"""Run the scheduling cycle through the objects and print one JSON line.

    python -m volcano_tpu_torch.cmd.cycle --tasks 50000 --nodes 10000 \\
        [--queues 1] [--warm 1] [--device cpu] \\
        [--zones 8 --spread-every 4 --anti-every 8] \\
        [--scenario {default,preempt,reclaim,example-conf}] [--trace] \\
        [--commit {live,alternate}] [--apply {deferred,eager,alternate}]

With ``--scenario default`` (the default), each run builds a fresh store
with ``populate_store(n_nodes, n_jobs=tasks // 8, gang_size=8)`` over
``--queues`` queues (with ``--zones`` > 0, nodes in that many zones, every
``--spread-every``-th gang spread over them with max_skew 1 and every
``--anti-every``-th gang one replica per zone), lets a new SchedulerCache
ingest it, and runs one ``Scheduler.run_once`` with the default conf plus
binpack (``enqueue, allocate, backfill``). The first run is cold (it
builds the kernel on the GPU); ``--warm`` more runs follow, each in a
fresh store. The line gives, per run, the populate and cache-sync seconds,
the cycle's wall ms, ``flush_ms`` (the ``cache.flush_executors()`` wait
after it: the executor's store writes of the cycle's binds and PodGroup
statuses, and their watch echoes) and the cycle's split
(``Scheduler.last_cycle``: snapshot,
open_session, each action, the allocate action's ordering, placement,
staging and commit, close_session, and each placement's encode, solve,
kernel and decode, its kernel launches and its prune summary), the binds,
the committed gangs and, on the GPU, the cycle's peak device memory above
what the process already held.

With ``--trace`` (or VOLCANO_TRACE=1 in the environment) the flight
recorder (trace/tracer.py) records each cycle, and each run's entry gains
``trace``: the span split of the cycle (``phases``: '/'-joined span paths
to ms and count), of its commit (``async``: the bind flush's spans), the
cycle's tags and the spans' coverage of its wall time.

``--scenario preempt`` and ``--scenario reclaim`` build the reference
harness's preemption and reclamation shapes instead
(``populate_preempt_store`` / ``populate_reclaim_store``, ``--tasks`` is
not read): ``--nodes`` full nodes of 16 CPU, nodes / 8 Running victim gangs
of 8 and half as many pending gangs of 8, under the conf ``enqueue,
allocate, preempt|reclaim, backfill`` with the reference's preemption or
reclamation tiers (volcano_tpu/bench_suite.py:39-50 and :463-475). The
line then also gives ``preempt_ms`` or ``reclaim_ms``, the evictions, the
pipelined tasks and the victim-selection paths taken.

``--scenario example-conf`` runs the repo's full-featured conf, the text
of examples/scheduler-conf.yaml, on the default scenario's store with the
shares of its plugins (``populate_store(..., plugin_shares=True)``): a
Numatopology on every node (2 NUMA nodes of 16 cores of 2 threads, the
static CPU manager, the single-numa-node topology manager), every 8th
gang Guaranteed with the single-numa-node policy and every 16th created
two hours before the store's clock (past sla's 1 h). Each run's
``places`` then carry the ``host_predicates`` sweep (ms, groups, nodes).

Every run's entry names its ``commit``: who wrote the cycle's binds,
evictions and statuses. ``live`` is the cache's executor, after the
cycle, as in a scheduler once ``cache.run()`` has started it (every run
with ``--commit live``, the default); ``inline`` is the cycle itself,
through :class:`InlineCache`, whose executor never starts (the
synchronous commit of a cache before ``run()``). ``--commit alternate``
times the two against each other: a live cold run, then warm runs in
live, inline, inline, live order, so that a drift of the host cancels.

Every run's entry also names its ``apply``: ``deferred`` (the default, as
in the reference: allocate records the placed gangs and their staging
runs at the first ``Session.materialize``, under the default conf
backfill's) or ``eager`` (the solver's ``apply: eager``: allocate stages
them). ``--apply alternate`` times the two against each other in the same
order: a deferred cold run, then warm runs in deferred, eager, eager,
deferred order.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time
from typing import List, Optional

import torch

from ..apiserver.store import ObjectStore
from ..cache import SchedulerCache
from ..scheduler import Scheduler
from ..trace import tracer
from ..utils.platform import default_device
from ..utils.synth import (populate_preempt_store, populate_reclaim_store,
                           populate_store)

CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""

PREEMPT_CONF = """
actions: "enqueue, allocate, preempt, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: nodeorder
"""

RECLAIM_CONF = """
actions: "enqueue, allocate, reclaim, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

# the repo's full-featured conf
EXAMPLE_CONF = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "examples", "scheduler-conf.yaml")

SCENARIOS = ("default", "preempt", "reclaim", "example-conf")
COMMITS = ("live", "alternate")
APPLIES = ("deferred", "eager", "alternate")
# the warm runs' order under --commit alternate and --apply alternate
ALTERNATION = ("live", "inline", "inline", "live")
APPLY_ALTERNATION = ("deferred", "eager", "eager", "deferred")
EAGER_APPLY = ("configurations:\n- name: solver\n"
               "  arguments: {apply: eager}\n")

# how long a run waits for the cache's executor to drain a cycle's writes
FLUSH_TIMEOUT_S = 300.0


class InlineCache(SchedulerCache):
    """A cache whose executor never starts: every bind, evict and status
    write runs inline in the cycle, as it does before ``run()`` (the
    synchronous commit the live executor is measured against)."""

    def start_executors(self) -> None:
        pass


def example_conf() -> str:
    """The text of examples/scheduler-conf.yaml."""
    with open(EXAMPLE_CONF) as f:
        return f.read()


def populate_scenario(store, scenario: str, n_nodes: int) -> str:
    """Fill ``store`` with the preempt or reclaim shape at ``n_nodes``
    nodes; returns the scenario's conf."""
    n_victim = max(1, n_nodes // 8)
    if scenario == "preempt":
        populate_preempt_store(store, n_nodes=n_nodes, n_low=n_victim,
                               n_high=max(1, n_victim // 2))
        return PREEMPT_CONF
    populate_reclaim_store(store, n_nodes=n_nodes, n_running=n_victim,
                           n_pending=max(1, n_victim // 2))
    return RECLAIM_CONF


def run_cycle(n_tasks: int, n_nodes: int, n_queues: int = 1,
              device=None, zones: int = 0, spread_every: int = 0,
              anti_every: int = 0, scenario: str = "default",
              commit: str = "live", apply: str = "deferred") -> dict:
    """One cycle on a fresh store: populate, sync the cache, run_once,
    its commit written by the cache's executor (``commit="live"``) or
    inline in the cycle (``"inline"``), its staging deferred
    (``apply="deferred"``) or eager (``"eager"``). Returns the timings
    and counts, and the store (key ``store``)."""
    device = default_device(device)
    store = ObjectStore()
    t0 = time.perf_counter()
    if scenario in ("default", "example-conf"):
        queues = [(f"queue-{i}", 1) for i in range(n_queues)] \
            if n_queues > 1 else None
        populate_store(store, n_nodes=n_nodes, n_jobs=n_tasks // 8,
                       gang_size=8, queues=queues, zones=zones,
                       spread_every=spread_every, anti_every=anti_every,
                       plugin_shares=scenario == "example-conf")
        conf = example_conf() if scenario == "example-conf" else CONF
    else:
        conf = populate_scenario(store, scenario, n_nodes)
    if apply == "eager":
        conf = conf.rstrip("\n") + "\n" + EAGER_APPLY
    t1 = time.perf_counter()
    cache = (InlineCache if commit == "inline" else SchedulerCache)(store)
    cache.run()
    t2 = time.perf_counter()
    sched = Scheduler(store, scheduler_conf=conf, cache=cache,
                      device=device)
    # the long-lived cluster objects are frozen out of the cyclic
    # collector, as the scheduler's own loop does (Scheduler.run)
    gc.collect()
    gc.freeze()
    try:
        if device.type == "cuda":
            # the allocator's statistics exist once CUDA is initialised,
            # which nothing before this point in a fresh process has done
            torch.cuda.init()
            resident = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        sched.run_once()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t3 = time.perf_counter()
        if not cache.flush_executors(timeout=FLUSH_TIMEOUT_S):
            raise RuntimeError(f"the cache's executor did not drain in "
                               f"{FLUSH_TIMEOUT_S:g} s")
        flush_ms = (time.perf_counter() - t3) * 1000.0
    finally:
        gc.unfreeze()
    pods = store.list("pods")
    binds = sum(1 for p in pods if p.spec.node_name)
    committed = sum(1 for g in store.list("podgroups")
                    if g.status.phase == "Running")
    out = {"commit": commit, "apply": apply, "populate_s": t1 - t0, "sync_s": t2 - t1,
           **sched.last_cycle, "flush_ms": flush_ms,
           "binds": binds, "committed_gangs": committed,
           "evictions": cache.evictions, "store": store}
    if tracer.is_enabled():
        out["trace"] = trace_split(tracer.last_record())
    if device.type == "cuda":
        # the cycle's own peak, above what the process already held
        out["peak_device_bytes"] = \
            torch.cuda.max_memory_allocated(device) - resident
    cache.stop()
    return out


def trace_split(rec) -> dict:
    """The flight recorder's split of one cycle record: every span path's
    ms and count, the commit's (the bind flush's) spans, the cycle's tags
    and the spans' coverage of its wall time."""
    summary = tracer.summary(rec)
    return {"phases": tracer.flat_phases(rec),
            "async": tracer.async_phases(rec),
            "tags": summary["tags"], "coverage": summary["coverage"],
            "cycle_ms": summary["cycle_ms"]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="volcano_tpu_torch.cmd.cycle",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--tasks", type=int, default=50_000)
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--queues", type=int, default=1)
    ap.add_argument("--warm", type=int, default=1,
                    help="warm runs after the cold one, each on a fresh "
                         "store")
    ap.add_argument("--zones", type=int, default=0,
                    help="zones the nodes lie in (0: no zone labels)")
    ap.add_argument("--spread-every", type=int, default=0,
                    help="every Nth gang spreads over the zones")
    ap.add_argument("--anti-every", type=int, default=0,
                    help="every Nth gang places one replica per zone")
    ap.add_argument("--scenario", choices=SCENARIOS, default="default",
                    help="the cluster's shape: the allocation backlog, "
                         "the preemption or reclamation shape (--tasks is "
                         "then not read), or the backlog with NUMA, "
                         "Guaranteed and sla shares under "
                         "examples/scheduler-conf.yaml")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain loop)")
    ap.add_argument("--commit", choices=COMMITS, default="live",
                    help="who writes the cycle's binds, evictions and "
                         "statuses: the cache's executor after the cycle "
                         "(live), or, alternated over the warm runs, it and "
                         "the cycle itself (inline)")
    ap.add_argument("--apply", choices=APPLIES, default="deferred",
                    help="the placed gangs' staging: deferred to the "
                         "first materialize (the default), eager in "
                         "allocate, or the two alternated over the warm "
                         "runs")
    ap.add_argument("--trace", action="store_true",
                    help="record each cycle with the flight recorder and "
                         "print its span split")
    opts = ap.parse_args(argv)
    if opts.trace:
        tracer.enable()
    else:
        tracer.enable_from_env()
    device = default_device(opts.device)
    runs = []
    for i in range(1 + opts.warm):
        commit = opts.commit
        if commit == "alternate":
            commit = "live" if i == 0 else \
                ALTERNATION[(i - 1) % len(ALTERNATION)]
        apply = opts.apply
        if apply == "alternate":
            apply = "deferred" if i == 0 else \
                APPLY_ALTERNATION[(i - 1) % len(APPLY_ALTERNATION)]
        r = run_cycle(opts.tasks, opts.nodes, opts.queues, device,
                      zones=opts.zones, spread_every=opts.spread_every,
                      anti_every=opts.anti_every, scenario=opts.scenario,
                      commit=commit, apply=apply)
        r.pop("store")
        runs.append(r)
    print(json.dumps({
        "device": torch.cuda.get_device_name(device)
        if device.type == "cuda" else str(device),
        "scenario": opts.scenario, "tasks": opts.tasks,
        "nodes": opts.nodes, "queues": opts.queues,
        "zones": opts.zones, "spread_every": opts.spread_every,
        "anti_every": opts.anti_every,
        "cold": runs[0], "warm": runs[1:]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
