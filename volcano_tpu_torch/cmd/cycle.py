"""Run the scheduling cycle through the objects and print one JSON line.

    python -m volcano_tpu_torch.cmd.cycle --tasks 50000 --nodes 10000 \\
        [--queues 1] [--warm 1] [--device cpu] \\
        [--zones 8 --spread-every 4 --anti-every 8] \\
        [--scenario {default,preempt,reclaim}]

With ``--scenario default`` (the default), each run builds a fresh store
with ``populate_store(n_nodes, n_jobs=tasks // 8, gang_size=8)`` over
``--queues`` queues (with ``--zones`` > 0, nodes in that many zones, every
``--spread-every``-th gang spread over them with max_skew 1 and every
``--anti-every``-th gang one replica per zone), lets a new SchedulerCache
ingest it, and runs one ``Scheduler.run_once`` with the default conf plus
binpack (``enqueue, allocate, backfill``). The first run is cold (it
builds the kernel on the GPU); ``--warm`` more runs follow, each in a
fresh store. The line gives, per run, the populate and cache-sync seconds,
the cycle's wall ms and its split (``Scheduler.last_cycle``: snapshot,
open_session, each action, the allocate action's ordering, placement,
staging and commit, close_session, and each placement's encode, solve,
kernel and decode), the binds, the committed gangs and, on the GPU, the
cycle's peak device memory above what the process already held.

``--scenario preempt`` and ``--scenario reclaim`` build the reference
harness's preemption and reclamation shapes instead
(``populate_preempt_store`` / ``populate_reclaim_store``, ``--tasks`` is
not read): ``--nodes`` full nodes of 16 CPU, nodes / 8 Running victim gangs
of 8 and half as many pending gangs of 8, under the conf ``enqueue,
allocate, preempt|reclaim, backfill`` with the reference's preemption or
reclamation tiers (volcano_tpu/bench_suite.py:39-50 and :463-475). The
line then also gives ``preempt_ms`` or ``reclaim_ms``, the evictions, the
pipelined tasks and the victim-selection paths taken.
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from typing import List, Optional

import torch

from ..apiserver.store import ObjectStore
from ..cache import SchedulerCache
from ..scheduler import Scheduler
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

SCENARIOS = ("default", "preempt", "reclaim")


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
              anti_every: int = 0, scenario: str = "default") -> dict:
    """One cycle on a fresh store: populate, sync the cache, run_once.
    Returns the timings and counts, and the store (key ``store``)."""
    device = default_device(device)
    store = ObjectStore()
    t0 = time.perf_counter()
    if scenario == "default":
        queues = [(f"queue-{i}", 1) for i in range(n_queues)] \
            if n_queues > 1 else None
        populate_store(store, n_nodes=n_nodes, n_jobs=n_tasks // 8,
                       gang_size=8, queues=queues, zones=zones,
                       spread_every=spread_every, anti_every=anti_every)
        conf = CONF
    else:
        conf = populate_scenario(store, scenario, n_nodes)
    t1 = time.perf_counter()
    cache = SchedulerCache(store)
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
            resident = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        sched.run_once()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        gc.unfreeze()
    pods = store.list("pods")
    binds = sum(1 for p in pods if p.spec.node_name)
    committed = sum(1 for g in store.list("podgroups")
                    if g.status.phase == "Running")
    out = {"populate_s": t1 - t0, "sync_s": t2 - t1,
           **sched.last_cycle, "binds": binds, "committed_gangs": committed,
           "evictions": cache.evictions, "store": store}
    if device.type == "cuda":
        # the cycle's own peak, above what the process already held
        out["peak_device_bytes"] = \
            torch.cuda.max_memory_allocated(device) - resident
    cache.stop()
    return out


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
                    help="the cluster's shape: the allocation backlog, or "
                         "the preemption or reclamation shape (--tasks is "
                         "then not read)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain loop)")
    opts = ap.parse_args(argv)
    device = default_device(opts.device)
    runs = []
    for _ in range(1 + opts.warm):
        r = run_cycle(opts.tasks, opts.nodes, opts.queues, device,
                      zones=opts.zones, spread_every=opts.spread_every,
                      anti_every=opts.anti_every, scenario=opts.scenario)
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
