"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--group NAME]

Run from the root of a checkout on a machine with one Hopper GPU and nvcc
(under $CUDA_HOME or /usr/local/cuda). Phases, each printing one line:

1. device: the card's name and capability (must be 9.0), and
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
2. build: every kernel of volcano_tpu_torch/csrc, compiled with nvcc, and
   ptxas's registers and spills of every gang-allocate instantiation;
   and the native engine (volcano_tpu_torch/native/fastmodel.c), compiled
   with gcc, the default engine of the commit path and the snapshot's
   clones in every later phase;
3. kernel against plain on the card at 4,096 tasks x 2,048 nodes, gang 8:
   one queue; four queues with budgets from the proportion water-fill;
   three namespaces with the live namespace order off and on; tight
   capacity that forces gang rollbacks; topology buckets with releasing
   capacity, pipelining on and off; then gang 1 (a table refresh every
   step), gang 20 (longer than the table's chunk of 16, so it refreshes
   inside a job, over tight capacity), a ragged node count (2,100, not
   a multiple of the cluster's 8 blocks x 32), mixed gangs (pod caps,
   padding tasks and a group change inside a job's span, rollbacks
   followed by a job of the same group) and buckets shared by
   neighbouring jobs; then per-task domain slots over 8 zones
   (utils/synth.py:zone_slots): every gang rotating over the zones, an
   all-false row, slots with buckets, and slots over tight capacity.
   assign, pipelined, ready, kept and the final node state must match
   exactly, every placement must replay feasibly and lie in its task's
   slot row; the kernel's count of table refreshes must equal that of its
   plain model, ops/allocate.py:gang_allocate_chunked (run meanwhile on
   the host's CPU by four worker processes), whose counts by cause show
   that the refreshes each case aims at happened;
4. the main path at full size: DenseSolver.place on
   synth_arrays(50_000, 10_000, gang_size=8, seed=42, utilization=0.3),
   one warm-up and three timed runs, with every launch count set to 0
   before and read after; the result must replay feasibly and be
   gang-atomic;
5. the kernel on the main path's own inputs, three timed runs, and the
   bound of its work, held exactly against its plain version, which runs
   on the same inputs on the host's CPU in a worker process meanwhile
   (it rounds as on the card; LatePlain) and is compared before the
   kernels line; then the kernel's time per step at 50,000 tasks over
   fewer nodes;
6. the table's worst case: 50,000 tasks of gang 1 over 10,000 nodes, the
   kernel alone after a warm-up (no plain run: it would take minutes),
   feasible and gang-atomic; with the gang-8 main-path inputs it splits
   the kernel's time into microseconds per refresh and per served step;
6b. shapes_vs_plain: the shapes the kernel used to refuse, each held
   exactly against the plain loop with its refreshes against the plain
   model's: R = 9, 12, 16 and 20 at 4,096 tasks x 2,048 nodes (the last
   in the kernel's runtime-R form), and the global plan (node state in
   device memory) over 60,000 and 100,000 nodes at R = 4 and 50,000 at
   R = 16 (2,048 tasks); the main path's inputs under both plans,
   alternated and timed, equal to each other; ptxas's registers and
   spills at R = 16;
7. cycle_vs_plain: the scheduling cycle through the objects,
   ``Scheduler(store, device="cuda").run_once()`` against the same cycle
   with ``device="cpu"`` (the plain loop), each on its own store built by
   the same seeded builders, at 4,096 tasks x 2,048 nodes in gangs of 8:
   one queue; four queues (weights 1, 2, 4, 1, the last capped) in three
   namespaces with drf's live namespace order; tight capacity with zone
   selectors and NoSchedule taints, where gangs roll back; and the
   constrained mix (populate_store over 8 zones, every 4th gang spread
   with max_skew 1, every 8th one replica per zone); and nine resource
   kinds (populate_store's gangs with seven scalar kinds over 256 nodes,
   R = 9, where some gangs roll back). Binds must be
   equal pod for pod and PodGroup phases gang for gang, the binds must
   replay within every node's allocatable, every gang be all-or-nothing,
   every spread gang keep max_skew 1 and every anti gang one replica a
   zone;
8. prune_vs_plain: candidate pruning (ops/prune.py), GPU cycles against
   CPU cycles of the port on the same seeded stores: the reference's probe
   shape (populate_store, 4,096 nodes, 600 gangs of 8) under the default
   conf, where auto mode engages; forced ``prune.enable: "true"`` at
   2,048 nodes on populate_store's uniform fleet and on the constrained
   mix; k = 1 over identical nodes that each hold one pod, which ends in
   the exhaustion guard (``shortlist_exhausted``, two launches); k = 1
   over nodes of varied sizes with a 0.99 coverage floor, which ends in
   ``low_coverage``. Binds, phases and every field of each place's prune
   summary must be equal (coverage within 1e-6) and each case must end
   in its path;
9. cycle: the port's main path through the objects at the north star's
   size, volcano_tpu_torch.cmd.cycle.run_cycle: populate_store(10,000
   nodes, 6,250 gangs of 8), a fresh cache, one Scheduler.run_once with
   the default conf plus binpack, so pruning engages where the reference's
   does; one cold and one warm run on fresh stores, the launch count set
   to 0 just before each cycle and read just after. Each prints populate
   and sync seconds, the cycle's wall ms and its split, each place's prune
   summary (whether the reduced run served, the fallback), the
   distillation's ms, the union width and the kernel's CUDA-event ms per
   launch and launch report, binds (all 50,000), committed gangs (all
   6,250) and peak device memory; the binds must replay within
   allocatable and be gang-atomic, and the launches must be what the
   places' prune outcomes give (one a place, two where the exhaustion
   guard discarded the reduced run);
10. the kernel on the cycle's own inputs at that size (R = 2, the
    encode of the allocate action's phase-A batch), feasible and
    gang-atomic, and held exactly against its plain version like phase
    5 on the inputs the warm cycle launched on (the reduced ones where
    its place pruned and served); the distillation on the card and
    on the CPU on the full-width inputs must give the same union,
    feasible and kept counts and guard, coverage within 1e-6;
11. cycle_constrained: the slot path, the constrained mix of phase 7 at
    the north star's size (50,000 pods, 10,000 nodes), one cold and one
    warm run, each with the launch count set to 0 just before and read
    just after; each prints the cycle's split with the constraint passes'
    ms, the prune fields of phase 9, the kernel's CUDA-event ms and table
    refreshes, binds and committed gangs, and fails on an infeasible
    bind, a broken gang, a spread or anti-affinity violation or launches
    other than its prune outcomes give; then that cycle's own kernel
    inputs (with task_slot and slot_ok) as in phase 10, and the kernel's
    refreshes against the count its rule gives;
12. victims_vs_plain: preempt and reclaim through the objects, the
    reference harness's shapes (utils/synth.py:populate_preempt_store,
    populate_reclaim_store) at 2,048 nodes, 256 victim gangs and 128
    waiting gangs, in four confs: preempt by the walk (drf's tier
    decides), preempt vectorized (the reference's A/B conf over the
    elastic shape), reclaim vectorized and reclaim with
    ``victims.kernel: off``. Two cycles on one store with
    device="cuda" against the same two with device="cpu": evicted pods
    (in order), pipelined task -> node, cycle-2 binds and PodGroup
    phases must be equal, and each cycle must take its conf's path; a
    pipelined task that does not fit its node's future idle once its
    victims are released, a preempt victim not of strictly lower
    priority, a reclaim victim not of another, reclaimable queue, or a
    gang bound below minMember fails;
13. preempt_cycle and 14. reclaim_cycle: the same paths at the
    reference's full size (10,000 nodes, 1,250 victim gangs, 625 waiting
    gangs of 8), each on fresh stores: one cold and one warm GPU cycle
    and one CPU cycle held equal to the warm one as in phase 12; each
    prints populate and sync seconds, the cycle's wall ms and split (the
    kernel's CUDA-event ms and launches, the prune fields, preempt_ms or
    reclaim_ms, the commit), evictions, pipelined tasks and peak device
    memory, and fails if nothing is evicted or the kernel's launches are
    not what the cycle's one place's prune outcome gives;
15. victim_prefix: the batched torch prefix functions of
    ops/preempt.py at 5,000 preemptors x 10,000 nodes, on the preempt
    path's own tensors (V = 1) and on a seeded V = 8, R = 2 case, on the
    card (three timed runs after a warm-up) and on the CPU: feasible,
    n_evict, covered and pick_best_node must be equal; prints the card's
    ms and the bound of the bytes the function must move;
15b. traced_cycle: the north-star cycle of phase 9 with the flight
    recorder (and ledger) off and on through volcano_tpu_torch/cmd/
    trace_overhead.py: two warm runs of each on fresh stores in
    off-on-on-off order, then eight steady cycles (nothing left to
    place) on one of those stores, tracing off and on in the same order: the span split of the cycle and of its commit,
    the overhead of tracing in percent, the kernel's device time from the
    execute span's tag against the solver's own, /metrics fetched from
    the metrics server on a local port (every line must parse), and the
    ledger must have completed every bind;
15c. incremental_cycle: the incremental steady-state cycle.
    Full width: two north-star stores (phase 9's shape), one Scheduler
    with ``incremental=True`` and one with ``False``, through one seeded
    sequence: a placing cycle, three steady cycles (the last two quiet),
    two cycles with a gang no node holds, four churn cycles (each
    deletes 62 bound gangs, 1 %, adds 62 pending gangs of 8 and
    relabels 10 nodes) and a queue add (a full rebuild); after each
    cycle the binds, evictions and PodGroup phases and conditions of
    the two must be equal. Unpruned: the same sequence at 4,096 pods
    over 2,048 nodes, below the pruning threshold, incremental on the
    card against incremental with the plain loop on the CPU, equal the
    same way; after every full-width launch on the card the five
    resident node tensors must equal a fresh upload of the session's
    NodeArrays.build; the second cycle with the unfit gang launches and
    copies no node row, and every churn cycle copies some rows but not
    all. Each cycle prints its mode, patched jobs and nodes, quiet,
    snapshot, open_session, close_session and cycle ms, the node-tensor
    bytes and rows copied and the kernel's launches, counted from 0 just
    before the cycle (0 on a quiet cycle, what the prune outcomes give
    otherwise);
15d. flush_cycle: the write-behind commit (the cache's executor).
    (a) Full width: phase 9's north-star store with the executor live,
    one cycle, its flush (``flush_ms``) and one timed anti-entropy pass
    that must repair nothing, against fresh stores of the same shape
    committed inline by a cache whose executor never starts
    (InlineCache), live first: binds and
    PodGroups (phase and conditions) equal, every pod bound, every gang
    Running. (b) Faults: 4,096 pods over
    2,048 nodes on a FakeClock, a FlakyBinder failing a seeded 2 % of
    the binds, six cycles one virtual second apart, the card against
    the plain loop on the CPU, both live: binds, PodGroups, retry
    records (attempts, not_before), quarantine and healed pods equal
    after every flush. (c) Fenced: a cache whose fencing token is behind
    the store's floor: no bind lands, and the store's fenced writes and
    the cache's resync retries equal the binds attempted;
15e. plugins_cycle: the remaining plugins and actions through the
    kernel. (a) Full width: phase 9's north-star store with a
    Numatopology on every node (2 NUMA nodes x 16 cores x 2 threads,
    the static CPU manager, the single-numa-node topology manager),
    every 8th gang Guaranteed with the single-numa-node policy and every
    16th created two hours before the clock, under the text of
    examples/scheduler-conf.yaml (sla, numa-aware and the rest): one
    placing and one steady cycle, the launch count set to 0 just before
    each and read just after; each prints cycle_ms with its split,
    flush_ms, the host_predicates sweep's ms and G, the kernel's ms and
    launches, the binds and the pods given NUMA CPU sets, beside phase
    9's warm default-conf cycle; every pod binds, every gang runs. The
    placing cycle's two launches (the pruned place's 64-column one and
    the full-width one, numa-aware's host mask in the static mask) are
    captured and held exactly against the plain loop on the same
    tensors, as in phase 10 (the plain loop runs on the host during the
    later phases, so this phase runs right after phase 11).
    (b) The card against the plain loop on fresh FakeClock stores of
    4,096 pods, equal every cycle in binds, PodGroups (phase and
    conditions), evictions, NUMA sets, NUMA pods and the reservation's
    target and locked nodes: (a)'s conf and shares over 2,048 nodes and
    over 4,096 (the pruned place carries the host mask); tdm (zone rz1
    on one node in 8, one gang in 4 revocable and preemptable) with
    overcommit under enqueue, allocate, backfill and preempt, two cycles
    with the zone active all day, then the bound pods marked Running and
    a third cycle outside the zone's window, which must drain one
    revocable pod of each job on the zone's nodes (tdm's victim tasks
    and disruption budget); reservation with elect and reserve over
    four cycles an hour apart, a gang of two 62-core pods Pending until
    sla admits it, which binds on the nodes reserve locked. The reservation singleton and
    tdm's evict clock are reset around every run;
15f. scheduler_binary: the scheduler binary (volcano_tpu_torch/cmd/
    scheduler.py) with leader election, the conf hot reload, the
    deferred apply (the default) and the store's volume binder.
    (a) Two candidates through ``run_scheduler`` (--leader-elect, a 1 s
    period) on one store of populate_store(10,000 nodes, 6,250 gangs of
    8, volumes=32: every 32nd gang's pods mount a claim each, the claims
    of every 8th such gang match no volume), the default conf plus
    binpack read from a file: the leader's placing cycle and two steady
    cycles, each with the launch count set to 0 just before and read
    just after and its flush timed; the binds replay within allocatable
    and gangs are all-or-nothing; every bound pod's claim is Bound to a
    volume that holds it, no volume holds two claims, the 25 unmatched
    gangs stay Pending and their volumes Available; the standby's
    pending report says REASON_NOT_LEADER. Then the leader's elector
    stops and releases the lease: the standby takes over with a higher
    token, a write with the old token is fenced, and the new leader's
    first cycle keeps every bind and volume. Then the conf file is
    rewritten without binpack: the new leader runs it within two
    watcher intervals. Prints each cycle's cycle_ms, flush_ms,
    allocate.stage_ms (and within it the volume plan's ms), the volume
    binds' ms, backfill_ms, kernel ms and launches, the
    takeover time, the tokens and the volumes bound. (b) The deferred
    apply against ``apply: eager`` at the north star: one warm cycle
    each on a fresh store, binds and PodGroups equal; prints both
    sides' allocate.stage_ms, backfill_ms and cycle_ms. (c) The card
    against the plain loop at 4,096 pods x 2,048 nodes with volumes:
    three cycles with the executor live and a seeded churn between them
    (volumes for an unmatched gang, which then binds; a claim of the
    other deleted; two new gangs whose claims have volumes), and two
    cycles in which the deferred apply of gang pg-1 fails before its
    commit in the first (the gang is dropped, and binds in the second);
    binds, PodGroups, claims and volumes equal after every cycle;
15g. native_commit: the native engine (native/fastmodel.c) against the
    Python bodies at the north star (phase 9's store, the default conf
    plus binpack, pruning auto, the cache's executor live, the ledger
    on): one placing cycle and its flush a run, each on a fresh store of
    the same seed, the engines in N P P N order (Python: every native
    switch off), then one traced Python run for the flush's async spans
    (the native engine's are phase 15b's, whose traced placing cycles run
    the same store and conf on it). After every flush the stored pods and their resource
    versions, the journal's (rv, action, kind, key) sequence, the
    ledger's counts (completed, open, per hop, per queue, the recent
    ring's pods and hops) and the PodGroup phases must equal the first
    run's; every pod binds (the first run's binds replay within
    allocatable, gangs all-or-nothing), the kernel launches once a
    cycle, and the native entries must have taken the native runs' work
    and the Python runs must call none (counted in each run's line,
    ``entries``: calls, calls that took their work). Prints per engine
    cycle_ms, snapshot_ms, flush_ms and the gang's bound time (cycle +
    flush) with medians and spreads, and the traced runs'
    bind_flush.apply, bind_flush.store and store.patch.echo_wait;
16. the kernels line (with the table refreshes, the cluster's blocks and
    each block's shared memory, the plan and R, as the main path's launch
    reported them, the shapes_vs_plain summary, traced_cycle's overhead,
    the kernel's launches per cycle, per preempt and per reclaim cycle,
    per quiet and per churn incremental cycle, per flush_cycle cycle
    (``launches_per_flush_cycle``), plugins_cycle's launches, kernel ms,
    host_predicates ms and G, scheduler_binary's launches per cycle,
    and a ``prune`` entry for the north-star cycle's place: union, padded
    width, launches, refreshes, whether the reduced run served; a second
    entry for the slot path), then the card's nvidia-smi line, then
    {"ok": true, "device": {...}} as the last line.

The phases after 8 run in three groups (GROUPS), each in a process of
its own, started together after the build and run beside phases 3-8 on
the one card: ``cycles`` (9-11, 15e, 12), ``binary_victims`` (15f, 13,
14, 15, 15c) and ``commit`` (15b, 15d, 15g). Their lines reach stdout
through the script; their host times carry each other's load, on the
host's cores and the card's time slices (``--group NAME`` runs one
group alone, for host times without that load). A group that fails
stops the script; every process it started is killed on the way out.

Every phase that runs a cache (``cache.run()`` starts its executor)
waits for it with ``flush_executors()`` before it reads the store, and
prints that wait as ``flush_ms`` beside the cycle's ``cycle_ms``.

Any failed check exits non-zero before the last line. Without a CUDA
device, or without the volcano_tpu_torch package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import _thread
import argparse
import atexit
import concurrent.futures
import ctypes
import gc
import json
import logging
import multiprocessing
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    raise SystemExit(2)

from volcano_tpu_torch import convert  # noqa: E402
from volcano_tpu_torch.apiserver import ObjectStore  # noqa: E402
from volcano_tpu_torch.apiserver.store import FencedError  # noqa: E402
from volcano_tpu_torch.cache import SchedulerCache  # noqa: E402
from volcano_tpu_torch.cache.event_handlers import (  # noqa: E402
    EventHandlersMixin)
from volcano_tpu_torch.cmd import cycle as cycle_cmd  # noqa: E402
from volcano_tpu_torch.cmd import scheduler as scheduler_cmd  # noqa: E402
from volcano_tpu_torch.framework import parse_scheduler_conf  # noqa: E402
from volcano_tpu_torch.framework import statement as statement_mod  # noqa: E402
from volcano_tpu_torch.framework.solver import DenseSolver  # noqa: E402
from volcano_tpu_torch.ops import allocate, build, prune  # noqa: E402
from volcano_tpu_torch.ops.cuda_allocate import (  # noqa: E402
    gang_allocate_cuda)
from volcano_tpu_torch.ops.fairshare import proportion_waterfill  # noqa: E402
from volcano_tpu_torch.models import job_info  # noqa: E402
from volcano_tpu_torch.models import objects as obj  # noqa: E402
from volcano_tpu_torch.native import build as native_build  # noqa: E402
from volcano_tpu_torch.models.resource import Resource  # noqa: E402
from volcano_tpu_torch.ops.score import ScoreWeights  # noqa: E402
from volcano_tpu_torch.scheduler import Scheduler  # noqa: E402
from volcano_tpu_torch.sim.faults import FlakyBinder  # noqa: E402
from volcano_tpu_torch.plugins import numaaware as numaaware_plugin  # noqa: E402
from volcano_tpu_torch.plugins import tdm as tdm_plugin  # noqa: E402
from volcano_tpu_torch.trace import ledger, pending, tracer  # noqa: E402
from volcano_tpu_torch.utils import test_utils as tu  # noqa: E402
from volcano_tpu_torch.utils.clock import FakeClock  # noqa: E402
from volcano_tpu_torch.utils.reservation import RESERVATION  # noqa: E402
from volcano_tpu_torch.utils.synth import (  # noqa: E402
    UNMATCHED_CLAIM, populate_preempt_store, populate_reclaim_store,
    populate_store, scalar_kinds, synth_arrays, volume_plan, zone_slots)

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s
# and float32 operations/s outside the tensor cores. The float32 peak
# counts a fused multiply-add as two operations; the kernel is built
# with -fmad=false, so its separate adds and multiplies reach half of it
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP32_NO_FMA_OPS_PER_S = FP32_OPS_PER_S / 2
# float32 operations the kernel does for one node in one step: fits
# (2 R adds, 2 R compares), binpack (7 R), least/most/balanced over
# cpu and memory (24), the weighted sum and pack bonus (13)
OPS_PER_NODE_STEP_R4 = 16 + 28 + 24 + 13

MID = dict(n_tasks=4096, n_nodes=2048, gang=8)
# worker processes that run the mid cases' plain refresh model on the
# host's CPU while the card runs the kernel and the plain loop
MODEL_WORKERS = 4
# worker processes that run the plain loop on the full-size inputs on the
# host's CPU while the card runs the later phases (LatePlain)
LATE_WORKERS = 2
FULL = dict(n_tasks=50_000, n_nodes=10_000, gang=8)
# the reference's constraint benchmark mix (bench.py:455's "heavy")
HEAVY = dict(zones=8, spread_every=4, anti_every=8)
# shapes_vs_plain: the resource counts held against the plain loop at
# MID's size (cpu, memory and 7, 10, 14 and 18 scalar kinds), and the
# global plan's (nodes, R) at 2,048 tasks
SHAPE_RS = (9, 12, 16, 20)
GLOBAL_CASES = ((60_000, 4), (100_000, 4), (50_000, 16))
GLOBAL_TASKS = 2048
# traced_cycle: warm north-star cycles with tracing off and on, in
# off-on-on-off order (even)
TRACE_PAIRS = 2
# one Prometheus exposition line: name{labels} value
PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\\n])*",?)*\})?'
    r' -?[0-9.e+\-]+$')
ZONE_KEY = "topology.kubernetes.io/zone"

# the scheduler conf of the cycle phases: the default conf's plugins plus
# binpack; ``{drf}`` takes drf's options
CYCLE_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf{drf}
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


# each phase line says when it was printed, in seconds since the script
# started (a group's process is handed the start by its parent), so that
# the phases' share of the time limit can be read off
STARTED = float(os.environ.get("CHIP_SMOKE_STARTED", time.time()))
# the lines of a group's processes reach stdout through their parent,
# whole, one at a time
PRINT_LOCK = threading.Lock()


def emit(text: str) -> None:
    with PRINT_LOCK:
        sys.stdout.write(text)
        sys.stdout.flush()


def line(phase: str, **fields) -> None:
    emit(json.dumps({"phase": phase, "t_s": time.time() - STARTED,
                     **fields}) + "\n")


def to_np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def replay_feasible(sa, assign: np.ndarray, pipelined: np.ndarray) -> bool:
    """Every placement fits. Tasks on idle capacity each fit idle when
    placed, so on every node idle minus all of them stays >= -eps;
    pipelined tasks each fit future capacity, which every earlier
    placement on the node drew down, so future minus all pipelined tasks
    stays >= -eps. (A task on idle does not check future, as in the
    reference, so future minus every task may go lower.) Only nodes that
    took a task count: a node may start over-committed."""
    placed = assign >= 0
    tol = -sa.eps[None, :] - 1e-3
    took = np.zeros(sa.node_idle.shape[0], bool)
    took[assign[placed]] = True
    ok = True
    for cap, which in ((sa.node_idle, placed & ~pipelined),
                       (sa.node_future, placed & pipelined)):
        used = np.zeros_like(cap)
        np.add.at(used, assign[which], sa.group_req[sa.task_group[which]])
        ok &= bool(np.all((cap - used)[took] >= tol))
    return ok


def gang_atomic(sa, assign, ready, kept) -> bool:
    """Jobs neither ready nor kept place nothing; the others place at
    least minAvailable tasks counting those already running."""
    J = sa.job_min_available.shape[0]
    placed = np.bincount(sa.task_job[assign >= 0], minlength=J)[:J]
    keep = ready | kept
    ok_none = np.all(placed[~keep] == 0)
    ok_min = np.all(placed[keep] + sa.job_ready_base[keep]
                    >= sa.job_min_available[keep])
    return bool(ok_none and ok_min)


def compare(sa, got, want, ctx: str) -> dict:
    """The kernel's outputs (got) against the plain loop's (want), exactly:
    assign, pipelined, ready, kept and the final node state. Built with
    -fmad=false and the score summed in the plain version's order, the
    kernel rounds as the plain loop does on the card, so a wrong score
    term or tie-break shows as a differing node even where every task is
    placed. The placements must also replay feasibly and be gang-atomic."""
    a1, p1, r1, k1 = (to_np(x) for x in got[:4])
    a2, p2, r2, k2 = (to_np(x) for x in want[:4])
    if not np.array_equal(r1, r2):
        fail(f"{ctx}: ready differs on {int((r1 != r2).sum())} jobs")
    if not np.array_equal(k1, k2):
        fail(f"{ctx}: kept differs on {int((k1 != k2).sum())} jobs")
    if not replay_feasible(sa, a1, p1):
        fail(f"{ctx}: the kernel's placements do not replay feasibly")
    if not gang_atomic(sa, a1, r1, k1):
        fail(f"{ctx}: the kernel's result is not gang-atomic")
    s1, s2 = got[4], want[4]
    state_err = max(float(np.abs(to_np(s1.idle) - to_np(s2.idle)).max()),
                    float(np.abs(to_np(s1.future)
                                 - to_np(s2.future)).max()))
    assign_mismatches = int((a1 != a2).sum())
    pipelined_mismatches = int((p1 != p2).sum())
    if assign_mismatches or pipelined_mismatches or state_err > 0:
        fail(f"{ctx}: {assign_mismatches} assign and {pipelined_mismatches} "
             f"pipelined mismatches, node state error {state_err}")
    return {"assign_mismatches": assign_mismatches,
            "pipelined_mismatches": pipelined_mismatches,
            "placed": int((a1 >= 0).sum()), "ready": int(r1.sum()),
            "kept": int(k1.sum()), "state_max_abs_err": state_err}


def in_slot_rows(assign: np.ndarray, slots) -> bool:
    """Every placed task lies on a node of its slot row (no slots: True)."""
    if slots is None:
        return True
    task_slot, slot_ok = slots
    placed = np.flatnonzero(assign >= 0)
    return bool(slot_ok[task_slot[placed], assign[placed]].all())


def bound(args, slot_args, outputs, n_refresh: int, steps: int, N: int,
          R: int):
    """(bytes ms, operations ms, operations ms without FMA): each input
    read once and each output written once over HBM, against the
    operations this run's data needs, every node scored at each refresh
    and at most two table rows rescored at each step."""
    in_bytes = sum(x.numel() * x.element_size()
                   for x in [*args, *slot_args])
    out_bytes = sum(x.numel() * x.element_size() for x in outputs)
    ops = (n_refresh * N + 2 * steps) * OPS_PER_NODE_STEP_R4 * R / 4
    return ((in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
            ops / FP32_OPS_PER_S * 1e3, ops / FP32_NO_FMA_OPS_PER_S * 1e3)


def mid_cases():
    """The mid-size scenarios: (name, SynthArrays, ns_live, allow_pipeline,
    (task_slot, slot_ok) or None)."""
    n, m, g = MID["n_tasks"], MID["n_nodes"], MID["gang"]
    one_q = synth_arrays(n, m, gang_size=g, seed=1, utilization=0.3)
    four_q = synth_arrays(n, m, gang_size=g, seed=2, utilization=0.3,
                          n_queues=4)
    # proportion: queue weights 1..4, each capped at a slice of the
    # cluster, over the pending requests of its jobs
    r = four_q.group_req.shape[1]
    real = four_q.task_valid
    request = np.zeros((4, r), np.float32)
    job_q = four_q.job_queue[four_q.task_job[real]]
    np.add.at(request, job_q, four_q.group_req[four_q.task_group[real]])
    capability = (four_q.ns_total[None, :]
                  * np.array([[0.01], [0.02], [0.03], [0.04]], np.float32))
    deserved, _ = proportion_waterfill(
        torch.tensor([1.0, 2.0, 3.0, 4.0]), torch.from_numpy(capability),
        torch.from_numpy(request), torch.from_numpy(four_q.ns_total))
    four_q.queue_deserved[:4] = deserved.numpy()
    three_ns = synth_arrays(n, m, gang_size=g, seed=3, utilization=0.3,
                            n_queues=2, n_namespaces=3)
    three_ns.ns_weight[:] = [1.0, 2.0, 4.0]
    tight = synth_arrays(n, m, gang_size=g, seed=4, utilization=0.6)
    tight.node_idle *= np.float32(0.15)
    tight.node_future[:] = tight.node_idle
    # topology buckets with a pack bonus, releasing capacity to pipeline
    # onto, and jobs with members already running
    packed = synth_arrays(n, m, gang_size=g, seed=5, utilization=0.6)
    groups = np.arange(packed.group_req.shape[0])
    bucket = np.where(groups % 3 == 0, -1, groups % 7)
    packed.task_bucket[:] = np.where(packed.task_valid,
                                     bucket[packed.task_group], -1)
    packed.group_pack_bonus[:] = 5.0
    packed.node_idle *= np.float32(0.3)
    packed.node_future[:] = np.minimum(packed.node_idle * 4, packed.node_alloc)
    packed.job_ready_base[::5] = 2
    gang1 = synth_arrays(n, m, gang_size=1, seed=6, utilization=0.3)
    gang20 = synth_arrays(n, m, gang_size=20, seed=7, utilization=0.6)
    gang20.node_idle *= np.float32(0.2)
    gang20.node_future[:] = gang20.node_idle
    ragged = synth_arrays(n, 2100, gang_size=g, seed=8, utilization=0.3,
                          node_pad_to=2100)
    # the second half of every other job takes the next job's group, a
    # sixth of the tasks are padding, minAvailable varies and pod caps bite
    rng = np.random.default_rng(9)
    mixed = synth_arrays(n, m, gang_size=g, seed=9, utilization=0.6)
    jobs = int((mixed.job_n_tasks > 0).sum())
    for j in range(0, jobs - 1, 2):
        s = mixed.job_task_start[j]
        mixed.task_group[s + g // 2:s + g] = mixed.task_group[s] + 1
    real = np.flatnonzero(mixed.task_valid)
    mixed.task_valid[rng.choice(real, len(real) // 6, replace=False)] = False
    mixed.job_min_available[:jobs] = rng.integers(1, g + 1, jobs)
    mixed.node_max_tasks[:] = rng.integers(0, 40, mixed.node_idle.shape[0])
    mixed.node_idle *= np.float32(0.2)
    mixed.node_future[:] = mixed.node_idle
    # neighbouring groups share a bucket, so a job's mates count into the
    # next job's pack row
    shared = synth_arrays(n, m, gang_size=g, seed=10, utilization=0.4)
    groups = np.arange(shared.group_req.shape[0])
    bucket = np.where(groups % 5 == 0, -1, (groups // 2) % 3)
    shared.task_bucket[:] = np.where(shared.task_valid,
                                     bucket[shared.task_group], -1)
    shared.group_pack_bonus[:] = rng.uniform(0.0, 8.0, groups.shape[0])
    # per-task domain slots over 8 zones: every gang rotating over them;
    # every other gang, with an all-false row for the last task of every
    # second such gang; with topology buckets; over tight capacity
    rotating = synth_arrays(n, m, gang_size=g, seed=11, utilization=0.3)
    unsat = synth_arrays(n, m, gang_size=g, seed=12, utilization=0.3)
    slot_buckets = synth_arrays(n, m, gang_size=g, seed=13, utilization=0.5)
    groups = np.arange(slot_buckets.group_req.shape[0])
    bucket = np.where(groups % 3 == 0, -1, groups % 5)
    slot_buckets.task_bucket[:] = np.where(
        slot_buckets.task_valid, bucket[slot_buckets.task_group], -1)
    slot_buckets.group_pack_bonus[:] = 5.0
    slot_tight = synth_arrays(n, m, gang_size=g, seed=14, utilization=0.6)
    slot_tight.node_idle *= np.float32(0.15)
    slot_tight.node_future[:] = slot_tight.node_idle
    return [("one_queue", one_q, False, True, None),
            ("four_queues", four_q, False, True, None),
            ("three_namespaces", three_ns, False, True, None),
            ("three_namespaces_live", three_ns, True, True, None),
            ("tight_capacity", tight, False, True, None),
            ("buckets_pipelined", packed, False, True, None),
            ("buckets_no_pipeline", packed, False, False, None),
            ("gang1", gang1, False, True, None),
            ("gang20", gang20, False, True, None),
            ("ragged_nodes", ragged, False, True, None),
            ("mixed_gangs", mixed, False, True, None),
            ("buckets_shared", shared, False, True, None),
            ("slots_rotating", rotating, False, True,
             zone_slots(rotating, 8, every=1, seed=11)),
            ("slots_all_false", unsat, False, True,
             zone_slots(unsat, 8, every=2, unsat_every=2, seed=12)),
            ("slots_buckets", slot_buckets, False, True,
             zone_slots(slot_buckets, 8, every=2, seed=13)),
            ("slots_tight", slot_tight, False, True,
             zone_slots(slot_tight, 8, every=2, seed=14))]


# the refresh causes (gang_allocate_chunked's counts) a mid case is built
# to reach
AIMS = {"gang20": ("in_job",), "mixed_gangs": ("forced", "in_job"),
        "buckets_shared": ("bucket_carried",), "slots_rotating": ("slot",),
        "slots_all_false": ("slot",), "slots_buckets": ("slot",),
        "slots_tight": ("slot",)}


def ptxas_usage(log: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads}} from the ptxas
    report of every instantiation: key R<R>_B<blocks> for the shared
    plan, with _global for the global plan; R "rt" is the runtime form
    (R > 16)."""
    usage, name = {}, None
    for text in log.splitlines():
        m = re.search(r"Function properties for (\S+)", text)
        if m:
            name = m.group(1)
            continue
        k = re.search(r"gang_allocate_kernelILi(\d+)ELi(\d+)ELb([01])E",
                      name or "")
        if k is None:
            continue
        r = k.group(1) if k.group(1) != "0" else "rt"
        key = f"R{r}_B{k.group(2)}" + ("_global" if k.group(3) == "1"
                                        else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      text)
        if m:
            usage.setdefault(key, {}).update(spill_stores=int(m.group(1)),
                                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", text)
        if m:
            usage.setdefault(key, {})["registers"] = int(m.group(1))
            name = None
    return usage


def launch_stats() -> dict:
    """What the kernel's last launch reported of itself, with its plan."""
    n, blocks, shared = gang_allocate_cuda.last_stats.tolist()
    plan = gang_allocate_cuda.last_plan
    return {"refreshes": n, "cluster_blocks": blocks,
            "shared_bytes_per_block": shared, "plan": plan.kind,
            "plan_flags": plan.flags}


def refreshes() -> int:
    """Table refreshes of the kernel's last launch."""
    return launch_stats()["refreshes"]


def cycle_store(case: str, seed: int) -> ObjectStore:
    """A store of MID's size for the cycle_vs_plain phase, built from a
    seed with the port's builders: 512 gangs of 8 whose requests vary by
    job over 2,048 nodes. ``four_queues``: queues of weights 1, 2, 4 and 1,
    the last capped, in three namespaces of weights 1, 2 and 4.
    ``tight``: small nodes that cannot hold every gang, a zone selector on
    a quarter of the jobs, a NoSchedule taint on a fifth of the nodes that
    a third of the jobs tolerate. ``constrained``: populate_store's nodes
    and gangs with the HEAVY constraint mix. ``nine_kinds``:
    populate_store's gangs with seven scalar resource kinds (R = 9) over
    256 nodes."""
    rng = np.random.default_rng(seed)
    n_nodes, n_jobs, gang = MID["n_nodes"], MID["n_tasks"] // 8, MID["gang"]
    store = ObjectStore()
    if case == "constrained":
        populate_store(store, n_nodes=n_nodes, n_jobs=n_jobs, gang_size=gang,
                       **HEAVY)
        return store
    if case == "nine_kinds":
        # cpu, memory and seven scalar kinds (R = 9), scarce enough on 256
        # nodes that they decide which gangs fit
        populate_store(store, n_nodes=256, n_jobs=n_jobs, gang_size=gang,
                       scalars=scalar_kinds(7))
        return store
    queues, namespaces = [("default", 1, None)], ["default"]
    if case == "four_queues":
        queues = [("q0", 1, None), ("q1", 2, None), ("q2", 4, None),
                  ("q3", 1, {"cpu": "1500", "memory": "3000Gi"})]
        namespaces = ["ns-a", "ns-b", "ns-c"]
        for ns, weight in zip(namespaces, (1, 2, 4)):
            store.create("resourcequotas", obj.ResourceQuota(
                metadata=obj.ObjectMeta(name=f"weight-{ns}", namespace=ns),
                hard={"namespace.weight": str(weight)}))
    for name, weight, cap in queues:
        q = tu.build_queue(name, weight=weight, capability=cap)
        q.metadata.creation_timestamp = 1.0
        store.create("queues", q)
    tight = case == "tight"
    for i in range(n_nodes):
        cpu = int(rng.integers(2, 7) if tight else rng.integers(4, 13))
        node = tu.build_node(
            f"node-{i:05d}", {"cpu": str(cpu), "memory": f"{4 * cpu}Gi",
                              "pods": "110"},
            labels={"zone": f"z{i % 3}", "rack": f"rack-{i % 32}"})
        if tight and i % 5 == 0:
            node.spec.taints = [obj.Taint(key="dedicated", value="batch",
                                          effect="NoSchedule")]
        node.metadata.creation_timestamp = 1.0
        store.create("nodes", node)
    for j in range(n_jobs):
        ns = namespaces[j % len(namespaces)]
        pg = tu.build_pod_group(f"pg-{j}", ns, queues[j % len(queues)][0],
                                gang, phase="Inqueue")
        pg.metadata.creation_timestamp = 10.0 + j
        store.create("podgroups", pg)
        cpu_m = int(rng.integers(500, 4001))
        mem_mi = int(rng.integers(512, 8193))
        for t in range(gang):
            pod = tu.build_pod(
                ns, f"job{j}-task{t}", "", "Pending",
                {"cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"},
                groupname=f"pg-{j}",
                selector={"zone": f"z{j % 3}"} if tight and j % 4 == 1
                else None)
            if tight and j % 3 == 0:
                pod.spec.tolerations = [obj.Toleration(
                    key="dedicated", value="batch", effect="NoSchedule")]
            pod.metadata.creation_timestamp = 10.0 + j
            store.create("pods", pod)
    return store


def cycle_outcome(store: ObjectStore):
    """(binds pod -> node, PodGroup phases, PodGroups carrying the
    Unschedulable condition) as read back from the store."""
    binds = {p.metadata.key(): p.spec.node_name for p in store.list("pods")
             if p.spec.node_name}
    pgs = store.list("podgroups")
    phases = {g.metadata.key(): g.status.phase for g in pgs}
    unschedulable = sum(
        any(c.type == "Unschedulable" and c.status == "True"
            for c in g.status.conditions) for g in pgs)
    return binds, phases, unschedulable


def check_binds(store: ObjectStore, ctx: str, drained=None) -> None:
    """The binds replay feasibly against every node's allocatable (cpu,
    memory and pod count), and every gang is all-or-nothing: a PodGroup
    has no bound pod or at least minMember, counting its pods in
    ``drained`` ((namespace, group) -> pods a plugin evicted from the
    running gang on purpose, as tdm's drain does, one at a time)."""
    alloc = {n.metadata.name: Resource.from_resource_list(
        n.status.allocatable) for n in store.list("nodes")}
    used = {name: Resource() for name in alloc}
    count = dict.fromkeys(alloc, 0)
    per_group = dict(drained or {})
    for p in store.list("pods"):
        if not p.spec.node_name:
            continue
        used[p.spec.node_name].add(p.resource_request())
        count[p.spec.node_name] += 1
        key = (p.metadata.namespace,
               p.metadata.annotations.get(obj.GROUP_NAME_ANNOTATION, ""))
        per_group[key] = per_group.get(key, 0) + 1
    for name, res in used.items():
        if not res.less_equal(alloc[name]) or \
                count[name] > alloc[name].max_task_num:
            fail(f"{ctx}: the binds on {name} exceed its allocatable")
    for g in store.list("podgroups"):
        n = per_group.get((g.metadata.namespace, g.metadata.name), 0)
        if 0 < n < g.spec.min_member:
            fail(f"{ctx}: gang {g.metadata.key()} bound {n} of "
                 f"{g.spec.min_member} pods")


def check_constraints(store: ObjectStore, ctx: str) -> dict:
    """Every spread gang's bound pods keep max_skew 1 over the zones, and
    every anti-affinity gang has at most one bound pod a zone; no pod of
    either is bound to a node without a zone. Returns the gangs checked."""
    zone = {n.metadata.name: n.metadata.labels.get(ZONE_KEY)
            for n in store.list("nodes")}
    zones = sorted({z for z in zone.values() if z is not None})
    gangs: dict = {}
    for p in store.list("pods"):
        aff = p.spec.affinity
        kind = "spread" if p.spec.topology_spread else \
            "anti" if aff is not None and aff.pod_anti_affinity is not None \
            else None
        if kind is None or not p.spec.node_name:
            continue
        key = (p.metadata.namespace,
               p.metadata.annotations.get(obj.GROUP_NAME_ANNOTATION, ""))
        counts = gangs.setdefault(key, (kind, {}))[1]
        z = zone[p.spec.node_name]
        counts[z] = counts.get(z, 0) + 1
    n = {"spread": 0, "anti": 0}
    for key, (kind, counts) in gangs.items():
        n[kind] += 1
        if None in counts:
            fail(f"{ctx}: {kind} gang {key} bound a pod to a node without "
                 f"a zone")
        per_zone = [counts.get(z, 0) for z in zones]
        if kind == "spread" and max(per_zone) - min(per_zone) > 1:
            fail(f"{ctx}: spread gang {key} breaks max_skew 1: {counts}")
        if kind == "anti" and max(per_zone) > 1:
            fail(f"{ctx}: anti-affinity gang {key} has two pods in a zone: "
                 f"{counts}")
    return {"spread_gangs": n["spread"], "anti_gangs": n["anti"]}


def timed(fn):
    """(result, ms) of fn() with CUDA events, synchronised."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def flush(cache, ctx: str) -> float:
    """Wait until the cache's executor has written what the cycle
    committed (binds, evictions, PodGroup statuses and their echoes);
    returns the wait in ms and fails when it does not drain."""
    t0 = time.perf_counter()
    if not cache.flush_executors(timeout=cycle_cmd.FLUSH_TIMEOUT_S):
        fail(f"{ctx}: the cache's executor did not drain in "
             f"{cycle_cmd.FLUSH_TIMEOUT_S:g} s")
    return (time.perf_counter() - t0) * 1000.0


def with_solver(conf: str, **args) -> str:
    """``conf`` with a solver section of ``args``."""
    lines = "\n".join(f'    {k}: "{v}"' for k, v in args.items())
    return conf + f"configurations:\n- name: solver\n  arguments:\n{lines}\n"


def expected_launches(places) -> list:
    """The kernel launches each place must have made, by its recorded
    prune outcome: two where the exhaustion guard discarded the reduced
    run (it, then the full-width run), else one (unpruned, a pre-kernel
    fallback, or the reduced run serving)."""
    return [2 if (pl["prune"] or {}).get("fallback") == "shortlist_exhausted"
            else 1 for pl in places]


def check_launches(ctx: str, launches: int, places, on_gpu: bool) -> None:
    """The launch count read around a cycle equals what its places'
    prune outcomes add up to (0 on the CPU), and so does each place's own
    count."""
    want = expected_launches(places)
    if [pl["launches"] for pl in places] != want or \
            launches != (sum(want) if on_gpu else 0):
        fail(f"{ctx}: {launches} kernel launches, places "
             f"{[pl['launches'] for pl in places]}, their prune outcomes "
             f"{[(pl['prune'] or {}).get('fallback') for pl in places]} "
             f"give {want}")


def prune_fields(places) -> dict:
    """What a cycle line prints of its places' pruning: each place's
    summary (``served``: the reduced run's placements were kept;
    ``fallback``: why not), the distillation's ms, the union width and
    the kernel's CUDA-event ms per launch."""
    pruned = [pl["prune"] or {} for pl in places]
    return {"prune": [pl["prune"] for pl in places],
            "distill_ms": [p.get("distill_ms") for p in pruned],
            "union": [p.get("union") for p in pruned],
            "launch_ms": [pl["launch_ms"] for pl in places]}


def place_prune(pl) -> dict:
    """The kernels line's prune entry for one cycle place: the union and
    its padded width, the launches the place made and the last one's
    table refreshes and the kernel's ms per launch, whether the reduced
    run served (else the fallback) and the distillation's ms."""
    p = pl["prune"] or {}
    return {"union": p.get("union"), "u_pad": p.get("u_pad"),
            "nodes": p.get("nodes"), "k_max": p.get("k_max"),
            "launches": pl["launches"], "refreshes": pl["launch"][0],
            "launch_ms": pl["launch_ms"], "served": p.get("served", False),
            "fallback": p.get("fallback"),
            "distill_ms": p.get("distill_ms")}


class ReducedTap:
    """While installed, keeps the inputs of every reduced-width launch
    DenseSolver.launch makes (a pruned place's gathered tensors, its
    weights and budgets) and, with ``full``, of every full-width launch
    too (copies of the snapshot's tensors and the mask as launched, taken
    before a later place can patch them), in launch order, so that the
    kernel can be held against its plain loop on exactly those inputs
    after the cycle. It launches nothing itself."""

    def __init__(self, full: bool = False):
        self.inputs = []
        self.full = full
        self._launch = DenseSolver.launch

    def __enter__(self):
        launch, inputs, full = self._launch, self.inputs, self.full

        def tapped(solver, gmask, allow_pipeline=True, ns_live=False,
                   arrays=None):
            if arrays is None and not full:
                return launch(solver, gmask, allow_pipeline, ns_live, arrays)
            cap = {"weights": solver.weights,
                   "deserved": solver.queue_deserved(),
                   "allow_pipeline": allow_pipeline, "ns_live": ns_live}
            if arrays is not None:
                cap.update(arrays=convert.as_tensors(arrays, solver.device),
                           gmask=gmask)
            out = launch(solver, gmask, allow_pipeline, ns_live, arrays)
            if arrays is None:
                # launch() materialized the snapshot's node tensors
                snap = convert.as_tensors(solver.arrays, solver.device)
                cap.update(arrays={k: v.clone() for k, v in snap.items()},
                           gmask=gmask.clone())
            inputs.append(cap)
            return out
        DenseSolver.launch = tapped
        return self

    def __exit__(self, *exc):
        DenseSolver.launch = self._launch


def cycle_vs_plain() -> None:
    """Phase 7: the cycle through the objects on the GPU against the same
    cycle with the plain loop on the CPU, at MID's size, in four cases;
    binds and PodGroup phases must be equal."""
    for case, seed, drf in (("one_queue", 1, ""),
                            ("four_queues", 2,
                             "\n    enableNamespaceOrder: true"),
                            ("tight", 3, ""), ("constrained", 4, ""),
                            ("nine_kinds", 5, "")):
        conf = CYCLE_CONF.format(drf=drf)
        res = {}
        for device in ("cuda", "cpu"):
            store = cycle_store(case, seed)
            sched = Scheduler(store, scheduler_conf=conf, device=device)
            sched.cache.run()
            launches0 = gang_allocate_cuda.launches
            t0 = time.perf_counter()
            sched.run_once()
            ms = (time.perf_counter() - t0) * 1000.0
            flush_ms = flush(sched.cache, f"cycle_vs_plain {case}")
            sched.cache.stop()
            res[device] = (cycle_outcome(store), ms,
                           gang_allocate_cuda.launches - launches0,
                           sched.last_cycle, flush_ms)
            check_binds(store, f"cycle_vs_plain {case} on {device}")
            if case == "constrained":
                gangs = check_constraints(
                    store, f"cycle_vs_plain {case} on {device}")
        (k_binds, k_phases, k_unsched), k_ms, k_launches, k_split, \
            k_flush = res["cuda"]
        (p_binds, p_phases, p_unsched), p_ms, p_launches, _, p_flush = \
            res["cpu"]
        check_launches(f"cycle_vs_plain {case} on the GPU", k_launches,
                       k_split["places"], True)
        check_launches(f"cycle_vs_plain {case} on the CPU", p_launches,
                       res["cpu"][3]["places"], False)
        diff = sum(k_binds.get(k) != p_binds.get(k)
                   for k in set(k_binds) | set(p_binds))
        phase_diff = sum(k_phases[k] != p_phases.get(k) for k in k_phases)
        if diff or phase_diff or k_unsched != p_unsched:
            fail(f"cycle_vs_plain {case}: {diff} binds and {phase_diff} "
                 f"PodGroup phases differ between the kernel's cycle and "
                 f"the plain loop's")
        committed = sum(v == "Running" for v in k_phases.values())
        if not k_binds or (case == "tight" and k_unsched == 0):
            fail(f"cycle_vs_plain {case}: {len(k_binds)} binds, "
                 f"{k_unsched} rolled-back gangs")
        slots = [pl["slots"] for pl in k_split["places"]]
        extra = {"R": [pl["R"] for pl in k_split["places"]],
                 "plan": [pl["plan"] for pl in k_split["places"]]}
        if case == "nine_kinds" and (set(extra["R"]) != {9}
                                     or k_unsched == 0):
            fail(f"cycle_vs_plain {case}: R {extra['R']}, {k_unsched} "
                 f"rolled-back gangs")
        if case == "constrained":
            if not gangs["spread_gangs"] or not gangs["anti_gangs"] \
                    or not max(slots):
                fail(f"cycle_vs_plain {case}: {gangs}, slots {slots}: the "
                     f"slot path was not taken")
            extra.update(gangs, slots=slots)
        line("cycle_vs_plain", case=case, pods=MID["n_tasks"],
             nodes=256 if case == "nine_kinds" else MID["n_nodes"],
             binds=len(k_binds),
             committed_gangs=committed, rolled_back_gangs=k_unsched,
             bind_mismatches=diff, phase_mismatches=phase_diff,
             kernel_launches=k_launches, cycle_ms=k_ms, plain_cycle_ms=p_ms,
             flush_ms=k_flush, plain_flush_ms=p_flush,
             kernel_ms=[pl["kernel_ms"] for pl in k_split["places"]],
             **extra)


def cycle(dev):
    """Phase 9: the port's main path through the objects at the north
    star's size, one cold cycle and one warm one on fresh stores, the
    launch count set to 0 just before each cycle and read just after.
    Returns (launches per cycle, the cycles' lines, the inputs of the
    warm cycle's reduced-width launches)."""
    cycles = []
    cycle_launches = []
    for i in range(2):          # one cold cycle, then a warm one
        with ReducedTap() as tap:
            gang_allocate_cuda.launches = 0
            r = cycle_cmd.run_cycle(FULL["n_tasks"], FULL["n_nodes"], 1, dev)
            cycle_launches.append(gang_allocate_cuda.launches)
        store = r.pop("store")
        if r["binds"] != FULL["n_tasks"] or \
                r["committed_gangs"] != FULL["n_tasks"] // FULL["gang"]:
            fail(f"cycle: {r['binds']} binds and {r['committed_gangs']} "
                 f"committed gangs")
        check_binds(store, "cycle")
        check_launches("cycle", cycle_launches[-1], r["places"], True)
        del store
        cycles.append(r)
        line("cycle", run="cold" if i == 0 else f"warm{i}",
             shape={"tasks": FULL["n_tasks"], "nodes": FULL["n_nodes"],
                    "gang": FULL["gang"]},
             kernel_launches=cycle_launches[-1], **prune_fields(r["places"]),
             **r)
    return cycle_launches, cycles, tap.inputs


def cycle_constrained(dev):
    """Phase 11: the slot path at the north star's size, populate_store
    with the HEAVY mix, one cold cycle and one warm one on fresh stores,
    the launch count set to 0 just before each cycle and read just after.
    Returns (launches per cycle, the cycles' results, the inputs of the
    warm cycle's reduced-width launches)."""
    cycles, launches = [], []
    for i in range(2):
        with ReducedTap() as tap:
            gang_allocate_cuda.launches = 0
            r = cycle_cmd.run_cycle(FULL["n_tasks"], FULL["n_nodes"], 1, dev,
                                    **HEAVY)
            launches.append(gang_allocate_cuda.launches)
        store = r.pop("store")
        if r["binds"] != FULL["n_tasks"] or \
                r["committed_gangs"] != FULL["n_tasks"] // FULL["gang"]:
            fail(f"cycle_constrained: {r['binds']} binds and "
                 f"{r['committed_gangs']} committed gangs")
        check_binds(store, "cycle_constrained")
        gangs = check_constraints(store, "cycle_constrained")
        check_launches("cycle_constrained", launches[-1], r["places"], True)
        if not r["places"][0]["slots"]:
            fail(f"cycle_constrained: slots "
                 f"{[pl['slots'] for pl in r['places']]}")
        del store
        cycles.append(r)
        line("cycle_constrained", run="cold" if i == 0 else f"warm{i}",
             shape={"tasks": FULL["n_tasks"], "nodes": FULL["n_nodes"],
                    "gang": FULL["gang"], **HEAVY},
             kernel_launches=launches[-1],
             refreshes=[pl["launch"][0] for pl in r["places"]],
             **gangs, **prune_fields(r["places"]), **r)
    return launches, cycles, tap.inputs


def hold_inputs(arrays, gmask, weights, deserved, kw, ctx, plain=None,
                done=None):
    """The kernel (a warm-up, then three timed runs) on one set of kernel
    inputs (``arrays`` with the mask ``gmask`` and the budgets
    ``deserved``), feasible and gang-atomic; with ``plain`` (a LatePlain)
    held exactly against its plain loop by plain.finish(), which updates
    the returned comparison and then calls ``done(res)``. Returns (the
    launch's report, the times and the bound of the work; the inputs as
    numpy; the kernel's ready)."""
    args = convert.args(arrays)
    names = list(convert.FIELDS)
    args[names.index("group_mask")] = gmask
    args[names.index("queue_deserved")] = deserved
    gang_allocate_cuda(*args, weights, **kw)                 # warm-up
    runs = [timed(lambda: gang_allocate_cuda(*args, weights, **kw))
            for _ in range(3)]
    got = runs[-1][0]
    stats = launch_stats()
    sa = type("Inputs", (), {k: to_np(v) for k, v in arrays.items()})
    a1 = to_np(got[0])
    if not replay_feasible(sa, a1, to_np(got[1])) or not gang_atomic(
            sa, a1, to_np(got[2]), to_np(got[3])):
        fail(f"{ctx}: the kernel's placements are infeasible or not "
             f"gang-atomic")
    res = {"placed": int((a1 >= 0).sum()), "plain_ms": None}
    if plain is not None:
        def held(cmp):
            res.update(cmp)
            if done is not None:
                done(res)
        plain.submit(ctx, sa, got, args, weights, kw, held)
    steps = int(sa.job_n_tasks.sum())
    N, R = sa.node_idle.shape
    slot_args = [kw[k] for k in ("task_slot", "slot_ok") if k in kw]
    bytes_ms, ops_ms, _ = bound(args, slot_args, got[:4],
                                stats["refreshes"], steps, N, R)
    res.update(kernel_ms=[ms for _, ms in runs], steps=steps,
               bytes_ms=bytes_ms, ops_ms=ops_ms, N=N, R=R, **stats)
    if "task_slot" in kw:
        if not in_slot_rows(a1, (sa.task_slot, sa.slot_ok)):
            fail(f"{ctx}: a task was placed outside its slot row")
        res["slots"] = int(sa.slot_ok.shape[0] - 1)
    return res, sa, to_np(got[2])


def distill_card_vs_cpu(narr, batch, dense, gmask, solver, ctx) -> dict:
    """ops/prune.distill on the card and on the CPU on one place's own
    inputs: the same union, feasible and kept counts and pre-kernel guard,
    coverage within 1e-6. Returns the card's summary and both times."""
    static = dense.arrays["group_static_score"]

    def run(*tensors):
        t0 = time.perf_counter()
        ctx = prune.distill(batch, narr, *tensors, solver.prune,
                            dedupe=solver._prune_dedupe_ok)
        return ctx, (time.perf_counter() - t0) * 1000.0
    run(gmask, static, dense.weights)                      # warm-up
    card, card_ms = run(gmask, static, dense.weights)
    host, host_ms = run(gmask.cpu(), static.cpu(), dense.weights.to("cpu"))
    cov_err = float(np.abs(card.coverage.astype(np.float64)
                           - host.coverage).max()) \
        if card.coverage.size else 0.0
    if not (np.array_equal(card.union, host.union)
            and np.array_equal(card.feasible, host.feasible)
            and np.array_equal(card.count, host.count)
            and card.pre_guard() == host.pre_guard()
            and card.k_max == host.k_max) or cov_err > 1e-6:
        fail(f"{ctx}: the distillation on the card and on the CPU differ: "
             f"{card.summary()} against {host.summary()}, coverage error "
             f"{cov_err}")
    return {"summary": card.summary(), "u_pad": card.u_pad,
            "pre_guard": card.pre_guard(), "ms": card_ms, "cpu_ms": host_ms,
            "coverage_max_abs_err": cov_err}


def cycle_inputs_vs_plain(dev, late, constraints=None, reduced=None
                          ) -> dict:
    """Phases 10 and 11: the kernel against its plain version on the
    cycle's own inputs at the north star's size: a fresh store as phase 9
    (``constraints``: phase 11, with that mix) builds it, one session on
    the GPU, enqueue, then the allocate action's phase-A batch encoded by
    the session's BatchSolver as place() encodes it; the kernel (three
    timed runs) and the plain loop (one) on those full-width tensors, held
    exactly, and on ``reduced`` (the inputs a warm cycle's pruned place
    launched on, captured by ReducedTap) when given; with ``reduced``
    the full-width inputs, which the cycle did not launch on, get the
    kernel alone (feasible and gang-atomic) and the plain loop runs on
    the reduced inputs only. The distillation runs
    on those inputs on the card and on the CPU and must agree. With slots,
    the kernel's refreshes must equal the rule's count."""
    from volcano_tpu_torch.actions.allocate import AllocateAction
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.framework import (get_action, open_session,
                                             parse_scheduler_conf)
    store = ObjectStore()
    populate_store(store, n_nodes=FULL["n_nodes"],
                   n_jobs=FULL["n_tasks"] // FULL["gang"],
                   gang_size=FULL["gang"], **(constraints or {}))
    cache = SchedulerCache(store)
    cache.run()
    conf = parse_scheduler_conf(cycle_cmd.CONF)
    ssn = open_session(cache, conf.tiers, conf.configurations, device=dev)
    get_action("enqueue").execute(ssn)
    act = AllocateAction()
    jobs = []
    for job in act._ordered_jobs(ssn):
        tasks = act._pending_tasks(ssn, job)
        if tasks:
            need = max(0, job.min_available - job.ready_task_num())
            jobs.append((job, tasks[:need]))
    narr, batch, dense = ssn.solver._context(jobs, dev, slot_tensors=True)
    dense.materialize_nodes()
    gmask = dense.static_mask()
    slot_kw = convert.slot_kwargs(dense.arrays)
    if bool(constraints) != bool(slot_kw):
        fail(f"cycle inputs {constraints}: slot inputs {sorted(slot_kw)}")
    ctx = "cycle constrained inputs" if constraints else "cycle inputs"
    kw = dict(ns_live=ssn.solver._ns_live, **slot_kw)
    N, R = dense.arrays["node_idle"].shape
    shape = {"T": dense.arrays["task_group"].shape[0],
             "G": dense.arrays["group_req"].shape[0], "N": N, "R": R}
    case = "cycle_constrained_inputs" if constraints else "cycle_inputs"

    def print_line(r):
        line("kernel_vs_plain", case=case, shape=shape, **r)
    # the plain loop runs on the inputs the warm cycle launched on: the
    # reduced ones where its place pruned and served, else these
    res, sa, ready = hold_inputs(dense.arrays, gmask, dense.weights,
                                 dense.queue_deserved(), kw, ctx,
                                 plain=None if reduced else late,
                                 done=print_line)
    if slot_kw:
        if not ready[:len(jobs)].all():
            fail(f"{ctx}: a gang was not committed")
        res["rule_refreshes"] = allocate.rule_refreshes(
            sa.task_group, sa.task_bucket, sa.task_slot, sa.job_task_start,
            sa.job_n_tasks)
        if res["rule_refreshes"] != res["refreshes"]:
            fail(f"{ctx}: the kernel refreshed {res['refreshes']} times, "
                 f"its rule gives {res['rule_refreshes']}")
    res["distill"] = distill_card_vs_cpu(narr, batch, dense, gmask,
                                         ssn.solver, ctx)
    if reduced:
        print_line(res)
        cap = reduced[-1]
        rkw = dict(allow_pipeline=cap["allow_pipeline"],
                   ns_live=cap["ns_live"],
                   **convert.slot_kwargs(cap["arrays"]))
        rctx = ctx.replace("inputs", "reduced inputs")
        rshape = {"T": cap["arrays"]["task_group"].shape[0],
                  "G": cap["arrays"]["group_req"].shape[0],
                  "N": cap["arrays"]["node_idle"].shape[0], "R": R}

        def print_reduced(r):
            line("kernel_vs_plain", case=rctx.replace(" ", "_"),
                 shape=rshape, **r)
        red, _, _ = hold_inputs(cap["arrays"], cap["gmask"], cap["weights"],
                                cap["deserved"], rkw, rctx, plain=late,
                                done=print_reduced)
        res["reduced"] = red
    cache.stop()
    return res


# ---- candidate pruning ------------------------------------------------------

# the prune summary's fields that must be equal between the card and the CPU
# (coverage to 1e-6)
PRUNE_EXACT = ("level", "k", "k_max", "pairs", "union", "nodes",
               "truncated_pairs", "fallback", "fallback_pairs", "served",
               "u_pad")


def synth_store(n_nodes: int, n_jobs: int, gang: int, **kw) -> ObjectStore:
    store = ObjectStore()
    populate_store(store, n_nodes=n_nodes, n_jobs=n_jobs, gang_size=gang,
                   **kw)
    return store


def prune_cases() -> dict:
    """name -> (store builder, scheduler conf or None for the default, the
    fallback the first pruned place must end in). The reference's probe
    shape under the default conf (auto mode: 4,096 nodes engage it);
    forced pruning at MID's 2,048 nodes on populate_store's uniform fleet
    and on the constrained mix; k = 1 over identical nodes that each hold
    one pod (the reduced run places one gang and the exhaustion guard
    discards it); k = 1 over cycle_store's nodes of varied sizes with a
    0.99 coverage floor (the pre-kernel guard)."""
    base = CYCLE_CONF.format(drf="")
    k1 = {"prune.enable": "true", "prune.k": 1, "prune.demand_aware": "off"}
    return {
        "probe_default_conf": (lambda: synth_store(4096, 600, 8), None,
                               None),
        "uniform_forced": (
            lambda: synth_store(MID["n_nodes"], MID["n_tasks"] // 8, 8),
            with_solver(base, **{"prune.enable": "true"}), None),
        "constrained_forced": (
            lambda: cycle_store("constrained", 4),
            with_solver(base, **{"prune.enable": "true"}), None),
        "tight_exhausted": (
            lambda: synth_store(MID["n_nodes"], 1024, 1, cpu_req="40"),
            with_solver(base, **k1, **{"prune.coverage_floor": 0.0}),
            "shortlist_exhausted"),
        "skewed_low_coverage": (
            lambda: cycle_store("one_queue", 5),
            with_solver(base, **k1, **{"prune.coverage_floor": 0.99}),
            "low_coverage"),
    }


def prune_vs_plain() -> None:
    """Phase 8: pruned cycles on the GPU against the same cycles on the
    CPU (the plain loop), each on a fresh store from one seeded builder:
    binds, PodGroup phases and every field of each place's prune summary
    must be equal (coverage within 1e-6), each case must end in the path
    it is built for, and the launches must follow each place's outcome."""
    for case, (build, conf, want) in prune_cases().items():
        res = {}
        for device in ("cuda", "cpu"):
            store = build()
            sched = Scheduler(store, scheduler_conf=conf, device=device)
            sched.cache.run()
            gang_allocate_cuda.launches = 0
            t0 = time.perf_counter()
            sched.run_once()
            ms = (time.perf_counter() - t0) * 1000.0
            flush_ms = flush(sched.cache, f"prune_vs_plain {case}")
            sched.cache.stop()
            places = sched.last_cycle["places"]
            check_launches(f"prune_vs_plain {case} on {device}",
                           gang_allocate_cuda.launches, places,
                           device == "cuda")
            check_binds(store, f"prune_vs_plain {case} on {device}")
            res[device] = (cycle_outcome(store), places, ms, flush_ms)
        (k_binds, k_phases, k_unsched), k_places, k_ms, k_flush = res["cuda"]
        (p_binds, p_phases, p_unsched), p_places, p_ms, p_flush = res["cpu"]
        diff = sum(k_binds.get(k) != p_binds.get(k)
                   for k in set(k_binds) | set(p_binds))
        phase_diff = sum(k_phases[k] != p_phases.get(k) for k in k_phases)
        k_sum = [pl["prune"] for pl in k_places]
        p_sum = [pl["prune"] for pl in p_places]
        summary_diff = [
            (a, b) for a, b in zip(k_sum, p_sum)
            if (a is None) != (b is None) or a is not None and (
                any(a[f] != b[f] for f in PRUNE_EXACT)
                # coverage is rounded to 6 decimals in the summary
                or round(abs(a["coverage_min"] - b["coverage_min"]), 9) > 1e-6
                or round(abs(a["coverage_mean"] - b["coverage_mean"]), 9)
                > 1e-6)]
        if diff or phase_diff or k_unsched != p_unsched or summary_diff \
                or len(k_sum) != len(p_sum):
            fail(f"prune_vs_plain {case}: {diff} binds, {phase_diff} "
                 f"phases, prune summaries {summary_diff or (k_sum, p_sum)} "
                 f"differ between the GPU cycle and the CPU's")
        pruned = [x for x in k_sum if x is not None]
        if not k_binds or not pruned or pruned[0]["fallback"] != want:
            fail(f"prune_vs_plain {case}: {len(k_binds)} binds, prune "
                 f"{pruned}: the case did not end in fallback {want}")
        line("prune_vs_plain", case=case, binds=len(k_binds),
             bind_mismatches=diff, phase_mismatches=phase_diff,
             rolled_back_gangs=k_unsched, cycle_ms=k_ms, plain_cycle_ms=p_ms,
             flush_ms=k_flush, plain_flush_ms=p_flush,
             kernel_launches=[pl["launches"] for pl in k_places],
             plain_distill_ms=[(pl["prune"] or {}).get("distill_ms")
                               for pl in p_places],
             **prune_fields(k_places))


# ---- the preempt and reclaim paths ----------------------------------------

# the reference's victim-selection A/B conf (bench.py:538-547) over the
# whole cycle: no drf, so the vectorized path selects the victims
ELASTIC_PREEMPT_CONF = """
actions: "enqueue, allocate, preempt, backfill"
tiers:
- plugins:
  - name: priority
  - name: conformance
  - name: gang
- plugins:
  - name: predicates
  - name: nodeorder
"""
WALK_OFF = """
configurations:
- name: solver
  arguments:
    victims.kernel: "off"
"""
# (action, elastic shape, conf, the victim-selection path it must take)
VICTIM_CASES = {
    "preempt_walk": ("preempt", False, cycle_cmd.PREEMPT_CONF, "python"),
    "preempt_vectorized": ("preempt", True, ELASTIC_PREEMPT_CONF, "kernel"),
    "reclaim_vectorized": ("reclaim", False, cycle_cmd.RECLAIM_CONF,
                           "kernel"),
    "reclaim_walk": ("reclaim", False, cycle_cmd.RECLAIM_CONF + WALK_OFF,
                     "python"),
}
# the reference harness's shapes (bench_suite.py config 4 and
# config_reclaim): victim gangs fill the nodes, half as many gangs wait
VICTIM_FULL = dict(n_nodes=10_000, n_victim=1_250, n_pending=625)
VICTIM_MID = dict(n_nodes=2_048, n_victim=256, n_pending=128)


def victim_store(action: str, elastic: bool, size: dict) -> ObjectStore:
    store = ObjectStore()
    if action == "preempt":
        populate_preempt_store(store, n_nodes=size["n_nodes"],
                               n_low=size["n_victim"],
                               n_high=size["n_pending"], elastic=elastic)
    else:
        populate_reclaim_store(store, n_nodes=size["n_nodes"],
                               n_running=size["n_victim"],
                               n_pending=size["n_pending"])
    return store


def pod_facts(store: ObjectStore) -> dict:
    """pod key -> (node, request, group key) as the store holds them."""
    return {p.metadata.key(): (
        p.spec.node_name, p.resource_request(),
        f"{p.metadata.namespace}/"
        f"{p.metadata.annotations.get(obj.GROUP_NAME_ANNOTATION, '')}")
        for p in store.list("pods")}


def check_victim_cycle(store: ObjectStore, before: dict, evicted, pipelined,
                       action: str, ctx: str) -> None:
    """One preempt or reclaim cycle's result against the store before it
    (``before``: pod_facts) and after it. Fails on a pipelined task that
    does not fit its node's future idle once the victims are released
    (allocatable minus what stays bound there), on a preempt victim not of
    strictly lower priority than every task pipelined onto its node, on a
    reclaim victim not of another, reclaimable queue, and on a gang that
    had nothing bound and now has fewer than minMember pods bound."""
    pcs = {c.metadata.name: c.value for c in store.list("priorityclasses")}
    pgs = {g.metadata.key(): g for g in store.list("podgroups")}
    queues = {q.metadata.name: q for q in store.list("queues")}
    after = pod_facts(store)
    alloc = {n.metadata.name: Resource.from_resource_list(
        n.status.allocatable) for n in store.list("nodes")}
    bound = {name: Resource() for name in alloc}
    for node, req, _ in after.values():
        if node:
            bound[node].add(req)
    want = {}
    for key, node in pipelined.items():
        want.setdefault(node, Resource()).add(before[key][1])
    for node, need in want.items():
        free = alloc[node].clone().sub(bound[node])
        if not need.less_equal(free):
            fail(f"{ctx}: the tasks pipelined onto {node} do not fit its "
                 f"future idle once its victims are released")

    def prio(group):
        return pcs.get(pgs[group].spec.priority_class_name, 0)

    on_node = {}
    for key, node in pipelined.items():
        on_node.setdefault(node, []).append(before[key][2])
    claimer_queues = {pgs[before[k][2]].spec.queue for k in pipelined}
    for key in evicted:
        node, _, group = before[key]
        if key in after:
            fail(f"{ctx}: evicted pod {key} is still in the store")
        if action == "preempt":
            mates = on_node.get(node, [])
            if not mates or any(prio(group) >= prio(g) for g in mates):
                fail(f"{ctx}: victim {key} is not of strictly lower "
                     f"priority than the tasks pipelined onto {node}")
        else:
            q = pgs[group].spec.queue
            if not queues[q].spec.reclaimable or q in claimer_queues:
                fail(f"{ctx}: victim {key} of queue {q} is not of another, "
                     f"reclaimable queue")
    n_before, n_after = {}, {}
    for facts, counts in ((before, n_before), (after, n_after)):
        for node, _, group in facts.values():
            if node:
                counts[group] = counts.get(group, 0) + 1
    for group, pg in pgs.items():
        n = n_after.get(group, 0)
        if not n_before.get(group) and 0 < n < pg.spec.min_member:
            fail(f"{ctx}: gang {group} bound {n} of {pg.spec.min_member}")


def victim_cycles(case: str, size: dict, device: str, cycles: int) -> dict:
    """``cycles`` cycles of a VICTIM_CASES case on one fresh store with
    ``device``, each checked by check_victim_cycle, with the launch count
    set to 0 just before each cycle and read just after. Returns the
    populate and sync seconds and, per cycle, the evicted keys, the
    pipelined map, binds, phases, split, launches, wall ms and (on the
    GPU) peak device memory."""
    from volcano_tpu_torch.cache import SchedulerCache
    action, elastic, conf, _ = VICTIM_CASES[case]
    t0 = time.perf_counter()
    store = victim_store(action, elastic, size)
    t1 = time.perf_counter()
    evictor = tu.FakeEvictor(store)
    cache = SchedulerCache(store, evictor=evictor)
    cache.run()
    t2 = time.perf_counter()
    sched = Scheduler(store, scheduler_conf=conf, cache=cache, device=device)
    out = {"populate_s": t1 - t0, "sync_s": t2 - t1, "cycles": []}
    on_gpu = device == "cuda"
    for c in range(cycles):
        before = pod_facts(store)
        n0 = len(evictor.evicts)
        if on_gpu:
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        gang_allocate_cuda.launches = 0
        t = time.perf_counter()
        sched.run_once()
        if on_gpu:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1000.0
        launches = gang_allocate_cuda.launches
        flush_ms = flush(cache, f"{case} cycle {c + 1} on {device}")
        binds, phases, _ = cycle_outcome(store)
        r = {"evicted": evictor.evicts[n0:],
             "pipelined": dict(sched.last_pipelined), "binds": binds,
             "phases": phases, "split": sched.last_cycle,
             "launches": launches, "wall_ms": wall_ms, "flush_ms": flush_ms}
        if on_gpu:
            r["peak_device_bytes"] = torch.cuda.max_memory_allocated() \
                - resident
        check_victim_cycle(store, before, r["evicted"], r["pipelined"],
                           action, f"{case} cycle {c + 1} on {device}")
        out["cycles"].append(r)
    cache.stop()
    return out


def victim_mismatches(a: dict, b: dict) -> dict:
    """Evictions (in order), pipelines, binds and phases that differ
    between two cycles' results."""
    return {
        "eviction_mismatches": sum(
            x != y for x, y in zip(a["evicted"], b["evicted"]))
        + abs(len(a["evicted"]) - len(b["evicted"])),
        "pipeline_mismatches": sum(
            a["pipelined"].get(k) != b["pipelined"].get(k)
            for k in set(a["pipelined"]) | set(b["pipelined"])),
        "bind_mismatches": sum(a["binds"].get(k) != b["binds"].get(k)
                               for k in set(a["binds"]) | set(b["binds"])),
        "phase_mismatches": sum(a["phases"][k] != b["phases"].get(k)
                                for k in a["phases"])}


def victim_summary(r: dict) -> dict:
    """What a victim cycle's line prints of its split."""
    s = r["split"]
    keep = ("cycle_ms", "snapshot_ms", "open_session_ms", "enqueue_ms",
            "allocate_ms", "preempt_ms", "reclaim_ms", "backfill_ms",
            "close_session_ms", "allocate.commit_ms", "pipelined",
            "victim_runs")
    return {"evictions": len(r["evicted"]), "wall_ms": r["wall_ms"],
            "flush_ms": r["flush_ms"], "kernel_launches": r["launches"],
            "kernel_ms": [pl["kernel_ms"] for pl in s["places"]],
            **prune_fields(s["places"]),
            "binds": len(r["binds"]),
            **{k: s[k] for k in keep if k in s},
            **({"peak_device_bytes": r["peak_device_bytes"]}
               if "peak_device_bytes" in r else {})}


def victims_vs_plain() -> None:
    """Phase 12: the four VICTIM_CASES at VICTIM_MID's size, two cycles on
    one store with device="cuda" against the same two with device="cpu"
    (the plain loop); evictions, pipelines, cycle-2 binds and phases must
    be equal, and the cycle must take its case's victim-selection path."""
    for case, (action, _, _, path) in VICTIM_CASES.items():
        gpu = victim_cycles(case, VICTIM_MID, "cuda", 2)
        cpu = victim_cycles(case, VICTIM_MID, "cpu", 2)
        diffs = [victim_mismatches(g, c)
                 for g, c in zip(gpu["cycles"], cpu["cycles"])]
        first = gpu["cycles"][0]
        runs = first["split"]["victim_runs"]
        if any(any(d.values()) for d in diffs):
            fail(f"victims_vs_plain {case}: the GPU cycles and the plain "
                 f"loop's differ: {diffs}")
        if not first["evicted"] or not runs.get(path) or \
                sum(runs.values()) != runs[path]:
            fail(f"victims_vs_plain {case}: {len(first['evicted'])} "
                 f"evictions, victim-selection runs {runs}")
        if any(r["launches"] < 1 for r in gpu["cycles"]):
            fail(f"victims_vs_plain {case}: kernel launches "
                 f"{[r['launches'] for r in gpu['cycles']]} on the GPU")
        for device, out in (("GPU", gpu), ("CPU", cpu)):
            for c, r in enumerate(out["cycles"]):
                check_launches(f"victims_vs_plain {case} cycle {c + 1} on "
                               f"the {device}", r["launches"],
                               r["split"]["places"], device == "GPU")
        line("victims_vs_plain", case=case, action=action, **VICTIM_MID,
             mismatches=diffs,
             evictions=[len(r["evicted"]) for r in gpu["cycles"]],
             pipelined=[len(r["pipelined"]) for r in gpu["cycles"]],
             cycle2_binds=len(gpu["cycles"][1]["binds"]),
             victim_runs=[r["split"]["victim_runs"] for r in gpu["cycles"]],
             cycle_ms=[r["wall_ms"] for r in gpu["cycles"]],
             plain_cycle_ms=[r["wall_ms"] for r in cpu["cycles"]])


def victim_cycle(action: str) -> dict:
    """Phases 13 and 14: the preempt or reclaim path at the reference's
    full size (VICTIM_FULL), on fresh stores one cold and one warm GPU
    cycle and one CPU (plain loop) cycle, the last held equal to the warm
    one. Returns the warm cycle's result."""
    case = "preempt_walk" if action == "preempt" else "reclaim_vectorized"
    runs = {}
    for run, device in (("cold", "cuda"), ("warm", "cuda"), ("plain", "cpu")):
        out = victim_cycles(case, VICTIM_FULL, device, 1)
        r = out["cycles"][0]
        runs[run] = r
        if not r["evicted"]:
            fail(f"{action}_cycle {run}: nothing was evicted")
        if len(r["split"]["places"]) != 1:
            fail(f"{action}_cycle {run}: {len(r['split']['places'])} "
                 f"placements")
        check_launches(f"{action}_cycle {run}", r["launches"],
                       r["split"]["places"], device == "cuda")
        extra = {}
        if run == "plain":
            extra = victim_mismatches(runs["warm"], r)
            if any(extra.values()):
                fail(f"{action}_cycle: the warm GPU cycle and the plain "
                     f"loop's differ: {extra}")
        line(f"{action}_cycle", run=run, device=device, case=case,
             shape=VICTIM_FULL, populate_s=out["populate_s"],
             sync_s=out["sync_s"], **victim_summary(r), **extra)
    return runs["warm"]


def prefix_inputs(dev) -> dict:
    """The preempt path's own victim tensors at VICTIM_FULL's size: one
    session on a fresh preemption store, enqueue and allocate, then the
    preempt action's PreemptContext over every preemptor task: req [B, R]
    and node_ok [B, N] per task, future idle, the candidates packed per
    node (V = 1), eps, and the score row."""
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.framework import (get_action, open_session,
                                             parse_scheduler_conf)
    from volcano_tpu_torch.framework.victims import PreemptContext
    from volcano_tpu_torch.models.job_info import TaskStatus
    from volcano_tpu_torch.ops.preempt import pack_node_major
    from volcano_tpu_torch.ops.score import host_node_score
    store = victim_store("preempt", False, VICTIM_FULL)
    cache = SchedulerCache(store)
    cache.run()
    conf = parse_scheduler_conf(cycle_cmd.PREEMPT_CONF)
    ssn = open_session(cache, conf.tiers, conf.configurations, device=dev)
    for name in ("enqueue", "allocate"):
        get_action(name).execute(ssn)
    jobs = [(job, list(job.task_status_index.get(TaskStatus.Pending,
                                                 {}).values()))
            for job in ssn.jobs.values()]
    ctx = PreemptContext(ssn, [(j, ts) for j, ts in jobs if ts])
    n = len(ctx.narr.names)
    g = ctx.batch.task_group[:len(ctx.batch.tasks)]
    pods_ok = (ctx.max_tasks[:n] == 0) | (ctx.n_tasks[:n] < ctx.max_tasks[:n])
    vres, vvalid, _ = pack_node_major(ctx.victims.node_of, ctx.victims.res, n)
    req = ctx.batch.group_req[g]
    score = host_node_score(req[0], ctx.idle, ctx.alloc, ctx.weights,
                            ctx.static[g[0]])[:n]
    flush(cache, "victim_prefix inputs")
    cache.stop()
    return {"req": req, "node_ok": ctx.gmask[g][:, :n] & pods_ok[None],
            "base": ctx.future[:n], "vres": vres, "vvalid": vvalid,
            "eps": ctx.eps, "score": score.astype(np.float32)}


def seeded_prefix_inputs(b: int, n: int, v: int, r: int, seed: int) -> dict:
    """Seeded integer-valued requests and victims (milli-cpu and MiB are
    integers, so every sum is exact in float32 in any order)."""
    rng = np.random.default_rng(seed)
    return {"req": rng.integers(0, 9, (b, r)).astype(np.float32),
            "node_ok": rng.uniform(size=(b, n)) < 0.8,
            "base": rng.integers(0, 4, (n, r)).astype(np.float32),
            "vres": rng.integers(0, 5, (n, v, r)).astype(np.float32),
            "vvalid": rng.uniform(size=(n, v)) < 0.7,
            "eps": np.full(r, 0.1, np.float32),
            "score": rng.choice([1.0, 2.0, 3.0], n).astype(np.float32)}


def prefix_bound(x: dict, out_bytes: int) -> tuple:
    """(bytes_ms, ops_ms): the inputs read once and the [B, N] results
    (``out_bytes`` a pair: feasible and covered 1, n_evict 4) written once
    over HBM's rate; a compare and an AND for every (task, node, prefix,
    resource) over the float32 peak."""
    b, n = x["node_ok"].shape
    _, v, r = x["vres"].shape
    nbytes = sum(a.nbytes for k, a in x.items() if k != "score") \
        + out_bytes * b * n
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            2 * b * n * (v + 1) * r / FP32_OPS_PER_S * 1e3)


def victim_prefix_phase(dev) -> dict:
    """Phase 15: the batched prefix functions of ops/preempt.py at 5,000
    preemptors x 10,000 nodes on the preempt path's own tensors (V = 1)
    and on a seeded V = 8, R = 2 case, on the card (a warm-up, then three
    timed runs) and on the CPU; feasible, n_evict, covered and
    pick_best_node must be equal."""
    from volcano_tpu_torch.ops import preempt as pre
    out = {}
    for case, x in (("preempt_path", prefix_inputs(dev)),
                    ("seeded_v8", seeded_prefix_inputs(
                        5_000, 10_000, 8, 2, seed=7))):
        args = [x[k] for k in ("req", "node_ok", "base", "vres", "vvalid",
                               "eps")]
        res = {}
        for fn_name, fn, out_bytes in (("victim_prefix_batch",
                                        pre.victim_prefix_batch, 5),
                                       ("reclaim_prefix_batch",
                                        pre.reclaim_prefix_batch, 6)):
            targs = [torch.as_tensor(a).to(dev) for a in args]
            fn(*targs, device=dev)                       # warm-up
            runs = [timed(lambda: fn(*targs, device=dev)) for _ in range(3)]
            got = runs[-1][0]
            t0 = time.perf_counter()
            want = fn(*args, device="cpu")
            cpu_s = time.perf_counter() - t0
            score = torch.as_tensor(x["score"])
            best_g = pre.pick_best_node(got[0], score.to(dev))
            best_w = pre.pick_best_node(want[0], score)
            mism = {name: int((to_np(a) != b.numpy()).sum())
                    for name, a, b in zip(("feasible", "n_evict", "covered"),
                                          got, want)}
            mism["pick_best_node"] = int((to_np(best_g)
                                          != best_w.numpy()).sum())
            if any(mism.values()):
                fail(f"victim_prefix {case} {fn_name}: the card and the CPU "
                     f"differ: {mism}")
            bytes_ms, ops_ms = prefix_bound(x, out_bytes)
            res[fn_name] = {
                "ms": [ms for _, ms in runs], "cpu_ms": cpu_s * 1e3,
                "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "feasible_pairs": int(want[0].sum()),
                "mismatches": mism}
        b, n = x["node_ok"].shape
        line("victim_prefix", case=case, B=b, N=n, V=x["vres"].shape[1],
             R=x["vres"].shape[2], **res)
        out[case] = res
    return out


def model_refreshes(arrays: dict, ns_live: bool, allow_pipeline: bool):
    """The plain model's table refreshes by cause
    (ops/allocate.py:gang_allocate_chunked) on the host's CPU, in a worker
    process. Its decisions are the plain loop's, which rounds alike on the
    CPU and the card, so the counts are those of the model on the card."""
    torch.set_num_threads(1)
    t, _ = convert.from_reference(arrays, None, "cpu")
    w = ScoreWeights.make(t["node_idle"].shape[1], binpack=1.0)
    return allocate.gang_allocate_chunked(
        *convert.args(t), w, ns_live=ns_live, allow_pipeline=allow_pipeline,
        **convert.slot_kwargs(t))[5]


def plain_on_cpu(arrays: dict, weights: dict, kw: dict) -> dict:
    """The plain loop (ops/allocate.py:gang_allocate) on one set of kernel
    inputs (``arrays``: field -> numpy, ``weights``: ScoreWeights field ->
    numpy, ``kw``: its keyword options) on the host's CPU, in a worker
    process, while the card runs the script's later phases. It rounds
    alike on the CPU and on the card (IEEE float32, one rounding per
    operation, its sums in a fixed order), as cycle_vs_plain and the
    victim cells' CPU cycles hold the kernel against it. Returns its
    outputs as numpy and its wall ms."""
    torch.set_num_threads(2)
    t, w = convert.from_reference(arrays, weights, "cpu")
    t0 = time.perf_counter()
    assign, pipelined, ready, kept, state = allocate.gang_allocate(
        *convert.args(t), w, **kw, **convert.slot_kwargs(t))
    return {"out": [x.numpy() for x in (assign, pipelined, ready, kept,
                                        state.idle, state.future)],
            "plain_ms": (time.perf_counter() - t0) * 1000.0}


def plain_result(res: dict):
    """plain_on_cpu's outputs in the shape compare() reads."""
    assign, pipelined, ready, kept, idle, future = (
        torch.from_numpy(x) for x in res["out"])
    return (assign, pipelined, ready, kept,
            types.SimpleNamespace(idle=idle, future=future))


class LatePlain:
    """The plain loop on the full-size inputs (the main path's, and those
    the warm cycles launched on), run by LATE_WORKERS worker processes on
    the host's CPU while the card runs the later phases; ``finish`` holds
    each kernel result against its plain result exactly (compare()) and
    hands the comparison to the submitter's callback. The workers are
    stopped by ``finish`` or ``close``."""

    def __init__(self):
        self.pool = concurrent.futures.ProcessPoolExecutor(
            LATE_WORKERS, mp_context=multiprocessing.get_context("spawn"))
        self.jobs = []

    def submit(self, ctx, sa, got, args, weights, kw, done) -> None:
        """Hold ``got`` (the kernel's outputs on ``args``, the 28 inputs,
        with ``weights`` and keyword options ``kw``) later; ``done(res)``
        gets compare()'s result with plain_ms and max_abs_err."""
        arrays = {name: to_np(x) for name, x in zip(convert.FIELDS, args)}
        kw = dict(kw)
        for name in convert.SLOT_FIELDS:
            if name in kw:
                arrays[name] = to_np(kw.pop(name))
        w = {f: to_np(getattr(weights, f)) for f in ScoreWeights._fields}
        self.jobs.append((ctx, sa, got, done, self.pool.submit(
            plain_on_cpu, arrays, w, kw)))

    def finish(self) -> None:
        try:
            for ctx, sa, got, done, fut in self.jobs:
                plain = fut.result()
                want = plain_result(plain)
                res = compare(sa, got, want, ctx)
                res["plain_ms"] = plain["plain_ms"]
                res["plain_device"] = "cpu"
                res["max_abs_err"] = max(res["state_max_abs_err"], float(
                    np.abs(to_np(got[0]).astype(np.float64)
                           - to_np(want[0])).max()))
                done(res)
        finally:
            self.close()

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


def kernel_vs_plain_mid(dev) -> dict:
    """Phase 3: the kernel against the plain loop and its refreshes
    against the plain model's, in every mid case. The model runs in
    MODEL_WORKERS spawned processes on the host's CPU meanwhile; all of
    them are stopped before this returns. Returns {case: results}."""
    cases = []
    for case, sa, ns_live, pipe, slots in mid_cases():
        arrays = sa.as_dict()
        if slots is not None:
            arrays.update(task_slot=slots[0], slot_ok=slots[1])
        cases.append((case, sa, arrays, ns_live, pipe, slots))
    pool = concurrent.futures.ProcessPoolExecutor(
        MODEL_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        models = {case: pool.submit(model_refreshes, arrays, ns_live, pipe)
                  for case, _, arrays, ns_live, pipe, _ in cases}
        return {case: kernel_vs_plain_case(dev, case, sa, arrays, ns_live,
                                           pipe, slots, models[case])
                for case, sa, arrays, ns_live, pipe, slots in cases}
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def kernel_vs_plain_case(dev, case, sa, arrays, ns_live, pipe, slots,
                         model) -> dict:
    """One mid case of phase 3 (``model``: the future of its refresh
    counts by cause)."""
    t, _ = convert.from_reference(arrays, None, dev)
    w = ScoreWeights.make(sa.group_req.shape[1], binpack=1.0, device=dev)
    args = convert.args(t)
    opts = dict(ns_live=ns_live, allow_pipeline=pipe)
    kw = dict(opts, **convert.slot_kwargs(t))
    gang_allocate_cuda(*args, w, **kw)                # warm-up
    got, ms = timed(lambda: gang_allocate_cuda(*args, w, **kw))
    stats = launch_stats()
    want, plain_ms = timed(lambda: allocate.gang_allocate(*args, w, **kw))
    res = compare(sa, got, want, case)
    if not in_slot_rows(to_np(got[0]), slots):
        fail(f"{case}: a task was placed outside its slot row")
    # the plain model of the kernel's table refreshes by the same rule
    causes = model.result()
    if causes["total"] != stats["refreshes"]:
        fail(f"{case}: the kernel refreshed its table {stats['refreshes']} "
             f"times, its plain model {causes['total']} times")
    for cause in AIMS.get(case, ()):
        if causes[cause] == 0:
            fail(f"{case}: no refresh of cause {cause}")
    res.update(ms=ms, plain_ms=plain_ms, pipelined=int(to_np(got[1]).sum()),
               **stats, refresh_causes=causes,
               slots=0 if slots is None else len(slots[1]) - 1)
    line("kernel_vs_plain", case=case, shape=sa.shapes, **opts, **res)
    return res


def shape_case(dev, case, sa, plan, model) -> dict:
    """One case of shapes_vs_plain: the kernel (a warm-up and one timed
    run, ``plan`` forced or picked by shape) against the plain loop,
    exactly, with its refreshes against the plain model's (``model``:
    the future of its counts)."""
    t, _ = convert.from_reference(sa.as_dict(), None, dev)
    R = sa.group_req.shape[1]
    w = ScoreWeights.make(R, binpack=1.0, device=dev)
    args = convert.args(t)
    gang_allocate_cuda(*args, w, plan=plan)                 # warm-up
    got, ms = timed(lambda: gang_allocate_cuda(*args, w, plan=plan))
    stats = launch_stats()
    if stats["plan"] != (plan or "shared"):
        fail(f"shapes_vs_plain {case}: plan {stats['plan']}")
    want, plain_ms = timed(lambda: allocate.gang_allocate(*args, w))
    res = compare(sa, got, want, f"shapes_vs_plain {case}")
    causes = model.result()
    if causes["total"] != stats["refreshes"]:
        fail(f"shapes_vs_plain {case}: the kernel refreshed its table "
             f"{stats['refreshes']} times, its plain model "
             f"{causes['total']} times")
    steps = int(sa.job_n_tasks.sum())
    N = sa.node_idle.shape[0]
    bytes_ms, ops_ms, _ = bound(args, [], got[:4], stats["refreshes"],
                                steps, N, R)
    res.update(ms=ms, plain_ms=plain_ms, R=R, steps=steps,
               bytes_ms=bytes_ms, ops_ms=ops_ms, **stats)
    line("shapes_vs_plain", case=case, shape=sa.shapes, **res)
    return res


def shapes_vs_plain(dev, main_args, main_weights, main_sa) -> dict:
    """Phase 6b: the shapes the kernel used to refuse. At MID's size,
    gang 8, with R = 9, 12, 16 and 20 (synth_arrays' scalar kinds, two
    queues); then the global plan, node state in device memory, over
    60,000 and 100,000 nodes at R = 4 and 50,000 at R = 16 (2,048 tasks):
    each held exactly against the plain loop, refreshes equal to the plain
    model's (run meanwhile on the host's CPU). Then the main path's own
    inputs under both plans, alternated, equal to each other; and
    ptxas's registers and spills at R = 16. Returns the summary for the
    kernels line."""
    cases = []
    n, m_, g = MID["n_tasks"], MID["n_nodes"], MID["gang"]
    for r in SHAPE_RS:
        cases.append((f"R{r}", synth_arrays(n, m_, gang_size=g, seed=20 + r,
                                            utilization=0.6, r=r,
                                            n_queues=2), None))
    for n_nodes, r in GLOBAL_CASES:
        cases.append((f"global_{n_nodes}_R{r}",
                      synth_arrays(GLOBAL_TASKS, n_nodes, gang_size=g,
                                   seed=n_nodes + r, utilization=0.6, r=r),
                      "global"))
    pool = concurrent.futures.ProcessPoolExecutor(
        MODEL_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        models = {case: pool.submit(model_refreshes, sa.as_dict(), False,
                                    True)
                  for case, sa, _ in cases}
        out = {case: shape_case(dev, case, sa, plan, models[case])
               for case, sa, plan in cases}
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    # the main path's inputs under both plans, alternated
    plans = {}
    outs = {}
    for plan in ("shared", "global", "global", "shared"):
        got, ms = timed(lambda: gang_allocate_cuda(*main_args, main_weights,
                                                   plan=plan))
        plans.setdefault(plan, []).append(ms)
        outs[plan] = got
        if launch_stats()["plan"] != plan:
            fail(f"main path inputs: plan {launch_stats()['plan']}")
    both = compare(main_sa, outs["global"], outs["shared"],
                   "main path inputs, global plan against shared")
    usage = ptxas_usage(build.report("gang_allocate"))
    r16 = {k: v for k, v in usage.items() if k.startswith("R16_")}
    line("shapes_vs_plain", case="main_path_inputs_plans",
         shape=main_sa.shapes, shared_ms=plans["shared"],
         global_ms=plans["global"], **both, ptxas_R16=r16)
    return {"cases": {k: {f: v[f] for f in (
                "ms", "plain_ms", "R", "plan", "refreshes", "bytes_ms",
                "ops_ms", "assign_mismatches", "state_max_abs_err")}
                      for k, v in out.items()},
            "main_path_plans": plans, "ptxas_R16": r16}


def find_spans(span, name):
    """Every span called ``name`` in the tree under ``span``."""
    found = [span] if span.name == name else []
    for c in span.children or ():
        found.extend(find_spans(c, name))
    return found


def traced_cycle(dev) -> dict:
    """Phase 15b: the north-star cycle with the flight recorder (and the
    lifecycle ledger tracer.enable turns on) off and on, through
    volcano_tpu_torch/cmd/trace_overhead.py: TRACE_PAIRS placing cycles
    each way on fresh stores in off-on-on-off order, then two rounds of
    steady cycles on one bound store, each cycle's launch count set to 0
    just before and read just after. Prints the span split of the cycle
    and of its commit, the overhead of tracing in percent (by the minima
    and the medians), the kernel's device time from the execute span's
    tag beside the solver's own; checks that /metrics, fetched from the
    metrics server on a local port, parses line by line, and that the
    ledger completed every bind."""
    from volcano_tpu_torch.cmd import trace_overhead
    from volcano_tpu_torch.metrics.server import MetricsServer
    from volcano_tpu_torch.trace import ledger
    runs = trace_overhead.placing(FULL["n_tasks"], FULL["n_nodes"], dev,
                                  TRACE_PAIRS)
    for r in runs["off"] + runs["on"]:
        if r["binds"] != FULL["n_tasks"]:
            fail(f"traced_cycle: {r['binds']} binds")
        check_launches("traced_cycle", r["kernel_launches"], r["places"],
                       True)
    if ledger.stats()["completed"] != FULL["n_tasks"]:
        fail(f"traced_cycle: the ledger completed "
             f"{ledger.stats()['completed']} binds")
    steady = trace_overhead.steady(runs.pop("store"), dev, rounds=2)
    if steady["launches"]:
        fail("traced_cycle: a steady cycle launched the kernel")
    record = runs["record"]
    last = runs["on"][-1]
    span_kernel_ms = [sp.tags["kernel_ms"]
                      for sp in find_spans(record.root, "execute")]
    solver_kernel_ms = [ms for pl in last["places"]
                        for ms in pl["launch_ms"]]
    if [round(x, 6) for x in span_kernel_ms] != \
            [round(x, 6) for x in solver_kernel_ms]:
        fail(f"traced_cycle: execute spans' kernel_ms {span_kernel_ms}, "
             f"the solver's {solver_kernel_ms}")
    server = MetricsServer(port=0)
    server.start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics",
            timeout=30).read().decode()
        cycles = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/debug/cycles",
            timeout=30).read().decode())
    finally:
        server.stop()
    bad = [ln for ln in body.splitlines() if not PROM_LINE.match(ln)]
    if bad or "volcano_e2e_scheduling_latency_milliseconds_count" not in body:
        fail(f"traced_cycle: /metrics does not parse: {bad[:3]}")
    on = [r["cycle_ms"] for r in runs["on"]]
    off = [r["cycle_ms"] for r in runs["off"]]
    placing_oh = trace_overhead.overhead(on, off)
    steady_oh = trace_overhead.overhead(steady["on"], steady["off"])
    split = last["trace"]
    res = {"cycle_ms_on": on, "cycle_ms_off": off,
           "overhead_pct": placing_oh["min_pct"],
           "overhead_median_pct": placing_oh["median_pct"],
           "steady_cycle_ms_on": steady["on"],
           "steady_cycle_ms_off": steady["off"],
           "steady_overhead_pct": steady_oh["min_pct"],
           "steady_overhead_median_pct": steady_oh["median_pct"],
           "phases": split["phases"], "commit": split["async"],
           "coverage": split["coverage"], "tags": split["tags"],
           "span_kernel_ms": span_kernel_ms,
           "solver_kernel_ms": solver_kernel_ms,
           "metrics_lines": len(body.splitlines()),
           "debug_cycles": len(cycles["cycles"]),
           "kernel_launches": [r["kernel_launches"]
                               for r in runs["off"] + runs["on"]]}
    line("traced_cycle", shape={"tasks": FULL["n_tasks"],
                                "nodes": FULL["n_nodes"],
                                "gang": FULL["gang"]}, **res)
    return res


# incremental_cycle: the cycles of the sequence after the placing one
INCR_STEADY = 3
INCR_CHURN = 4
INCR_RELABEL = 10


def incr_sequence() -> list:
    """The phase's cycles in order: one placing cycle, steady cycles with
    nothing changed, two cycles with a gang no node can hold (the second
    patches no node: a launch that copies no node row), churn cycles
    (the first also deletes that gang) and a queue add (structural)."""
    return (["place"] + ["steady"] * INCR_STEADY + ["unfit"] * 2
            + ["churn"] * INCR_CHURN + ["structural"])


def incr_events(n_jobs: int, n_nodes: int, seed: int) -> list:
    """The store events before each cycle of incr_sequence, drawn from
    ``seed``: each churn cycle deletes 1 % of the gangs (bound ones:
    chosen among those live before the cycle), adds as many pending
    gangs of populate_store's shape and relabels INCR_RELABEL nodes."""
    rng = np.random.default_rng(seed)
    live = list(range(n_jobs))
    next_job = n_jobs
    n_churn = max(1, n_jobs // 100)
    events = []
    for c, kind in enumerate(incr_sequence()):
        ev = []
        if kind == "unfit" and not any(k == "unfit"
                                       for k in incr_sequence()[:c]):
            ev.append(("unfit",))
        if kind == "churn":
            if incr_sequence()[c - 1] == "unfit":
                ev.append(("delete_unfit",))
            gone = sorted(rng.choice(len(live), n_churn, replace=False),
                          reverse=True)
            ev += [("delete", live.pop(int(i))) for i in gone]
            for _ in range(n_churn):
                ev.append(("add", next_job))
                live.append(next_job)
                next_job += 1
            ev += [("relabel", int(i), c) for i in
                   rng.choice(n_nodes, INCR_RELABEL, replace=False)]
        if kind == "structural":
            ev.append(("queue",))
        events.append(ev)
    return events


def apply_incr_events(store: ObjectStore, events, gang: int) -> None:
    for ev in events:
        if ev[0] in ("delete", "delete_unfit"):
            name = f"pg-{ev[1]}" if ev[0] == "delete" else "unfit"
            for pod in [f"job{ev[1]}-task{t}" for t in range(gang)] \
                    if ev[0] == "delete" else ["unfit-0", "unfit-1"]:
                store.delete("pods", pod, "default")
            store.delete("podgroups", name, "default")
        elif ev[0] in ("add", "unfit"):
            name = f"pg-{ev[1]}" if ev[0] == "add" else "unfit"
            store.create("podgroups", tu.build_pod_group(
                name, "default", "default", gang if ev[0] == "add" else 2,
                phase="Inqueue"))
            pods = [(f"job{ev[1]}-task{t}", {"cpu": "2", "memory": "4Gi"})
                    for t in range(gang)] if ev[0] == "add" else \
                [(f"unfit-{t}", {"cpu": "512", "memory": "4Gi"})
                 for t in range(2)]
            for pod, req in pods:
                store.create("pods", tu.build_pod(
                    "default", pod, "", "Pending", req, groupname=name))
        elif ev[0] == "relabel":
            node = store.get("nodes", f"node-{ev[1]}")
            node.metadata.labels["rack"] = f"rack-moved-{ev[2]}"
            store.update("nodes", node)
        elif ev[0] == "queue":
            store.create("queues", tu.build_queue("q-extra", weight=1))


def store_state(store: ObjectStore):
    """(binds pod -> node, PodGroup -> (phase, sorted conditions)) as the
    store holds them, read in place (store.list would clone 50,000
    pods a call)."""
    with store._lock:
        binds = {k: p.spec.node_name
                 for k, p in store._objects["pods"].items()
                 if p.spec.node_name}
        groups = {k: (g.status.phase, sorted(
            (c.type, c.status, c.reason, c.message)
            for c in g.status.conditions))
            for k, g in store._objects["podgroups"].items()}
    return binds, groups


def fresh_node_upload(cache, dev):
    """(node order, the five node tensors) of a full upload of
    NodeArrays.build for the cache as it stands: the nodes the next
    session encodes."""
    from volcano_tpu_torch.models.arrays import NodeArrays, ResourceIndex
    with cache.mutex:
        full = cache._snapshot_locked()
    order = [n for n in full.node_list if n in full.nodes]
    narr = NodeArrays.build(full.nodes, order,
                            ResourceIndex.from_cluster(full.nodes, full.jobs))
    host = {"node_idle": narr.idle, "node_future": narr.future_idle,
            "node_alloc": narr.allocatable, "node_ntasks": narr.n_tasks,
            "node_max_tasks": narr.max_tasks}
    return order, {f: torch.tensor(a, dtype=convert.FIELDS[f], device=dev)
                   for f, a in host.items()}


def incr_run(sched, store, kind, events, gang, dev, check_resident):
    """One cycle of the phase: the events, then run_once with the launch
    count set to 0 just before and read just after. With
    ``check_resident`` (an unpruned run on the card), the resident node
    tensors after a full-width launch must equal a fresh upload of the
    session's nodes, taken before the cycle."""
    apply_incr_events(store, events, gang)
    cache = sched.cache
    fresh = fresh_node_upload(cache, dev) if check_resident else None
    gang_allocate_cuda.launches = 0
    sched.run_once()
    launches = gang_allocate_cuda.launches
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    flush_ms = flush(cache, f"incremental_cycle {kind} cycle")
    lc = sched.last_cycle
    full_width = [pl for pl in lc["places"]
                  if pl["prune"] is None or not pl["prune"]["served"]]
    resident = None
    state = getattr(cache, "_incr_solver_state", None)
    if check_resident and full_width:
        order, want = fresh
        if state is None or state.dev is None or order != state.names \
                or any(not torch.equal(state.dev[f], want[f])
                       for f in want):
            fail(f"incremental_cycle: after the {kind} cycle the "
                 f"resident node tensors differ from a fresh upload")
        resident = True
    row_bytes = None
    if state is not None and state.dev is not None:
        row_bytes = sum(int(t[0].numel() * t.element_size())
                        for t in state.dev.values())
    node_bytes = sum(pl["node_bytes"] for pl in lc["places"])
    return {"kind": kind, "mode": lc["mode"],
            "patched_jobs": lc["patched_jobs"],
            "patched_nodes": lc["patched_nodes"], "quiet": lc["quiet"],
            "snapshot_ms": lc["snapshot_ms"],
            "open_session_ms": lc["open_session_ms"],
            "close_session_ms": lc["close_session_ms"],
            "cycle_ms": lc["cycle_ms"], "flush_ms": flush_ms,
            "actions_ms": {a: lc[f"{a}_ms"] for a in ("enqueue", "allocate",
                                                      "backfill")},
            "node_bytes": node_bytes,
            "node_rows": node_bytes // row_bytes if row_bytes else None,
            "kernel_launches": launches,
            "places": [{"launches": pl["launches"],
                        "prune": (pl["prune"] or {}).get("fallback", "off")
                        if pl["prune"] is None or not pl["prune"]["served"]
                        else "served", "kernel_ms": pl["kernel_ms"]}
                       for pl in lc["places"]],
            "resident_checked": resident}


def incremental_cycle(dev) -> dict:
    """Phase 15c: the incremental steady-state cycle. Full width: two
    stores of the north star (populate_store(10,000 nodes, 6,250 gangs
    of 8), default conf plus binpack) on the card, one Scheduler with
    ``incremental=True`` and one with ``False``, driven through the same
    seeded sequence (incr_sequence, incr_events); after every cycle the
    binds, evictions and PodGroup phases and conditions of the two must
    be equal. Unpruned: 4,096 pods over 2,048 nodes (no pruning below
    4,096 nodes, so the resident node tensors and their dirty-row copies
    run), incremental on the card against incremental with the plain
    loop on the CPU, equal the same way; after each full-width launch on
    the card the resident tensors must equal a fresh upload. Every
    cycle's launches are counted from 0 and must be 0 on a quiet cycle
    and what the places' prune outcomes give otherwise."""
    out = {}
    for case, size, runs in (
            ("full_width", FULL,
             (("incremental", dev, True), ("full", dev, False))),
            ("unpruned", MID,
             (("incremental", dev, True),
              ("plain", torch.device("cpu"), True)))):
        n_jobs = size["n_tasks"] // size["gang"]
        events = incr_events(n_jobs, size["n_nodes"], seed=8)
        conf = CYCLE_CONF.format(drf="")
        sides = {}
        for name, device, incremental in runs:
            store = ObjectStore()
            populate_store(store, n_nodes=size["n_nodes"], n_jobs=n_jobs,
                           gang_size=size["gang"])
            sched = Scheduler(store, scheduler_conf=conf, device=device,
                              incremental=incremental)
            sched.cache.run()
            sides[name] = (store, sched)
        rows = {name: [] for name in sides}
        for c, kind in enumerate(incr_sequence()):
            states = {}
            # the two sides take turns at going first
            order = list(sides.items())
            if c % 2:
                order.reverse()
            for name, (store, sched) in order:
                r = incr_run(sched, store, kind, events[c], size["gang"],
                             sched.device, check_resident=(
                                 case == "unpruned"
                                 and name == "incremental"))
                want = 0 if r["quiet"] else sum(
                    expected_launches(sched.last_cycle["places"]))
                got = r["kernel_launches"]
                if sched.device.type != "cuda":
                    want = 0
                if got != want:
                    fail(f"incremental_cycle {case} {name} cycle {c} "
                         f"({kind}): {got} launches, {want} expected")
                if kind == "steady" and c > 1 and incremental and \
                        not r["quiet"]:
                    fail(f"incremental_cycle {case} {name}: steady cycle "
                         f"{c} was not quiet: {r}")
                states[name] = (store_state(store), sched.cache.evictions)
                rows[name].append(r)
            (a_name, a), (b_name, b) = sorted(states.items())
            if a != b:
                (ab, ag), (bb, bg) = a[0], b[0]
                fail(f"incremental_cycle {case} cycle {c} ({kind}): "
                     f"{a_name} and {b_name} differ: "
                     f"{sum(ab.get(k) != bb.get(k) for k in set(ab) | set(bb))}"
                     f" binds, {sum(ag.get(k) != bg.get(k) for k in ag)} "
                     f"PodGroups, evictions {a[1]} / {b[1]}")
            line("incremental_cycle", case=case, cycle=c, kind=kind,
                 binds=len(a[0][0]),
                 **{name: rows[name][-1] for name in rows})
        incr = rows["incremental"]
        modes = [r["mode"] for r in incr]
        if modes[0] != "full" or modes[-1] != "full" or \
                set(modes[1:-1]) != {"incremental"} or \
                not any(r["quiet"] for r in incr):
            fail(f"incremental_cycle {case}: modes {modes}")
        if case == "unpruned":
            unfit = [r for r in incr if r["kind"] == "unfit"]
            churn = [r for r in incr if r["kind"] == "churn"]
            n = size["n_nodes"]
            if [pl["launches"] for pl in unfit[-1]["places"]] != [1] or \
                    unfit[-1]["node_rows"] != 0 or \
                    not all(0 < r["node_rows"] < n for r in churn) or \
                    not any(r["resident_checked"] for r in incr):
                fail(f"incremental_cycle {case}: node rows copied "
                     f"{[(r['kind'], r['node_rows']) for r in incr]}")
        out[case] = {
            name: {k: [r[k] for r in rs] for k in (
                "kind", "mode", "quiet", "patched_jobs", "patched_nodes",
                "snapshot_ms", "open_session_ms", "close_session_ms",
                "cycle_ms", "flush_ms", "node_bytes", "node_rows",
                "kernel_launches")}
            for name, rs in rows.items()}
        for store, sched in sides.values():
            sched.cache.stop()
        del sides
        gc.collect()
    return out


# ---- the write-behind commit ----------------------------------------------

# flush_cycle (b): the faults' shape, the FlakyBinder's failure rate and
# seed, and the cycles on a FakeClock one virtual second apart
FLUSH_FAULTS = dict(MID, fail_rate=0.02, seed=5, cycles=6)


class InlineCache(SchedulerCache):
    """A cache whose executor never starts: every bind, evict and status
    write runs inline in the cycle, as it does before run() (the
    synchronous commit the live executor is held against)."""

    def start_executors(self) -> None:
        pass


def flush_full_width(dev) -> dict:
    """flush_cycle (a): the north star's store (phase 9's shape), two
    fresh stores, live first: with the executor live, one cycle, its
    flush and one timed anti-entropy pass (no repair expected); inline,
    the same committed by InlineCache. The inline run's binds and
    PodGroups (phase and conditions) must equal the live run's, every pod
    bound, every gang committed. (``cmd.cycle --commit alternate`` times
    the two in more runs.)"""
    out = {"live": [], "inline": []}
    first = None
    for mode in ("live", "inline"):
        store = ObjectStore()
        populate_store(store, n_nodes=FULL["n_nodes"],
                       n_jobs=FULL["n_tasks"] // FULL["gang"],
                       gang_size=FULL["gang"])
        cache = (SchedulerCache if mode == "live" else InlineCache)(store)
        cache.run()
        sched = Scheduler(store, scheduler_conf=cycle_cmd.CONF, cache=cache,
                          device=dev)
        gc.collect()
        gc.freeze()
        try:
            gang_allocate_cuda.launches = 0
            sched.run_once()
            torch.cuda.synchronize(dev)
            launches = gang_allocate_cuda.launches
            flush_ms = flush(cache, f"flush_cycle {mode}")
        finally:
            gc.unfreeze()
        check_launches(f"flush_cycle {mode}", launches,
                       sched.last_cycle["places"], True)
        check_binds(store, f"flush_cycle {mode}")
        r = {"launches": launches, "cycle_ms": sched.last_cycle["cycle_ms"],
             "flush_ms": flush_ms,
             "commit_ms": sched.last_cycle.get("allocate.commit_ms"),
             "close_session_ms": sched.last_cycle["close_session_ms"]}
        if mode == "live":
            t0 = time.perf_counter()
            rep = cache.anti_entropy()
            r["anti_entropy_ms"] = (time.perf_counter() - t0) * 1000.0
            if rep["divergent"] or rep["repaired"]:
                fail(f"flush_cycle: anti-entropy found {rep} after the "
                     f"flush")
        state = store_state(store)
        cache.stop()
        if first is None:
            first = state
        elif state != first:
            (ab, ag), (bb, bg) = first, state
            fail(f"flush_cycle {mode}: "
                 f"{sum(ab.get(k) != bb.get(k) for k in set(ab) | set(bb))}"
                 f" binds and {sum(ag.get(k) != bg.get(k) for k in ag)} "
                 f"PodGroups differ from the first run's")
        out[mode].append(r)
        del store, cache, sched
        gc.collect()
    binds, groups = first
    running = sum(g[0] == "Running" for g in groups.values())
    if len(binds) != FULL["n_tasks"] or \
            running != FULL["n_tasks"] // FULL["gang"]:
        fail(f"flush_cycle: {len(binds)} binds, {running} running gangs")
    out["binds"] = len(binds)
    out["running_gangs"] = running
    return out


def flush_fault_run(device) -> list:
    """flush_cycle (b) on one device: MID's populate_store cluster on a
    FakeClock, a FlakyBinder failing FLUSH_FAULTS["fail_rate"] of the
    binds from its seed, the executor live; per cycle (each flushed, then
    the clock advanced one second): binds, retry records (attempts,
    not_before), quarantine, the GangUnbound events of the heals, the
    injected failures and the kernel's launches."""
    f = FLUSH_FAULTS
    clock = FakeClock(start=1.0)
    store = ObjectStore(clock=clock)
    populate_store(store, n_nodes=f["n_nodes"],
                   n_jobs=f["n_tasks"] // f["gang"], gang_size=f["gang"])
    binder = FlakyBinder(store, clock, fail_rate=f["fail_rate"],
                         seed=f["seed"])
    cache = SchedulerCache(store, binder=binder)
    cache.run()
    sched = Scheduler(store, scheduler_conf=CYCLE_CONF.format(drf=""),
                      cache=cache, clock=clock, device=device)
    rows = []
    for c in range(f["cycles"]):
        gang_allocate_cuda.launches = 0
        sched.run_once()
        launches = gang_allocate_cuda.launches
        flush_ms = flush(cache, f"flush_cycle faults cycle {c}")
        binds, groups = store_state(store)
        rows.append({
            "binds": binds, "groups": groups,
            "retry": {k: (r.attempts, r.not_before)
                      for k, r in cache.retry_records.items()},
            "quarantined": sorted(cache.quarantined),
            "healed": sorted(e[1] for e in store.events
                             if e[3] == "GangUnbound"),
            "failed": len(binder.failed_keys), "launches": launches,
            "cycle_ms": sched.last_cycle["cycle_ms"], "flush_ms": flush_ms})
        clock.advance(1.0)
    cache.stop()
    return rows


def flush_fenced(dev) -> dict:
    """flush_cycle (c): MID's populate_store cluster, a FlakyBinder that
    fails nothing, and a cache whose fencing token (1) is behind the
    store's floor (2); one cycle on the card, flushed: no bind may land,
    and the store's fenced writes and the cache's resync retries must
    equal the binds the cycle attempted."""
    clock = FakeClock(start=1.0)
    store = ObjectStore(clock=clock)
    populate_store(store, n_nodes=MID["n_nodes"],
                   n_jobs=MID["n_tasks"] // MID["gang"],
                   gang_size=MID["gang"])
    binder = FlakyBinder(store, clock)
    cache = SchedulerCache(store, binder=binder, fence_source=lambda: 1)
    cache.run()
    store.advance_fence(2)
    sched = Scheduler(store, scheduler_conf=CYCLE_CONF.format(drf=""),
                      cache=cache, clock=clock, device=dev)
    gang_allocate_cuda.launches = 0
    sched.run_once()
    launches = gang_allocate_cuda.launches
    flush(cache, "flush_cycle fenced")
    out = {"attempted": binder.attempts,
           "fenced_writes": store.fenced_writes,
           "bound": len(store_state(store)[0]),
           "resync_retries": cache.resync_retry_total,
           "kernel_launches": launches}
    cache.stop()
    if out["bound"] or not out["attempted"] or \
            out["fenced_writes"] != out["attempted"] or \
            out["resync_retries"] != out["attempted"]:
        fail(f"flush_cycle fenced: {out}")
    return out


def flush_cycle(dev) -> dict:
    """Phase 15d: the write-behind commit. (a) flush_full_width; (b) the
    faults at MID's size over six cycles, the card against the plain loop
    on the CPU, both with the executor live: binds, PodGroups, retry
    records, quarantine and heals must be equal after every flush, and
    faults must have been injected and healed; (c) a fenced run: a cache
    whose fencing token (1) is behind the store's floor (2), one cycle on
    the card: no bind lands and the store's fenced writes equal the binds
    the cycle attempted."""
    t_phase = time.perf_counter()
    full = flush_full_width(dev)
    line("flush_cycle", part="full_width",
         shape={"tasks": FULL["n_tasks"], "nodes": FULL["n_nodes"],
                "gang": FULL["gang"]}, **full)

    # the injected failures log one warning a pod: kept off the output
    # while parts (b) and (c) run
    cache_log = logging.getLogger("volcano_tpu_torch.cache.cache")
    level = cache_log.level
    cache_log.setLevel(logging.ERROR)
    try:
        card = flush_fault_run(dev)
        plain = flush_fault_run(torch.device("cpu"))
        fenced = flush_fenced(dev)
    finally:
        cache_log.setLevel(level)
    keys = ("binds", "groups", "retry", "quarantined", "healed", "failed")
    for c, (a, b) in enumerate(zip(card, plain)):
        diff = [k for k in keys if a[k] != b[k]]
        if diff:
            fail(f"flush_cycle faults cycle {c}: the card's and the plain "
                 f"loop's {diff} differ")
        line("flush_cycle", part="faults", cycle=c, binds=len(a["binds"]),
             retry_records=len(a["retry"]), quarantined=len(a["quarantined"]),
             healed=len(a["healed"]), failed=a["failed"],
             kernel_launches=a["launches"], cycle_ms=a["cycle_ms"],
             flush_ms=a["flush_ms"], plain_cycle_ms=b["cycle_ms"],
             plain_flush_ms=b["flush_ms"])
    if not card[-1]["failed"] or not card[-1]["healed"]:
        fail(f"flush_cycle faults: {card[-1]['failed']} injected failures, "
             f"{len(card[-1]['healed'])} healed pods")

    line("flush_cycle", part="fenced", **fenced)
    return {"full_width": full, "faults": card, "fenced": fenced,
            "seconds": time.perf_counter() - t_phase}


# native_commit: the engines' order over the runs (each on a fresh store
# of the same seed), then the traced run's engine (the native engine's
# traced runs are traced_cycle's placing cycles: the same store, conf and
# executor on the default engine)
ENGINE_ORDER = ("native", "python", "python", "native")
TRACED_ENGINE = "python"
# the flush's async spans the phase prints of a traced run
COMMIT_SPANS = ("bind_flush.apply", "bind_flush.store",
                "store.patch.echo_wait", "bind_flush.echo",
                "store.patch.clone_wait", "store.patch.publish")
# the native engine's switches: (owner, attribute); all off is the
# Python engine
NATIVE_SWITCHES = ((ObjectStore, "NATIVE_PUBLISH"),
                   (SchedulerCache, "NATIVE_APPLY"),
                   (EventHandlersMixin, "NATIVE_ECHO"),
                   (ledger, "NATIVE_CONFIRM"), (job_info, "NATIVE_CLONE"))
# the native entries of the path, each with the test of whether a call
# took its work (None: every call does)
NATIVE_ENTRIES = {
    "bind_apply_bursts": lambda args, out: out is True,
    "bind_echo_apply": lambda args, out: out == len(args[0]),
    "bind_clone_pods": lambda args, out: out is not None,
    "bind_request_items": lambda args, out: out is not None,
    "publish_shard": None, "attr_eq_filter_pairs": None,
    "ledger_confirm_runs": None, "clone_task_table": None,
    "clone_task_dict": None, "clone_resource": None}


def set_engine(engine: str) -> None:
    for owner, attr in NATIVE_SWITCHES:
        setattr(owner, attr, engine == "native")


class EntryTap:
    """Counts, per native entry, the calls made while it is installed and
    the calls that took their work (the module's attributes wrapped)."""

    def __init__(self):
        self.fm = job_info._fastmodel()
        self.counts = {name: [0, 0] for name in NATIVE_ENTRIES}
        self.real = {}

    def __enter__(self):
        for name, took in NATIVE_ENTRIES.items():
            real = self.real[name] = getattr(self.fm, name)

            def wrapper(*args, _real=real, _name=name, _took=took):
                out = _real(*args)
                c = self.counts[_name]
                c[0] += 1
                c[1] += _took is None or bool(_took(args, out))
                return out
            setattr(self.fm, name, wrapper)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.fm, name, real)


def commit_state(store: ObjectStore) -> dict:
    """What the two engines must leave equal after a flush: the stored
    pods (node, resource version), the journal's (rv, action, kind, key)
    sequence, the PodGroup phases and the ledger's counts (completed,
    open, per hop, per queue, and the recent ring's pods, queues and
    hops), read in place."""
    with store._lock:
        pods = {k: (p.spec.node_name, p.metadata.resource_version)
                for k, p in store._objects["pods"].items()}
        journal = [(rv, action, kind, store.key_of(kind, o))
                   for rv, action, kind, o in store._journal]
        groups = {k: g.status.phase
                  for k, g in store._objects["podgroups"].items()}
    rep = ledger.report()
    led = {"open": rep["open"], "completed": rep["completed"],
           "dropped": rep["dropped"], "detours": rep["detours"],
           "hops": {h: r["count"] for h, r in rep["hops"].items()},
           "queues": {q: r["count"]
                      for q, r in rep["per_queue_e2e"].items()},
           "recent": [(r["pod"], r["queue"], tuple(r["hops"]))
                      for r in rep["recent"]]}
    return {"pods": pods, "journal": journal, "groups": groups,
            "ledger": led}


def native_commit_run(dev, engine: str, traced: bool, check: bool) -> tuple:
    """One placing cycle and its flush on a fresh north-star store on
    ``engine``, the ledger on (and the flight recorder when ``traced``);
    ``check`` replays the binds against allocatable (later runs must leave
    the same binds). Returns (the run's line, its commit_state)."""
    set_engine(engine)
    ledger.reset()
    if traced:
        tracer.enable()
    else:
        ledger.enable()
    try:
        store = ObjectStore()
        populate_store(store, n_nodes=FULL["n_nodes"],
                       n_jobs=FULL["n_tasks"] // FULL["gang"],
                       gang_size=FULL["gang"])
        with EntryTap() as tap:
            cache = SchedulerCache(store)
            cache.run()
            sched = Scheduler(store, scheduler_conf=cycle_cmd.CONF,
                              cache=cache, device=dev)
            gc.collect()
            gc.freeze()
            try:
                gang_allocate_cuda.launches = 0
                sched.run_once()
                torch.cuda.synchronize(dev)
                launches = gang_allocate_cuda.launches
                flush_ms = flush(cache, f"native_commit {engine}")
            finally:
                gc.unfreeze()
        check_launches(f"native_commit {engine}", launches,
                       sched.last_cycle["places"], True)
        if check:
            check_binds(store, f"native_commit {engine}")
        lc = sched.last_cycle
        r = {"engine": engine, "traced": traced, "launches": launches,
             "cycle_ms": lc["cycle_ms"], "snapshot_ms": lc["snapshot_ms"],
             "flush_ms": flush_ms, "bound_ms": lc["cycle_ms"] + flush_ms,
             "entries": tap.counts}
        if traced:
            r["async"] = commit_spans(
                tracer.async_phases(tracer.last_record()))
        state = commit_state(store)
        cache.stop()
        return r, state
    finally:
        tracer.disable()
        ledger.disable()
        ledger.reset()
        set_engine("native")


def commit_spans(spans: dict) -> dict:
    """The flush's spans of a cycle's async split (tracer.async_phases)."""
    return {k: v for k, v in spans.items()
            if k.split("/")[-1] in COMMIT_SPANS}


def spread(xs) -> dict:
    """Median, least and greatest of ``xs``, and the values in order."""
    xs = sorted(xs)
    mid = len(xs) // 2
    return {"median": xs[mid] if len(xs) % 2 else (xs[mid - 1] + xs[mid]) / 2,
            "min": xs[0], "max": xs[-1], "runs": xs}


def native_commit(dev, native_async: dict) -> dict:
    """Phase 15g: the native engine against the Python bodies at the
    north star (see the module docstring); ``native_async`` is the async
    split of traced_cycle's last traced placing cycle."""
    t_phase = time.perf_counter()
    runs = []
    first = None
    plan = [(e, False) for e in ENGINE_ORDER] + [(TRACED_ENGINE, True)]
    for i, (engine, traced) in enumerate(plan):
        # the run's garbage is collected before the next cycle starts
        r, state = native_commit_run(dev, engine, traced, check=i == 0)
        n_binds = sum(1 for node, _ in state["pods"].values() if node)
        if n_binds != FULL["n_tasks"] or \
                state["ledger"]["completed"] != FULL["n_tasks"]:
            fail(f"native_commit run {i} ({engine}): {n_binds} binds, "
                 f"{state['ledger']['completed']} ledger completions")
        if engine == "native":
            idle = [n for n, (calls, took) in r["entries"].items()
                    if calls == 0 or took != calls]
            if idle:
                fail(f"native_commit run {i}: the native entries {idle} "
                     f"did not take their work: {r['entries']}")
        elif any(calls for calls, _ in r["entries"].values()):
            fail(f"native_commit run {i}: the Python engine called "
                 f"native entries: {r['entries']}")
        if first is None:
            first = state
        else:
            diff = [k for k in first if state[k] != first[k]]
            if diff:
                fail(f"native_commit run {i} ({engine}, traced "
                     f"{traced}): {diff} differ from the first run's")
        r["run"] = i
        runs.append(r)
        line("native_commit", **r)
    out = {"seconds": time.perf_counter() - t_phase,
           "launches": [r["launches"] for r in runs]}
    for engine in ("native", "python"):
        mine = [r for r in runs if r["engine"] == engine]
        out[engine] = {k: spread([r[k] for r in mine if not r["traced"]])
                       for k in ("cycle_ms", "snapshot_ms", "flush_ms",
                                 "bound_ms")}
        out[engine]["async"] = commit_spans(native_async) \
            if engine == "native" else \
            [r for r in mine if r["traced"]][0]["async"]
    line("native_commit", summary=True,
         shape={"tasks": FULL["n_tasks"], "nodes": FULL["n_nodes"],
                "gang": FULL["gang"]}, **out)
    return out


# plugins_cycle: the repo's full-featured conf, read from the checkout
# (cmd.cycle.example_conf), over stores with the shares of its plugins
# (populate_store's plugin_shares: a Numatopology of 64 CPUs on every
# node, as its 64 cores, every 8th gang Guaranteed, every 16th past sla's
# hour)
example_conf = cycle_cmd.example_conf
PLUGINS_CLOCK0 = 1_000_000.0
REVOCABLE_ZONE = "volcano.sh/revocable-zone"
TDM_CONF = """
actions: "enqueue, allocate, backfill, preempt"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: tdm
    arguments:
      tdm.revocable-zone.rz1: {window}
      tdm.evict.period: 1ms
  - name: overcommit
    arguments:
      overcommit-factor: 1.2
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""
RESERVE_CONF = """
actions: "enqueue, elect, allocate, backfill, reserve"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: reservation
  - name: sla
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: overcommit
"""
# plugins_cycle (b): (nodes, cycles) of each case at MID's 4,096 pods
PLUGIN_CASES = {"example_conf": (MID["n_nodes"], 2),
                "example_conf_pruned": (4096, 2),
                "tdm": (MID["n_nodes"], 3),
                "reservation": (MID["n_nodes"], 4)}


def numa_free(cache) -> dict:
    """node -> sorted free CPU ids of the cache's scheduler-side NUMA
    views (nodes with one)."""
    with cache.mutex:
        return {name: sorted(n.numa_scheduler_info.numa_res_map["cpu"]
                             .allocatable)
                for name, n in cache.nodes.items()
                if n.numa_scheduler_info is not None}


def numa_cpus(free: dict) -> int:
    """The CPUs taken off the 64 of each node's NUMA view."""
    return sum(64 - len(ids) for ids in free.values())


class NumaTap:
    """While installed, records at each numa-aware session close how many
    allocated tasks it writes CPU sets back for (the plugin's
    ``task_bind_node``): the pods given NUMA CPU sets that cycle. It
    changes nothing the plugin does."""

    def __init__(self):
        self.counts = []
        self._close = numaaware_plugin.NumaAwarePlugin.on_session_close

    def __enter__(self):
        close, counts = self._close, self.counts

        def tapped(plugin, ssn):
            counts.append(len(plugin.task_bind_node))
            return close(plugin, ssn)
        numaaware_plugin.NumaAwarePlugin.on_session_close = tapped
        return self

    def __exit__(self, *exc):
        numaaware_plugin.NumaAwarePlugin.on_session_close = self._close

    def last(self) -> int:
        return self.counts[-1] if self.counts else 0


def guaranteed_binds(binds: dict) -> int:
    """Bound pods of the Guaranteed gangs (populate_store's job j with
    j % 8 == 0, pods named job<j>-task<t>)."""
    return sum(1 for k in binds
               if int(k.split("/")[1].split("-")[0][3:]) % 8 == 0)


def plugins_full_width(dev, north_star: dict, late) -> dict:
    """plugins_cycle (a): the north star's store with the plugin shares under
    examples/scheduler-conf.yaml, one placing cycle and one steady cycle
    on it, the launch count set to 0 just before each and read just
    after. Every pod binds, every gang runs, every bound Guaranteed pod
    got a 2-CPU NUMA set. Each cycle prints its cycle_ms and split,
    flush_ms, the host_predicates sweep's ms and G, the kernel's ms
    (CUDA events) and launches, the binds and the pods given NUMA sets;
    ``north_star`` is phase 9's warm default-conf cycle of this run.
    Every launch of the placing cycle (the pruned place's reduced one and
    the full-width one, with numa-aware's host mask in the static mask)
    is captured and held exactly against the plain loop on the same
    tensors by ``late`` (a LatePlain), and each place's launch report
    must equal that of the kernel rerun on its last launch's inputs."""
    store = ObjectStore()
    t0 = time.perf_counter()
    populate_store(store, n_nodes=FULL["n_nodes"],
                   n_jobs=FULL["n_tasks"] // FULL["gang"],
                   gang_size=FULL["gang"], plugin_shares=True)
    t1 = time.perf_counter()
    cache = SchedulerCache(store)
    cache.run()
    t2 = time.perf_counter()
    sched = Scheduler(store, scheduler_conf=example_conf(), cache=cache,
                      device=dev)
    runs = []
    gc.collect()
    gc.freeze()
    try:
        for run in ("placing", "steady"):
            with NumaTap() as tap, ReducedTap(full=True) as inputs:
                gang_allocate_cuda.launches = 0
                sched.run_once()
                torch.cuda.synchronize(dev)
                launches = gang_allocate_cuda.launches
            flush_ms = flush(cache, f"plugins_cycle {run}")
            split = dict(sched.last_cycle)
            places = split.pop("places")
            check_launches(f"plugins_cycle {run}", launches, places, True)
            binds, groups = store_state(store)
            free = numa_free(cache)
            host = [pl["host_predicates"] or {} for pl in places]
            held = hold_plugin_launches(run, places, inputs.inputs, late)
            runs.append(dict(
                run=run, launches=launches, flush_ms=flush_ms,
                held=held,
                kernel_ms=[pl["kernel_ms"] for pl in places],
                host_predicates_ms=[h.get("ms") for h in host],
                groups=[h.get("groups") for h in host],
                host_nodes=[h.get("nodes") for h in host],
                encode_ms=[pl["encode_ms"] for pl in places],
                prune=[pl["prune"] for pl in places],
                binds=len(binds), numa_pods=tap.last(),
                numa_cpus=numa_cpus(free),
                guaranteed_binds=guaranteed_binds(binds),
                running_gangs=sum(g[0] == "Running"
                                  for g in groups.values()), **split))
            line("plugins_cycle", part="full_width",
                 shape={"tasks": FULL["n_tasks"], "nodes": FULL["n_nodes"],
                        "gang": FULL["gang"]},
                 populate_s=t1 - t0, sync_s=t2 - t1,
                 north_star_cycle_ms=north_star["cycle_ms"],
                 north_star_flush_ms=north_star["flush_ms"], **runs[-1])
    finally:
        gc.unfreeze()
    check_binds(store, "plugins_cycle")
    placing = runs[0]
    if placing["binds"] != FULL["n_tasks"] or \
            placing["running_gangs"] != FULL["n_tasks"] // FULL["gang"]:
        fail(f"plugins_cycle: {placing['binds']} binds, "
             f"{placing['running_gangs']} running gangs")
    # a group's first task is admitted against the session-open NUMA
    # views and its CPU sets fixed then (the reference's design), so two
    # Guaranteed gangs on one node may be given overlapping sets: the
    # CPUs taken may fall short of 2 a pod, never exceed it
    if not 0 < placing["numa_pods"] <= placing["guaranteed_binds"] or \
            not 0 < placing["numa_cpus"] <= 2 * placing["numa_pods"] or \
            runs[1]["numa_cpus"] != placing["numa_cpus"]:
        fail(f"plugins_cycle: {placing['numa_pods']} pods given NUMA sets "
             f"({placing['numa_cpus']} CPUs) for "
             f"{placing['guaranteed_binds']} bound Guaranteed pods "
             f"({runs[1]['numa_cpus']} CPUs after the steady cycle)")
    if not all(placing["groups"]) or runs[1]["launches"]:
        fail(f"plugins_cycle: host sweeps {placing['groups']}, "
             f"{runs[1]['launches']} launches in the steady cycle")
    cache.stop()
    del store, cache, sched
    gc.collect()
    return {"runs": runs, "populate_s": t1 - t0, "sync_s": t2 - t1}


def hold_plugin_launches(run: str, places: list, inputs: list,
                         late) -> list:
    """Hold each captured launch of a plugins_cycle (a) cycle against the
    plain loop (hold_inputs, then late.finish); a place's launch report
    must equal the rerun's on its last launch's inputs. Returns one dict
    a launch, which late.finish completes with the comparison."""
    if len(inputs) != sum(pl["launches"] for pl in places):
        fail(f"plugins_cycle {run}: {len(inputs)} launches captured for "
             f"{[pl['launches'] for pl in places]} launches by place")
    held, i = [], 0
    for p, pl in enumerate(places):
        for k in range(pl["launches"]):
            cap = inputs[i]
            i += 1
            a = cap["arrays"]
            shape = {"T": a["task_group"].shape[0],
                     "G": a["group_req"].shape[0],
                     "N": a["node_idle"].shape[0],
                     "R": a["group_req"].shape[1]}
            ctx = f"plugins_cycle {run} place {p} launch {k} inputs"
            kw = dict(allow_pipeline=cap["allow_pipeline"],
                      ns_live=cap["ns_live"], **convert.slot_kwargs(a))

            def print_held(r, ctx=ctx):
                line("kernel_vs_plain", case=ctx.replace(" ", "_"), **r)
            res, _, _ = hold_inputs(a, cap["gmask"], cap["weights"],
                                    cap["deserved"], kw, ctx, plain=late,
                                    done=print_held)
            res["shape"] = shape
            held.append(res)
        if pl["launches"] and pl["launch"][0] != held[-1]["refreshes"]:
            fail(f"plugins_cycle {run} place {p}: the cycle's launch and "
                 f"the kernel rerun on its inputs refreshed their tables "
                 f"{pl['launch'][0]} and {held[-1]['refreshes']} times")
    return held


def make_revocable(store, n_nodes: int, n_jobs: int) -> None:
    """tdm's shares: one node in 8 in revocable zone rz1, one gang in 4
    (j % 4 == 0) revocable (its pods carry the zone) and preemptable."""
    for i in range(0, n_nodes, 8):
        node = store.get("nodes", f"node-{i}")
        node.metadata.labels[REVOCABLE_ZONE] = "rz1"
        store.update("nodes", node)
    for j in range(0, n_jobs, 4):
        pg = store.get("podgroups", f"pg-{j}")
        pg.metadata.annotations[obj.PREEMPTABLE_KEY] = "true"
        store.update("podgroups", pg)
        for t in range(MID["gang"]):
            pod = store.get("pods", f"job{j}-task{t}")
            pod.metadata.annotations.update(
                {obj.REVOCABLE_ZONE_KEY: "rz1", obj.PREEMPTABLE_KEY: "true"})
            store.update("pods", pod)


def zone_window(active: bool) -> str:
    """A tdm window that cannot end during a run: the whole day when
    active, else 02:00-03:00 hours from now (which never holds now)."""
    if active:
        return "00:00-23:59"
    lt = time.localtime()
    now_min = lt.tm_hour * 60 + lt.tm_min
    start, end = (now_min + 120) % 1440, (now_min + 180) % 1440
    return f"{start // 60:02d}:{start % 60:02d}-{end // 60:02d}:{end % 60:02d}"


def run_bound_pods(store) -> None:
    """The kubelet's part: every bound pod not yet Running starts."""
    with store._lock:
        bound = [p for p in store._objects["pods"].values()
                 if p.spec.node_name and p.status.phase != "Running"]
    for pod in bound:
        pod = store.get("pods", pod.metadata.name, pod.metadata.namespace)
        pod.status.phase = "Running"
        store.update("pods", pod)


def reservation_target(store) -> None:
    """The reservation case's gang: two pods of 62 of a node's 64 cores,
    priority 1000, Pending behind MinResources that no overcommit
    headroom passes, until its sla-waiting-time (150 min) is over."""
    store.create("priorityclasses", obj.PriorityClass(
        metadata=obj.ObjectMeta(name="top"), value=1000))
    pg = tu.build_pod_group("pg-target", "default", "default", 2,
                            phase="Pending", priority_class="top")
    pg.spec.min_resources = {"cpu": "1000000", "memory": "1Gi"}
    pg.metadata.annotations["sla-waiting-time"] = "150m"
    pg.metadata.creation_timestamp = PLUGINS_CLOCK0 - 60.0
    store.create("podgroups", pg)
    for t in range(2):
        store.create("pods", tu.build_pod(
            "default", f"target-task{t}", "", "Pending",
            {"cpu": "62", "memory": "8Gi"}, groupname="pg-target",
            priority=1000))


def plugins_case(case: str, device) -> list:
    """One plugins_cycle (b) case on ``device`` ("cuda": the card, "cpu":
    the plain loop) on a fresh FakeClock store, the reservation and tdm's
    evict clock reset first and after; per cycle the binds, PodGroups
    (phase, conditions), evictions in order, NUMA sets, the reservation's
    target and locked nodes, launches, cycle and flush ms and places."""
    n_nodes, n_cycles = PLUGIN_CASES[case]
    n_jobs = MID["n_tasks"] // MID["gang"]
    RESERVATION.reset()
    tdm_plugin._last_evict_at = 0.0
    clock = FakeClock(PLUGINS_CLOCK0)
    store = ObjectStore(clock=clock)
    if case.startswith("example_conf"):
        populate_store(store, n_nodes=n_nodes, n_jobs=n_jobs,
                       gang_size=MID["gang"], plugin_shares=True)
        conf = example_conf()
    elif case == "tdm":
        populate_store(store, n_nodes=n_nodes, n_jobs=n_jobs,
                       gang_size=MID["gang"])
        make_revocable(store, n_nodes, n_jobs)
        conf = TDM_CONF.format(window=zone_window(True))
    else:
        populate_store(store, n_nodes=n_nodes, n_jobs=0,
                       gang_size=MID["gang"])
        reservation_target(store)
        conf = RESERVE_CONF
    evictor = tu.FakeEvictor(store)
    cache = SchedulerCache(store, evictor=evictor)
    cache.run()
    sched = Scheduler(store, scheduler_conf=conf, cache=cache,
                      device=device)
    out = []
    for c in range(n_cycles):
        if case == "reservation" and c:
            clock.advance(3600.0)
            if c == 2:    # the other gangs arrive after two locks
                populate_store(store, n_nodes=0, n_jobs=n_jobs,
                               gang_size=MID["gang"])
        if case == "tdm" and c == 2:
            # the zone's window closes on pods that run: tdm drains them
            run_bound_pods(store)
            sched.conf = parse_scheduler_conf(
                TDM_CONF.format(window=zone_window(False)))
        with NumaTap() as tap:
            launches0 = gang_allocate_cuda.launches
            t0 = time.perf_counter()
            sched.run_once()
            ms = (time.perf_counter() - t0) * 1000.0
            launches = gang_allocate_cuda.launches - launches0
        flush_ms = flush(cache, f"plugins_cycle {case} on {device}")
        binds, groups = store_state(store)
        places = sched.last_cycle["places"]
        check_launches(f"plugins_cycle {case} on {device}", launches,
                       places, device == "cuda")
        drained: dict = {}
        for k in evictor.evicts:    # populate_store's job<j>-task<t>
            g = ("default", "pg-" + k.split("/")[1].split("-")[0][3:])
            drained[g] = drained.get(g, 0) + 1
        check_binds(store, f"plugins_cycle {case} on {device}", drained)
        out.append({
            "binds": binds, "groups": groups,
            "evictions": list(evictor.evicts), "numa": numa_free(cache),
            "numa_pods": tap.last(),
            "reservation": (RESERVATION.target_job.name
                            if RESERVATION.target_job is not None else None,
                            sorted(RESERVATION.locked_nodes)),
            "launches": launches, "cycle_ms": ms, "flush_ms": flush_ms,
            "places": places})
    cache.stop()
    RESERVATION.reset()
    tdm_plugin._last_evict_at = 0.0
    return out


def check_plugin_case(case: str, runs: list, store_nodes: int) -> None:
    """What each (b) case must have exercised (on the card's runs, which
    equal the plain loop's)."""
    first, last = runs[0], runs[-1]
    if case.startswith("example_conf"):
        host = [pl["host_predicates"] for pl in first["places"]]
        if not first["binds"] or not first["numa_pods"] or \
                not numa_cpus(first["numa"]) or not host or None in host:
            fail(f"plugins_cycle {case}: {len(first['binds'])} binds, "
                 f"{first['numa_pods']} NUMA pods, host sweeps {host}")
        pruned = [pl["prune"] is not None for pl in first["places"]]
        if pruned != [case == "example_conf_pruned"] * len(pruned):
            fail(f"plugins_cycle {case}: prune records {pruned}")
    elif case == "tdm":
        # the active cycles put only revocable pods on the zone's nodes;
        # the closed one drains one of each job there (the default
        # disruption budget) and nothing else
        zone = {f"node-{i}" for i in range(0, store_nodes, 8)}
        on_zone = [k for k, n in runs[1]["binds"].items() if n in zone]
        revocable = [k for k in on_zone
                     if int(k.split("/")[1].split("-")[0][3:]) % 4 == 0]
        if not on_zone or len(revocable) != len(on_zone):
            fail(f"plugins_cycle tdm: {len(on_zone)} pods on the zone's "
                 f"nodes, {len(revocable)} of them revocable")
        jobs = {k.split("/")[1].split("-")[0] for k in on_zone}
        drained = last["evictions"]
        if runs[1]["evictions"] or len(drained) != len(jobs) or \
                {k.split("/")[1].split("-")[0] for k in drained} != jobs or \
                not set(drained) <= set(on_zone):
            fail(f"plugins_cycle tdm: evictions {runs[1]['evictions']} "
                 f"while the zone is active, then {len(drained)} of the "
                 f"{len(jobs)} jobs on the zone's nodes drained")
    else:
        res = [r["reservation"] for r in runs]
        locked = set(res[2][1])
        target = {last["binds"].get(f"default/target-task{t}")
                  for t in range(2)}
        if [r[0] for r in res] != ["pg-target"] * 3 + [None] or \
                [len(r[1]) for r in res[:3]] != [1, 2, 3] or \
                not target <= locked:
            fail(f"plugins_cycle reservation: reservations {res}, the "
                 f"target bound on {target}")


def plugins_cycle(dev, north_star: dict, late) -> dict:
    """Phase 15e: the scheduler's remaining plugins and actions (sla,
    overcommit, tdm, reservation with elect and reserve, numa-aware on
    the host-predicate mask) through the gang-allocate kernel: (a) at
    full width under examples/scheduler-conf.yaml, (b) the card against
    the plain loop in four cases, equal every cycle."""
    full = plugins_full_width(dev, north_star, late)
    cases = {}
    for case in PLUGIN_CASES:
        res = {device: plugins_case(case, device)
               for device in ("cuda", "cpu")}
        for c, (k, p) in enumerate(zip(res["cuda"], res["cpu"])):
            diff = {f: k[f] != p[f] for f in ("binds", "groups", "evictions",
                                              "numa", "numa_pods",
                                              "reservation")}
            if any(diff.values()):
                fail(f"plugins_cycle {case} cycle {c}: the card and the "
                     f"plain loop differ in "
                     f"{[f for f, d in diff.items() if d]}")
        check_plugin_case(case, res["cuda"], PLUGIN_CASES[case][0])
        k_runs, p_runs = res["cuda"], res["cpu"]
        cases[case] = {
            "nodes": PLUGIN_CASES[case][0], "pods": MID["n_tasks"],
            "cycles": len(k_runs),
            "binds": [len(r["binds"]) for r in k_runs],
            "evictions": [len(r["evictions"]) for r in k_runs],
            "numa_pods": [r["numa_pods"] for r in k_runs],
            "numa_cpus": [numa_cpus(r["numa"]) for r in k_runs],
            "reservation": [r["reservation"] for r in k_runs],
            "kernel_launches": [r["launches"] for r in k_runs],
            "kernel_ms": [[pl["kernel_ms"] for pl in r["places"]]
                          for r in k_runs],
            "host_predicates": [[pl["host_predicates"]
                                 for pl in r["places"]] for r in k_runs],
            "prune": [[pl["prune"] for pl in r["places"]] for r in k_runs],
            "cycle_ms": [r["cycle_ms"] for r in k_runs],
            "plain_cycle_ms": [r["cycle_ms"] for r in p_runs],
            "flush_ms": [r["flush_ms"] for r in k_runs],
            "mismatches": 0}
        line("plugins_cycle", part="card_vs_plain", case=case,
             **cases[case])
    return {"full_width": full, "cases": cases}


# scheduler_binary: every BINARY_VOLUMES-th gang's pods mount one claim
# each (utils/synth.py:volume_plan: the claims of every 8th such gang
# match no volume); the schedule period of the binary's candidates; the
# north star's unmatched gangs
BINARY_VOLUMES = 32
BINARY_PERIOD_S = 1.0
BINARY_CYCLES = 3          # the leader's placing cycle and two steady
BINARY_WAIT_S = 600.0
BINARY_CHURN_SEED = 17


class CycleRecorder:
    """Wraps Scheduler.run_once for the binary's threads: the launch count
    set to 0 just before each cycle and read just after, then the flush
    waited for and timed; one record a cycle, with the cycle's split."""

    def __init__(self):
        self.records = []
        self.errors = []
        self.cond = threading.Condition()
        self._orig = Scheduler.run_once

    def __enter__(self):
        orig = self._orig
        recorder = self

        def recorded(sched):
            if sched.elector is not None and not sched.elector.is_leader:
                return orig(sched)   # a standby's: nothing to count
            try:
                gang_allocate_cuda.launches = 0
                orig(sched)
                torch.cuda.synchronize()
                launches = gang_allocate_cuda.launches
                t0 = time.perf_counter()
                if not sched.cache.flush_executors(
                        timeout=cycle_cmd.FLUSH_TIMEOUT_S):
                    raise RuntimeError("the cache's executor did not drain")
                flush_ms = (time.perf_counter() - t0) * 1000.0
                lc = sched.last_cycle
                rec = {"sched": sched, "launches": launches,
                       "cycle_ms": lc["cycle_ms"], "flush_ms": flush_ms,
                       "allocate.stage_ms": lc.get("allocate.stage_ms"),
                       "volumes.plan_ms": lc.get("volumes.plan_ms"),
                       "volumes.bind_ms": lc.get("volumes.bind_ms"),
                       "backfill_ms": lc.get("backfill_ms"),
                       "kernel_ms": [pl["kernel_ms"] for pl in lc["places"]],
                       "places": lc["places"], "mode": lc["mode"]}
            except BaseException as e:
                # the scheduler's loop would log and go on: the phase
                # fails instead
                with recorder.cond:
                    recorder.errors.append(repr(e))
                    recorder.cond.notify_all()
                raise
            with recorder.cond:
                recorder.records.append(rec)
                recorder.cond.notify_all()

        Scheduler.run_once = recorded
        return self

    def __exit__(self, *exc):
        Scheduler.run_once = self._orig

    def wait(self, sched, n: int, ctx: str) -> list:
        """The first ``n`` records of ``sched``'s cycles."""
        deadline = time.monotonic() + BINARY_WAIT_S
        with self.cond:
            while True:
                if self.errors:
                    fail(f"scheduler_binary {ctx}: a cycle failed: "
                         f"{self.errors[0]}")
                mine = [r for r in self.records if r["sched"] is sched]
                if len(mine) >= n:
                    return mine[:n]
                left = deadline - time.monotonic()
                if left <= 0:
                    fail(f"scheduler_binary {ctx}: {len(mine)} of {n} "
                         f"cycles in {BINARY_WAIT_S:g} s")
                self.cond.wait(left)


def volume_facts(store: ObjectStore) -> dict:
    """What the volume checks read from the store: each claim's (phase,
    volume), each volume's (phase, claim), and the claim of each pod that
    mounts one with its node."""
    with store._lock:
        pvcs = {k: (c.phase, c.volume_name) for k, c in
                store._objects["persistentvolumeclaims"].items()}
        pvs = {k: (v.phase, v.claim_ref) for k, v in
               store._objects["persistentvolumes"].items()}
        mounts = {k: (f"{p.metadata.namespace}/"
                      f"{p.spec.volumes[0]['persistentVolumeClaim']['claimName']}",
                      p.spec.node_name)
                  for k, p in store._objects["pods"].items()
                  if p.spec.volumes}
    return {"pvcs": pvcs, "pvs": pvs, "mounts": mounts}


def placed(store: ObjectStore):
    """(binds, PodGroup phases) as the store holds them."""
    binds, groups = store_state(store)
    return binds, {k: g[0] for k, g in groups.items()}


def check_volumes(store: ObjectStore, n_jobs: int, gang: int,
                  ctx: str) -> dict:
    """Every bound pod's claim is Bound to a volume that holds it, no
    volume holds two claims, every pod of an unmatched gang (volume_plan)
    is unbound with its claim Pending and its gang not Running, and no
    volume of the unmatched class is taken. Returns the counts."""
    facts = volume_facts(store)
    pvcs, pvs = facts["pvcs"], facts["pvs"]
    claims, _ = volume_plan(n_jobs, gang, BINARY_VOLUMES)
    unmatched = {f"default/pg-{j}" for j, _, _, storage, _ in claims
                 if storage == UNMATCHED_CLAIM}
    for pod, (claim, node) in facts["mounts"].items():
        phase, vol = pvcs.get(claim, ("missing", ""))
        if node and (phase != "Bound" or pvs.get(vol) != ("Bound", claim)):
            fail(f"{ctx}: {pod} is bound but its claim {claim} is "
                 f"{phase} on {vol!r} ({pvs.get(vol)})")
    held = [c for _, c in pvs.values() if c]
    if len(held) != len(set(held)):
        fail(f"{ctx}: a claim is held by two volumes")
    vols = [v for phase, v in pvcs.values() if phase == "Bound"]
    if len(vols) != len(set(vols)):
        fail(f"{ctx}: a volume is bound to two claims")
    binds, groups = store_state(store)
    for key in unmatched:
        if groups[key][0] == "Running":
            fail(f"{ctx}: the unmatched gang {key} runs")
    unmatched_pods = [p for p, (c, _) in facts["mounts"].items()
                      if pvcs[c][0] != "Bound"]
    if any(p in binds for p in unmatched_pods):
        fail(f"{ctx}: a pod whose claim is unbound is bound")
    free = [v for v, (phase, c) in pvs.items() if phase == "Available"]
    for j, t, _, storage, _ in claims:
        if storage == UNMATCHED_CLAIM and \
                pvs[f"pv-job{j}-task{t}"] != ("Available", ""):
            fail(f"{ctx}: the unmatched gang pg-{j}'s volume was taken")
    return {"claims": len(pvcs), "claims_bound": len(vols),
            "volumes": len(pvs), "volumes_bound": len(held),
            "volumes_available": len(free), "unmatched_gangs": len(unmatched),
            "unmatched_pods": len(unmatched_pods), "binds": len(binds)}


def binary_args(conf_path: str):
    parser = argparse.ArgumentParser()
    scheduler_cmd.add_flags(parser)
    return parser.parse_args(["--leader-elect", "--scheduler-conf",
                              conf_path, "--schedule-period",
                              str(BINARY_PERIOD_S)])


def stop_candidate(sched) -> None:
    """End a candidate: its elector's loop (which releases the lease), its
    cycle loop and its cache."""
    sched.elector.stop(timeout=60.0)
    sched.stop()
    if sched.thread is not None:
        sched.thread.join(BINARY_WAIT_S)
    sched.cache.stop()


def binary_north_star(dev) -> dict:
    """scheduler_binary (a): the binary at the north star. Two candidates
    through cmd/scheduler.py:run_scheduler (--leader-elect, a 1 s period)
    on one store of populate_store(10,000 nodes, 6,250 gangs of 8,
    volumes=BINARY_VOLUMES) under the default conf plus binpack, read from
    a file: the leader's placing cycle and two steady ones; the standby's
    report; the leader released, the standby's takeover with a higher
    token, a write with the old token fenced, the new leader's cycle
    keeping the binds; then the conf file rewritten without binpack,
    which the new leader must run within two watcher intervals."""
    n_jobs = FULL["n_tasks"] // FULL["gang"]
    store = ObjectStore()
    t0 = time.perf_counter()
    populate_store(store, n_nodes=FULL["n_nodes"], n_jobs=n_jobs,
                   gang_size=FULL["gang"], volumes=BINARY_VOLUMES)
    populate_s = time.perf_counter() - t0
    out = {"populate_s": populate_s}
    with tempfile.TemporaryDirectory() as tmp, CycleRecorder() as rec:
        conf_path = f"{tmp}/scheduler.yaml"
        with open(conf_path, "w") as f:
            f.write(CYCLE_CONF.format(drf=""))
        args = binary_args(conf_path)
        cands = [scheduler_cmd.run_scheduler(store, args) for _ in range(2)]
        try:
            deadline = time.monotonic() + 60.0
            while not any(c.elector.is_leader for c in cands):
                if time.monotonic() > deadline:
                    fail("scheduler_binary: no candidate leads")
                time.sleep(0.01)
            leader = next(c for c in cands if c.elector.is_leader)
            standby = next(c for c in cands if c is not leader)
            if leader.device != dev:
                fail(f"scheduler_binary: the binary runs on "
                     f"{leader.device}")
            runs = rec.wait(leader, BINARY_CYCLES, "leader")
            if runs[0]["launches"] < 1:
                fail("scheduler_binary: the placing cycle launched no "
                     "kernel")
            check_launches("scheduler_binary placing", runs[0]["launches"],
                           runs[0]["places"], True)
            check_binds(store, "scheduler_binary")
            vols = check_volumes(store, n_jobs, FULL["gang"],
                                 "scheduler_binary")
            want = FULL["n_tasks"] - vols["unmatched_gangs"] * FULL["gang"]
            if vols["binds"] != want or \
                    vols["claims_bound"] != vols["claims"] - \
                    vols["unmatched_pods"]:
                fail(f"scheduler_binary: {vols}, {want} binds wanted")
            binds_before = placed(store)
            facts_before = volume_facts(store)
            # the standby does not schedule, and says why
            tracer.set_pending_report(None)
            standby.run_once()
            report = tracer.pending_report()
            if report is None or \
                    report.get("idle_reason") != pending.REASON_NOT_LEADER:
                fail(f"scheduler_binary: the standby's report {report}")
            old_token = leader.cache.fence_source()
            # release: the standby takes over at its next round
            t_release = time.perf_counter()
            leader.elector.stop(timeout=60.0)
            while not standby.elector.is_leader:
                if time.perf_counter() - t_release > 60.0:
                    fail("scheduler_binary: the standby did not take over")
                time.sleep(0.01)
            takeover_s = time.perf_counter() - t_release
            new_token = standby.elector.fencing_token
            if not new_token > old_token or store.fence_floor() != new_token:
                fail(f"scheduler_binary: token {old_token} -> {new_token}, "
                     f"floor {store.fence_floor()}")
            fenced0 = store.fenced_writes
            pod = store.get("pods", "job0-task0", "default")
            try:
                store.update("pods", pod, fence=old_token)
                fail("scheduler_binary: a write with the old token landed")
            except FencedError:
                pass
            if store.fenced_writes != fenced0 + 1:
                fail("scheduler_binary: the fenced write was not counted")
            after = rec.wait(standby, 1, "new leader")[0]
            if placed(store) != binds_before or \
                    volume_facts(store) != facts_before:
                fail("scheduler_binary: the new leader's cycle changed the "
                     "binds or the volumes")
            # the conf hot reload
            with open(conf_path, "w") as f:
                f.write(CYCLE_CONF.format(drf="").replace(
                    "  - name: binpack\n", ""))
            t_write = time.perf_counter()
            while any(p.name == "binpack" for tier in standby.conf.tiers
                      for p in tier.plugins):
                if time.perf_counter() - t_write > 2.5 * BINARY_PERIOD_S:
                    fail("scheduler_binary: the conf was not reloaded "
                         "within two watcher intervals")
                time.sleep(0.01)
            reload_s = time.perf_counter() - t_write
        finally:
            for c in cands:
                stop_candidate(c)
    if any(c.thread is not None and c.thread.is_alive() for c in cands):
        fail("scheduler_binary: a scheduler loop did not end")
    # Scheduler.run froze the process's objects out of the collector
    gc.unfreeze()
    keep = ("launches", "cycle_ms", "flush_ms", "allocate.stage_ms",
            "volumes.plan_ms", "volumes.bind_ms", "backfill_ms",
            "kernel_ms", "mode")
    out.update({
        "cycles": [{k: r[k] for k in keep} for r in runs],
        "new_leader_cycle": {k: after[k] for k in keep},
        "prune": prune_fields(runs[0]["places"]), "volumes": vols,
        "takeover_s": takeover_s, "tokens": [old_token, new_token],
        "fenced_writes": store.fenced_writes, "reload_s": reload_s,
        "standby_reason": report["idle_reason"]})
    return out


def binary_apply_modes(dev) -> dict:
    """scheduler_binary (b): the deferred apply (the default) against
    ``apply: eager`` at the north star: one warm cycle each on a fresh
    store of populate_store(10,000 nodes, 6,250 gangs of 8) under the
    default conf plus binpack; binds and PodGroups equal."""
    out = {}
    states = {}
    for mode in ("deferred", "eager"):
        store = ObjectStore()
        populate_store(store, n_nodes=FULL["n_nodes"],
                       n_jobs=FULL["n_tasks"] // FULL["gang"],
                       gang_size=FULL["gang"])
        cache = SchedulerCache(store)
        cache.run()
        conf = CYCLE_CONF.format(drf="")
        if mode == "eager":
            conf = with_solver(conf, apply="eager")
        sched = Scheduler(store, scheduler_conf=conf, cache=cache,
                          device=dev)
        gc.collect()
        gc.freeze()
        try:
            gang_allocate_cuda.launches = 0
            sched.run_once()
            torch.cuda.synchronize(dev)
            launches = gang_allocate_cuda.launches
            flush_ms = flush(cache, f"scheduler_binary {mode}")
        finally:
            gc.unfreeze()
        check_launches(f"scheduler_binary {mode}", launches,
                       sched.last_cycle["places"], True)
        check_binds(store, f"scheduler_binary {mode}")
        lc = sched.last_cycle
        out[mode] = {"launches": launches, "cycle_ms": lc["cycle_ms"],
                     "flush_ms": flush_ms,
                     "allocate_ms": lc["allocate_ms"],
                     "allocate.stage_ms": lc["allocate.stage_ms"],
                     "allocate.commit_ms": lc["allocate.commit_ms"],
                     "backfill_ms": lc["backfill_ms"],
                     "close_session_ms": lc["close_session_ms"],
                     "kernel_ms": [pl["kernel_ms"] for pl in lc["places"]]}
        states[mode] = store_state(store)
        cache.stop()
        del store, cache, sched
        gc.collect()
    if states["deferred"] != states["eager"]:
        (ab, ag), (bb, bg) = states["deferred"], states["eager"]
        fail(f"scheduler_binary: deferred and eager differ in "
             f"{sum(ab.get(k) != bb.get(k) for k in set(ab) | set(bb))} "
             f"binds and {sum(ag[k] != bg[k] for k in ag)} PodGroups")
    binds, groups = states["deferred"]
    if len(binds) != FULL["n_tasks"]:
        fail(f"scheduler_binary apply modes: {len(binds)} binds")
    out["binds"] = len(binds)
    return out


def volume_churn(store, cycle: int, order) -> dict:
    """scheduler_binary (c)'s churn before ``cycle`` (1 or 2), over MID's
    two unmatched gangs in the seeded ``order``: before the second cycle,
    volumes for the claims of the first (it binds then); before the
    third, one claim of the second deleted (it stays Pending) and two new
    gangs of 8 whose claims have volumes (they bind)."""
    n_jobs = MID["n_tasks"] // MID["gang"]
    claims, _ = volume_plan(n_jobs, MID["gang"], BINARY_VOLUMES)
    if cycle == 1:
        for j, t, name, _, cls in claims:
            if j == order[0]:
                store.create("persistentvolumes", obj.PersistentVolume(
                    metadata=obj.ObjectMeta(name=f"late-{name}"),
                    capacity="600Gi", storage_class=cls))
        return {"volumes_for": f"pg-{order[0]}"}
    name = next(n for j, t, n, _, _ in claims if j == order[1])
    store.delete("persistentvolumeclaims", name, "default")
    for j in (n_jobs, n_jobs + 1):
        store.create("podgroups", tu.build_pod_group(
            f"pg-{j}", "default", "default", MID["gang"], phase="Inqueue"))
        for t in range(MID["gang"]):
            claim = f"data-job{j}-task{t}"
            store.create("persistentvolumeclaims", obj.PersistentVolumeClaim(
                metadata=obj.ObjectMeta(name=claim, namespace="default"),
                spec={"resources": {"requests": {"storage": "20Gi"}},
                      "storageClassName": "standard"}))
            store.create("persistentvolumes", obj.PersistentVolume(
                metadata=obj.ObjectMeta(name=f"pv-{claim}"),
                capacity="25Gi", storage_class="standard"))
            pod = tu.build_pod("default", f"job{j}-task{t}", "", "Pending",
                               {"cpu": "2", "memory": "4Gi"},
                               groupname=f"pg-{j}")
            pod.spec.volumes = [{"name": "data", "persistentVolumeClaim":
                                 {"claimName": claim}}]
            store.create("pods", pod)
    return {"claim_deleted": name,
            "new_gangs": [f"pg-{n_jobs}", f"pg-{n_jobs + 1}"]}


def binary_card_vs_plain_run(device, case: str) -> list:
    """scheduler_binary (c) on one device: MID's populate_store cluster
    with volumes, the executor live, three incremental cycles with
    volume_churn between them (case ``churn``), or two cycles with the
    deferred apply of gang pg-1 failing before its commit in the first
    (case ``apply_failure``). Per cycle: binds, PodGroups, claims and
    volumes, the churn, launches and ms."""
    store = ObjectStore()
    populate_store(store, n_nodes=MID["n_nodes"],
                   n_jobs=MID["n_tasks"] // MID["gang"],
                   gang_size=MID["gang"], volumes=BINARY_VOLUMES)
    cache = SchedulerCache(store)
    cache.run()
    sched = Scheduler(store, scheduler_conf=CYCLE_CONF.format(drf=""),
                      cache=cache, device=device)
    claims, _ = volume_plan(MID["n_tasks"] // MID["gang"], MID["gang"],
                            BINARY_VOLUMES)
    order = [int(j) for j in np.random.default_rng(BINARY_CHURN_SEED)
             .permutation(sorted({j for j, _, _, storage, _ in claims
                                  if storage == UNMATCHED_CLAIM}))]
    apply = statement_mod._DeferredBatch.apply
    failed = []

    def failing_apply(op, ssn):
        if op.job.name == "pg-1" and not failed:
            failed.append(op.job.name)
            raise RuntimeError("injected deferred apply failure")
        return apply(op, ssn)

    rows = []
    cycles = 3 if case == "churn" else 2
    session_log = logging.getLogger("volcano_tpu_torch.framework.session")
    level = session_log.level
    try:
        for c in range(cycles):
            churn = volume_churn(store, c, order) \
                if case == "churn" and c else None
            if case == "apply_failure" and c == 0:
                statement_mod._DeferredBatch.apply = failing_apply
                # the failure's expected traceback stays off the output
                session_log.setLevel(logging.CRITICAL)
            gang_allocate_cuda.launches = 0
            try:
                sched.run_once()
            finally:
                statement_mod._DeferredBatch.apply = apply
                session_log.setLevel(level)
            launches = gang_allocate_cuda.launches
            flush_ms = flush(cache, f"scheduler_binary {case} cycle {c}")
            binds, groups = store_state(store)
            facts = volume_facts(store)
            rows.append({"binds": binds, "groups": groups,
                         "pvcs": facts["pvcs"], "pvs": facts["pvs"],
                         "churn": churn, "failed": list(failed),
                         "launches": launches,
                         "cycle_ms": sched.last_cycle["cycle_ms"],
                         "flush_ms": flush_ms})
        check_binds(store, f"scheduler_binary {case}")
    finally:
        cache.stop()
    return rows


def binary_card_vs_plain(dev) -> dict:
    """scheduler_binary (c): the card against the plain loop at 4,096
    pods x 2,048 nodes with volumes, equal in binds, PodGroups, claims
    and volumes after every cycle, in both cases of
    binary_card_vs_plain_run."""
    out = {}
    for case in ("churn", "apply_failure"):
        card = binary_card_vs_plain_run(dev, case)
        plain = binary_card_vs_plain_run(torch.device("cpu"), case)
        keys = ("binds", "groups", "pvcs", "pvs", "churn", "failed")
        for c, (a, b) in enumerate(zip(card, plain)):
            diff = [k for k in keys if a[k] != b[k]]
            if diff:
                fail(f"scheduler_binary {case} cycle {c}: the card's and "
                     f"the plain loop's {diff} differ")
        if case == "churn":
            late = card[1]["churn"]["volumes_for"]
            if card[0]["launches"] < 1 or \
                    card[0]["groups"][f"default/{late}"][0] == "Running" or \
                    card[1]["groups"][f"default/{late}"][0] != "Running":
                fail(f"scheduler_binary churn: {late} did not wait for its "
                     f"volumes and then bind")
            for g in card[2]["churn"]["new_gangs"]:
                if card[2]["groups"][f"default/{g}"][0] != "Running":
                    fail(f"scheduler_binary churn: the new gang {g} did "
                         f"not bind")
            deleted = card[2]["churn"]["claim_deleted"]
            gone = f"default/pg-{deleted.split('-')[1][3:]}"
            if f"default/{deleted}" in card[2]["pvcs"] or \
                    card[2]["groups"][gone][0] == "Running":
                fail(f"scheduler_binary churn: {gone} runs without its "
                     f"deleted claim")
        else:
            first, second = card
            if first["failed"] != ["pg-1"] or \
                    first["groups"]["default/pg-1"][0] == "Running" or \
                    any(k.startswith("default/job1-") for k in first["binds"]) \
                    or second["groups"]["default/pg-1"][0] != "Running":
                fail(f"scheduler_binary apply_failure: pg-1 "
                     f"{first['groups']['default/pg-1'][0]} then "
                     f"{second['groups']['default/pg-1'][0]}")
        out[case] = {
            "cycles": len(card),
            "binds": [len(r["binds"]) for r in card],
            "claims_bound": [sum(p == "Bound" for p, _ in r["pvcs"].values())
                             for r in card],
            "churn": [r["churn"] for r in card],
            "kernel_launches": [r["launches"] for r in card],
            "cycle_ms": [r["cycle_ms"] for r in card],
            "flush_ms": [r["flush_ms"] for r in card],
            "plain_cycle_ms": [r["cycle_ms"] for r in plain],
            "mismatches": 0}
        line("scheduler_binary", part="card_vs_plain", case=case,
             shape={"tasks": MID["n_tasks"], "nodes": MID["n_nodes"],
                    "gang": MID["gang"], "volumes_every": BINARY_VOLUMES},
             **out[case])
    return out


def scheduler_binary(dev) -> dict:
    """Phase 15f: the scheduler binary (cmd/scheduler.py) with leader
    election, the conf hot reload, the deferred apply and the store's
    volume binder, through the gang-allocate kernel: (a)
    binary_north_star, (b) binary_apply_modes, (c) binary_card_vs_plain."""
    t_phase = time.perf_counter()
    full = binary_north_star(dev)
    line("scheduler_binary", part="north_star",
         shape={"tasks": FULL["n_tasks"], "nodes": FULL["n_nodes"],
                "gang": FULL["gang"], "volumes_every": BINARY_VOLUMES},
         **full)
    modes = binary_apply_modes(dev)
    line("scheduler_binary", part="apply_modes",
         shape={"tasks": FULL["n_tasks"], "nodes": FULL["n_nodes"],
                "gang": FULL["gang"]}, **modes)
    cases = binary_card_vs_plain(dev)
    return {"north_star": full, "apply_modes": modes, "cases": cases,
            "seconds": time.perf_counter() - t_phase}


def cycles_group(dev) -> dict:
    """Phases 9-11, 15e and 12: the north-star cycle and the constrained
    one, the kernel against its plain version on their inputs (the plain
    loop in this group's own LatePlain workers), plugins_cycle on the warm
    north-star cycle, and the victim cases at mid size. Returns, per
    kernel, the kernels line's entries they give."""
    late = LatePlain()
    try:
        cycle_launches, cycles, reduced = cycle(dev)
        cyc = cycle_inputs_vs_plain(dev, late, reduced=reduced)
        con_launches, con_cycles, con_reduced = cycle_constrained(dev)
        con = cycle_inputs_vs_plain(dev, late, HEAVY, reduced=con_reduced)
        for phase, runs, held, taps in (("cycle", cycles, cyc, reduced),
                                        ("cycle_constrained", con_cycles,
                                         con, con_reduced)):
            # the warm cycle made a reduced-width launch exactly when its
            # place's prune outcome says so, and that launch's inputs are
            # the ones held against the plain loop above
            prunes = [pl["prune"] for pl in runs[-1]["places"]]
            made = [p is not None and p["fallback"] in (
                None, "shortlist_exhausted") for p in prunes]
            if sum(made) != len(taps):
                fail(f"{phase}: {len(taps)} reduced launches captured for "
                     f"prune outcomes {prunes}")
            # a place's launch report is its last launch's: the reduced
            # run's where it served, else the full-width run's
            for r in runs:
                want = [held["reduced"]["refreshes"]
                        if pl["prune"] is not None and pl["prune"]["served"]
                        else held["refreshes"] for pl in r["places"]]
                if [pl["launch"][0] for pl in r["places"]] != want:
                    fail(f"{phase}: the cycle's launches and the kernel run "
                         f"on their inputs refreshed their tables a "
                         f"different number of times")
        warm = cycles[1:]
        north_prune, con_prune = (place_prune(runs[-1]["places"][0])
                                  for runs in (cycles, con_cycles))
        # early, so that the plain loop on its full-width launch runs on
        # the host while victims_vs_plain runs on the card
        plugins = plugins_cycle(dev, warm[-1], late)
        victims_vs_plain()
        # the plain loop's full-size runs, held against the kernel's results
        late.finish()
    finally:
        late.close()
    # the kernel against the plain loop on the inputs the warm cycles
    # launched on (pruned: the reduced ones)
    held_cyc, held_con = (h.get("reduced", h) for h in (cyc, con))
    runs = plugins["full_width"]["runs"]
    return {"gang_allocate": {
        "launches_per_cycle": cycle_launches[-1],
        "plugins_cycle": {
            "launches": [r["launches"] for r in runs],
            "kernel_ms": [r["kernel_ms"] for r in runs],
            "host_predicates_ms": runs[0]["host_predicates_ms"],
            "groups": runs[0]["groups"],
            "cycle_ms": [r["cycle_ms"] for r in runs],
            "held": [{k: h[k] for k in ("shape", "assign_mismatches",
                                        "max_abs_err", "plain_ms")}
                     for h in runs[0]["held"]],
            "cases_launches": {c: v["kernel_launches"]
                               for c, v in plugins["cases"].items()}},
        "cycle_kernel_ms": [sum(pl["kernel_ms"] for pl in r["places"])
                            for r in warm],
        "cycle_ms": [r["cycle_ms"] for r in warm],
        "prune": north_prune,
        "cycle_inputs": {k: held_cyc[k] for k in (
            "plain_ms", "max_abs_err", "assign_mismatches")}
        | {"ms": min(held_cyc["kernel_ms"]), "N": held_cyc["N"]}},
        "gang_allocate_slots": {
            "launches": con_launches[-1],
            "max_abs_err": held_con["max_abs_err"],
            "ms": min(held_con["kernel_ms"]),
            "plain_ms": held_con["plain_ms"], "plain_device": "cpu",
            "bound_ms": max(held_con["bytes_ms"], held_con["ops_ms"]),
            "bound_by": "bytes"
            if held_con["bytes_ms"] >= held_con["ops_ms"] else "operations",
            "library_ms": None, "slots": con["slots"],
            "plan": con["plan"], "R": con["R"],
            "refreshes": con["refreshes"],
            "rule_refreshes": con["rule_refreshes"], "steps": con["steps"],
            "cycle_kernel_ms": [sum(pl["kernel_ms"] for pl in r["places"])
                                for r in con_cycles[1:]],
            "cycle_ms": [r["cycle_ms"] for r in con_cycles[1:]],
            "constraint_ms": [sum(pl["constraint_ms"] for pl in r["places"])
                              for r in con_cycles[1:]],
            "prune": con_prune,
            "checked_against_plain": True,
            "assign_mismatches": held_con["assign_mismatches"],
            "N": held_con["N"]}}


def binary_victims_group(dev) -> dict:
    """Phases 15f, 13, 14, 15 and 15c: the scheduler binary, the preempt
    and reclaim cycles at full size, the victim prefix functions and the
    incremental cycle. Returns, per kernel, the kernels line's entries
    they give."""
    binary = scheduler_binary(dev)
    preempt = victim_cycle("preempt")
    reclaim = victim_cycle("reclaim")
    victim_prefix_phase(dev)
    incr = incremental_cycle(dev)
    north = binary["north_star"]
    return {"gang_allocate": {
        "launches_per_incremental_cycle": {
            case: {kind: sorted({n for k, q, n in zip(
                r["incremental"]["kind"], r["incremental"]["quiet"],
                r["incremental"]["kernel_launches"])
                if (q if kind == "quiet" else k == kind and not q)})
                for kind in ("quiet", "churn")}
            for case, r in incr.items()},
        "scheduler_binary": {
            "launches": [r["launches"] for r in north["cycles"]],
            "kernel_ms": [r["kernel_ms"] for r in north["cycles"]],
            "new_leader_launches": north["new_leader_cycle"]["launches"],
            "apply_modes_launches": {
                m: binary["apply_modes"][m]["launches"]
                for m in ("deferred", "eager")},
            "cases_launches": {c: v["kernel_launches"]
                               for c, v in binary["cases"].items()},
            "seconds": binary["seconds"]},
        "launches_per_preempt_cycle": preempt["launches"],
        "launches_per_reclaim_cycle": reclaim["launches"],
        "preempt_cycle_kernel_ms": [pl["kernel_ms"]
                                    for pl in preempt["split"]["places"]],
        "reclaim_cycle_kernel_ms": [pl["kernel_ms"]
                                    for pl in reclaim["split"]["places"]]}}


def commit_group(dev) -> dict:
    """Phases 15b, 15d and 15g: the traced cycle, the write-behind commit
    and the native commit path. Returns, per kernel, the kernels line's
    entries they give."""
    traced = traced_cycle(dev)
    flushed = flush_cycle(dev)
    native = native_commit(dev, traced["commit"])
    return {"gang_allocate": {
        "traced_cycle": {k: traced[k] for k in (
            "overhead_pct", "overhead_median_pct", "cycle_ms_on",
            "cycle_ms_off", "steady_overhead_pct",
            "steady_overhead_median_pct",
            "span_kernel_ms", "solver_kernel_ms")},
        "launches_per_flush_cycle": flushed["full_width"]["live"][-1][
            "launches"],
        "launches_per_native_commit_cycle": native["launches"]}}


# the phases after the kernel's own, in groups that need nothing of each
# other: by default each group runs in a process of its own (this script
# with --group), all at once and beside main's phases 3-8, on the one card
GROUPS = {"cycles": cycles_group, "binary_victims": binary_victims_group,
          "commit": commit_group}
# a group's process prints its result as its last line, after this tag
RESULT_TAG = "chip_smoke group result: "
PR_SET_PDEATHSIG = 1        # linux/prctl.h


def share_threads() -> None:
    """torch's CPU threads in each of the processes that run at once (main
    and one per group): an equal share of the host's cores."""
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // (1 + len(GROUPS))))


class Groups:
    """The GROUPS, each in a process of its own, started at once. Their
    lines reach stdout whole through this process, and their results come
    from their tagged last lines. A group that exits non-zero interrupts
    the main thread; ``close`` kills what is left of every group, the
    group's own worker processes included (each group is a session)."""

    def __init__(self):
        env = dict(os.environ, CHIP_SMOKE_STARTED=repr(STARTED))
        self.results = {}
        self.failed = []
        self.procs = {name: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--group", name],
            stdout=subprocess.PIPE, text=True, env=env,
            start_new_session=True) for name in GROUPS}
        self.threads = [threading.Thread(target=self._relay, args=item,
                                         daemon=True)
                        for item in self.procs.items()]
        for t in self.threads:
            t.start()

    def _relay(self, name, proc) -> None:
        for text in proc.stdout:
            if text.startswith(RESULT_TAG):
                self.results[name] = json.loads(text[len(RESULT_TAG):])
            else:
                emit(text)
        if proc.wait() != 0:
            self.failed.append(name)
            _thread.interrupt_main()

    def wait(self) -> dict:
        for t in self.threads:
            t.join()
        missing = sorted(set(GROUPS) - set(self.results))
        if self.failed or missing:
            fail(f"phase groups {self.failed or missing} failed")
        return self.results

    def close(self) -> None:
        for proc in self.procs.values():
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Chip smoke test of the PyTorch/CUDA port on one H100.")
    parser.add_argument("--group", choices=sorted(GROUPS),
                        help="run only this phase group and print its "
                             "result (what the default run starts; alone, "
                             "its host times carry no other group's load)")
    opts = parser.parse_args()
    dev = torch.device("cuda", 0)
    if opts.group:
        # the group dies with the script, however the script ends
        ctypes.CDLL(None).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
        share_threads()
        emit(RESULT_TAG + json.dumps(GROUPS[opts.group](dev)) + "\n")
        return
    name = torch.cuda.get_device_name(dev)
    cap = torch.cuda.get_device_capability(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    line("device", name=name, capability=list(cap), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())
    if tuple(cap) != (9, 0):
        fail(f"capability {cap}: the kernels are built for sm_90a")

    t0 = time.perf_counter()
    libs = build.build_all()
    kernels_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    libs["fastmodel"] = native_build.build()
    native_s = time.perf_counter() - t0
    line("build", seconds=kernels_s + native_s, native_seconds=native_s,
         libraries={k: v.name for k, v in sorted(libs.items())},
         ptxas=ptxas_usage(build.report("gang_allocate")))
    share_threads()
    groups = Groups()
    late = LatePlain()
    atexit.register(late.close)
    # first on the way out: the groups stop before main's workers drain
    atexit.register(groups.close)

    # ---- 3. kernel against plain at the mid size
    mid = kernel_vs_plain_mid(dev)

    # ---- 4. the main path at full size
    sa = synth_arrays(FULL["n_tasks"], FULL["n_nodes"],
                      gang_size=FULL["gang"], seed=42, utilization=0.3)
    weights = ScoreWeights.make(sa.group_req.shape[1], binpack=1.0,
                                device=dev)
    t0 = time.perf_counter()
    solver = DenseSolver(sa, weights, dev)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    gang_allocate_cuda.launches = 0
    runs = []
    for i in range(4):          # one warm-up, three timed runs
        t0 = time.perf_counter()
        out = solver.place()
        torch.cuda.synchronize(dev)
        runs.append(((time.perf_counter() - t0) * 1000.0, out.kernel_ms,
                     launch_stats()))
    launches = gang_allocate_cuda.launches
    if launches == 0:
        fail("the main path never launched the gang_allocate kernel")
    assign, pipelined = to_np(out.assign), to_np(out.pipelined)
    ready, kept = to_np(out.ready), to_np(out.kept)
    if assign.shape != sa.task_group.shape or \
            not np.all((assign >= -1) & (assign < sa.node_idle.shape[0])):
        fail("assign has the wrong shape or out-of-range nodes")
    if not replay_feasible(sa, assign, pipelined):
        fail("full size: placements do not replay feasibly")
    if not gang_atomic(sa, assign, ready, kept):
        fail("full size: the result is not gang-atomic")
    if not (np.isfinite(to_np(out.job_total_vec)).all()
            and np.isfinite(to_np(out.node_alloc_vec)).all()):
        fail("full size: non-finite decoded totals")
    placed = int((assign >= 0).sum())
    if placed == 0:
        fail("full size: nothing was placed")
    timed_runs = runs[1:]
    line("main_path", shape=sa.shapes, setup_s=setup_s,
         launches=launches, placed=placed, ready_jobs=int(ready.sum()),
         kept_jobs=int(kept.sum()),
         kernel_ms=[k for _, k, _ in timed_runs],
         place_ms=[p for p, _, _ in timed_runs],
         refreshes=[n["refreshes"] for _, _, n in timed_runs],
         warmup_place_ms=runs[0][0],
         max_memory_allocated=torch.cuda.max_memory_allocated(dev))

    # ---- 5. the kernel against plain on the main path's inputs
    args = convert.args(solver.arrays)
    names = list(convert.FIELDS)
    args[names.index("group_mask")] = solver.static_mask()
    got, ms = timed(lambda: gang_allocate_cuda(*args, solver.weights))
    kernel_runs = [ms] + [timed(lambda: gang_allocate_cuda(
        *args, solver.weights))[1] for _ in range(2)]
    if not np.array_equal(to_np(got[0]), assign):
        fail("the kernel run alone differs from the main path's result")
    n_refresh = refreshes()
    main_stats = runs[-1][2]
    if main_stats["cluster_blocks"] < 2:
        fail("the main path's kernel launch ran as a single block")
    if main_stats["refreshes"] != n_refresh:
        fail("the main path's launch and the kernel run alone refreshed "
             "their tables a different number of times")
    steps = int(sa.job_n_tasks.sum())
    N, R = sa.node_idle.shape
    bytes_ms, ops_ms, no_fma_ops_ms = bound(args, [], got[:4], n_refresh,
                                            steps, N, R)
    full = {}

    def print_full(res):
        full.update(res)
        line("kernel_vs_plain", case="main_path_inputs", shape=sa.shapes,
             **res, kernel_ms=kernel_runs, refreshes=n_refresh,
             bytes_ms=bytes_ms, ops_ms=ops_ms, no_fma_ops_ms=no_fma_ops_ms,
             steps=steps)
    late.submit("full size", sa, got, args, solver.weights, {}, print_full)

    # where the step's time goes: the same task count over fewer nodes
    # separates the per-step fixed cost from the per-node sweep
    scaling = {}
    for n_nodes in (1024, 2560, 5120):
        small = synth_arrays(FULL["n_tasks"], n_nodes, gang_size=FULL["gang"],
                             seed=42, utilization=0.3)
        t, _ = convert.from_reference(small.as_dict(), None, dev)
        s_args = convert.args(t)
        gang_allocate_cuda(*s_args, solver.weights)          # warm-up
        _, s_ms = timed(lambda: gang_allocate_cuda(*s_args, solver.weights))
        scaling[small.node_idle.shape[0]] = s_ms
    scaling[N] = min(kernel_runs)
    line("sweep_scaling", steps=steps,
         us_per_step={n: ms * 1e3 / steps for n, ms in scaling.items()})

    # ---- 6. the table's worst case: gang 1 changes group every step, so
    # every step refreshes
    worst = synth_arrays(FULL["n_tasks"], FULL["n_nodes"], gang_size=1,
                         seed=42, utilization=0.3)
    t, _ = convert.from_reference(worst.as_dict(), None, dev)
    w_args = convert.args(t)
    gang_allocate_cuda(*w_args, solver.weights)              # warm-up
    worst_runs = [timed(lambda: gang_allocate_cuda(*w_args, solver.weights))
                  for _ in range(3)]
    w_out = worst_runs[-1][0]
    w_refresh = refreshes()
    if not replay_feasible(worst, to_np(w_out[0]), to_np(w_out[1])):
        fail("gang 1: placements do not replay feasibly")
    if not gang_atomic(worst, to_np(w_out[0]), to_np(w_out[2]),
                       to_np(w_out[3])):
        fail("gang 1: the result is not gang-atomic")
    w_steps = int(worst.job_n_tasks.sum())
    w_ms = min(ms for _, ms in worst_runs)
    # t = refreshes * x + steps * y over the two runs: x is what a refresh
    # adds to a step, y a served step (job boundaries folded in)
    k_ms = min(kernel_runs)
    per_refresh_us = ((w_ms - k_ms * w_steps / steps) * 1e3
                      / (w_refresh - n_refresh * w_steps / steps))
    per_step_us = (k_ms * 1e3 - n_refresh * per_refresh_us) / steps
    line("refresh_worst_case", shape=worst.shapes, steps=w_steps,
         refreshes=w_refresh, kernel_ms=[ms for _, ms in worst_runs],
         placed=int((to_np(w_out[0]) >= 0).sum()),
         us_per_refresh=per_refresh_us, us_per_served_step=per_step_us,
         gang8_refreshes=n_refresh, gang8_steps=steps)

    shapes = shapes_vs_plain(dev, args, solver.weights, sa)
    cycle_vs_plain()
    prune_vs_plain()
    results = groups.wait()
    # the plain loop's run on the main path's inputs, held against the
    # kernel's result
    late.finish()

    mid_cases = {k: {"ms": v["ms"], "plain_ms": v["plain_ms"],
                     "refreshes": v["refreshes"],
                     "assign_mismatches": v["assign_mismatches"]}
                 for k, v in mid.items()}
    kernels = [{
        "name": "gang_allocate", "route": "cuda",
        "source": "volcano_tpu_torch/csrc/gang_allocate.cu",
        "replaces": "volcano_tpu/ops/pallas_allocate.py:55",
        "launches": launches, "max_abs_err": full["max_abs_err"],
        "ms": min(kernel_runs), "plain_ms": full["plain_ms"],
        "plain_device": "cpu",
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "no_fma_ops_ms": no_fma_ops_ms, **main_stats, "R": R,
        "shapes": shapes,
        "worst_case_ms": w_ms, "worst_case_refreshes": w_refresh,
        "shape": sa.shapes, "checked_against_plain": True,
        "assign_mismatches": full["assign_mismatches"],
        "mid_cases": mid_cases}, {
        "name": "gang_allocate_slots", "route": "cuda",
        "source": "volcano_tpu_torch/csrc/gang_allocate.cu",
        "replaces": "volcano_tpu/ops/pallas_allocate.py:55",
        "shape": {"tasks": FULL["n_tasks"], "nodes": FULL["n_nodes"],
                  **HEAVY},
        "mid_cases": {k: v for k, v in mid_cases.items()
                      if mid[k]["slots"]}}]
    for res in results.values():
        for k in kernels:
            k.update(res.get(k["name"], {}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        fail("stopped: a phase group failed (its error is above)")
