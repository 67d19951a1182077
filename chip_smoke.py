"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one Hopper GPU and nvcc
(under $CUDA_HOME or /usr/local/cuda). Phases, each printing one line:

1. device: the card's name and capability (must be 9.0), and
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
2. build: every kernel of volcano_tpu_torch/csrc, compiled with nvcc, and
   ptxas's registers and spills of the R = 4 gang-allocate kernels;
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
5. the kernel against its plain version on the main path's own inputs,
   each timed once, and the bound of the kernel's work; then the kernel's
   time per step at 50,000 tasks over fewer nodes;
6. the table's worst case: 50,000 tasks of gang 1 over 10,000 nodes, the
   kernel alone after a warm-up (no plain run: it would take minutes),
   feasible and gang-atomic; with the gang-8 main-path inputs it splits
   the kernel's time into microseconds per refresh and per served step;
7. cycle_vs_plain: the scheduling cycle through the objects,
   ``Scheduler(store, device="cuda").run_once()`` against the same cycle
   with ``device="cpu"`` (the plain loop), each on its own store built by
   the same seeded builders, at 4,096 tasks x 2,048 nodes in gangs of 8:
   one queue; four queues (weights 1, 2, 4, 1, the last capped) in three
   namespaces with drf's live namespace order; tight capacity with zone
   selectors and NoSchedule taints, where gangs roll back; and the
   constrained mix (populate_store over 8 zones, every 4th gang spread
   with max_skew 1, every 8th one replica per zone). Binds must be
   equal pod for pod and PodGroup phases gang for gang, the binds must
   replay within every node's allocatable, every gang be all-or-nothing,
   every spread gang keep max_skew 1 and every anti gang one replica a
   zone;
8. cycle: the port's main path through the objects at the north star's
   size, volcano_tpu_torch.cmd.cycle.run_cycle: populate_store(10,000
   nodes, 6,250 gangs of 8), a fresh cache, one Scheduler.run_once with
   the default conf plus binpack; one cold and one warm run on fresh
   stores, the launch count set to 0 just before each cycle and read just
   after. Each prints populate and sync seconds, the cycle's wall ms and
   its split, the kernel's CUDA-event ms and launch report, binds (all
   50,000), committed gangs (all 6,250) and peak device memory; the binds
   must replay within allocatable and be gang-atomic;
9. the kernel against its plain version on the cycle's own inputs at
   that size (R = 2, the encode of the allocate action's phase-A batch),
   held exactly like phase 5;
10. cycle_constrained: the slot path, the constrained mix of phase 7 at
    the north star's size (50,000 pods, 10,000 nodes), one cold and one
    warm run, each with the launch count set to 0 just before and read
    just after; each prints the cycle's split with the constraint passes'
    ms, the kernel's CUDA-event ms and table refreshes, binds and
    committed gangs, and fails on an infeasible bind, a broken gang, or a
    spread or anti-affinity violation; then that cycle's own kernel
    inputs (with task_slot and slot_ok) against the plain loop once, and
    the kernel's refreshes against the count its rule gives;
11. victims_vs_plain: preempt and reclaim through the objects, the
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
12. preempt_cycle and 13. reclaim_cycle: the same paths at the
    reference's full size (10,000 nodes, 1,250 victim gangs, 625 waiting
    gangs of 8), each on fresh stores: one cold and one warm GPU cycle
    and one CPU cycle held equal to the warm one as in phase 11; each
    prints populate and sync seconds, the cycle's wall ms and split (the
    kernel's CUDA-event ms and launches, preempt_ms or reclaim_ms, the
    commit), evictions, pipelined tasks and peak device memory, and
    fails if nothing is evicted or the kernel does not launch exactly
    once a GPU cycle;
14. victim_prefix: the batched torch prefix functions of
    ops/preempt.py at 5,000 preemptors x 10,000 nodes, on the preempt
    path's own tensors (V = 1) and on a seeded V = 8, R = 2 case, on the
    card (three timed runs after a warm-up) and on the CPU: feasible,
    n_evict, covered and pick_best_node must be equal; prints the card's
    ms and the bound of the bytes the function must move;
15. the kernels line (with the table refreshes, the cluster's blocks and
    each block's shared memory, as the main path's launch reported them,
    and the kernel's launches per cycle, per preempt and per reclaim
    cycle; a second entry for the slot path), then the card's nvidia-smi
    line, then {"ok": true, "device": {...}} as the last line.

Any failed check exits non-zero before the last line. Without a CUDA
device, or without the volcano_tpu_torch package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import re
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    raise SystemExit(2)

from volcano_tpu_torch import convert  # noqa: E402
from volcano_tpu_torch.apiserver import ObjectStore  # noqa: E402
from volcano_tpu_torch.cmd import cycle as cycle_cmd  # noqa: E402
from volcano_tpu_torch.framework.solver import DenseSolver  # noqa: E402
from volcano_tpu_torch.ops import allocate, build  # noqa: E402
from volcano_tpu_torch.ops.cuda_allocate import (  # noqa: E402
    gang_allocate_cuda)
from volcano_tpu_torch.ops.fairshare import proportion_waterfill  # noqa: E402
from volcano_tpu_torch.models import objects as obj  # noqa: E402
from volcano_tpu_torch.models.resource import Resource  # noqa: E402
from volcano_tpu_torch.ops.score import ScoreWeights  # noqa: E402
from volcano_tpu_torch.scheduler import Scheduler  # noqa: E402
from volcano_tpu_torch.utils import test_utils as tu  # noqa: E402
from volcano_tpu_torch.utils.synth import (  # noqa: E402
    populate_preempt_store, populate_reclaim_store, populate_store,
    synth_arrays, zone_slots)

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
FULL = dict(n_tasks=50_000, n_nodes=10_000, gang=8)
# the reference's constraint benchmark mix (bench.py:455's "heavy")
HEAVY = dict(zones=8, spread_every=4, anti_every=8)
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


def line(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    state_err = max(float((s1.idle - s2.idle).abs().max()),
                    float((s1.future - s2.future).abs().max()))
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
    report, for the R = 4 instantiations (the shapes chip_smoke runs)."""
    usage, name = {}, None
    for text in log.splitlines():
        m = re.search(r"Function properties for (\S+)", text)
        if m:
            name = m.group(1)
            continue
        if name is None or "gang_allocate_kernelILi4E" not in name:
            continue
        key = "R4_B" + re.search(r"ILi4ELi(\d+)E", name).group(1)
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
    """What the kernel's last launch reported of itself."""
    n, blocks, shared = gang_allocate_cuda.last_stats.tolist()
    return {"refreshes": n, "cluster_blocks": blocks,
            "shared_bytes_per_block": shared}


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
    and gangs with the HEAVY constraint mix."""
    rng = np.random.default_rng(seed)
    n_nodes, n_jobs, gang = MID["n_nodes"], MID["n_tasks"] // 8, MID["gang"]
    store = ObjectStore()
    if case == "constrained":
        populate_store(store, n_nodes=n_nodes, n_jobs=n_jobs, gang_size=gang,
                       **HEAVY)
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


def check_binds(store: ObjectStore, ctx: str) -> None:
    """The binds replay feasibly against every node's allocatable (cpu,
    memory and pod count), and every gang is all-or-nothing: a PodGroup
    has no bound pod or at least minMember."""
    alloc = {n.metadata.name: Resource.from_resource_list(
        n.status.allocatable) for n in store.list("nodes")}
    used = {name: Resource() for name in alloc}
    count = dict.fromkeys(alloc, 0)
    per_group: dict = {}
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


def cycle_vs_plain() -> None:
    """Phase 7: the cycle through the objects on the GPU against the same
    cycle with the plain loop on the CPU, at MID's size, in four cases;
    binds and PodGroup phases must be equal."""
    for case, seed, drf in (("one_queue", 1, ""),
                            ("four_queues", 2,
                             "\n    enableNamespaceOrder: true"),
                            ("tight", 3, ""), ("constrained", 4, "")):
        conf = CYCLE_CONF.format(drf=drf)
        res = {}
        for device in ("cuda", "cpu"):
            store = cycle_store(case, seed)
            sched = Scheduler(store, scheduler_conf=conf, device=device)
            sched.cache.run()
            launches0 = gang_allocate_cuda.launches
            t0 = time.perf_counter()
            sched.run_once()
            res[device] = (cycle_outcome(store),
                           (time.perf_counter() - t0) * 1000.0,
                           gang_allocate_cuda.launches - launches0,
                           sched.last_cycle)
            check_binds(store, f"cycle_vs_plain {case} on {device}")
            if case == "constrained":
                gangs = check_constraints(
                    store, f"cycle_vs_plain {case} on {device}")
        (k_binds, k_phases, k_unsched), k_ms, k_launches, k_split = \
            res["cuda"]
        (p_binds, p_phases, p_unsched), p_ms, p_launches, _ = res["cpu"]
        if k_launches < 1 or p_launches != 0:
            fail(f"cycle_vs_plain {case}: {k_launches} kernel launches on "
                 f"the GPU cycle, {p_launches} on the CPU cycle")
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
        extra = {}
        if case == "constrained":
            if not gangs["spread_gangs"] or not gangs["anti_gangs"] \
                    or not max(slots):
                fail(f"cycle_vs_plain {case}: {gangs}, slots {slots}: the "
                     f"slot path was not taken")
            extra = dict(gangs, slots=slots)
        line("cycle_vs_plain", case=case, pods=MID["n_tasks"],
             nodes=MID["n_nodes"], binds=len(k_binds),
             committed_gangs=committed, rolled_back_gangs=k_unsched,
             bind_mismatches=diff, phase_mismatches=phase_diff,
             kernel_launches=k_launches, cycle_ms=k_ms, plain_cycle_ms=p_ms,
             kernel_ms=[pl["kernel_ms"] for pl in k_split["places"]],
             **extra)


def cycle(dev):
    """Phase 8: the port's main path through the objects at the north
    star's size, one cold cycle and one warm one on fresh stores, the
    launch count set to 0 just before each cycle and read just after.
    Returns (launches per cycle, the cycles' lines)."""
    cycles = []
    cycle_launches = []
    for i in range(2):          # one cold cycle, then a warm one
        gang_allocate_cuda.launches = 0
        r = cycle_cmd.run_cycle(FULL["n_tasks"], FULL["n_nodes"], 1, dev)
        cycle_launches.append(gang_allocate_cuda.launches)
        store = r.pop("store")
        if r["binds"] != FULL["n_tasks"] or \
                r["committed_gangs"] != FULL["n_tasks"] // FULL["gang"]:
            fail(f"cycle: {r['binds']} binds and {r['committed_gangs']} "
                 f"committed gangs")
        check_binds(store, "cycle")
        if cycle_launches[-1] != len(r["places"]):
            fail(f"cycle: {cycle_launches[-1]} kernel launches for "
                 f"{len(r['places'])} placements")
        del store
        cycles.append(r)
        line("cycle", run="cold" if i == 0 else f"warm{i}",
             shape={"tasks": FULL["n_tasks"], "nodes": FULL["n_nodes"],
                    "gang": FULL["gang"]},
             kernel_launches=cycle_launches[-1], **r)
    return cycle_launches, cycles


def cycle_constrained(dev):
    """Phase 10: the slot path at the north star's size, populate_store
    with the HEAVY mix, one cold cycle and one warm one on fresh stores,
    the launch count set to 0 just before each cycle and read just after.
    Returns (launches per cycle, the cycles' results)."""
    cycles, launches = [], []
    for i in range(2):
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
        if launches[-1] != len(r["places"]) or launches[-1] < 1 or \
                not r["places"][0]["slots"]:
            fail(f"cycle_constrained: {launches[-1]} kernel launches for "
                 f"{len(r['places'])} placements, slots "
                 f"{[pl['slots'] for pl in r['places']]}")
        del store
        cycles.append(r)
        line("cycle_constrained", run="cold" if i == 0 else f"warm{i}",
             shape={"tasks": FULL["n_tasks"], "nodes": FULL["n_nodes"],
                    "gang": FULL["gang"], **HEAVY},
             kernel_launches=launches[-1],
             refreshes=[pl["launch"][0] for pl in r["places"]],
             **gangs, **r)
    return launches, cycles


def cycle_inputs_vs_plain(dev, constraints=None) -> dict:
    """Phases 9 and 10: the kernel against its plain version on the
    cycle's own inputs at the north star's size: a fresh store as phase 8
    (``constraints``: phase 10, with that mix) builds it, one session on
    the GPU, enqueue, then the allocate action's phase-A batch encoded by
    the session's BatchSolver as place() encodes it; the kernel (three
    timed runs) and the plain loop (one) on those tensors, held exactly.
    With slots, the kernel's refreshes must equal the rule's count."""
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
    _, _, dense = ssn.solver._context(jobs, dev, slot_tensors=True)
    args = convert.args(dense.arrays)
    args[list(convert.FIELDS).index("group_mask")] = dense.static_mask()
    slot_kw = convert.slot_kwargs(dense.arrays)
    if bool(constraints) != bool(slot_kw):
        fail(f"cycle inputs {constraints}: slot inputs {sorted(slot_kw)}")
    kw = dict(ns_live=ssn.solver._ns_live, **slot_kw)
    gang_allocate_cuda(*args, dense.weights, **kw)           # warm-up
    runs = [timed(lambda: gang_allocate_cuda(*args, dense.weights, **kw))
            for _ in range(3)]
    got = runs[-1][0]
    stats = launch_stats()
    want, plain_ms = timed(lambda: allocate.gang_allocate(
        *args, dense.weights, **kw))
    sa = type("Inputs", (), {k: to_np(v) for k, v in dense.arrays.items()})
    ctx = "cycle constrained inputs" if constraints else "cycle inputs"
    res = compare(sa, got, want, ctx)
    a1, a2 = to_np(got[0]), to_np(want[0])
    res["max_abs_err"] = max(res["state_max_abs_err"],
                             float(np.abs(a1.astype(np.float64) - a2).max()))
    steps = int(sa.job_n_tasks.sum())
    N, R = sa.node_idle.shape
    bytes_ms, ops_ms, _ = bound(args, slot_kw.values(), got[:4],
                                stats["refreshes"], steps, N, R)
    res.update(kernel_ms=[ms for _, ms in runs], plain_ms=plain_ms,
               steps=steps, bytes_ms=bytes_ms, ops_ms=ops_ms, **stats)
    if slot_kw:
        slots = (sa.task_slot, sa.slot_ok)
        if not in_slot_rows(a1, slots):
            fail(f"{ctx}: a task was placed outside its slot row")
        if not to_np(got[2])[:len(jobs)].all():
            fail(f"{ctx}: a gang was not committed")
        res.update(slots=int(sa.slot_ok.shape[0] - 1),
                   rule_refreshes=allocate.rule_refreshes(
                       sa.task_group, sa.task_bucket, sa.task_slot,
                       sa.job_task_start, sa.job_n_tasks))
        if res["rule_refreshes"] != stats["refreshes"]:
            fail(f"{ctx}: the kernel refreshed {stats['refreshes']} times, "
                 f"its rule gives {res['rule_refreshes']}")
    line("kernel_vs_plain", case="cycle_constrained_inputs" if constraints
         else "cycle_inputs",
         shape={"T": sa.task_group.shape[0], "G": sa.group_req.shape[0],
                "N": N, "R": R}, **res)
    return res


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
        binds, phases, _ = cycle_outcome(store)
        r = {"evicted": evictor.evicts[n0:],
             "pipelined": dict(sched.last_pipelined), "binds": binds,
             "phases": phases, "split": sched.last_cycle,
             "launches": launches, "wall_ms": wall_ms}
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
            "kernel_launches": r["launches"],
            "kernel_ms": [pl["kernel_ms"] for pl in s["places"]],
            "binds": len(r["binds"]),
            **{k: s[k] for k in keep if k in s},
            **({"peak_device_bytes": r["peak_device_bytes"]}
               if "peak_device_bytes" in r else {})}


def victims_vs_plain() -> None:
    """Phase 11: the four VICTIM_CASES at VICTIM_MID's size, two cycles on
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
        if any(r["launches"] != len(r["split"]["places"])
               or r["launches"] < 1 for r in gpu["cycles"]) or \
                any(r["launches"] for r in cpu["cycles"]):
            fail(f"victims_vs_plain {case}: kernel launches "
                 f"{[r['launches'] for r in gpu['cycles']]} on the GPU, "
                 f"{[r['launches'] for r in cpu['cycles']]} on the CPU")
        line("victims_vs_plain", case=case, action=action, **VICTIM_MID,
             mismatches=diffs,
             evictions=[len(r["evicted"]) for r in gpu["cycles"]],
             pipelined=[len(r["pipelined"]) for r in gpu["cycles"]],
             cycle2_binds=len(gpu["cycles"][1]["binds"]),
             victim_runs=[r["split"]["victim_runs"] for r in gpu["cycles"]],
             cycle_ms=[r["wall_ms"] for r in gpu["cycles"]],
             plain_cycle_ms=[r["wall_ms"] for r in cpu["cycles"]])


def victim_cycle(action: str) -> dict:
    """Phases 12 and 13: the preempt or reclaim path at the reference's
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
        if r["launches"] != (1 if device == "cuda" else 0):
            fail(f"{action}_cycle {run}: {r['launches']} kernel launches")
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
    """Phase 14: the batched prefix functions of ops/preempt.py at 5,000
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


def main() -> None:
    dev = torch.device("cuda", 0)
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
    line("build", seconds=time.perf_counter() - t0, libraries=sorted(libs),
         ptxas=ptxas_usage(build.report("gang_allocate")))

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
    want, plain_ms = timed(lambda: allocate.gang_allocate(
        *args, solver.weights))
    full = compare(sa, got, want, "full size")
    if not np.array_equal(to_np(got[0]), assign):
        fail("the kernel run alone differs from the main path's result")
    a1, a2 = to_np(got[0]), to_np(want[0])
    max_abs_err = max(full["state_max_abs_err"],
                      float(np.abs(a1.astype(np.float64) - a2).max()))
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
    line("kernel_vs_plain", case="main_path_inputs", shape=sa.shapes, **full,
         kernel_ms=kernel_runs, refreshes=n_refresh, plain_ms=plain_ms,
         bytes_ms=bytes_ms, ops_ms=ops_ms, no_fma_ops_ms=no_fma_ops_ms,
         steps=steps)

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

    cycle_vs_plain()
    cycle_launches, cycles = cycle(dev)
    cyc = cycle_inputs_vs_plain(dev)
    con_launches, con_cycles = cycle_constrained(dev)
    con = cycle_inputs_vs_plain(dev, HEAVY)
    for r in con_cycles:
        if [pl["launch"][0] for pl in r["places"]] != [con["refreshes"]]:
            fail("cycle_constrained: the cycle's launch and the kernel run "
                 "on its inputs refreshed their tables a different number "
                 "of times")
    warm = cycles[1:]
    cycle_kernel_ms = [sum(pl["kernel_ms"] for pl in r["places"])
                       for r in warm]

    victims_vs_plain()
    preempt = victim_cycle("preempt")
    reclaim = victim_cycle("reclaim")
    victim_prefix_phase(dev)

    kernels = [{
        "name": "gang_allocate", "route": "cuda",
        "source": "volcano_tpu_torch/csrc/gang_allocate.cu",
        "replaces": "volcano_tpu/ops/pallas_allocate.py:55",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": min(kernel_runs), "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "no_fma_ops_ms": no_fma_ops_ms, **main_stats,
        "launches_per_cycle": cycle_launches[-1],
        "launches_per_preempt_cycle": preempt["launches"],
        "launches_per_reclaim_cycle": reclaim["launches"],
        "preempt_cycle_kernel_ms": [pl["kernel_ms"]
                                    for pl in preempt["split"]["places"]],
        "reclaim_cycle_kernel_ms": [pl["kernel_ms"]
                                    for pl in reclaim["split"]["places"]],
        "cycle_kernel_ms": cycle_kernel_ms,
        "cycle_ms": [r["cycle_ms"] for r in warm],
        "cycle_inputs": {"ms": min(cyc["kernel_ms"]),
                         "plain_ms": cyc["plain_ms"],
                         "max_abs_err": cyc["max_abs_err"],
                         "assign_mismatches": cyc["assign_mismatches"]},
        "worst_case_ms": w_ms, "worst_case_refreshes": w_refresh,
        "shape": sa.shapes, "checked_against_plain": True,
        "assign_mismatches": full["assign_mismatches"],
        "mid_cases": {k: {"ms": v["ms"], "plain_ms": v["plain_ms"],
                          "refreshes": v["refreshes"],
                          "assign_mismatches": v["assign_mismatches"]}
                      for k, v in mid.items()}}, {
        "name": "gang_allocate_slots", "route": "cuda",
        "source": "volcano_tpu_torch/csrc/gang_allocate.cu",
        "replaces": "volcano_tpu/ops/pallas_allocate.py:55",
        "launches": con_launches[-1], "max_abs_err": con["max_abs_err"],
        "ms": min(con["kernel_ms"]), "plain_ms": con["plain_ms"],
        "bound_ms": max(con["bytes_ms"], con["ops_ms"]),
        "bound_by": "bytes" if con["bytes_ms"] >= con["ops_ms"]
        else "operations",
        "library_ms": None, "slots": con["slots"],
        "refreshes": con["refreshes"],
        "rule_refreshes": con["rule_refreshes"], "steps": con["steps"],
        "cycle_kernel_ms": [sum(pl["kernel_ms"] for pl in r["places"])
                            for r in con_cycles[1:]],
        "cycle_ms": [r["cycle_ms"] for r in con_cycles[1:]],
        "constraint_ms": [sum(pl["constraint_ms"] for pl in r["places"])
                          for r in con_cycles[1:]],
        "shape": {"tasks": FULL["n_tasks"], "nodes": FULL["n_nodes"],
                  **HEAVY},
        "checked_against_plain": True,
        "assign_mismatches": con["assign_mismatches"],
        "mid_cases": {k: {"ms": v["ms"], "plain_ms": v["plain_ms"],
                          "refreshes": v["refreshes"],
                          "assign_mismatches": v["assign_mismatches"]}
                      for k, v in mid.items() if v["slots"]}}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
