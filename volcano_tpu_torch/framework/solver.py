"""The per-cycle placement solve (counterpart of
volcano_tpu/framework/solver.py: ``_fused_static_mask``, the mask and score
composition of ``_apply_masks_and_scores``, and ``BatchSolver`` with its
context build, ``place`` and decode).

``DenseSolver`` starts from an encoded snapshot (the fields of
utils.synth.SynthArrays) and runs: the capability-fit mask through unique
capability rows; the selector and taint masks when predicate features are
given; the proportion water-fill of queue budgets when queue weights are
given; the gang-allocate kernel; and the decode into per-job and per-node
totals. One kernel serves each device: the CUDA kernel on the GPU, the
plain loop on the CPU.

``BatchSolver`` is the session's placement context. Plugins feed it score
weights, mask and static-score functions and fair-share budgets while the
session opens; ``place`` encodes the session's Pods and Nodes
(models/arrays.py), runs a ``DenseSolver`` over them and decodes the
kernel's assignment back into per-job placements. Placement constraints
(topology spread, pod anti-affinity) reach the kernel through
ops/constraints.py, as per-task domain slots on the place path and as
split groups in host contexts. The conf keys of the reference that only
choose among exact kernels are accepted and ignored.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import convert
from ..models import arrays
from ..models.arrays import NodeArrays, ResourceIndex, TaskBatch
from ..models.job_info import JobInfo, TaskInfo
from ..models.unschedule_info import FitErrors
from ..ops import constraints
from ..ops.cuda_allocate import gang_allocate_cuda
from ..ops.fairshare import proportion_waterfill
from ..ops.fit import group_fit_mask, selector_mask, taint_mask
from ..ops.score import ScoreWeights
from ..utils.platform import default_device


class PredicateFeatures(NamedTuple):
    """Label and taint features encoded from the snapshot."""
    node_pairs: torch.Tensor            # [N, F] f32 0/1 label pairs held
    group_requires: torch.Tensor        # [G, F] f32 0/1 pairs required
    group_require_counts: torch.Tensor  # [G] f32 pairs required
    node_taints: torch.Tensor           # [N, K] f32 0/1 NoSchedule taints
    group_tolerates: torch.Tensor       # [G, K] f32 0/1 taints tolerated


class QueueBudgets(NamedTuple):
    """The proportion plugin's per-queue inputs of the water-fill; their
    rows are the first queues of the snapshot's (padded) queue axis."""
    weight: torch.Tensor       # [Q] f32
    capability: torch.Tensor   # [Q, R] f32, +inf = unset
    request: torch.Tensor      # [Q, R] f32 allocated + pending


@dataclass
class DensePlacement:
    """The decoded result of one placement solve, on the solver's device."""
    assign: torch.Tensor          # [T] i32 node or -1
    pipelined: torch.Tensor       # [T] bool placed onto future capacity
    ready: torch.Tensor           # [J] bool JobReady -> commit (bind)
    kept: torch.Tensor            # [J] bool JobPipelined -> keep claims
    job_placed: torch.Tensor      # [J] i32 tasks placed per job
    job_total_vec: torch.Tensor   # [J, R] f32 resources placed per job
    node_alloc_vec: torch.Tensor  # [N, R] f32 idle claimed per node
    queue_deserved: torch.Tensor  # [Q, R] f32 the budgets the kernel used
    group_mask: torch.Tensor      # [G, N] bool the static mask the kernel used
    kernel_ms: float              # the gang-allocate call on the device

    @property
    def n_placed(self) -> int:
        return int((self.assign >= 0).sum())


def fused_static_mask(group_req: torch.Tensor, uniq_cap: torch.Tensor,
                      inv: torch.Tensor, valid: torch.Tensor,
                      eps: torch.Tensor) -> torch.Tensor:
    """valid & capability-fit for every group x node, via the unique
    capability rows: [G, U] fits gathered to [G, N]."""
    fit_u = group_fit_mask(group_req, uniq_cap, eps)      # [G, U]
    return valid[None, :] & fit_u[:, inv]


class DenseSolver:
    """The placement solve for one encoded snapshot on one device.

    ``snapshot``: a utils.synth.SynthArrays, or any mapping or object with
    its fields (numpy arrays or tensors). ``device`` defaults to the GPU and
    raises when there is none. The capability fit reads ``capability``
    ([N, R]) when it is given, else the snapshot's ``node_alloc``; only the
    nodes marked in ``valid`` ([N] bool) are placeable when it is given,
    else every node is (padded nodes have zero capability and fail the
    fit). A snapshot that carries ``task_slot`` ([T] i32) and ``slot_ok``
    ([S+1, N] bool) restricts each task to the nodes of its slot row."""

    def __init__(self, snapshot: Any, weights: ScoreWeights,
                 device=None, *, features: Optional[PredicateFeatures] = None,
                 queues: Optional[QueueBudgets] = None,
                 capability: Any = None, valid: Any = None):
        self.device = default_device(device)
        self.arrays = convert.as_tensors(snapshot, self.device)
        self.weights = weights.to(self.device)
        self.capability = None if capability is None else torch.as_tensor(
            capability, dtype=torch.float32).to(self.device)
        self.valid = None if valid is None else torch.as_tensor(
            valid, dtype=torch.bool).to(self.device)
        self.features = None if features is None else PredicateFeatures(
            *(torch.as_tensor(x, dtype=torch.float32).to(self.device)
              for x in features))
        self.queues = None if queues is None else QueueBudgets(
            *(torch.as_tensor(x, dtype=torch.float32).to(self.device)
              for x in queues))

    def static_mask(self) -> torch.Tensor:
        """[G, N] bool: capability fit & the snapshot's group mask, AND the
        selector and taint masks when features are given."""
        a = self.arrays
        cap = a["node_alloc"] if self.capability is None else self.capability
        uniq_cap, inv = torch.unique(cap, dim=0, return_inverse=True)
        valid = torch.ones(inv.shape[0], dtype=torch.bool, device=self.device) \
            if self.valid is None else self.valid
        gmask = fused_static_mask(a["group_req"], uniq_cap, inv, valid,
                                  a["eps"]) & a["group_mask"]
        f = self.features
        if f is not None:
            if bool(f.group_require_counts.any()):
                gmask &= selector_mask(f.node_pairs, f.group_requires,
                                       f.group_require_counts)
            if bool(f.node_taints.any()):
                gmask &= taint_mask(f.node_taints, f.group_tolerates)
        return gmask

    def queue_deserved(self) -> torch.Tensor:
        """[Q, R]: the snapshot's budgets, or the water-fill of the cluster
        total over the queue budgets when they are given (queues beyond
        them stay ungated)."""
        a = self.arrays
        if self.queues is None:
            return a["queue_deserved"]
        deserved, _ = proportion_waterfill(*self.queues, a["ns_total"])
        out = torch.full_like(a["queue_deserved"], float("inf"))
        out[:deserved.shape[0]] = deserved
        return out

    def place(self, allow_pipeline: bool = True,
              ns_live: bool = False) -> DensePlacement:
        a = self.arrays
        args = convert.args(a)
        names = list(convert.FIELDS)
        gmask = self.static_mask()
        args[names.index("group_mask")] = gmask
        deserved = self.queue_deserved()
        args[names.index("queue_deserved")] = deserved

        on_cuda = self.device.type == "cuda"
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        assign, pipelined, ready, kept, _ = gang_allocate_cuda(
            *args, self.weights, allow_pipeline=allow_pipeline,
            ns_live=ns_live, **convert.slot_kwargs(a))
        if on_cuda:
            end.record()
        else:
            kernel_ms = (time.perf_counter() - t0) * 1000.0

        # decode (solver.py:1036-1048): per-job and per-node totals
        J, R = a["job_min_available"].shape[0], a["group_req"].shape[1]
        N = a["node_idle"].shape[0]
        placed = assign >= 0
        tj = a["task_job"].long()
        rows = a["group_req"][a["task_group"].long()]               # [T, R]
        job_placed = torch.zeros(J, dtype=torch.int32, device=self.device)
        job_placed.index_add_(0, tj, placed.to(torch.int32))
        job_total = torch.zeros((J, R), dtype=torch.float32,
                                device=self.device)
        job_total.index_add_(0, tj, rows * placed[:, None])
        on_idle = placed & ~pipelined
        node_alloc_vec = torch.zeros((N, R), dtype=torch.float32,
                                     device=self.device)
        node_alloc_vec.index_add_(0, assign.clamp(min=0).long(),
                                  rows * on_idle[:, None])
        if on_cuda:
            end.synchronize()
            kernel_ms = start.elapsed_time(end)
        return DensePlacement(assign, pipelined, ready, kept, job_placed,
                              job_total, node_alloc_vec, deserved, gmask,
                              kernel_ms)


class Placement(NamedTuple):
    # NamedTuple over dataclass: a cycle materializes one per placed task
    # (50k at the target scale) and tuple allocation is ~3x cheaper
    task: TaskInfo
    node_name: str
    pipelined: bool


@dataclass
class PlacementResult:
    batch: TaskBatch
    committed: Dict[str, bool]                  # job uid -> JobReady (bind)
    kept: Dict[str, bool]                       # job uid -> JobPipelined (keep)
    placements: Dict[str, List[Placement]]      # job uid -> placements
    unplaced: Dict[str, List[TaskInfo]]         # job uid -> tasks left pending


class BatchSolver:
    """The session's placement context on one device (``device``:
    default the GPU, which raises when there is none).

    Conf (``configurations: [{name: solver, arguments: {...}}]``): the
    reference's keys that only choose among exact kernels or apply modes
    that give the same binds (``kernel``, ``mesh.*``, ``breaker.window``,
    ``apply``) are accepted and ignored: this port runs one kernel per
    device and stages placements eagerly. ``prune.*`` is accepted and
    ignored too, but it is not of that kind: the port always gives the
    reference's answers under ``prune.enable: off``. The reference's
    default ``prune.enable: auto`` engages at 4,096 ready nodes or more,
    where its placements may differ (docs/design/pruning.md, the
    documented-divergence regime); pruning is still to port.
    ``sampling.enable`` raises NotImplementedError, because a sampled
    node window changes placements. ``constraints.compile: off``
    evaluates the constraint mask per pair and lowers domains by
    splitting groups (ops/constraints.py). ``victims.kernel: off`` makes
    preempt and reclaim select victims by the walk of
    framework/victims.py instead of ops/victims.py; both are exact."""

    def __init__(self, ssn, device=None, rindex: Optional[ResourceIndex] = None):
        self.ssn = ssn
        self.device = default_device(device)
        self.rindex = rindex if rindex is not None \
            else ResourceIndex.from_cluster(ssn.nodes, ssn.jobs)
        self._weights: Dict[str, float] = {"binpack": 0.0, "least": 0.0,
                                           "most": 0.0, "balanced": 0.0}
        self._binpack_res: Optional[np.ndarray] = None
        self.mask_fns: List[Callable] = []
        self.static_score_fns: List[Callable] = []
        self.queue_budget_fns: List[Callable] = []
        self.namespace_budget_fn: Optional[Callable] = None
        self.bucket_fn: Optional[Callable] = None
        self.vectorized_plugins: set = set()
        self.enable_default_predicates = False
        # one entry per place(): host encode (of which the constraint
        # lowering and compile passes, constraint_ms), device solve,
        # object decode and kernel times (ms), the batch's domain slots
        # and the launch's own report
        self.stats: List[Dict[str, Any]] = []
        solver_args = (ssn.configurations or {}).get("solver")
        if solver_args is not None and \
                solver_args.get_bool("sampling.enable", False):
            raise NotImplementedError(
                "solver sampling.enable: a sampled node window changes "
                "placements; this port always evaluates every node")

    # -- plugin contribution API ------------------------------------------

    def set_weight(self, term: str, value: float) -> None:
        self._weights[term] = float(value)

    def add_weight(self, term: str, value: float) -> None:
        self._weights[term] = self._weights.get(term, 0.0) + float(value)

    def set_binpack_resources(self, weights_by_name: Dict[str, float]) -> None:
        w = np.zeros(self.rindex.r, np.float32)
        for name, weight in weights_by_name.items():
            i = self.rindex.index.get(name)
            if i is not None:
                w[i] = weight
        self._binpack_res = w

    def add_mask_fn(self, fn: Callable) -> None:
        """fn(batch, node_arrays, features) -> [G, N] bool or None"""
        self.mask_fns.append(fn)

    def add_static_score_fn(self, fn: Callable) -> None:
        """fn(batch, node_arrays, features) -> [G, N] float or None"""
        self.static_score_fns.append(fn)

    def add_queue_budget_fn(self, fn: Callable) -> None:
        """fn(queue_name, rindex) -> None | (allocated [R], deserved [R]):
        the kernel's live fair-share gate (proportion's Overused, at job
        granularity)."""
        self.queue_budget_fns.append(fn)

    def set_namespace_budget_fn(self, fn: Callable) -> None:
        """fn(ns_name, rindex) -> None | (allocated [R], weight): the
        kernel's live namespace re-selection (drf's NamespaceOrderFn)."""
        self.namespace_budget_fn = fn

    def set_bucket_fn(self, fn: Callable) -> None:
        """fn(task) -> None | (bucket_key, per_mate_bonus). Tasks sharing a
        bucket_key attract each other inside the kernel: every same-bucket
        placement on a node adds per_mate_bonus to that node's score for
        later bucket mates (the task-topology plugin's packing term)."""
        self.bucket_fn = fn

    def mark_vectorized(self, plugin_name: str) -> None:
        self.vectorized_plugins.add(plugin_name)

    def score_weights(self) -> ScoreWeights:
        br = self._binpack_res if self._binpack_res is not None \
            else np.ones(self.rindex.r, np.float32)
        w = self._weights
        return ScoreWeights.make(self.rindex.r, binpack_res=br,
                                 binpack=w.get("binpack", 0.0),
                                 least=w.get("least", 0.0),
                                 most=w.get("most", 0.0),
                                 balanced=w.get("balanced", 0.0),
                                 device=self.device)

    # -- context build -----------------------------------------------------

    def _lower_constraints(self, ordered_jobs, narr: NodeArrays,
                           slot_tensors: bool):
        """(batch, slot entries for the selector feature pairs or None):
        the batch with its topology-domain assignments lowered
        (volcano_tpu/framework/solver.py:528-617). ``slot_tensors`` (the
        place path) gives the batch the kernel's per-task
        ``task_slot``/``slot_rows`` and keeps base groups; otherwise (host
        contexts, ``constraints.compile: off``, or more than SLOT_CAP
        distinct slots) each assigned domain splits off a derived group
        whose domain rides the selector feature pairs. The constraint
        passes, not the batch build, count into ``constraint_ms``."""
        ssn = self.ssn
        use_tensors, sig_override = constraints.lower_slots(
            ssn, ordered_jobs, narr.names, slot_tensors)
        batch = TaskBatch.build(ordered_jobs, self.rindex,
                                sig_override=sig_override)
        if use_tensors:
            slot_data = constraints.build_slot_tensors(ssn, batch, narr)
            if slot_data is not None:
                batch.task_slot, batch.slot_rows = slot_data
        # split slots lower through the selector feature pairs, tensor
        # slots through the kernel's inputs; either way compile_mask then
        # skips its group-wide slot rows
        slot_entries = getattr(ssn, "_constraint_slots", None) \
            if sig_override else None
        if slot_entries or batch.task_slot is not None:
            ssn._constraint_slots_lowered = True
        return batch, slot_entries

    def _buckets(self, batch: TaskBatch) -> Tuple[np.ndarray, np.ndarray]:
        """(task_bucket [T] i32, group_pack_bonus [G] f32) from the bucket
        fn (volcano_tpu/framework/solver.py:954-967): -1 and 0 without
        one."""
        task_bucket = np.full(batch.t_pad, -1, np.int32)
        pack_bonus = np.zeros(batch.g_pad, np.float32)
        if self.bucket_fn is not None:
            keys: Dict = {}
            for t_idx, task in enumerate(batch.tasks):
                res = self.bucket_fn(task)
                if res is None:
                    continue
                key, bonus = res
                task_bucket[t_idx] = keys.setdefault(key, len(keys))
                pack_bonus[batch.task_group[t_idx]] = bonus
        return task_bucket, pack_bonus

    def _context(self, ordered_jobs, device, slot_tensors: bool = False
                 ) -> Tuple[NodeArrays, TaskBatch, "DenseSolver"]:
        """Encode the batch against the session's current node state and
        compose the plugins' contributions into a DenseSolver on
        ``device`` (volcano_tpu/framework/solver.py:528-811);
        ``slot_tensors`` picks the topology-domain lowering
        (``_lower_constraints``)."""
        ssn = self.ssn
        extra = {name for name in ssn.predicate_fns
                 if name not in self.vectorized_plugins}
        if extra:
            raise NotImplementedError(
                f"host predicate fns of plugins {sorted(extra)}: this port "
                "places only through vectorized masks")
        narr = NodeArrays.build(ssn.nodes, [n.name for n in ssn.node_list],
                                self.rindex)
        batch, slot_entries = self._lower_constraints(ordered_jobs, narr,
                                                      slot_tensors)
        feats = arrays.PredicateFeatures.build(ssn.nodes, narr, batch,
                                               slot_entries=slot_entries)

        gmask = None
        if self.enable_default_predicates and \
                feats.group_affinity_ok is not None:
            gmask = feats.group_affinity_ok
        for fn in self.mask_fns:
            contrib = fn(batch, narr, feats)
            if contrib is not None:
                gmask = contrib if gmask is None else gmask & contrib
        static_score = None
        for fn in self.static_score_fns:
            contrib = fn(batch, narr, feats)
            if contrib is not None:
                static_score = contrib if static_score is None \
                    else static_score + contrib
        shape = (batch.g_pad, narr.n_pad)
        gmask = torch.ones(shape, dtype=torch.bool, device=device) \
            if gmask is None else torch.from_numpy(gmask).to(device)
        static_score = torch.zeros(shape, dtype=torch.float32, device=device) \
            if static_score is None else \
            torch.from_numpy(np.asarray(static_score, np.float32)).to(device)

        # queue fair-share budgets (live Overused gate inside the kernel)
        r = self.rindex.r
        q_deserved = np.full((batch.q_pad, r), np.inf, np.float32)
        q_alloc0 = np.zeros((batch.q_pad, r), np.float32)
        for qi, qname in enumerate(batch.queue_names):
            for fn in self.queue_budget_fns:
                budget = fn(qname, self.rindex)
                if budget is not None:
                    q_alloc0[qi], q_deserved[qi] = budget
                    break
        # namespace fairness state: live weighted-share re-selection when
        # drf's namespace order is on and the batch spans namespaces,
        # else the encode's static namespace order
        ns_pad = arrays.bucket(max(1, len(batch.ns_names)), 8)
        ns_weight = np.ones(ns_pad, np.float32)
        ns_alloc0 = np.zeros((ns_pad, r), np.float32)
        self._ns_live = self.namespace_budget_fn is not None \
            and len(batch.ns_names) > 1
        if self._ns_live:
            for ni, nsname in enumerate(batch.ns_names):
                budget = self.namespace_budget_fn(nsname, self.rindex)
                if budget is not None:
                    allocated, weight = budget
                    ns_alloc0[ni] = allocated
                    ns_weight[ni] = max(float(weight), 1e-9)

        task_bucket, pack_bonus = self._buckets(batch)
        snapshot = {
            "task_group": batch.task_group, "task_job": batch.task_job,
            "task_valid": batch.task_valid, "group_req": batch.group_req,
            "group_mask": gmask, "group_static_score": static_score,
            "task_bucket": task_bucket, "group_pack_bonus": pack_bonus,
            "job_min_available": batch.job_min_available,
            "job_ready_base": batch.job_ready_base,
            "job_task_start": batch.job_task_start,
            "job_n_tasks": batch.job_n_tasks, "job_queue": batch.job_queue,
            "pool_queue": batch.pool_queue, "pool_ns": batch.pool_ns,
            "pool_job_start": batch.pool_job_start,
            "pool_njobs": batch.pool_njobs, "ns_weight": ns_weight,
            "ns_alloc0": ns_alloc0,
            "ns_total": self.rindex.vec(ssn.total_resource),
            "queue_deserved": q_deserved, "queue_alloc0": q_alloc0,
            "node_idle": narr.idle, "node_future": narr.future_idle,
            "node_alloc": narr.allocatable, "node_ntasks": narr.n_tasks,
            "node_max_tasks": narr.max_tasks, "eps": self.rindex.eps}
        if batch.task_slot is not None:
            snapshot["task_slot"] = batch.task_slot
            snapshot["slot_ok"] = batch.slot_rows
        features = None
        if self.enable_default_predicates:
            features = PredicateFeatures(
                feats.node_pairs, feats.group_requires,
                feats.group_require_counts, feats.node_taints,
                feats.group_tolerates)
        dense = DenseSolver(snapshot, self.score_weights(), device,
                            features=features, capability=narr.capability,
                            valid=narr.valid)
        return narr, batch, dense

    def build_host_context(self, ordered_jobs):
        """(narr, batch, gmask [G, N] numpy bool, static_score [G, N]
        numpy f32): the static mask and score the kernel would get, built
        on the CPU for host-driven actions (backfill, preempt and reclaim
        walk nodes in Python reading a few mask and score rows;
        volcano_tpu/framework/solver.py:813-838)."""
        narr, batch, dense = self._context(ordered_jobs, torch.device("cpu"))
        return (narr, batch, dense.static_mask().numpy(),
                dense.arrays["group_static_score"].numpy())

    # -- placement ---------------------------------------------------------

    def place(self, ordered_jobs: List[Tuple[JobInfo, List[TaskInfo]]],
              allow_pipeline: bool = True) -> PlacementResult:
        """Run the gang-allocate kernel for the ordered job/task batch
        against the session's *current* node state."""
        t0 = time.perf_counter()
        self.ssn._constraint_ms = 0.0
        narr, batch, dense = self._context(ordered_jobs, self.device,
                                           slot_tensors=True)
        t1 = time.perf_counter()
        out = dense.place(allow_pipeline=allow_pipeline, ns_live=self._ns_live)
        assign = out.assign.cpu().numpy()
        pipelined = out.pipelined.cpu().numpy()
        ready_list = out.ready.cpu().tolist()
        kept_list = out.kept.cpu().tolist()
        t2 = time.perf_counter()
        stats = gang_allocate_cuda.last_stats
        self.stats.append({
            "encode_ms": (t1 - t0) * 1000.0,
            "constraint_ms": self.ssn._constraint_ms,
            "slots": 0 if batch.slot_rows is None
            else batch.slot_rows.shape[0] - 1,
            "solve_ms": (t2 - t1) * 1000.0,
            "kernel_ms": out.kernel_ms,
            "launch": stats.tolist() if stats is not None
            and self.device.type == "cuda" else None})

        # decode (volcano_tpu/framework/solver.py:1016-1106): one pass over
        # the assign vector; each job reads its window of the sorted
        # placed/unplaced indices
        uid_to_j = {uid: j for j, uid in enumerate(batch.job_uids)}
        result = PlacementResult(batch=batch, committed={}, kept={},
                                 placements={}, unplaced={})
        unplaced_records: List[Tuple[JobInfo, TaskInfo, int]] = []
        all_tasks = batch.tasks
        a_real = assign[:len(all_tasks)]
        placed_all = np.flatnonzero(a_real >= 0)
        unplaced_all = np.flatnonzero(a_real < 0)
        names_obj = np.empty(narr.n_pad, object)
        names_obj[:len(narr.names)] = narr.names
        pnames = names_obj[a_real[placed_all]].tolist()
        ppipe = pipelined[placed_all].astype(bool).tolist()
        pidx = placed_all.tolist()
        uidx = unplaced_all.tolist()
        plo = np.searchsorted(placed_all, batch.job_task_start).tolist()
        phi = np.searchsorted(placed_all, batch.job_task_end).tolist()
        ulo = np.searchsorted(unplaced_all, batch.job_task_start).tolist()
        uhi = np.searchsorted(unplaced_all, batch.job_task_end).tolist()
        starts = batch.job_task_start.tolist()
        ends = batch.job_task_end.tolist()
        for job, jtasks in ordered_jobs:
            j = uid_to_j.get(job.uid, -1)
            if not jtasks or j < 0:
                # job contributed no tasks to the kernel: readiness is
                # decided by its pre-existing occupancy alone
                ok = job.ready_task_num() >= job.min_available
                result.committed[job.uid] = ok
                result.kept[job.uid] = ok
                result.placements[job.uid] = []
                result.unplaced[job.uid] = []
                continue
            ok, was_kept = ready_list[j], kept_list[j]
            result.committed[job.uid] = ok
            result.kept[job.uid] = was_kept
            if ok or was_kept:
                placements = [
                    Placement(all_tasks[pidx[k]], pnames[k], ppipe[k])
                    for k in range(plo[j], phi[j])]
                un_iter = (uidx[k] for k in range(ulo[j], uhi[j]))
            else:
                placements = []
                un_iter = range(starts[j], ends[j])
            unplaced = []
            for t_idx in un_iter:
                task = all_tasks[t_idx]
                unplaced.append(task)
                unplaced_records.append(
                    (job, task, int(batch.task_group[t_idx])))
            result.placements[job.uid] = placements
            result.unplaced[job.uid] = unplaced
        if unplaced_records:
            # fit errors read the mask rows of the unplaced groups only
            gs = sorted({g for _, _, g in unplaced_records})
            rows = out.group_mask[torch.tensor(gs, device=out.group_mask.device)]
            rows = rows.cpu().numpy()
            row_of = {g: rows[i] for i, g in enumerate(gs)}
            for job, task, g in unplaced_records:
                self._record_fit_errors(job, task, narr, row_of[g])
        self.stats[-1]["decode_ms"] = (time.perf_counter() - t2) * 1000.0
        return result

    @staticmethod
    def _record_fit_errors(job: JobInfo, task: TaskInfo,
                           narr: NodeArrays, mask_row: np.ndarray) -> None:
        """Summarize why a task found no node (FitErrors analogue)."""
        fe = FitErrors()
        n_real = len(narr.names)
        blocked = int(n_real - mask_row[:n_real].sum())
        if blocked:
            fe.set_error(f"{blocked}/{n_real} nodes are unavailable for task "
                         f"{task.namespace}/{task.name}: predicates failed "
                         f"or insufficient resources")
        else:
            fe.set_error("gang rollback or all feasible nodes already full")
        job.nodes_fit_errors[task.uid] = fe
