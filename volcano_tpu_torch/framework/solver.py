"""The per-cycle placement solve (counterpart of
volcano_tpu/framework/solver.py: ``_fused_static_mask``, the mask and score
composition of ``_apply_masks_and_scores``, and ``BatchSolver`` with its
context build, ``place`` and decode).

``DenseSolver`` starts from an encoded snapshot (the fields of
utils.synth.SynthArrays) and runs: the capability-fit mask through unique
capability rows; the selector and taint masks when predicate features are
given; the proportion water-fill of queue budgets when queue weights are
given; the gang-allocate kernel; and the decode into per-job and per-node
totals. By default one kernel serves each device: the CUDA kernel on the
GPU, the plain loop on the CPU; ``kernel: native`` in the solver conf runs
the native CPU solver (ops/native.py, native/solver.cc) on either device.

``BatchSolver`` is the session's placement context. Plugins feed it score
weights, mask and static-score functions and fair-share budgets while the
session opens; the predicate fns of plugins that did not mark themselves
vectorized (numa-aware's) are swept over every group and node into one
more mask (``host_predicate_mask``); ``place`` encodes the session's Pods
and Nodes (models/arrays.py), runs a ``DenseSolver`` over them and
decodes the kernel's assignment back into per-job placements. Placement
constraints (topology spread, pod anti-affinity) reach the kernel through
ops/constraints.py, as per-task domain slots on the place path and as
split groups in host contexts. Of the conf keys of the reference that
choose among exact kernels, ``kernel: native`` picks the native solver and
the others are accepted and ignored.

On the incremental cycle (docs/design/incremental_cycle.md) the cache
keeps an ``_IncrNodeState``: the host NodeArrays and the five node
tensors the kernel reads (idle, future idle, allocatable, task counts,
task limits), resident on the solver's device across sessions. A
session's first context build re-encodes only the rows of the nodes
patched since (``NodeArrays.update_rows``) and the unpruned launch copies
only those rows into the resident tensors (``index_copy_``); the kernel
only reads them. Each launch counts
on ``volcano_solver_kernel_runs_total{kernel}`` under its route, "cuda"
(the hand kernel), "plain" (the plain loop on the CPU) or "native" (the
native solver on the host), and is traced as the reference's ``kernel``
span (``DenseSolver.launch``).
"""

from __future__ import annotations

import logging
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
from ..metrics import metrics as m
from ..ops import constraints, prune
from ..ops.cuda_allocate import cluster_plan, gang_allocate_cuda
from ..ops.fairshare import proportion_waterfill
from ..ops.fit import group_fit_mask, selector_mask, taint_mask
from ..ops.native import gang_allocate_native
from ..ops.prune import PruneConf
from ..ops.score import ScoreWeights
from ..trace import explain
from ..trace import tracer as tr
from ..utils.platform import default_device

_logger = logging.getLogger(__name__)
_logged_once: set = set()


def _log_once(msg: str) -> None:
    if msg not in _logged_once:
        _logged_once.add(msg)
        _logger.warning(msg)


# the start of the sampling window: a process-wide cursor, as the
# reference's node cursor (scheduler_helper.go:95); it advances by the
# window's width each sampled session
_node_cursor = 0

# the fleet fragmentation gauge's cadence: every place() when the
# explainer is on, else one place() in FRAG_EVERY (a process-wide count,
# volcano_tpu/framework/solver.py:47-62)
FRAG_EVERY = 16
_place_counter = 0


# the five node inputs of the kernel that can stay resident on the device
NODE_FIELDS = ("node_idle", "node_future", "node_alloc", "node_ntasks",
               "node_max_tasks")


def node_inputs_of(narr: NodeArrays) -> Dict[str, np.ndarray]:
    """The NODE_FIELDS of ``narr`` as host arrays."""
    return {"node_idle": narr.idle, "node_future": narr.future_idle,
            "node_alloc": narr.allocatable, "node_ntasks": narr.n_tasks,
            "node_max_tasks": narr.max_tasks}


class _IncrNodeState:
    """The host NodeArrays and the resident node tensors reused across
    the cycles of one cache (the BatchSolver lives one session). Each
    incremental snapshot's patched nodes accumulate in ``pending``; the
    next session's first context build re-encodes those host rows, and
    its unpruned launch copies those rows into the resident tensors. A
    full snapshot, or a change of node order or ResourceIndex, drops the
    state; the resident tensors also belong to one device (``device``)
    and are rebuilt for a solver on another."""

    __slots__ = ("seq", "narr", "rindex", "names", "pending", "dev",
                 "device", "dev_dirty_rows")

    def __init__(self):
        self.seq = -1
        self.narr: Optional[NodeArrays] = None
        self.rindex: Optional[ResourceIndex] = None
        self.names: Optional[List[str]] = None   # the node order encoded
        self.pending: set = set()      # node names to re-encode on the host
        self.dev: Optional[Dict[str, torch.Tensor]] = None
        self.device: Optional[torch.device] = None
        self.dev_dirty_rows: set = set()   # rows to copy to the device


def note_incremental_snapshot(cache, snap) -> None:
    """Fold one snapshot's patched nodes into the cache's persistent node
    state (called once a cycle by open_session)."""
    state = getattr(cache, "_incr_solver_state", None)
    if state is None:
        state = cache._incr_solver_state = _IncrNodeState()
    if snap.incr_seq == state.seq:
        return
    state.seq = snap.incr_seq
    if snap.incr_mode != "incremental":
        state.narr = None
        state.dev = None
        state.pending.clear()
        state.dev_dirty_rows.clear()
    else:
        state.pending |= snap.patched_nodes
    # the constraint compiler's persistent node rows ride the same
    # patched sets
    constraints.note_snapshot(cache, snap)


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
    kernel_ms: float              # the gang-allocate call
    route: str = "plain"          # the kernel's route: "cuda", "plain" or
                                  # "native"
    plan: str = "shared"          # its cluster plan (ops/cuda_allocate.py),
                                  # "host" on the native route
    r: int = 0                    # its resource count R

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
    ([S+1, N] bool) restricts each task to the nodes of its slot row.
    ``kernel`` is the solver conf's: "native" runs the native CPU solver
    on either device, anything else the device's own kernel."""

    def __init__(self, snapshot: Any, weights: ScoreWeights,
                 device=None, *, features: Optional[PredicateFeatures] = None,
                 queues: Optional[QueueBudgets] = None,
                 capability: Any = None, valid: Any = None,
                 node_inputs: Optional[Callable] = None,
                 kernel: str = "auto"):
        self.device = default_device(device)
        self.kernel = kernel
        # the snapshot's host entries, which the native route reads
        # without a round trip through the device
        self._snapshot = snapshot if kernel == "native" else None
        # ``node_inputs`` () -> ({field: tensor}, bytes copied) supplies
        # the NODE_FIELDS at the first full-width launch (the resident
        # tensors of the incremental cycle); the snapshot then lacks them
        omit = NODE_FIELDS if node_inputs is not None else ()
        self._node_inputs = node_inputs
        # bytes copied host->device for the NODE_FIELDS by this solver's
        # launches
        self.node_bytes = 0
        # host->device bytes of the snapshot's host entries, counted at
        # the first launch
        self._staged_bytes = sum(
            int(np.asarray(v).nbytes) for k, v in convert.entries(snapshot)
            if k not in omit and not isinstance(v, torch.Tensor))
        self.arrays = convert.as_tensors(snapshot, self.device, omit=omit)
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

    def materialize_nodes(self) -> None:
        """Put the node tensors of ``node_inputs`` into ``arrays`` (done
        by the first full-width launch; a no-op without them)."""
        if self._node_inputs is not None:
            nodes, node_xfer = self._node_inputs()
            self._node_inputs = None
            self.arrays.update(nodes)
            self._staged_bytes += node_xfer
            self.node_bytes += node_xfer

    def _host_inputs(self, a: Dict[str, Any],
                     arrays: Optional[Dict[str, Any]]
                     ) -> Dict[str, torch.Tensor]:
        """The kernel inputs ``a`` on the host for the native route: the
        snapshot's (or ``arrays``') host entries as they are, the rest
        copied back from the device."""
        src = dict(convert.entries(self._snapshot if arrays is None
                                   else arrays))
        return convert.as_tensors(
            {k: v if isinstance(src.get(k, v), torch.Tensor) else src[k]
             for k, v in a.items()}, "cpu")

    def static_mask(self, stages: Optional[list] = None,
                    parts=()) -> torch.Tensor:
        """[G, N] bool: capability fit & the snapshot's group mask, AND the
        selector and taint masks when features are given. ``stages`` (the
        explainer's) collects the mask ladder in the reference's order as
        ``(label, survivors [G])``: fit, selector, taint, then each of
        ``parts`` ((label, [G, N] mask) that make up the group mask)."""
        a = self.arrays
        cap = a["node_alloc"] if self.capability is None else self.capability
        uniq_cap, inv = torch.unique(cap, dim=0, return_inverse=True)
        valid = torch.ones(inv.shape[0], dtype=torch.bool, device=self.device) \
            if self.valid is None else self.valid
        gmask = fused_static_mask(a["group_req"], uniq_cap, inv, valid,
                                  a["eps"])

        def stage(label, mask):
            nonlocal gmask
            gmask = gmask & mask
            if stages is not None:
                stages.append((label, gmask.sum(dim=1)))

        if stages is not None:
            stages.append(("fit", gmask.sum(dim=1)))
        f = self.features
        if f is not None:
            if bool(f.group_require_counts.any()):
                stage("selector", selector_mask(f.node_pairs, f.group_requires,
                                                f.group_require_counts))
            if bool(f.node_taints.any()):
                stage("taint", taint_mask(f.node_taints, f.group_tolerates))
        for label, part in parts:
            stage(label, torch.as_tensor(part).to(self.device))
        return gmask & a["group_mask"]

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
        return self.launch(self.static_mask(), allow_pipeline, ns_live)

    def launch(self, gmask: torch.Tensor, allow_pipeline: bool = True,
               ns_live: bool = False,
               arrays: Optional[Dict[str, Any]] = None
               ) -> DensePlacement:
        """The gang-allocate kernel on the static mask ``gmask`` and the
        decode. ``arrays`` (default: the snapshot's tensors) may be a
        reduced copy of them whose node axis is a subset of the snapshot's
        (the pruned place); the results then index that axis. Entries of
        ``arrays`` still on the host (numpy) are copied to the device
        here.

        Traced as the reference's ``kernel`` span (tags: the route,
        ``cuda``, ``plain`` or ``native``, the padded shapes, whether
        pruned, the bytes copied), with ``tensor_build`` > ``transfer``
        (the argument list, and the host->device copy of host entries) and
        ``execute`` (the launch; asynchronous on the card, so the span
        times only the launch, and its ``kernel_ms`` tag is the kernel's
        device time from the CUDA events, read at the decode's existing
        sync; on the native route the solver's wall time).

        The native route takes its inputs on the host: the snapshot's (or
        ``arrays``') host entries as they are, the device's tensors (the
        static mask, the budgets, resident node tensors) copied back; its
        outputs move to the solver's device for the decode."""
        native = self.kernel == "native"
        on_cuda = self.device.type == "cuda" and not native
        route = "native" if native else "cuda" if on_cuda else "plain"
        G, N = gmask.shape
        with tr.span("kernel", kernel=route, g_pad=int(G), n_pad=int(N),
                     t_pad=int(self.arrays["task_group"].shape[0]),
                     pruned=arrays is not None):
            with tr.span("tensor_build"):
                with tr.span("transfer"):
                    if arrays is None:
                        self.materialize_nodes()
                    xfer, self._staged_bytes = self._staged_bytes, 0
                    a = self.arrays if arrays is None else arrays
                    if native:
                        host_in = self._host_inputs(a, arrays)
                    host = {k: int(np.asarray(v).nbytes)
                            for k, v in a.items()
                            if not isinstance(v, torch.Tensor)}
                    if host:
                        a = convert.as_tensors(a, self.device)
                    xfer += sum(host.values())
                    self.node_bytes += sum(host.get(k, 0)
                                           for k in NODE_FIELDS)
                args = convert.args(a)
                names = list(convert.FIELDS)
                args[names.index("group_mask")] = gmask
                deserved = self.queue_deserved()
                args[names.index("queue_deserved")] = deserved
            m.inc(m.DEVICE_TRANSFER_BYTES, float(xfer))
            tr.add_tags(transfer_bytes=xfer)
            R = a["group_req"].shape[1]
            plan = "host" if native else cluster_plan(
                int(N), int(R), int(deserved.shape[0]),
                int(a["ns_weight"].shape[0]),
                int(a["pool_queue"].shape[0])).kind

            if on_cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
            with tr.span("execute") as execute:
                if on_cuda:
                    start.record()
                else:
                    t0 = time.perf_counter()
                if native:
                    host_in["group_mask"] = gmask.cpu()
                    host_in["queue_deserved"] = deserved.cpu()
                    out = gang_allocate_native(
                        *convert.args(host_in), self.weights.to("cpu"),
                        allow_pipeline=allow_pipeline, ns_live=ns_live,
                        **convert.slot_kwargs(host_in))
                    assign, pipelined, ready, kept = (
                        x.to(self.device) for x in out[:4])
                else:
                    assign, pipelined, ready, kept, _ = gang_allocate_cuda(
                        *args, self.weights, allow_pipeline=allow_pipeline,
                        ns_live=ns_live, **convert.slot_kwargs(a))
                if on_cuda:
                    end.record()
                else:
                    kernel_ms = (time.perf_counter() - t0) * 1000.0
            m.inc(m.SOLVER_KERNEL_RUNS, kernel=route)

            # decode (solver.py:1036-1048): per-job and per-node totals
            J = a["job_min_available"].shape[0]
            placed = assign >= 0
            tj = a["task_job"].long()
            rows = a["group_req"][a["task_group"].long()]           # [T, R]
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
            tr.tag_span(execute, kernel_ms=kernel_ms)
        return DensePlacement(assign, pipelined, ready, kept, job_placed,
                              job_total, node_alloc_vec, deserved, gmask,
                              kernel_ms, route, plan, int(R))


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
    # the deferred staging's vectorized accounting (one array sum in place
    # of a Resource.add per placed task): the context's node arrays, the
    # per-job placed totals and the per-node allocated claims, scaled
    narr: Optional[NodeArrays] = None
    job_total_vec: Optional[Dict[str, np.ndarray]] = None  # uid -> [R]
    node_alloc_vec: Optional[np.ndarray] = None  # [N_pad, R]


class BatchSolver:
    """The session's placement context on one device (``device``:
    default the GPU, which raises when there is none).

    Conf (``configurations: [{name: solver, arguments: {...}}]``):
    ``kernel: native`` runs every place on the native CPU solver
    (ops/native.py), on either device, as the reference's forced native
    kernel does; with ``auto`` (the default) the CUDA kernel runs on the
    card and the plain loop on a CPU device, where the reference's
    ``auto`` would pick its native solver off a TPU (the port's CPU tests
    hold the plain loop). The reference's other kernel values
    (``pallas``, ``chunked``, ``scan``) and ``mesh.*`` and
    ``breaker.window`` are accepted and ignored: all its kernels are
    exact. A native solver that cannot be built raises; no route stands
    in for it. ``apply`` is the reference's: by default
    (``deferred``) the allocate action records placed gangs as per-job
    deltas and ``task.node_name`` markers, and their object-model staging
    runs at ``Session.materialize``, when something reads placement state
    (the head of every context build, the later actions); ``apply: eager``
    stages them as they are made. ``prune.*`` is candidate pruning
    (ops/prune.py): with the default ``prune.enable: auto`` a place over
    4,096 ready nodes or more runs the kernel over the union of per-gang
    shortlists, as the reference does; ``off`` keeps the full width.
    ``sampling.enable`` (with ``sampling.percentage``, 0 = adaptive, and
    ``sampling.minNodes``) builds each session's contexts over a rotating
    window of the node list (``_node_order``). ``constraints.compile: off``
    evaluates the constraint mask per pair and lowers domains by
    splitting groups (ops/constraints.py). ``victims.kernel: off`` makes
    preempt and reclaim select victims by the walk of
    framework/victims.py instead of ops/victims.py; both are exact.

    A plugin's predicate fn reaches the kernel as a mask: a plugin that
    marks itself vectorized (``mark_vectorized``) gives its own
    ``mask_fn``; any other predicate fn is swept over every group and
    node by ``host_predicate_mask`` into the static mask, on the full
    width and, through its union columns, on a pruned place."""

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
        # object decode and kernel times (ms), the kernel launches and
        # each one's ms, the batch's domain slots, the last launch's own
        # report, the bytes copied to the device for the node tensors
        # (node_bytes) and the prune summary (None when pruning did not
        # engage)
        self.stats: List[Dict[str, Any]] = []
        solver_args = (ssn.configurations or {}).get("solver")
        # the deferred object-model apply (Session.materialize), the
        # reference's default; ``apply: eager`` stages at once
        self.deferred_apply = solver_args is None or \
            solver_args.get_str("apply", "deferred") != "eager"
        self.kernel = "auto" if solver_args is None else \
            (solver_args.get_str("kernel", "auto") or "auto").strip().lower()
        self.sampling = False
        self.sampling_pct = 0.0
        self.sampling_min = 100
        if solver_args is not None and \
                solver_args.get_bool("sampling.enable", False):
            self.sampling = True
            self.sampling_pct = solver_args.get_float("sampling.percentage",
                                                      0.0)
            self.sampling_min = solver_args.get_int("sampling.minNodes", 100)
        self.prune = PruneConf.from_args(solver_args)
        # the placement explainer (trace/explain.py): the solver conf's
        # ``explain.enable`` overrides the module switch; the operator's
        # shortlist width joins its recorded coverage widths
        self.explain = explain.session_enabled(solver_args)
        if not self.prune.off:
            explain.register_prune_k(self.prune.k)
        # the group mask's parts for the explainer's ladder, set by each
        # context build while the explainer is on
        self._explain_parts: List[Tuple[str, np.ndarray]] = []
        self._sampled_names: Optional[List[str]] = None
        # the exact-dedupe license of the shortlist distillation, set by
        # each context build (_context)
        self._prune_dedupe_ok = False
        # the last host-predicate sweep's ms, groups and nodes (None when
        # no plugin registered a host predicate)
        self._host_record: Optional[Dict[str, Any]] = None

    def _node_order(self) -> List[str]:
        """The node names the contexts are built over: every ready node,
        or with sampling a window of max(minNodes, pct% of N) names
        (adaptive pct = 50 - N/125, at least 5), stable within the
        session; the window's start advances by its width each sampled
        session (volcano_tpu/framework/solver.py:392-419)."""
        if self.sampling and self._sampled_names is not None:
            return self._sampled_names
        names = [n.name for n in self.ssn.node_list]
        if not self.sampling:
            return names
        n = len(names)
        k = n
        if n > self.sampling_min:
            pct = self.sampling_pct or max(5.0, 50.0 - n / 125.0)
            k = min(n, max(self.sampling_min, int(n * pct / 100.0)))
        if k >= n:
            self._sampled_names = names
            return names
        global _node_cursor
        start = _node_cursor % n
        _node_cursor += k
        window = names[start:start + k]
        if len(window) < k:
            window += names[:k - len(window)]
        self._sampled_names = window
        return window

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

    # -- the incremental cycle's persistent node state --------------------

    def _incr_state(self) -> Optional[_IncrNodeState]:
        if self.ssn.cache is None:
            return None
        return getattr(self.ssn.cache, "_incr_solver_state", None)

    def _incremental_node_arrays(self) -> Optional[NodeArrays]:
        """The session's first node encode through the persistent host
        arrays (volcano_tpu/framework/solver.py:624-659), re-encoding the
        pending rows only; else a fresh build, installed as the new
        persistent state. None (a plain fresh build) outside the
        incremental cycle and with sampling."""
        ssn = self.ssn
        state = self._incr_state()
        if state is None or ssn.incr_mode is None or self.sampling:
            return None
        order = self._node_order()
        if ssn.incr_mode == "incremental" and state.narr is not None \
                and state.rindex is self.rindex \
                and state.names == order \
                and not ssn.touched_nodes \
                and len(state.pending) <= max(64, len(order) // 4):
            rows = state.narr.update_rows(ssn.nodes, state.pending)
            state.pending = set()
            state.dev_dirty_rows.update(rows)
            return state.narr
        # membership, order or ResourceIndex changed, or too many rows
        # are pending: the resident tensors go with the host arrays
        narr = NodeArrays.build(ssn.nodes, order, self.rindex)
        state.narr = narr
        state.rindex = self.rindex
        state.names = list(order)
        state.pending = set()
        state.dev = None
        state.dev_dirty_rows = set()
        return narr

    def _device_node_inputs(self, narr: NodeArrays
                            ) -> Tuple[Dict[str, torch.Tensor], int]:
        """The kernel's five node tensors on the solver's device and the
        bytes copied for them (volcano_tpu/framework/solver.py:661-703):
        the resident tensors with only the dirty rows copied in
        (``index_copy_``) when ``narr`` is the persistent host state,
        else a full upload. A fresh resident set counts as
        ``volcano_solver_device_buffer_total{event="rebuild"}``, a reused
        one as ``{event="reuse"}``."""
        dev = self.device
        state = self._incr_state()

        def upload(host):
            # a copy, never a view of the host arrays (on the CPU
            # from_numpy would share them with the persistent NodeArrays)
            return {f: torch.tensor(a, dtype=convert.FIELDS[f], device=dev)
                    for f, a in host.items()}

        if state is None or state.narr is not narr:
            host = node_inputs_of(narr)
            return upload(host), sum(int(a.nbytes) for a in host.values())
        if state.dev is None or state.device != dev:
            host = node_inputs_of(narr)
            state.dev = upload(host)
            state.device = dev
            state.dev_dirty_rows = set()
            m.inc(m.SOLVER_DEVICE_BUFFER, event="rebuild")
            return dict(state.dev), sum(int(a.nbytes) for a in host.values())
        xfer = 0
        rows = sorted(state.dev_dirty_rows)
        if rows:
            idx = torch.tensor(rows, dtype=torch.long, device=dev)
            host_rows = {
                "node_idle": narr.idle[rows],
                "node_future": narr.idle[rows] + narr.releasing[rows]
                - narr.pipelined[rows],
                "node_alloc": narr.allocatable[rows],
                "node_ntasks": narr.n_tasks[rows],
                "node_max_tasks": narr.max_tasks[rows]}
            for f, hr in host_rows.items():
                state.dev[f].index_copy_(0, idx, torch.from_numpy(hr).to(
                    device=dev, dtype=convert.FIELDS[f]))
                xfer += int(hr.nbytes)
            state.dev_dirty_rows = set()
        m.inc(m.SOLVER_DEVICE_BUFFER, event="reuse")
        return dict(state.dev), xfer

    def host_predicate_mask(self, batch: TaskBatch, narr: NodeArrays
                            ) -> Optional[np.ndarray]:
        """The [G, N] mask of the host predicates: the predicate fns of
        the plugins that did not mark themselves vectorized, called for
        each group's first task on every node of ``narr``
        (volcano_tpu/framework/solver.py:487-526); None without any.

        O(G x N) Python, as in the reference, so the first use logs which
        plugins forced the sweep; it runs inside the span
        ``host_predicates`` (tagged with G, the nodes and the plugins).
        A predicate vetoes a node by raising (the PredicateFn error
        contract, scheduler_helper.go:95-127): FitException and the
        assertion, lookup, runtime and value errors a filter raises;
        anything else is a plugin bug, logged once and re-raised rather
        than read as "node infeasible"."""
        extra = {name: fn for name, fn in self.ssn.predicate_fns.items()
                 if name not in self.vectorized_plugins}
        if not extra:
            return None
        from ..plugins.predicates import FitException
        veto_types = (FitException, AssertionError, KeyError, RuntimeError,
                      ValueError)
        _log_once("host-predicate fallback active for plugins "
                  f"{sorted(extra)}: per-node Python sweep (register a "
                  "vectorized mask_fn for solver-speed predicates)")
        mask = np.ones((batch.g_pad, narr.n_pad), bool)
        name_to_idx = narr.name_to_idx
        columns = [(name_to_idx[name], node)
                   for name, node in self.ssn.nodes.items()
                   if name in name_to_idx]
        fns = list(extra.items())
        t0 = time.perf_counter()
        with tr.span("host_predicates", groups=batch.n_groups,
                     nodes=len(columns), plugins=sorted(extra)):
            for g, members in enumerate(batch.group_members):
                rep = batch.tasks[members[0]]
                row = mask[g]
                for i, node in columns:
                    for pname, fn in fns:
                        try:
                            fn(rep, node)
                        except veto_types:
                            row[i] = False
                            break
                        except Exception:
                            _log_once(f"host predicate {pname!r} raised an "
                                      "unexpected error (plugin bug?)")
                            raise
        self._host_record = {"ms": (time.perf_counter() - t0) * 1000.0,
                             "groups": batch.n_groups,
                             "nodes": len(columns)}
        return mask

    def _context(self, ordered_jobs, device, slot_tensors: bool = False
                 ) -> Tuple[NodeArrays, TaskBatch, "DenseSolver"]:
        """Encode the batch against the session's current node state and
        compose the plugins' contributions into a DenseSolver on
        ``device`` (volcano_tpu/framework/solver.py:528-811);
        ``slot_tensors`` picks the topology-domain lowering
        (``_lower_constraints``) and marks the place path, whose
        DenseSolver takes the node tensors from ``_device_node_inputs``.
        The session's first build goes through the persistent node state
        (``_incremental_node_arrays``); later builds see the nodes the
        session mutated and encode afresh. Deferred placements are applied
        first (``Session.materialize``), so the encode sees them."""
        ssn = self.ssn
        ssn.materialize()
        narr = None
        if not getattr(ssn, "_narr_first_done", False):
            ssn._narr_first_done = True
            narr = self._incremental_node_arrays()
        if narr is None:
            narr = NodeArrays.build(ssn.nodes, self._node_order(),
                                    self.rindex)
        batch, slot_entries = self._lower_constraints(ordered_jobs, narr,
                                                      slot_tensors)
        feats = arrays.PredicateFeatures.build(ssn.nodes, narr, batch,
                                               slot_entries=slot_entries)

        gmask = None
        parts: List[Tuple[str, np.ndarray]] = []
        if self.enable_default_predicates and \
                feats.group_affinity_ok is not None:
            gmask = feats.group_affinity_ok
            parts.append(("node_affinity", gmask))
        for fn in self.mask_fns:
            contrib = fn(batch, narr, feats)
            if contrib is not None:
                gmask = contrib if gmask is None else gmask & contrib
                parts.append((getattr(fn, "explain_label", "plugin"),
                              contrib))
        host_mask = self.host_predicate_mask(batch, narr)
        if host_mask is not None:
            gmask = host_mask if gmask is None else gmask & host_mask
            parts.append(("host_predicates", host_mask))
        self._explain_parts = parts if self.explain else []
        static_score = None
        for fn in self.static_score_fns:
            contrib = fn(batch, narr, feats)
            if contrib is not None:
                static_score = contrib if static_score is None \
                    else static_score + contrib
        # the distillation's exact-dedupe license (ops/prune.py), as the
        # reference grants it (volcano_tpu/framework/solver.py:720-804):
        # no mask stage beyond the capability fit applied (the selector
        # and taint masks DenseSolver.static_mask adds, node affinity, a
        # plugin's mask, the host predicates) and no static score, so
        # that identical request rows have identical mask and score rows
        selector_or_taint = self.enable_default_predicates and (
            bool(feats.group_require_counts.any())
            or bool(feats.node_taints.any()))
        self._prune_dedupe_ok = gmask is None and static_score is None \
            and not selector_or_taint
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
            "eps": self.rindex.eps}
        node_inputs = None
        if slot_tensors:
            node_inputs = lambda: self._device_node_inputs(narr)
        else:
            snapshot.update(node_inputs_of(narr))
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
                            valid=narr.valid, node_inputs=node_inputs,
                            kernel=self.kernel)
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
        against the session's *current* node state (span solver.place,
        tagged with the placed tasks and committed jobs)."""
        with tr.span("solver.place", jobs=len(ordered_jobs)):
            result = self._place(ordered_jobs, allow_pipeline)
            tr.add_tags(
                placed=sum(len(p) for p in result.placements.values()),
                committed=sum(1 for ok in result.committed.values() if ok))
            return result

    def _place(self, ordered_jobs, allow_pipeline: bool) -> PlacementResult:
        global _place_counter
        t0 = time.perf_counter()
        self.ssn._constraint_ms = 0.0
        self._host_record = None
        with tr.span("build_context"):
            narr, batch, dense = self._context(ordered_jobs, self.device,
                                               slot_tensors=True)
            t1 = time.perf_counter()
            stages = [] if self.explain else None
            gmask = dense.static_mask(stages, self._explain_parts)
        # kernel cost attribution: padded against live rows of each
        # kernel axis, and the fleet fragmentation gauge
        _place_counter += 1
        n_real_nodes = len(narr.names)
        m.set_gauge(m.PADDED_WASTE, round(
            1.0 - n_real_nodes / max(1, narr.n_pad), 4), axis="nodes")
        m.set_gauge(m.PADDED_WASTE, round(
            1.0 - batch.n_groups / max(1, batch.g_pad), 4), axis="groups")
        m.set_gauge(m.PADDED_WASTE, round(
            1.0 - len(batch.tasks) / max(1, int(batch.task_group.shape[0])),
            4), axis="tasks")
        if self.explain or _place_counter % FRAG_EVERY == 0:
            explain.note_fragmentation(narr)
        t_kernel = time.perf_counter()
        runs: List[DensePlacement] = []
        ctx, distill_ms, assign = None, None, None
        if self.prune.active(n_real_nodes):
            ctx, distill_ms, assign = self._place_pruned(
                narr, batch, dense, gmask, allow_pipeline, runs)
        if assign is None:
            runs.append(dense.launch(gmask, allow_pipeline, self._ns_live))
            assign = runs[-1].assign.cpu().numpy()
        out = runs[-1]
        pipelined = out.pipelined.cpu().numpy()
        ready_list = out.ready.cpu().tolist()
        kept_list = out.kept.cpu().tolist()
        t2 = time.perf_counter()
        m.observe(m.SOLVER_KERNEL_LATENCY, (t2 - t_kernel) * 1000.0)
        if out.route == "native":
            stats = gang_allocate_native.last_stats
        elif out.route == "cuda":
            stats = gang_allocate_cuda.last_stats
        else:
            stats = None
        prune_record = None
        if ctx is not None:
            prune_record = dict(ctx.summary(), served=ctx.fallback is None,
                                distill_ms=distill_ms, u_pad=ctx.u_pad)
        self.stats.append({
            "encode_ms": (t1 - t0) * 1000.0,
            "constraint_ms": self.ssn._constraint_ms,
            "slots": 0 if batch.slot_rows is None
            else batch.slot_rows.shape[0] - 1,
            "solve_ms": (t2 - t1) * 1000.0,
            "kernel_ms": sum(r.kernel_ms for r in runs),
            "launches": len(runs),
            "launch_ms": [r.kernel_ms for r in runs],
            "launch": stats.tolist() if stats is not None else None,
            "plan": out.plan,
            "R": out.r,
            "node_bytes": dense.node_bytes,
            "host_predicates": self._host_record,
            "prune": prune_record})

        # decode (volcano_tpu/framework/solver.py:1016-1106): one pass over
        # the assign vector; each job reads its window of the sorted
        # placed/unplaced indices
        uid_to_j = {uid: j for j, uid in enumerate(batch.job_uids)}
        result = PlacementResult(batch=batch, committed={}, kept={},
                                 placements={}, unplaced={}, narr=narr)
        unplaced_records: List[Tuple[JobInfo, TaskInfo, int]] = []
        all_tasks = batch.tasks
        a_real = assign[:len(all_tasks)]
        placed_all = np.flatnonzero(a_real >= 0)
        unplaced_all = np.flatnonzero(a_real < 0)
        if placed_all.size:
            # per-job and per-node placed totals for the deferred staging
            # (volcano_tpu/framework/solver.py:1033-1048)
            rows_req = batch.group_req[batch.task_group[placed_all]]
            jt = np.zeros((len(batch.job_uids), self.rindex.r), np.float32)
            np.add.at(jt, batch.task_job[placed_all], rows_req)
            result.job_total_vec = {uid: jt[j]
                                    for uid, j in uid_to_j.items()
                                    if jt[j].any()}
            alloc_rows = ~pipelined[placed_all].astype(bool)
            if alloc_rows.any():
                nv = np.zeros((narr.idle.shape[0], self.rindex.r),
                              np.float32)
                np.add.at(nv, a_real[placed_all][alloc_rows],
                          rows_req[alloc_rows])
                result.node_alloc_vec = nv
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
            with tr.span("fit_errors", tasks=len(unplaced_records)):
                gs = sorted({g for _, _, g in unplaced_records})
                rows = gmask[torch.tensor(gs, device=gmask.device)] \
                    .cpu().numpy()
                row_of = {g: rows[i] for i, g in enumerate(gs)}
                for job, task, g in unplaced_records:
                    self._record_fit_errors(job, task, narr, row_of[g])
        self.stats[-1]["decode_ms"] = (time.perf_counter() - t2) * 1000.0
        if self.explain:
            # decision provenance from the mask and score this place
            # compiled (trace/explain.py)
            with tr.span("explain_capture"):
                explain.record_place(
                    self.ssn, batch, narr, stages, gmask,
                    dense.arrays["group_static_score"], dense.weights,
                    assign, result, out.route)
        return result

    def _reduced_inputs(self, batch: TaskBatch, narr: NodeArrays,
                        dense: DenseSolver, gmask: torch.Tensor,
                        ctx: prune.PruneContext) -> Dict[str, torch.Tensor]:
        """The kernel's inputs on the shortlist union's columns
        (volcano_tpu/framework/solver.py:1322-1352): mask and static-score
        columns gathered on the device, the slot rows' columns and the
        five node arrays gathered on the host; padding columns are
        infeasible, so the kernel selects only live union entries."""
        dev = self.device
        u = torch.from_numpy(ctx.union_padded).to(dev)
        live = torch.from_numpy(ctx.live).to(dev)
        a = dict(dense.arrays)
        a["group_mask"] = gmask.index_select(1, u) & live[None, :]
        a["group_static_score"] = \
            a["group_static_score"].index_select(1, u)
        if "slot_ok" in a:
            rows = np.take(batch.slot_rows, ctx.union_padded, axis=1)
            rows[:, ~ctx.live] = False
            a["slot_ok"] = torch.from_numpy(rows).to(dev)
        idx = ctx.union_padded
        for name, host in node_inputs_of(narr).items():
            a[name] = host[idx]
        return a

    def _place_pruned(self, narr: NodeArrays, batch: TaskBatch,
                      dense: DenseSolver, gmask: torch.Tensor,
                      allow_pipeline: bool, runs: List[DensePlacement]):
        """One pruned placement attempt (volcano_tpu/framework/solver.py:
        1354-1426): distill the shortlists, run the kernel on the union's
        columns, map its placements back. Returns (the PruneContext, the
        distillation's ms, the global assign or None): None, with the
        context's ``fallback`` set, when a pre-kernel guard (low coverage,
        a wide or empty union) or the post-kernel exhaustion guard sends
        the place to the full-width kernel; each fallback counts once on
        volcano_prune_fallback_total{reason}. The reduced run's placement
        is appended to ``runs``. No exception is caught: a failing
        distillation or launch fails the place. Spans prune_distill and
        pruned_kernel, the latter tagged with the reduced launch's
        ``kernel_ms``."""
        t0 = time.perf_counter()
        with tr.span("prune_distill", k=self.prune.k):
            ctx = prune.distill(batch, narr, gmask,
                                dense.arrays["group_static_score"],
                                dense.weights, self.prune,
                                dedupe=self._prune_dedupe_ok)
        distill_ms = (time.perf_counter() - t0) * 1000.0
        guard = ctx.pre_guard()
        if guard is not None:
            ctx.fallback, ctx.fallback_pairs = guard
            m.inc(m.PRUNE_FALLBACK, reason=ctx.fallback)
            explain.note_prune(ctx.summary())
            return ctx, distill_ms, None
        with tr.span("pruned_kernel", union=ctx.m_real,
                     level=ctx.level) as span:
            reduced = self._reduced_inputs(batch, narr, dense, gmask, ctx)
            runs.append(dense.launch(reduced["group_mask"], allow_pipeline,
                                     self._ns_live, arrays=reduced))
            assign = ctx.map_assign(runs[-1].assign.cpu().numpy())
        tr.tag_span(span, kernel_ms=runs[-1].kernel_ms)
        if ctx.post_guard(assign, batch):
            ctx.fallback = "shortlist_exhausted"
            m.inc(m.PRUNE_FALLBACK, reason=ctx.fallback)
            explain.note_prune(ctx.summary())
            return ctx, distill_ms, None
        m.inc(m.PRUNE_RUNS, level=ctx.level)
        m.set_gauge(m.PRUNE_UNION_WIDTH, float(ctx.m_real))
        explain.note_prune(ctx.summary())
        return ctx, distill_ms, assign

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
