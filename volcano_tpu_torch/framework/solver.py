"""The per-cycle placement solve on dense tensors (counterpart of
volcano_tpu/framework/solver.py: ``_fused_static_mask``, the mask and score
composition of ``_apply_masks_and_scores``, and ``BatchSolver.place`` with
its decode).

``DenseSolver`` starts from the encoded snapshot (the fields of
utils.synth.SynthArrays) and runs: the capability-fit mask through unique
capability rows; the selector and taint masks when predicate features are
given; the proportion water-fill of queue budgets when queue weights are
given; the gang-allocate kernel; and the decode into per-job and per-node
totals. One kernel serves each device: the CUDA kernel on the GPU, the
plain loop on the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from .. import convert
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
    raises when there is none. Every node counts as valid: padded nodes
    have zero capability and fail the capability fit."""

    def __init__(self, snapshot: Any, weights: ScoreWeights,
                 device=None, *, features: Optional[PredicateFeatures] = None,
                 queues: Optional[QueueBudgets] = None):
        self.device = default_device(device)
        self.arrays = convert.as_tensors(snapshot, self.device)
        self.weights = weights.to(self.device)
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
        uniq_cap, inv = torch.unique(a["node_alloc"], dim=0,
                                     return_inverse=True)
        valid = torch.ones(inv.shape[0], dtype=torch.bool, device=self.device)
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
        args[names.index("group_mask")] = self.static_mask()
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
            ns_live=ns_live)
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
                              job_total, node_alloc_vec, deserved, kernel_ms)
