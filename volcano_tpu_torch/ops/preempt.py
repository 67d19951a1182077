"""Victim-prefix functions of preempt and reclaim as torch functions
(counterpart of volcano_tpu/ops/preempt.py and of the batch forms of
volcano_tpu/ops/victims.py:61-77).

Per node, the eviction-ordered victim resources are summed cumulatively
along the victim axis and the smallest feasible prefix is found with one
comparison and a first-true reduction (the pop-until-fit loops of
preempt.go:237-251 and reclaim.go:153-166), with every node evaluated at
once. ValidateVictims (scheduler_helper.go:239-252) is folded in: a node is
feasible only with at least one victim, and with its whole victim set plus
the base availability covering the request.

The single forms compute on their inputs' device. The batch forms take a
leading preemptor axis on ``req`` and ``node_ok`` and an explicit
``device`` (the GPU unless the caller names another); their [B, N, V+1]
intermediates are built ``chunk`` preemptors at a time, so that 5,000
preemptors x 10,000 nodes never materialise gigabytes at once. The
preempt and reclaim actions themselves select victims on the host
(framework/victims.py, ops/victims.py): they apply evictions between
preemptors, so batching across preemptors would change their answers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.platform import default_device

NEG = -1e30

# elements of one chunk's [B, N, V+1] intermediates in the batch forms
CHUNK_ELEMS = 1 << 26


def _first_true(mask: torch.Tensor, ks: torch.Tensor, none: int) -> torch.Tensor:
    """Along the last axis, ``ks`` at the first True of ``mask``, else
    ``none``."""
    return torch.where(mask, ks, none).amin(dim=-1)


def victim_prefix(req: torch.Tensor,          # [R] preemptor request
                  node_ok: torch.Tensor,      # [N] bool (predicates passed)
                  base_avail: torch.Tensor,   # [N, R] avail before eviction
                  victim_res: torch.Tensor,   # [N, V, R] eviction order
                  victim_valid: torch.Tensor,  # [N, V] bool
                  eps: torch.Tensor           # [R]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per node, the smallest victim prefix whose release makes ``req``
    fit: (feasible [N] bool, n_evict [N] i32). feasible: the node passed
    predicates, has a victim, and evicting all of them (plus base_avail)
    covers req; n_evict: the shortest feasible prefix's length (0 when req
    already fits base_avail), 0 where not feasible."""
    feasible, n_evict = victim_prefix_batch(
        req[None], node_ok[None], base_avail, victim_res, victim_valid, eps,
        device=req.device)
    return feasible[0], n_evict[0]


def reclaim_prefix(req: torch.Tensor,          # [R]
                   node_ok: torch.Tensor,      # [N] bool
                   future_idle: torch.Tensor,  # [N, R] for ValidateVictims
                   victim_res: torch.Tensor,   # [N, V, R] plugin order
                   victim_valid: torch.Tensor,  # [N, V] bool
                   eps: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reclaim's variant (reclaim.go:149-181): victims are evicted in
    order until their summed resources alone cover the request; future
    idle only enters ValidateVictims. Returns (feasible [N], n_evict [N]:
    all valid victims when coverage is never reached, covered [N]: the
    evicted prefix covers req)."""
    feasible, n_evict, covered = reclaim_prefix_batch(
        req[None], node_ok[None], future_idle, victim_res, victim_valid, eps,
        device=req.device)
    return feasible[0], n_evict[0], covered[0]


def pick_best_node(feasible: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """Along the last axis, the highest-scoring feasible node, ties to the
    lowest index, or -1 (SortNodes + first feasible, preempt.go:206-267)."""
    best = torch.argmax(torch.where(feasible, score, NEG), dim=-1)
    return torch.where(feasible.any(dim=-1), best, -1).to(torch.int32)


def _inputs(device, *arrays):
    return [torch.as_tensor(a).to(device) for a in arrays]


def _chunks(b: int, per_row: int, chunk: Optional[int]):
    step = chunk or max(1, CHUNK_ELEMS // max(1, per_row))
    for lo in range(0, b, step):
        yield lo, min(b, lo + step)


def victim_prefix_batch(req, node_ok, base_avail, victim_res, victim_valid,
                        eps, *, device=None, chunk: Optional[int] = None):
    """:func:`victim_prefix` over a preemptor batch: req [B, R] and
    node_ok [B, N], the rest shared -> (feasible [B, N], n_evict [B, N])
    on ``device``."""
    device = default_device(device)
    req, node_ok, base_avail, victim_res, victim_valid, eps = _inputs(
        device, req, node_ok, base_avail, victim_res, victim_valid, eps)
    n, v, r = victim_res.shape
    cum = torch.cumsum(torch.where(victim_valid[..., None], victim_res, 0.0),
                       dim=1)
    cum0 = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
    thr = (base_avail[:, None, :] + cum0) + eps[None, None, :]  # [N, V+1, R]
    n_valid = victim_valid.sum(dim=1).to(torch.int32)
    ks = torch.arange(v + 1, dtype=torch.int32, device=device)
    k_ok = ks[None, :] <= n_valid[:, None]                       # [N, V+1]
    has = n_valid > 0
    b = req.shape[0]
    feasible = torch.empty((b, n), dtype=torch.bool, device=device)
    n_evict = torch.empty((b, n), dtype=torch.int32, device=device)
    for lo, hi in _chunks(b, n * (v + 1), chunk):
        feas_k = k_ok[None].expand(hi - lo, n, v + 1).clone()
        for c in range(r):
            feas_k &= req[lo:hi, c, None, None] <= thr[None, :, :, c]
        f = node_ok[lo:hi] & has[None] & feas_k.any(dim=-1)
        feasible[lo:hi] = f
        n_evict[lo:hi] = torch.where(f, _first_true(feas_k, ks, v + 1), 0)
    return feasible, n_evict


def reclaim_prefix_batch(req, node_ok, future_idle, victim_res, victim_valid,
                         eps, *, device=None, chunk: Optional[int] = None):
    """:func:`reclaim_prefix` over a preemptor batch: req [B, R] and
    node_ok [B, N], the rest shared -> (feasible, n_evict, covered), each
    [B, N], on ``device``."""
    device = default_device(device)
    req, node_ok, future_idle, victim_res, victim_valid, eps = _inputs(
        device, req, node_ok, future_idle, victim_res, victim_valid, eps)
    n, v, r = victim_res.shape
    masked = torch.where(victim_valid[..., None], victim_res, 0.0)
    cover_thr = torch.cumsum(masked, dim=1) + eps[None, None, :]  # [N, V, R]
    valid_thr = (future_idle + masked.sum(dim=1)) + eps[None, :]  # [N, R]
    n_valid = victim_valid.sum(dim=1).to(torch.int32)
    ks = torch.arange(1, v + 1, dtype=torch.int32, device=device)
    k_ok = ks[None, :] <= n_valid[:, None]                        # [N, V]
    has = n_valid > 0
    b = req.shape[0]
    feasible = torch.empty((b, n), dtype=torch.bool, device=device)
    n_evict = torch.empty((b, n), dtype=torch.int32, device=device)
    covered = torch.empty((b, n), dtype=torch.bool, device=device)
    for lo, hi in _chunks(b, n * max(1, v), chunk):
        feas_k = k_ok[None].expand(hi - lo, n, v).clone()
        validate = node_ok[lo:hi] & has[None]
        for c in range(r):
            feas_k &= req[lo:hi, c, None, None] <= cover_thr[None, :, :, c]
            validate &= req[lo:hi, c, None] <= valid_thr[None, :, c]
        any_k = feas_k.any(dim=-1)
        first = _first_true(feas_k, ks, v + 1)
        feasible[lo:hi] = validate
        n_evict[lo:hi] = torch.where(
            validate, torch.where(any_k, first, n_valid[None]), 0)
        covered[lo:hi] = any_k & validate
    return feasible, n_evict, covered


def pack_node_major(node_of: np.ndarray, res: np.ndarray, n: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack victim rows sorted by node (``node_of`` [M] non-decreasing,
    ``res`` [M, R]) into (victim_res [n, V, R] f32, victim_valid [n, V]
    bool, seg_lo [n]): node i's victims in row order, V the most any node
    holds, seg_lo[i] the first row of node i."""
    seg_lo = np.searchsorted(node_of, np.arange(n))
    seg_hi = np.searchsorted(node_of, np.arange(n) + 1)
    vmax = int((seg_hi - seg_lo).max()) if n else 0
    vres = np.zeros((n, vmax, res.shape[1]), np.float32)
    vvalid = np.zeros((n, vmax), bool)
    pos = np.arange(len(node_of)) - seg_lo[node_of]
    vres[node_of, pos] = res
    vvalid[node_of, pos] = True
    return vres, vvalid, seg_lo
