"""The explainer's fused top-k pass (counterpart of
volcano_tpu/trace/explain.py:_topk_fn and its ``fused``).

One pass over a block of [B, N] mask rows and the session-open score:
feasible counts, the top-k masked values and their node indices, and the
min-shifted score-mass coverage of the top k. Candidate pruning
(ops/prune.py) distills its shortlists with it; the explainer's other
coverage widths come with the rest of the explainer.

Ranking is ``jax.lax.top_k``'s: the float32 total order (+0.0 above -0.0),
and among equal values the lower node index first. ``torch.topk`` keeps
neither tie rule and a stable sort does not rank +0.0 above -0.0, so the
pass ranks unique int64 keys instead (``rank_keys``): every row's order is
then fixed by the data alone, on any device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.score import ScoreWeights, node_score

NEG = -1e30


def rank_keys(x: torch.Tensor) -> torch.Tensor:
    """[B, N] float32 -> [B, N] int64 keys, unique within a row, that order
    as ``lax.top_k`` ranks: by the float's total order (its bits as a signed
    integer, the magnitude bits of a negative flipped), then by the lower
    column (N - 1 - column in the low 32 bits)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    n = x.shape[-1]
    rev = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=x.device)
    return ordered * (1 << 32) + rev


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of each row's k largest entries of float32 ``x``
    [B, N], in ``lax.top_k``'s order."""
    idx = torch.topk(rank_keys(x), k, dim=1, largest=True, sorted=True).indices
    return x.gather(1, idx), idx


def fused(group_req: torch.Tensor, idle: torch.Tensor, alloc: torch.Tensor,
          static: torch.Tensor, mask: torch.Tensor, weights: ScoreWeights,
          k: int):
    """(feasible [B], vals [B, k], idx [B, k], cov [B]) for B rows:
    ``group_req`` [B, R] against the node state ``idle``/``alloc`` [N, R]
    with ``static`` [B, N] and ``mask`` [B, N]. ``cov`` is the top-k
    min-shifted masked values over the row's min-shifted total (1 where
    the total is 0); k is clamped to N."""
    score = node_score(group_req, idle, alloc, weights, static)
    masked = torch.where(mask, score, NEG)
    vals, idx = top_k(masked, min(k, mask.shape[1]))
    feasible = mask.sum(dim=1)
    minf = torch.where(mask, score, 1e30).amin(dim=1)
    total = torch.where(mask, score - minf[:, None], 0.0).sum(dim=1)
    # the top-k min-shifted mass is the top-k masked values shifted and
    # clipped: an infeasible NEG entry clips to the 0 its column adds
    svals = torch.clamp(vals - minf[:, None], min=0.0)
    cov = torch.where(total > 0.0, svals.sum(dim=1) / total, 1.0)
    return feasible, vals, idx, cov
