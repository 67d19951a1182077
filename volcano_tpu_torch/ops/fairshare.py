"""Fair share: proportion water-fill and dominant-resource shares
(counterpart of volcano_tpu/ops/fairshare.py).

Both evaluate every queue at once over dense [Q, R] tensors. The
water-fill's data-dependent fixed point is a plain Python ``while`` loop:
Q and R are small, and the loop runs a handful of passes.
"""

from __future__ import annotations

from typing import Tuple

import torch


def proportion_waterfill(weight: torch.Tensor,      # [Q] f32
                         capability: torch.Tensor,  # [Q, R] f32, +inf = unset
                         request: torch.Tensor,     # [Q, R] f32
                         total: torch.Tensor,       # [R] f32
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative weighted water-fill of per-queue deserved resources.

    Each pass hands every unmet queue ``remaining * w / total_w``; a queue
    whose deserved crosses its capability is clamped to
    min(capability, request) and marked met; one whose request is satisfied
    is clamped to its request and marked met; otherwise deserved is
    dimension-clamped to the request. The pass's net growth leaves
    ``remaining``; the loop ends when remaining is empty or unchanged, or
    no unmet queue is left.

    Returns (deserved [Q, R], met [Q] bool).
    """
    q, r = request.shape
    has_cap = torch.any(torch.isfinite(capability), dim=-1)           # [Q]
    deserved = torch.zeros((q, r), dtype=torch.float32, device=request.device)
    met = torch.zeros(q, dtype=torch.bool, device=request.device)
    remaining = total.clone()
    prev_remaining = None
    while True:
        live_w = torch.where(met, 0.0, weight)
        total_w = live_w.sum()
        unchanged = prev_remaining is not None and \
            bool(torch.all(remaining == prev_remaining))
        empty = bool(torch.all(remaining <= 0.0))
        if not (bool(total_w > 0) and not empty and not unchanged):
            return deserved, met
        frac = live_w / torch.clamp(total_w, min=1e-9)
        grown = deserved + remaining[None, :] * frac[:, None]         # [Q, R]

        over_cap = has_cap & ~torch.all(grown <= capability, dim=-1)
        req_met = torch.all(request <= grown, dim=-1)
        cap_clamped = torch.minimum(torch.minimum(grown, capability), request)
        req_clamped = torch.minimum(grown, request)
        new_deserved = torch.where(
            over_cap[:, None], cap_clamped,
            torch.where(req_met[:, None], req_clamped,
                        torch.minimum(grown, request)))
        new_deserved = torch.where(met[:, None], deserved, new_deserved)
        met = met | over_cap | req_met

        delta = new_deserved - deserved                   # per-queue growth
        prev_remaining = remaining
        remaining = remaining - delta.sum(dim=0)
        deserved = new_deserved


def dominant_share(allocated: torch.Tensor,   # [..., R] f32
                   total: torch.Tensor,       # [R] f32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """share = max_r allocated_r / total_r with 0/0 = 0 and x/0 = 1.

    Returns (share [...], dominant dim index [...] i32; the lowest index
    among equal shares)."""
    zero_total = total == 0.0
    frac = torch.where(zero_total,
                       torch.where(allocated == 0.0, 0.0, 1.0),
                       allocated / torch.where(zero_total, 1.0, total))
    share = frac.max(dim=-1).values
    return share, torch.argmax(frac, dim=-1).to(torch.int32)
