"""Node scoring (counterpart of volcano_tpu/ops/score.py).

Dynamic terms (binpack / least / most / balanced) read the current idle
state, so the allocate loop evaluates them at every placement; static
terms arrive per group x node as ``static_bonus``.

Every sum is written out term by term in a fixed order, and no multiply is
fused into an add, so that the CUDA kernel (csrc/gang_allocate.cu, built
with -fmad=false) rounds exactly as this code does on the same card.

``host_node_score`` is the numpy form the preempt and reclaim walks read
(framework/victims.py): it is the reference's ``node_score(..., xp=np)``
written out with numpy's own reductions, so that it rounds bit for bit as
the reference does. Every node ties in the preempt and reclaim shapes, so
one rounding difference would change which node loses its pods.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch


class ScoreWeights(NamedTuple):
    """Score-term weights as float32 tensors; zeros disable a term.

    binpack_res [R]: per-resource binpack weights
    binpack [ ]    : overall binpack plugin weight
    least [ ]      : nodeorder leastrequested weight
    most [ ]       : nodeorder mostrequested weight
    balanced [ ]   : nodeorder balancedresource weight
    """
    binpack_res: torch.Tensor
    binpack: torch.Tensor
    least: torch.Tensor
    most: torch.Tensor
    balanced: torch.Tensor

    @classmethod
    def make(cls, r: int, binpack_res: Optional[Sequence[float]] = None,
             binpack: float = 0.0, least: float = 1.0, most: float = 0.0,
             balanced: float = 1.0,
             device: Union[str, torch.device, None] = "cpu"
             ) -> "ScoreWeights":
        br = torch.ones(r, dtype=torch.float32) if binpack_res is None \
            else torch.as_tensor(binpack_res, dtype=torch.float32)

        def scalar(x):
            return torch.tensor(float(x), dtype=torch.float32, device=device)
        return cls(br.to(device), scalar(binpack), scalar(least),
                   scalar(most), scalar(balanced))

    def to(self, device: Union[str, torch.device]) -> "ScoreWeights":
        return ScoreWeights(*(t.to(device) for t in self))

    def host(self) -> "ScoreWeights":
        """Host-value copy (a numpy array and Python floats) for
        :func:`host_node_score`, converted once instead of per call."""
        return ScoreWeights(self.binpack_res.cpu().numpy(),
                            float(self.binpack), float(self.least),
                            float(self.most), float(self.balanced))


def _fsum(cols):
    """Left-to-right float sum of a sequence of equal-shape tensors."""
    acc = cols[0]
    for c in cols[1:]:
        acc = acc + c
    return acc


def binpack_score(req: torch.Tensor, used: torch.Tensor, alloc: torch.Tensor,
                  w_res: torch.Tensor) -> torch.Tensor:
    """Best-fit packing score, 0..100.

    score_r = (used_r + req_r) * 100 / alloc_r for requested dims, weighted
    by w_res and normalized by the sum of participating weights. A node where
    a requested dim overflows alloc scores 0 in that dim.
    req [R], used [N,R], alloc [N,R] -> [N]."""
    requested = (req > 0) & (w_res > 0)
    frac = torch.where(alloc > 0,
                       (used + req[None, :]) / torch.clamp(alloc, min=1e-9),
                       2.0)
    per_res = torch.where(frac <= 1.0, frac * 100.0, 0.0)          # [N, R]
    w = torch.where(requested, w_res, 0.0)                           # [R]
    wsum = torch.clamp(_fsum([w[r] for r in range(w.shape[0])]), min=1e-9)
    num = _fsum([per_res[:, r] * w[r] for r in range(w.shape[0])])
    return num / wsum


def least_requested_score(req: torch.Tensor, used: torch.Tensor,
                          alloc: torch.Tensor) -> torch.Tensor:
    """(capacity - requested) * 100 / capacity over cpu and memory, averaged."""
    a = alloc[:, 0:2]
    u = used[:, 0:2] + req[None, 0:2]
    frac = torch.where(a > 0, torch.clamp(a - u, min=0.0)
                       / torch.clamp(a, min=1e-9), 0.0) * 100.0
    return (frac[:, 0] + frac[:, 1]) / 2.0


def most_requested_score(req: torch.Tensor, used: torch.Tensor,
                         alloc: torch.Tensor) -> torch.Tensor:
    """requested * 100 / capacity over cpu and memory, averaged."""
    a = alloc[:, 0:2]
    u = used[:, 0:2] + req[None, 0:2]
    frac = torch.where(a > 0, torch.minimum(torch.clamp(u, min=0.0), a)
                       / torch.clamp(a, min=1e-9), 0.0) * 100.0
    return (frac[:, 0] + frac[:, 1]) / 2.0


def balanced_allocation_score(req: torch.Tensor, used: torch.Tensor,
                              alloc: torch.Tensor) -> torch.Tensor:
    """100 - |cpu_fraction - mem_fraction| * 100."""
    a = alloc[:, 0:2]
    u = used[:, 0:2] + req[None, 0:2]
    frac = torch.where(a > 0, u / torch.clamp(a, min=1e-9), 0.0)
    return 100.0 - torch.abs(frac[:, 0] - frac[:, 1]) * 100.0


def node_score(req: torch.Tensor, idle: torch.Tensor, alloc: torch.Tensor,
               weights: ScoreWeights,
               static_bonus: torch.Tensor) -> torch.Tensor:
    """Combined per-node score for one task against the current node state.

    used = alloc - idle (the schedulable-accounting invariant), so the loop
    carries only idle. req [R], idle [N,R], alloc [N,R],
    static_bonus [N] -> [N]."""
    used = alloc - idle
    s = weights.binpack * binpack_score(req, used, alloc, weights.binpack_res)
    s = s + weights.least * least_requested_score(req, used, alloc)
    s = s + weights.most * most_requested_score(req, used, alloc)
    s = s + weights.balanced * balanced_allocation_score(req, used, alloc)
    return s + static_bonus


# -- the host (numpy) form -----------------------------------------------------


def _host_binpack(req, used, alloc, w_res):
    requested = (req > 0) & (w_res > 0)
    frac = np.where(alloc > 0, (used + req[None, :]) / np.maximum(alloc, 1e-9),
                    2.0)
    per_res = np.where(frac <= 1.0, frac * 100.0, 0.0)
    w = np.where(requested, w_res, 0.0)[None, :]
    wsum = np.maximum(np.sum(np.where(requested, w_res, 0.0)), 1e-9)
    return np.sum(per_res * w, axis=-1) / wsum


def _host_least(req, used, alloc):
    a = alloc[:, 0:2]
    u = used[:, 0:2] + req[None, 0:2]
    frac = np.where(a > 0, np.clip((a - u), 0.0, None) / np.maximum(a, 1e-9),
                    0.0)
    return np.mean(frac * 100.0, axis=-1)


def _host_most(req, used, alloc):
    a = alloc[:, 0:2]
    u = used[:, 0:2] + req[None, 0:2]
    frac = np.where(a > 0, np.clip(u, 0.0, a) / np.maximum(a, 1e-9), 0.0)
    return np.mean(frac * 100.0, axis=-1)


def _host_balanced(req, used, alloc):
    a = alloc[:, 0:2]
    u = used[:, 0:2] + req[None, 0:2]
    frac = np.where(a > 0, u / np.maximum(a, 1e-9), 0.0)
    return 100.0 - np.abs(frac[:, 0] - frac[:, 1]) * 100.0


def host_node_score(req: np.ndarray, idle: np.ndarray, alloc: np.ndarray,
                    weights: ScoreWeights,
                    static_bonus: np.ndarray) -> np.ndarray:
    """:func:`node_score` on numpy arrays, with ``weights`` from
    :meth:`ScoreWeights.host`. req [R], idle [N,R], alloc [N,R],
    static_bonus [N] -> [N]."""
    used = alloc - idle
    s = weights.binpack * _host_binpack(req, used, alloc,
                                        weights.binpack_res)
    s = s + weights.least * _host_least(req, used, alloc)
    s = s + weights.most * _host_most(req, used, alloc)
    s = s + weights.balanced * _host_balanced(req, used, alloc)
    return s + static_bonus
