"""Predicates: every group x node feasibility decision in one shot
(counterpart of volcano_tpu/ops/fit.py).

String matching was encoded into feature matrices when the snapshot was
built; here it is matmul and broadcast compares over the whole
group x node matrix. The matmuls go to ``torch.matmul`` in float32 (the
JAX package leaves them to XLA outside any kernel). Their inputs are 0/1
features, which TF32 also holds exactly, and the counts they sum stay
exact in the float32 accumulator.
"""

from __future__ import annotations

import torch


def resource_le(req: torch.Tensor, avail: torch.Tensor,
                eps: torch.Tensor) -> torch.Tensor:
    """req <= avail within per-dimension epsilon, all dims.
    req [..., R], avail [..., R] -> [...] bool (padded dims are 0 <= avail)."""
    return torch.all(req <= avail + eps, dim=-1)


def group_fit_mask(group_req: torch.Tensor, node_avail: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """[G,R] x [N,R] -> [G,N] resource-fit mask."""
    return torch.all(group_req[:, None, :]
                     <= node_avail[None, :, :] + eps[None, None, :], dim=-1)


def selector_mask(node_pairs: torch.Tensor, group_requires: torch.Tensor,
                  group_require_counts: torch.Tensor) -> torch.Tensor:
    """Conjunctive label-pair matching as a matmul.
    node_pairs [N,F], group_requires [G,F] -> [G,N] bool: the node carries
    all of the group's required pairs."""
    got = group_requires @ node_pairs.T   # [G, N] matched pairs
    return got >= group_require_counts[:, None] - 0.5


def taint_mask(node_taints: torch.Tensor,
               group_tolerates: torch.Tensor) -> torch.Tensor:
    """[N,K] x [G,K] -> [G,N] bool: no untolerated NoSchedule/NoExecute
    taint on the node."""
    violations = (1.0 - group_tolerates) @ node_taints.T
    return violations < 0.5


def pod_count_mask(n_tasks: torch.Tensor,
                   max_tasks: torch.Tensor) -> torch.Tensor:
    """[N] -> [N] bool: node pod-count cap; max_tasks == 0 means uncapped."""
    return (max_tasks == 0) | (n_tasks < max_tasks)


def static_predicate_mask(node_valid: torch.Tensor, fit_cap: torch.Tensor,
                          sel_ok: torch.Tensor, taints_ok: torch.Tensor,
                          affinity_ok: torch.Tensor) -> torch.Tensor:
    """AND-compose the cycle-static predicate masks into [G,N]; ``fit_cap``
    is the capability prefit (tasks that can never fit a node are
    excluded up front)."""
    return node_valid[None, :] & fit_cap & sel_ok & taints_ok & affinity_ok
