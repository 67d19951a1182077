"""Topology-manager policies for the numaaware plugin (the port's own
copy of volcano_tpu/plugins/numaaware/policy.py; reference:
pkg/scheduler/plugins/numaaware/policy/{policy,factory,policy_none,
policy_best_effort,policy_restricted,policy_single_numa_node}.go).

NUMA affinities are integer bitmasks (bit i = NUMA node i). A TopologyHint
is (affinity mask | None, preferred); merging takes the bitwise-AND over one
hint per provider-resource and keeps the narrowest preferred result.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

CPU_MANAGER_POLICY = "CPUManagerPolicy"        # nodeinfo CRD policy keys
TOPOLOGY_MANAGER_POLICY = "TopologyManagerPolicy"

POLICY_NONE = "none"
POLICY_BEST_EFFORT = "best-effort"
POLICY_RESTRICTED = "restricted"
POLICY_SINGLE_NUMA_NODE = "single-numa-node"


def mask_of(bits: Sequence[int]) -> int:
    mask = 0
    for b in bits:
        mask |= 1 << b
    return mask


def mask_bits(mask: int) -> List[int]:
    out, i = [], 0
    while mask >> i:
        if (mask >> i) & 1:
            out.append(i)
        i += 1
    return out


def mask_count(mask: int) -> int:
    return bin(mask).count("1")


def is_narrower(a: int, b: int) -> bool:
    """kubelet bitmask.IsNarrowerThan: fewer bits wins; ties by lower value."""
    ca, cb = mask_count(a), mask_count(b)
    if ca != cb:
        return ca < cb
    return a < b


@dataclass(frozen=True)
class TopologyHint:
    """policy.go:28-35 — affinity None means 'any NUMA placement'."""
    affinity: Optional[int]
    preferred: bool


def filter_providers_hints(
        providers_hints: List[Dict[str, List[TopologyHint]]]
) -> List[List[TopologyHint]]:
    """policy.go:24-52 — one hint list per provider-resource; providers with
    no opinion contribute a single preferred any-NUMA hint, providers with an
    empty list contribute a non-preferred any-NUMA hint."""
    all_hints: List[List[TopologyHint]] = []
    for hints in providers_hints:
        if not hints:
            all_hints.append([TopologyHint(None, True)])
            continue
        for resource, res_hints in hints.items():
            if res_hints is None:
                all_hints.append([TopologyHint(None, True)])
            elif len(res_hints) == 0:
                all_hints.append([TopologyHint(None, False)])
            else:
                all_hints.append(res_hints)
    return all_hints


def merge_permutation(default_affinity: int,
                      permutation: Sequence[TopologyHint]) -> TopologyHint:
    """policy.go:141-166 — AND of affinities; preferred iff all preferred."""
    preferred = True
    merged = default_affinity
    for hint in permutation:
        merged &= default_affinity if hint.affinity is None else hint.affinity
        if not hint.preferred:
            preferred = False
    return TopologyHint(merged, preferred)


def merge_filtered_hints(numa_nodes: Sequence[int],
                         filtered: List[List[TopologyHint]]) -> TopologyHint:
    """policy.go:54-100 — best merged hint over the hint cross-product."""
    default_affinity = mask_of(numa_nodes)
    best = TopologyHint(default_affinity, False)
    for permutation in itertools.product(*filtered):
        merged = merge_permutation(default_affinity, permutation)
        if mask_count(merged.affinity) == 0:
            continue
        if merged.preferred and not best.preferred:
            best = merged
            continue
        if not merged.preferred and best.preferred:
            continue
        if not is_narrower(merged.affinity, best.affinity):
            continue
        best = merged
    return best


class Policy:
    def predicate(self, providers_hints) -> tuple:
        """-> (best_hint, admit)"""
        raise NotImplementedError


class PolicyNone(Policy):
    """policy_none.go — everything admitted, no affinity."""

    def __init__(self, numa_nodes: Sequence[int] = ()):
        self.numa_nodes = list(numa_nodes)

    def predicate(self, providers_hints):
        return TopologyHint(None, True), True


class PolicyBestEffort(Policy):
    """policy_best_effort.go — merge, always admit."""

    def __init__(self, numa_nodes: Sequence[int]):
        self.numa_nodes = list(numa_nodes)

    def predicate(self, providers_hints):
        filtered = filter_providers_hints(providers_hints)
        best = merge_filtered_hints(self.numa_nodes, filtered)
        return best, True


class PolicyRestricted(Policy):
    """policy_restricted.go — admit only preferred placements."""

    def __init__(self, numa_nodes: Sequence[int]):
        self.numa_nodes = list(numa_nodes)

    def predicate(self, providers_hints):
        filtered = filter_providers_hints(providers_hints)
        best = merge_filtered_hints(self.numa_nodes, filtered)
        return best, best.preferred


class PolicySingleNumaNode(Policy):
    """policy_single_numa_node.go — only single-node preferred hints."""

    def __init__(self, numa_nodes: Sequence[int]):
        self.numa_nodes = list(numa_nodes)

    @staticmethod
    def _filter_single_numa(filtered: List[List[TopologyHint]]):
        out = []
        for res_hints in filtered:
            kept = [h for h in res_hints
                    if h.preferred and
                    (h.affinity is None or mask_count(h.affinity) == 1)]
            out.append(kept)
        return out

    def predicate(self, providers_hints):
        filtered = filter_providers_hints(providers_hints)
        single = self._filter_single_numa(filtered)
        best = merge_filtered_hints(self.numa_nodes, single)
        return best, best.preferred


def get_policy(node, numa_nodes: Sequence[int]) -> Policy:
    """factory.go:54-68 — policy from the node's topology-manager policy."""
    name = ""
    if node.numa_scheduler_info is not None:
        name = node.numa_scheduler_info.policies.get(TOPOLOGY_MANAGER_POLICY, "")
    return {
        POLICY_NONE: PolicyNone,
        POLICY_BEST_EFFORT: PolicyBestEffort,
        POLICY_RESTRICTED: PolicyRestricted,
        POLICY_SINGLE_NUMA_NODE: PolicySingleNumaNode,
    }.get(name, PolicyNone)(numa_nodes)


def accumulate_providers_hints(container, topo_info, res_numa_sets,
                               hint_providers):
    """factory.go:70-80"""
    return [p.get_topology_hints(container, topo_info, res_numa_sets)
            for p in hint_providers]


def allocate(container, best_hint, topo_info, res_numa_sets, hint_providers):
    """factory.go:82-94 — union of every provider's assignment."""
    all_alloc: Dict[str, set] = {}
    for provider in hint_providers:
        for res, assign in provider.allocate(
                container, best_hint, topo_info, res_numa_sets).items():
            all_alloc[res] = assign
    return all_alloc
