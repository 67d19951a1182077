"""CPU-manager hint provider: replicates the kubelet static CPU manager's
topology-aware allocation (the port's own copy of
volcano_tpu/plugins/numaaware/cpumanager.py; reference:
pkg/scheduler/plugins/numaaware/provider/cpumanager/
{cpu_mng,cpu_assignment}.go).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Set

from ...models.resource import CPU, milli_value
from .policy import TopologyHint, mask_bits, mask_count, mask_of


class CPUDetails:
    """Topology lookups over {cpu_id: CpuInfo} (kubelet topology.CPUDetails)."""

    def __init__(self, detail: Dict[int, object]):
        self.detail = detail

    def cpus(self) -> Set[int]:
        return set(self.detail.keys())

    def sockets(self) -> List[int]:
        return sorted({c.socket_id for c in self.detail.values()})

    def cores(self) -> List[tuple]:
        return sorted({(c.socket_id, c.core_id) for c in self.detail.values()})

    def numa_nodes(self) -> List[int]:
        return sorted({c.numa_id for c in self.detail.values()})

    def cpus_in_socket(self, socket_id: int) -> Set[int]:
        return {i for i, c in self.detail.items() if c.socket_id == socket_id}

    def cpus_in_core(self, socket_id: int, core_id: int) -> Set[int]:
        return {i for i, c in self.detail.items()
                if c.socket_id == socket_id and c.core_id == core_id}

    def cpus_in_numa_nodes(self, numa_ids: Sequence[int]) -> Set[int]:
        ids = set(numa_ids)
        return {i for i, c in self.detail.items() if c.numa_id in ids}

    def numa_of(self, cpu_id: int) -> int:
        return self.detail[cpu_id].numa_id


def take_by_topology(details: CPUDetails, available: Set[int],
                     count: int) -> Set[int]:
    """cpu_assignment.go takeByTopology: whole sockets, then whole cores,
    then single CPUs packing partially-used cores first.

    Raises ValueError when not enough CPUs are available."""
    if count > len(available):
        raise ValueError(
            f"not enough cpus available to satisfy request: want {count}, "
            f"have {len(available)}")
    if count <= 0:
        return set()
    taken: Set[int] = set()
    remaining = count

    # 1. whole sockets that are fully free and fit
    for socket_id in details.sockets():
        cpus = details.cpus_in_socket(socket_id)
        if cpus and cpus <= available - taken and len(cpus) <= remaining:
            taken |= cpus
            remaining -= len(cpus)
            if remaining == 0:
                return taken

    # 2. whole cores that are fully free and fit
    for socket_id, core_id in details.cores():
        cpus = details.cpus_in_core(socket_id, core_id)
        free = cpus & (available - taken)
        if free == cpus and cpus and len(cpus) <= remaining:
            taken |= cpus
            remaining -= len(cpus)
            if remaining == 0:
                return taken

    # 3. single CPUs: prefer cores with the fewest free CPUs (pack partial
    # cores), then lowest id — the kubelet's free-CPU sort order
    free_left = sorted(
        available - taken,
        key=lambda i: (len(details.cpus_in_core(
            details.detail[i].socket_id, details.detail[i].core_id)
            & (available - taken)), i))
    taken |= set(free_left[:remaining])
    return taken


def guaranteed_cpus(container) -> int:
    """cpu_mng.go:46-53 — integral CPU request, else 0 (no exclusive set)."""
    if CPU not in container.requests:
        return 0
    milli = milli_value(container.requests[CPU])
    if milli <= 0 or milli % 1000 != 0:
        return 0
    return int(milli // 1000)


def generate_cpu_topology_hints(available: Set[int], details: CPUDetails,
                                request: int) -> List[TopologyHint]:
    """cpu_mng.go:57-104 — one hint per NUMA mask that can satisfy the
    request from available CPUs; preferred iff the mask is minimal in size
    among masks whose total capacity fits the request."""
    numa_nodes = details.numa_nodes()
    min_affinity_size = len(numa_nodes)
    hints: List[TopologyHint] = []
    for size in range(1, len(numa_nodes) + 1):
        for combo in itertools.combinations(numa_nodes, size):
            mask = mask_of(combo)
            in_mask = details.cpus_in_numa_nodes(combo)
            if len(in_mask) >= request and size < min_affinity_size:
                min_affinity_size = size
            if len(available & in_mask) < request:
                continue
            hints.append(TopologyHint(mask, False))
    return [TopologyHint(h.affinity,
                         mask_count(h.affinity) == min_affinity_size)
            for h in hints]


class CpuManager:
    """The cpuMng hint provider (cpu_mng.go)."""

    def name(self) -> str:
        return "cpuMng"

    def _reserved(self, details: CPUDetails, topo_info) -> Set[int]:
        reserved_milli = topo_info.res_reserved.get(CPU, 0)
        if not reserved_milli:
            return set()
        num_reserved = int(math.ceil(float(reserved_milli) / 1000.0))
        try:
            return take_by_topology(details, details.cpus(), num_reserved)
        except ValueError:
            return set()

    def get_topology_hints(self, container, topo_info,
                           res_numa_sets) -> Optional[Dict[str, List[TopologyHint]]]:
        """cpu_mng.go:106-147"""
        request = guaranteed_cpus(container)
        if request == 0:
            return None
        details = CPUDetails(topo_info.cpu_detail)
        available = set(res_numa_sets.get(CPU, set()))
        available -= self._reserved(details, topo_info)
        return {CPU: generate_cpu_topology_hints(available, details, request)}

    def allocate(self, container, best_hint, topo_info,
                 res_numa_sets) -> Dict[str, Set[int]]:
        """cpu_mng.go:149-210 — aligned CPUs from the hint's NUMA nodes
        first, topping up from the remainder."""
        request = guaranteed_cpus(container)
        if request == 0:
            return {}
        details = CPUDetails(topo_info.cpu_detail)
        available = set(res_numa_sets.get(CPU, set()))
        available -= self._reserved(details, topo_info)

        result: Set[int] = set()
        if best_hint.affinity is not None:
            aligned = available & details.cpus_in_numa_nodes(
                mask_bits(best_hint.affinity))
            num_aligned = min(request, len(aligned))
            try:
                result |= take_by_topology(details, aligned, num_aligned)
            except ValueError:
                return {CPU: set()}
        try:
            result |= take_by_topology(details, available - result,
                                       request - len(result))
        except ValueError:
            return {CPU: set()}
        return {CPU: result}
