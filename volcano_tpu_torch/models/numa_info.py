"""NUMA topology info (the port's own copy of
volcano_tpu/models/numa_info.py; reference: pkg/scheduler/api/
numa_info.go:38-185).

Per-node NUMA/CPU detail ingested from the Numatopology CRD: per-resource
allocatable sets, cpu detail (numa/socket/core ids), topology policies, and
the Allocate/Release set operations used by the numaaware plugin's event
handlers.
"""

from __future__ import annotations

from typing import Dict, Set

from .objects import CpuInfo, Numatopology


class ResourceInfo:
    def __init__(self, allocatable: Set[int] = None, capacity: int = 0):
        self.allocatable: Set[int] = set(allocatable or ())
        self.capacity = capacity

    def clone(self) -> "ResourceInfo":
        return ResourceInfo(set(self.allocatable), self.capacity)


class NumatopoInfo:
    def __init__(self, name: str = ""):
        self.name = name
        self.policies: Dict[str, str] = {}
        self.numa_res_map: Dict[str, ResourceInfo] = {}
        self.cpu_detail: Dict[int, CpuInfo] = {}
        self.res_reserved: Dict[str, float] = {}

    @classmethod
    def from_crd(cls, nt: Numatopology) -> "NumatopoInfo":
        info = cls(nt.metadata.name)
        info.policies = dict(nt.policies)
        for res, ri in nt.numa_res.items():
            info.numa_res_map[res] = ResourceInfo(set(ri.allocatable), ri.capacity)
        info.cpu_detail = dict(nt.cpu_detail)
        return info

    def clone(self) -> "NumatopoInfo":
        c = NumatopoInfo(self.name)
        c.policies = dict(self.policies)
        c.numa_res_map = {k: v.clone() for k, v in self.numa_res_map.items()}
        c.cpu_detail = dict(self.cpu_detail)
        c.res_reserved = dict(self.res_reserved)
        return c

    # ResNumaSets ops (numa_info.go:150-185): the scheduler-side view takes
    # sets out on allocate and returns them on release.
    def allocate(self, res_sets: Dict[str, Set[int]]) -> None:
        for res, taken in res_sets.items():
            ri = self.numa_res_map.get(res)
            if ri is not None:
                ri.allocatable -= set(taken)

    def release(self, res_sets: Dict[str, Set[int]]) -> None:
        for res, returned in res_sets.items():
            ri = self.numa_res_map.get(res)
            if ri is not None:
                ri.allocatable |= set(returned)
