"""Simulated NUMA node agent (the port's own copy of
volcano_tpu/utils/numa_agent.py).

The reference's Numatopology CRDs are written by a per-node agent that
introspects the kubelet's CPU/topology managers (SURVEY.md section 2.9,
nodeinfo/v1alpha1.Numatopology); the scheduler only consumes them. This
agent plays that role for simulated nodes: given a hardware shape it
publishes the Numatopology object for each node (``build_numatopology``),
and ``NumaAgent`` watches the nodes of a store so that nodes added later
get topology too, so numaaware scheduling works end to end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..models.objects import CpuInfo, Numatopology, NumaResInfo, ObjectMeta


@dataclass
class NumaShape:
    """Hardware shape of a simulated node."""
    numa_count: int = 2
    cores_per_numa: int = 8
    threads_per_core: int = 2
    cpu_manager_policy: str = "static"
    topology_manager_policy: str = "best-effort"
    reserved_cpu_milli: float = 0.0

    @property
    def cpus_per_numa(self) -> int:
        return self.cores_per_numa * self.threads_per_core


# the NUMA shape of utils/synth.py:populate_store's plugin shares: two
# NUMA nodes of 16 cores of 2 threads (64 CPUs, as the synthetic node's
# 64 cores), the static CPU manager and the single-numa-node topology
# manager
SHARES_NUMA = NumaShape(numa_count=2, cores_per_numa=16, threads_per_core=2,
                        topology_manager_policy="single-numa-node")


def build_numatopology(node_name: str, shape: NumaShape) -> Numatopology:
    """Numatopology object for one node (numatopo_types.go:50-94 shape)."""
    detail: Dict[int, CpuInfo] = {}
    cpu_id = 0
    for numa in range(shape.numa_count):
        for core in range(shape.cores_per_numa):
            for _ in range(shape.threads_per_core):
                detail[cpu_id] = CpuInfo(numa_id=numa, socket_id=numa,
                                         core_id=core)
                cpu_id += 1
    nt = Numatopology(
        metadata=ObjectMeta(name=node_name),
        policies={"CPUManagerPolicy": shape.cpu_manager_policy,
                  "TopologyManagerPolicy": shape.topology_manager_policy},
        numa_res={"cpu": NumaResInfo(allocatable=sorted(detail.keys()),
                                     capacity=len(detail))},
        cpu_detail=detail)
    if shape.reserved_cpu_milli:
        nt.res_reserved["cpu"] = shape.reserved_cpu_milli
    return nt


class NumaAgent:
    """Publishes Numatopology for every node matching a shape map; watches
    nodes so late-added nodes get topology too."""

    def __init__(self, store, default_shape: Optional[NumaShape] = None,
                 shapes: Optional[Dict[str, NumaShape]] = None):
        self.store = store
        self.default_shape = default_shape
        self.shapes = shapes or {}
        self._watches = [store.watch("nodes", self._on_node,
                                     lambda o, n: self._on_node(n), None)]

    def stop(self) -> None:
        for w in self._watches:
            self.store.unwatch(w)
        self._watches = []

    def _shape_for(self, node_name: str) -> Optional[NumaShape]:
        return self.shapes.get(node_name, self.default_shape)

    def _on_node(self, node) -> None:
        shape = self._shape_for(node.metadata.name)
        if shape is None:
            return
        if self.store.get("numatopologies", node.metadata.name) is None:
            self.store.create("numatopologies",
                              build_numatopology(node.metadata.name, shape),
                              skip_admission=True)
