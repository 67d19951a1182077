"""Numatopology fixtures (the port's own copy of what the scheduler's
tests and chip_smoke.py need of volcano_tpu/utils/numa_agent.py).

The reference's Numatopology CRDs are written by a per-node agent that
introspects the kubelet's CPU/topology managers (SURVEY.md section 2.9,
nodeinfo/v1alpha1.Numatopology); the scheduler only consumes them. This
module builds that object for a simulated node of a given hardware shape,
with the static CPU manager. The reference's node-watching ``NumaAgent``
waits for the simulator's port (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from ..models.objects import CpuInfo, Numatopology, NumaResInfo, ObjectMeta


@dataclass
class NumaShape:
    """Hardware shape of a simulated node (static CPU manager)."""
    numa_count: int = 2
    cores_per_numa: int = 8
    threads_per_core: int = 2
    topology_manager_policy: str = "best-effort"

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
    return Numatopology(
        metadata=ObjectMeta(name=node_name),
        policies={"CPUManagerPolicy": "static",
                  "TopologyManagerPolicy": shape.topology_manager_policy},
        numa_res={"cpu": NumaResInfo(allocatable=sorted(detail.keys()),
                                     capacity=len(detail))},
        cpu_detail=detail)
