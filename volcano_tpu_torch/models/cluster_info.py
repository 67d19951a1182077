"""ClusterInfo: the per-cycle snapshot bundle (counterpart of
volcano_tpu/models/cluster_info.py; reference: pkg/scheduler/api/
cluster_info.go). Only the full-rebuild snapshot is ported, so none of the
incremental-snapshot fields are here."""

from __future__ import annotations

from typing import Dict, List

from .job_info import JobInfo
from .node_info import NodeInfo
from .queue_info import NamespaceInfo, QueueInfo


class ClusterInfo:
    def __init__(self):
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.namespaces: Dict[str, NamespaceInfo] = {}
        self.revocable_nodes: Dict[str, NodeInfo] = {}
        self.node_list: List[str] = []

    def __repr__(self):
        return (f"ClusterInfo(jobs={len(self.jobs)}, nodes={len(self.nodes)}, "
                f"queues={len(self.queues)})")
