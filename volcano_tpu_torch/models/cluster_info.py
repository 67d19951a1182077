"""ClusterInfo: the per-cycle snapshot bundle (counterpart of
volcano_tpu/models/cluster_info.py; reference: pkg/scheduler/api/
cluster_info.go)."""

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
        # the incremental steady-state cycle (docs/design/
        # incremental_cycle.md), filled only by the cache's persistent
        # snapshot. incr_mode: None (the full rebuild of every cycle),
        # "full" (a rebuild of the persistent snapshot) or "incremental"
        # (patched in place); patched_* name exactly the entities
        # re-cloned this cycle (what the session and the solver must
        # treat as changed). The rollups below are kept per patch, so
        # open_session reads them instead of walking every job and node.
        self.incr_mode = None
        self.incr_seq: int = 0
        self.patched_jobs = None        # set[str] | None
        self.patched_nodes = None       # set[str] | None
        self.quiet: bool = False        # nothing changed, nothing pending
        self.rindex = None              # models.arrays.ResourceIndex
        self.total_resource = None      # Resource: sum of node allocatable
        self.pg_fprints = None          # {job uid: status_fingerprint}
        self.pending_task_jobs = None   # uids of jobs with Pending tasks
        self.pending_phase_jobs = None  # uids of Pending-phase PodGroups

    def __repr__(self):
        return (f"ClusterInfo(jobs={len(self.jobs)}, nodes={len(self.nodes)}, "
                f"queues={len(self.queues)})")
