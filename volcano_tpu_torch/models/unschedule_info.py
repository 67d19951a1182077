"""Fit errors: per task x node failure reasons, aggregated for PodGroup
conditions (reference: pkg/scheduler/api/unschedule_info.go)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

ALL_NODE_UNAVAILABLE = "all nodes are unavailable"

# Canonical predicate failure reasons (mirroring upstream k8s strings where
# the reference reuses them).
NODE_POD_NUMBER_EXCEEDED = "node(s) pod number exceeded"
NODE_RESOURCE_FIT_FAILED = "node(s) resource fit failed"
NODE_UNSCHEDULABLE = "node(s) were unschedulable"
NODE_AFFINITY_FAILED = "node(s) didn't match Pod's node affinity"
NODE_SELECTOR_FAILED = "node(s) didn't match Pod's node selector"
TAINT_FAILED = "node(s) had taints that the pod didn't tolerate"
NODE_PORT_FAILED = "node(s) didn't have free ports for the requested pod ports"
POD_AFFINITY_FAILED = "node(s) didn't match pod affinity/anti-affinity rules"


class FitError:
    """One task's failure on one node."""

    def __init__(self, task=None, node=None, reasons: Optional[List[str]] = None,
                 task_namespace: str = "", task_name: str = "", node_name: str = ""):
        if task is not None:
            task_namespace, task_name = task.namespace, task.name
        if node is not None:
            node_name = node.name
        self.task_namespace = task_namespace
        self.task_name = task_name
        self.node_name = node_name
        self.reasons: List[str] = list(reasons or [])

    def error(self) -> str:
        return (f"task {self.task_namespace}/{self.task_name} on node "
                f"{self.node_name} fit failed: {', '.join(self.reasons)}")

    def __repr__(self):
        return self.error()


class FitErrors:
    """All nodes' failures for one task (unschedule_info.go)."""

    def __init__(self):
        self.nodes: Dict[str, FitError] = {}
        self.err: str = ""

    def set_error(self, err: str) -> None:
        self.err = err

    def set_node_error(self, node_name: str, fit_error: FitError) -> None:
        fit_error.node_name = node_name
        self.nodes[node_name] = fit_error

    def error(self) -> str:
        if self.err:
            return self.err
        if not self.nodes:
            return ALL_NODE_UNAVAILABLE
        # histogram of reasons, like the reference's sortReasonsHistogram
        reasons: Dict[str, int] = defaultdict(int)
        for fe in self.nodes.values():
            for r in fe.reasons:
                reasons[r] += 1
        parts = sorted(f"{cnt} {reason}" for reason, cnt in reasons.items())
        return f"0/{len(self.nodes)} nodes are unavailable: {', '.join(parts)}."
