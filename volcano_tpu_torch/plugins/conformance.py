"""conformance plugin (the port's own copy of
volcano_tpu/plugins/conformance.py; reference: pkg/scheduler/plugins/
conformance/conformance.go).

Shields cluster-critical pods from preemption and reclamation: tasks in the
kube-system namespace or carrying the system-cluster-critical /
system-node-critical priority classes are filtered out of every victim set
(conformance.go:45-66).
"""

from __future__ import annotations

from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from ..framework.session import PERMIT

NAME = "conformance"

SYSTEM_NAMESPACE = "kube-system"
SYSTEM_CLUSTER_CRITICAL = "system-cluster-critical"
SYSTEM_NODE_CRITICAL = "system-node-critical"


def is_critical(task) -> bool:
    """Whether conformance shields ``task`` from eviction."""
    return (task.pod.spec.priority_class_name in (SYSTEM_CLUSTER_CRITICAL,
                                                  SYSTEM_NODE_CRITICAL)
            or task.namespace == SYSTEM_NAMESPACE)


class ConformancePlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn) -> None:
        def evictable_fn(evictor, evictees):
            return [t for t in evictees if not is_critical(t)], PERMIT

        ssn.add_preemptable_fn(NAME, evictable_fn)
        ssn.add_reclaimable_fn(NAME, evictable_fn)

    def on_session_close(self, ssn) -> None:
        pass


register_plugin_builder(NAME, ConformancePlugin)
