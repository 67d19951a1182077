"""QueueInfo / NamespaceInfo (reference: pkg/scheduler/api/queue_info.go,
namespace_info.go)."""

from __future__ import annotations

from typing import Dict

from . import objects
from .objects import Queue, ResourceQuota


class QueueInfo:
    """Scheduler view of one Queue (queue_info.go:29-88)."""

    def __init__(self, queue: Queue):
        self.uid: str = queue.metadata.name
        self.name: str = queue.metadata.name
        self.weight: int = max(1, queue.spec.weight)
        self.queue: Queue = queue
        # hierarchical fair-share path: "root/sci/dev" with per-level weights
        self.hierarchy: str = queue.metadata.annotations.get(
            objects.QUEUE_HIERARCHY_ANNOTATION, "")
        self.hierarchical_weights: str = queue.metadata.annotations.get(
            objects.QUEUE_HIERARCHY_WEIGHT_ANNOTATION, "")

    def clone(self) -> "QueueInfo":
        return QueueInfo(self.queue)

    def reclaimable(self) -> bool:
        return self.queue.spec.reclaimable


DEFAULT_NAMESPACE_WEIGHT = 1
NAMESPACE_WEIGHT_KEY = "namespace.weight"


class NamespaceInfo:
    """Per-namespace weight from ResourceQuota objects
    (namespace_info.go:26-145)."""

    def __init__(self, name: str, weight: int = DEFAULT_NAMESPACE_WEIGHT):
        self.name = name
        self.weight = weight

    def get_weight(self) -> int:
        return self.weight if self.weight > 0 else DEFAULT_NAMESPACE_WEIGHT


class NamespaceCollection:
    """Tracks quota objects per namespace; weight = max over quotas of the
    namespace.weight hard field (namespace_info.go:55-145)."""

    def __init__(self, name: str):
        self.name = name
        self.quota_weight: Dict[str, int] = {}

    def update(self, quota: ResourceQuota) -> None:
        w = quota.hard.get(NAMESPACE_WEIGHT_KEY)
        if w is not None:
            self.quota_weight[quota.metadata.name] = int(float(w))
        else:
            self.quota_weight.pop(quota.metadata.name, None)

    def delete(self, quota: ResourceQuota) -> None:
        self.quota_weight.pop(quota.metadata.name, None)

    def snapshot(self) -> NamespaceInfo:
        if not self.quota_weight:
            return NamespaceInfo(self.name)
        return NamespaceInfo(self.name, max(self.quota_weight.values()))
