"""PodGroup controller: auto-creates a 1-member PodGroup for bare pods so
vanilla pods still gang-schedule
(reference: pkg/controllers/podgroup/{pg_controller,pg_controller_handler}.go).

The port's own copy of volcano_tpu/controllers/podgroup.py.
"""

from __future__ import annotations

from collections import deque
from typing import Set

from ..apiserver.store import ConflictError
from ..models import objects as obj
from ..models.objects import ObjectMeta, Pod, PodGroup
from .framework import Controller

PODGROUP_NAME_PREFIX = "podgroup-"


def generate_podgroup_name(pod: Pod) -> str:
    """vendor/.../apis/helpers/helpers.go:178-192 — owner UID when controlled,
    else the pod's own UID."""
    if pod.metadata.owner:
        return PODGROUP_NAME_PREFIX + pod.metadata.owner.replace("/", "-")
    return PODGROUP_NAME_PREFIX + pod.metadata.uid


class PodGroupController(Controller):
    NAME = "pg-controller"

    def __init__(self, scheduler_name: str = obj.DEFAULT_SCHEDULER_NAME):
        self.scheduler_name = scheduler_name
        self.store = None
        self.work: deque = deque()
        self._pending: Set[str] = set()
        self._watches: list = []

    def initialize(self, store) -> None:
        self.store = store
        self._watches = [store.watch("pods", self._add_pod, None, None,
                                     filter_fn=self._bare_pod)]

    def stop(self) -> None:
        for w in self._watches:
            self.store.unwatch(w)
        self._watches = []

    def _bare_pod(self, pod: Pod) -> bool:
        """Pods for this scheduler without a PodGroup link
        (pg_controller_handler.go:36-52)."""
        return (pod.spec.scheduler_name == self.scheduler_name and
                obj.GROUP_NAME_ANNOTATION not in pod.metadata.annotations)

    def _add_pod(self, pod: Pod) -> None:
        key = pod.metadata.key()
        if key not in self._pending:
            self._pending.add(key)
            self.work.append(key)

    def process_pending(self, max_items: int = 10000) -> int:
        processed = 0
        n = len(self.work)
        for _ in range(min(n, max_items)):
            key = self.work.popleft()
            self._pending.discard(key)
            ns, name = key.split("/", 1)
            pod = self.store.get("pods", name, ns)
            if pod is None or obj.GROUP_NAME_ANNOTATION in pod.metadata.annotations:
                continue
            try:
                self._create_normal_pod_pg_if_not_exist(pod)
            except (ConflictError, KeyError):
                # pod updated or deleted between get and update; requeue so
                # the retry sees the fresh object
                if key not in self._pending:
                    self._pending.add(key)
                    self.work.append(key)
            processed += 1
        return processed

    def _create_normal_pod_pg_if_not_exist(self, pod: Pod) -> None:
        """pg_controller_handler.go:74-120"""
        pg_name = generate_podgroup_name(pod)
        if self.store.get("podgroups", pg_name, pod.metadata.namespace) is None:
            pg = PodGroup(metadata=ObjectMeta(
                name=pg_name, namespace=pod.metadata.namespace,
                owner=pod.metadata.owner or f"Pod/{pod.metadata.key()}"))
            pg.spec.min_member = 1
            pg.spec.priority_class_name = pod.spec.priority_class_name
            if obj.QUEUE_NAME_KEY in pod.metadata.annotations:
                pg.spec.queue = pod.metadata.annotations[obj.QUEUE_NAME_KEY]
            for key in (obj.PREEMPTABLE_KEY, obj.REVOCABLE_ZONE_KEY,
                        obj.JDB_MIN_AVAILABLE_KEY, obj.JDB_MAX_UNAVAILABLE_KEY):
                if key in pod.metadata.annotations:
                    pg.metadata.annotations[key] = pod.metadata.annotations[key]
            if obj.PREEMPTABLE_KEY in pod.metadata.labels:
                pg.metadata.labels[obj.PREEMPTABLE_KEY] = \
                    pod.metadata.labels[obj.PREEMPTABLE_KEY]
            self.store.create("podgroups", pg)
        pod.metadata.annotations[obj.GROUP_NAME_ANNOTATION] = pg_name
        self.store.update("pods", pod, skip_admission=True)
