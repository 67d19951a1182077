"""Test fakes and builders (the port's own copy of
volcano_tpu/utils/test_utils.py; reference: pkg/scheduler/util/test_utils.go).

FakeBinder and FakeEvictor record binds and evictions for assertions;
build_pod/build_node/
build_resource_list construct objects tersely. Used by
the action/plugin test harnesses and usable by downstream users for their
own scheduler tests.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..models import objects as obj
from ..models.objects import (Container, Node, NodeStatus, ObjectMeta, Pod,
                              PodGroup, PodGroupSpec, PodSpec, PodStatus,
                              Queue, QueueSpec)


class FakeBinder:
    """Records binds as "ns/name": hostname (test_utils.go:96-117)."""

    def __init__(self, store=None):
        self.binds: Dict[str, str] = {}
        self.channel: List[str] = []
        self.store = store

    def bind(self, pod: Pod, hostname: str) -> None:
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        if self.store is not None:
            live = self.store.get("pods", pod.metadata.name, pod.metadata.namespace)
            if live is not None:
                live.spec.node_name = hostname
                self.store.update("pods", live)
        # record AFTER the store write: a failed write must not appear in
        # the bind channel
        self.binds[key] = hostname
        self.channel.append(key)

    def bind_batch(self, items) -> list:
        """Batched form sharing StoreBinder's engine
        (:func:`..cache.interface.bind_pods_batch`): records the binds,
        returns the pairs that did not bind. Subclasses overriding
        :meth:`bind` (e.g. failure injection) get per-pod calls through
        their override, which record for themselves."""
        from ..cache.interface import bind_pods_batch
        failed, used_batch = bind_pods_batch(
            self.store, items, self.bind,
            type(self).bind is FakeBinder.bind)
        if used_batch:
            gone = set(map(id, (pod for pod, _ in failed)))
            for pod, hostname in items:
                if id(pod) in gone:
                    continue
                key = f"{pod.metadata.namespace}/{pod.metadata.name}"
                self.binds[key] = hostname
                self.channel.append(key)
        return failed


class FakeEvictor:
    """Records evicted pod keys (test_utils.go:119-141) and, given a
    store, deletes the pods through it."""

    def __init__(self, store=None):
        self.evicts: List[str] = []
        self.channel: List[str] = []
        self.store = store

    def evict(self, pod: Pod, reason: str) -> None:
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        self.evicts.append(key)
        self.channel.append(key)
        if self.store is not None:
            self.store.delete("pods", pod.metadata.name,
                              pod.metadata.namespace)


def build_resource_list(cpu: str, memory: str, pods: str = "100",
                        **scalars) -> Dict[str, str]:
    rl = {"cpu": cpu, "memory": memory, "pods": pods}
    rl.update(scalars)
    return rl


def build_pod(namespace: str, name: str, nodename: str, phase: str,
              req: Dict[str, str], groupname: str = "",
              labels: Optional[Dict[str, str]] = None,
              selector: Optional[Dict[str, str]] = None,
              priority: Optional[int] = None,
              preemptable: Optional[bool] = None,
              task_name: str = "") -> Pod:
    """Analogue of util.BuildPod (test_utils.go:38-63)."""
    annotations = {}
    if groupname:
        annotations[obj.GROUP_NAME_ANNOTATION] = groupname
    if preemptable is not None:
        annotations[obj.PREEMPTABLE_KEY] = str(preemptable).lower()
    if task_name:
        annotations[obj.TASK_SPEC_KEY] = task_name
    return Pod(
        metadata=ObjectMeta(name=name, namespace=namespace,
                            uid=f"{namespace}-{name}", labels=labels or {},
                            annotations=annotations),
        spec=PodSpec(containers=[Container(requests=req)], node_name=nodename,
                     node_selector=selector or {}, priority=priority),
        status=PodStatus(phase=phase),
    )


def build_node(name: str, alloc: Dict[str, str],
               labels: Optional[Dict[str, str]] = None,
               annotations: Optional[Dict[str, str]] = None) -> Node:
    return Node(
        metadata=ObjectMeta(name=name, labels=labels or {},
                            annotations=annotations or {}),
        status=NodeStatus(allocatable=alloc, capacity=dict(alloc)),
    )


def build_pod_group(name: str, namespace: str, queue: str, min_member: int,
                    min_task_member: Optional[Dict[str, int]] = None,
                    phase: str = "Pending",
                    priority_class: str = "") -> PodGroup:
    pg = PodGroup(
        metadata=ObjectMeta(name=name, namespace=namespace),
        spec=PodGroupSpec(min_member=min_member,
                          min_task_member=min_task_member or {},
                          queue=queue, priority_class_name=priority_class),
    )
    pg.status.phase = phase
    return pg


def build_queue(name: str, weight: int = 1, capability=None,
                reclaimable: bool = True) -> Queue:
    return Queue(metadata=ObjectMeta(name=name),
                 spec=QueueSpec(weight=weight, capability=capability,
                                reclaimable=reclaimable))
