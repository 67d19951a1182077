"""Cache event handlers: watch events -> JobInfo/NodeInfo mutation
(counterpart of volcano_tpu/cache/event_handlers.py; reference:
pkg/scheduler/cache/event_handlers.go): pod->task conversion and job/node
accounting (:47-260), node ingestion (:302-418), PodGroup/Queue ingestion
(:420-560), PriorityClass and ResourceQuota handlers. All methods assume
the cache lock is held by the caller (the watch fan-out is synchronous).

Left out with the incremental snapshot and the commit-path resilience: the
dirty-set bookkeeping, the bind-retry records and the NUMA handlers.
"""

from __future__ import annotations

from typing import Optional

from ..models import objects as obj
from ..models.arrays import _group_sig
from ..models.job_info import (JobInfo, TaskInfo, allocated_status,
                               get_job_id, get_task_status, is_terminated)
from ..models.node_info import NodeInfo
from ..models.queue_info import NamespaceCollection, QueueInfo
from ..utils.fastclone import fast_clone


class EventHandlersMixin:
    """Mixed into SchedulerCache; operates on self.jobs/self.nodes/..."""

    # -- pods -------------------------------------------------------------

    def _get_or_create_job(self, ti: TaskInfo) -> Optional[JobInfo]:
        """Tasks without a PodGroup link are not schedulable by us
        (event_handlers.go:47-58)."""
        if not ti.job:
            return None
        if ti.job not in self.jobs:
            self.jobs[ti.job] = JobInfo(ti.job, clock=self.store.clock)
        return self.jobs[ti.job]

    def _add_task(self, ti: TaskInfo) -> None:
        # the encode-group fingerprint is derived at ingest, so cycles
        # inherit it through snapshot clones
        _group_sig(ti)
        if ti.node_name:
            if ti.node_name not in self.nodes:
                raise KeyError(f"node <{ti.node_name}> does not exist")
            if not is_terminated(ti.status):
                self.nodes[ti.node_name].add_task(ti)
        job = self._get_or_create_job(ti)
        if job is not None:
            job.add_task_info(ti)

    def add_pod(self, pod: obj.Pod) -> None:
        self._add_task(TaskInfo(pod))

    def _cached_task_view(self, ti: TaskInfo) -> TaskInfo:
        """Prefer the cache's task (it knows Binding/Allocated state and the
        node it sits on) over the event's view (event_handlers.go:163-176)."""
        job = self.jobs.get(ti.job)
        if job is not None:
            cached = job.tasks.get(ti.uid)
            if cached is not None:
                return cached
        return ti

    def _delete_task(self, ti: TaskInfo) -> None:
        ti = self._cached_task_view(ti)
        job = self.jobs.get(ti.job) if ti.job else None
        if job is not None:
            try:
                job.delete_task_info(ti)
            except KeyError:
                pass
        if ti.node_name and ti.node_name in self.nodes:
            self.nodes[ti.node_name].remove_task(ti)

    def update_pod(self, old: obj.Pod, new: obj.Pod) -> None:
        # bind/status echoes: when the cached task and the new view sit on
        # the same node with the same request, both in allocated-like
        # states, the node accounting is unchanged and only the status
        # index and the task's pod-derived fields move
        nt = TaskInfo(new)
        job = self.jobs.get(nt.job) if nt.job else None
        cached = job.tasks.get(nt.uid) if job is not None else None
        if (cached is not None and cached.node_name
                and cached.node_name == nt.node_name
                and allocated_status(cached.status)
                and allocated_status(nt.status)
                and cached.resreq.equal(nt.resreq)):
            _group_sig(nt)
            job.move_task_status(cached, nt.status)
            node = self.nodes.get(cached.node_name)
            for view in (cached,) if node is None else \
                    (cached, node.tasks.get(cached.key())):
                if view is None:
                    continue
                view.status = nt.status
                view.pod = nt.pod
                view.priority = nt.priority
                view.preemptable = nt.preemptable
                view.revocable_zone = nt.revocable_zone
                view.topology_policy = nt.topology_policy
                view.constraint_key_cache = nt.constraint_key_cache
                view.group_sig_cache = nt.group_sig_cache
            return
        self._delete_task(TaskInfo(old))
        self.add_pod(new)

    def update_pods_bulk(self, pairs) -> None:
        """Batched echo ingest for bulk store patches (bind writes). The
        delivered ``new`` objects are the store's own and must not be
        mutated. A bind echo (same node, allocated-like, same request,
        unchanged annotations, priority and deletion stamp) reduces to a
        status-index move plus a resource_version refresh on the pod the
        cache already holds; anything else goes through
        :meth:`update_pod` on a private copy."""
        with self.mutex:
            for old, new in pairs:
                jid = get_job_id(new)
                job = self.jobs.get(jid) if jid else None
                cached = None
                if job is not None:
                    cached = job.tasks.get(new.metadata.uid
                                           or new.metadata.key())
                om, nm = old.metadata, new.metadata
                if cached is not None and cached.node_name \
                        and cached.node_name == new.spec.node_name \
                        and allocated_status(cached.status) \
                        and (om.annotations is nm.annotations
                             or om.annotations == nm.annotations) \
                        and old.spec.priority == new.spec.priority \
                        and om.deletion_timestamp == nm.deletion_timestamp:
                    new_status = get_task_status(new)
                    rr = new.__dict__.get("_rr")
                    if allocated_status(new_status) and rr is not None \
                            and cached.resreq.equal(rr):
                        job.move_task_status(cached, new_status)
                        cached.pod.metadata.resource_version = \
                            nm.resource_version
                        node = self.nodes.get(cached.node_name)
                        stored = node.tasks.get(cached.key()) \
                            if node is not None else None
                        if stored is not None and stored is not cached:
                            stored.status = new_status
                            if stored.pod is not cached.pod:
                                stored.pod.metadata.resource_version = \
                                    nm.resource_version
                        continue
                try:
                    self.update_pod(old, fast_clone(new))
                except KeyError:
                    pass   # e.g. pod bound to a node we haven't seen yet

    def delete_pod(self, pod: obj.Pod) -> None:
        self._delete_task(TaskInfo(pod))
        # drop empty shell jobs with no podgroup (processCleanupJob analogue)
        jid = get_job_id(pod)
        job = self.jobs.get(jid)
        if job is not None and not job.tasks and job.pod_group is None:
            del self.jobs[jid]

    # -- nodes ------------------------------------------------------------

    def add_node(self, node: obj.Node) -> None:
        name = node.metadata.name
        if name in self.nodes:
            self.nodes[name].set_node(node)
        else:
            self.nodes[name] = NodeInfo(node)
        if name not in self.node_list:
            self.node_list.append(name)

    def update_node(self, old: obj.Node, new: obj.Node) -> None:
        if new.metadata.name in self.nodes:
            self.nodes[new.metadata.name].set_node(new)
        else:
            self.add_node(new)

    def delete_node(self, node: obj.Node) -> None:
        self.nodes.pop(node.metadata.name, None)
        if node.metadata.name in self.node_list:
            self.node_list.remove(node.metadata.name)

    # -- podgroups --------------------------------------------------------

    def add_pod_group(self, pg: obj.PodGroup) -> None:
        key = pg.metadata.key()
        if key not in self.jobs:
            self.jobs[key] = JobInfo(key, clock=self.store.clock)
        self.jobs[key].set_pod_group(pg)

    def update_pod_group(self, old: obj.PodGroup, new: obj.PodGroup) -> None:
        self.add_pod_group(new)

    def update_pod_groups_bulk(self, pairs) -> None:
        """Batched podgroup echo ingest (the session-close bulk status
        push). A status-only echo (the push's clone shares the spec) swaps
        in the store's object without re-deriving the job's spec fields;
        anything else is cloned and fully re-ingested."""
        with self.mutex:
            for old, new in pairs:
                job = self.jobs.get(new.metadata.key())
                if job is not None and job.pod_group is not None \
                        and new.spec is old.spec:
                    # stored objects are never mutated in place: sharing is
                    # safe; sessions copy on write via own_pod_group
                    job.pod_group = new
                    job.pod_group_owned = True
                    continue
                self.add_pod_group(fast_clone(new))

    def delete_pod_group(self, pg: obj.PodGroup) -> None:
        key = pg.metadata.key()
        job = self.jobs.get(key)
        if job is None:
            return
        job.unset_pod_group()
        if not job.tasks:
            del self.jobs[key]

    # -- queues -----------------------------------------------------------

    def add_queue(self, queue: obj.Queue) -> None:
        self.queues[queue.metadata.name] = QueueInfo(queue)

    def update_queue(self, old: obj.Queue, new: obj.Queue) -> None:
        self.add_queue(new)

    def delete_queue(self, queue: obj.Queue) -> None:
        self.queues.pop(queue.metadata.name, None)

    # -- priority classes -------------------------------------------------

    def add_priority_class(self, pc: obj.PriorityClass) -> None:
        if pc.global_default:
            self.default_priority_class = pc
            self.default_priority = pc.value
        self.priority_classes[pc.metadata.name] = pc

    def update_priority_class(self, old: obj.PriorityClass,
                              new: obj.PriorityClass) -> None:
        self.delete_priority_class(old)
        self.add_priority_class(new)

    def delete_priority_class(self, pc: obj.PriorityClass) -> None:
        if pc.global_default:
            self.default_priority_class = None
            self.default_priority = 0
        self.priority_classes.pop(pc.metadata.name, None)

    # -- resource quotas (namespace weights) ------------------------------

    def add_resource_quota(self, quota: obj.ResourceQuota) -> None:
        ns = quota.metadata.namespace
        if ns not in self.namespace_collection:
            self.namespace_collection[ns] = NamespaceCollection(ns)
        self.namespace_collection[ns].update(quota)

    def update_resource_quota(self, old, new) -> None:
        self.add_resource_quota(new)

    def delete_resource_quota(self, quota: obj.ResourceQuota) -> None:
        coll = self.namespace_collection.get(quota.metadata.namespace)
        if coll is not None:
            coll.delete(quota)
