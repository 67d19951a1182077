"""SchedulerCache: watch-fed cluster state with a per-cycle snapshot
(counterpart of volcano_tpu/cache/cache.py; reference:
pkg/scheduler/cache/cache.go): watch ingestion (:84-96, Run:487), the
full-rebuild deep-copy snapshot (:793-882), binds, evictions and
PodGroup status writeback.

Binds and evictions are synchronous: ``bind``/``bind_batch`` move the
cache's tasks to Binding, add them to their nodes and write the store at
commit; ``evict``/``evict_batch`` move them to Releasing and delete their
pods through the evictor. The store's watch echo then updates the cache
(a deleted pod leaves its job and node) before the call returns; it
edits the cache's own objects, never a session's snapshot clones. So
``flush_executors`` has nothing to wait for.

Left out of this port: the incremental snapshot, the async bind/evict
executors and write-behind applies, bind retry/backoff/quarantine,
partial-gang healing, anti-entropy, lease fencing and NUMA.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..apiserver.store import ObjectStore
from ..models import objects as obj
from ..models.cluster_info import ClusterInfo
from ..models.job_info import JobInfo, TaskInfo, TaskStatus
from ..models.node_info import NodeInfo
from ..models.objects import (DEFAULT_QUEUE, DEFAULT_SCHEDULER_NAME,
                              PodGroupPhase)
from ..models.queue_info import NamespaceCollection, QueueInfo
from .event_handlers import EventHandlersMixin
from .interface import (NullVolumeBinder, StoreBinder, StoreEvictor,
                        StoreStatusUpdater)


class SchedulerCache(EventHandlersMixin):
    """The scheduler's view of the cluster, fed by store watches."""

    def __init__(self, store: ObjectStore,
                 scheduler_name: str = DEFAULT_SCHEDULER_NAME,
                 default_queue: str = DEFAULT_QUEUE,
                 binder=None, evictor=None, status_updater=None,
                 volume_binder=None):
        self.store = store
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue

        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.priority_classes: Dict[str, obj.PriorityClass] = {}
        self.default_priority: int = 0
        self.default_priority_class: Optional[obj.PriorityClass] = None
        self.namespace_collection: Dict[str, NamespaceCollection] = {}
        self.node_list: List[str] = []

        self.binder = binder if binder is not None else StoreBinder(store)
        self.evictor = evictor if evictor is not None \
            else StoreEvictor(store)
        self.status_updater = (status_updater if status_updater is not None
                               else StoreStatusUpdater(store))
        self.volume_binder = volume_binder if volume_binder is not None \
            else NullVolumeBinder()

        self.mutex = threading.RLock()
        self._watches: list = []
        self._running = False
        # wall ms of the last snapshot (read by the cycle's timing split)
        self.last_snapshot_ms = 0.0
        # pods handed to the evictor since the cache was built
        self.evictions = 0

    # -- lifecycle ---------------------------------------------------------

    def _responsible_for(self, pod: obj.Pod) -> bool:
        """Only pods targeted at this scheduler (cache.go responsibleForPod)."""
        return pod.spec.scheduler_name == self.scheduler_name

    def run(self) -> None:
        """Subscribe all watches, replaying existing objects (informer
        list+watch; cache.go:487-507)."""
        if self._running:
            return
        self._running = True
        s = self.store

        def locked(fn):
            def wrapper(*args):
                with self.mutex:
                    try:
                        fn(*args)
                    except KeyError:
                        pass  # e.g. pod bound to a node we haven't seen yet
            return wrapper

        # nodes/podgroups/queues before pods: replayed pods reference them
        self._watches = [
            s.watch("nodes", locked(self.add_node), locked(self.update_node),
                    locked(self.delete_node)),
            s.watch("podgroups", locked(self.add_pod_group),
                    locked(self.update_pod_group),
                    locked(self.delete_pod_group),
                    on_bulk_update=self.update_pod_groups_bulk),
            s.watch("queues", locked(self.add_queue),
                    locked(self.update_queue), locked(self.delete_queue)),
            s.watch("pods", locked(self.add_pod), locked(self.update_pod),
                    locked(self.delete_pod),
                    filter_fn=self._responsible_for,
                    on_bulk_update=self.update_pods_bulk),
            s.watch("priorityclasses", locked(self.add_priority_class),
                    locked(self.update_priority_class),
                    locked(self.delete_priority_class)),
            s.watch("resourcequotas", locked(self.add_resource_quota),
                    locked(self.update_resource_quota),
                    locked(self.delete_resource_quota)),
        ]

    def stop(self) -> None:
        for w in self._watches:
            self.store.unwatch(w)
        self._watches = []
        self._running = False

    def wait_for_cache_sync(self) -> bool:
        return self._running  # synchronous watches: synced once run

    def flush_executors(self, timeout: float = 30.0) -> bool:
        """Every store write already happened inside its call."""
        return True

    def submit_background(self, fn) -> None:
        """Run ``fn`` now: there is no background executor."""
        fn()

    def client(self) -> ObjectStore:
        """The plugins'/actions' handle to the API (Cache.Client analogue)."""
        return self.store

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> ClusterInfo:
        """Deep copy of the whole state (cache.go:793-882): only Ready
        nodes; only jobs with a PodGroup and an existing queue; job
        priority resolved from PriorityClass here."""
        t0 = time.perf_counter()
        with self.mutex:
            snap = ClusterInfo()
            snap.node_list = list(self.node_list)
            for node in self.nodes.values():
                if not node.ready():
                    continue
                cloned = node.clone()
                snap.nodes[node.name] = cloned
                if node.revocable_zone:
                    snap.revocable_nodes[node.name] = cloned
            for q in self.queues.values():
                snap.queues[q.uid] = q.clone()
            for coll in self.namespace_collection.values():
                info = coll.snapshot()
                snap.namespaces[info.name] = info
            for job in self.jobs.values():
                if job.pod_group is None or job.queue not in snap.queues:
                    continue
                job.priority = self.default_priority
                pc = self.priority_classes.get(
                    job.pod_group.spec.priority_class_name)
                if pc is not None:
                    job.priority = pc.value
                snap.jobs[job.uid] = job.clone()
        self.last_snapshot_ms = (time.perf_counter() - t0) * 1000.0
        return snap

    # -- binds -------------------------------------------------------------

    def _find_job_and_task(self, task_info: TaskInfo):
        job = self.jobs.get(task_info.job)
        if job is None:
            raise KeyError(f"failed to find job <{task_info.job}>")
        task = job.tasks.get(task_info.uid)
        if task is None:
            raise KeyError(f"failed to find task <{task_info.uid}>")
        return job, task

    def _stage_bind(self, task_info: TaskInfo, hostname: str):
        """Mark one task Binding in the cache and add it to its node
        (cache.go:605-645); caller holds the mutex. Returns (task, pod) or
        raises KeyError/RuntimeError with nothing changed."""
        job, task = self._find_job_and_task(task_info)
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to bind Task {task.uid} to host "
                           f"{hostname}, host does not exist")
        original = task.status
        job.move_task_status(task, TaskStatus.Binding)
        try:
            node.add_task(task)
        except RuntimeError:
            job.move_task_status(task, original)
            raise
        return task, task.pod

    def bind(self, task_info: TaskInfo, hostname: str) -> None:
        """Stage one task's bind in the cache, then write it to the store."""
        with self.mutex:
            task, pod = self._stage_bind(task_info, hostname)
        self._bind_store_writes([(task, pod, hostname)])

    def bind_batch(self, pairs) -> list:
        """Bind a gang: ``[(task_info, hostname)]`` staged in one mutex
        pass and written in one store commit. A task whose job, task or
        node lookup fails, or whose node refuses it, is skipped. Returns
        the accepted task infos."""
        accepted, bound = [], []
        with self.mutex:
            for task_info, hostname in pairs:
                try:
                    task, pod = self._stage_bind(task_info, hostname)
                except (KeyError, RuntimeError):
                    continue
                accepted.append(task_info)
                bound.append((task, pod, hostname))
        self._bind_store_writes(bound)
        return accepted

    def _bind_store_writes(self, bound) -> None:
        """One binder pass + Scheduled events for [(task, pod, hostname)]."""
        if not bound:
            return
        failed = self.binder.bind_batch([(pod, hostname)
                                         for _, pod, hostname in bound])
        if failed:
            # the cache staged these as Binding; the store does not have
            # them: reconcile each from the store
            gone = {id(pod) for pod, _ in failed}
            for task, pod, _ in bound:
                if id(pod) in gone:
                    self.sync_task(task)
        cap = self.store.EVENTS_CAPACITY
        for task, pod, hostname in bound[-cap:]:
            self.store.record_event(
                "pods", pod, "Normal", "Scheduled",
                f"Successfully assigned {task.namespace}/{task.name} "
                f"to {hostname}")

    # -- evictions ---------------------------------------------------------

    def evict(self, task_info: TaskInfo, reason: str) -> None:
        """Mark the cache's task Releasing, update its node's accounting,
        then delete the pod through the evictor (cache.go:552-601)."""
        with self.mutex:
            job, task = self._find_job_and_task(task_info)
            node = self.nodes.get(task.node_name)
            if node is None:
                raise KeyError(f"failed to evict Task {task.uid} on host "
                               f"{task.node_name}, host does not exist")
            original = task.status
            job.update_task_status(task, TaskStatus.Releasing)
            try:
                node.update_task(task)
            except RuntimeError:
                job.update_task_status(task, original)
                raise
        self._evict_store_writes([(task, task.pod, job.pod_group, reason)])

    def evict_batch(self, items) -> None:
        """Evict ``[(task_info, reason)]`` in one mutex pass, in order (the
        per-statement form of :meth:`evict`). A task whose job, task or
        node lookup fails is skipped, as the per-task commit path skips
        its KeyError; one whose node refuses the flip is rolled back and
        resynced from the store."""
        staged = []
        with self.mutex:
            for task_info, reason in items:
                try:
                    job, task = self._find_job_and_task(task_info)
                except KeyError:
                    continue
                node = self.nodes.get(task.node_name)
                if node is None:
                    continue
                original = task.status
                job.move_task_status(task, TaskStatus.Releasing)
                try:
                    node.transition_task(task)
                except RuntimeError:
                    job.move_task_status(task, original)
                    self.sync_task(task)
                    continue
                staged.append((task, task.pod, job.pod_group, reason))
        self._evict_store_writes(staged)

    def _evict_store_writes(self, staged) -> None:
        """The evictor's pod deletes and the PodGroups' Evict events for
        ``[(task, pod, pod_group, reason)]``; a failed delete resyncs the
        task from the store."""
        for task, pod, pod_group, reason in staged:
            self.evictions += 1
            try:
                self.evictor.evict(pod, reason)
            except Exception:
                self.sync_task(task)
            if pod_group is not None:
                self.store.record_event("podgroups", pod_group, "Normal",
                                        "Evict", reason)

    def sync_task(self, old_task: TaskInfo) -> None:
        """Rebuild one task from the store's pod (cache.go:768-791)."""
        pod = self.store.get("pods", old_task.name, old_task.namespace)
        with self.mutex:
            self._delete_task(old_task)
            if pod is not None:
                try:
                    self._add_task(TaskInfo(pod))
                except KeyError:
                    pass

    # -- status writeback --------------------------------------------------

    def update_job_status(self, job: JobInfo, update_pg: bool = True) -> JobInfo:
        """Record user-facing events and push PodGroup status
        (cache.go:700-739 + job_updater)."""
        self.update_job_statuses([(job, update_pg)])
        return job

    def update_job_statuses(self, updates) -> None:
        """The session's close writeback, ``[(job, update_pg)]``: events
        and Unschedulable pod conditions first, then one bulk PodGroup
        status push."""
        push = []
        conditions: list = []
        for job, update_pg in updates:
            self.record_job_status_event(job, condition_sink=conditions)
            if update_pg and job.pod_group is not None:
                push.append(job)
        if conditions:
            self.status_updater.update_pod_conditions(conditions)
        if not push:
            return
        for job, pg in zip(push, self.status_updater.update_pod_groups(
                [j.pod_group for j in push])):
            if pg is not None:
                job.pod_group = pg
                job.pod_group_owned = True

    def record_job_status_event(self, job: JobInfo,
                                condition_sink: list) -> None:
        """Pending-not-ready jobs get FailedScheduling events on their
        unscheduled tasks (cache.go:659-698); their Unschedulable pod
        conditions are collected as ``(pod, reason, message)`` in
        ``condition_sink`` for the caller's bulk push."""
        if job.pod_group is None:
            return
        phase = job.pod_group.status.phase
        if phase in (PodGroupPhase.PENDING, PodGroupPhase.INQUEUE) \
                and not job.ready():
            msg = job.fit_error()
            for task in job.task_status_index.get(TaskStatus.Pending,
                                                  {}).values():
                fit_errors = job.nodes_fit_errors.get(task.uid)
                reason = fit_errors.error() if fit_errors is not None \
                    else msg
                self.store.record_event("pods", task.pod, "Warning",
                                        "FailedScheduling", reason)
                condition_sink.append((task.pod, "Unschedulable", reason))

    def __repr__(self):
        return (f"SchedulerCache(jobs={len(self.jobs)}, "
                f"nodes={len(self.nodes)}, queues={len(self.queues)})")
