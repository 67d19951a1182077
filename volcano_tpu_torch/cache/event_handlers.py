"""Cache event handlers: watch events -> JobInfo/NodeInfo mutation
(counterpart of volcano_tpu/cache/event_handlers.py; reference:
pkg/scheduler/cache/event_handlers.go): pod->task conversion and job/node
accounting (:47-260), node ingestion (:302-418), PodGroup/Queue ingestion
(:420-560), PriorityClass, ResourceQuota and Numatopology handlers. All
methods assume the cache lock is held by the caller (the watch fan-out is
synchronous).

Every handler records the job and node keys it changes in the cache's
dirty sets, which the incremental snapshot re-clones
(docs/design/incremental_cycle.md); queue, priority-class,
resource-quota and Numatopology edits are structural and force a full
rebuild. A pod's update that changes its node or its request, and its
delete, clear its bind-retry record and quarantine.
"""

from __future__ import annotations

from typing import Optional

from ..apiserver import store as store_api
from ..models import objects as obj
from ..models.arrays import _group_sig
from ..models.job_info import (JobInfo, TaskInfo, _fastmodel,
                               allocated_status, get_job_id, get_task_status,
                               is_terminated)
from ..models.node_info import NodeInfo
from ..models.numa_info import NumatopoInfo
from ..models.queue_info import NamespaceCollection, QueueInfo
from ..trace import ledger, tracer
from ..utils.fastclone import fast_clone


class EventHandlersMixin:
    """Mixed into SchedulerCache; operates on self.jobs/self.nodes/...

    The one delivery that does not dirty: the echo of the cache's own
    bind write, which :meth:`update_pods_bulk` recognises by the
    expected-bind-echo hint of the writing thread; the bind's apply
    already dirtied its job and node with the same information."""

    # the native engine's switch for the own-write echo (a class
    # attribute, so tests can force either engine)
    NATIVE_ECHO = True

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
        if ti.job and not ti.node_name and ledger.is_enabled():
            # lifecycle ledger: a schedulable pod enters the pipeline here
            # (set once: a relist keeps the first submission stamp)
            ledger.stamp(ti.key(), "submitted", self.store.clock.now(),
                         job=ti.job)
        if ti.node_name:
            if ti.node_name not in self.nodes:
                raise KeyError(f"node <{ti.node_name}> does not exist")
            if not is_terminated(ti.status):
                self.nodes[ti.node_name].add_task(ti)
        job = self._get_or_create_job(ti)
        if job is not None:
            job.add_task_info(ti)
            self._dirty_jobs.add(ti.job)
        if ti.node_name:
            self._dirty_nodes.add(ti.node_name)

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
                self._dirty_jobs.add(ti.job)
            except KeyError:
                pass
        if ti.node_name:
            self._dirty_nodes.add(ti.node_name)
            if ti.node_name in self.nodes:
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
            if ledger.is_enabled():
                # a bound pod's echo: the ledger's terminal stamp (set
                # once, so a later Running-phase echo is a no-op)
                ledger.confirm(cached.key(), self.store.clock.now(),
                               queue=job.queue)
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
            # a status or annotation change from outside: the snapshot's
            # job and node views of the task are both stale
            self._dirty_jobs.add(nt.job)
            self._dirty_nodes.add(cached.node_name)
            return
        ot = TaskInfo(old)
        # a material update (another node, another request) may cure what
        # failed the bind: the pod gets a fresh retry budget. A status
        # writeback (the Unschedulable condition each cycle) does not.
        if self.retry_records or self.quarantined:
            key = new.metadata.key()
            if key in self.retry_records or key in self.quarantined:
                if old.spec.node_name != new.spec.node_name or \
                        not ot.resreq.equal(nt.resreq):
                    self._clear_bind_retry_state(key)
        self._delete_task(ot)
        self.add_pod(new)

    def update_pods_bulk(self, pairs) -> None:
        """Batched echo ingest for bulk store patches (bind writes), one
        call a delivery (a shard on the sharded flush, from the echo
        worker, so it overlaps the cloning of the shards behind it). The
        delivered ``new`` objects are the store's own and must not be
        mutated. A bind echo (same node, allocated-like, same request,
        unchanged annotations, priority and deletion stamp) reduces to a
        status-index move plus a resource_version refresh on the pod the
        cache already holds; anything else goes through
        :meth:`update_pod` on a private copy.

        The echo of the cache's own bind write does not dirty: a delivery
        whose origin (``store.delivery_origin``: the writing thread, on
        whose behalf the echo worker delivers) is the thread that set the
        expected-bind-echo hint, of a pod the hint names bound to the
        hinted node, is that write. Another writer's patch of the same
        shape dirties its job and node like any watch delta. The ledger
        confirms the echoed binds, with the shard's publish instant as
        their store_committed stamp.

        On the native engine (NATIVE_ECHO) ``bind_echo_apply`` takes the
        own-write pairs, the same guards and the same changes, up to the
        first pair it hands back; that pair takes this body, and the
        native pass resumes after it, so pairs are handled in order."""
        hint = self._expected_bind_echo
        exp = hint[1] if hint is not None \
            and hint[0] == store_api.delivery_origin() else None
        now = self.store.clock.now() if ledger.is_enabled() else None
        commit_t = store_api.delivery_commit_time() \
            if now is not None else None
        confirms: list = []
        with tracer.async_span("bind_flush.echo", pairs=len(pairs)), \
                self.mutex:
            self._state_version += 1

            def apply(job, cached, new_status, rv) -> None:
                """The echo's status move and resource_version refresh."""
                if now is not None:
                    if confirms and confirms[-1][1] == job.queue:
                        confirms[-1][0].append(cached.key())
                    else:
                        confirms.append(([cached.key()], job.queue))
                job.move_task_status(cached, new_status)
                cached.pod.metadata.resource_version = rv
                node = self.nodes.get(cached.node_name)
                stored = node.tasks.get(cached.key()) \
                    if node is not None else None
                if stored is not None and stored is not cached:
                    stored.status = new_status
                    if stored.pod is not cached.pod:
                        stored.pod.metadata.resource_version = rv

            def one(old, new) -> None:
                """The ingest of one pair."""
                nm = new.metadata
                own = exp.get(nm.uid) if exp is not None else None
                if own is not None:
                    # our own bind write: it changed node_name and the
                    # resource_version and nothing else, so the guards
                    # below are moot and nothing is dirtied
                    task, host = own
                    new_status = get_task_status(new)
                    job = self.jobs.get(task.job)
                    if job is not None and new.spec.node_name == host \
                            and task.node_name == host \
                            and allocated_status(task.status) \
                            and allocated_status(new_status):
                        apply(job, task, new_status, nm.resource_version)
                        return
                jid = get_job_id(new)
                job = self.jobs.get(jid) if jid else None
                cached = None
                if job is not None:
                    cached = job.tasks.get(nm.uid or nm.key())
                om = old.metadata
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
                        # another writer's patch: it carries new state,
                        # so it dirties like any watch delta
                        self._dirty_jobs.add(jid)
                        self._dirty_nodes.add(cached.node_name)
                        apply(job, cached, new_status, nm.resource_version)
                        return
                try:
                    self.update_pod(old, fast_clone(new))
                except KeyError:
                    pass   # e.g. pod bound to a node we haven't seen yet

            if exp is None or not self.NATIVE_ECHO:
                for old, new in pairs:
                    one(old, new)
            else:
                fm = _fastmodel()
                pairs = pairs if isinstance(pairs, list) else list(pairs)
                i, n = 0, len(pairs)
                while i < n:
                    i = fm.bind_echo_apply(
                        pairs, i, exp, self.jobs, self.nodes,
                        confirms if now is not None else None)
                    if i < n:
                        one(*pairs[i])
                        i += 1
            if confirms:
                ledger.confirm_runs(confirms, now, commit_t)

    def delete_pod(self, pod: obj.Pod) -> None:
        ledger.drop(pod.metadata.key())
        # a deleted pod drops its bind-failure history: a recreated pod
        # starts with a fresh retry budget
        if self.retry_records or self.quarantined:
            self._clear_bind_retry_state(pod.metadata.key())
        self._delete_task(TaskInfo(pod))
        # drop empty shell jobs with no podgroup (processCleanupJob analogue)
        jid = get_job_id(pod)
        job = self.jobs.get(jid)
        if job is not None and not job.tasks and job.pod_group is None:
            del self.jobs[jid]
            self._dirty_jobs.add(jid)

    # -- nodes ------------------------------------------------------------

    def add_node(self, node: obj.Node) -> None:
        name = node.metadata.name
        self._dirty_nodes.add(name)
        if name in self.nodes:
            self.nodes[name].set_node(node)
        else:
            self.nodes[name] = NodeInfo(node)
            nt = self.numatopologies.get(name)
            if nt is not None:
                self.nodes[name].numa_info = nt
        if name not in self.node_list:
            self.node_list.append(name)

    def update_node(self, old: obj.Node, new: obj.Node) -> None:
        self._dirty_nodes.add(new.metadata.name)
        if new.metadata.name in self.nodes:
            self.nodes[new.metadata.name].set_node(new)
        else:
            self.add_node(new)

    def delete_node(self, node: obj.Node) -> None:
        self._dirty_nodes.add(node.metadata.name)
        self.nodes.pop(node.metadata.name, None)
        if node.metadata.name in self.node_list:
            self.node_list.remove(node.metadata.name)

    # -- podgroups --------------------------------------------------------

    def add_pod_group(self, pg: obj.PodGroup) -> None:
        key = pg.metadata.key()
        self._dirty_jobs.add(key)
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
            self._state_version += 1
            for old, new in pairs:
                self._dirty_jobs.add(new.metadata.key())
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
        self._dirty_jobs.add(key)
        job = self.jobs.get(key)
        if job is None:
            return
        job.unset_pod_group()
        if not job.tasks:
            del self.jobs[key]

    # -- queues -----------------------------------------------------------
    # Queue, priority-class, quota and NUMA topology edits are structural
    # for the incremental snapshot: they reach every job (inclusion,
    # fair-share budgets, priority resolution, namespace weights) or
    # every node (the NUMA views), so the next snapshot rebuilds in full.

    def add_queue(self, queue: obj.Queue) -> None:
        self.mark_structural_change()
        self.queues[queue.metadata.name] = QueueInfo(queue)

    def update_queue(self, old: obj.Queue, new: obj.Queue) -> None:
        self.add_queue(new)

    def delete_queue(self, queue: obj.Queue) -> None:
        self.mark_structural_change()
        self.queues.pop(queue.metadata.name, None)

    # -- priority classes -------------------------------------------------

    def add_priority_class(self, pc: obj.PriorityClass) -> None:
        self.mark_structural_change()
        if pc.global_default:
            self.default_priority_class = pc
            self.default_priority = pc.value
        self.priority_classes[pc.metadata.name] = pc

    def update_priority_class(self, old: obj.PriorityClass,
                              new: obj.PriorityClass) -> None:
        self.delete_priority_class(old)
        self.add_priority_class(new)

    def delete_priority_class(self, pc: obj.PriorityClass) -> None:
        self.mark_structural_change()
        if pc.global_default:
            self.default_priority_class = None
            self.default_priority = 0
        self.priority_classes.pop(pc.metadata.name, None)

    # -- resource quotas (namespace weights) ------------------------------

    def add_resource_quota(self, quota: obj.ResourceQuota) -> None:
        self.mark_structural_change()
        ns = quota.metadata.namespace
        if ns not in self.namespace_collection:
            self.namespace_collection[ns] = NamespaceCollection(ns)
        self.namespace_collection[ns].update(quota)

    def update_resource_quota(self, old, new) -> None:
        self.add_resource_quota(new)

    def delete_resource_quota(self, quota: obj.ResourceQuota) -> None:
        self.mark_structural_change()
        coll = self.namespace_collection.get(quota.metadata.namespace)
        if coll is not None:
            coll.delete(quota)

    # -- numatopology -----------------------------------------------------

    def add_numa_info(self, nt: obj.Numatopology) -> None:
        self.mark_structural_change()
        info = NumatopoInfo.from_crd(nt)
        old = self.numatopologies.get(nt.metadata.name)
        self.numatopologies[nt.metadata.name] = info
        node = self.nodes.get(nt.metadata.name)
        if node is not None:
            node.numa_info = info
            # widen vs narrow decides how the scheduler-side view is merged
            # at snapshot time (reference: event_handlers.go:818-841 Compare)
            shrank = old is not None and any(
                len(info.numa_res_map[res].allocatable) < len(ri.allocatable)
                for res, ri in old.numa_res_map.items()
                if res in info.numa_res_map)
            node.numa_chg_flag = "less" if shrank else "more"

    def update_numa_info(self, old: obj.Numatopology,
                         new: obj.Numatopology) -> None:
        self.add_numa_info(new)

    def delete_numa_info(self, nt: obj.Numatopology) -> None:
        self.mark_structural_change()
        self.numatopologies.pop(nt.metadata.name, None)
        node = self.nodes.get(nt.metadata.name)
        if node is not None:
            node.numa_info = None
