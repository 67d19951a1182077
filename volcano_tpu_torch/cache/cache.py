"""SchedulerCache: watch-fed cluster state with a per-cycle snapshot
(counterpart of volcano_tpu/cache/cache.py; reference:
pkg/scheduler/cache/cache.go): watch ingestion (:84-96, Run:487), the
deep-copy snapshot (:793-882), binds, evictions and PodGroup status
writeback.

With ``incremental`` on (the Scheduler's default) the snapshot is the
incremental steady-state cycle's (docs/design/incremental_cycle.md): one
persistent ClusterInfo, patched in place by re-cloning only the jobs and
nodes in the dirty sets. Every watch delta, bind and eviction marks the
sets, and a closing session folds in what it mutated
(``absorb_session_touches``). The first snapshot, every structural change
(queue, priority class, resource quota) and every
``INCR_FULL_RECOMPUTE_EVERY_CYCLES``-th snapshot rebuild in full.

Binds and evictions are synchronous: ``bind``/``bind_batch`` move the
cache's tasks to Binding, add them to their nodes and write the store at
commit; ``evict``/``evict_batch`` move them to Releasing and delete their
pods through the evictor. The store's watch echo then updates the cache
(a deleted pod leaves its job and node) before the call returns; it
edits the cache's own objects, never a session's snapshot clones. So
``flush_executors`` has nothing to wait for. While tracing is on the
commit is split as the reference's bind flush is: the gangs' staging
(``bind_flush.apply``), store writes with their events
(``bind_flush.store``) and watch echoes (``bind_flush.echo``, inside the
store write) are summed over the cycle and recorded once a cycle as the
flight recorder's async spans (``emit_commit_spans``); and the pod
lifecycle ledger (trace/ledger.py) is stamped: ``bind_staged`` at staging,
``store_committed`` and ``echo_confirmed`` at the echo, all within the
cycle's commit; the ledger completes the echoed entries after the cycle
(``flush_executors`` and the scheduler), where the reference's flush
executor does.

Left out of this port: the async bind/evict executors and write-behind
applies (the async flush), bind retry/backoff/quarantine and the retry
records that re-dirty their jobs, partial-gang healing, anti-entropy,
lease fencing and NUMA.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

from ..apiserver.store import ObjectStore
from ..metrics import metrics as m
from ..models import objects as obj
from ..models.arrays import ResourceIndex
from ..models.cluster_info import ClusterInfo
from ..models.job_info import JobInfo, TaskInfo, TaskStatus
from ..models.node_info import NodeInfo
from ..models.objects import (DEFAULT_QUEUE, DEFAULT_SCHEDULER_NAME,
                              PodGroupPhase, status_fingerprint)
from ..models.queue_info import NamespaceCollection, QueueInfo
from ..models.resource import CPU, MEMORY, Resource
from ..trace import ledger
from ..trace import tracer
from .event_handlers import EventHandlersMixin
from .interface import (NullVolumeBinder, StoreBinder, StoreEvictor,
                        StoreStatusUpdater)


class SchedulerCache(EventHandlersMixin):
    """The scheduler's view of the cluster, fed by store watches."""

    # every Nth incremental snapshot is a full rebuild even with nothing
    # dirty, so a dirty-tracking bug lasts at most this many cycles
    # (0 turns the cadence off)
    INCR_FULL_RECOMPUTE_EVERY_CYCLES = 64

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
        # bind correlation ids ("bind-<n>"), one a store commit, joining
        # the lifecycle ledger's entries to the commit that bound them
        self._trace_ids = itertools.count(1)
        # in a traced cycle: the commit's seconds of apply, store and echo,
        # its binds and echoed pairs, and its first instant, summed over
        # its gangs (begin_commit_trace, emit_commit_spans)
        self._commit_acc: Optional[list] = None
        # the incremental steady-state cycle: with ``incremental`` on,
        # snapshot() keeps one persistent ClusterInfo and re-clones only
        # the jobs and nodes in the dirty sets
        self.incremental = False
        self._dirty_jobs: set = set()
        self._dirty_nodes: set = set()
        self._dirty_structural = True      # the first snapshot is full
        self._incr_snap: Optional[ClusterInfo] = None
        self._incr_seq = 0
        self._incr_cycles_since_full = 0
        # {("n", name) | ("j", uid): frozenset of scalar resource names}
        # of the entities that bring scalar dimensions: the upkeep behind
        # snapshot.rindex
        self._incr_scalar_src: Dict[tuple, frozenset] = {}
        # the last snapshot's mode and dirty-set sizes (the cycle's tags)
        self.last_snapshot_stats: dict = {}
        # while _bind_store_writes is in the store: (thread ident, {task
        # uid: (cache task, hostname)}) of the binds being written, so
        # update_pods_bulk knows their echoes (delivered on this thread)
        # and does not dirty for them
        self._expected_bind_echo: Optional[tuple] = None

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
        """Every store write already happened inside its call; the
        lifecycle ledger's held echo confirmations complete here."""
        ledger.complete_deferred()
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
        priority resolved from PriorityClass here. With ``incremental``
        on, the persistent snapshot patched by the dirty sets, equal in
        content and order to this full rebuild."""
        t0 = time.perf_counter()
        with self.mutex:
            if self.incremental:
                snap = self._incr_snapshot_locked()
            else:
                # the dirty sets are consumed (kept bounded) even though
                # the rebuild does not read them
                self._dirty_jobs.clear()
                self._dirty_nodes.clear()
                self._dirty_structural = False
                self._incr_snap = None
                snap = self._snapshot_locked()
        self.last_snapshot_ms = (time.perf_counter() - t0) * 1000.0
        return snap

    def _snapshot_locked(self) -> ClusterInfo:
        """The full rebuild; the caller holds the mutex."""
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
            self._resolve_priority(job)
            snap.jobs[job.uid] = job.clone()
        return snap

    def _resolve_priority(self, job: JobInfo) -> None:
        job.priority = self.default_priority
        pc = self.priority_classes.get(job.pod_group.spec.priority_class_name)
        if pc is not None:
            job.priority = pc.value

    # -- incremental snapshot (docs/design/incremental_cycle.md) -----------

    def mark_structural_change(self) -> None:
        """Make the next snapshot a full rebuild: a change that reaches
        beyond one job or node (queue add/update/delete re-gates every
        job's inclusion and fair share; priority-class and quota edits
        re-resolve every job)."""
        with self.mutex:
            self._dirty_structural = True

    def absorb_session_touches(self, jobs, nodes) -> None:
        """Fold a closing session's own mutations (placements, pipelined
        claims, condition and status writes) into the dirty sets: the
        session mutates the persistent snapshot's objects in place, so
        each touched job and node is re-cloned from the cache before it
        is read again."""
        if not (jobs or nodes):
            return
        with self.mutex:
            self._dirty_jobs.update(jobs)
            self._dirty_nodes.update(nodes)

    @staticmethod
    def _scalar_names_of(res) -> Optional[frozenset]:
        return frozenset(res.scalars) if res.scalars else None

    def _incr_scalar_update(self, key: tuple, names) -> bool:
        """Track one entity's scalar resource names; True when they
        changed (the caller then re-derives snapshot.rindex)."""
        old = self._incr_scalar_src.pop(key, None)
        if names:
            self._incr_scalar_src[key] = names
        return old != names

    def _incr_refresh_rindex(self, snap: ClusterInfo) -> None:
        """Re-derive the snapshot's ResourceIndex from the tracked scalar
        names, keeping the same object while the names are unchanged
        (the solver's persistent node state keys on its identity)."""
        names: set = set()
        for contributed in self._incr_scalar_src.values():
            names |= contributed
        if snap.rindex is not None and \
                set(snap.rindex.names) == ({CPU, MEMORY} | names):
            return
        snap.rindex = ResourceIndex(names)

    def _init_incr_aux(self, snap: ClusterInfo) -> None:
        """The rollups of a full rebuild: the resource index, the
        allocatable total (summed in snap.nodes order, as open_session's
        loop sums it, so that the two agree to the bit), the PodGroup
        status fingerprints and the pending-work sets of the quiet
        cycle."""
        self._incr_scalar_src = {}
        for name, node in snap.nodes.items():
            sn = self._scalar_names_of(node.allocatable)
            if sn:
                self._incr_scalar_src[("n", name)] = sn
        for uid, job in snap.jobs.items():
            sn = self._scalar_names_of(job.total_request)
            if sn:
                self._incr_scalar_src[("j", uid)] = sn
        snap.rindex = None
        self._incr_refresh_rindex(snap)
        total = Resource()
        for node in snap.nodes.values():
            total.add(node.allocatable)
        snap.total_resource = total
        snap.pg_fprints = {uid: status_fingerprint(job.pod_group.status)
                           for uid, job in snap.jobs.items()}
        snap.pending_task_jobs = {
            uid for uid, job in snap.jobs.items()
            if job.task_status_index.get(TaskStatus.Pending)}
        snap.pending_phase_jobs = {
            uid for uid, job in snap.jobs.items()
            if job.pod_group.status.phase == PodGroupPhase.PENDING}

    @staticmethod
    def _incr_job_aux(snap: ClusterInfo, uid: str, job) -> None:
        """Refresh one patched job's rollup entries (``job`` None: gone)."""
        if job is None:
            snap.pg_fprints.pop(uid, None)
            snap.pending_task_jobs.discard(uid)
            snap.pending_phase_jobs.discard(uid)
            return
        snap.pg_fprints[uid] = status_fingerprint(job.pod_group.status)
        if job.task_status_index.get(TaskStatus.Pending):
            snap.pending_task_jobs.add(uid)
        else:
            snap.pending_task_jobs.discard(uid)
        if job.pod_group.status.phase == PodGroupPhase.PENDING:
            snap.pending_phase_jobs.add(uid)
        else:
            snap.pending_phase_jobs.discard(uid)

    def _incr_snapshot_locked(self) -> ClusterInfo:
        """The persistent snapshot: a full rebuild when due (first use, a
        structural change, the periodic cadence), else patched in place.
        The caller holds the mutex."""
        every = self.INCR_FULL_RECOMPUTE_EVERY_CYCLES
        full_due = (self._incr_snap is None or self._dirty_structural
                    or (every > 0
                        and self._incr_cycles_since_full >= every))
        n_dirty_jobs = len(self._dirty_jobs)
        n_dirty_nodes = len(self._dirty_nodes)
        self._incr_seq += 1
        if full_due:
            snap = self._snapshot_locked()
            self._init_incr_aux(snap)
            self._incr_snap = snap
            self._incr_cycles_since_full = 0
            self._dirty_structural = False
            self._dirty_jobs = set()
            self._dirty_nodes = set()
            snap.incr_mode = "full"
            snap.patched_jobs = set(snap.jobs)
            snap.patched_nodes = set(snap.nodes)
        else:
            snap = self._incr_snap
            snap.incr_mode = "incremental"
            self._patch_snapshot_locked(snap)
        self._incr_cycles_since_full += 1
        snap.incr_seq = self._incr_seq
        snap.quiet = (snap.incr_mode == "incremental"
                      and not snap.patched_jobs and not snap.patched_nodes
                      and not snap.pending_task_jobs
                      and not snap.pending_phase_jobs)
        self.last_snapshot_stats = {
            "mode": snap.incr_mode, "quiet": snap.quiet,
            "dirty_jobs": n_dirty_jobs, "dirty_nodes": n_dirty_nodes,
            "patched_jobs": len(snap.patched_jobs),
            "patched_nodes": len(snap.patched_nodes),
            "jobs": len(snap.jobs), "nodes": len(snap.nodes)}
        m.inc(m.CYCLE_MODE, mode=snap.incr_mode)
        m.set_gauge(m.DIRTY_SET_SIZE, float(n_dirty_jobs), kind="jobs")
        m.set_gauge(m.DIRTY_SET_SIZE, float(n_dirty_nodes), kind="nodes")
        return snap

    def _patch_snapshot_locked(self, snap: ClusterInfo) -> None:
        """Patch the persistent ClusterInfo: re-clone exactly the dirty
        jobs and nodes, drop the gone or filtered ones, and rebuild the
        small whole-cluster collections (queues, namespaces, node_list).

        Order: the full rebuild iterates the cache's dicts, and float sums
        downstream (the allocatable total, proportion's queue sums) follow
        dict order, so whenever membership may have changed the dict
        shells are rebuilt in the cache's order."""
        dirty_jobs, self._dirty_jobs = self._dirty_jobs, set()
        dirty_nodes, self._dirty_nodes = self._dirty_nodes, set()
        rindex_stale = False

        snap.queues = {q.uid: q.clone() for q in self.queues.values()}
        snap.namespaces = {}
        for coll in self.namespace_collection.values():
            info = coll.snapshot()
            snap.namespaces[info.name] = info

        patched_nodes: set = set()
        if dirty_nodes:
            for name in dirty_nodes:
                node = self.nodes.get(name)
                patched_nodes.add(name)
                if node is None or not node.ready():
                    snap.nodes.pop(name, None)
                    rindex_stale |= self._incr_scalar_update(("n", name),
                                                             None)
                    continue
                snap.nodes[name] = node.clone()
                rindex_stale |= self._incr_scalar_update(
                    ("n", name), self._scalar_names_of(node.allocatable))
            # a delete and re-add between cycles moves a key to the end
            # of the cache's dict; the snapshot follows
            snap.nodes = {n: snap.nodes[n] for n in self.nodes
                          if n in snap.nodes}
            snap.revocable_nodes = {n: c for n, c in snap.nodes.items()
                                    if c.revocable_zone}
            snap.node_list = list(self.node_list)
            total = Resource()
            for node in snap.nodes.values():
                total.add(node.allocatable)
            snap.total_resource = total

        patched_jobs: set = set()
        if dirty_jobs:
            for uid in dirty_jobs:
                job = self.jobs.get(uid)
                patched_jobs.add(uid)
                if job is None or job.pod_group is None \
                        or job.queue not in snap.queues:
                    snap.jobs.pop(uid, None)
                    self._incr_job_aux(snap, uid, None)
                    rindex_stale |= self._incr_scalar_update(("j", uid),
                                                             None)
                    continue
                self._resolve_priority(job)
                snap.jobs[uid] = job.clone()
                self._incr_job_aux(snap, uid, job)
                rindex_stale |= self._incr_scalar_update(
                    ("j", uid), self._scalar_names_of(job.total_request))
            snap.jobs = {u: snap.jobs[u] for u in self.jobs
                         if u in snap.jobs}
        if rindex_stale:
            self._incr_refresh_rindex(snap)
        snap.patched_jobs = patched_jobs
        snap.patched_nodes = patched_nodes

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
        self._dirty_jobs.add(task.job)
        self._dirty_nodes.add(hostname)
        return task, task.pod

    def bind(self, task_info: TaskInfo, hostname: str) -> None:
        """Stage one task's bind in the cache, then write it to the store."""
        self.bind_batch([(task_info, hostname)], strict=True)

    def bind_batch(self, pairs, strict: bool = False) -> list:
        """Bind a gang: ``[(task_info, hostname)]`` staged in one mutex
        pass and written in one store commit. A task whose job, task or
        node lookup fails, or whose node refuses it, is skipped (with
        ``strict``, its KeyError or RuntimeError propagates). Returns the
        accepted task infos."""
        accepted, bound = [], []
        corr = f"bind-{next(self._trace_ids)}" if ledger.is_enabled() \
            else None
        t0 = time.perf_counter()
        with self.mutex:
            for task_info, hostname in pairs:
                try:
                    task, pod = self._stage_bind(task_info, hostname)
                except (KeyError, RuntimeError):
                    if strict:
                        raise
                    continue
                accepted.append(task_info)
                bound.append((task, pod, hostname))
        if corr is not None and bound:
            now = self.store.clock.now()
            ledger.defer(lambda: ledger.stamp_bulk(
                [t.key() for t, _, _ in bound], "bind_staged", now,
                trace=corr))
        self._bind_store_writes(bound, t0)
        return accepted

    def begin_commit_trace(self) -> None:
        """Start summing the commit's phases (the scheduler calls it at
        the start of a traced cycle): seconds of apply, store and echo,
        binds and echoed pairs, and the first instant."""
        self._commit_acc = [0.0, 0.0, 0.0, 0, 0, None]

    def emit_commit_spans(self) -> None:
        """Record the commit's summed phases as the cycle's bind flush
        spans (``bind_flush.apply``, then ``bind_flush.store`` with
        ``bind_flush.echo`` inside it), laid end to end from the commit's
        first instant, and stop summing; the scheduler calls it at the end
        of each traced cycle."""
        acc, self._commit_acc = self._commit_acc, None
        if acc is None or acc[5] is None:
            return
        apply_s, store_s, echo_s, binds, pairs, t0 = acc
        tracer.async_record("bind_flush.apply", t0, apply_s)
        echo = tracer.Span("bind_flush.echo", t0 + apply_s)
        echo.dur = echo_s
        echo.tags = {"pairs": pairs}
        tracer.async_record("bind_flush.store", t0 + apply_s, store_s,
                            children=[echo], binds=binds)

    def _bind_store_writes(self, bound, t0: float) -> None:
        """One binder pass + Scheduled events for [(task, pod, hostname)]
        staged since ``t0``; the store's synchronous echo confirms the
        ledger entries inside it."""
        if not bound:
            return
        t1 = time.perf_counter()
        # the store delivers the echo of these writes on this thread,
        # inside bind_batch: the hint lets update_pods_bulk tell them
        # from another writer's patches
        self._expected_bind_echo = (threading.get_ident(), {
            task.uid: (task, hostname) for task, _, hostname in bound})
        try:
            failed = self.binder.bind_batch([(pod, hostname)
                                             for _, pod, hostname in bound])
        finally:
            self._expected_bind_echo = None
        if failed:
            m.inc(m.BIND_ERRORS, float(len(failed)), reason="rejected")
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
        n = len(bound) - len(failed)
        t2 = time.perf_counter()
        acc = self._commit_acc
        if acc is not None:
            acc[0] += t1 - t0
            acc[1] += t2 - t1
            acc[3] += n
            if acc[5] is None:
                acc[5] = t0
        m.observe(m.BIND_FLUSH_LATENCY, (t2 - t1) * 1000.0)
        m.inc(m.BIND_FLUSH_BINDS, float(n))

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
            self._dirty_jobs.add(task.job)
            self._dirty_nodes.add(task.node_name)
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
                self._dirty_jobs.add(task.job)
                self._dirty_nodes.add(task.node_name)
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
        status push; its wall time is volcano_status_writeback_latency."""
        t0 = time.perf_counter()
        try:
            self._update_job_statuses(updates)
        finally:
            m.observe(m.STATUS_WRITEBACK_LATENCY,
                      (time.perf_counter() - t0) * 1000.0)

    def _update_job_statuses(self, updates) -> None:
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
