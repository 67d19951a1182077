"""SchedulerCache: watch-fed cluster state with a per-cycle snapshot
(counterpart of volcano_tpu/cache/cache.py; reference:
pkg/scheduler/cache/cache.go): watch ingestion (:84-96, Run:487), the
deep-copy snapshot (:793-882), the bind and evict executors with resync
on failure (:552-660, processResyncTask:772) and PodGroup status
writeback.

Executor model (cache.go:647-654): bind and evict change the cache's
state (task to Binding or Releasing, node accounting) and the store write
runs on one background executor thread once ``run()`` has started it,
off the scheduling cycle, with failures reconciled through the resync
queue. ``bind_batch`` and ``evict_batch`` are write-behind: the cycle
only records the gang, and the executor (or the next ``snapshot()``,
whichever comes first) applies it to the cache before the store writes
it. Consecutive gangs coalesce into one store commit (the store's
sharded ``bind_pods``), whose watch echo comes back through
``update_pods_bulk``. The executor yields to a live cycle once a cycle
(``begin_cycle``/``end_cycle``) and pauses cyclic GC for a drain burst.
Before ``run()`` the same writes run inline. Readers of the store call
``flush_executors()`` first: it waits until every submitted write ran.

Resilience (docs/design/resilience.md): a failed bind reconciles at once
through the resync queue, while a retry record holds the pod out of
placement for a seeded-jitter backoff on the store's clock
(``bind_ineligible``, read at session open); past the retry budget the
pod is quarantined until its pod object changes. A gang left below
minAvailable by failed binds has its bound siblings unbound (the heal).
With ``fence_source`` set, bind and heal writes carry the leader's
fencing token, so a deposed incarnation's writes raise FencedError in the
store. ``anti_entropy()`` fingerprints cache against store by kind and
relists what diverged (docs/design/failover.md).

With ``incremental`` on (the Scheduler's default) the snapshot is the
incremental steady-state cycle's (docs/design/incremental_cycle.md): one
persistent ClusterInfo, patched in place by re-cloning only the jobs and
nodes in the dirty sets. Every watch delta, bind and eviction marks the
sets, a closing session folds in what it mutated
(``absorb_session_touches``), and the jobs of live retry records are
re-dirtied every snapshot (their backoff ends without a watch delta).
The first snapshot, every structural change (queue, priority class,
resource quota, NUMA topology, an anti-entropy repair) and every
``INCR_FULL_RECOMPUTE_EVERY_CYCLES``-th snapshot rebuild in full.

While tracing is on the executor records the flush as the flight
recorder's async spans (``bind_flush.apply``, ``bind_flush.store`` with
the echo's ``bind_flush.echo`` inside it) and stamps the pod lifecycle
ledger (``bind_staged`` at the gang's staging instant, then
``store_committed`` at the shard's publish and ``echo_confirmed`` at the
echo); the ledger's stamps held during the cycle complete on the
executor before its own.

NUMA: the ``numatopologies`` watch feeds each node's CRD view
(``NodeInfo.numa_info``); every snapshot refreshes the nodes'
scheduler-side views from it (``refresh_numa_scheduler_info``), and the
numa-aware plugin writes the CPU sets it assigned back at session close
(``update_scheduler_numa_info``), dirtying those nodes.

Volumes: the default ``volume_binder`` is ``StoreVolumeBinder(store)``, as
in the reference: a pod whose claim matches no PV fails its staging and
stays Pending. Its PV and PVC writes carry the fencing token too (the
reference's do not). Pass ``NullVolumeBinder()`` to count every volume as
bound.

The native engine (native/fastmodel.c): while ``NATIVE_APPLY`` is on, the
default, the cross-gang bind apply is one ``bind_apply_bursts`` call, and
while ``NATIVE_ECHO`` is on (event_handlers.py) the echo of the cache's
own bind write is ingested by ``bind_echo_apply``; the pods watch
declares its filter (``filter_attr``) for the store's native
classification. The Python bodies beside them are the plain version.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional

from ..apiserver.store import ObjectStore
from ..metrics import metrics as m
from ..models import objects as obj
from ..models.arrays import ResourceIndex
from ..models.cluster_info import ClusterInfo
from ..models.job_info import (JobInfo, TaskInfo, TaskStatus, _fastmodel,
                               allocated_status, get_job_id)
from ..models.node_info import NodeInfo
from ..models.objects import (DEFAULT_QUEUE, DEFAULT_SCHEDULER_NAME,
                              PodGroupPhase, status_fingerprint)
from ..models.queue_info import NamespaceCollection, QueueInfo
from ..models.resource import CPU, EPS, MEMORY, Resource
from ..trace import ledger, pending
from ..trace import tracer
from ..utils import gcguard
from ..utils.backoff import seeded_backoff
from ..utils.fastclone import fast_clone
from .event_handlers import EventHandlersMixin
from .interface import (StoreBinder, StoreEvictor, StoreStatusUpdater,
                        StoreVolumeBinder)

log = logging.getLogger(__name__)


class _RetryRecord:
    """One pod's bind-failure history: the attempts and the store-clock
    instant before which the pod may not be placed again. Attempts reset
    only on a bind success or a pod update or delete that may change the
    outcome."""

    __slots__ = ("key", "attempts", "not_before", "job")

    def __init__(self, key: str, job: str = ""):
        self.key = key
        self.attempts = 0
        self.not_before = 0.0
        # the owning job's uid: the backoff ends with no watch delta, so
        # the incremental snapshot re-dirties the job of every live record
        self.job = job


class _BindBurst:
    """One gang's recorded bind: the write-behind apply's ``pairs`` of
    (task_info, hostname), and the accepted and bound lists filled when
    it is applied. Callable, so the apply queue runs it like any queued
    mutation; the drain coalesces consecutive bursts into one cross-gang
    pass (``_apply_bind_bursts``)."""

    __slots__ = ("cache", "pairs", "accepted", "bound", "t_staged")

    def __init__(self, cache, pairs):
        self.cache = cache
        self.pairs = pairs
        self.accepted: list = []
        self.bound: list = []
        # the ledger's staging instant (store clock): the drain stamps
        # bind_staged with it, so the staged->committed hop includes the
        # executor's queue wait
        self.t_staged = 0.0

    def __call__(self):
        self.cache._apply_bind_bursts([self])


class SchedulerCache(EventHandlersMixin):
    """The scheduler's view of the cluster, fed by store watches."""

    # every Nth incremental snapshot is a full rebuild even with nothing
    # dirty, so a dirty-tracking bug lasts at most this many cycles
    # (0 turns the cadence off)
    INCR_FULL_RECOMPUTE_EVERY_CYCLES = 64

    # how often the idle executor retries pending reconciliations (the
    # reference's processResyncTask wait.Until period)
    RESYNC_RETRY_SECONDS = 1.0

    # resync: a bind failure's re-placement backoff is base * 2^(attempt-1)
    # seconds, jittered into [0.5, 1.0) of itself by a seeded hash of
    # (pod, attempt), capped; a pod that fails RESYNC_RETRY_BUDGET times is
    # quarantined until its pod object changes or is deleted. Times come
    # from the store's clock, so a virtual clock repeats exactly.
    RESYNC_BACKOFF_BASE_SECONDS = 0.5
    RESYNC_BACKOFF_CAP_SECONDS = 30.0
    RESYNC_RETRY_BUDGET = 5
    RESYNC_JITTER_SEED = 0

    # how long the executor holds a drain back for a live cycle, once a
    # cycle: under the GIL a drain in the middle of a cycle time-slices it
    # and stretches both, so the executor waits for the cycle's end, for
    # at most this long, and then drains regardless
    CYCLE_YIELD_SECONDS = 5.0

    # the kinds the anti-entropy pass fingerprints, in repair order (pods
    # reference nodes, so nodes repair first)
    ANTI_ENTROPY_KINDS = ("nodes", "queues", "podgroups", "pods")

    # the native engine's switch for the bind apply (a class attribute, so
    # tests can force either engine; NATIVE_ECHO is the echo's)
    NATIVE_APPLY = True

    def __init__(self, store: ObjectStore,
                 scheduler_name: str = DEFAULT_SCHEDULER_NAME,
                 default_queue: str = DEFAULT_QUEUE,
                 binder=None, evictor=None, status_updater=None,
                 volume_binder=None, fence_source=None):
        self.store = store
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue
        # lease fencing: a callable returning the leader's fencing token
        # (or None); bind and heal writes carry it, so the store refuses a
        # deposed incarnation's writes. None leaves every write unstamped.
        self.fence_source = fence_source

        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.priority_classes: Dict[str, obj.PriorityClass] = {}
        self.default_priority: int = 0
        self.default_priority_class: Optional[obj.PriorityClass] = None
        self.namespace_collection: Dict[str, NamespaceCollection] = {}
        self.numatopologies: Dict[str, object] = {}
        self.node_list: List[str] = []

        self.binder = binder if binder is not None else StoreBinder(store)
        self.evictor = evictor if evictor is not None \
            else StoreEvictor(store)
        self.status_updater = (status_updater if status_updater is not None
                               else StoreStatusUpdater(store))
        self.volume_binder = volume_binder if volume_binder is not None \
            else StoreVolumeBinder(store, fence_source=self._current_fence)

        self.mutex = threading.RLock()
        self.err_tasks: deque = deque()      # resync queue (cache.go:116)
        # bind failures reconcile at once through err_tasks, while these
        # records, keyed by pod key, gate when the pod may be placed again
        self.retry_records: Dict[str, _RetryRecord] = {}
        self.quarantined: Dict[str, str] = {}    # key -> reason
        self.resync_retry_total = 0              # bind failures, lifetime
        # per-task bind commits in flight, by job uid: {"gen": cycle
        # generation, "ok": [(task, pod, hostname)] committed, "failed":
        # count}. A heal reads it after a partial failure; it is dropped
        # once enough commits landed and discarded after one generation,
        # so a later failure never unbinds an earlier dispatch's pods.
        self._single_bind_state: Dict[str, dict] = {}
        # per-task heals held for the flush barrier in inline mode: a heal
        # in the middle of a dispatch would unbind siblings whose gang
        # mates have not even staged
        self._deferred_heals: list = []
        self._watches: list = []
        self._running = False
        # the executor: a FIFO of store writes, so a bind and a later
        # evict of one pod run in order
        self._exec_queue: deque = deque()
        self._exec_lock = threading.Lock()
        self._exec_event = threading.Event()
        self._exec_idle = threading.Event()
        self._exec_idle.set()
        self._exec_thread: Optional[threading.Thread] = None
        self._exec_stop = False
        # write-behind cache mutations, run once each in submission order
        # under self.mutex, on the executor or at the next snapshot()
        self._pending_apply: deque = deque()
        self._apply_lock = threading.Lock()
        # recorded gangs waiting for one drain: a single store commit and
        # one bulk echo for every gang recorded by the drain's run time
        self._pending_binds: list = []
        self._bind_drain_queued = False
        # the flush correlation sequence ("bind-N", per cache)
        self._flush_seq = 0
        # cleared while a cycle is in flight (see CYCLE_YIELD_SECONDS)
        self._cycle_idle = threading.Event()
        self._cycle_idle.set()
        self._cycle_gen = 0
        # the full snapshot's clone, built by the executor between cycles
        # and used when nothing changed since (_state_version)
        self._state_version = 0
        self._prebuilt: Optional[tuple] = None
        # wall ms of the last snapshot (read by the cycle's timing split)
        self.last_snapshot_ms = 0.0
        # pods handed to the evictor since the cache was built
        self.evictions = 0
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
        # update_pods_bulk knows their echoes and does not dirty for them.
        # The echo worker delivers on the writer's behalf
        # (store.delivery_origin), so the key is the writing thread.
        self._expected_bind_echo: Optional[tuple] = None
        self.anti_entropy_state: Optional[dict] = None

    # -- lifecycle ---------------------------------------------------------

    def _responsible_for(self, pod: obj.Pod) -> bool:
        """Only pods targeted at this scheduler (cache.go responsibleForPod)."""
        return pod.spec.scheduler_name == self.scheduler_name

    def run(self) -> None:
        """Start the executor and subscribe all watches, replaying
        existing objects (informer list+watch; cache.go:487-507)."""
        if self._running:
            return
        self._running = True
        self.start_executors()
        s = self.store

        def locked(fn):
            def wrapper(*args):
                with self.mutex:
                    self._state_version += 1
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
                    on_bulk_update=self.update_pods_bulk,
                    filter_attr=(("spec", "scheduler_name"),
                                 self.scheduler_name)),
            s.watch("priorityclasses", locked(self.add_priority_class),
                    locked(self.update_priority_class),
                    locked(self.delete_priority_class)),
            s.watch("resourcequotas", locked(self.add_resource_quota),
                    locked(self.update_resource_quota),
                    locked(self.delete_resource_quota)),
            s.watch("numatopologies", locked(self.add_numa_info),
                    locked(self.update_numa_info),
                    locked(self.delete_numa_info)),
        ]

    def stop(self) -> None:
        """Unsubscribe the watches and stop the executor: it runs what was
        already submitted, then exits (waited for up to 5 s); later
        writes run inline."""
        for w in self._watches:
            self.store.unwatch(w)
        self._watches = []
        self._running = False
        self._exec_stop = True
        self._exec_event.set()
        if self._exec_thread is not None:
            self._exec_thread.join(timeout=5.0)
            self._exec_thread = None

    def wait_for_cache_sync(self) -> bool:
        return self._running  # synchronous watches: synced once run

    def client(self) -> ObjectStore:
        """The plugins'/actions' handle to the API (Cache.Client analogue)."""
        return self.store

    # -- the executor (cache.go:647-654's goroutines) ------------------------

    def _submit(self, fn) -> None:
        with self._exec_lock:
            if self._exec_thread is not None:
                self._exec_queue.append(fn)
                self._exec_idle.clear()
                self._exec_event.set()
                return
        fn()   # inline mode (no worker started): run now

    def submit_background(self, fn) -> None:
        """Run fn on the executor (inline before run()), in FIFO order
        with the binds it follows: the session's PodGroup status
        writeback goes this way, off the cycle."""
        self._submit(fn)

    def _exec_loop(self) -> None:
        last_yield_gen = -1
        gc_paused = False
        while True:
            # while reconciliations or parked heals are pending, wake
            # periodically without a new submission (cache.go:772-791
            # runs resync on its own loop)
            self._exec_event.wait(
                timeout=self.RESYNC_RETRY_SECONDS
                if (self.err_tasks or self._deferred_heals) else None)
            try:
                while True:
                    with self._exec_lock:
                        fn = self._exec_queue.popleft() if self._exec_queue \
                            else None
                    if fn is None:
                        # drained: run the heals parked by per-task bind
                        # failures, but only with no cycle in flight (a
                        # dispatch cannot straddle the cycle's end, so
                        # this is the first point its gang's outcome is
                        # complete)
                        if self._deferred_heals and \
                                self._cycle_idle.is_set():
                            self._run_deferred_heals()
                        # then reconcile failed binds and evicts, while
                        # the passes make progress
                        before = len(self.err_tasks)
                        if before:
                            self.process_resync_tasks()
                        if self.err_tasks and len(self.err_tasks) < before:
                            continue
                        with self._exec_lock:
                            if not self._exec_queue:
                                self._exec_event.clear()
                                self._exec_idle.set()
                                break
                        continue
                    if not gc_paused:
                        # pause cyclic GC for the drain burst, as run_once
                        # does for the cycle: the burst's garbage is
                        # acyclic
                        gc_paused = True
                        gcguard.pause()
                    # yield to a live cycle, once a cycle generation
                    if not self._cycle_idle.is_set():
                        gen = self._cycle_gen
                        if gen != last_yield_gen:
                            self._cycle_idle.wait(
                                timeout=self.CYCLE_YIELD_SECONDS)
                            last_yield_gen = gen
                    try:
                        fn()   # submitted fns resync their own errors
                    except Exception:
                        # an escaped error must not kill the worker: every
                        # later bind and evict would queue forever
                        log.exception("cache executor task failed")
            finally:
                # any exit from the drain releases the GC pause
                if gc_paused:
                    gc_paused = False
                    gcguard.resume()
            if self._exec_stop:
                return

    def start_executors(self) -> None:
        """Start the bind/evict executor thread (live mode)."""
        with self._exec_lock:
            if self._exec_thread is not None:
                return
            self._exec_stop = False
            self._exec_thread = threading.Thread(
                target=self._exec_loop, daemon=True, name="cache-executor")
            self._exec_thread.start()

    def begin_cycle(self) -> None:
        """Mark a scheduling cycle in flight: the executor holds its drain
        back (see CYCLE_YIELD_SECONDS)."""
        self._cycle_gen += 1
        self._cycle_idle.clear()
        if self._single_bind_state:
            # retire per-task dispatch records no heal will read (their
            # dispatch ended more than a generation ago)
            with self.mutex:
                stale = [k for k, st in self._single_bind_state.items()
                         if st["gen"] < self._cycle_gen - 1]
                for k in stale:
                    del self._single_bind_state[k]

    def end_cycle(self) -> None:
        self._cycle_idle.set()
        # rebuild the full snapshot's clone between cycles, after the
        # executor drains this cycle's binds; the incremental snapshot
        # patches on the cycle's thread instead
        if self._exec_thread is not None and not self.incremental:
            self._submit(self._prebuild_snapshot)

    def _prebuild_snapshot(self) -> None:
        if self.incremental or not self._cycle_idle.is_set():
            # a cycle already in flight would invalidate the clone; the
            # next end_cycle submits again
            return
        t0 = time.perf_counter()
        with self.mutex:
            self._drain_applies_locked()
            self._prebuilt = (self._state_version, self._snapshot_locked())
        m.observe(m.SNAPSHOT_PREBUILD_LATENCY,
                  (time.perf_counter() - t0) * 1000.0)

    def flush_executors(self, timeout: float = 30.0) -> bool:
        """Wait until every submitted bind, evict and status write has run
        (False on timeout); then complete the ledger's held stamps. In
        inline mode this is also where the heals parked by per-task bind
        failures run: in the middle of a dispatch the gang's outcome is
        not known yet."""
        with self._exec_lock:
            worker_live = self._exec_thread is not None
        if not worker_live:
            self._run_deferred_heals()
            ledger.complete_deferred()
            return True
        done = self._exec_idle.wait(timeout)
        ledger.complete_deferred()
        return done

    def _run_deferred_heals(self) -> None:
        while True:
            with self.mutex:
                if not self._deferred_heals:
                    return
                task = self._deferred_heals.pop(0)
            self._heal_gang_of(task)

    # -- write-behind applies ----------------------------------------------

    def _queue_apply(self, fn) -> bool:
        """Queue a cache mutation for write-behind; False in inline mode
        (the caller then runs it at once)."""
        with self._exec_lock:
            if self._exec_thread is None:
                return False
        with self._apply_lock:
            self._pending_apply.append(fn)
        return True

    def _drain_applies_locked(self) -> None:
        """Run every pending write-behind mutation; the caller holds
        ``self.mutex``, so a drain that finds the queue empty knows every
        earlier apply has completed. A run of consecutive bind bursts
        applies as one cross-gang pass; any other entry (an evict) ends
        the run, so no bind moves across a later evict."""
        while True:
            bursts = None
            with self._apply_lock:
                if not self._pending_apply:
                    return
                fn = self._pending_apply.popleft()
                if isinstance(fn, _BindBurst):
                    bursts = [fn]
                    while self._pending_apply and isinstance(
                            self._pending_apply[0], _BindBurst):
                        bursts.append(self._pending_apply.popleft())
            self._state_version += 1
            if bursts is not None:
                self._apply_bind_bursts(bursts)
            else:
                fn()

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> ClusterInfo:
        """Deep copy of the whole state (cache.go:793-882): only Ready
        nodes; only jobs with a PodGroup and an existing queue; job
        priority resolved from PriorityClass here. Pending write-behind
        applies run first. With ``incremental`` on, the persistent
        snapshot patched by the dirty sets, equal in content and order to
        this full rebuild."""
        t0 = time.perf_counter()
        with self.mutex:
            self._drain_applies_locked()
            if self.incremental:
                snap = self._incr_snapshot_locked()
            else:
                # the dirty sets are consumed (kept bounded) even though
                # the rebuild does not read them
                self._dirty_jobs.clear()
                self._dirty_nodes.clear()
                self._dirty_structural = False
                self._incr_snap = None
                pre, self._prebuilt = self._prebuilt, None
                if pre is not None and pre[0] == self._state_version:
                    snap = pre[1]
                else:
                    snap = self._snapshot_locked()
        self.last_snapshot_ms = (time.perf_counter() - t0) * 1000.0
        return snap

    def _snapshot_locked(self) -> ClusterInfo:
        """The full rebuild; the caller holds the mutex."""
        snap = ClusterInfo()
        snap.node_list = list(self.node_list)
        for node in self.nodes.values():
            node.refresh_numa_scheduler_info()
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
        re-resolve every job; NUMA topology feeds every node's scheduler
        view)."""
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
        # a bind backoff ends with no watch delta: the jobs of live retry
        # records re-enter the working set every cycle, so their
        # eligibility is read again on time
        for rec in self.retry_records.values():
            if rec.job:
                self._dirty_jobs.add(rec.job)
        self._prebuilt = None
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
                node.refresh_numa_scheduler_info()
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

    def _current_fence(self):
        """The fencing token for leader-scoped writes (None without
        fencing), read for each write batch: a token that went stale in
        flight is just what the store must see."""
        if self.fence_source is None:
            return None
        try:
            return self.fence_source()
        except Exception:
            return None

    def _next_trace(self) -> str:
        """The next flush correlation ID (a plain per-cache counter)."""
        with self._apply_lock:
            self._flush_seq += 1
            return f"bind-{self._flush_seq}"

    def _stamp_binder(self, trace) -> None:
        """Give the binder this batch's fencing token and correlation ID
        (attributes, so a binder subclass keeps its own signatures)."""
        fence = self._current_fence()
        if fence is not None:
            self.binder.fence = fence
        self.binder.trace = trace

    def _find_job_and_task(self, task_info: TaskInfo):
        job = self.jobs.get(task_info.job)
        if job is None:
            raise KeyError(f"failed to find job <{task_info.job}>")
        task = job.tasks.get(task_info.uid)
        if task is None:
            raise KeyError(f"failed to find task <{task_info.uid}>")
        return job, task

    def bind(self, task_info: TaskInfo, hostname: str) -> None:
        """Mark the task Binding in the cache and add it to its node, then
        write the bind on the executor (cache.go:605-655); a failed write
        reconciles through the resync queue."""
        with self.mutex:
            self._state_version += 1
            job, task = self._find_job_and_task(task_info)
            node = self.nodes.get(hostname)
            if node is None:
                raise KeyError(f"failed to bind Task {task.uid} to host "
                               f"{hostname}, host does not exist")
            original = task.status
            job.update_task_status(task, TaskStatus.Binding)
            try:
                node.add_task(task)
            except RuntimeError:
                job.update_task_status(task, original)
                raise
            self._dirty_jobs.add(task.job)
            self._dirty_nodes.add(hostname)
            pod = task.pod
        corr = None
        if ledger.is_enabled():
            corr = self._next_trace()
            now = self.store.clock.now()
            ledger.defer(lambda: ledger.stamp(task.key(), "bind_staged", now,
                                              job=task.job, trace=corr))

        def do_bind():
            if corr is not None:
                # the cycle's held stamps land first, then this pod's
                ledger.complete_deferred()
            try:
                self._stamp_binder(corr)
                self.binder.bind(pod, hostname)
                self.store.record_event(
                    "pods", pod, "Normal", "Scheduled",
                    f"Successfully assigned {task.namespace}/{task.name} "
                    f"to {hostname}")
            except Exception as e:
                log.warning("bind of pod %s to %s failed: %s; scheduling "
                            "resync", pod.metadata.key(), hostname, e)
                m.inc(m.BIND_ERRORS, reason=type(e).__name__)
                self._record_bind_failure(task, str(e))
                self.resync_task(task)
                # the session dispatches a ready gang as one bind() a
                # task, so the heal waits for a point where the dispatch
                # has ended (the drained executor with no cycle in flight,
                # or flush_executors() in inline mode)
                with self.mutex:
                    st = self._single_bind_record(task.job)
                    st["failed"] += 1
                    self._deferred_heals.append(task)
                return
            if corr is not None:
                # a no-op when the synchronous echo already confirmed it
                ledger.stamp(task.key(), "store_committed",
                             self.store.clock.now(), trace=corr)
            self._clear_bind_successes([(task, pod, hostname)])
            with self.mutex:
                st = self._single_bind_record(task.job)
                st["ok"].append((task, pod, hostname))
                j = self.jobs.get(task.job)
                if j is not None and \
                        len(st["ok"]) >= max(1, j.min_available):
                    # the gang committed on its own: nothing to heal
                    self._single_bind_state.pop(task.job, None)
        self._submit(do_bind)

    def _single_bind_record(self, job_uid: str) -> dict:
        """The job's per-task dispatch record, fenced by generation (the
        caller holds ``self.mutex``): a record older than one generation
        belongs to another commit and starts over. Its birth generation is
        not refreshed on use, so a job topped up every cycle cannot gather
        commits for one late failure to unbind."""
        st = self._single_bind_state.get(job_uid)
        if st is None or st["gen"] < self._cycle_gen - 1:
            st = self._single_bind_state[job_uid] = {
                "gen": self._cycle_gen, "ok": [], "failed": 0}
        return st

    def bind_batch(self, pairs) -> list:
        """Bind a gang, ``[(task_info, hostname)]``, with one executor
        submission (the per-gang form of :meth:`bind`).

        Write-behind: with a live executor the call only records the
        pairs; the cache's task moves and node accounting run on the
        executor before the store writes, or at the next ``snapshot()``.
        The return is then every task (optimistic): a task whose pod went
        away in the meantime is skipped at apply time and reconverges from
        the store. In inline mode (no worker) it applies and writes at
        once and returns the accepted tasks."""
        pairs = list(pairs)
        if not pairs:
            return []
        burst = _BindBurst(self, pairs)
        if ledger.is_enabled():
            burst.t_staged = self.store.clock.now()
        with self._exec_lock:
            worker_live = self._exec_thread is not None
        if worker_live:
            # one lock pass records both the apply and the gang, so the
            # drain's apply drain covers every gang it pops
            with self._apply_lock:
                self._pending_apply.append(burst)
                self._pending_binds.append(burst)
                need_drain = not self._bind_drain_queued
                self._bind_drain_queued = True
            if need_drain:
                self._submit(self._drain_binds)
            return [t for t, _ in pairs]
        with self.mutex:
            self._state_version += 1
            burst()
        corr = None
        if ledger.is_enabled():
            ledger.complete_deferred()
            corr = self._next_trace()
            ledger.stamp_bulk([t.key() for t, _, _ in burst.bound],
                              "bind_staged", burst.t_staged, trace=corr)
        self._bind_store_writes(burst.bound, trace=corr)
        return list(burst.accepted)

    def _apply_bind_one(self, burst: _BindBurst, task_info, hostname) -> None:
        """The per-task bind apply, where a burst item's job, task or node
        lookup failed: skips or rolls back exactly the affected task."""
        try:
            job, task = self._find_job_and_task(task_info)
        except KeyError:
            return
        node = self.nodes.get(hostname)
        if node is None:
            return
        original = task.status
        job.move_task_status(task, TaskStatus.Binding)
        try:
            node.add_task(task)
        except RuntimeError:
            job.move_task_status(task, original)
            return
        self._dirty_jobs.add(task.job)
        self._dirty_nodes.add(hostname)
        burst.accepted.append(task_info)
        burst.bound.append((task, task.pod, hostname))

    def _apply_bind_bursts(self, bursts) -> None:
        """The cross-gang bind apply (the caller holds ``self.mutex``): one
        status move a job and one accounting pass a node over a run of
        bursts (a 50,000-bind flush lands about 5 tasks a node across
        6,250 gangs). A lookup miss or a refused fit falls back to the
        per-task path for exactly the items affected. Each burst's
        accepted and bound lists fill in (job group, node group) order,
        both in input order.

        On the native engine the whole pass is one ``bind_apply_bursts``
        call; it checks everything first and, on any irregular shape,
        returns False with nothing changed, and this body runs."""
        if self.NATIVE_APPLY and _fastmodel().bind_apply_bursts(
                list(bursts), self.jobs, self.nodes, self._dirty_jobs,
                self._dirty_nodes, TaskStatus.Binding, EPS):
            return
        by_job: Dict[str, list] = {}
        for burst in bursts:
            for task_info, hostname in burst.pairs:
                by_job.setdefault(task_info.job, []).append(
                    (burst, task_info, hostname))
        self._dirty_jobs.update(by_job)
        by_node: Dict[str, list] = {}
        for jid, items in by_job.items():
            job = self.jobs.get(jid)
            stored = None
            if job is not None:
                stored = [job.tasks.get(t.uid) for _, t, _ in items]
            if job is None or any(s is None for s in stored) or \
                    any(self.nodes.get(h) is None for _, _, h in items):
                for burst, task_info, hostname in items:
                    self._apply_bind_one(burst, task_info, hostname)
                continue
            originals = [s.status for s in stored]
            job.move_tasks_status_bulk(stored, TaskStatus.Binding)
            for (burst, task_info, hostname), s, orig in zip(items, stored,
                                                             originals):
                by_node.setdefault(hostname, []).append(
                    (burst, task_info, s, orig, job))
        self._dirty_nodes.update(by_node)
        for hostname, node_items in by_node.items():
            node = self.nodes[hostname]
            try:
                node.add_tasks_bulk([s for _, _, s, _, _ in node_items],
                                    pipelined=False)
            except RuntimeError:
                # the combined fit was refused (drifted accounting):
                # replay per task so the fitting prefix still lands
                for burst, task_info, s, orig, job in node_items:
                    try:
                        node.add_task(s)
                    except RuntimeError:
                        job.move_task_status(s, orig)
                        continue
                    burst.accepted.append(task_info)
                    burst.bound.append((s, s.pod, hostname))
                continue
            for burst, task_info, s, orig, job in node_items:
                burst.accepted.append(task_info)
                burst.bound.append((s, s.pod, hostname))

    def _drain_binds(self) -> None:
        """The executor's half of the coalesced bind flush: pop the
        recorded gangs, drain the pending applies (they order before the
        store writes), then write every gang in one store commit (the
        store's sharded pipeline; its per-shard echoes come back through
        ``update_pods_bulk``)."""
        with self._apply_lock:
            bursts, self._pending_binds = self._pending_binds, []
            self._bind_drain_queued = False
        t0 = time.perf_counter()
        with tracer.async_span("bind_flush.apply"):
            with self.mutex:
                self._drain_applies_locked()
        bound = [x for b in bursts for x in b.bound]
        if not bound:
            return
        corr = None
        if ledger.is_enabled():
            # the cycle's held stamps land before this flush's; one
            # correlation ID a flush, each burst stamped at its own
            # staging instant
            ledger.complete_deferred()
            corr = self._next_trace()
            ledger.stamp_runs(
                [([t.key() for t, _, _ in b.bound], b.t_staged)
                 for b in bursts], "bind_staged", trace=corr)
        with tracer.async_span("bind_flush.store", binds=len(bound)):
            self._bind_store_writes(bound, trace=corr)
        m.observe(m.BIND_FLUSH_LATENCY, (time.perf_counter() - t0) * 1000.0)
        m.inc(m.BIND_FLUSH_BINDS, float(len(bound)))

    def _bind_store_writes(self, bound, trace=None) -> None:
        """One binder pass and the Scheduled events for [(task, pod,
        hostname)]; failures go to the resync queue with retry
        accounting, and a gang they leave partly bound is healed (its
        bound siblings unbound) before anything else sees the commit
        (cache.go:605-655). ``trace`` stamps the store writes and the
        pods' ledger entries."""
        if not bound:
            return
        self._stamp_binder(trace)
        # deliveries of this commit, on this thread or on the echo worker
        # for it, are our own writes: update_pods_bulk skips its change
        # checks for them
        self._expected_bind_echo = (threading.get_ident(), {
            task.uid: (task, hostname) for task, _, hostname in bound})
        try:
            missing = self.binder.bind_batch([(pod, hostname)
                                              for _, pod, hostname in bound])
        except Exception as e:
            log.warning("batch bind of %d pods failed: %s; scheduling "
                        "resync", len(bound), e)
            m.inc(m.BIND_ERRORS, float(len(bound)), reason=type(e).__name__)
            for task, _, _ in bound:
                self._record_bind_failure(task, str(e))
                self.resync_task(task)
            return
        finally:
            self._expected_bind_echo = None
        gone = {id(pod) for pod, _ in missing}
        ok = bound
        if gone:
            failed = [b for b in bound if id(b[1]) in gone]
            ok = [b for b in bound if id(b[1]) not in gone]
            m.inc(m.BIND_ERRORS, float(len(failed)), reason="rejected")
            for task, pod, hostname in failed:
                log.warning("bind of pod %s to %s failed (binder rejected "
                            "or pod gone); scheduling resync",
                            pod.metadata.key(), hostname)
                self._record_bind_failure(task, "bind rejected")
                self.resync_task(task)
            ok = self._heal_partial_gangs(ok, failed)
        if trace is not None and ok:
            ledger.stamp_bulk([t.key() for t, _, _ in ok], "store_committed",
                              self.store.clock.now(), trace=trace)
        self._clear_bind_successes(ok)
        # the store's event deque is bounded: skip the messages its append
        # would evict at once
        for task, pod, hostname in ok[-self.store.EVENTS_CAPACITY:]:
            self.store.record_event(
                "pods", pod, "Normal", "Scheduled",
                f"Successfully assigned {task.namespace}/{task.name} "
                f"to {hostname}")

    # -- gang-atomic healing -------------------------------------------------

    def _heal_partial_gangs(self, bound_ok, failed) -> list:
        """When this flush's failures leave a gang bound below
        ``min_available``, unbind its bound siblings (a store patch
        clearing ``node_name``, whose echo rolls back the node accounting)
        and resync the gang as a unit. Returns the bound entries that
        survive (an elastic job still at or above min_available without
        the failed pods keeps them)."""
        fail_count: Dict[str, int] = {}
        for task, _, _ in failed:
            fail_count[task.job] = fail_count.get(task.job, 0) + 1
        heal_jobs = set()
        with self.mutex:
            for jid, f in fail_count.items():
                job = self.jobs.get(jid)
                if job is None or job.min_available <= 0:
                    continue
                alloc = sum(len(tasks) for st, tasks
                            in job.task_status_index.items()
                            if allocated_status(st))
                # the failed tasks still sit in Binding (their reconcile
                # is queued behind this call): without them the job keeps
                # alloc - f allocated tasks
                if 0 < alloc - f < job.min_available:
                    heal_jobs.add(jid)
        if not heal_jobs:
            return bound_ok
        unbind = [b for b in bound_ok if b[0].job in heal_jobs]
        if not unbind:
            return bound_ok
        log.warning("gang-atomic heal: unbinding %d bound sibling(s) of %d "
                    "partially bound gang(s)", len(unbind), len(heal_jobs))
        m.inc(m.GANG_HEALS, float(len(heal_jobs)))
        self._unbind_bound(unbind)
        return [b for b in bound_ok if b[0].job not in heal_jobs]

    def _unbind_bound(self, unbind) -> None:
        """Unbind [(task, pod, hostname)]: one store patch clearing
        ``node_name``, a GangUnbound event a pod, and a resync so the gang
        reconciles as a unit; no retry attempt is charged to these pods
        (their binds succeeded)."""
        def clear_node(p):
            p.spec.node_name = ""

        self.store.patch_batch(
            "pods", [(pod.metadata.name, pod.metadata.namespace, clear_node)
                     for _, pod, _ in unbind], fence=self._current_fence())
        for task, pod, hostname in unbind:
            self.store.record_event(
                "pods", pod, "Warning", "GangUnbound",
                f"unbound from {hostname}: a sibling bind failure broke "
                f"gang atomicity; the gang will be re-placed as a unit")
            # the bind's echo already confirmed the pod's entry: its
            # lifecycle restarts so the re-placement is tracked
            ledger.reopen(task.key(), "healed", self.store.clock.now())
            self.resync_task(task)

    def _heal_gang_of(self, task_info: TaskInfo) -> None:
        """The heal of the per-task bind path, once the gang's commit
        outcome is known: unbind the dispatch's recorded sibling successes
        when the job is left bound below ``min_available``."""
        with self.mutex:
            st = self._single_bind_state.pop(task_info.job, None)
            if st is None or st["gen"] < self._cycle_gen - 1:
                return   # another, long-gone dispatch's record
            unbind, f = st["ok"], st["failed"]
            job = self.jobs.get(task_info.job)
            if job is None or job.min_available <= 0:
                return
            alloc = sum(len(tasks) for s, tasks
                        in job.task_status_index.items()
                        if allocated_status(s))
            if not (0 < alloc - f < job.min_available):
                return
        if not unbind:
            return
        log.warning("gang-atomic heal: unbinding %d bound sibling(s) of "
                    "partially bound gang %s", len(unbind), task_info.job)
        m.inc(m.GANG_HEALS)
        self._unbind_bound(unbind)

    # -- evictions ---------------------------------------------------------

    def evict(self, task_info: TaskInfo, reason: str) -> None:
        """Mark the cache's task Releasing and update its node's
        accounting, then delete the pod through the evictor on the
        executor (cache.go:552-601)."""
        with self.mutex:
            self._state_version += 1
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
        staged = [(task, task.pod, job.pod_group, reason)]
        self._submit(lambda: self._evict_store_writes(staged))

    def evict_batch(self, items) -> None:
        """Evict ``[(task_info, reason)]`` in order with one executor
        submission (the per-statement form of :meth:`evict`). A task whose
        job, task or node lookup fails is skipped, as the per-task path
        skips its KeyError; one whose node refuses the flip is rolled back
        and resynced. Write-behind like :meth:`bind_batch`."""
        items = list(items)
        if not items:
            return
        staged: list = []

        def apply():
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
                    # the node refused the flip (drifted accounting): the
                    # session already assumes this eviction, so reconcile
                    # from the store rather than skip it silently
                    job.move_task_status(task, original)
                    log.exception("evict_batch: node accounting rejected "
                                  "%s; scheduling resync", task.uid)
                    self.resync_task(task)
                    continue
                self._dirty_jobs.add(task.job)
                self._dirty_nodes.add(task.node_name)
                staged.append((task, task.pod, job.pod_group, reason))

        def do_evict_all():
            with self.mutex:
                self._drain_applies_locked()
            self._evict_store_writes(staged)

        if self._queue_apply(apply):
            self._submit(do_evict_all)
            return
        with self.mutex:
            self._state_version += 1
            apply()
        self._evict_store_writes(staged)

    def _evict_store_writes(self, staged) -> None:
        """The evictor's pod deletes and the PodGroups' Evict events for
        ``[(task, pod, pod_group, reason)]``; a failed delete resyncs the
        task."""
        for task, pod, pod_group, reason in staged:
            self.evictions += 1
            try:
                self.evictor.evict(pod, reason)
            except Exception:
                self.resync_task(task)
            if pod_group is not None:
                self.store.record_event("podgroups", pod_group, "Normal",
                                        "Evict", reason)

    # -- resync (cache.go:768-791) ----------------------------------------

    def resync_task(self, task: TaskInfo) -> None:
        self.err_tasks.append(task)

    def _backoff_seconds(self, key: str, attempts: int) -> float:
        """The re-placement backoff after the Nth bind failure of a pod,
        fixed for a given (key, attempt, seed)."""
        return seeded_backoff(key, attempts, self.RESYNC_BACKOFF_BASE_SECONDS,
                              self.RESYNC_BACKOFF_CAP_SECONDS,
                              seed=self.RESYNC_JITTER_SEED)

    def _record_bind_failure(self, task: TaskInfo, reason: str) -> None:
        """Bump the pod's retry record: set its re-placement backoff or,
        past the retry budget, quarantine it (a store event and
        ``volcano_quarantined_tasks``). The caller still queues the
        immediate reconcile (resync_task): backoff gates placement, never
        the cache's convergence with the store."""
        key = task.key()
        quarantine_msg = None
        with self.mutex:
            self.resync_retry_total += 1
            if key in self.quarantined:
                return
            rec = self.retry_records.get(key)
            if rec is None:
                rec = self.retry_records[key] = _RetryRecord(key, task.job)
            rec.attempts += 1
            if rec.attempts >= self.RESYNC_RETRY_BUDGET:
                del self.retry_records[key]
                quarantine_msg = (
                    f"bind retry budget ({self.RESYNC_RETRY_BUDGET}) "
                    f"exhausted after {rec.attempts} attempts; last "
                    f"failure: {reason}")
                self.quarantined[key] = quarantine_msg
                n_quarantined = len(self.quarantined)
            else:
                rec.not_before = self.store.clock.now() + \
                    self._backoff_seconds(key, rec.attempts)
        m.inc(m.RESYNC_RETRIES)
        ledger.detour(key, "quarantined" if quarantine_msg is not None
                      else "retry")
        if quarantine_msg is not None:
            m.set_gauge(m.QUARANTINED_TASKS, float(n_quarantined))
            self.store.record_event("pods", task.pod, "Warning",
                                    "BindQuarantined", quarantine_msg)
            log.warning("quarantining pod %s: %s", key, quarantine_msg)

    def _clear_bind_retry_state(self, key: str) -> None:
        """Forget a pod's failure history (a bind success, or a pod update
        or delete that may change the outcome); the caller holds
        ``self.mutex``."""
        self.retry_records.pop(key, None)
        if self.quarantined.pop(key, None) is not None:
            m.set_gauge(m.QUARANTINED_TASKS, float(len(self.quarantined)))

    def _clear_bind_successes(self, bound_ok) -> None:
        """Successful binds reset their pods' retry records."""
        if not self.retry_records:
            return
        with self.mutex:
            for task, _, _ in bound_ok:
                self.retry_records.pop(task.key(), None)

    def bind_ineligible(self) -> Dict[str, str]:
        """Pod keys that may not be placed now, each with its reason:
        quarantined pods and pods inside their backoff window. Read into
        the session at open (``ssn.ineligible_binds``): the placing
        actions skip them and the why-pending report shows why."""
        if not self.retry_records and not self.quarantined:
            return {}
        now = self.store.clock.now()
        out: Dict[str, str] = {}
        with self.mutex:
            for key in self.quarantined:
                out[key] = pending.REASON_QUARANTINED
            for key, rec in self.retry_records.items():
                if rec.not_before > now:
                    out.setdefault(key, f"{pending.REASON_BIND_BACKOFF} "
                                        f"(attempt {rec.attempts})")
        return out

    def process_resync_tasks(self) -> None:
        """Refetch each errored pod from the store and reconcile the
        cache; a task whose reconcile fails goes back on the queue
        (cache.go:781-787)."""
        for _ in range(len(self.err_tasks)):
            task = self.err_tasks.popleft()
            try:
                self.sync_task(task)
            except Exception:
                log.exception("resync of task %s failed; requeued", task.uid)
                self.err_tasks.append(task)

    def sync_task(self, old_task: TaskInfo) -> None:
        """Rebuild one task from the store's pod."""
        pod = self.store.get("pods", old_task.name, old_task.namespace)
        with self.mutex:
            self._state_version += 1
            if pod is None:
                # a failure recorded after the pod's delete echo must not
                # leak its retry record
                self._clear_bind_retry_state(old_task.key())
                ledger.drop(old_task.key())
                self._delete_task(old_task)
                return
            new_task = TaskInfo(pod)
            self._delete_task(old_task)
            try:
                self._add_task(new_task)
            except KeyError:
                self.err_tasks.append(new_task)

    # -- anti-entropy (docs/design/failover.md) ----------------------------

    def _anti_entropy_views(self, kind: str):
        """(store view, cache view) as {key: (rv, obj)} for one kind: the
        store's own objects (no clones) against the cache's maps. Pods are
        this scheduler's pods with a PodGroup link, what the watch puts in
        ``jobs``. The caller holds ``self.mutex`` with applies drained."""
        store_view: Dict[str, tuple] = {}
        cache_view: Dict[str, tuple] = {}
        refs = self.store.list_refs(kind)
        if kind == "pods":
            for p in refs:
                if self._responsible_for(p) and get_job_id(p):
                    store_view[p.metadata.key()] = (
                        p.metadata.resource_version, p)
            for job in self.jobs.values():
                for t in job.tasks.values():
                    cache_view[t.key()] = (t.pod.metadata.resource_version,
                                           t.pod)
        elif kind == "nodes":
            for n in refs:
                store_view[n.metadata.name] = (n.metadata.resource_version,
                                               n)
            for name, node in self.nodes.items():
                cache_view[name] = (node.node.metadata.resource_version,
                                    node.node)
        elif kind == "queues":
            for q in refs:
                store_view[q.metadata.name] = (q.metadata.resource_version,
                                               q)
            for name, qi in self.queues.items():
                cache_view[name] = (qi.queue.metadata.resource_version,
                                    qi.queue)
        elif kind == "podgroups":
            for pg in refs:
                store_view[pg.metadata.key()] = (
                    pg.metadata.resource_version, pg)
            for job in self.jobs.values():
                if job.pod_group is not None:
                    cache_view[job.pod_group.metadata.key()] = (
                        job.pod_group.metadata.resource_version,
                        job.pod_group)
        else:
            raise ValueError(f"anti-entropy does not cover kind {kind!r}")
        return store_view, cache_view

    @staticmethod
    def _fingerprint(view: Dict[str, tuple]) -> tuple:
        """(count, max rv, crc32 of the sorted key@rv lines): any missed,
        extra or stale object changes it."""
        crc = 0
        max_rv = 0
        for key in sorted(view):
            rv = view[key][0]
            crc = zlib.crc32(f"{key}@{rv}\n".encode(), crc)
            if rv > max_rv:
                max_rv = rv
        return (len(view), max_rv, crc)

    def _repair_kind(self, kind: str, store_view, cache_view) -> int:
        """Relist one diverged kind through the handlers a live watch
        calls: adds for misses, deletes for strays, re-ingest for stale
        versions, keys in sorted order. The caller holds ``self.mutex``."""
        add_fn, update_fn, delete_fn = {
            "pods": (self.add_pod, self.update_pod, self.delete_pod),
            "nodes": (self.add_node, self.update_node, self.delete_node),
            "queues": (self.add_queue, self.update_queue, self.delete_queue),
            "podgroups": (self.add_pod_group, self.update_pod_group,
                          self.delete_pod_group),
        }[kind]
        repaired = 0
        for key in sorted(set(cache_view) - set(store_view)):
            try:
                delete_fn(cache_view[key][1])
                repaired += 1
            except KeyError:
                pass
        for key in sorted(store_view):
            rv, ref = store_view[key]
            cached = cache_view.get(key)
            try:
                if cached is None:
                    add_fn(fast_clone(ref))
                    repaired += 1
                elif cached[0] != rv:
                    update_fn(cached[1], fast_clone(ref))
                    repaired += 1
            except KeyError:
                # e.g. a pod bound to a node the cache has not seen yet:
                # nodes repair first, so the next pass converges it
                continue
        return repaired

    def anti_entropy(self, repair: bool = True) -> dict:
        """One cache<->store reconciliation pass: fingerprint every kind
        covered, count ``volcano_cache_divergence_total{kind}`` on a
        mismatch and (with ``repair``) relist the diverged kinds in place.
        A repair means the watch stream lied, so the dirty sets cannot be
        trusted either: the next snapshot rebuilds in full. Returns the
        report; ``anti_entropy_state`` and ``/debug/health`` (component
        ``anti_entropy``) keep the last check and repair.

        Run between cycles: pending write-behind applies drain first, and
        a bind staged but not yet committed does not show (the cache's pod
        keeps the store's resource_version until its echo)."""
        now = self.store.clock.now()
        divergent: List[str] = []
        repaired_total = 0
        with self.mutex:
            self._drain_applies_locked()
            for kind in self.ANTI_ENTROPY_KINDS:
                store_view, cache_view = self._anti_entropy_views(kind)
                if self._fingerprint(store_view) == \
                        self._fingerprint(cache_view):
                    continue
                divergent.append(kind)
                m.inc(m.CACHE_DIVERGENCE, kind=kind)
                if repair:
                    self._state_version += 1
                    if repaired_total == 0:
                        pending.publish_idle(
                            pending.REASON_CACHE_RESYNC,
                            detail=f"anti-entropy repairing {kind}")
                    repaired_total += self._repair_kind(
                        kind, store_view, cache_view)
        state = self.anti_entropy_state or {
            "checks": 0, "repairs": 0, "objects_repaired": 0,
            "last_check": None, "last_repair": None, "last_divergent": []}
        state["checks"] += 1
        state["last_check"] = now
        state["last_divergent"] = list(divergent)
        if divergent and repair:
            state["repairs"] += 1
            state["objects_repaired"] += repaired_total
            state["last_repair"] = now
            self.mark_structural_change()
            log.warning("anti-entropy: cache diverged from the store on %s; "
                        "repaired %d object(s) via relist", divergent,
                        repaired_total)
        self.anti_entropy_state = state
        m.set_health(
            "anti_entropy", True,
            f"last-check @{state['last_check']}, last-repair "
            f"@{state['last_repair']}, {state['repairs']} repair pass(es) "
            f"/ {state['objects_repaired']} object(s) over "
            f"{state['checks']} check(s)")
        return {"divergent": divergent, "repaired": repaired_total,
                "checked": list(self.ANTI_ENTROPY_KINDS)}

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

    def update_scheduler_numa_info(self, node_res_sets: Dict[str, Dict[str, set]]) -> None:
        """Write allocated NUMA sets back (numa-aware plugin session
        close); the nodes written are dirty for the next snapshot."""
        with self.mutex:
            self._state_version += 1
            for node_name, res_sets in node_res_sets.items():
                node = self.nodes.get(node_name)
                if node is not None and node.numa_scheduler_info is not None:
                    node.numa_scheduler_info.allocate(res_sets)
                    self._dirty_nodes.add(node_name)

    def __repr__(self):
        return (f"SchedulerCache(jobs={len(self.jobs)}, "
                f"nodes={len(self.nodes)}, queues={len(self.queues)})")
