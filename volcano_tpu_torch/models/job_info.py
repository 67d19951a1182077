"""TaskInfo / JobInfo: scheduler-facing wrappers over Pod and PodGroup.

The port's own copy of volcano_tpu/models/job_info.py. Behavioral
contract mirrors the reference (pkg/scheduler/api/job_info.go):
status taxonomy (job_info.go / types.go:26-74), readiness accounting
(ReadyTaskNum:509, WaitingTaskNum:531, ValidTaskNum:572,
CheckTaskMinAvailable:543, Ready:587), and annotation extraction
(preemptable:304, revocable zone:332, sla waiting time:286, budget:354).

The snapshot's clones (``JobInfo.clone``, ``NodeInfo.clone``) clone their
task tables and Resources on the native engine (native/fastmodel.c) while
``NATIVE_CLONE`` is on, the default; the Python loops beside them are the
plain version.
"""

from __future__ import annotations

import enum
from collections import defaultdict
from typing import Dict, List, Optional

from ..utils.fastclone import fast_clone
from . import objects
from .objects import Pod, PodGroup
from .resource import Resource
from .unschedule_info import FitErrors


class TaskStatus(enum.IntFlag):
    """Task status bits (reference: pkg/scheduler/api/types.go:26-74)."""
    Pending = 1 << 0
    Allocated = 1 << 1
    Pipelined = 1 << 2
    Binding = 1 << 3
    Bound = 1 << 4
    Running = 1 << 5
    Releasing = 1 << 6
    Succeeded = 1 << 7
    Failed = 1 << 8
    Unknown = 1 << 9


_ALLOCATED_STATUSES = frozenset((TaskStatus.Bound, TaskStatus.Binding,
                                 TaskStatus.Running, TaskStatus.Allocated))


def allocated_status(status: TaskStatus) -> bool:
    """Statuses that occupy node resources from the scheduler's viewpoint
    (reference: pkg/scheduler/api/job_info.go AllocatedStatus)."""
    return status in _ALLOCATED_STATUSES


def is_terminated(status: TaskStatus) -> bool:
    return status in (TaskStatus.Succeeded, TaskStatus.Failed)


def get_task_status(pod: Pod) -> TaskStatus:
    """Pod phase -> TaskStatus (reference: pkg/scheduler/api/pod_info.go)."""
    phase = pod.status.phase
    if phase == "Running":
        if pod.metadata.deletion_timestamp is not None:
            return TaskStatus.Releasing
        return TaskStatus.Running
    if phase == "Pending":
        if pod.metadata.deletion_timestamp is not None:
            return TaskStatus.Releasing
        if pod.spec.node_name:
            return TaskStatus.Bound
        return TaskStatus.Pending
    if phase == "Succeeded":
        return TaskStatus.Succeeded
    if phase == "Failed":
        return TaskStatus.Failed
    return TaskStatus.Unknown


def get_job_id(pod: Pod) -> str:
    """PodGroup link via annotation (reference: job_info.go:99-106)."""
    gn = pod.metadata.annotations.get(objects.GROUP_NAME_ANNOTATION, "")
    if gn:
        return f"{pod.metadata.namespace}/{gn}"
    return ""


def get_task_id(pod: Pod) -> str:
    return pod.metadata.annotations.get(objects.TASK_SPEC_KEY, "")


class TaskInfo:
    """Scheduler view of one Pod (reference: job_info.go:70-147)."""

    __slots__ = ("uid", "job", "name", "namespace", "resreq", "init_resreq",
                 "node_name", "status", "priority", "volume_ready",
                 "preemptable", "revocable_zone", "topology_policy", "pod",
                 "best_effort", "last_transaction", "pod_volumes",
                 "constraint_key_cache", "req_key_cache",
                 "group_sig_cache", "has_volumes", "key_cache")

    def __init__(self, pod: Pod):
        req = pod.resource_request()
        self.uid: str = pod.metadata.uid or pod.metadata.key()
        self.job: str = get_job_id(pod)
        self.name: str = pod.metadata.name
        self.namespace: str = pod.metadata.namespace
        # "ns/name" precomputed once: the bind flush reads it ~4x per pod
        # (node task tables, the native and Python echo passes),
        # and a fresh f-string re-hashes on every dict probe while this
        # one's hash is cached after first use
        self.key_cache: str = f"{self.namespace}/{self.name}"
        self.init_resreq: Resource = req
        self.resreq: Resource = req.clone()
        self.node_name: str = pod.spec.node_name
        self.status: TaskStatus = get_task_status(pod)
        self.priority: int = pod.spec.priority if pod.spec.priority is not None else 1
        self.volume_ready: bool = False
        pa = pod.metadata.annotations.get(objects.PREEMPTABLE_KEY)
        self.preemptable: bool = str(pa).lower() == "true" if pa is not None else False
        self.revocable_zone: str = pod.metadata.annotations.get(objects.REVOCABLE_ZONE_KEY, "")
        self.topology_policy: str = pod.metadata.annotations.get(objects.NUMA_TOPOLOGY_POLICY_KEY, "")
        self.pod: Pod = pod
        self.best_effort: bool = self.init_resreq.is_empty()
        self.last_transaction = None
        self.pod_volumes = None
        # lazy scheduling-constraint / request fingerprints (models/arrays.py
        # grouping); pod constraints and resreq are immutable, so clones
        # inherit them
        self.constraint_key_cache = None
        self.req_key_cache = None
        self.group_sig_cache = None
        self.has_volumes = bool(pod.spec.volumes)

    @property
    def task_id(self) -> str:
        return get_task_id(self.pod)

    def clone(self) -> "TaskInfo":
        c = TaskInfo.__new__(TaskInfo)
        c.uid = self.uid
        c.job = self.job
        c.name = self.name
        c.namespace = self.namespace
        # resreq/init_resreq are immutable after construction (nothing in
        # the scheduler mutates a task's request in place — a changed pod
        # spec arrives as a *new* TaskInfo via the event handlers), so
        # clones share them; a cycle clones every task 3+ times and the
        # defensive Resource copies dominated snapshot cost
        c.resreq = self.resreq
        c.init_resreq = self.init_resreq
        c.node_name = self.node_name
        c.status = self.status
        c.priority = self.priority
        c.volume_ready = self.volume_ready
        c.preemptable = self.preemptable
        c.revocable_zone = self.revocable_zone
        c.topology_policy = self.topology_policy
        c.pod = self.pod
        c.best_effort = self.best_effort
        c.last_transaction = self.last_transaction
        c.pod_volumes = self.pod_volumes
        c.constraint_key_cache = self.constraint_key_cache
        c.req_key_cache = self.req_key_cache
        c.group_sig_cache = self.group_sig_cache
        c.has_volumes = self.has_volumes
        c.key_cache = self.key_cache
        return c

    def key(self) -> str:
        return self.key_cache

    def __repr__(self):
        return (f"Task ({self.uid}:{self.namespace}/{self.name}): "
                f"job {self.job}, status {self.status.name}, pri {self.priority}")


# the snapshot clones' switch: the native engine (the default) or the
# Python bodies; a module attribute, so tests can force either
NATIVE_CLONE = True
_fm = None


def _fastmodel():
    """The native engine, built at first use and registered with the
    model classes its entries read (the task and resource slot layouts,
    the status members, the bind clone's classes). A failed build raises."""
    global _fm
    if _fm is None:
        from ..native.build import fastmodel
        mod = fastmodel()
        mod.register_task_type(TaskInfo)
        mod.register_resource_type(Resource)
        mod.register_task_status(TaskStatus, _ALLOCATED_STATUSES)
        mod.register_pod_types(objects.Pod, objects.ObjectMeta,
                               objects.PodSpec)
        _fm = mod
    return _fm


class DisruptionBudget:
    """Job disruption budget (reference: job_info.go:38-58)."""

    def __init__(self, min_available: str = "", max_unavailable: str = ""):
        self.min_available = min_available
        self.max_unavailable = max_unavailable

    def clone(self) -> "DisruptionBudget":
        return DisruptionBudget(self.min_available, self.max_unavailable)


class JobInfo:
    """Scheduler view of one PodGroup and its tasks
    (reference: job_info.go:187-591)."""

    def __init__(self, uid: str, *tasks: TaskInfo, clock=None):
        self.uid: str = uid
        self.name: str = ""
        self.namespace: str = ""
        self.queue: str = objects.DEFAULT_QUEUE
        self.priority: int = 0
        self.min_available: int = 0
        self.waiting_time: Optional[float] = None   # sla-waiting-time seconds
        self.job_fit_errors: str = ""
        self.nodes_fit_errors: Dict[str, FitErrors] = {}
        self.tasks: Dict[str, TaskInfo] = {}
        self.task_status_index: Dict[TaskStatus, Dict[str, TaskInfo]] = defaultdict(dict)
        self.allocated: Resource = Resource()
        self.total_request: Resource = Resource()
        # running sum of Pending tasks' requests (proportion's queue
        # `request` walk was one Resource.add per pending task per cycle —
        # 50k adds at the burst benchmark)
        self.pending_request: Resource = Resource()
        self.creation_timestamp: float = 0.0
        self.pod_group: Optional[PodGroup] = None
        # copy-on-write marker: snapshot clones share the cache's PodGroup
        # until a session-side mutation claims it (own_pod_group)
        self.pod_group_owned: bool = True
        # stamped when the cache first sees the job, so the reservation
        # election's "longest waiting" survives per-cycle snapshot clones
        # (clone() copies it; the reference's ScheduleStartTimestamp
        # analogue). The cache passes its store's clock so the stamp
        # shares the session timebase — virtual under the churn simulator
        import time as _t
        self.scheduling_start_time: float = \
            clock.now() if clock is not None else _t.time()
        self.preemptable: bool = False
        self.revocable_zone: str = ""
        self.budget: DisruptionBudget = DisruptionBudget()
        self.task_min_available: Dict[str, int] = {}
        self.task_min_available_total: int = 0
        # status-index version: bumped on any task/status mutation so the
        # readiness counters can memoize (preempt calls ready_task_num
        # tens of thousands of times between mutations)
        self._status_version: int = 0
        self._ready_cache: tuple = (-1, 0)
        # the session's deferred-apply deltas (Session.materialize):
        # placements the allocate action recorded whose object-model apply
        # (status moves, node accounting) has not run yet. The readiness
        # and status rollups stay exact by adding them.
        self.deferred_alloc: int = 0
        self.deferred_pipe: int = 0
        for t in tasks:
            self.add_task_info(t)

    # -- podgroup ingestion ------------------------------------------------

    def set_pod_group(self, pg: PodGroup) -> None:
        self.name = pg.metadata.name
        self.namespace = pg.metadata.namespace
        self.min_available = pg.spec.min_member
        self.queue = pg.spec.queue
        self.creation_timestamp = pg.metadata.creation_timestamp
        self.waiting_time = self._extract_waiting_time(pg)
        self.preemptable = self._extract_preemptable(pg)
        self.revocable_zone = self._extract_revocable_zone(pg)
        self.budget = self._extract_budget(pg)
        self.task_min_available = dict(pg.spec.min_task_member)
        self.task_min_available_total = sum(self.task_min_available.values())
        self.pod_group = pg
        self.pod_group_owned = True

    def unset_pod_group(self) -> None:
        self.pod_group = None

    def own_pod_group(self) -> Optional[PodGroup]:
        """Claim a private PodGroup copy before a session-side mutation
        (copy-on-write counterpart of clone()); writeback goes through the
        status updater, never through the cache's shared object."""
        if not self.pod_group_owned and self.pod_group is not None:
            self.pod_group = fast_clone(self.pod_group)
            self.pod_group_owned = True
        return self.pod_group

    @staticmethod
    def _extract_waiting_time(pg: PodGroup) -> Optional[float]:
        """Invalid annotations are treated as unset, never fatal
        (reference: job_info.go:286-300 logs and returns nil)."""
        v = pg.metadata.annotations.get(objects.SLA_WAITING_TIME_KEY)
        if v is None:
            return None
        w = parse_duration(v)
        if w is None or w <= 0:
            return None
        return w

    @staticmethod
    def _extract_preemptable(pg: PodGroup) -> bool:
        """Annotations beat labels (reference: job_info.go:304-330)."""
        for src in (pg.metadata.annotations, pg.metadata.labels):
            if objects.PREEMPTABLE_KEY in src:
                return str(src[objects.PREEMPTABLE_KEY]).lower() == "true"
        return False

    @staticmethod
    def _extract_revocable_zone(pg: PodGroup) -> str:
        v = pg.metadata.annotations.get(objects.REVOCABLE_ZONE_KEY)
        if v is not None:
            return v if v == "*" else ""
        if pg.metadata.annotations.get(objects.PREEMPTABLE_KEY, "").lower() == "true":
            return "*"
        return ""

    @staticmethod
    def _extract_budget(pg: PodGroup) -> DisruptionBudget:
        a = pg.metadata.annotations
        if objects.JDB_MIN_AVAILABLE_KEY in a:
            return DisruptionBudget(min_available=a[objects.JDB_MIN_AVAILABLE_KEY])
        if objects.JDB_MAX_UNAVAILABLE_KEY in a:
            return DisruptionBudget(max_unavailable=a[objects.JDB_MAX_UNAVAILABLE_KEY])
        return DisruptionBudget()

    def get_min_resources(self) -> Resource:
        if self.pod_group is None or self.pod_group.spec.min_resources is None:
            return Resource()
        return Resource.from_resource_list(self.pod_group.spec.min_resources)

    # -- task management ---------------------------------------------------

    def add_task_info(self, ti: TaskInfo) -> None:
        self._status_version += 1
        self.tasks[ti.uid] = ti
        self.task_status_index[ti.status][ti.uid] = ti
        if allocated_status(ti.status):
            self.allocated.add(ti.resreq)
        elif ti.status == TaskStatus.Pending:
            self.pending_request.add(ti.resreq)
        self.total_request.add(ti.resreq)

    def update_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        self.delete_task_info(task)
        task.status = status
        self.add_task_info(task)

    def move_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        """In-place status move for a task already registered in this job.

        Equivalent to :meth:`update_task_status` but skips the net-zero
        total_request sub/add pair and only touches ``allocated`` when the
        allocated-ness actually flips — the hot allocate/bind path moves
        every placed task three times per cycle, so the saved Resource
        arithmetic is significant at 50k tasks."""
        stored = self.tasks.get(task.uid)
        if stored is None:
            raise KeyError(f"failed to find task <{task.namespace}/"
                           f"{task.name}> in job <{self.namespace}/{self.name}>")
        self._status_version += 1
        old = stored.status
        idx = self.task_status_index[old]
        idx.pop(task.uid, None)
        if not idx:
            del self.task_status_index[old]
        was, now = allocated_status(old), allocated_status(status)
        if was and not now:
            self.allocated.sub(stored.resreq)
        elif now and not was:
            self.allocated.add(stored.resreq)
        if old == TaskStatus.Pending and status != TaskStatus.Pending:
            self.pending_request.sub(stored.resreq)
        elif status == TaskStatus.Pending and old != TaskStatus.Pending:
            self.pending_request.add(stored.resreq)
        task.status = status
        self.tasks[task.uid] = task
        self.task_status_index[status][task.uid] = task

    def move_tasks_status_bulk(self, tasks: List[TaskInfo],
                               status: TaskStatus) -> Optional[Resource]:
        """:meth:`move_task_status` over many registered tasks with the
        allocated-resource flips accumulated into one Resource op pair and
        a single index-version bump. Raises before any mutation if a task
        is unknown (the bulk callers stage whole gangs all-or-nothing)."""
        stored_list = []
        for task in tasks:
            stored = self.tasks.get(task.uid)
            if stored is None:
                raise KeyError(f"failed to find task <{task.namespace}/"
                               f"{task.name}> in job "
                               f"<{self.namespace}/{self.name}>")
            stored_list.append(stored)
        self._status_version += 1
        now = allocated_status(status)
        now_pending = status == TaskStatus.Pending
        flip_add = None
        flip_sub = None
        pend_add = None
        pend_sub = None
        new_idx = self.task_status_index[status]
        for task, stored in zip(tasks, stored_list):
            old = stored.status
            idx = self.task_status_index[old]
            idx.pop(task.uid, None)
            if not idx and old != status:   # never drop the target index
                del self.task_status_index[old]
            was = allocated_status(old)
            if was and not now:
                if flip_sub is None:
                    flip_sub = Resource()
                flip_sub.add(stored.resreq)
            elif now and not was:
                if flip_add is None:
                    flip_add = Resource()
                flip_add.add(stored.resreq)
            was_pending = old == TaskStatus.Pending
            if was_pending and not now_pending:
                if pend_sub is None:
                    pend_sub = Resource()
                pend_sub.add(stored.resreq)
            elif now_pending and not was_pending:
                if pend_add is None:
                    pend_add = Resource()
                pend_add.add(stored.resreq)
            task.status = status
            self.tasks[task.uid] = task
            new_idx[task.uid] = task
        if flip_add is not None:
            self.allocated.add(flip_add)
        if flip_sub is not None:
            self.allocated.sub(flip_sub)
        if pend_add is not None:
            self.pending_request.add(pend_add)
        if pend_sub is not None:
            self.pending_request.sub(pend_sub)
        return flip_add

    def delete_task_info(self, ti: TaskInfo) -> None:
        self._status_version += 1
        task = self.tasks.get(ti.uid)
        if task is None:
            raise KeyError(f"failed to find task <{ti.namespace}/{ti.name}> "
                           f"in job <{self.namespace}/{self.name}>")
        if allocated_status(task.status):
            self.allocated.sub(task.resreq)
        elif task.status == TaskStatus.Pending:
            self.pending_request.sub(task.resreq)
        self.total_request.sub(task.resreq)
        del self.tasks[task.uid]
        idx = self.task_status_index[task.status]
        idx.pop(task.uid, None)
        if not idx:
            del self.task_status_index[task.status]

    def clone(self) -> "JobInfo":
        # __new__ + explicit fields: JobInfo() runs the full constructor
        # (time.time(), defaultdicts, ~25 defaults) only for clone() to
        # overwrite nearly all of it — measurable at 6k jobs per snapshot
        info = JobInfo.__new__(JobInfo)
        info.uid = self.uid
        info.job_fit_errors = ""
        info._status_version = 0
        info._ready_cache = (-1, 0)
        info.deferred_alloc = 0
        info.deferred_pipe = 0
        info.name = self.name
        info.namespace = self.namespace
        info.queue = self.queue
        info.priority = self.priority
        info.min_available = self.min_available
        info.waiting_time = self.waiting_time
        info.nodes_fit_errors = {}
        # copy-on-write PodGroup: the snapshot shares the cache's object
        # until a session-side mutation (enqueue phase flip, condition or
        # status write) claims a private copy via own_pod_group() — most
        # jobs per cycle are never mutated, and the deep copy dominated
        # snapshot cost (reference pays it via cache.go:793 deepcopy)
        info.pod_group = self.pod_group
        info.pod_group_owned = False
        info.creation_timestamp = self.creation_timestamp
        info.scheduling_start_time = self.scheduling_start_time
        info.preemptable = self.preemptable
        info.revocable_zone = self.revocable_zone
        info.budget = self.budget.clone()
        info.task_min_available = dict(self.task_min_available)
        info.task_min_available_total = self.task_min_available_total
        # direct task copy: the status index and allocated/total aggregates
        # are cloned rather than re-derived one add_task_info at a time
        # (cache.go:827-876 pays the same via deepcopy-gen); the native
        # engine clones the table and builds the index in one C pass. The
        # fields above stay Python stores: they keep the instance's
        # attributes in the class's shared layout, which a C copy of the
        # __dict__ does not (every later attribute read of a dict-backed
        # instance is about three times slower)
        index = defaultdict(dict)
        if NATIVE_CLONE:
            fm = _fastmodel()
            tasks, plain = fm.clone_task_table(self.tasks)
            index.update(plain)
            info.tasks = tasks
            info.task_status_index = index
            info.allocated = fm.clone_resource(self.allocated)
            info.total_request = fm.clone_resource(self.total_request)
            info.pending_request = fm.clone_resource(self.pending_request)
            return info
        tasks = {}
        for uid, task in self.tasks.items():
            c = task.clone()
            tasks[uid] = c
            index[c.status][uid] = c
        info.tasks = tasks
        info.task_status_index = index
        info.allocated = self.allocated.clone()
        info.total_request = self.total_request.clone()
        info.pending_request = self.pending_request.clone()
        return info

    # -- readiness accounting ---------------------------------------------

    def ready_task_num(self) -> int:
        """Allocated-ish + Succeeded + best-effort Pending
        (reference: job_info.go:509-527). Memoized per status version."""
        cached_version, cached = self._ready_cache
        if cached_version == self._status_version:
            return cached + self.deferred_alloc
        occupied = 0
        for status, tasks in self.task_status_index.items():
            if allocated_status(status) or status == TaskStatus.Succeeded:
                occupied += len(tasks)
            elif status == TaskStatus.Pending:
                occupied += sum(1 for t in tasks.values() if t.init_resreq.is_empty())
        self._ready_cache = (self._status_version, occupied)
        return occupied + self.deferred_alloc

    def waiting_task_num(self) -> int:
        return len(self.task_status_index.get(TaskStatus.Pipelined, {})) \
            + self.deferred_pipe

    def valid_task_num(self) -> int:
        occupied = 0
        for status, tasks in self.task_status_index.items():
            if (allocated_status(status) or status == TaskStatus.Succeeded
                    or status == TaskStatus.Pipelined or status == TaskStatus.Pending):
                occupied += len(tasks)
        return occupied

    def check_task_min_available(self) -> bool:
        """Per-task-type minAvailable check (reference: job_info.go:543-569)."""
        if not self.task_min_available:
            return True   # no per-type minimums: skip the status sweep
        if self.min_available < self.task_min_available_total:
            return True
        actual: Dict[str, int] = defaultdict(int)
        for status, tasks in self.task_status_index.items():
            if (allocated_status(status) or status == TaskStatus.Succeeded
                    or status == TaskStatus.Pipelined or status == TaskStatus.Pending):
                for t in tasks.values():
                    actual[t.task_id] += 1
        return all(actual.get(name, 0) >= need
                   for name, need in self.task_min_available.items())

    def ready(self) -> bool:
        return self.ready_task_num() >= self.min_available

    def is_pending(self) -> bool:
        return (self.pod_group is None
                or self.pod_group.status.phase == objects.PodGroupPhase.PENDING)

    def fit_error(self) -> str:
        """Histogram of pending/fit reasons (reference: job_info.go:487-505)."""
        reasons: Dict[str, int] = defaultdict(int)
        for status, tasks in self.task_status_index.items():
            reasons[status.name] += len(tasks)
        sorted_reasons = sorted(reasons.items(), key=lambda kv: kv[0])
        msg = ", ".join(f"{n} {r}" for r, n in sorted_reasons)
        return f"pod group is not ready, {self.min_available} minAvailable, {msg}"

    def __repr__(self):
        return (f"Job ({self.uid}): namespace {self.namespace} ({self.name}), "
                f"minAvailable {self.min_available}")


def parse_duration(v: str) -> Optional[float]:
    """Go-style duration string to seconds ("1h30m", "300s", "1.5h")."""
    import re
    if v is None:
        return None
    v = str(v).strip()
    m = re.findall(r"([0-9]*\.?[0-9]+)(ms|us|ns|h|m|s)", v)
    if not m:
        try:
            return float(v)
        except ValueError:
            return None
    mult = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}
    return sum(float(num) * mult[unit] for num, unit in m)
