"""Session: the per-cycle scheduling context (counterpart of
volcano_tpu/framework/session.py).

Mirrors pkg/scheduler/framework/session.go + session_plugins.go: a deep-copy
snapshot of the cluster, 22 plugin extension-point registries with tiered
dispatch (first-tier-with-an-opinion for order fns, AND/intersection for
predicates and victim sets, Permit/Abstain/Reject voting for pipelined/
enqueueable), and the Allocate/Pipeline/Evict primitives that mutate session
state and dispatch to the cache (a bind when a gang becomes ready, an
eviction at once).

``ssn.solver`` (framework/solver.py) is the batched task x node placement
context that the builtin plugins feed masks and score terms into; it runs
the gang-allocate kernel on the session's device. Placements are staged
into the session's objects as they are made (there is no deferred apply).
"""

from __future__ import annotations

import time
import uuid
from typing import Callable, Dict, List, Optional

from ..models.cluster_info import ClusterInfo
from ..models.job_info import JobInfo, TaskInfo, TaskStatus
from ..models.node_info import NodeInfo
from ..models.queue_info import NamespaceInfo, QueueInfo
from ..models.resource import Resource
from ..utils.clock import GLOBAL_CLOCK

# plugin voting values (reference: plugins/util/util.go:31-36)
PERMIT = 1
ABSTAIN = 0
REJECT = -1


class ValidateResult:
    def __init__(self, passed: bool, reason: str = "", message: str = ""):
        self.passed = passed
        self.reason = reason
        self.message = message


class Event:
    def __init__(self, task: TaskInfo):
        self.task = task


class EventHandler:
    """Per-task Allocate/Deallocate hooks, with optional batched forms.

    ``batch_allocate_func(job, tasks, total_resource)`` lets additive
    plugins (drf, proportion) absorb a whole gang's placement in one call
    instead of one share recompute per task; handlers without a batch form
    are fed per-task events by the session's batched fire, so semantics
    are identical either way."""

    def __init__(self, allocate_func: Optional[Callable] = None,
                 deallocate_func: Optional[Callable] = None,
                 batch_allocate_func: Optional[Callable] = None,
                 batch_deallocate_func: Optional[Callable] = None):
        self.allocate_func = allocate_func
        self.deallocate_func = deallocate_func
        self.batch_allocate_func = batch_allocate_func
        self.batch_deallocate_func = batch_deallocate_func


_FN_MAPS = (
    "job_order_fns", "queue_order_fns", "task_order_fns", "namespace_order_fns",
    "cluster_order_fns", "predicate_fns", "best_node_fns", "node_order_fns",
    "batch_node_order_fns", "node_map_fns", "node_reduce_fns",
    "preemptable_fns", "reclaimable_fns", "overused_fns", "job_ready_fns",
    "job_pipelined_fns", "job_valid_fns", "job_enqueueable_fns",
    "job_enqueued_fns", "target_job_fns", "reserved_nodes_fns",
    "victim_tasks_fns", "job_starving_fns",
)

# extension-point -> conf enable flag consulted during dispatch
_ENABLE_FOR = {
    "job_order_fns": "enabledJobOrder",
    "namespace_order_fns": "enabledNamespaceOrder",
    "queue_order_fns": "enabledQueueOrder",
    "task_order_fns": "enabledTaskOrder",
    "predicate_fns": "enabledPredicate",
    "best_node_fns": "enabledBestNode",
    "node_order_fns": "enabledNodeOrder",
    "batch_node_order_fns": "enabledNodeOrder",
    "node_map_fns": "enabledNodeOrder",
    "node_reduce_fns": "enabledNodeOrder",
    "preemptable_fns": "enabledPreemptable",
    "reclaimable_fns": "enabledReclaimable",
    "overused_fns": "enabledOverused",
    "job_ready_fns": "enabledJobReady",
    "job_pipelined_fns": "enabledJobPipelined",
    "job_valid_fns": None,
    "job_enqueueable_fns": "enabledJobEnqueued",
    "job_enqueued_fns": "enabledJobEnqueued",
    "target_job_fns": "enabledTargetJob",
    "reserved_nodes_fns": "enabledReservedNodes",
    "victim_tasks_fns": "enabledVictim",
    "job_starving_fns": "enabledJobStarving",
}


class Session:
    """One scheduling cycle's context."""

    def __init__(self, cache, snapshot: ClusterInfo, tiers,
                 configurations=None, clock=None):
        self.uid = str(uuid.uuid4())
        self.cache = cache
        self.kube_client = cache.client() if cache is not None else None
        # time-dependent decisions read this clock, never time.time(), so
        # they compare against the timebase that stamped
        # creation_timestamp. An explicit clock (Scheduler's) wins;
        # otherwise the store's clock is the source of truth.
        self.clock = clock if clock is not None else \
            (getattr(self.kube_client, "clock", None) or GLOBAL_CLOCK)
        self.jobs: Dict[str, JobInfo] = snapshot.jobs
        self.nodes: Dict[str, NodeInfo] = snapshot.nodes
        self.queues: Dict[str, QueueInfo] = snapshot.queues
        self.namespace_info: Dict[str, NamespaceInfo] = snapshot.namespaces
        self.revocable_nodes: Dict[str, NodeInfo] = snapshot.revocable_nodes
        self.node_list: List[NodeInfo] = [self.nodes[n] for n in snapshot.node_list
                                          if n in self.nodes]
        self.tiers = tiers
        self.configurations = configurations or {}
        self.plugins: Dict[str, object] = {}
        self.event_handlers: List[EventHandler] = []
        for m in _FN_MAPS:
            setattr(self, m, {})
        self._enabled_fns_cache: Dict[str, list] = {}
        self._victims_chain_cache: Dict[str, list] = {}
        # the placement solver (framework/solver.py), built by open_session
        self.solver = None
        # open_session fills these: the cluster total and the PodGroup
        # status fingerprints taken before the session changed anything
        self.total_resource: Resource = Resource()
        self.pod_group_status: Dict[str, tuple] = {}
        # wall ms of the actions' inner phases, by name (the allocate
        # action's ordering, staging and commit; read by the cycle's
        # timing split)
        self.timings: Dict[str, float] = {}
        # preempt/reclaim placements by victim-selection path ("kernel":
        # ops/victims.py, "python": the walk of framework/victims.py)
        self.victim_runs: Dict[str, int] = {}

    def add_timing(self, name: str, since: float) -> float:
        """Add the wall time since ``since`` (a perf_counter reading) to
        ``timings[name]``; returns the current reading."""
        now = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + \
            (now - since) * 1000.0
        return now

    # ------------------------------------------------------------------
    # registration (AddXxxFn, session_plugins.go:37-140)
    # ------------------------------------------------------------------

    def _add(self, map_name: str, plugin_name: str, fn) -> None:
        getattr(self, map_name)[plugin_name] = fn
        self._enabled_fns_cache.pop(map_name, None)
        self._victims_chain_cache.pop(map_name, None)

    def add_job_order_fn(self, name, fn): self._add("job_order_fns", name, fn)
    def add_queue_order_fn(self, name, fn): self._add("queue_order_fns", name, fn)
    def add_task_order_fn(self, name, fn): self._add("task_order_fns", name, fn)
    def add_namespace_order_fn(self, name, fn): self._add("namespace_order_fns", name, fn)
    def add_predicate_fn(self, name, fn): self._add("predicate_fns", name, fn)
    def add_best_node_fn(self, name, fn): self._add("best_node_fns", name, fn)
    def add_node_order_fn(self, name, fn): self._add("node_order_fns", name, fn)
    def add_batch_node_order_fn(self, name, fn): self._add("batch_node_order_fns", name, fn)
    def add_node_map_fn(self, name, fn): self._add("node_map_fns", name, fn)
    def add_node_reduce_fn(self, name, fn): self._add("node_reduce_fns", name, fn)
    def add_preemptable_fn(self, name, fn): self._add("preemptable_fns", name, fn)
    def add_reclaimable_fn(self, name, fn): self._add("reclaimable_fns", name, fn)
    def add_overused_fn(self, name, fn): self._add("overused_fns", name, fn)
    def add_job_ready_fn(self, name, fn): self._add("job_ready_fns", name, fn)
    def add_job_pipelined_fn(self, name, fn): self._add("job_pipelined_fns", name, fn)
    def add_job_valid_fn(self, name, fn): self._add("job_valid_fns", name, fn)
    def add_job_enqueueable_fn(self, name, fn): self._add("job_enqueueable_fns", name, fn)
    def add_job_enqueued_fn(self, name, fn): self._add("job_enqueued_fns", name, fn)
    def add_target_job_fn(self, name, fn): self._add("target_job_fns", name, fn)
    def add_reserved_nodes_fn(self, name, fn): self._add("reserved_nodes_fns", name, fn)
    def add_victim_tasks_fns(self, name, fn): self._add("victim_tasks_fns", name, fn)
    def add_job_starving_fns(self, name, fn): self._add("job_starving_fns", name, fn)
    def add_event_handler(self, handler: EventHandler): self.event_handlers.append(handler)

    # ------------------------------------------------------------------
    # tiered dispatch
    # ------------------------------------------------------------------

    def plugin_enabled(self, plugin_name: str, flag: str) -> bool:
        """Whether the conf enables ``flag`` for ``plugin_name`` (unset flags
        default to enabled). Consulted by plugins before feeding the solver so
        the vectorized path honors per-extension-point enables exactly like
        tiered dispatch does for host fns."""
        for tier in self.tiers:
            for opt in tier.plugins:
                if opt.name == plugin_name:
                    return opt.is_enabled(flag)
        return True

    def _enabled_fns(self, map_name: str):
        """(tier_index, plugin_option, fn) honoring enable flags. Memoized:
        tiers and fn registrations are fixed after OnSessionOpen, and this
        resolution sits under every order-fn comparison on the hot path."""
        cached = self._enabled_fns_cache.get(map_name)
        if cached is not None:
            return cached
        fns = getattr(self, map_name)
        flag = _ENABLE_FOR.get(map_name)
        out = []
        for ti, tier in enumerate(self.tiers):
            for opt in tier.plugins:
                if flag is not None and not opt.is_enabled(flag):
                    continue
                fn = fns.get(opt.name)
                if fn is not None:
                    out.append((ti, opt, fn))
        self._enabled_fns_cache[map_name] = out
        return out

    def _compare_dispatch(self, map_name: str, l, r) -> Optional[int]:
        """First plugin with a non-zero comparison wins."""
        for _, _, fn in self._enabled_fns(map_name):
            v = fn(l, r)
            if v != 0:
                return v
        return None

    def job_order_fn(self, l: JobInfo, r: JobInfo) -> bool:
        """Whether l should be placed before r (session_plugins.go:486-510);
        falls back to creation time then UID."""
        v = self._compare_dispatch("job_order_fns", l, r)
        if v is not None:
            return v < 0
        if l.creation_timestamp != r.creation_timestamp:
            return l.creation_timestamp < r.creation_timestamp
        return l.uid < r.uid

    def namespace_order_fn(self, l, r) -> bool:
        v = self._compare_dispatch("namespace_order_fns", l, r)
        if v is not None:
            return v < 0
        return l < r

    def queue_order_fn(self, l: QueueInfo, r: QueueInfo) -> bool:
        v = self._compare_dispatch("queue_order_fns", l, r)
        if v is not None:
            return v < 0
        if l.queue.metadata.creation_timestamp != r.queue.metadata.creation_timestamp:
            return (l.queue.metadata.creation_timestamp
                    < r.queue.metadata.creation_timestamp)
        return l.uid < r.uid

    def task_compare_fns(self, l: TaskInfo, r: TaskInfo) -> Optional[int]:
        return self._compare_dispatch("task_order_fns", l, r)

    def task_order_fn(self, l: TaskInfo, r: TaskInfo) -> bool:
        v = self.task_compare_fns(l, r)
        if v is not None:
            return v < 0
        if l.priority != r.priority:
            return l.priority > r.priority
        return l.uid < r.uid

    def predicate_fn(self, task: TaskInfo, node: NodeInfo) -> None:
        """All enabled predicates must pass; raises FitError-carrying
        exceptions on failure (session_plugins.go:625-640)."""
        for _, _, fn in self._enabled_fns("predicate_fns"):
            fn(task, node)

    def best_node_fn(self, task: TaskInfo, node_scores) -> Optional[NodeInfo]:
        for _, _, fn in self._enabled_fns("best_node_fns"):
            best = fn(task, node_scores)
            if best is not None:
                return best
        return None

    def node_order_fn(self, task: TaskInfo, node: NodeInfo) -> float:
        score = 0.0
        for _, _, fn in self._enabled_fns("node_order_fns"):
            score += fn(task, node)
        return score

    def batch_node_order_fn(self, task: TaskInfo, nodes) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for _, _, fn in self._enabled_fns("batch_node_order_fns"):
            for name, s in fn(task, nodes).items():
                total[name] = total.get(name, 0.0) + s
        return total

    def _victims_dispatch(self, map_name, claimer, claimees):
        """Per-tier intersection of victim sets (session_plugins.go:142-238):
        abstaining plugins skip; an empty candidate set (or an empty
        intersection) vetoes the tier and dispatch falls through to the next
        tier; the first tier producing a non-empty set decides."""
        chain = self._victims_chain_cache.get(map_name)
        if chain is None:
            # [(tier_index, [fn, ...])] — resolved once; fn maps are fixed
            # after OnSessionOpen (same contract as _enabled_fns)
            by_tier: Dict[int, list] = {}
            for ti, _, fn in self._enabled_fns(map_name):
                by_tier.setdefault(ti, []).append(fn)
            chain = sorted(by_tier.items())
            self._victims_chain_cache[map_name] = chain
        for ti, fns in chain:
            victims: Optional[list] = None
            for fn in fns:
                candidates, abstain = fn(claimer, claimees)
                if abstain == ABSTAIN:
                    continue
                if not candidates:
                    victims = None
                    break
                if victims is None:
                    victims = list(candidates)
                else:
                    cand_ids = {c.uid for c in candidates}
                    victims = [v for v in victims if v.uid in cand_ids]
                    if not victims:
                        victims = None
                        break
            if victims:
                return victims
        return []

    def preemptable(self, preemptor: TaskInfo, preemptees) -> list:
        return self._victims_dispatch("preemptable_fns", preemptor, preemptees)

    def reclaimable(self, reclaimer: TaskInfo, reclaimees) -> list:
        return self._victims_dispatch("reclaimable_fns", reclaimer, reclaimees)

    def victim_tasks(self) -> list:
        """Union of all victim-task sets (session_plugins.go:427-450)."""
        victims = []
        seen = set()
        for _, _, fn in self._enabled_fns("victim_tasks_fns"):
            for v in fn():
                if v.uid not in seen:
                    seen.add(v.uid)
                    victims.append(v)
        return victims

    def overused(self, queue: QueueInfo) -> bool:
        for _, _, fn in self._enabled_fns("overused_fns"):
            if fn(queue):
                return True
        return False

    def job_ready(self, job: JobInfo) -> bool:
        for _, _, fn in self._enabled_fns("job_ready_fns"):
            if not fn(job):
                return False
        return True

    def _voting_dispatch(self, map_name: str, obj, default: bool) -> bool:
        """Permit/Abstain/Reject per tier (session_plugins.go:283-313)."""
        for ti, tier in enumerate(self.tiers):
            has_found = False
            flag = _ENABLE_FOR[map_name]
            fns = getattr(self, map_name)
            for opt in tier.plugins:
                if not opt.is_enabled(flag):
                    continue
                fn = fns.get(opt.name)
                if fn is None:
                    continue
                res = fn(obj)
                if res < 0:
                    return False
                if res > 0:
                    has_found = True
            if has_found:
                return True
        return default

    def job_pipelined(self, job: JobInfo) -> bool:
        return self._voting_dispatch("job_pipelined_fns", job, True)

    def job_enqueueable(self, job: JobInfo) -> bool:
        return self._voting_dispatch("job_enqueueable_fns", job, True)

    def job_enqueued(self, job: JobInfo) -> None:
        for _, _, fn in self._enabled_fns("job_enqueued_fns"):
            fn(job)

    def job_starving(self, job: JobInfo) -> bool:
        """AND within the first tier that registered (session_plugins.go:
        315-340)."""
        for ti, tier in enumerate(self.tiers):
            has_found = False
            fns = self.job_starving_fns
            for opt in tier.plugins:
                if not opt.is_enabled("enabledJobStarving"):
                    continue
                fn = fns.get(opt.name)
                if fn is None:
                    continue
                has_found = True
                if not fn(job):
                    return False
            if has_found:
                return True
        return False

    def job_valid(self, job: JobInfo) -> Optional[ValidateResult]:
        for _, _, fn in self._enabled_fns("job_valid_fns"):
            vr = fn(job)
            if vr is not None and not vr.passed:
                return vr
        return None

    def target_job(self, jobs) -> Optional[JobInfo]:
        for _, _, fn in self._enabled_fns("target_job_fns"):
            target = fn(jobs)
            if target is not None:
                return target
        return None

    def reserved_nodes(self) -> None:
        for _, _, fn in self._enabled_fns("reserved_nodes_fns"):
            fn()

    # ------------------------------------------------------------------
    # primitives (session.go:238-345)
    # ------------------------------------------------------------------

    def statement(self):
        from .statement import Statement
        return Statement(self)

    def _fire_allocate(self, task: TaskInfo) -> None:
        for eh in self.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(task))

    def _fire_deallocate(self, task: TaskInfo) -> None:
        for eh in self.event_handlers:
            if eh.deallocate_func is not None:
                eh.deallocate_func(Event(task))

    def _fire_allocate_batch(self, job, tasks, total=None) -> None:
        """One event round for a whole gang's placements. ``total`` may be
        passed by callers that already hold the gang's resource sum."""
        if not tasks:
            return
        if total is None:
            total = Resource()
            for t in tasks:
                total.add(t.resreq)
        for eh in self.event_handlers:
            if eh.batch_allocate_func is not None:
                eh.batch_allocate_func(job, tasks, total)
            elif eh.allocate_func is not None:
                for t in tasks:
                    eh.allocate_func(Event(t))

    def _fire_deallocate_batch(self, job, tasks) -> None:
        if not tasks:
            return
        total = Resource()
        for t in tasks:
            total.add(t.resreq)
        for eh in self.event_handlers:
            if eh.batch_deallocate_func is not None:
                eh.batch_deallocate_func(job, tasks, total)
            elif eh.deallocate_func is not None:
                for t in tasks:
                    eh.deallocate_func(Event(t))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """Assign onto releasing resources; session-state only."""
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job} when pipelining")
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        job.update_task_status(task, TaskStatus.Pipelined)
        task.node_name = hostname
        node.add_task(task)
        self._fire_allocate(task)

    def allocate(self, task: TaskInfo, node_info: NodeInfo) -> None:
        """Assign onto idle resources; dispatches the whole gang to the cache
        binder once the job is ready (session.go:281-331)."""
        hostname = node_info.name
        pod_volumes = self.cache.volume_binder.get_pod_volumes(task, node_info.node) \
            if self.cache is not None else None
        if self.cache is not None:
            self.cache.volume_binder.allocate_volumes(task, hostname, pod_volumes)
        task.pod_volumes = pod_volumes
        task.pod.spec.node_name = hostname
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        job.update_task_status(task, TaskStatus.Allocated)
        task.node_name = hostname
        node.add_task(task)
        self._fire_allocate(task)
        if self.job_ready(job):
            for t in list(job.task_status_index.get(TaskStatus.Allocated, {}).values()):
                self.dispatch(t, t.pod_volumes)

    def dispatch(self, task: TaskInfo, volumes=None) -> None:
        """Send a session-allocated task to the cache for real binding."""
        if self.cache is not None:
            self.cache.volume_binder.bind_volumes(task, volumes
                                                  if volumes is not None
                                                  else task.pod_volumes)
            self.cache.bind(task, task.node_name)
        job = self.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.Binding)

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """Immediate eviction (used by reclaim): session state, then the
        cache (session.go:593-608)."""
        job = self.jobs.get(reclaimee.job)
        if job is None:
            raise KeyError(f"failed to find job {reclaimee.job}")
        node = self.nodes.get(reclaimee.node_name)
        if node is None:
            raise KeyError(f"failed to find node {reclaimee.node_name}")
        job.update_task_status(reclaimee, TaskStatus.Releasing)
        node.update_task(reclaimee)
        self._fire_deallocate(reclaimee)
        if self.cache is not None:
            self.cache.evict(reclaimee, reason)

    def __repr__(self):
        return (f"Session {self.uid}: jobs={len(self.jobs)} "
                f"nodes={len(self.nodes)} queues={len(self.queues)}")
