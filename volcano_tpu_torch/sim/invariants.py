"""Invariant catalog audited after every simulator tick (the port's own
copy of volcano_tpu/sim/invariants.py).

Each checker is a standalone function taking a :class:`CycleContext` and
returning :class:`Violation` records (empty = clean), so the test suite
can aim a deliberately-broken fixture at each one individually. The
engine runs the full catalog after flushing the executors, when cache,
store and snapshot are supposed to agree.

Catalog (docs/design/simulation.md carries the prose version):

* ``node_accounting`` — no node overcommit: per-node ``idle >= 0`` on
  every dimension, ``used`` equals the sum of resident non-pipelined task
  requests, ``idle + used == allocatable``, and no task resident on two
  nodes.
* ``gang_atomicity`` — a job never sits partially bound below its
  ``minAvailable``: excluding gangs hit by CHURN (node kills, evict
  storms, pod failures) this run, the allocated-status task count is
  either 0 or >= minAvailable. Injected BIND failures are NOT exempt —
  the commit path heals them (gang-atomic unbind of the bound siblings,
  docs/design/resilience.md), and this checker asserts the heal
  converges within ``gang_converge_ticks`` consecutive ticks.
* ``queue_quota`` — a queue with a capability never crosses it through
  *scheduler* action: if it was within capability before the cycle, new
  binds must not push its allocated total beyond capability.
* ``no_orphans`` — every bound store pod's node exists (store + cache)
  and accounts for it; every allocated cache task's pod still exists in
  the store.
* ``snapshot_coherence`` — the per-cycle snapshot agrees with the live
  cache and the store: task keysets match, snapshot nodes are exactly
  the ready cache nodes, and cloned idle equals live idle.
* ``journal_order`` — the store's change journal is rv-sorted and
  gap-free, its tail matches the watch-visible resource version, and no
  reservation (sharded bind flush, docs/design/bind_pipeline.md) is
  left open at the tick boundary: no parked entries, no in-flight keys.
* ``spread_skew`` — hard (DoNotSchedule) topology-spread constraints are
  honored at placement: a fully-placed full gang's per-domain counts stay
  within ``max_skew``, and no constrained pod lands on a node missing the
  topology label (docs/design/constraints.md).
* ``anti_affinity`` — required self-anti-affinity is honored: no two
  allocated siblings selected by the same required term share that
  term's topology domain (the one-replica-per-domain idiom).
* ``no_silent_rebind`` — a bound pod's node never changes without an
  observed unbind (node_name cleared by a gang heal) or delete between
  the two placements. The signature of a DEPOSED leader double-binding
  across a failover; lease fencing (docs/design/failover.md) exists to
  make this impossible, and this checker holds it to that. Active only
  when the engine threads its persistent ``bind_ledger`` through the
  context — the post-restart catalog re-audits the whole store against
  the ledger, so binds surviving a crash/restart (or a snapshot-mode
  store swap) are also covered.

The restart story (docs/design/failover.md) deliberately reuses this
catalog: after a scheduler crash/restart the engine keeps auditing every
tick, so "no orphaned or duplicated binds, journal gap-free, gangs
reconverge within ``gang_converge_ticks``" are enforced by
``no_orphans`` + ``no_silent_rebind`` + ``journal_order`` +
``gang_atomicity`` over the rebuilt control plane, not by a separate
weaker post-restart mode.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..models.job_info import TaskStatus, allocated_status
from ..models.resource import Resource

EPS = 0.5


@dataclass
class Violation:
    invariant: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.invariant}] {self.detail}"


@dataclass
class CycleContext:
    """Everything the checkers need about one audited tick."""
    store: object
    cache: object
    tick: int = 0
    # job keys ("ns/pg-name") whose gangs were hit by CHURN (node kill,
    # evict storm, mid-run pod failure) at any point — exempt from the
    # gang-atomicity rule (a pod delete legitimately leaves a partial
    # gang). Bind failures are NOT collected here: the commit path must
    # heal them (resilience.md), not get them waived.
    dirty_jobs: Set[str] = field(default_factory=set)
    # gang-atomicity convergence window: consecutive audited ticks a job
    # may sit partially bound before it violates (0 = flag immediately).
    # The engine passes a persistent ``partial_streaks`` dict so streaks
    # survive across per-tick contexts.
    gang_converge_ticks: int = 0
    partial_streaks: Dict[str, int] = field(default_factory=dict)
    # jobs that reached >= minAvailable in an earlier tick (a completing
    # gang draining down is not an atomicity violation)
    ever_ready: Set[str] = field(default_factory=set)
    # queue names already beyond capability before the cycle ran
    # (grandfathered: node churn can strand a queue over its cap; only
    # the scheduler *pushing* it over is a violation)
    queues_over_before: Set[str] = field(default_factory=set)
    # engine-persistent {pod key: node} of the last audited bind per
    # still-bound pod; None disables the no_silent_rebind checker (unit
    # fixtures aiming at individual checkers don't carry a ledger)
    bind_ledger: Optional[Dict[str, str]] = None
    snapshot: Optional[object] = None


def _dims(r: Resource) -> Dict[str, float]:
    d = {"cpu": r.milli_cpu, "memory": r.memory}
    d.update(r.scalars)
    return d


def _res_delta(a: Resource, b: Resource) -> Dict[str, float]:
    da, db = _dims(a), _dims(b)
    return {k: da.get(k, 0.0) - db.get(k, 0.0)
            for k in set(da) | set(db)}


def allocated_task_count(job) -> int:
    return sum(len(tasks) for status, tasks in job.task_status_index.items()
               if allocated_status(status))


def queue_allocated(cache) -> Dict[str, Resource]:
    """Per-queue total of allocated-status task requests (cache view)."""
    totals: Dict[str, Resource] = {}
    for job in cache.jobs.values():
        if job.pod_group is None:
            continue
        for task in job.tasks.values():
            if not allocated_status(task.status):
                continue
            totals.setdefault(job.queue, Resource()).add(task.resreq)
    return totals


def queues_over_capability(cache, eps: float = EPS) -> Set[str]:
    over: Set[str] = set()
    totals = queue_allocated(cache)
    for name, q in cache.queues.items():
        cap = q.queue.spec.capability
        if not cap:
            continue
        cap_r = Resource.from_resource_list(cap)
        total = totals.get(name, Resource())
        # constrain only dims the capability NAMES (raw resource-list
        # keys, which match _dims' naming): Resource zero-fills missing
        # dims, and a cpu-only capability read as memory=0 would mark
        # the queue over-capability from tick 0 — grandfathering it out
        # of the check forever
        named = set(cap)
        if any(v > eps for k, v in _res_delta(total, cap_r).items()
               if k in named):
            over.add(name)
    return over


# -- checkers ---------------------------------------------------------------


def check_node_accounting(ctx: CycleContext,
                          eps: float = EPS) -> List[Violation]:
    out: List[Violation] = []
    cache = ctx.cache
    seen: Dict[str, str] = {}
    for node in cache.nodes.values():
        used = Resource()
        for key, task in node.tasks.items():
            if key in seen:
                out.append(Violation(
                    "node_accounting",
                    f"task {key} resident on both {seen[key]} and "
                    f"{node.name}"))
            seen[key] = node.name
            if task.status != TaskStatus.Pipelined:
                used.add(task.resreq)
        for dim, dv in _res_delta(node.used, used).items():
            if abs(dv) > eps:
                out.append(Violation(
                    "node_accounting",
                    f"node {node.name} used[{dim}] drifted {dv:+.3f} from "
                    f"its resident tasks"))
        for dim, v in _dims(node.idle).items():
            if v < -eps:
                out.append(Violation(
                    "node_accounting",
                    f"node {node.name} overcommitted: idle[{dim}]={v:.3f}"))
        total = node.idle.clone().add(node.used)
        for dim, dv in _res_delta(total, node.allocatable).items():
            if abs(dv) > eps:
                out.append(Violation(
                    "node_accounting",
                    f"node {node.name} idle+used != allocatable on {dim} "
                    f"(delta {dv:+.3f})"))
    return out


def check_gang_atomicity(ctx: CycleContext) -> List[Violation]:
    out: List[Violation] = []
    partial_now: Set[str] = set()
    for key, job in ctx.cache.jobs.items():
        if job.pod_group is None or job.min_available <= 0:
            continue
        if key in ctx.dirty_jobs or key in ctx.ever_ready:
            continue
        allocated = allocated_task_count(job)
        if 0 < allocated < job.min_available:
            partial_now.add(key)
            streak = ctx.partial_streaks.get(key, 0) + 1
            ctx.partial_streaks[key] = streak
            if streak > ctx.gang_converge_ticks:
                out.append(Violation(
                    "gang_atomicity",
                    f"job {key} partially bound: {allocated}/"
                    f"{job.min_available} allocated (gang of "
                    f"{len(job.tasks)}) for {streak} consecutive tick(s) "
                    f"(convergence window {ctx.gang_converge_ticks})"))
    for key in [k for k in ctx.partial_streaks if k not in partial_now]:
        del ctx.partial_streaks[key]   # converged (or job gone)
    return out


def check_queue_quota(ctx: CycleContext, eps: float = EPS) -> List[Violation]:
    out: List[Violation] = []
    over_now = queues_over_capability(ctx.cache, eps)
    for name in over_now - ctx.queues_over_before:
        q = ctx.cache.queues.get(name)
        cap = q.queue.spec.capability if q is not None else None
        out.append(Violation(
            "queue_quota",
            f"queue {name} pushed beyond capability {cap} by this cycle's "
            "binds"))
    return out


def check_no_orphans(ctx: CycleContext) -> List[Violation]:
    out: List[Violation] = []
    store, cache = ctx.store, ctx.cache
    # list_refs: read-only audit over live store objects (no clones —
    # cloning the whole cluster per tick would dwarf the audited cycle)
    store_pods = {p.metadata.key(): p for p in store.list_refs("pods")}
    store_nodes = {n.metadata.name for n in store.list_refs("nodes")}
    for key, pod in store_pods.items():
        if not pod.spec.node_name or is_terminated_phase(pod):
            continue
        if pod.spec.node_name not in store_nodes:
            out.append(Violation(
                "no_orphans",
                f"pod {key} bound to node {pod.spec.node_name} which is "
                "gone from the store"))
            continue
        node = cache.nodes.get(pod.spec.node_name)
        if node is None:
            out.append(Violation(
                "no_orphans",
                f"pod {key} bound to node {pod.spec.node_name} unknown to "
                "the cache"))
        elif key not in node.tasks:
            out.append(Violation(
                "no_orphans",
                f"pod {key} bound to {pod.spec.node_name} but not "
                "accounted on it"))
    for job in cache.jobs.values():
        for task in job.tasks.values():
            if allocated_status(task.status) and task.key() not in store_pods:
                out.append(Violation(
                    "no_orphans",
                    f"cache task {task.key()} ({task.status.name}) has no "
                    "store pod"))
    return out


def is_terminated_phase(pod) -> bool:
    return pod.status.phase in ("Succeeded", "Failed")


def check_snapshot_coherence(ctx: CycleContext,
                             eps: float = EPS) -> List[Violation]:
    out: List[Violation] = []
    store, cache = ctx.store, ctx.cache
    snap = ctx.snapshot if ctx.snapshot is not None else cache.snapshot()
    # cache tasks mirror store pods exactly (this scheduler's pods)
    cache_keys = {t.key() for j in cache.jobs.values()
                  for t in j.tasks.values()}
    store_keys = {p.metadata.key() for p in store.list_refs("pods")
                  if p.spec.scheduler_name == cache.scheduler_name}
    for key in cache_keys - store_keys:
        out.append(Violation("snapshot_coherence",
                             f"cache task {key} has no store pod"))
    for key in store_keys - cache_keys:
        out.append(Violation("snapshot_coherence",
                             f"store pod {key} missing from the cache"))
    # snapshot nodes are exactly the ready cache nodes, with equal idle
    ready = {n.name for n in cache.nodes.values() if n.ready()}
    snap_nodes = set(snap.nodes)
    for name in ready ^ snap_nodes:
        out.append(Violation(
            "snapshot_coherence",
            f"node {name} {'missing from' if name in ready else 'extra in'}"
            " the snapshot"))
    for name in ready & snap_nodes:
        delta = _res_delta(snap.nodes[name].idle, cache.nodes[name].idle)
        for dim, dv in delta.items():
            if abs(dv) > eps:
                out.append(Violation(
                    "snapshot_coherence",
                    f"snapshot idle[{dim}] of {name} drifted {dv:+.3f} "
                    "from the live cache"))
    # snapshot jobs carry the same task sets as the live cache
    for uid, sjob in snap.jobs.items():
        cjob = cache.jobs.get(uid)
        if cjob is None:
            out.append(Violation("snapshot_coherence",
                                 f"snapshot job {uid} not in the cache"))
            continue
        if set(sjob.tasks) != set(cjob.tasks):
            out.append(Violation(
                "snapshot_coherence",
                f"snapshot job {uid} task set drifted "
                f"({len(sjob.tasks)} vs {len(cjob.tasks)})"))
    return out


def check_journal_order(ctx: CycleContext) -> List[Violation]:
    """The store journal under the parallel bind flush: rvs strictly
    contiguous ascending, tail == watch-visible rv, and every
    reservation fully published by the tick's flush barrier."""
    out: List[Violation] = []
    store = ctx.store
    if not hasattr(store, "_journal"):
        return out   # remote mirror: no local journal to audit
    with store._lock:
        entries = list(store._journal)
        tail = store._journal_tail
        parked = dict(store._journal_parked)
        inflight = {k: set(v) for k, v in store._inflight.items() if v}
        alloc = store._rv
    prev = None
    for rv, _action, _kind, _obj in entries:
        if prev is not None and rv != prev + 1:
            out.append(Violation(
                "journal_order",
                f"journal gap: rv {prev} followed by {rv}"))
            break
        prev = rv
    if entries and entries[-1][0] != tail:
        out.append(Violation(
            "journal_order",
            f"journal tail {tail} != last entry rv {entries[-1][0]}"))
    if parked:
        out.append(Violation(
            "journal_order",
            f"{len(parked)} journal entries still parked at the flush "
            f"barrier (tail {tail}, reserved through {alloc})"))
    if inflight:
        out.append(Violation(
            "journal_order",
            f"in-flight patch keys left open at the flush barrier: "
            f"{ {k: len(v) for k, v in inflight.items()} }"))
    if tail != alloc and not parked:
        out.append(Violation(
            "journal_order",
            f"allocated rv {alloc} never published (tail {tail})"))
    return out


def check_no_silent_rebind(ctx: CycleContext) -> List[Violation]:
    """Reconcile the persistent bind ledger against the store: every
    currently bound pod either matches its last audited node, or is a
    NEW binding (key absent — first bind, or re-bind after an observed
    unbind/delete dropped it from the ledger). A bound pod whose node
    CHANGED with no unbind in between means two writers each believed
    they placed it — the deposed-leader double-bind that lease fencing
    must prevent. Unbound/deleted pods fall out of the ledger here, so a
    legitimate heal-then-replace (always >= one audited tick apart,
    docs/design/resilience.md) never trips it."""
    out: List[Violation] = []
    ledger = ctx.bind_ledger
    if ledger is None:
        return out
    bound_now: Dict[str, str] = {}
    for p in ctx.store.list_refs("pods"):
        if p.spec.node_name and not is_terminated_phase(p):
            bound_now[p.metadata.key()] = p.spec.node_name
    for key, node in bound_now.items():
        last = ledger.get(key)
        if last is not None and last != node:
            out.append(Violation(
                "no_silent_rebind",
                f"pod {key} moved {last} -> {node} with no observed "
                "unbind/delete between the placements (double-bind "
                "signature: a second writer landed a bind over a live "
                "one)"))
    ledger.clear()
    ledger.update(bound_now)
    return out


def _node_topology_value(ctx: CycleContext, node_name: str, key: str):
    ni = ctx.cache.nodes.get(node_name)
    if ni is not None:
        v = ni.topology_value(key)
        if v is not None:
            return v
    n = ctx.store.get("nodes", node_name)
    return n.metadata.labels.get(key) if n is not None else None


def check_spread_skew(ctx: CycleContext) -> List[Violation]:
    """Hard topology-spread honored at placement: for every FULL gang
    (min_available == gang size — the shape whose membership preemption
    and gang healing never shrink) carrying a DoNotSchedule spread
    constraint and untouched by churn, the per-domain counts of its
    allocated tasks stay within max_skew once the gang is fully placed.
    Partially-placed gangs are the gang_atomicity checker's business;
    jobs whose pods churned away (node kill, evict storm, pod_fail) can
    skew without scheduler fault and are exempt like everywhere else."""
    out: List[Violation] = []
    for key, job in ctx.cache.jobs.items():
        if key in ctx.dirty_jobs or job.min_available < len(job.tasks) \
                or not job.tasks:
            continue
        placed = [t for t in job.tasks.values()
                  if t.node_name and allocated_status(t.status)]
        if len(placed) < len(job.tasks):
            continue   # not fully placed this tick
        rep = next(iter(job.tasks.values()))
        for c in rep.pod.spec.topology_spread:
            if c.when_unsatisfiable != "DoNotSchedule":
                continue
            counts: Dict[str, int] = {}
            unlabeled = 0
            for t in placed:
                v = _node_topology_value(ctx, t.node_name, c.topology_key)
                if v is None:
                    unlabeled += 1
                else:
                    counts[v] = counts.get(v, 0) + 1
            if unlabeled:
                out.append(Violation(
                    "spread_skew",
                    f"job {key}: {unlabeled} pod(s) placed on nodes "
                    f"missing topology label {c.topology_key} despite a "
                    "hard spread constraint over it"))
            if counts and max(counts.values()) - min(counts.values()) \
                    > c.max_skew:
                out.append(Violation(
                    "spread_skew",
                    f"job {key}: per-{c.topology_key} counts {counts} "
                    f"violate max_skew {c.max_skew}"))
    return out


def check_anti_affinity(ctx: CycleContext) -> List[Violation]:
    """Required self-anti-affinity honored at placement: no two allocated
    siblings matched by the same required pod-anti-affinity term share
    that term's topology domain. Scoped to SELF-matching terms (the
    one-replica-per-domain gang idiom the compiler lowers); churn-dirty
    jobs are exempt for the same reason as everywhere else."""
    from ..ops.constraints import _self_anti_terms
    out: List[Violation] = []
    for key, job in ctx.cache.jobs.items():
        if key in ctx.dirty_jobs or not job.tasks:
            continue
        rep = next(iter(job.tasks.values()))
        for term in _self_anti_terms(rep):
            domains: Dict[str, List[str]] = {}
            for t in job.tasks.values():
                if not t.node_name or not allocated_status(t.status):
                    continue
                v = _node_topology_value(ctx, t.node_name,
                                         term.topology_key)
                if v is not None:
                    domains.setdefault(v, []).append(t.key())
            for v, pods in domains.items():
                if len(pods) > 1:
                    out.append(Violation(
                        "anti_affinity",
                        f"job {key}: pods {pods} share "
                        f"{term.topology_key}={v} despite required "
                        "self-anti-affinity over that key"))
    return out


CHECKERS = (check_node_accounting, check_gang_atomicity, check_queue_quota,
            check_no_orphans, check_snapshot_coherence, check_journal_order,
            check_no_silent_rebind, check_spread_skew, check_anti_affinity)


def check_all(ctx: CycleContext) -> List[Violation]:
    """Run the whole catalog under the cache lock (the engine calls this
    between cycles, when the executors are flushed; the RLock makes the
    nested ``snapshot()`` reentrant)."""
    out: List[Violation] = []
    with ctx.cache.mutex:
        if ctx.snapshot is None:
            ctx.snapshot = ctx.cache.snapshot()
        for checker in CHECKERS:
            out.extend(checker(ctx))
    return out
