"""allocate: the hot-path action (counterpart of
volcano_tpu/actions/allocate.py).

Mirrors pkg/scheduler/actions/allocate/allocate.go with the per-task loop
replaced by the batched placement solver:

1. Collect allocatable jobs (PodGroup not Pending-phase, JobValid, queue
   exists, queue not Overused) -- allocate.go:60-103.
2. Order host-side: namespaces by NamespaceOrderFn, queues by QueueOrderFn,
   jobs by JobOrderFn, each job's pending non-best-effort tasks by
   TaskOrderFn -- allocate.go:54-96,183-196.
3. Place in two solver phases, preserving the reference's breadth-first
   behavior (a ready job re-queues its extra tasks, allocate.go:258-262):
   phase A places each job's tasks up to its remaining minAvailable with
   gang commit/rollback in-kernel; phase B places the committed/kept jobs'
   surplus tasks with no gang constraint.
4. Apply to the session through a Statement per job: JobReady -> Commit
   (binds), JobPipelined -> keep, else Discard -- allocate.go:264-270.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from ..framework.plugin import Action
from ..framework.registry import register_action
from ..framework.solver import Placement
from ..framework.statement import Statement
from ..metrics import metrics as m
from ..models.job_info import JobInfo, TaskInfo, TaskStatus
from ..models.objects import PodGroupPhase
from ..models.resource import ZERO, Resource
from ..trace import ledger
from ..trace import tracer as trace
from ..utils.reservation import RESERVATION


class AllocateAction(Action):
    def name(self) -> str:
        return "allocate"

    def execute(self, ssn) -> None:
        # reservation-locked nodes are masked for every job except the
        # reservation target they are held for (allocate.go:98-107; the
        # exemption realizes the reservation design's intent)
        if RESERVATION.target_job is not None and RESERVATION.locked_nodes:
            locked = set(RESERVATION.locked_nodes)
            target_uid = RESERVATION.target_job.uid

            def locked_mask(batch, narr, feats):
                node_open = np.array([name not in locked
                                      for name in narr.names] +
                                     [True] * (narr.idle.shape[0]
                                               - len(narr.names)))
                mask = np.ones((batch.g_pad, narr.idle.shape[0]), bool)
                for g, members in enumerate(batch.group_members):
                    if batch.tasks[members[0]].job != target_uid:
                        mask[g] &= node_open
                return mask

            ssn.solver.add_mask_fn(locked_mask)
            try:
                self._execute_inner(ssn)
            finally:
                ssn.solver.mask_fns.remove(locked_mask)
        else:
            self._execute_inner(ssn)

    # -- ordering ----------------------------------------------------------

    def _ordered_jobs(self, ssn) -> List[JobInfo]:
        """(namespace, queue, job) nested ordering, flattened."""
        # steady-state fast path: with no Pending task anywhere there is
        # nothing to order or place (taskless jobs are excluded from the
        # encode anyway — TaskBatch.build — and resolve their readiness
        # from existing occupancy in place())
        if not any(job.task_status_index.get(TaskStatus.Pending)
                   for job in ssn.jobs.values()):
            return []

        # the scoped working set (docs/design/incremental_cycle.md): on an
        # incremental cycle where no node changed, a pending job outside
        # the patched and touched jobs is in the state it was last
        # evaluated in, against the same cluster, and would repeat last
        # cycle's no-placement (a placement would have dirtied it), so it
        # is skipped. A patched node (or a full rebuild) widens the set to
        # every pending job: changed capacity can unlock any of them.
        # Reservation locks are session-global state with no cache delta
        # (elect and reserve lock and unlock nodes on their own clock), so
        # a live or just-changed lock state widens too: a job parked by a
        # lock must be evaluated again the cycle the lock lifts.
        working = None
        if ssn.incr_mode == "incremental" and not ssn.patched_nodes \
                and not self._reservation_active_or_changed(ssn):
            working = set(ssn.patched_jobs or ()) | ssn.touched_jobs
        skipped_jobs = skipped_tasks = 0

        jobs_by_ns_queue: Dict[str, Dict[str, List[JobInfo]]] = {}
        for job in ssn.jobs.values():
            if working is not None and job.uid not in working:
                n_pending = len(job.task_status_index.get(
                    TaskStatus.Pending, ()))
                if n_pending:
                    skipped_jobs += 1
                    skipped_tasks += n_pending
                continue
            if job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            if job.queue not in ssn.queues:
                continue
            jobs_by_ns_queue.setdefault(job.namespace, {}) \
                .setdefault(job.queue, []).append(job)
        if skipped_jobs:
            trace.tag_cycle(skipped_jobs=skipped_jobs,
                            skipped_tasks=skipped_tasks)

        import functools
        ns_sorted = sorted(
            jobs_by_ns_queue,
            key=functools.cmp_to_key(
                lambda a, b: -1 if ssn.namespace_order_fn(a, b) else 1))
        job_key = functools.cmp_to_key(
            lambda a, b: -1 if ssn.job_order_fn(a, b) else 1)

        qnames = {q for per_q in jobs_by_ns_queue.values() for q in per_q}
        queues = [ssn.queues[q] for q in qnames
                  if not ssn.overused(ssn.queues[q])]
        queues.sort(key=functools.cmp_to_key(
            lambda a, b: -1 if ssn.queue_order_fn(a, b) else 1))

        # namespace-major encode (allocate.go:120-162): jobs are fed in
        # session-open namespace order, then queue order, then job order —
        # the kernel re-selects the namespace (live weighted share when the
        # drf namespace order is active, else this static order) and the
        # best non-overused queue within it at every job boundary, so the
        # encode order only decides ties (models/arrays.py TaskBatch)
        ordered: List[JobInfo] = []
        for ns in ns_sorted:
            per_q = jobs_by_ns_queue[ns]
            for q in queues:
                jobs = per_q.get(q.name)
                if jobs:
                    jobs.sort(key=job_key)
                    ordered.extend(jobs)
        return ordered

    @staticmethod
    def _reservation_active_or_changed(ssn) -> bool:
        """True while reservation locks are live or the lock state
        differs from the previous cycle's (the unlock itself carries no
        cache delta, so the cycle it happens on must evaluate every
        pending job again)."""
        state = (RESERVATION.target_job.uid
                 if RESERVATION.target_job is not None else None,
                 frozenset(RESERVATION.locked_nodes))
        cache = ssn.cache
        prev = getattr(cache, "_incr_reservation_state", None) \
            if cache is not None else None
        if cache is not None:
            cache._incr_reservation_state = state
        if state != (None, frozenset()):
            return True
        return prev is not None and prev != state

    def _pending_tasks(self, ssn, job: JobInfo) -> List[TaskInfo]:
        """Pending, non-best-effort, task-order sorted (allocate.go:183-196).
        Pods the cache made bind-ineligible (quarantine, bind-failure
        backoff) are skipped this cycle."""
        ineligible = ssn.ineligible_binds
        tasks = [t for t in job.task_status_index.get(TaskStatus.Pending, {}).values()
                 if not t.resreq.is_empty() and t.key() not in ineligible]
        fns = ssn._enabled_fns("task_order_fns")
        if all(getattr(fn, "standard_priority_order", False)
               for _, _, fn in fns):
            # no order fn beyond the standard priority comparator (or none
            # at all): the dispatch result is exactly (priority desc, uid
            # asc) — a key sort instead of a cmp_to_key dispatch per
            # comparison (50k comparisons per burst cycle)
            tasks.sort(key=lambda t: (-t.priority, t.uid))
            return tasks
        import functools
        tasks.sort(key=functools.cmp_to_key(
            lambda a, b: -1 if ssn.task_order_fn(a, b) else 1))
        return tasks

    # -- main --------------------------------------------------------------

    def _execute_inner(self, ssn) -> None:
        tick = time.perf_counter()
        with trace.span("ordered_jobs"):
            ordered_jobs = self._ordered_jobs(ssn)
        if not ordered_jobs:
            return

        pending: Dict[str, List[TaskInfo]] = {}
        phase_a = []
        for job in ordered_jobs:
            tasks = self._pending_tasks(ssn, job)
            if not tasks:
                continue
            pending[job.uid] = tasks
            need = max(0, job.min_available - job.ready_task_num())
            phase_a.append((job, tasks[:need] if need else []))

        tick = ssn.add_timing("allocate.order", tick)
        if not phase_a:
            return
        trace.tag_cycle(tasks_considered=sum(len(t) for t in pending.values()))
        if ledger.is_enabled():
            # lifecycle ledger: every task entering this cycle's allocate
            # batch is session-eligible (set once: a parked backlog stamps
            # only its first eligible cycle); applied after the cycle
            now = ssn.clock.now()
            ledger.defer(lambda: ledger.stamp_bulk(
                [t.key() for tasks in pending.values() for t in tasks],
                "session_eligible", now))

        result_a = ssn.solver.place([(j, t) for j, t in phase_a],
                                    allow_pipeline=True)
        self._stamp_placed(ssn, result_a)
        tick = ssn.add_timing("allocate.place", tick)

        # phase B: surplus tasks of jobs that survived phase A
        phase_b = []
        for job, tasks_a in phase_a:
            if not (result_a.committed[job.uid] or result_a.kept[job.uid]):
                continue
            surplus = pending[job.uid][len(tasks_a):]
            if surplus:
                shadow = _ZeroMinJob(job)
                phase_b.append((job, shadow, surplus))

        # phase A's claims must be visible to phase B's solver run;
        # stage them in session state first, then place surplus
        with trace.span("stage", jobs=len(phase_a)):
            staged = self._stage(ssn, phase_a, result_a)
        tick = ssn.add_timing("allocate.stage", tick)
        if phase_b:
            result_b = ssn.solver.place(
                [(shadow, ts) for _, shadow, ts in phase_b],
                allow_pipeline=True)
            self._stamp_placed(ssn, result_b)
            tick = ssn.add_timing("allocate.place", tick)
            with trace.span("apply_extra", jobs=len(phase_b)):
                self._apply_extra(ssn, staged, result_b, phase_b)
            tick = ssn.add_timing("allocate.stage", tick)
        with trace.span("finalize", jobs=len(staged)):
            self._finalize(ssn, phase_a, result_a, staged)
        ssn.add_timing("allocate.commit", tick)

    @staticmethod
    def _stamp_placed(ssn, result) -> None:
        if ledger.is_enabled():
            now = ssn.clock.now()
            ledger.defer(lambda: ledger.stamp_bulk(
                [p.task.key() for pls in result.placements.values()
                 for p in pls], "kernel_placed", now))

    # -- session application ----------------------------------------------

    def _stage(self, ssn, phase_a, result_a) -> Dict[str, Statement]:
        """Stage phase-A placements into session state.

        Phase-level bulk apply: placements are grouped per *node* across
        all committed jobs (the kernel's spreading scorers land ~T/N tasks
        per node, so per-gang node groups degenerate to singletons), fits
        are validated upfront against each node's idle, and the node
        accounting runs once per node instead of once per task. Each job
        still gets its own Statement (commit/discard unchanged) and its
        own batched plugin-event round. Jobs with volume-mounting tasks,
        missing nodes, or any validation failure take the per-job
        ``Statement.allocate_batch`` path, which re-validates from
        scratch."""
        staged: Dict[str, Statement] = {}
        slow: List = []    # (phase-A position, job, placements)
        bulk: List = []    # (job, [(task, node, pipelined)])
        pos_of: Dict[str, int] = {}
        for pos, (job, _) in enumerate(phase_a):
            if not (result_a.committed[job.uid] or result_a.kept[job.uid]):
                continue
            pos_of[job.uid] = pos
            pls = result_a.placements[job.uid]
            items = []
            for p in pls:
                node = ssn.nodes.get(p.node_name)
                if node is None:
                    items = None
                    break
                items.append((p.task, node, p.pipelined))
            if items is None:
                slow.append((pos, job, pls))
                continue
            if ssn.cache is not None and \
                    any(t.has_volumes for t, _, _ in items):
                slow.append((pos, job, pls))
                continue
            bulk.append((job, items))

        if bulk:
            failed = self._stage_bulk(ssn, bulk, staged, result_a)
            # fallbacks re-stage in phase-A priority order with the rest
            slow.extend((pos_of[job.uid], job, pls) for job, pls in failed)
            slow.sort(key=lambda e: e[0])

        if slow:
            # the per-task staging checks against live node state, so the
            # deferred placements are applied first
            ssn.materialize()
        for _, job, pls in slow:
            stmt = Statement(ssn)
            try:
                stmt.allocate_batch(
                    job, [(p.task, ssn.nodes[p.node_name], p.pipelined)
                          for p in pls])
            except (KeyError, RuntimeError, AssertionError):
                stmt.discard()
                continue
            staged[job.uid] = stmt
        return staged

    def _stage_bulk(self, ssn, bulk, staged: Dict[str, Statement],
                    result) -> List:
        """Apply ``bulk`` = [(job, [(task, node, pipelined)])] with
        per-node accounting. Returns the jobs that must retry on the
        per-job path (as (job, placements-like) pairs rebuilt lazily).
        On any unexpected apply failure everything staged here is undone
        and ALL bulk jobs are returned for the per-job path.

        Under the deferred apply (the default) each gang is only recorded
        (``Statement.record_batch_deferred``: node_name markers and the
        job's deltas) and its staging runs at ``Session.materialize``."""
        if ssn.solver.deferred_apply:
            # the deferred fast path: the kernel's vectorized totals stand
            # in for the per-task Resource sums, and the fit check is one
            # array compare, which fails only on internal drift and then
            # routes the gangs on those nodes to the per-job path
            rindex = ssn.solver.rindex
            narr = result.narr
            failed_uids = set()
            if result.node_alloc_vec is not None:
                over = (result.node_alloc_vec >
                        narr.idle + rindex.eps[None, :]).any(axis=1)
                if over.any():
                    bad = {narr.names[i] for i in np.flatnonzero(over)
                           if i < len(narr.names)}
                    for job, items in bulk:
                        if any((not p) and node.name in bad
                               for _, node, p in items):
                            failed_uids.add(job.uid)
            for job, items in bulk:
                if job.uid in failed_uids:
                    continue
                for t, node, pipelined in items:
                    t.node_name = node.name
                stmt = Statement(ssn)
                vec = result.job_total_vec.get(job.uid)
                stmt.record_batch_deferred(
                    job, items,
                    total=rindex.resource(vec) if vec is not None
                    else None)
                staged[job.uid] = stmt
            return [(job, [Placement(t, n.name, p) for t, n, p in items])
                    for job, items in bulk if job.uid in failed_uids]

        # upfront fit validation per (node, allocated) group; the group
        # totals are kept and reused by add_tasks_bulk below
        groups: Dict[int, tuple] = {}
        for job, items in bulk:
            for task, node, pipelined in items:
                key = (id(node), pipelined)
                g = groups.get(key)
                if g is None:
                    g = (node, pipelined, [], Resource())
                    groups[key] = g
                g[2].append((task, job))
                g[3].add(task.resreq)
        failed_uids = set()
        for node, pipelined, entries, total in groups.values():
            if pipelined or node.node is None:
                continue
            if not total.less_equal(node.idle, ZERO):
                failed_uids.update(j.uid for _, j in entries)

        moved: List = []   # (job, tasks, prior-status) applied status moves
        added: List = []   # (node, pipelined, tasks) applied node adds
        flips: Dict[str, Optional[Resource]] = {}   # job uid -> alloc sum
        try:
            ok_jobs = []
            for job, items in bulk:
                if job.uid in failed_uids:
                    continue
                alloc = [t for t, _, p in items if not p]
                pipe = [t for t, _, p in items if p]
                try:
                    if alloc:
                        flips[job.uid] = job.move_tasks_status_bulk(
                            alloc, TaskStatus.Allocated)
                        moved.append((job, alloc))
                    if pipe:
                        job.move_tasks_status_bulk(pipe,
                                                   TaskStatus.Pipelined)
                        moved.append((job, pipe))
                except KeyError:
                    if alloc and moved and moved[-1][0] is job:
                        moved.pop()
                        job.move_tasks_status_bulk(alloc,
                                                   TaskStatus.Pending)
                    failed_uids.add(job.uid)
                    continue
                ok_jobs.append((job, items))
            no_failures = not failed_uids
            for node, pipelined, entries, total in groups.values():
                if no_failures:
                    tasks = [t for t, _ in entries]
                elif any(j.uid in failed_uids for _, j in entries):
                    tasks = [t for t, j in entries
                             if j.uid not in failed_uids]
                    total = None   # stale sum: includes dropped jobs
                else:
                    tasks = [t for t, _ in entries]
                if not tasks:
                    continue
                node.add_tasks_bulk(tasks, pipelined, total=total,
                                    share_objects=True)
                added.append((node, pipelined, tasks))
                if not pipelined:
                    name = node.name
                    for t in tasks:
                        t.pod.spec.node_name = name
        except BaseException:
            # unexpected apply failure (pre-validated, so ~impossible):
            # undo everything staged here and retry all jobs per-job
            for node, pipelined, tasks in reversed(added):
                for t in tasks:
                    node.remove_task(t)
                    t.node_name = ""
                    if not pipelined:
                        t.pod.spec.node_name = ""
            for job, tasks in reversed(moved):
                job.move_tasks_status_bulk(tasks, TaskStatus.Pending)
            return [(job, [Placement(t, n.name, p) for t, n, p in items])
                    for job, items in bulk]

        for job, items in ok_jobs:
            stmt = Statement(ssn)
            # the allocated-flip sum equals the gang total only when no
            # task was pipelined (flip excludes Pipelined status)
            total = flips.get(job.uid) \
                if all(not p for _, _, p in items) else None
            stmt.record_batch(job, items, total=total)
            staged[job.uid] = stmt
        return [(job, [Placement(t, n.name, p) for t, n, p in items])
                for job, items in bulk if job.uid in failed_uids]

    def _apply_extra(self, ssn, staged, result_b, phase_b) -> None:
        """Stage surplus placements onto the same statements."""
        for job, shadow, _ in phase_b:
            stmt = staged.get(job.uid)
            if stmt is None:
                continue
            try:
                stmt.allocate_batch(
                    job, [(p.task, ssn.nodes[p.node_name], p.pipelined)
                          for p in result_b.placements.get(shadow.uid, [])
                          if p.node_name in ssn.nodes],
                    keep_partial=True)  # surplus is best-effort
            except (KeyError, RuntimeError, AssertionError):
                # a volume-mounting surplus task takes the per-task path
                # inside allocate_batch and can still raise; the gang
                # itself stays staged either way
                pass

    def _finalize(self, ssn, phase_a, result_a, staged) -> None:
        """JobReady -> Commit; JobPipelined -> keep; else Discard."""
        committed = pipelined = discarded = binds = 0
        for job, _ in phase_a:
            stmt = staged.get(job.uid)
            if stmt is None:
                continue
            if ssn.job_ready(job):
                binds += sum(len(getattr(op, "items", ())) or 1
                             for op in stmt.operations)
                stmt.commit()
                committed += 1
                m.register_schedule_attempt("scheduled")
            elif ssn.job_pipelined(job):
                pipelined += 1   # keep the claims in session state
            else:
                stmt.discard()
                discarded += 1
                m.register_schedule_attempt("unschedulable")
        trace.add_tags(committed=committed, pipelined=pipelined,
                       discarded=discarded)
        trace.tag_cycle(committed_tasks=binds)


class _ZeroMinJob:
    """A shadow of a job with min_available 0, for gang-free surplus
    placement (the reference achieves this by re-queuing ready jobs)."""

    def __init__(self, job: JobInfo):
        self._job = job
        self.uid = job.uid
        self.min_available = 0

    def ready_task_num(self) -> int:
        return 0

    def __getattr__(self, item):
        return getattr(self._job, item)


register_action(AllocateAction())
