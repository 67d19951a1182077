"""preempt: intra-queue preemption for starving jobs (the port's own copy
of volcano_tpu/actions/preempt.py).

Mirrors pkg/scheduler/actions/preempt/preempt.go: classify starving jobs
(JobStarving), then per queue pop preemptor jobs by JobOrder and their
pending tasks by TaskOrder; changes are staged on a Statement and committed
only when the job reaches JobPipelined (preempt.go:132-138). Intra-job task
preemption (preempt.go:146-183) and plugin VictimTasks eviction
(preempt.go:273-284) follow.

Batched evaluation (framework/victims.py): the snapshot encode happens ONCE
per action execution for every preemptor task, candidate victims live in a
flat incremental index, and each preemptor costs one vectorized
all-nodes feasibility pass plus plugin filtering for the few nodes actually
visited in score order — instead of the reference's per-preemptor
full-cluster sweeps. The context's placements by victim-selection path
add into ``ssn.victim_runs``. The reference's metrics, trace spans and
bind-quarantine filter are not ported.
"""

from __future__ import annotations

import functools
from typing import Dict, List

from ..framework.plugin import Action
from ..framework.registry import register_action
from ..framework.statement import Statement
from ..framework.victims import INTER_JOB, INTRA_JOB, PreemptContext
from ..models.job_info import JobInfo, TaskInfo, TaskStatus
from ..models.objects import PodGroupPhase


class PreemptAction(Action):
    def name(self) -> str:
        return "preempt"

    def execute(self, ssn) -> None:
        preemptors_map: Dict[str, List[JobInfo]] = {}   # queue -> jobs
        preemptor_tasks: Dict[str, List[TaskInfo]] = {}  # job uid -> tasks
        under_request: List[JobInfo] = []
        queues = {}

        for job in ssn.jobs.values():
            if job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            queues[queue.uid] = queue
            if ssn.job_starving(job):
                preemptors_map.setdefault(job.queue, []).append(job)
                under_request.append(job)
                preemptor_tasks[job.uid] = self._pending_tasks(ssn, job)

        if not under_request:
            self._victim_tasks(ssn)
            return

        # one batched encode for ALL preemptor tasks of the action
        ctx = PreemptContext(
            ssn, [(job, list(preemptor_tasks[job.uid]))
                  for job in under_request if preemptor_tasks.get(job.uid)])

        job_key = functools.cmp_to_key(
            lambda a, b: -1 if ssn.job_order_fn(a, b) else 1)

        # preemption between jobs within a queue (preempt.go:83-143);
        # priority-queue pop/re-push like the reference's preemptorsQueue
        # (rebuilding the order per pop is O(n^2 log n) at 5k starving jobs)
        import heapq
        for queue in queues.values():
            jobs_list = preemptors_map.get(queue.name)
            if not jobs_list:
                continue
            heap = [job_key(j) for j in jobs_list]
            heapq.heapify(heap)
            while heap:
                preemptor_job = heapq.heappop(heap).obj

                stmt = Statement(ssn)
                ctx.checkpoint()
                assigned = False
                while ssn.job_starving(preemptor_job):
                    tasks = preemptor_tasks.get(preemptor_job.uid)
                    if not tasks:
                        break
                    preemptor = tasks.pop(0)
                    if self._preempt(ctx, stmt, preemptor, INTER_JOB):
                        assigned = True

                if ssn.job_pipelined(preemptor_job):
                    stmt.commit()
                    ctx.commit()
                else:
                    stmt.discard()
                    ctx.rollback()
                    continue
                if assigned:
                    heapq.heappush(heap, job_key(preemptor_job))

        # preemption between tasks within a job (preempt.go:146-183)
        for job in under_request:
            tasks = self._pending_tasks(ssn, job)
            while tasks:
                preemptor = tasks.pop(0)
                stmt = Statement(ssn)
                ctx.checkpoint()
                assigned = self._preempt(ctx, stmt, preemptor, INTRA_JOB)
                stmt.commit()
                ctx.commit()
                if not assigned:
                    break

        for path, n in ctx.runs.items():
            ssn.victim_runs[path] = ssn.victim_runs.get(path, 0) + n
        self._victim_tasks(ssn)

    # ------------------------------------------------------------------

    def _pending_tasks(self, ssn, job: JobInfo) -> List[TaskInfo]:
        tasks = list(job.task_status_index.get(TaskStatus.Pending,
                                               {}).values())
        tasks.sort(key=functools.cmp_to_key(
            lambda a, b: -1 if ssn.task_order_fn(a, b) else 1))
        return tasks

    def _preempt(self, ctx: PreemptContext, stmt: Statement,
                 preemptor: TaskInfo, mode: str) -> bool:
        """One preemptor placement (preempt.go:192-271)."""
        res = ctx.place(preemptor, mode)
        if res is None:
            return False
        node_name, victims, _covered = res
        for victim in victims:
            # clone: status flips must not touch the node's accounting copy
            # (preempt.go:215-218)
            try:
                stmt.evict(victim.clone(), "preempt")
            except KeyError:
                continue
            ctx.apply_evict(node_name, victim)
        try:
            stmt.pipeline(preemptor, node_name)
        except KeyError:
            return False
        ctx.apply_pipeline(node_name, preemptor)
        return True

    def _victim_tasks(self, ssn) -> None:
        """Evict every plugin-nominated victim (tdm drain, preempt.go:
        273-284)."""
        victims = ssn.victim_tasks()
        if not victims:
            return
        stmt = Statement(ssn)
        for victim in victims:
            try:
                stmt.evict(victim.clone(), "evict")  # preempt.go:277
            except KeyError:
                continue
        stmt.commit()


register_action(PreemptAction())
