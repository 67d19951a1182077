"""reclaim: cross-queue reclamation for underserved queues (the port's own
copy of volcano_tpu/actions/reclaim.py).

Mirrors pkg/scheduler/actions/reclaim/reclaim.go: queues popped by
QueueOrder (skipping Overused ones), their jobs by JobOrder, one pending
task per turn; candidate victims are Running tasks of *other* queues whose
queue allows reclamation (reclaim.go:124-141), filtered by the Reclaimable
plugin intersection. Unlike preempt, evictions are immediate session evicts
(not statement-staged, reclaim.go:156-166) and the stop condition is the
summed victim resources alone covering the request (reclaim.go:149-181).

Uses the batched PreemptContext (framework/victims.py): one snapshot encode
for every reclaimer, flat incremental victim index, per-reclaimer
vectorized feasibility + lazy exact node descent — the reclaim_prefix
semantics without per-task re-encoding. The context's placements by
victim-selection path add into ``ssn.victim_runs``. The reference's
bind-quarantine filter is not ported.
"""

from __future__ import annotations

import functools
from typing import Dict, List

from ..framework.plugin import Action
from ..framework.registry import register_action
from ..framework.victims import CROSS_QUEUE, PreemptContext
from ..models.job_info import JobInfo, TaskInfo, TaskStatus
from ..models.objects import PodGroupPhase


class ReclaimAction(Action):
    def name(self) -> str:
        return "reclaim"

    def execute(self, ssn) -> None:
        queue_list = []
        queue_seen = set()
        preemptors_map: Dict[str, List[JobInfo]] = {}
        preemptor_tasks: Dict[str, List[TaskInfo]] = {}

        task_key = functools.cmp_to_key(
            lambda a, b: -1 if ssn.task_order_fn(a, b) else 1)
        job_key = functools.cmp_to_key(
            lambda a, b: -1 if ssn.job_order_fn(a, b) else 1)
        queue_key = functools.cmp_to_key(
            lambda a, b: -1 if ssn.queue_order_fn(a, b) else 1)

        for job in ssn.jobs.values():
            if job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            if queue.uid not in queue_seen:
                queue_seen.add(queue.uid)
                queue_list.append(queue)
            pending = list(job.task_status_index.get(TaskStatus.Pending,
                                                     {}).values())
            if pending:
                preemptors_map.setdefault(job.queue, []).append(job)
                pending.sort(key=task_key)
                preemptor_tasks[job.uid] = pending

        if not preemptor_tasks:
            return
        ctx = PreemptContext(
            ssn, [(job, list(preemptor_tasks[job.uid]))
                  for jobs in preemptors_map.values() for job in jobs])

        # queue priority loop (reclaim.go:84-188): pop best queue each turn,
        # re-pushing it after a task was attempted. Priority HEAPS (the
        # reference's util.PriorityQueue, same shape as preempt.py): the
        # cmp_to_key wrappers invoke the live order fns at every heap-sift
        # comparison — exactly a Go heap whose LessFn reads live shares —
        # so entries already in the heap see drifted keys, which the
        # reference tolerates identically. Re-sorting the job list on every
        # one of ~5k turns instead cost O(turns x J log J) order-fn
        # dispatches at the 5k x 10k benchmark.
        import heapq
        job_heaps: Dict[str, list] = {}
        for qname, jobs in preemptors_map.items():
            heap = [job_key(job) for job in jobs]
            heapq.heapify(heap)
            job_heaps[qname] = heap
        queue_heap = [queue_key(q) for q in queue_list]
        heapq.heapify(queue_heap)
        while queue_heap:
            queue = heapq.heappop(queue_heap).obj
            if ssn.overused(queue):
                continue
            heap = job_heaps.get(queue.name)
            if not heap:
                continue
            job = heapq.heappop(heap).obj
            tasks = preemptor_tasks.get(job.uid)
            if not tasks:
                # reference-exact: a popped job with no tasks left drops
                # the queue from this cycle's rotation (reclaim.go:107-111
                # continues without re-pushing) — its siblings reclaim in
                # subsequent cycles
                continue
            task = tasks.pop(0)

            assigned = self._reclaim(ssn, ctx, task)
            if assigned:
                heapq.heappush(heap, job_key(job))
            heapq.heappush(queue_heap, queue_key(queue))
        for path, n in ctx.runs.items():
            ssn.victim_runs[path] = ssn.victim_runs.get(path, 0) + n

    # ------------------------------------------------------------------

    def _reclaim(self, ssn, ctx: PreemptContext, task: TaskInfo) -> bool:
        """Place one reclaimer by evicting cross-queue victims
        (reclaim.go:114-182). The walk spans nodes: every visited node's
        victims are evicted immediately and stick even when they don't
        cover the request; the pipeline lands on the first covering node."""
        ctx.checkpoint()
        assigned = False
        while True:
            step = ctx.place(task, CROSS_QUEUE)
            if step is None:
                break
            node_name, victims, covered = step
            for victim in victims:
                try:
                    ssn.evict(victim.clone(), "reclaim")  # reclaim.go:138-140
                except KeyError:
                    ctx.mark_dead(victim)   # gone from session; don't retry
                    continue
                ctx.apply_evict(node_name, victim)
            if not covered:
                continue   # walk on: later filters see post-eviction state
            try:
                ssn.pipeline(task, node_name)
            except KeyError:
                break
            ctx.apply_pipeline(node_name, task)
            assigned = True
            break
        ctx.commit()
        return assigned


register_action(ReclaimAction())
