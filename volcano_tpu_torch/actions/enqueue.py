"""enqueue: gate Pending PodGroups into the Inqueue phase (the port's own
copy of volcano_tpu/actions/enqueue.py).

Mirrors pkg/scheduler/actions/enqueue/enqueue.go:43-103: queues popped by
QueueOrder round-robin, their Pending jobs by JobOrder; a job advances to
Inqueue when it declares no MinResources or the JobEnqueueable voters
(proportion / overcommit / sla) permit it, after which JobEnqueued
observers (overcommit) charge its resources.
"""

from __future__ import annotations

import functools
from typing import Dict, List

from ..framework.plugin import Action
from ..framework.registry import register_action
from ..models.job_info import JobInfo
from ..models.objects import PodGroupPhase
from ..trace import ledger
from ..trace import tracer as trace


class EnqueueAction(Action):
    def name(self) -> str:
        return "enqueue"

    def execute(self, ssn) -> None:
        queue_list = []
        queue_seen = set()
        jobs_map: Dict[str, List[JobInfo]] = {}

        for job in ssn.jobs.values():
            if not job.scheduling_start_time:
                job.scheduling_start_time = ssn.clock.now()
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            if queue.uid not in queue_seen:
                queue_seen.add(queue.uid)
                queue_list.append(queue)
            if job.pod_group.status.phase == PodGroupPhase.PENDING:
                jobs_map.setdefault(job.queue, []).append(job)

        queue_key = functools.cmp_to_key(
            lambda a, b: -1 if ssn.queue_order_fn(a, b) else 1)
        job_key = functools.cmp_to_key(
            lambda a, b: -1 if ssn.job_order_fn(a, b) else 1)

        inqueued = 0
        with trace.span("enqueue.gate"):
            while queue_list:
                queue_list.sort(key=queue_key)
                queue = queue_list.pop(0)
                jobs = jobs_map.get(queue.name)
                if not jobs:
                    continue
                jobs.sort(key=job_key)
                job = jobs.pop(0)

                if (job.pod_group.spec.min_resources is None
                        or ssn.job_enqueueable(job)):
                    ssn.job_enqueued(job)
                    job.own_pod_group().status.phase = PodGroupPhase.INQUEUE
                    ssn.touched_jobs.add(job.uid)
                    inqueued += 1
                    if ledger.is_enabled() and job.tasks:
                        # lifecycle ledger: pods whose group went Pending
                        # -> Inqueue this cycle (a group created Inqueue
                        # skips this hop)
                        ledger.stamp_bulk(
                            [t.key() for t in job.tasks.values()],
                            "enqueued", ssn.clock.now())

                queue_list.append(queue)
            trace.add_tags(inqueued=inqueued)


register_action(EnqueueAction())
