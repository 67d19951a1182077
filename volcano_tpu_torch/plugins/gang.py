"""gang plugin (the port's own copy of volcano_tpu/plugins/gang.py;
reference: pkg/scheduler/plugins/gang/gang.go).

Extension points: JobValid (minAvailable admission), Preemptable/Reclaimable
(victims only above minAvailable), JobOrder (ready jobs last), JobReady,
JobPipelined, JobStarving; OnSessionClose writes Unschedulable/Scheduled
PodGroup conditions (the reference's unschedulable metrics are not ported).

The gang *commit/rollback* semantics themselves live in the allocate kernel
(ops/allocate.py, csrc/gang_allocate.cu) whose per-job ready/kept flags
implement exactly this plugin's JobReady/JobPipelined formulas.
"""

from __future__ import annotations

from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from ..framework.session import PERMIT, REJECT, ValidateResult
from ..framework import framework as fw
from ..models.job_info import TaskStatus
from ..models.objects import (NOT_ENOUGH_PODS_REASON,
                              NOT_ENOUGH_RESOURCES_REASON, PodGroupCondition,
                              PodGroupConditionType, POD_GROUP_READY)
from ..models.unschedule_info import FitErrors

NAME = "gang"


class GangPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn) -> None:
        def valid_job_fn(job):
            """minAvailable admission (gang.go:50-79)."""
            if not job.check_task_min_available():
                return ValidateResult(
                    False, NOT_ENOUGH_PODS_REASON,
                    "Not enough valid pods of each task for gang-scheduling")
            vtn = job.valid_task_num()
            if vtn < job.min_available:
                return ValidateResult(
                    False, NOT_ENOUGH_PODS_REASON,
                    f"Not enough valid tasks for gang-scheduling, "
                    f"valid: {vtn}, min: {job.min_available}")
            return None

        ssn.add_job_valid_fn(NAME, valid_job_fn)

        def preemptable_fn(preemptor, preemptees):
            """Victims only while their job stays above minAvailable
            (gang.go:83-105)."""
            victims = []
            occupied = {}
            for preemptee in preemptees:
                job = ssn.jobs.get(preemptee.job)
                if job is None:
                    continue
                if job.uid not in occupied:
                    occupied[job.uid] = job.ready_task_num()
                if occupied[job.uid] > job.min_available:
                    occupied[job.uid] -= 1
                    victims.append(preemptee)
            return victims, PERMIT

        ssn.add_reclaimable_fn(NAME, preemptable_fn)
        ssn.add_preemptable_fn(NAME, preemptable_fn)

        def job_order_fn(l, r):
            """Unready jobs first (gang.go:111-134)."""
            l_ready, r_ready = l.ready(), r.ready()
            if l_ready and r_ready:
                return 0
            if l_ready:
                return 1
            if r_ready:
                return -1
            return 0

        ssn.add_job_order_fn(NAME, job_order_fn)
        ssn.add_job_ready_fn(NAME, lambda job: job.ready())

        def pipelined_fn(job):
            occupied = job.waiting_task_num() + job.ready_task_num()
            return PERMIT if occupied >= job.min_available else REJECT

        ssn.add_job_pipelined_fn(NAME, pipelined_fn)

        def job_starving_fn(job):
            occupied = job.waiting_task_num() + job.ready_task_num()
            return occupied < job.min_available

        ssn.add_job_starving_fns(NAME, job_starving_fn)

    def on_session_close(self, ssn) -> None:
        """Write gang conditions (gang.go:160-219)."""
        for job in ssn.jobs.values():
            if job.pod_group is None:
                continue
            if not job.ready():
                unready = job.min_available - job.ready_task_num()
                msg = (f"{unready}/{len(job.tasks)} tasks in gang "
                       f"unschedulable: {job.fit_error()}")
                job.job_fit_errors = msg
                fw.update_pod_group_condition(ssn, job, PodGroupCondition(
                    type=PodGroupConditionType.UNSCHEDULABLE, status="True",
                    transition_id=ssn.uid,
                    reason=NOT_ENOUGH_RESOURCES_REASON, message=msg))
                for task in job.task_status_index.get(TaskStatus.Allocated, {}).values():
                    if task.uid not in job.nodes_fit_errors:
                        fe = FitErrors()
                        fe.set_error(msg)
                        job.nodes_fit_errors[task.uid] = fe
            else:
                # refreshing an identical Scheduled condition would only
                # bump transition_id (nothing reads it for Scheduled —
                # job_status consults it for Unschedulable only), but it
                # claims a COW PodGroup per ready job per cycle; skip when
                # an equivalent condition is already present
                if not any(c.type == PodGroupConditionType.SCHEDULED
                           and c.status == "True"
                           and c.reason == POD_GROUP_READY
                           for c in job.pod_group.status.conditions):
                    fw.update_pod_group_condition(ssn, job, PodGroupCondition(
                        type=PodGroupConditionType.SCHEDULED, status="True",
                        transition_id=ssn.uid, reason=POD_GROUP_READY))


register_plugin_builder(NAME, GangPlugin)
