"""elect: pick the reservation target job (the port's own copy of
volcano_tpu/actions/elect.py).

Mirrors pkg/scheduler/actions/elect/elect.go:29-48: when no target job is
held, ask the TargetJob plugin fn (reservation plugin: highest priority,
then longest waiting) to choose among Pending-phase jobs.
"""

from __future__ import annotations

from ..framework.plugin import Action
from ..framework.registry import register_action
from ..models.objects import PodGroupPhase
from ..utils.reservation import RESERVATION


class ElectAction(Action):
    def name(self) -> str:
        return "elect"

    def execute(self, ssn) -> None:
        if RESERVATION.target_job is not None:
            return
        pending = [job for job in ssn.jobs.values()
                   if job.pod_group.status.phase == PodGroupPhase.PENDING]
        RESERVATION.target_job = ssn.target_job(pending)


register_action(ElectAction())
