"""reserve: maintain locked nodes for the elected target job (the
port's own copy of volcano_tpu/actions/reserve.py).

Mirrors pkg/scheduler/actions/reserve/reserve.go:43-77: while the target
job exists and is not Ready, the ReservedNodes plugin fn locks one more
node per cycle; once it schedules (or disappears) the reservation resets.
"""

from __future__ import annotations

from ..framework.plugin import Action
from ..framework.registry import register_action
from ..utils.reservation import RESERVATION


class ReserveAction(Action):
    def name(self) -> str:
        return "reserve"

    def execute(self, ssn) -> None:
        if RESERVATION.target_job is None:
            return
        target = ssn.jobs.get(RESERVATION.target_job.uid)
        if target is None:
            RESERVATION.reset()
            return
        RESERVATION.target_job = target
        if not target.ready():
            ssn.materialize()   # node idle must include deferred placements
            ssn.reserved_nodes()
        else:
            RESERVATION.reset()


register_action(ReserveAction())
