"""Global resource-reservation state (the port's own copy of
volcano_tpu/utils/reservation.py; reference: pkg/scheduler/util/
scheduler_helper.go:36-45,253-268): the elect action picks a TargetJob, the
reserve action locks nodes for it via the reservation plugin, and allocate
excludes locked nodes for every other job until the target schedules.
"""

from __future__ import annotations

from typing import Dict


class ResourceReservation:
    def __init__(self):
        self.target_job = None                     # JobInfo
        self.locked_nodes: Dict[str, object] = {}  # name -> NodeInfo

    def reset(self) -> None:
        self.target_job = None
        self.locked_nodes.clear()


RESERVATION = ResourceReservation()
