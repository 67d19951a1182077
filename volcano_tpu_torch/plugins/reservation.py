"""reservation plugin (the port's own copy of
volcano_tpu/plugins/reservation.py; reference: pkg/scheduler/plugins/
reservation/reservation.go).

TargetJob: among pending jobs, the highest priority, ties broken by the
longest wait since scheduling started (reservation.go:44-118). ReservedNodes:
each cycle lock the unlocked node with the most idle resources
(reservation.go:56-65,120-141).
"""

from __future__ import annotations

from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from ..models.resource import ZERO
from ..utils.reservation import RESERVATION

NAME = "reservation"


class ReservationPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn) -> None:
        def target_job_fn(jobs):
            if not jobs:
                return None
            highest = max(job.priority for job in jobs)
            candidates = [job for job in jobs if job.priority == highest]
            now = ssn.clock.now()

            def waited(job):
                start = job.scheduling_start_time or now
                return now - start

            return max(candidates, key=waited)

        ssn.add_target_job_fn(NAME, target_job_fn)

        def reserved_nodes_fn():
            max_idle = None
            for node in ssn.nodes.values():
                if node.name in RESERVATION.locked_nodes:
                    continue
                if max_idle is None or max_idle.idle.less_equal(node.idle,
                                                               ZERO):
                    max_idle = node
            if max_idle is not None:
                # only the name is ever consulted; storing the snapshot
                # NodeInfo would pin dead sessions in the process global
                RESERVATION.locked_nodes[max_idle.name] = None

        ssn.add_reserved_nodes_fn(NAME, reserved_nodes_fn)

    def on_session_close(self, ssn) -> None:
        pass


register_plugin_builder(NAME, ReservationPlugin)
