"""sla plugin (the port's own copy of volcano_tpu/plugins/sla.py;
reference: pkg/scheduler/plugins/sla/sla.go).

Service-level agreement on job waiting time: jobs whose Pending age
exceeds their ``sla-waiting-time`` (per-job annotation, falling back to the
plugin argument) jump the job order and are force-permitted by the
JobEnqueueable and JobPipelined voters (sla.go:103-149).
"""

from __future__ import annotations

from typing import Optional

from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from ..framework.session import ABSTAIN, PERMIT
from ..models.job_info import parse_duration

NAME = "sla"

JOB_WAITING_TIME = "sla-waiting-time"


class SlaPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        self.job_waiting_time: Optional[float] = None

    def name(self) -> str:
        return NAME

    def _waiting_time(self, job) -> Optional[float]:
        """Per-job setting wins over the global argument (sla.go:55-64)."""
        if job.waiting_time is not None:
            return job.waiting_time
        return self.job_waiting_time

    def on_session_open(self, ssn) -> None:
        if JOB_WAITING_TIME in self.arguments:
            jwt = parse_duration(self.arguments[JOB_WAITING_TIME])
            if jwt is not None and jwt > 0:
                self.job_waiting_time = jwt

        def job_order_fn(l, r):
            """Jobs with an SLA deadline order by creation + waiting time;
            jobs without one sort last (sla.go:103-130)."""
            ljwt, rjwt = self._waiting_time(l), self._waiting_time(r)
            if ljwt is None:
                return 0 if rjwt is None else 1
            if rjwt is None:
                return -1
            ldeadline = l.creation_timestamp + ljwt
            rdeadline = r.creation_timestamp + rjwt
            if ldeadline < rdeadline:
                return -1
            if ldeadline > rdeadline:
                return 1
            return 0

        ssn.add_job_order_fn(NAME, job_order_fn)

        def permitable_fn(job):
            jwt = self._waiting_time(job)
            if jwt is None:
                return ABSTAIN
            if ssn.clock.now() - job.creation_timestamp < jwt:
                return ABSTAIN
            return PERMIT

        ssn.add_job_enqueueable_fn(NAME, permitable_fn)
        ssn.add_job_pipelined_fn(NAME, permitable_fn)

    def on_session_close(self, ssn) -> None:
        pass


register_plugin_builder(NAME, SlaPlugin)
