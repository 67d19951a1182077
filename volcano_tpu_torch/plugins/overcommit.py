"""overcommit plugin (the port's own copy of
volcano_tpu/plugins/overcommit.py; reference: pkg/scheduler/plugins/
overcommit/overcommit.go).

Gates enqueue admission on overcommitted cluster headroom: idle =
total x factor - used (default factor 1.2, floor 1.0); a job may enter the
Inqueue phase only while the already-inqueue jobs' MinResources plus its
own fit that headroom. JobEnqueued charges admitted jobs against the
running total (overcommit.go:71-127).
"""

from __future__ import annotations

from ..framework.arguments import Arguments
from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from ..framework.session import PERMIT, REJECT
from ..models.objects import PodGroupPhase
from ..models.resource import Resource, ZERO

NAME = "overcommit"

OVERCOMMIT_FACTOR = "overcommit-factor"
DEFAULT_FACTOR = 1.2


class OvercommitPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = Arguments(arguments or {})
        self.idle = Resource()
        self.inqueue = Resource()
        self.factor = DEFAULT_FACTOR

    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn) -> None:
        self.factor = self.arguments.get_float(OVERCOMMIT_FACTOR,
                                               DEFAULT_FACTOR)
        if self.factor < 1.0:
            self.factor = DEFAULT_FACTOR

        total, used = Resource(), Resource()
        for node in ssn.nodes.values():
            total.add(node.allocatable)
            used.add(node.used)
        self.idle = total.clone().multi(self.factor)
        # fit_delta-style subtraction: used may exceed total x factor
        for name in used.resource_names():
            self.idle.set(name, self.idle.get(name) - used.get(name))

        self.inqueue = Resource()
        for job in ssn.jobs.values():
            if (job.pod_group.status.phase == PodGroupPhase.INQUEUE
                    and job.pod_group.spec.min_resources is not None):
                self.inqueue.add(job.get_min_resources())

        def enqueueable_fn(job):
            if job.pod_group.spec.min_resources is None:
                return PERMIT
            job_min_req = job.get_min_resources()
            if self.inqueue.clone().add(job_min_req).less_equal(self.idle,
                                                                ZERO):
                return PERMIT
            return REJECT

        ssn.add_job_enqueueable_fn(NAME, enqueueable_fn)

        def enqueued_fn(job):
            if job.pod_group.spec.min_resources is None:
                return
            self.inqueue.add(job.get_min_resources())

        ssn.add_job_enqueued_fn(NAME, enqueued_fn)

    def on_session_close(self, ssn) -> None:
        self.idle = Resource()
        self.inqueue = Resource()


register_plugin_builder(NAME, OvercommitPlugin)
