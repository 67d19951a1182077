"""proportion plugin (the port's own copy of volcano_tpu/plugins/
proportion.py; reference: pkg/scheduler/plugins/proportion/proportion.go).

Extension points: QueueOrder (by share = dominant allocated/deserved),
Reclaimable (victims only from queues above deserved), Overused,
JobEnqueueable (capability gate), plus allocate/deallocate event handlers
keeping shares live.

The iterative weighted water-fill of per-queue ``deserved``
(proportion.go:129-194) runs over dense [Q,R] tensors on the CPU
(ops/fairshare.py::proportion_waterfill). The reference's queue gauges are
not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from ..framework.session import PERMIT, REJECT, EventHandler
from ..models.arrays import ResourceIndex
from ..models.objects import PodGroupPhase
from ..models.resource import INFINITY, ZERO, Resource

NAME = "proportion"


def _share(allocated: Resource, deserved: Resource) -> float:
    """max_r allocated_r/deserved_r with 0/0=0, x/0=1 (helpers.go:47-60)."""
    res = 0.0
    for rn in deserved.resource_names():
        d = deserved.get(rn)
        a = allocated.get(rn)
        res = max(res, (0.0 if a == 0 else 1.0) if d == 0 else a / d)
    return res


class _QueueAttr:
    __slots__ = ("queue_id", "name", "weight", "share", "deserved",
                 "allocated", "request", "inqueue", "capability")

    def __init__(self, queue):
        self.queue_id = queue.uid
        self.name = queue.name
        self.weight = queue.weight
        self.share = 0.0
        self.deserved = Resource()
        self.allocated = Resource()
        self.request = Resource()
        self.inqueue = Resource()
        self.capability: Optional[Resource] = None
        if queue.queue.spec.capability:
            self.capability = Resource.from_resource_list(
                queue.queue.spec.capability)


class ProportionPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        self.queue_opts: Dict[str, _QueueAttr] = {}
        self.total = Resource()

    def name(self) -> str:
        return NAME

    # -- session open ------------------------------------------------------

    def on_session_open(self, ssn) -> None:
        self.total = ssn.total_resource.clone()

        for job in ssn.jobs.values():
            if job.queue not in ssn.queues:
                continue
            attr = self.queue_opts.get(job.queue)
            if attr is None:
                attr = _QueueAttr(ssn.queues[job.queue])
                self.queue_opts[job.queue] = attr
            # allocated-status and pending-request sums are maintained as
            # running aggregates on JobInfo (one add per job instead of
            # one per task — 50k adds per cycle at the burst benchmark)
            attr.allocated.add(job.allocated)
            attr.request.add(job.allocated)
            attr.request.add(job.pending_request)
            if job.pod_group.status.phase == PodGroupPhase.INQUEUE:
                attr.inqueue.add(job.get_min_resources())

        self._waterfill()

        if ssn.solver is not None:
            def queue_budget_fn(queue_name, rindex):
                """Feed live Overused gating into the allocate kernel: the
                scan stops selecting a queue's jobs once its in-scan
                allocation exceeds deserved (proportion.go:238-250 evaluated
                at job granularity, like the reference's per-pop check)."""
                for attr in self.queue_opts.values():
                    if attr.name == queue_name:
                        return (rindex.vec(attr.allocated),
                                rindex.vec(attr.deserved))
                return None

            ssn.solver.add_queue_budget_fn(queue_budget_fn)

        def queue_order_fn(l, r) -> int:
            ls = self.queue_opts[l.uid].share
            rs = self.queue_opts[r.uid].share
            return 0 if ls == rs else (-1 if ls < rs else 1)

        ssn.add_queue_order_fn(NAME, queue_order_fn)

        def reclaimable_fn(reclaimer, reclaimees):
            """Victims only from queues holding more than deserved
            (proportion.go:211-236)."""
            victims = []
            allocations: Dict[str, Resource] = {}
            for reclaimee in reclaimees:
                job = ssn.jobs.get(reclaimee.job)
                if job is None or job.queue not in self.queue_opts:
                    continue
                attr = self.queue_opts[job.queue]
                if job.queue not in allocations:
                    allocations[job.queue] = attr.allocated.clone()
                allocated = allocations[job.queue]
                if allocated.less_partly(reclaimer.resreq, ZERO):
                    continue
                if not allocated.less_equal(attr.deserved, ZERO):
                    allocated.sub(reclaimee.resreq)
                    victims.append(reclaimee)
            return victims, PERMIT

        ssn.add_reclaimable_fn(NAME, reclaimable_fn)

        def overused_fn(queue) -> bool:
            attr = self.queue_opts.get(queue.uid)
            if attr is None:
                return False
            return not attr.allocated.less_equal(attr.deserved, ZERO)

        ssn.add_overused_fn(NAME, overused_fn)

        def job_enqueueable_fn(job) -> int:
            """Capability gate: minResources must fit capability minus
            allocated+inqueue (proportion.go:252-276)."""
            queue = ssn.queues.get(job.queue)
            attr = self.queue_opts.get(job.queue)
            if queue is None or attr is None:
                return PERMIT
            if not queue.queue.spec.capability:
                return PERMIT
            if job.pod_group.spec.min_resources is None:
                return PERMIT
            min_req = job.get_min_resources()
            want = min_req.clone().add(attr.allocated).add(attr.inqueue)
            cap = Resource.from_resource_list(queue.queue.spec.capability)
            if want.less_equal(cap, INFINITY):
                attr.inqueue.add(min_req)
                return PERMIT
            return REJECT

        ssn.add_job_enqueueable_fn(NAME, job_enqueueable_fn)

        def _apply_total(job, total, sign):
            """The single queue-share update body (proportion.go events):
            per-task events pass one resreq, batched events a gang's sum."""
            if job is None or job.queue not in self.queue_opts:
                return
            attr = self.queue_opts[job.queue]
            if sign > 0:
                attr.allocated.add(total)
            else:
                attr.allocated.sub(total)
            attr.share = _share(attr.allocated, attr.deserved)

        ssn.add_event_handler(EventHandler(
            allocate_func=lambda e:
                _apply_total(ssn.jobs.get(e.task.job), e.task.resreq, +1),
            deallocate_func=lambda e:
                _apply_total(ssn.jobs.get(e.task.job), e.task.resreq, -1),
            batch_allocate_func=lambda job, tasks, total:
                _apply_total(job, total, +1),
            batch_deallocate_func=lambda job, tasks, total:
                _apply_total(job, total, -1)))

    # -- the water-fill --------------------------------------------------

    def _waterfill(self) -> None:
        """Run the deserved water-fill and write the results back into the
        per-queue attrs."""
        if not self.queue_opts:
            return
        from ..ops.fairshare import proportion_waterfill

        attrs = list(self.queue_opts.values())
        rindex = ResourceIndex(
            {rn for a in attrs for rn in a.request.scalars} |
            set(self.total.scalars))
        q = len(attrs)
        weight = np.array([a.weight for a in attrs], np.float32)
        request = np.stack([rindex.vec(a.request) for a in attrs])
        capability = np.full((q, rindex.r), np.inf, np.float32)
        for i, a in enumerate(attrs):
            if a.capability is not None:
                capability[i] = rindex.vec_capability(a.capability)
        total = rindex.vec(self.total)

        deserved, _ = proportion_waterfill(torch.from_numpy(weight),
                                           torch.from_numpy(capability),
                                           torch.from_numpy(request),
                                           torch.from_numpy(total))
        deserved = deserved.numpy() / rindex.scales  # back to base units
        for i, a in enumerate(attrs):
            a.deserved = Resource(milli_cpu=float(deserved[i, 0]),
                                  memory=float(deserved[i, 1]))
            for name in rindex.names[2:]:
                a.deserved.set_scalar(name, float(deserved[i, rindex.index[name]]))
            a.share = _share(a.allocated, a.deserved)

    def on_session_close(self, ssn) -> None:
        self.queue_opts = {}
        self.total = Resource()


register_plugin_builder(NAME, ProportionPlugin)
