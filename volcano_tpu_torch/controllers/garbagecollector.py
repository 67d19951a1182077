"""Garbage collector: TTL-after-finished Job deletion
(reference: pkg/controllers/garbagecollector/garbagecollector.go, which
mirrors the upstream TTL controller).

Finished jobs (Completed/Failed/Terminated) with
``spec.ttl_seconds_after_finished`` set are deleted once the TTL elapses,
measured against the store clock from the finish transition time.

The port's own copy of volcano_tpu/controllers/garbagecollector.py.
"""

from __future__ import annotations

import heapq
from typing import List, Set, Tuple

from ..models.objects import Job, JobPhase
from .framework import Controller

FINISHED_PHASES = {JobPhase.COMPLETED, JobPhase.FAILED, JobPhase.TERMINATED}


def needs_cleanup(job: Job) -> bool:
    """garbagecollector.go:140-147 — TTL set and job finished."""
    return (job.spec.ttl_seconds_after_finished is not None and
            job.status.state.phase in FINISHED_PHASES)


class GarbageCollector(Controller):
    NAME = "gc-controller"

    def __init__(self):
        self.store = None
        # min-heap of (due_time, job_key)
        self.timers: List[Tuple[float, str]] = []
        self._queued: Set[str] = set()
        self._watches: list = []

    def initialize(self, store) -> None:
        self.store = store
        self._watches = [store.watch("jobs", self._add_job, self._update_job, None)]

    def stop(self) -> None:
        for w in self._watches:
            self.store.unwatch(w)
        self._watches = []

    def _add_job(self, job: Job) -> None:
        if needs_cleanup(job):
            self._schedule(job)

    def _update_job(self, old: Job, new: Job) -> None:
        if needs_cleanup(new):
            self._schedule(new)

    def _schedule(self, job: Job) -> None:
        key = job.metadata.key()
        finish_time = job.status.state.last_transition_time or \
            job.metadata.creation_timestamp
        due = finish_time + float(job.spec.ttl_seconds_after_finished)
        if key not in self._queued:
            self._queued.add(key)
            heapq.heappush(self.timers, (due, key))

    def process_pending(self, max_items: int = 10000) -> int:
        """Expire due timers; re-verify TTL against the live job before
        deleting (processJob re-check, garbagecollector.go:178-212)."""
        now = self.store.clock.now()
        processed = 0
        while self.timers and self.timers[0][0] <= now and processed < max_items:
            _, key = heapq.heappop(self.timers)
            self._queued.discard(key)
            ns, name = key.split("/", 1)
            job = self.store.get("jobs", name, ns)
            if job is None or not needs_cleanup(job):
                continue
            finish_time = job.status.state.last_transition_time or \
                job.metadata.creation_timestamp
            if finish_time + float(job.spec.ttl_seconds_after_finished) > now:
                self._schedule(job)   # TTL extended since we queued it
                continue
            try:
                self.store.delete("jobs", name, ns, skip_admission=True)
            except KeyError:
                pass   # already deleted by another actor
            processed += 1
        return processed
