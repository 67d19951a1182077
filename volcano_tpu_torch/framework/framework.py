"""OpenSession / CloseSession (counterpart of
volcano_tpu/framework/framework.py; reference: pkg/scheduler/framework/
framework.go:30-58 + session.go:87-228 + job_updater.go).

Divergence from the reference, by design: job validation (JobValid) runs
*after* plugins' OnSessionOpen. The reference calls it before Tiers are even
assigned (framework.go:31-33 vs session.go:136), making it a no-op there;
running it after plugin registration realizes the documented intent (drop
invalid gangs and write the Unschedulable condition).
"""

from __future__ import annotations

import time as _time

from ..models.job_info import JobInfo, TaskStatus, allocated_status
from ..models.objects import (PodGroupCondition, PodGroupConditionType,
                              PodGroupPhase, status_fingerprint)
from ..models.resource import Resource
from .registry import get_plugin_builder
from .session import Session
from .solver import BatchSolver


def open_session(cache, tiers, configurations=None, clock=None,
                 device=None) -> Session:
    """Open one scheduling cycle's session: snapshot the cache, build the
    placement solver on ``device`` (default: the GPU), open the plugins,
    then drop invalid gangs."""
    snapshot = cache.snapshot()
    ssn = Session(cache, snapshot, tiers, configurations, clock=clock)
    ssn.solver = BatchSolver(ssn, device=device)
    # pre-session PodGroup statuses for the close-time writeback dedup
    for job in ssn.jobs.values():
        if job.pod_group is not None:
            ssn.pod_group_status[job.uid] = status_fingerprint(
                job.pod_group.status)
    ssn.total_resource = Resource()
    for n in ssn.nodes.values():
        ssn.total_resource.add(n.allocatable)

    for tier in tiers:
        for opt in tier.plugins:
            builder = get_plugin_builder(opt.name)
            if builder is None:
                continue
            plugin = builder(opt.arguments)
            ssn.plugins[plugin.name()] = plugin
            plugin.on_session_open(ssn)

    # drop invalid gangs (JobValid), writing the Unschedulable
    # condition. Pending PodGroups are exempt: their pods don't exist
    # yet (the job controller gates pod creation on the enqueue action
    # moving the group to Inqueue), so gang's valid-task-count check
    # cannot apply to them.
    for job in list(ssn.jobs.values()):
        if job.pod_group is not None and \
                job.pod_group.status.phase == PodGroupPhase.PENDING:
            continue
        vr = ssn.job_valid(job)
        if vr is not None and not vr.passed:
            update_pod_group_condition(ssn, job, PodGroupCondition(
                type=PodGroupConditionType.UNSCHEDULABLE,
                status="True", transition_id=ssn.uid,
                reason=vr.reason, message=vr.message))
            del ssn.jobs[job.uid]
    return ssn


def close_session(ssn: Session) -> None:
    for plugin in ssn.plugins.values():
        plugin.on_session_close(ssn)
    JobUpdater(ssn).update_all()
    ssn.plugins = {}
    ssn.event_handlers = []


def update_pod_group_condition(ssn: Session, job: JobInfo,
                               condition: PodGroupCondition) -> None:
    """Replace an existing condition of the same type, else append
    (session.go:425-437 UpdatePodGroupCondition) -- conditions must not grow
    per cycle."""
    if job.pod_group is None:
        return
    condition.last_transition_time = _time.time()
    conditions = job.own_pod_group().status.conditions
    for i, c in enumerate(conditions):
        if c.type == condition.type:
            conditions[i] = condition
            return
    conditions.append(condition)


def job_status(ssn: Session, job: JobInfo):
    """Roll task counts into a PodGroup status (session.go:190-228).

    Copy-on-write aware: the candidate values are computed first and the
    (possibly shared) PodGroup is only claimed and mutated when something
    actually changed."""
    status = job.pod_group.status
    unschedulable = any(
        c.type == PodGroupConditionType.UNSCHEDULABLE and c.status == "True"
        and c.transition_id == ssn.uid
        for c in status.conditions)
    running = len(job.task_status_index.get(TaskStatus.Running, {}))
    phase = status.phase
    if running and unschedulable:
        phase = PodGroupPhase.UNKNOWN
    else:
        allocated = 0
        for st, tasks in job.task_status_index.items():
            if allocated_status(st) or st == TaskStatus.Succeeded:
                allocated += len(tasks)
        if allocated >= job.pod_group.spec.min_member:
            phase = PodGroupPhase.RUNNING
        elif status.phase != PodGroupPhase.INQUEUE:
            phase = PodGroupPhase.PENDING
    failed = len(job.task_status_index.get(TaskStatus.Failed, {}))
    succeeded = len(job.task_status_index.get(TaskStatus.Succeeded, {}))
    if (phase, running, failed, succeeded) != \
            (status.phase, status.running, status.failed, status.succeeded):
        status = job.own_pod_group().status
        status.phase = phase
        status.running = running
        status.failed = failed
        status.succeeded = succeeded
    return status


# condition-writeback dedup window (job_updater.go:31-37)
JOB_CONDITION_UPDATE_TIME = 0.6
JOB_CONDITION_UPDATE_JITTER = 0.3


class JobUpdater:
    """Push changed PodGroup statuses back on session close
    (job_updater.go:40-108). The reference parallelizes over 16 goroutines;
    here the store write is an in-process call, so a plain loop is the
    faster equivalent."""

    def __init__(self, ssn: Session):
        self.ssn = ssn
        self.job_queue = [j for j in ssn.jobs.values()
                          if j.pod_group is not None]

    def update_all(self) -> None:
        """Compute every job's status, then push the store writes in one
        bulk call (synchronously: the port's cache has no executor)."""
        updates = [(job, self.prepare_job(job)) for job in self.job_queue]
        cache = self.ssn.cache
        if cache is not None and updates:
            cache.update_job_statuses(updates)

    def prepare_job(self, job: JobInfo) -> bool:
        """Roll up the job's status; True if the PodGroup must be pushed.

        No version-based skip here: task transitions arriving BETWEEN
        cycles leave the session-internal status version untouched while
        the stored PodGroup status is stale, so the rollup comparison
        itself is the only sound change check."""
        ssn = self.ssn
        status = job_status(ssn, job)
        old = ssn.pod_group_status.get(job.uid)
        return old is None or self._status_updated(status, old)

    @staticmethod
    def _status_updated(new, old: tuple) -> bool:
        """Compare a live status against its open-session fingerprint
        (models.objects.status_fingerprint)."""
        o_phase, o_running, o_succeeded, o_failed, o_conds = old
        if (new.phase, new.running, new.succeeded, new.failed) != \
                (o_phase, o_running, o_succeeded, o_failed):
            return True
        if len(new.conditions) != len(o_conds):
            return True
        for nc, (o_type, o_status, o_reason, o_message, o_ltt) in \
                zip(new.conditions, o_conds):
            # jitter dedup: a condition refreshed within the update window
            # counts as unchanged (TimeJitterAfter)
            if nc.last_transition_time - o_ltt > JOB_CONDITION_UPDATE_TIME:
                return True
            if (nc.type, nc.status, nc.reason, nc.message) != \
                    (o_type, o_status, o_reason, o_message):
                return True
        return False
