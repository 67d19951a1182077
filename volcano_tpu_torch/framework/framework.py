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
from .solver import BatchSolver, note_incremental_snapshot

# the actions that do nothing on a quiet cycle (nothing dirty, no pending
# work): the quiet path may skip the plugin opens only when the conf runs
# no action outside this set
QUIET_SAFE_ACTIONS = frozenset(
    ("enqueue", "allocate", "backfill", "preempt", "reclaim"))


def open_session(cache, tiers, configurations=None, clock=None,
                 device=None, actions=None) -> Session:
    """Open one scheduling cycle's session: snapshot the cache, build the
    placement solver on ``device`` (default: the GPU), open the plugins,
    then drop invalid gangs. Traced as the reference's spans:
    open_session > snapshot, plugin_open (one a plugin), job_valid.

    On a quiet incremental snapshot (nothing patched, no Pending task, no
    Pending-phase PodGroup) the plugin opens and the JobValid sweep decide
    nothing and are skipped, but only when ``actions`` (the conf's action
    names) are all quiet-safe; without ``actions`` they always run
    (docs/design/incremental_cycle.md)."""
    from ..metrics import metrics as m
    from ..trace import tracer as tr
    with tr.span("open_session"):
        with tr.span("snapshot"):
            snapshot = cache.snapshot()
        ssn = Session(cache, snapshot, tiers, configurations, clock=clock)
        ssn.solver = BatchSolver(ssn, device=device, rindex=snapshot.rindex)
        # the incremental surface, read by the solver's persistent node
        # state, allocate's working set and the close-time writeback
        ssn.incr_mode = snapshot.incr_mode
        ssn.incr_seq = snapshot.incr_seq
        ssn.patched_jobs = snapshot.patched_jobs
        ssn.patched_nodes = snapshot.patched_nodes
        ssn.quiet_cycle = bool(snapshot.quiet and actions is not None
                               and QUIET_SAFE_ACTIONS.issuperset(actions))
        if snapshot.incr_mode is not None:
            note_incremental_snapshot(cache, snapshot)
        # pre-session PodGroup statuses for the close-time writeback
        # dedup, and the cluster total: kept per patched entity by the
        # incremental snapshot, else computed over every job and node
        if snapshot.pg_fprints is not None:
            ssn.pod_group_status = snapshot.pg_fprints
        else:
            for job in ssn.jobs.values():
                if job.pod_group is not None:
                    ssn.pod_group_status[job.uid] = status_fingerprint(
                        job.pod_group.status)
        if snapshot.total_resource is not None:
            ssn.total_resource = snapshot.total_resource
        else:
            ssn.total_resource = Resource()
            for n in ssn.nodes.values():
                ssn.total_resource.add(n.allocatable)
        # the commit path's resilience: quarantined pods and pods inside
        # their bind-failure backoff are not placed this cycle;
        # why-pending reports the reasons
        ssn.ineligible_binds = cache.bind_ineligible()
        if ssn.quiet_cycle:
            return ssn

        for tier in tiers:
            for opt in tier.plugins:
                builder = get_plugin_builder(opt.name)
                if builder is None:
                    continue
                plugin = builder(opt.arguments)
                ssn.plugins[plugin.name()] = plugin
                with m.plugin_timer(plugin.name(), "OnSessionOpen"), \
                        tr.span("plugin_open", plugin=plugin.name()):
                    plugin.on_session_open(ssn)

        # drop invalid gangs (JobValid), writing the Unschedulable
        # condition. Pending PodGroups are exempt: their pods don't exist
        # yet (the job controller gates pod creation on the enqueue action
        # moving the group to Inqueue), so gang's valid-task-count check
        # cannot apply to them.
        with tr.span("job_valid"):
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
    """Close the plugins, publish the "why pending" report while tracing
    is on, and push the changed PodGroup statuses (spans close_session >
    plugin_close, pending_diagnosis, job_updater)."""
    from ..metrics import metrics as m
    from ..trace import tracer as tr
    with tr.span("close_session"):
        for plugin in ssn.plugins.values():
            with m.plugin_timer(plugin.name(), "OnSessionClose"), \
                    tr.span("plugin_close", plugin=plugin.name()):
                plugin.on_session_close(ssn)
        if tr.is_enabled():
            # after the plugin closes: gang has just written fit errors
            # and conditions
            from ..trace import pending
            with tr.span("pending_diagnosis"):
                pending.publish(ssn)
        with tr.span("job_updater"):
            JobUpdater(ssn).update_all()
        ssn.plugins = {}
        ssn.event_handlers = []
        # the incremental cycle: what this session mutated is re-cloned
        # from the cache before the persistent snapshot is read again
        if ssn.cache is not None and ssn.cache.incremental:
            ssn.cache.absorb_session_touches(ssn.touched_jobs,
                                             ssn.touched_nodes)


def update_pod_group_condition(ssn: Session, job: JobInfo,
                               condition: PodGroupCondition) -> None:
    """Replace an existing condition of the same type, else append
    (session.go:425-437 UpdatePodGroupCondition) -- conditions must not grow
    per cycle."""
    if job.pod_group is None:
        return
    condition.last_transition_time = _time.time()
    ssn.touched_jobs.add(job.uid)
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
        allocated = job.deferred_alloc
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
        ssn.touched_jobs.add(job.uid)
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
    (job_updater.go:40-108): computed in the cycle, written on the cache's
    executor."""

    def __init__(self, ssn: Session):
        self.ssn = ssn
        # on an incremental cycle only patched (cache-side deltas) or
        # touched (session-side mutations) jobs can roll up differently
        # from last cycle's writeback: a job that needs a condition or
        # FailedScheduling write this cycle wrote one last cycle too,
        # whose echo dirtied it, so the sweep is scoped to them
        scope = None
        if ssn.incr_mode == "incremental":
            scope = set(ssn.patched_jobs or ()) | ssn.touched_jobs
        self.job_queue = [j for j in ssn.jobs.values()
                          if j.pod_group is not None
                          and (scope is None or j.uid in scope)]

    def update_all(self) -> None:
        """Compute every job's status in the cycle, then push the store
        writes in one bulk call on the cache's executor, off the cycle, in
        FIFO order after the binds they follow (the reference spreads the
        API writes over 16 goroutines, job_updater.go:51)."""
        updates = [(job, self.prepare_job(job)) for job in self.job_queue]
        cache = self.ssn.cache
        if cache is not None and updates:
            cache.submit_background(
                lambda: cache.update_job_statuses(updates))

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
