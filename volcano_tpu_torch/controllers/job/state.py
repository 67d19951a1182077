"""Job state machine (reference: pkg/controllers/job/state/*.go).

Each phase is a State with ``execute(action)``; sync_job/kill_job callables
are injected by the job controller (state/factory.go:50-55 package vars).
``update_status`` callbacks receive the JobStatus being written and return
True when the phase changed (which stamps last_transition_time).

The port's own copy of volcano_tpu/controllers/job/state.py.
"""

from __future__ import annotations

from typing import Callable, Optional, Set

from ...models.objects import Job, JobAction, JobPhase, JobStatus
from ..apis import JobInfo, total_task_min_available, total_tasks

# Pod phases retained (not deleted) by kill (state/factory.go:40-47)
POD_RETAIN_PHASE_NONE: Set[str] = set()
POD_RETAIN_PHASE_SOFT: Set[str] = {"Succeeded", "Failed"}

SyncFn = Callable[[JobInfo, Optional[Callable[[JobStatus], bool]]], None]
KillFn = Callable[[JobInfo, Set[str], Optional[Callable[[JobStatus], bool]]], None]
# RestartTask: second argument is the TASK NAME, not a retain-phase set
TargetKillFn = Callable[[JobInfo, str, Optional[Callable[[JobStatus], bool]]], None]


class State:
    def __init__(self, job: JobInfo, sync_job: SyncFn, kill_job: KillFn,
                 kill_target: Optional[TargetKillFn] = None):
        self.job = job
        self.sync_job = sync_job
        self.kill_job = kill_job
        self.kill_target = kill_target

    def execute(self, action: str, target: str = "") -> None:
        raise NotImplementedError

    # common transitions -----------------------------------------------------

    def _kill_to(self, phase: str, retain: Set[str], bump_retry: bool = False) -> None:
        def update(status: JobStatus) -> bool:
            if bump_retry:
                status.retry_count += 1
            status.state.phase = phase
            return True
        self.kill_job(self.job, retain, update)


class PendingState(State):
    """state/pending.go"""

    def execute(self, action: str, target: str = "") -> None:
        if action == JobAction.RESTART_JOB:
            self._kill_to(JobPhase.RESTARTING, POD_RETAIN_PHASE_NONE, bump_retry=True)
        elif action == JobAction.ABORT_JOB:
            self._kill_to(JobPhase.ABORTING, POD_RETAIN_PHASE_SOFT)
        elif action == JobAction.COMPLETE_JOB:
            self._kill_to(JobPhase.COMPLETING, POD_RETAIN_PHASE_SOFT)
        elif action == JobAction.TERMINATE_JOB:
            self._kill_to(JobPhase.TERMINATING, POD_RETAIN_PHASE_SOFT)
        else:
            def update(status: JobStatus) -> bool:
                if self.job.job.spec.min_available <= (
                        status.running + status.succeeded + status.failed):
                    status.state.phase = JobPhase.RUNNING
                    return True
                return False
            self.sync_job(self.job, update)


class RunningState(State):
    """state/running.go — including minSuccess / per-task minAvailable
    completion semantics."""

    def execute(self, action: str, target: str = "") -> None:
        if action == JobAction.RESTART_JOB:
            self._kill_to(JobPhase.RESTARTING, POD_RETAIN_PHASE_NONE, bump_retry=True)
        elif action == JobAction.RESTART_TASK and target \
                and self.kill_target is not None:
            # restart ONLY the named task's pods; the job stays Running and
            # sync recreates them under the bumped version. The reference
            # declares the action (bus/v1alpha1/actions.go:31-33) as the
            # per-task default but its controller at this version has no
            # handler; this implements the documented contract.
            self.kill_target(self.job, target, None)
        elif action == JobAction.ABORT_JOB:
            self._kill_to(JobPhase.ABORTING, POD_RETAIN_PHASE_SOFT)
        elif action == JobAction.TERMINATE_JOB:
            self._kill_to(JobPhase.TERMINATING, POD_RETAIN_PHASE_SOFT)
        elif action == JobAction.COMPLETE_JOB:
            self._kill_to(JobPhase.COMPLETING, POD_RETAIN_PHASE_SOFT)
        else:
            job = self.job.job

            def update(status: JobStatus) -> bool:
                replicas = total_tasks(job)
                if replicas == 0:
                    # scaled to zero: keep current phase (running.go:60-63)
                    return False
                min_success = job.spec.min_success
                if min_success is not None and status.succeeded >= min_success:
                    status.state.phase = JobPhase.COMPLETED
                    return True
                if status.succeeded + status.failed == replicas:
                    if job.spec.min_available >= total_task_min_available(job):
                        for task in job.spec.tasks:
                            if task.min_available is None:
                                continue
                            counts = status.task_status_count.get(task.name, {})
                            if counts.get("Succeeded", 0) < task.min_available:
                                status.state.phase = JobPhase.FAILED
                                return True
                    if min_success is not None and status.succeeded < min_success:
                        status.state.phase = JobPhase.FAILED
                    elif status.succeeded >= job.spec.min_available:
                        status.state.phase = JobPhase.COMPLETED
                    else:
                        status.state.phase = JobPhase.FAILED
                    return True
                return False
            self.sync_job(self.job, update)


class RestartingState(State):
    """state/restarting.go — back to Pending once enough pods are gone,
    Failed once maxRetry exhausted."""

    def execute(self, action: str, target: str = "") -> None:
        job = self.job.job

        def update(status: JobStatus) -> bool:
            if status.retry_count >= job.spec.max_retry:
                status.state.phase = JobPhase.FAILED
                return True
            if total_tasks(job) - status.terminating >= status.min_available:
                status.state.phase = JobPhase.PENDING
                return True
            return False
        self.kill_job(self.job, POD_RETAIN_PHASE_NONE, update)


class AbortingState(State):
    """state/aborting.go"""

    def execute(self, action: str, target: str = "") -> None:
        if action == JobAction.RESUME_JOB:
            self._kill_to(JobPhase.RESTARTING, POD_RETAIN_PHASE_SOFT, bump_retry=True)
        else:
            def update(status: JobStatus) -> bool:
                if status.terminating or status.pending or status.running:
                    return False
                status.state.phase = JobPhase.ABORTED
                return True
            self.kill_job(self.job, POD_RETAIN_PHASE_SOFT, update)


class AbortedState(State):
    """state/aborted.go"""

    def execute(self, action: str, target: str = "") -> None:
        if action == JobAction.RESUME_JOB:
            self._kill_to(JobPhase.RESTARTING, POD_RETAIN_PHASE_SOFT, bump_retry=True)
        else:
            self.kill_job(self.job, POD_RETAIN_PHASE_SOFT, None)


class CompletingState(State):
    """state/completing.go"""

    def execute(self, action: str, target: str = "") -> None:
        def update(status: JobStatus) -> bool:
            if status.terminating or status.pending or status.running:
                return False
            status.state.phase = JobPhase.COMPLETED
            return True
        self.kill_job(self.job, POD_RETAIN_PHASE_SOFT, update)


class TerminatingState(State):
    """state/terminating.go"""

    def execute(self, action: str, target: str = "") -> None:
        def update(status: JobStatus) -> bool:
            if status.terminating or status.pending or status.running:
                return False
            status.state.phase = JobPhase.TERMINATED
            return True
        self.kill_job(self.job, POD_RETAIN_PHASE_SOFT, update)


class FinishedState(State):
    """state/finished.go — always release non-retained pods."""

    def execute(self, action: str, target: str = "") -> None:
        self.kill_job(self.job, POD_RETAIN_PHASE_SOFT, None)


_STATES = {
    JobPhase.PENDING: PendingState,
    JobPhase.RUNNING: RunningState,
    JobPhase.RESTARTING: RestartingState,
    JobPhase.TERMINATED: FinishedState,
    JobPhase.COMPLETED: FinishedState,
    JobPhase.FAILED: FinishedState,
    JobPhase.TERMINATING: TerminatingState,
    JobPhase.ABORTING: AbortingState,
    JobPhase.ABORTED: AbortedState,
    JobPhase.COMPLETING: CompletingState,
}


def new_state(job_info: JobInfo, sync_job: SyncFn, kill_job: KillFn,
              kill_target: Optional[TargetKillFn] = None) -> State:
    """state/factory.go:62-85 — Pending by default."""
    phase = job_info.job.status.state.phase if job_info.job else JobPhase.PENDING
    cls = _STATES.get(phase, PendingState)
    return cls(job_info, sync_job, kill_job, kill_target)
