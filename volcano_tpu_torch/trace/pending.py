""""Why pending" diagnosis: aggregate the cycle's unschedulable reasons
(this port's own copy of volcano_tpu/trace/pending.py).

The scheduler already *collects* per-task failure detail — FitErrors from
the solver's mask summaries (framework/solver.py _record_fit_errors) and
the host predicate path (plugins/predicates.py FitException reasons), plus
the gang plugin's Unschedulable PodGroup conditions — but nothing
aggregated it into an answerable "why is this task still pending".
``collect(ssn)`` rolls those sources into per-job and per-reason counts;
``publish(ssn)`` (called at session close while tracing is on) stores the
report for the ``/debug/pending`` endpoint and bumps the
``volcano_unschedulable_reason_total`` counters.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

from ..models.job_info import TaskStatus
from ..models.objects import PodGroupConditionType, PodGroupPhase
from . import tracer

# canonical reasons for the solver's summarized (mask-level) fit errors,
# matched against FitErrors.err strings set by _record_fit_errors
REASON_SOLVER_MASKED = "predicates failed or insufficient resources"
REASON_GANG_ROLLBACK = "gang rollback or all feasible nodes already full"
REASON_NOT_CONSIDERED = "not considered this cycle"
REASON_AWAITING_ENQUEUE = "PodGroup awaiting enqueue (Pending phase)"
# commit-path resilience (docs/design/resilience.md): pods the cache has
# made ineligible for re-placement — quarantined after exhausting their
# bind retry budget, or inside a bind-failure backoff window (the latter
# is suffixed "(attempt N)", bounded by the retry budget)
REASON_QUARANTINED = "bind quarantined: retry budget exhausted"
REASON_BIND_BACKOFF = "bind failed: in retry backoff"
# control-plane failover (docs/design/failover.md): windows where the
# scheduler is deliberately NOT scheduling — a standby waiting out the
# leader lease, or the cache mid-relist after an anti-entropy divergence
# — surface as explicit reasons instead of a silently stale report
REASON_NOT_LEADER = "scheduler not leader (standby)"
REASON_CACHE_RESYNC = "cache resync in progress"


def _task_reasons(fe) -> Counter:
    """Distinct reasons of one task's FitErrors: per-node predicate
    reasons when present, else the classified summary error."""
    reasons: Counter = Counter()
    if fe.nodes:
        seen = set()
        for node_fe in fe.nodes.values():
            seen.update(node_fe.reasons)
        for r in seen:
            reasons[r] += 1
        if seen:
            return reasons
    err = fe.err or ""
    if REASON_SOLVER_MASKED in err:
        reasons[REASON_SOLVER_MASKED] += 1
    elif "gang rollback" in err:
        reasons[REASON_GANG_ROLLBACK] += 1
    elif err:
        reasons[err] += 1
    return reasons


def collect(ssn) -> dict:
    """Per-job and per-reason pending counts for one session. A reason
    counts once per task (a task blocked on 9k nodes by the same
    predicate is one pending task, not 9k)."""
    jobs: Dict[str, dict] = {}
    totals: Counter = Counter()
    ineligible = getattr(ssn, "ineligible_binds", None) or {}
    for job in ssn.jobs.values():
        if job.pod_group is None or job.ready():
            continue
        pending = len(job.task_status_index.get(TaskStatus.Pending, {}))
        unready = max(0, job.min_available - job.ready_task_num())
        if not pending and not unready:
            continue
        per_reason: Counter = Counter()
        for fe in job.nodes_fit_errors.values():
            per_reason.update(_task_reasons(fe))
        had_fit_errors = bool(per_reason)
        gated = 0
        if ineligible:
            # quarantined / backoff-gated pods were skipped by the
            # placing actions, so they carry no fit errors — surface the
            # cache's ineligibility reason instead
            for task in job.task_status_index.get(
                    TaskStatus.Pending, {}).values():
                reason = ineligible.get(task.key())
                if reason:
                    per_reason[reason] += 1
                    gated += 1
        cond_reason = ""
        cond_message = ""
        for c in job.pod_group.status.conditions:
            if c.type == PodGroupConditionType.UNSCHEDULABLE \
                    and c.status == "True":
                cond_reason, cond_message = c.reason, c.message
        if not had_fit_errors:
            # no fit errors recorded: the job never reached the solver
            # this cycle (still Pending-phase, dropped by JobValid,
            # starved by ordering, or its eligible tasks parked behind a
            # gated gang mate). Count by max(pending, unready): a
            # Pending-phase group's pods don't exist yet, so its
            # Pending-status task count is 0 while min_available-unready
            # is the real shortfall. Gated tasks already carry their own
            # reason above — count only the remainder here, so a gang
            # with one quarantined pod still reports its other stuck
            # tasks instead of vanishing from the backlog.
            rest = (max(pending, unready) or 1) - gated
            if rest > 0:
                if job.pod_group.status.phase == PodGroupPhase.PENDING:
                    per_reason[REASON_AWAITING_ENQUEUE] = rest
                else:
                    per_reason[cond_reason or REASON_NOT_CONSIDERED] = rest
        totals.update(per_reason)
        jobs[f"{job.namespace}/{job.name}"] = {
            "queue": job.queue,
            "pending_tasks": pending,
            "unready": unready,
            "min_available": job.min_available,
            "condition_reason": cond_reason,
            "message": cond_message or job.job_fit_errors,
            "reasons": dict(per_reason),
        }
    return {"pending_jobs": len(jobs), "reasons": dict(totals),
            "jobs": jobs}


def publish(ssn) -> dict:
    """Collect + store for /debug/pending + export the per-reason
    counters (``volcano_unschedulable_reason_total``)."""
    from ..metrics import metrics as m
    report = collect(ssn)
    report["cycle_seq"] = tracer.current_seq()
    report["session_uid"] = getattr(ssn, "uid", "")
    for reason, count in report["reasons"].items():
        m.inc(m.UNSCHEDULABLE_REASON, float(count), reason=reason)
    tracer.set_pending_report(report)
    return report


def publish_idle(reason: str, detail: str = "") -> dict:
    """Publish a whole-scheduler idle reason to ``/debug/pending`` — no
    session ran, so there are no per-job rows, but during a failover
    window ("scheduler not leader (standby)", "cache resync in
    progress") the endpoint must say WHY nothing is being scheduled
    rather than serving the last leader's stale report."""
    from ..metrics import metrics as m
    report = {"pending_jobs": 0, "reasons": {reason: 1}, "jobs": {},
              "idle_reason": reason, "detail": detail,
              "cycle_seq": tracer.current_seq()}
    m.inc(m.UNSCHEDULABLE_REASON, 1.0, reason=reason)
    tracer.set_pending_report(report)
    return report
