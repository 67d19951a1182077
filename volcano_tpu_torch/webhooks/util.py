"""Shared validation helpers for admission webhooks
(reference: pkg/webhooks/admission/jobs/validate/util.go and k8s validation).

The port's own copy of volcano_tpu/webhooks/util.py.
"""

from __future__ import annotations

import re
from typing import List, Optional

from ..models.objects import JobAction, JobEvent, LifecyclePolicy

DNS1123_LABEL_RE = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
DNS1123_LABEL_MAX = 63
POD_NAME_MAX = 253

# events/actions allowed in user-facing lifecycle policies (util.go:32-57)
POLICY_EVENTS = {
    JobEvent.ANY: True,
    JobEvent.POD_FAILED: True,
    JobEvent.POD_EVICTED: True,
    JobEvent.JOB_UNKNOWN: True,
    JobEvent.TASK_COMPLETED: True,
    JobEvent.TASK_FAILED: True,
    JobEvent.OUT_OF_SYNC: False,
    JobEvent.COMMAND_ISSUED: False,
    JobEvent.JOB_UPDATED: True,
}
POLICY_ACTIONS = {
    JobAction.ABORT_JOB: True,
    JobAction.RESTART_JOB: True,
    JobAction.RESTART_TASK: True,
    JobAction.TERMINATE_JOB: True,
    JobAction.COMPLETE_JOB: True,
    JobAction.RESUME_JOB: True,
    JobAction.SYNC_JOB: False,
    JobAction.ENQUEUE_JOB: False,
    JobAction.SYNC_QUEUE: False,
    JobAction.OPEN_QUEUE: False,
    JobAction.CLOSE_QUEUE: False,
}


def valid_events() -> List[str]:
    return [e for e, ok in POLICY_EVENTS.items() if ok]


def valid_actions() -> List[str]:
    return [a for a, ok in POLICY_ACTIONS.items() if ok]


def is_dns1123_label(value: str) -> bool:
    return len(value) <= DNS1123_LABEL_MAX and bool(DNS1123_LABEL_RE.match(value))


def validate_policies(policies: List[LifecyclePolicy]) -> Optional[str]:
    """util.go:59-115 — one error message or None."""
    seen_events = set()
    seen_exit_codes = set()
    for policy in policies:
        has_event = bool(policy.event) or bool(policy.events)
        if has_event and policy.exit_code is not None:
            return "must not specify event and exitCode simultaneously"
        if not has_event and policy.exit_code is None:
            return "either event and exitCode should be specified"
        if has_event:
            events = list(policy.events)
            if policy.event:
                events.append(policy.event)
            for event in events:
                if not POLICY_EVENTS.get(event, False):
                    return f"invalid policy event: {event}"
                if not POLICY_ACTIONS.get(policy.action, False):
                    return f"invalid policy action: {policy.action}"
                if event in seen_events:
                    return f"duplicate event {event} across different policy"
                seen_events.add(event)
        else:
            if policy.exit_code == 0:
                return "0 is not a valid error code"
            if policy.exit_code in seen_exit_codes:
                return f"duplicate exitCode {policy.exit_code}"
            seen_exit_codes.add(policy.exit_code)
    return None


def validate_int_percentage_str(key: str, value: str) -> Optional[str]:
    """admit_pod.go:183-205 — positive int or 1%-99% percentage."""
    v = value.strip()
    if v.endswith("%"):
        try:
            pct = int(v[:-1])
        except ValueError:
            return f"invalid value {value!r} for {key}"
        if pct <= 0 or pct >= 100:
            return (f"invalid value {value!r} for {key}, it must be a valid "
                    f"percentage which between 1% ~ 99%")
        return None
    try:
        iv = int(v)
    except ValueError:
        return f"invalid value {value!r} for {key}"
    if iv <= 0:
        return f"invalid value {value!r} for {key}, it must be a positive integer"
    return None
