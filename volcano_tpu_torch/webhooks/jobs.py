"""Job admission: /jobs/validate + /jobs/mutate
(reference: pkg/webhooks/admission/jobs/{validate/admit_job.go,
mutate/mutate_job.go}).

The port's own copy of volcano_tpu/webhooks/jobs.py.
"""

from __future__ import annotations

import copy

from ..controllers.job import plugins as job_plugins
from ..controllers.apis import make_pod_name
from ..models import objects as obj
from ..models.objects import Job, QueueState
from .router import AdmissionDenied, AdmissionService, register_admission
from .util import (POD_NAME_MAX, is_dns1123_label, valid_actions, valid_events,
                   validate_policies)

DEFAULT_MAX_RETRY = 3
DEFAULT_TASK_NAME = "default"


# -- mutate (mutate_job.go:105-167) -----------------------------------------

def mutate_job(store, operation, job: Job, old=None) -> None:
    if not job.spec.queue:
        job.spec.queue = obj.DEFAULT_QUEUE
    if not job.spec.scheduler_name:
        job.spec.scheduler_name = obj.DEFAULT_SCHEDULER_NAME
    if job.spec.max_retry == 0:
        job.spec.max_retry = DEFAULT_MAX_RETRY
    for i, task in enumerate(job.spec.tasks):
        if not task.name:
            task.name = f"{DEFAULT_TASK_NAME}{i}"
    if job.spec.min_available == 0:
        job.spec.min_available = sum(
            t.min_available if t.min_available is not None else t.replicas
            for t in job.spec.tasks)


# -- validate (admit_job.go:110-252) ----------------------------------------

def validate_job(store, operation, job: Job, old=None) -> None:
    if operation == "UPDATE":
        _validate_job_update(old, job)
        return
    msgs = []
    if job.spec.min_available < 0:
        raise AdmissionDenied("job 'minAvailable' must be >= 0.")
    if job.spec.max_retry < 0:
        raise AdmissionDenied("'maxRetry' cannot be less than zero.")
    if job.spec.ttl_seconds_after_finished is not None and \
            job.spec.ttl_seconds_after_finished < 0:
        raise AdmissionDenied("'ttlSecondsAfterFinished' cannot be less than zero.")
    if not job.spec.tasks:
        raise AdmissionDenied("No task specified in job spec")

    task_names = set()
    total_replicas = 0
    for index, task in enumerate(job.spec.tasks):
        if task.replicas < 0:
            msgs.append(f"'replicas' < 0 in task: {task.name};")
        if task.min_available is not None and task.min_available > task.replicas:
            msgs.append(f"'minAvailable' is greater than 'replicas' in task: "
                        f"{task.name}, job: {job.metadata.name}")
        total_replicas += task.replicas
        if not is_dns1123_label(task.name):
            msgs.append(f"task name {task.name!r} must be a valid DNS-1123 label;")
        if task.name in task_names:
            msgs.append(f"duplicated task name {task.name};")
            break
        task_names.add(task.name)
        err = validate_policies(task.policies)
        if err:
            msgs.append(f"{err} valid events are {valid_events()}, "
                        f"valid actions are {valid_actions()}")
        pod_name = make_pod_name(job.metadata.name, task.name, index)
        if len(pod_name) > POD_NAME_MAX:
            msgs.append(f"pod name {pod_name!r} too long (max {POD_NAME_MAX});")
        if not task.template.spec.containers:
            msgs.append(f"no container specified in task {task.name!r} template;")

    if not is_dns1123_label(job.metadata.name):
        msgs.append(f"job name {job.metadata.name!r} must be a valid DNS-1123 label;")
    if total_replicas < job.spec.min_available:
        msgs.append("job 'minAvailable' should not be greater than "
                    "total replicas in tasks;")
    err = validate_policies(job.spec.policies)
    if err:
        msgs.append(f"{err} valid events are {valid_events()}, "
                    f"valid actions are {valid_actions()};")
    for name in job.spec.plugins:
        if not job_plugins.plugin_exists(name):
            msgs.append(f"unable to find job plugin: {name}")
    for volume in job.spec.volumes:
        if not volume.get("mount_path"):
            msgs.append("mountPath is required in volume;")

    queue = store.get("queues", job.spec.queue)
    if queue is None:
        msgs.append(f"unable to find job queue: {job.spec.queue}")
    elif queue.status.state != QueueState.OPEN:
        msgs.append(f"can only submit job to queue with state `Open`, "
                    f"queue `{queue.metadata.name}` status is "
                    f"`{queue.status.state}`")

    if msgs:
        raise AdmissionDenied(" ".join(msgs))


def _validate_job_update(old: Job, new: Job) -> None:
    """admit_job.go:210-252 — only minAvailable and tasks[*].replicas may
    change."""
    total_replicas = 0
    for task in new.spec.tasks:
        if task.replicas < 0:
            raise AdmissionDenied(f"'replicas' must be >= 0 in task: {task.name}")
        if task.min_available is not None and task.min_available > task.replicas:
            raise AdmissionDenied(
                f"'minAvailable' must be <= 'replicas' in task: {task.name};")
        total_replicas += task.replicas
    if new.spec.min_available > total_replicas:
        raise AdmissionDenied(
            "job 'minAvailable' must not be greater than total replicas")
    if new.spec.min_available < 0:
        raise AdmissionDenied("job 'minAvailable' must be >= 0")
    if len(old.spec.tasks) != len(new.spec.tasks):
        raise AdmissionDenied("job updates may not add or remove tasks")

    # neutralize the mutable fields, then require deep equality
    new_spec = copy.deepcopy(new.spec)
    old_spec = copy.deepcopy(old.spec)
    new_spec.min_available = old_spec.min_available
    new_spec.priority_class_name = old_spec.priority_class_name
    for i in range(len(new_spec.tasks)):
        new_spec.tasks[i].replicas = old_spec.tasks[i].replicas
        new_spec.tasks[i].min_available = old_spec.tasks[i].min_available
    for spec in (new_spec, old_spec):
        for volume in spec.volumes:
            if volume.get("volume_claim") is not None:
                volume["volume_claim_name"] = ""
    if new_spec != old_spec:
        raise AdmissionDenied(
            "job updates may not change fields other than `minAvailable`, "
            "`tasks[*].replicas under spec`")


register_admission(AdmissionService(
    path="/jobs/mutate", kind="jobs", operations=("CREATE",), mutate=mutate_job))
register_admission(AdmissionService(
    path="/jobs/validate", kind="jobs", operations=("CREATE", "UPDATE"),
    validate=validate_job))
