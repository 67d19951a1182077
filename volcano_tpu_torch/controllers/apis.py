"""Controller-side data types and helpers
(reference: pkg/controllers/apis/job_info.go, pkg/controllers/job/helpers).

``JobInfo`` here is the *controller's* view (Job spec + its pods indexed by
task), distinct from the scheduler's JobInfo (models/job_info.py) which wraps
a PodGroup.

The port's own copy of volcano_tpu/controllers/apis.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..models import objects as obj

POD_NAME_FMT = "{job}-{task}-{index}"


def make_pod_name(job_name: str, task_name: str, index: int) -> str:
    """reference: pkg/controllers/job/helpers/helpers.go:49-51"""
    return POD_NAME_FMT.format(job=job_name, task=task_name, index=index)


def get_task_index(pod: obj.Pod) -> str:
    """Trailing -N of the pod name (helpers.go:38-45)."""
    parts = pod.metadata.name.split("-")
    return parts[-1] if len(parts) >= 3 else ""


def job_key(namespace: str, name: str) -> str:
    return f"{namespace}/{name}"


@dataclass
class Request:
    """Work item for the job controller (pkg/controllers/apis/request.go)."""
    namespace: str = "default"
    job_name: str = ""
    task_name: str = ""
    queue_name: str = ""
    event: str = ""
    action: str = ""
    exit_code: Optional[int] = None
    job_version: int = 0

    def key(self) -> str:
        return job_key(self.namespace, self.job_name)


@dataclass
class JobInfo:
    """Job + pods by task name (pkg/controllers/apis/job_info.go:31-66)."""
    name: str = ""
    namespace: str = ""
    job: Optional[obj.Job] = None
    pods: Dict[str, Dict[str, obj.Pod]] = field(default_factory=dict)

    def clone(self) -> "JobInfo":
        return JobInfo(name=self.name, namespace=self.namespace, job=self.job,
                       pods={t: dict(ps) for t, ps in self.pods.items()})

    def set_job(self, job: obj.Job) -> None:
        self.name = job.metadata.name
        self.namespace = job.metadata.namespace
        self.job = job

    def add_pod(self, pod: obj.Pod) -> None:
        task_name = pod.metadata.annotations.get(obj.TASK_SPEC_KEY)
        if not task_name:
            raise ValueError(f"failed to find taskName of pod {pod.metadata.key()}")
        self.pods.setdefault(task_name, {})[pod.metadata.name] = pod

    def update_pod(self, pod: obj.Pod) -> None:
        task_name = pod.metadata.annotations.get(obj.TASK_SPEC_KEY)
        if not task_name:
            raise ValueError(f"failed to find taskName of pod {pod.metadata.key()}")
        self.pods.setdefault(task_name, {})[pod.metadata.name] = pod

    def delete_pod(self, pod: obj.Pod) -> None:
        task_name = pod.metadata.annotations.get(obj.TASK_SPEC_KEY)
        if not task_name:
            raise ValueError(f"failed to find taskName of pod {pod.metadata.key()}")
        pods = self.pods.get(task_name, {})
        pods.pop(pod.metadata.name, None)
        if not pods:
            self.pods.pop(task_name, None)


def total_tasks(job: obj.Job) -> int:
    """reference: pkg/controllers/job/state/util.go:24-32"""
    return sum(t.replicas for t in job.spec.tasks)


def total_task_min_available(job: obj.Job) -> int:
    """reference: state/util.go:35-47"""
    return sum(t.min_available if t.min_available is not None else t.replicas
               for t in job.spec.tasks)
