"""Controller job cache: local Job + Pods index with delayed cleanup
(reference: pkg/controllers/cache/cache.go:76-350).

Keyed by "namespace/name". ``get`` returns a clone so workers never race the
live index; TaskCompleted/TaskFailed implement the rollups the pod-update
handler uses to derive TaskCompleted/TaskFailed lifecycle events.

The port's own copy of volcano_tpu/controllers/cache.py.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, Optional

from ..models import objects as obj
from .apis import JobInfo, job_key


class JobCache:
    def __init__(self, clock=None):
        self.jobs: Dict[str, JobInfo] = {}
        self.lock = threading.RLock()
        self.delete_queue: Deque[tuple] = deque()   # (due_time, job_key)
        self.clock = clock

    # -- job ops (cache.go:115-192) ---------------------------------------

    def key_of(self, job: obj.Job) -> str:
        return job_key(job.metadata.namespace, job.metadata.name)

    def get(self, key: str) -> Optional[JobInfo]:
        with self.lock:
            ji = self.jobs.get(key)
            if ji is None or ji.job is None:
                return None
            return ji.clone()

    def add(self, job: obj.Job) -> None:
        with self.lock:
            key = self.key_of(job)
            ji = self.jobs.get(key)
            if ji is None:
                ji = JobInfo()
                self.jobs[key] = ji
            ji.set_job(job)

    def update(self, job: obj.Job) -> None:
        with self.lock:
            key = self.key_of(job)
            ji = self.jobs.get(key)
            if ji is None:
                ji = JobInfo()
                self.jobs[key] = ji
            # keep the freshest object (resource-version guard, cache.go:180)
            if ji.job is None or job.metadata.resource_version >= ji.job.metadata.resource_version:
                ji.set_job(job)

    def delete(self, job: obj.Job) -> None:
        with self.lock:
            key = self.key_of(job)
            ji = self.jobs.get(key)
            if ji is not None:
                ji.job = None
                if not ji.pods:
                    self.jobs.pop(key, None)

    # -- pod ops (cache.go:194-246) ---------------------------------------

    def _job_key_of_pod(self, pod: obj.Pod) -> Optional[str]:
        name = pod.metadata.annotations.get(obj.JOB_NAME_KEY)
        if not name:
            return None
        return job_key(pod.metadata.namespace, name)

    def add_pod(self, pod: obj.Pod) -> None:
        key = self._job_key_of_pod(pod)
        if key is None:
            return
        with self.lock:
            ji = self.jobs.get(key)
            if ji is None:
                ji = JobInfo(namespace=pod.metadata.namespace)
                self.jobs[key] = ji
            ji.update_pod(pod)

    update_pod = add_pod

    def delete_pod(self, pod: obj.Pod) -> None:
        key = self._job_key_of_pod(pod)
        if key is None:
            return
        with self.lock:
            ji = self.jobs.get(key)
            if ji is None:
                return
            ji.delete_pod(pod)
            if ji.job is None and not ji.pods:
                self.jobs.pop(key, None)

    # -- rollups (cache.go:248-334) ----------------------------------------

    def task_completed(self, key: str, task_name: str) -> bool:
        """All replicas of the task Succeeded (cache.go:248-285)."""
        with self.lock:
            ji = self.jobs.get(key)
            if ji is None or ji.job is None:
                return False
            task_pods = ji.pods.get(task_name)
            if not task_pods:
                return False
            replicas = next((t.replicas for t in ji.job.spec.tasks
                             if t.name == task_name), 0)
            if replicas <= 0:
                return False
            completed = sum(1 for p in task_pods.values()
                            if p.status.phase == "Succeeded")
            return completed >= replicas

    def task_failed(self, key: str, task_name: str) -> bool:
        """Task retries exhausted (cache.go:287-334). Our Pod model has no
        container restart counts, so a task is failed when every replica is
        in Failed phase."""
        with self.lock:
            ji = self.jobs.get(key)
            if ji is None or ji.job is None:
                return False
            task_pods = ji.pods.get(task_name)
            if not task_pods:
                return False
            replicas = next((t.replicas for t in ji.job.spec.tasks
                             if t.name == task_name), 0)
            if replicas <= 0:
                return False
            failed = sum(1 for p in task_pods.values()
                         if p.status.phase == "Failed")
            return failed >= replicas
