"""vcctl job subcommands (reference: pkg/cli/job/{run,list,view,suspend,
resume,delete}.go).

The port's own copy of volcano_tpu/cli/job.py."""

from __future__ import annotations

import time
from typing import Optional

from ..models import objects as obj
from ..models.objects import (Command, Container, Job, JobAction, JobSpec,
                              ObjectMeta, PodSpec, PodTemplate, TaskSpec)
from .util import parse_resource_list, print_table


def run_job(client, name: str, namespace: str = "default",
            image: str = "busybox", replicas: int = 1, min_available: int = 1,
            requests: str = "cpu=1000m,memory=100Mi",
            limits: str = "cpu=1000m,memory=100Mi",
            scheduler: str = obj.DEFAULT_SCHEDULER_NAME,
            queue: str = obj.DEFAULT_QUEUE,
            filename: Optional[str] = None) -> str:
    """pkg/cli/job/run.go:70-112"""
    if not name and not filename:
        raise ValueError("job name cannot be left blank")
    if filename:
        job = load_job_file(filename)
    else:
        job = Job(
            metadata=ObjectMeta(name=name, namespace=namespace),
            spec=JobSpec(
                min_available=min_available, queue=queue,
                scheduler_name=scheduler,
                tasks=[TaskSpec(
                    name=name, replicas=replicas,
                    template=PodTemplate(
                        metadata=ObjectMeta(name=name),
                        spec=PodSpec(containers=[Container(
                            name=name, image=image,
                            requests=parse_resource_list(requests),
                            limits=parse_resource_list(limits))])))]))
    created = client.create("jobs", job)
    return f"run job {created.metadata.name} successfully"


def load_job_file(filename: str) -> Job:
    """-f job.yaml (run.go readFile); YAML shape mirrors the CRD."""
    import yaml

    from ..apiserver.codec import decode_object
    with open(filename) as f:
        data = yaml.safe_load(f)
    # accept both wire-format dicts and k8s-style manifests
    if "apiVersion" in data or "kind" in data:
        meta = data.get("metadata", {})
        spec = data.get("spec", {})
        tasks = []
        for t in spec.get("tasks", []):
            template = t.get("template", {})
            pod_spec = template.get("spec", {})
            containers = [Container(
                name=c.get("name", "main"), image=c.get("image", ""),
                requests=(c.get("resources", {}) or {}).get("requests", {}),
                limits=(c.get("resources", {}) or {}).get("limits", {}),
                command=c.get("command", []))
                for c in pod_spec.get("containers", [])]
            tasks.append(TaskSpec(
                name=t.get("name", ""), replicas=t.get("replicas", 1),
                min_available=t.get("minAvailable"),
                template=PodTemplate(spec=PodSpec(containers=containers))))
        return Job(
            metadata=ObjectMeta(name=meta.get("name", ""),
                                namespace=meta.get("namespace", "default")),
            spec=JobSpec(
                min_available=spec.get("minAvailable", 0),
                queue=spec.get("queue", obj.DEFAULT_QUEUE),
                scheduler_name=spec.get("schedulerName",
                                        obj.DEFAULT_SCHEDULER_NAME),
                max_retry=spec.get("maxRetry", 0),
                plugins=spec.get("plugins", {}),
                tasks=tasks))
    return decode_object("jobs", data)


def list_jobs(client, namespace: str = "default", all_namespaces: bool = False,
              scheduler: str = "", selector: str = "") -> str:
    """pkg/cli/job/list.go:95-160"""
    jobs = client.list("jobs", None if all_namespaces else namespace)
    headers = ["Name", "Creation", "Phase", "JobType", "Replicas", "Min",
               "Pending", "Running", "Succeeded", "Failed", "Unknown",
               "RetryCount"]
    if all_namespaces:
        headers.insert(0, "Namespace")
    rows = []
    for job in jobs:
        if scheduler and job.spec.scheduler_name != scheduler:
            continue
        if selector and selector not in job.metadata.name:
            continue
        replicas = sum(t.replicas for t in job.spec.tasks)
        created = time.strftime(
            "%Y-%m-%d", time.localtime(job.metadata.creation_timestamp)) \
            if job.metadata.creation_timestamp else "-"
        row = [job.metadata.name, created, job.status.state.phase or "-",
               "batch", replicas, job.spec.min_available,
               job.status.pending, job.status.running, job.status.succeeded,
               job.status.failed, job.status.unknown, job.status.retry_count]
        if all_namespaces:
            row.insert(0, job.metadata.namespace)
        rows.append(row)
    return print_table(headers, rows)


def view_job(client, name: str, namespace: str = "default") -> str:
    """pkg/cli/job/view.go — job + its pods"""
    if not name:
        raise ValueError("job name must be specified")
    job = client.get("jobs", name, namespace)
    if job is None:
        raise ValueError(f"job {namespace}/{name} not found")
    lines = [
        f"Name:       {job.metadata.name}",
        f"Namespace:  {job.metadata.namespace}",
        f"Queue:      {job.spec.queue}",
        f"Scheduler:  {job.spec.scheduler_name}",
        f"Phase:      {job.status.state.phase or '-'}",
        f"MinAvailable: {job.spec.min_available}",
        f"RetryCount: {job.status.retry_count}",
        "Tasks:",
    ]
    for t in job.spec.tasks:
        lines.append(f"  - {t.name}: replicas={t.replicas}"
                     + (f" minAvailable={t.min_available}"
                        if t.min_available is not None else ""))
    pods = [p for p in client.list("pods", namespace)
            if p.metadata.annotations.get(obj.JOB_NAME_KEY) == name]
    if pods:
        lines.append("Pods:")
        for p in sorted(pods, key=lambda p: p.metadata.name):
            lines.append(f"  - {p.metadata.name}: phase={p.status.phase} "
                         f"node={p.spec.node_name or '-'}")
    return "\n".join(lines)


def _create_job_command(client, namespace: str, name: str, action: str) -> None:
    """pkg/cli/util createJobCommand — Command CR targeted at the job."""
    job = client.get("jobs", name, namespace)
    if job is None:
        raise ValueError(f"job {namespace}/{name} not found")
    cmd = Command(
        metadata=ObjectMeta(
            name=f"{name}-{action.lower()}-{int(time.time() * 1000) % 100000}",
            namespace=namespace),
        action=action, target_kind="Job", target_name=name)
    client.create("commands", cmd)


def suspend_job(client, name: str, namespace: str = "default") -> str:
    """pkg/cli/job/suspend.go — AbortJob command"""
    if not name:
        raise ValueError("job name is mandatory to suspend a particular job")
    _create_job_command(client, namespace, name, JobAction.ABORT_JOB)
    return f"suspend job {name} successfully"


def resume_job(client, name: str, namespace: str = "default") -> str:
    """pkg/cli/job/resume.go — ResumeJob command"""
    if not name:
        raise ValueError("job name is mandatory to resume a particular job")
    _create_job_command(client, namespace, name, JobAction.RESUME_JOB)
    return f"resume job {name} successfully"


def delete_job(client, name: str, namespace: str = "default") -> str:
    """pkg/cli/job/delete.go"""
    if not name:
        raise ValueError("job name is mandatory to delete a particular job")
    client.delete("jobs", name, namespace)
    return f"delete job {name} successfully"
