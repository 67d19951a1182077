"""Job controller: reconciles Jobs into PodGroups + per-task pods and drives
the job lifecycle state machine
(reference: pkg/controllers/job/{job_controller,job_controller_actions,
job_controller_handler,job_controller_util}.go).

Event flow: store watches (jobs/pods/podgroups/commands) -> handlers derive a
lifecycle event and enqueue a Request into a sharded work queue -> workers map
(state, policies, event) to an action and execute it via sync_job/kill_job.

The port's own copy of volcano_tpu/controllers/job/controller.py.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Dict, List, Optional, Set

from ...models import objects as obj
from ...models.objects import (Job, JobAction, JobEvent, JobPhase, JobStatus,
                               Pod, PodGroup, PodGroupPhase)
from ...models.resource import Resource
from ..apis import JobInfo, Request, job_key, make_pod_name
from ..cache import JobCache
from ..framework import Controller
from . import plugins as job_plugins
from .state import new_state


def apply_policies(job: Job, req: Request) -> str:
    """Map a lifecycle event to an action via task- then job-level policies
    (reference: job_controller_util.go applyPolicies)."""
    if req.action:
        return req.action
    if req.event == JobEvent.OUT_OF_SYNC:
        return JobAction.SYNC_JOB
    # requests from discarded (older-version) pods only sync
    if req.job_version < job.status.version:
        return JobAction.SYNC_JOB
    if req.task_name:
        for task in job.spec.tasks:
            if task.name == req.task_name:
                for policy in task.policies:
                    if policy.matches(req.event, req.exit_code):
                        return policy.action
                break
    for policy in job.spec.policies:
        if policy.matches(req.event, req.exit_code):
            return policy.action
    return JobAction.SYNC_JOB


class JobController(Controller):
    NAME = "job-controller"

    def __init__(self, workers: int = 4, max_requeue_num: int = 15):
        self.workers = max(1, workers)
        self.max_requeue_num = max_requeue_num
        self.store = None
        self.cache = JobCache()
        # sharded queues keyed by hash(job key) % workers (job_controller.go:130-144)
        self.queues: List[deque] = [deque() for _ in range(self.workers)]
        self._pending: Set[tuple] = set()   # workqueue dedup of identical items
        self.command_queue: deque = deque()
        self.requeue_count: Dict[tuple, int] = {}
        self._watches: list = []

    # -- wiring ------------------------------------------------------------

    def initialize(self, store) -> None:
        self.store = store
        s = store
        self._watches = [
            s.watch("jobs", self._add_job, self._update_job, self._delete_job),
            s.watch("pods", self._add_pod, self._update_pod, self._delete_pod,
                    filter_fn=self._controlled_pod),
            s.watch("podgroups", None, self._update_pod_group, None),
            s.watch("commands", self._add_command, None, None,
                    filter_fn=lambda c: c.target_kind == "Job"),
        ]

    def stop(self) -> None:
        for w in self._watches:
            self.store.unwatch(w)
        self._watches = []

    @staticmethod
    def _controlled_pod(pod: Pod) -> bool:
        """Only pods created from a volcano job (isControlledBy equivalent)."""
        return (pod.metadata.owner or "").startswith("Job/") and \
            obj.JOB_NAME_KEY in pod.metadata.annotations

    def _enqueue(self, req: Request) -> None:
        key = (req.key(), req.task_name, req.event, req.action, req.exit_code,
               req.job_version)
        if key in self._pending:
            return
        self._pending.add(key)
        shard = hash(req.key()) % self.workers
        self.queues[shard].append((key, req))

    # -- handlers (job_controller_handler.go) ------------------------------

    def _add_job(self, job: Job) -> None:
        self.cache.add(job)
        self._enqueue(Request(namespace=job.metadata.namespace,
                              job_name=job.metadata.name,
                              event=JobEvent.OUT_OF_SYNC))

    def _update_job(self, old: Job, new: Job) -> None:
        self.cache.update(new)
        if old.spec == new.spec and \
                old.status.state.phase == new.status.state.phase:
            return
        self._enqueue(Request(namespace=new.metadata.namespace,
                              job_name=new.metadata.name,
                              event=JobEvent.OUT_OF_SYNC))

    def _delete_job(self, job: Job) -> None:
        self.cache.delete(job)
        self._cascade_delete(job)

    def _cascade_delete(self, job: Job) -> None:
        """Owner-reference garbage collection equivalent: deleting a Job
        removes its pods, PodGroup and plugin-controlled resources (in k8s
        this is the apiserver GC following OwnerReferences)."""
        ns = job.metadata.namespace
        owner = f"Job/{ns}/{job.metadata.name}"
        for pod in list(self.store.list("pods", ns)):
            if pod.metadata.owner == owner:
                try:
                    self.store.delete("pods", pod.metadata.name, ns, skip_admission=True)
                except KeyError:
                    pass
        pg = self.store.get("podgroups", job.metadata.name, ns)
        if pg is not None and pg.metadata.owner == owner:
            self.store.delete("podgroups", job.metadata.name, ns, skip_admission=True)
        for plugin in self._job_plugins(job, tolerant=True):
            plugin.on_job_delete(job)

    def _pod_req_fields(self, pod: Pod) -> Optional[tuple]:
        ann = pod.metadata.annotations
        job_name = ann.get(obj.JOB_NAME_KEY)
        task_name = ann.get(obj.TASK_SPEC_KEY)
        version = ann.get(obj.JOB_VERSION_KEY)
        if job_name is None or task_name is None or version is None:
            return None
        return job_name, task_name, int(version)

    def _add_pod(self, pod: Pod) -> None:
        fields = self._pod_req_fields(pod)
        if fields is None:
            return
        job_name, _task, version = fields
        self.cache.add_pod(pod)
        self._enqueue(Request(namespace=pod.metadata.namespace, job_name=job_name,
                              event=JobEvent.OUT_OF_SYNC, job_version=version))

    def _update_pod(self, old: Pod, new: Pod) -> None:
        fields = self._pod_req_fields(new)
        if fields is None:
            return
        job_name, task_name, version = fields
        self.cache.update_pod(new)
        key = job_key(new.metadata.namespace, job_name)

        event = JobEvent.OUT_OF_SYNC
        exit_code: Optional[int] = None
        if new.status.phase == "Failed" and old.status.phase != "Failed":
            event = JobEvent.POD_FAILED
            exit_code = new.status.exit_code
        elif new.status.phase == "Succeeded" and old.status.phase != "Succeeded" \
                and self.cache.task_completed(key, task_name):
            event = JobEvent.TASK_COMPLETED
        elif new.status.phase in ("Pending", "Running") \
                and self.cache.task_failed(key, task_name):
            # job_controller_handler.go:270-273: the task's retries are
            # exhausted, so policies keyed on TaskFailed fire
            event = JobEvent.TASK_FAILED
        self._enqueue(Request(namespace=new.metadata.namespace, job_name=job_name,
                              task_name=task_name, event=event,
                              exit_code=exit_code, job_version=version))

    def _delete_pod(self, pod: Pod) -> None:
        fields = self._pod_req_fields(pod)
        if fields is None:
            return
        job_name, task_name, version = fields
        self.cache.delete_pod(pod)
        self._enqueue(Request(namespace=pod.metadata.namespace, job_name=job_name,
                              task_name=task_name, event=JobEvent.POD_EVICTED,
                              job_version=version))

    def _update_pod_group(self, old: PodGroup, new: PodGroup) -> None:
        if new.status.phase != old.status.phase:
            self._enqueue(Request(namespace=new.metadata.namespace,
                                  job_name=new.metadata.name,
                                  event=JobEvent.OUT_OF_SYNC))

    def _add_command(self, cmd: obj.Command) -> None:
        self.command_queue.append(cmd)

    # -- work loop (job_controller.go:256-358) ------------------------------

    def process_pending(self, max_items: int = 10000) -> int:
        processed = self._process_commands()
        for shard in range(self.workers):
            q = self.queues[shard]
            n = len(q)
            for _ in range(min(n, max_items)):
                key, req = q.popleft()
                self._pending.discard(key)
                self._process_request(req)
                processed += 1
        return processed

    def _process_commands(self) -> int:
        """Commands execute exactly once: delete the Command object first,
        then enqueue the action (job_controller_handler.go:374-404)."""
        n = 0
        while self.command_queue:
            cmd = self.command_queue.popleft()
            try:
                self.store.delete("commands", cmd.metadata.name,
                                  cmd.metadata.namespace, skip_admission=True)
            except KeyError:
                continue   # someone else consumed it
            self.store.record_event("jobs", None, "Normal", "CommandIssued",
                                    f"Start to execute command {cmd.action}")
            self._enqueue(Request(namespace=cmd.metadata.namespace,
                                  job_name=cmd.target_name,
                                  event=JobEvent.COMMAND_ISSUED, action=cmd.action))
            n += 1
        return n

    def _process_request(self, req: Request) -> None:
        job_info = self.cache.get(req.key())
        if job_info is None or job_info.job is None:
            return
        state = new_state(job_info, self.sync_job, self.kill_job,
                          self.kill_target)
        action = apply_policies(job_info.job, req)
        try:
            state.execute(action, target=req.task_name)
            self.requeue_count.pop(self._req_key(req), None)
        except Exception as e:  # requeue with backoff cap (job_controller.go:336-352)
            k = self._req_key(req)
            count = self.requeue_count.get(k, 0) + 1
            self.requeue_count[k] = count
            if self.max_requeue_num < 0 or count < self.max_requeue_num:
                self._enqueue(req)
            else:
                self.store.record_event(
                    "jobs", job_info.job, "Warning", "ExecuteAction",
                    f"Job failed on action {action} for retry limit reached: {e}")
                try:
                    state.execute(JobAction.TERMINATE_JOB)
                except Exception as te:
                    # the terminal kill can fail the same way the original
                    # action did; record it rather than killing the manager
                    self.store.record_event(
                        "jobs", job_info.job, "Warning", "ExecuteAction",
                        f"Job termination after retry limit failed: {te}")

    @staticmethod
    def _req_key(req: Request) -> tuple:
        return (req.key(), req.task_name, req.event, req.action)

    # -- sync (job_controller_actions.go:212-440) ---------------------------

    def _get_live_job(self, job_info: JobInfo) -> Optional[Job]:
        return self.store.get("jobs", job_info.name, job_info.namespace)

    def _job_plugins(self, job: Job, tolerant: bool = False) -> list:
        """Instantiate the job's requested plugins once per operation."""
        out = []
        for name, args in job.spec.plugins.items():
            builder = job_plugins.get_plugin_builder(name)
            if builder is None:
                if tolerant:
                    continue
                raise ValueError(f"job plugin {name!r} not found")
            out.append(builder(self.store, args))
        return out

    def sync_job(self, job_info: JobInfo, update_status) -> None:
        job = self._get_live_job(job_info)
        if job is None:
            return

        if not _is_initiated(job):
            self._initiate_job(job)
        else:
            self._init_on_job_update(job)

        # PodGroup gates pod creation: gang semantics (actions.go:269-281)
        pg = self.store.get("podgroups", job.metadata.name, job.metadata.namespace)
        sync_task = pg is not None and pg.status.phase not in ("", PodGroupPhase.PENDING)
        if pg is not None:
            for cond in pg.status.conditions:
                if cond.type == "Unschedulable":
                    self.store.record_event(
                        "jobs", job, "Warning", "PodGroupPending",
                        f"PodGroup {job.metadata.namespace}:{job.metadata.name} "
                        f"unschedule, reason: {cond.message}")

        if not sync_task:
            self._write_status(job, update_status)
            return

        counts = {"Pending": 0, "Running": 0, "Succeeded": 0, "Failed": 0,
                  "Unknown": 0, "Terminating": 0}
        task_status_count: Dict[str, Dict[str, int]] = {}

        plugins = self._job_plugins(job, tolerant=True)
        pods_to_create: List[Pod] = []
        pods_to_delete: List[Pod] = []
        for ts in job.spec.tasks:
            existing = dict(job_info.pods.get(ts.name, {}))
            for i in range(ts.replicas):
                pod_name = make_pod_name(job.metadata.name, ts.name, i)
                pod = existing.pop(pod_name, None)
                if pod is None:
                    new_pod = create_job_pod(job, ts, i)
                    for plugin in plugins:
                        plugin.on_pod_create(new_pod, job)
                    pods_to_create.append(new_pod)
                else:
                    _classify(pod, counts, task_status_count)
            # replicas scaled down: remove the excess (actions.go:349-351)
            pods_to_delete.extend(existing.values())

        for pod in pods_to_create:
            self.store.create("pods", pod)
            _classify(pod, counts, task_status_count)
        for pod in pods_to_delete:
            try:
                self.store.delete("pods", pod.metadata.name, pod.metadata.namespace,
                                  skip_admission=True)
                counts["Terminating"] += 1
            except KeyError:
                pass

        job = self._get_live_job(job_info) or job
        job.status = JobStatus(
            state=job.status.state,
            pending=counts["Pending"], running=counts["Running"],
            succeeded=counts["Succeeded"], failed=counts["Failed"],
            terminating=counts["Terminating"], unknown=counts["Unknown"],
            version=job.status.version, min_available=job.spec.min_available,
            task_status_count=task_status_count,
            controlled_resources=job.status.controlled_resources,
            retry_count=job.status.retry_count)
        self._write_status(job, update_status)

    def kill_target(self, job_info: JobInfo, task_name: str,
                    update_status=None) -> None:
        """RestartTask: delete ONLY the named task's pods (all phases) and
        bump the job version so their in-flight requests are discarded;
        the next sync recreates them. The job phase is untouched — the
        action's contract is a task-scoped restart
        (bus/v1alpha1/actions.go:31-33)."""
        job = self._get_live_job(job_info)
        if job is None:
            return
        for pod in list(job_info.pods.get(task_name, {}).values()):
            try:
                self.store.delete("pods", pod.metadata.name,
                                  pod.metadata.namespace,
                                  skip_admission=True)
            except KeyError:
                pass
        job = self._get_live_job(job_info) or job
        job.status.version += 1
        self.store.record_event(
            "jobs", job, "Normal", "RestartTask",
            f"Restarting task {task_name} pods")
        # like kill_job: the write must land (a ConflictError propagates so
        # the request requeues — a silently lost version bump would let
        # stale POD_FAILED events at the old version re-trigger the
        # restart) and the controller cache must see the bump immediately
        # (the async mirror can lag a queued same-version request)
        self.store.update("jobs", job, skip_admission=True)
        self.cache.update(job)

    def kill_job(self, job_info: JobInfo, pod_retain_phases: Set[str],
                 update_status) -> None:
        """job_controller_actions.go:43-150"""
        job = self._get_live_job(job_info)
        if job is None:
            return

        counts = {"Pending": 0, "Running": 0, "Succeeded": 0, "Failed": 0,
                  "Unknown": 0, "Terminating": 0}
        task_status_count: Dict[str, Dict[str, int]] = {}
        last_retry = job.status.retry_count >= job.spec.max_retry - 1

        for pods in job_info.pods.values():
            for pod in pods.values():
                retain = pod.status.phase in pod_retain_phases
                if not retain and not last_retry:
                    try:
                        self.store.delete("pods", pod.metadata.name,
                                          pod.metadata.namespace, skip_admission=True)
                        counts["Terminating"] += 1
                        continue
                    except KeyError:
                        counts["Terminating"] += 1
                        continue
                _classify(pod, counts, task_status_count)

        job = self._get_live_job(job_info) or job
        # version bumped only on kill (actions.go:104)
        job.status.version += 1
        job.status.pending = counts["Pending"]
        job.status.running = counts["Running"]
        job.status.succeeded = counts["Succeeded"]
        job.status.failed = counts["Failed"]
        job.status.terminating = 0   # store deletes are synchronous
        job.status.unknown = counts["Unknown"]
        job.status.task_status_count = task_status_count

        if update_status is not None and update_status(job.status):
            job.status.state.last_transition_time = self.store.clock.now()
        for plugin in self._job_plugins(job, tolerant=True):
            plugin.on_job_delete(job)
        self.store.update("jobs", job, skip_admission=True)
        self.cache.update(job)

        pg = self.store.get("podgroups", job.metadata.name, job.metadata.namespace)
        if pg is not None:
            self.store.delete("podgroups", job.metadata.name,
                              job.metadata.namespace, skip_admission=True)

    # -- initiation (actions.go:154-210,536-642) ----------------------------

    def _initiate_job(self, job: Job) -> None:
        if not job.status.state.phase:
            job.status.state.phase = JobPhase.PENDING
            job.status.state.last_transition_time = self.store.clock.now()
            job.status.min_available = job.spec.min_available
        for plugin in self._job_plugins(job):
            plugin.on_job_add(job)
        self._create_job_io_if_not_exist(job)
        self._create_or_update_podgroup(job)
        self.store.update("jobs", job, skip_admission=True)
        self.cache.update(job)

    def _init_on_job_update(self, job: Job) -> None:
        for plugin in self._job_plugins(job):
            plugin.on_job_update(job)
        self._create_or_update_podgroup(job)

    def _create_job_io_if_not_exist(self, job: Job) -> None:
        """PVC creation for job volumes (actions.go:446-505)."""
        for i, volume in enumerate(job.spec.volumes):
            vc_name = volume.get("volume_claim_name", "")
            if not vc_name:
                vc_name = f"{job.metadata.name}-pvc-{i}"
                volume["volume_claim_name"] = vc_name
                if self.store.get("persistentvolumeclaims", vc_name,
                                  job.metadata.namespace) is None:
                    self.store.create("persistentvolumeclaims", obj.PersistentVolumeClaim(
                        metadata=obj.ObjectMeta(
                            name=vc_name, namespace=job.metadata.namespace,
                            owner=f"Job/{job.metadata.namespace}/{job.metadata.name}"),
                        spec=volume.get("volume_claim", {})))
            elif self.store.get("persistentvolumeclaims", vc_name,
                                job.metadata.namespace) is None:
                raise ValueError(
                    f"pvc {vc_name} is not found, the job will remain Pending "
                    f"until the PVC is created")
            job.status.controlled_resources[f"volume-pvc-{vc_name}"] = vc_name

    def _create_or_update_podgroup(self, job: Job) -> None:
        """actions.go:536-642"""
        ns = job.metadata.namespace
        pg = self.store.get("podgroups", job.metadata.name, ns)
        if pg is None:
            min_task_member = {t.name: (t.min_available if t.min_available is not None
                                        else t.replicas)
                               for t in job.spec.tasks}
            pg = PodGroup(metadata=obj.ObjectMeta(
                name=job.metadata.name, namespace=ns,
                annotations=dict(job.metadata.annotations),
                labels=dict(job.metadata.labels),
                owner=f"Job/{ns}/{job.metadata.name}"))
            pg.spec.min_member = job.spec.min_available
            pg.spec.min_task_member = min_task_member
            pg.spec.queue = job.spec.queue
            pg.spec.min_resources = self._calc_pg_min_resources(job)
            pg.spec.priority_class_name = job.spec.priority_class_name
            self.store.create("podgroups", pg)
            return
        should_update = False
        if pg.spec.priority_class_name != job.spec.priority_class_name:
            pg.spec.priority_class_name = job.spec.priority_class_name
            should_update = True
        min_resources = self._calc_pg_min_resources(job)
        if pg.spec.min_member != job.spec.min_available or \
                pg.spec.min_resources != min_resources:
            pg.spec.min_member = job.spec.min_available
            pg.spec.min_resources = min_resources
            should_update = True
        for task in job.spec.tasks:
            if task.min_available is None:
                continue
            if pg.spec.min_task_member.get(task.name) != task.min_available:
                pg.spec.min_task_member[task.name] = task.min_available
                should_update = True
        if should_update:
            self.store.update("podgroups", pg, skip_admission=True)

    def _calc_pg_min_resources(self, job: Job) -> Dict[str, float]:
        """Sum requests of the minAvailable highest-priority pods
        (actions.go:644-678)."""
        def task_priority(ts) -> int:
            pc = self.store.get("priorityclasses",
                                ts.template.spec.priority_class_name)
            return pc.value if pc is not None else 0

        total = Resource()
        pod_cnt = 0
        for ts in sorted(job.spec.tasks, key=task_priority, reverse=True):
            per_pod = Resource()
            for c in ts.template.spec.containers:
                per_pod.add(Resource.from_resource_list(c.requests))
            for _ in range(ts.replicas):
                if pod_cnt >= job.spec.min_available:
                    break
                pod_cnt += 1
                total.add(per_pod)
        return total.to_resource_list()

    def _write_status(self, job: Job, update_status) -> None:
        if update_status is not None and update_status(job.status):
            job.status.state.last_transition_time = self.store.clock.now()
        self.store.update("jobs", job, skip_admission=True)
        self.cache.update(job)


# -- pod construction (job_controller_util.go createJobPod) -----------------

def create_job_pod(job: Job, task_spec, index: int) -> Pod:
    template = copy.deepcopy(task_spec.template)
    pod = Pod(metadata=obj.ObjectMeta(
        name=make_pod_name(job.metadata.name, task_spec.name, index),
        namespace=job.metadata.namespace,
        labels=dict(template.metadata.labels),
        annotations=dict(template.metadata.annotations),
        owner=f"Job/{job.metadata.namespace}/{job.metadata.name}"),
        spec=template.spec)
    if not pod.spec.scheduler_name:
        pod.spec.scheduler_name = job.spec.scheduler_name

    for volume in job.spec.volumes:
        vc_name = volume.get("volume_claim_name", "")
        pod.spec.volumes.append({"name": vc_name, "pvc": vc_name,
                                 "mount_path": volume.get("mount_path", "")})
        for c in pod.spec.containers:
            c.volume_mounts.append({"name": vc_name,
                                    "mount_path": volume.get("mount_path", "")})

    ann = pod.metadata.annotations
    ann[obj.TASK_SPEC_KEY] = task_spec.name
    ann[obj.GROUP_NAME_ANNOTATION] = job.metadata.name
    ann[obj.JOB_NAME_KEY] = job.metadata.name
    ann[obj.QUEUE_NAME_KEY] = job.spec.queue
    ann[obj.JOB_VERSION_KEY] = str(job.status.version)
    if task_spec.topology_policy:
        ann[obj.NUMA_TOPOLOGY_POLICY_KEY] = task_spec.topology_policy
    for key in (obj.PREEMPTABLE_KEY, obj.REVOCABLE_ZONE_KEY,
                obj.JDB_MIN_AVAILABLE_KEY, obj.JDB_MAX_UNAVAILABLE_KEY):
        if key in job.metadata.annotations:
            ann[key] = job.metadata.annotations[key]

    labels = pod.metadata.labels
    labels[obj.JOB_NAME_KEY] = job.metadata.name
    labels[obj.TASK_SPEC_KEY] = task_spec.name
    labels["volcano.sh/job-namespace"] = job.metadata.namespace
    labels[obj.QUEUE_NAME_KEY] = job.spec.queue
    if obj.PREEMPTABLE_KEY in job.metadata.labels:
        labels[obj.PREEMPTABLE_KEY] = job.metadata.labels[obj.PREEMPTABLE_KEY]
    return pod


def _is_initiated(job: Job) -> bool:
    """job_controller_actions.go isInitiated — Pending jobs re-run initiation
    every sync (all its steps are idempotent)."""
    return job.status.state.phase not in ("", JobPhase.PENDING)


def _classify(pod: Pod, counts: Dict[str, int],
              task_status_count: Dict[str, Dict[str, int]]) -> None:
    """classifyAndAddUpPodBaseOnPhase + calcPodStatus"""
    phase = pod.status.phase
    if phase not in counts:
        phase = "Unknown"
    counts[phase] += 1
    task_name = pod.metadata.annotations.get(obj.TASK_SPEC_KEY)
    if task_name:
        task_status_count.setdefault(task_name, {})
        task_status_count[task_name][phase] = \
            task_status_count[task_name].get(phase, 0) + 1
