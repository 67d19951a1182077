"""NodeInfo: per-node resource state machine.

The port's own copy of volcano_tpu/models/node_info.py (``clone``'s
Resources and task table are cloned by the native engine under
``job_info.NATIVE_CLONE``). Behavioral contract
mirrors the reference (pkg/scheduler/api/node_info.go):
Idle/Used/Releasing/Pipelined accounting by task status (AddTask:341,
RemoveTask:388), FutureIdle = Idle + Releasing - Pipelined (:71-73),
oversubscription ingestion (:187-226), ready/phase state (:227-263), and
GPU-share device accounting (:264-289, 463-509 + device_info.go).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from . import objects
from .objects import Node
from . import job_info
from .job_info import TaskInfo, TaskStatus
from .resource import EPS, GPU_MEMORY_RESOURCE, GPU_NUMBER_RESOURCE, Resource, ZERO


class GPUDevice:
    """One shareable GPU card (reference: pkg/scheduler/api/device_info.go:24-72)."""

    def __init__(self, gpu_id: int, memory: float):
        self.id = gpu_id
        self.memory = memory
        self.pod_map: Dict[str, float] = {}  # pod uid -> gpu memory used

    def get_pods_used_gpu_memory(self) -> float:
        return sum(self.pod_map.values())


def get_gpu_memory_of_pod(pod) -> float:
    """Requested volcano.sh/gpu-memory across containers (device_info.go)."""
    mem = 0.0
    for c in pod.spec.containers:
        req = Resource.from_resource_list(c.requests)
        mem += req.get(GPU_MEMORY_RESOURCE) / 1000.0  # stored in milli-units
    return mem


class NodeState:
    def __init__(self, phase: str = "Ready", reason: str = ""):
        self.phase = phase
        self.reason = reason


class NodeInfo:
    """Aggregated per-node scheduling state."""

    def __init__(self, node: Optional[Node] = None):
        self.name: str = ""
        self.node: Optional[Node] = node
        self.state = NodeState()
        self.releasing = Resource()
        self.pipelined = Resource()
        self.idle = Resource()
        self.used = Resource()
        self.allocatable = Resource()
        self.capability = Resource()
        self.tasks: Dict[str, TaskInfo] = {}
        self.numa_info = None            # NumatopoInfo, set by cache
        self.numa_scheduler_info = None
        self.numa_chg_flag: str = ""     # ""|"more"|"less" (NumaChgFlag)
        self.revocable_zone: str = ""
        self.others: Dict[str, object] = {}
        # topology labels the placement constraints read (zone/rack/...):
        # captured once per NodeInfo build — node labels are effectively
        # immutable for a Node object's lifetime (a relabel arrives as a
        # new Node through the watch, rebuilding the NodeInfo)
        self.topology: Dict[str, str] = {}
        self.gpu_devices: Dict[int, GPUDevice] = {}
        self.oversubscription_node: bool = False
        self.offline_job_evicting: bool = False
        self.oversubscription_resource = Resource()

        self._set_oversubscription(node)
        if node is not None:
            self.name = node.metadata.name
            alloc = Resource.from_resource_list(node.status.allocatable)
            self.idle = alloc.clone().add(self.oversubscription_resource)
            self.allocatable = alloc.clone().add(self.oversubscription_resource)
            self.capability = Resource.from_resource_list(node.status.capacity) \
                .add(self.oversubscription_resource)
        self._set_gpu_info(node)
        self._set_node_state(node)
        self._set_revocable_zone(node)

    # -- node-level state --------------------------------------------------

    def _set_oversubscription(self, node: Optional[Node]) -> None:
        """Oversubscription annotations (node_info.go:187-226)."""
        if node is None:
            return
        a = node.metadata.annotations
        self.oversubscription_node = a.get(objects.OVERSUBSCRIPTION_NODE_KEY, "").lower() == "true"
        self.offline_job_evicting = a.get(objects.OFFLINE_JOB_EVICTING_KEY, "").lower() == "true"
        res = a.get(objects.OVERSUBSCRIPTION_RESOURCE_KEY, "")
        if self.oversubscription_node and res:
            # "cpu:1000,memory:10Gi" style annotation
            rl = {}
            for part in res.split(","):
                if ":" in part:
                    k, v = part.split(":", 1)
                    rl[k.strip()] = v.strip()
            self.oversubscription_resource = Resource.from_resource_list(rl)

    def _set_node_state(self, node: Optional[Node]) -> None:
        """Ready iff node exists, schedulable and Ready (node_info.go:227-263)."""
        if node is None:
            self.state = NodeState("NotReady", "UnknownNode")
            return
        if node.spec.unschedulable:
            self.state = NodeState("NotReady", "Unschedulable")
            return
        if not node.status.ready:
            self.state = NodeState("NotReady", "NotReady")
            return
        self.state = NodeState("Ready")

    def _set_revocable_zone(self, node: Optional[Node]) -> None:
        if node is None:
            return
        self.revocable_zone = node.metadata.labels.get(objects.REVOCABLE_ZONE_LABEL, "")
        # topology label capture for the placement constraints: the
        # conventional topology.* namespace plus
        # the hostname identity key — arbitrary keys fall back to
        # :meth:`topology_value`'s label lookup
        labels = node.metadata.labels
        self.topology = {k: v for k, v in labels.items()
                         if k.startswith("topology.")
                         or k == "kubernetes.io/hostname"}

    def topology_value(self, key: str) -> Optional[str]:
        """The node's value for a topology key (zone/rack/hostname/...),
        None when the label is absent — absent-label nodes never satisfy a
        constraint over that key (upstream PodTopologySpread semantics)."""
        v = self.topology.get(key)
        if v is None and self.node is not None:
            v = self.node.metadata.labels.get(key)
        return v

    def _set_gpu_info(self, node: Optional[Node]) -> None:
        """Populate shareable GPU devices from capacity (node_info.go:264-289)."""
        if node is None:
            return
        cap = Resource.from_resource_list(node.status.capacity)
        mem_total = cap.get(GPU_MEMORY_RESOURCE) / 1000.0
        num = int(cap.get(GPU_NUMBER_RESOURCE) / 1000.0)
        if num > 0 and mem_total > 0:
            per_card = mem_total / num
            for i in range(num):
                self.gpu_devices[i] = GPUDevice(i, per_card)

    def ready(self) -> bool:
        return self.state.phase == "Ready"

    def refresh_numa_scheduler_info(self) -> None:
        """Sync scheduler-side NUMA view from the CRD-fed one, only widening
        (or narrowing when the kubelet shrank allocatable)
        (node_info.go:120-143 RefreshNumaSchedulerInfoByCrd)."""
        if self.numa_info is None:
            self.numa_scheduler_info = None
            return
        if self.numa_scheduler_info is None or self.numa_chg_flag == "more":
            self.numa_scheduler_info = self.numa_info.clone()
        elif self.numa_chg_flag == "less":
            tmp = self.numa_info.clone()
            for res, resinfo in tmp.numa_res_map.items():
                cur = self.numa_scheduler_info.numa_res_map.get(res)
                if cur is not None and len(cur.allocatable) >= len(resinfo.allocatable):
                    cur.allocatable = set(resinfo.allocatable)
                    cur.capacity = resinfo.capacity
        self.numa_chg_flag = ""

    def future_idle(self) -> Resource:
        """Idle + Releasing - Pipelined (node_info.go:71-73)."""
        return self.idle.clone().add(self.releasing).sub(self.pipelined)

    # -- task accounting ---------------------------------------------------

    def _allocate_idle(self, ti: TaskInfo) -> None:
        if not ti.resreq.less_equal(self.idle, ZERO):
            raise RuntimeError("selected node NotReady")
        self.idle.sub_unchecked(ti.resreq)   # checked on the line above

    def add_task(self, task: TaskInfo) -> None:
        """Add a task; accounting depends on its status (node_info.go:341-384).
        On error, both task and node are left unchanged."""
        if task.node_name and self.name and task.node_name != self.name:
            raise RuntimeError(
                f"task <{task.namespace}/{task.name}> already on different "
                f"node <{task.node_name}>")
        key = task.key()
        if key in self.tasks:
            raise RuntimeError(
                f"task <{task.namespace}/{task.name}> already on node <{self.name}>")
        ti = task.clone()
        if self.node is not None:
            if ti.status == TaskStatus.Releasing:
                self._allocate_idle(ti)
                self.releasing.add(ti.resreq)
                self.used.add(ti.resreq)
                self.add_gpu_resource(ti.pod)
            elif ti.status == TaskStatus.Pipelined:
                self.pipelined.add(ti.resreq)
            else:
                self._allocate_idle(ti)
                self.used.add(ti.resreq)
                self.add_gpu_resource(ti.pod)
        task.node_name = self.name
        ti.node_name = self.name
        self.tasks[key] = ti

    def add_tasks_bulk(self, tasks: List[TaskInfo], pipelined: bool,
                       total: Optional[Resource] = None,
                       share_objects: bool = False) -> None:
        """Add many same-status tasks with one resource-accounting pass
        (the per-node form of :meth:`add_task` — the allocate hot path
        lands ~5 tasks per node per cycle, and per-task idle checks plus
        used/idle updates dominated staging cost).

        All-or-nothing: validates everything (node identity, duplicates,
        combined fit against idle) before mutating, so no mid-way rollback
        can be needed. The combined-sum fit check is equivalent to the
        per-task declining-idle sequence. Callers needing prefix
        (keep-partial) semantics use the per-task path."""
        keys = []
        seen = set()
        summing = total is None
        if summing:
            total = Resource()
        for task in tasks:
            if task.node_name and self.name and task.node_name != self.name:
                raise RuntimeError(
                    f"task <{task.namespace}/{task.name}> already on "
                    f"different node <{task.node_name}>")
            key = task.key()
            if key in self.tasks or key in seen:
                raise RuntimeError(f"task <{task.namespace}/{task.name}> "
                                   f"already on node <{self.name}>")
            keys.append(key)
            seen.add(key)
            if summing:
                total.add(task.resreq)
        if self.node is not None and not pipelined \
                and not total.less_equal(self.idle, ZERO):
            raise RuntimeError("selected node NotReady")
        if self.node is not None:
            if pipelined:
                self.pipelined.add(total)
            else:
                self.idle.sub_unchecked(total)
                self.used.add(total)
        # share_objects: store the caller's TaskInfo instead of a clone.
        # Safe ONLY when no status-class-crossing transition can hit the
        # stored view while it is on the node — the session staging path
        # qualifies (victim selection is Running-only, staged tasks are
        # Allocated/Pipelined/Binding, and discard removes before the
        # status moves back). The cache keeps clones: its evict path
        # relies on the stored view holding the pre-transition status.
        for key, task in zip(keys, tasks):
            ti = task if share_objects else task.clone()
            if self.node is not None and not pipelined:
                self.add_gpu_resource(ti.pod)
            task.node_name = self.name
            ti.node_name = self.name
            self.tasks[key] = ti

    def remove_task(self, ti: TaskInfo) -> None:
        """Remove a task, reversing its accounting (node_info.go:388-420)."""
        key = ti.key()
        task = self.tasks.get(key)
        if task is None:
            return
        if self.node is not None:
            if task.status == TaskStatus.Releasing:
                self.releasing.sub(task.resreq)
                self.idle.add(task.resreq)
                self.used.sub(task.resreq)
                self.sub_gpu_resource(ti.pod)
            elif task.status == TaskStatus.Pipelined:
                self.pipelined.sub(task.resreq)
            else:
                self.idle.add(task.resreq)
                self.used.sub(task.resreq)
                self.sub_gpu_resource(ti.pod)
        ti.node_name = ""
        del self.tasks[key]

    def update_task(self, ti: TaskInfo) -> None:
        self.remove_task(ti)
        self.add_task(ti)

    def transition_task(self, ti: TaskInfo) -> None:
        """Status-only transition for a task already on this node.

        Equivalent to :meth:`update_task` but applies the accounting
        *delta* for the Running<->Releasing flip (the preempt/reclaim
        eviction pair) instead of fully reversing and replaying six
        Resource ops plus a task clone — idle/used cancel out, only
        ``releasing`` moves (node_info.go:388-420 replayed pairwise)."""
        stored = self.tasks.get(ti.key())
        if stored is None or self.node is None:
            self.update_task(ti)
            return
        old, new = stored.status, ti.status
        if old == TaskStatus.Running and new == TaskStatus.Releasing:
            self.releasing.add(stored.resreq)
        elif old == TaskStatus.Releasing and new == TaskStatus.Running:
            self.releasing.sub(stored.resreq)
        elif old != new:
            self.update_task(ti)
            return
        stored.status = new

    def set_node(self, node: Node) -> None:
        """Re-ingest node object, rebasing Idle on allocatable minus current
        usage (node_info.go:291-327)."""
        self.name = node.metadata.name
        self.node = node
        self._set_oversubscription(node)
        self._set_node_state(node)
        self._set_revocable_zone(node)
        self._set_gpu_info(node)
        if not self.ready():
            return
        alloc = Resource.from_resource_list(node.status.allocatable) \
            .add(self.oversubscription_resource)
        self.allocatable = alloc.clone()
        self.capability = Resource.from_resource_list(node.status.capacity) \
            .add(self.oversubscription_resource)
        self.idle = alloc.clone()
        self.used = Resource()
        self.releasing = Resource()
        self.pipelined = Resource()
        tasks = list(self.tasks.values())
        self.tasks = {}
        for t in tasks:
            t2 = t.clone()
            t2.node_name = ""
            self.add_task(t2)

    def clone(self) -> "NodeInfo":
        """Direct field copy (node_info.go Clone's deepcopy semantics).

        The accounting state (idle/used/releasing/pipelined) is copied as-is
        rather than re-derived by replaying add_task — the snapshot must
        mirror the cache's state, and replaying costs O(tasks) resource
        arithmetic plus a quantity re-parse per node, which dominated the
        per-cycle snapshot at 10k nodes."""
        # the native engine clones the Resources and the task table in C;
        # the fields stay Python stores (see JobInfo.clone)
        if job_info.NATIVE_CLONE:
            fm = job_info._fastmodel()
            clone_resource = fm.clone_resource
            tasks = fm.clone_task_dict(self.tasks)
        else:
            clone_resource = Resource.clone
            tasks = {k: t.clone() for k, t in self.tasks.items()}
        c = NodeInfo.__new__(NodeInfo)
        c.name = self.name
        c.node = self.node
        c.state = self.state
        c.releasing = clone_resource(self.releasing)
        c.pipelined = clone_resource(self.pipelined)
        c.idle = clone_resource(self.idle)
        c.used = clone_resource(self.used)
        # capacity vectors are only ever replaced wholesale (set_node),
        # never mutated in place — share them across clones
        c.allocatable = self.allocatable
        c.capability = self.capability
        c.tasks = tasks
        c.numa_info = self.numa_info
        c.numa_scheduler_info = (self.numa_scheduler_info.clone()
                                 if self.numa_scheduler_info is not None else None)
        c.numa_chg_flag = self.numa_chg_flag
        c.revocable_zone = self.revocable_zone
        c.topology = self.topology   # immutable after build: share
        c.others = dict(self.others)
        devices = {}
        for i, d in self.gpu_devices.items():
            nd = GPUDevice(d.id, d.memory)
            nd.pod_map = dict(d.pod_map)
            devices[i] = nd
        c.gpu_devices = devices
        c.oversubscription_node = self.oversubscription_node
        c.offline_job_evicting = self.offline_job_evicting
        c.oversubscription_resource = self.oversubscription_resource
        return c

    def pods(self):
        return [t.pod for t in self.tasks.values()]

    # -- GPU share accounting (device_info.go) -----------------------------

    def get_devices_idle_gpu_memory(self) -> Dict[int, float]:
        return {i: d.memory - d.get_pods_used_gpu_memory()
                for i, d in self.gpu_devices.items()}

    def add_gpu_resource(self, pod) -> None:
        if not self.gpu_devices:
            return   # no shareable GPUs: skip the per-container req rebuild
        mem = get_gpu_memory_of_pod(pod)
        if mem <= EPS:
            return
        gpu_id = pod.metadata.annotations.get("volcano.sh/gpu-index")
        if gpu_id is None:
            return
        dev = self.gpu_devices.get(int(gpu_id))
        if dev is not None:
            dev.pod_map[pod.metadata.uid] = mem

    def sub_gpu_resource(self, pod) -> None:
        gpu_id = pod.metadata.annotations.get("volcano.sh/gpu-index")
        if gpu_id is None:
            return
        dev = self.gpu_devices.get(int(gpu_id))
        if dev is not None:
            dev.pod_map.pop(pod.metadata.uid, None)

    def __repr__(self):
        return (f"Node ({self.name}): idle <{self.idle}>, used <{self.used}>, "
                f"releasing <{self.releasing}>, state <{self.state.phase}>")
