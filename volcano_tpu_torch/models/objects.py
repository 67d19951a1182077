"""API objects a scheduling cycle reads (the port's own copy of the core,
scheduling and priority slice of volcano_tpu/models/objects.py).

  * core: ObjectMeta, Pod, Node, PriorityClass, ResourceQuota
  * scheduling: PodGroup, Queue

The controller CRDs (Job, Command, Service, volumes, NUMA topology) are not
part of the scheduling cycle and are not ported. The clone helpers at the
end rebuild only the mutable shells of the hot shapes and share the
substructures a stored object never mutates.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .resource import Resource

# ---------------------------------------------------------------------------
# Annotation / label keys (reference: scheduling/v1beta1 & batch/v1alpha1 consts)
# ---------------------------------------------------------------------------

GROUP_NAME_ANNOTATION = "scheduling.k8s.io/group-name"       # pod -> PodGroup link
TASK_SPEC_KEY = "volcano.sh/task-spec"                       # pod -> task name in Job
JOB_NAME_KEY = "volcano.sh/job-name"
JOB_VERSION_KEY = "volcano.sh/job-version"
QUEUE_NAME_KEY = "volcano.sh/queue-name"
PREEMPTABLE_KEY = "volcano.sh/preemptable"
REVOCABLE_ZONE_KEY = "volcano.sh/revocable-zone"
JDB_MIN_AVAILABLE_KEY = "volcano.sh/jdb-min-available"
JDB_MAX_UNAVAILABLE_KEY = "volcano.sh/jdb-max-unavailable"
SLA_WAITING_TIME_KEY = "sla-waiting-time"
TOPOLOGY_AFFINITY_KEY = "volcano.sh/task-topology-affinity"
TOPOLOGY_ANTI_AFFINITY_KEY = "volcano.sh/task-topology-anti-affinity"
TOPOLOGY_TASK_ORDER_KEY = "volcano.sh/task-topology-task-order"
NUMA_TOPOLOGY_POLICY_KEY = "volcano.sh/numa-topology-policy"
QUEUE_HIERARCHY_ANNOTATION = "volcano.sh/hierarchy"
QUEUE_HIERARCHY_WEIGHT_ANNOTATION = "volcano.sh/hierarchy-weights"
OVERSUBSCRIPTION_NODE_KEY = "volcano.sh/oversubscription"
OVERSUBSCRIPTION_RESOURCE_KEY = "volcano.sh/oversubscription-resource"
OFFLINE_JOB_EVICTING_KEY = "volcano.sh/offline-job-evicting"
REVOCABLE_ZONE_LABEL = "volcano.sh/revocable-zone"

DEFAULT_SCHEDULER_NAME = "volcano"
DEFAULT_QUEUE = "default"

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "obj") -> str:
    return f"{prefix}-{next(_uid_counter):08d}"


# ---------------------------------------------------------------------------
# core/v1 slice
# ---------------------------------------------------------------------------

@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0
    resource_version: int = 0
    deletion_timestamp: Optional[float] = None
    owner: Optional[str] = None  # "kind/namespace/name" of the controller owner

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"      # Equal | Exists
    value: str = ""
    effect: str = ""             # "" matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"   # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class NodeSelectorRequirement:
    key: str = ""
    operator: str = "In"         # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        has = self.key in labels
        val = labels.get(self.key)
        if self.operator == "In":
            return has and val in self.values
        if self.operator == "NotIn":
            # k8s label-selector semantics: absent keys satisfy NotIn
            return (not has) or val not in self.values
        if self.operator == "Exists":
            return has
        if self.operator == "DoesNotExist":
            return not has
        if self.operator == "Gt":
            try:
                return has and float(val) > float(self.values[0])
            except (ValueError, IndexError):
                return False
        if self.operator == "Lt":
            try:
                return has and float(val) < float(self.values[0])
            except (ValueError, IndexError):
                return False
        return False


@dataclass
class NodeSelectorTerm:
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        return all(e.matches(labels) for e in self.match_expressions)


@dataclass
class PreferredSchedulingTerm:
    weight: int = 1
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class NodeAffinity:
    required: List[NodeSelectorTerm] = field(default_factory=list)      # OR of terms
    preferred: List[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class PodAffinityTerm:
    label_selector: List[NodeSelectorRequirement] = field(default_factory=list)
    topology_key: str = "kubernetes.io/hostname"
    namespaces: List[str] = field(default_factory=list)


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 1
    term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class PodAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAffinity] = None


@dataclass
class TopologySpreadConstraint:
    """PodTopologySpread slice (k8s topologySpreadConstraints): spread the
    selected pods across the values of a node topology label, bounding the
    count difference between the most- and least-loaded topology by
    ``max_skew``. An empty ``label_selector`` selects the pod's OWN job
    siblings (the volcano gang case — the scheduler fills it from the
    job's pods)."""
    max_skew: int = 1
    topology_key: str = "topology.kubernetes.io/zone"
    # DoNotSchedule (hard, lowered into the kernel mask) |
    # ScheduleAnyway (soft, lowered into the additive score)
    when_unsatisfiable: str = "DoNotSchedule"
    label_selector: List[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class Container:
    name: str = "main"
    image: str = ""
    requests: Dict[str, Any] = field(default_factory=dict)   # resource list
    limits: Dict[str, Any] = field(default_factory=dict)
    ports: List[int] = field(default_factory=list)
    command: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    volume_mounts: List[Dict[str, str]] = field(default_factory=list)


@dataclass
class PodSpec:
    """Pod spec slice.

    Immutability contract (matches k8s: a pod's spec is immutable after
    creation except the binding): once a pod has been stored,
    ``containers``/``init_containers``/``affinity``/``volumes`` are never
    mutated in place — the job controller and its svc/ssh/env plugins edit
    them only on freshly built pods BEFORE ``store.create``. Clones share
    these substructures (see the specialized cloner below).
    ``node_selector``/``tolerations`` ARE extended in place by pod admission
    mutators (webhooks/pods.py), so clones copy those containers (the
    Toleration elements themselves are immutable and shared)."""

    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    # immutable-after-store like affinity (clones share the list)
    topology_spread: List[TopologySpreadConstraint] = field(
        default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    priority: Optional[int] = None
    priority_class_name: str = ""
    restart_policy: str = "OnFailure"
    host_ports: List[int] = field(default_factory=list)
    volumes: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class PodStatus:
    phase: str = "Pending"   # Pending | Running | Succeeded | Failed | Unknown
    reason: str = ""
    message: str = ""
    host_ip: str = ""
    exit_code: Optional[int] = None  # terminated main-container exit code


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    def resource_request(self) -> Resource:
        """Aggregate container requests; init containers contribute their max
        per dimension (k8s pod resource semantics used by NewTaskInfo,
        reference: pkg/scheduler/api/pod_info.go GetPodResourceRequest).

        Memoized on the pod and treated as immutable: containers never
        change after storage (PodSpec contract), every TaskInfo rebuild of
        the same pod — ingest, bind echo, resync — re-parses the same
        quantities, and the parse dominated the 50k-bind watch-echo path.
        Clones share the cached Resource."""
        rr = self.__dict__.get("_rr")
        if rr is None:
            rr = Resource()
            for c in self.spec.containers:
                rr.add(Resource.from_resource_list(c.requests))
            for c in self.spec.init_containers:
                rr.set_max_resource(Resource.from_resource_list(c.requests))
            self.__dict__["_rr"] = rr
        return rr


@dataclass
class NodeStatus:
    allocatable: Dict[str, Any] = field(default_factory=dict)
    capacity: Dict[str, Any] = field(default_factory=dict)
    ready: bool = True


@dataclass
class NodeSpec:
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)


@dataclass
class PriorityClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    preemption_policy: str = "PreemptLowerPriority"


@dataclass
class ResourceQuota:
    """Consumed only for namespace weight (reference: namespace_info.go)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    hard: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# scheduling group: PodGroup & Queue
# ---------------------------------------------------------------------------

class PodGroupPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    UNKNOWN = "Unknown"
    INQUEUE = "Inqueue"
    COMPLETED = "Completed"


class PodGroupConditionType:
    UNSCHEDULABLE = "Unschedulable"
    SCHEDULED = "Scheduled"


NOT_ENOUGH_RESOURCES_REASON = "NotEnoughResources"
NOT_ENOUGH_PODS_REASON = "NotEnoughTasks"
POD_GROUP_READY = "tasks in gang are ready to be scheduled"
POD_GROUP_NOT_READY = "pod group is not ready"


@dataclass
class PodGroupCondition:
    type: str = ""
    status: str = "True"
    transition_id: str = ""
    last_transition_time: float = 0.0
    reason: str = ""
    message: str = ""


@dataclass
class PodGroupSpec:
    min_member: int = 0
    min_task_member: Dict[str, int] = field(default_factory=dict)
    queue: str = DEFAULT_QUEUE
    priority_class_name: str = ""
    min_resources: Optional[Dict[str, Any]] = None


@dataclass
class PodGroupStatus:
    phase: str = PodGroupPhase.PENDING
    conditions: List[PodGroupCondition] = field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclass
class PodGroup:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)


class QueueState:
    OPEN = "Open"
    CLOSED = "Closed"
    CLOSING = "Closing"
    UNKNOWN = "Unknown"


@dataclass
class QueueSpec:
    weight: int = 1
    capability: Optional[Dict[str, Any]] = None
    reclaimable: bool = True
    guarantee: Optional[Dict[str, Any]] = None
    extend_clusters: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class QueueStatus:
    state: str = QueueState.OPEN
    unknown: int = 0
    pending: int = 0
    running: int = 0
    inqueue: int = 0


@dataclass
class Queue:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: QueueSpec = field(default_factory=QueueSpec)
    status: QueueStatus = field(default_factory=QueueStatus)


# ---------------------------------------------------------------------------
# specialized fast_clone cloners for the hot shapes
# ---------------------------------------------------------------------------
# A 50k-bind flush clones every pod several times (store patch + per-watcher
# echo copies); the generic per-attribute recursion over the ~40-object pod
# tree dominated it. These cloners rebuild only the mutable shell and share
# the substructures PodSpec's docstring declares immutable-after-store.

from ..utils.fastclone import register_cloner  # noqa: E402


def _clone_object_meta(m: "ObjectMeta") -> "ObjectMeta":
    new = object.__new__(ObjectMeta)
    d = new.__dict__
    s = m.__dict__
    d.update(s)                        # scalars (str/int/float/None)
    d["labels"] = dict(s["labels"])    # str -> str: shallow copy is exact
    d["annotations"] = dict(s["annotations"])
    return new


def _clone_pod_status(st: "PodStatus") -> "PodStatus":
    new = object.__new__(PodStatus)
    new.__dict__.update(st.__dict__)   # all scalars
    return new


def _clone_pod_spec(sp: "PodSpec") -> "PodSpec":
    new = object.__new__(PodSpec)
    d = new.__dict__
    d.update(sp.__dict__)   # scalars + immutable-after-store subtrees
    #                         (containers/init_containers/affinity/volumes)
    # admission mutators extend these in place on inbound objects, so the
    # containers are copied; the elements are immutable and shared
    d["node_selector"] = dict(sp.node_selector)
    d["tolerations"] = list(sp.tolerations)
    d["host_ports"] = list(sp.host_ports)
    return new


def _clone_pod(p: "Pod") -> "Pod":
    new = object.__new__(Pod)
    d = new.__dict__
    s = p.__dict__
    d["metadata"] = _clone_object_meta(s["metadata"])
    d["spec"] = _clone_pod_spec(s["spec"])
    d["status"] = _clone_pod_status(s["status"])
    rr = s.get("_rr")
    if rr is not None:
        d["_rr"] = rr                  # immutable parse cache: share
    sig = s.get("_sched_group_sig")
    if sig is not None:
        d["_sched_group_sig"] = sig    # encode-group intern id: share
    return new


def clone_pod_for_bind(p: "Pod") -> "Pod":
    """Minimal pod clone for the store's bind patch: only the mutated
    shells (metadata for the resource_version bump, spec for node_name)
    are fresh; labels/annotations/status and every spec subtree are
    SHARED with the stored object. Safe because stored objects are never
    mutated in place (store reads hand out copies; admission mutates
    inbound objects pre-store) — the 50k-bind flush pays two dict.update
    calls per pod instead of a structured deep clone."""
    new = object.__new__(Pod)
    d = new.__dict__
    s = p.__dict__
    m = object.__new__(ObjectMeta)
    m.__dict__.update(s["metadata"].__dict__)   # labels/annotations shared
    d["metadata"] = m
    sp = object.__new__(PodSpec)
    sp.__dict__.update(s["spec"].__dict__)      # subtrees shared
    d["spec"] = sp
    d["status"] = s["status"]                   # shared (bind leaves it)
    rr = s.get("_rr")
    if rr is not None:
        d["_rr"] = rr
    sig = s.get("_sched_group_sig")
    if sig is not None:
        d["_sched_group_sig"] = sig
    return new


def clone_pod_group_for_status(pg: "PodGroup") -> "PodGroup":
    """Minimal podgroup clone for the store's bulk STATUS push: a fresh
    metadata shell (resource_version bump) with the spec SHARED — stored
    objects are never mutated in place, and sharing lets watchers detect
    the status-only echo by spec identity (cache.update_pod_groups_bulk).
    The status is installed by the patch fn, so the clone's own status is
    irrelevant (shared here)."""
    new = object.__new__(PodGroup)
    d = new.__dict__
    s = pg.__dict__
    m = object.__new__(ObjectMeta)
    m.__dict__.update(s["metadata"].__dict__)
    d["metadata"] = m
    d["spec"] = s["spec"]
    d["status"] = s["status"]
    return new


def _clone_pod_group_status(st: "PodGroupStatus") -> "PodGroupStatus":
    new = object.__new__(PodGroupStatus)
    d = new.__dict__
    d.update(st.__dict__)              # phase + counters (scalars)
    # condition entries are replaced/appended, never mutated in place
    # (framework.update_pod_group_condition rebinds conditions[i]), so the
    # elements are shared and only the list is copied
    d["conditions"] = list(st.conditions)
    return new


def _clone_pod_group_spec(sp: "PodGroupSpec") -> "PodGroupSpec":
    # a flat copy (the job controller mutates a gotten pg's spec in place
    # before update, so specs are NOT shareable across clones): scalars +
    # two shallow dict copies with scalar values
    new = object.__new__(PodGroupSpec)
    d = new.__dict__
    d.update(sp.__dict__)
    d["min_task_member"] = dict(sp.min_task_member)
    if sp.min_resources is not None:
        d["min_resources"] = dict(sp.min_resources)
    return new


def _clone_pod_group(pg: "PodGroup") -> "PodGroup":
    """PodGroup clones run once per status-writing job per cycle (the
    copy-on-write claim in JobInfo.own_pod_group) and once per job per
    snapshot echo: rebuild the three shells without generic recursion."""
    new = object.__new__(PodGroup)
    d = new.__dict__
    d["metadata"] = _clone_object_meta(pg.metadata)
    d["spec"] = _clone_pod_group_spec(pg.spec)
    d["status"] = _clone_pod_group_status(pg.status)
    return new


register_cloner(ObjectMeta, _clone_object_meta)
register_cloner(PodStatus, _clone_pod_status)
register_cloner(PodSpec, _clone_pod_spec)
register_cloner(Pod, _clone_pod)
register_cloner(PodGroupStatus, _clone_pod_group_status)
register_cloner(PodGroupSpec, _clone_pod_group_spec)
register_cloner(PodGroup, _clone_pod_group)


def status_fingerprint(status: "PodGroupStatus") -> tuple:
    """Cheap immutable fingerprint of a PodGroup status, used for the
    session-close writeback dedup (framework.JobUpdater): taken at
    session open and compared with the status at close."""
    return (status.phase, status.running, status.succeeded, status.failed,
            tuple((c.type, c.status, c.reason, c.message,
                   c.last_transition_time) for c in status.conditions))
