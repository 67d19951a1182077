"""Dense structure-of-arrays snapshot encoding for the placement kernel
(the port's own copy of volcano_tpu/models/arrays.py).

The per-cycle state is encoded once into padded, statically-shaped numpy
arrays; the solver turns them into tensors on its device.

* **Resource index**: the cycle's resource dimensions [cpu, memory,
  *scalars] with per-dimension scale (memory is encoded in MiB to keep
  float32 exact) and the reference's 0.1 epsilon scaled alongside.
* **Task groups**: tasks sharing (job, task-spec, resreq, scheduling
  constraints) collapse into one group; predicates and static scores are
  evaluated per group x node, tasks index into their group. The group
  signature intern table is this module's own.
* **Feature matrices**: node labels/taints referenced by any group become
  0/1 matrices so selector/toleration matching is a matmul.
* **Padding/bucketing**: node/task/group counts are padded to buckets, with
  validity masks.

* **Topology domains**: the constraint compiler (ops/constraints.py)
  lowers a task's assigned spread / anti-affinity domains either as
  derived group sigs whose domains ride the selector feature pairs
  (``derived_sig``, ``sig_override``, ``slot_entries``), or as the
  kernel's per-task ``task_slot``/``slot_rows`` inputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import threading

import numpy as np

from .job_info import JobInfo, TaskInfo
from .node_info import NodeInfo
from .resource import CPU, EPS, MEMORY, Resource

MIB = float(2**20)

# scales: millicores stay, bytes -> MiB, scalar milli-units stay
def _scale_for(name: str) -> float:
    return 1.0 / MIB if name == MEMORY else 1.0


def bucket(n: int, size: int) -> int:
    """Round up to a bucket boundary (>= 1 bucket) for stable shapes."""
    return max(size, ((n + size - 1) // size) * size)


class ResourceIndex:
    """The cycle's resource-dimension registry."""

    def __init__(self, names: Sequence[str]):
        ordered = [CPU, MEMORY] + sorted(n for n in names if n not in (CPU, MEMORY))
        self.names: Tuple[str, ...] = tuple(ordered)
        self.index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}
        self.scales = np.array([_scale_for(n) for n in self.names], np.float32)
        self.eps = (EPS * self.scales).astype(np.float32)

    @property
    def r(self) -> int:
        return len(self.names)

    @classmethod
    def from_cluster(cls, nodes: Dict[str, NodeInfo],
                     jobs: Dict[str, JobInfo]) -> "ResourceIndex":
        names = set()
        for n in nodes.values():
            names.update(n.allocatable.scalars.keys())
        for j in jobs.values():
            names.update(j.total_request.scalars.keys())
        return cls(names)

    def vec(self, r: Resource) -> np.ndarray:
        v = np.zeros(self.r, np.float32)
        v[0] = r.milli_cpu
        v[1] = r.memory
        for name, quant in r.scalars.items():
            i = self.index.get(name)
            if i is not None:
                v[i] = quant
        return v * self.scales

    def resource(self, v: np.ndarray) -> Resource:
        """Inverse of :meth:`vec`: a Resource from a scaled row."""
        unscaled = np.asarray(v, np.float64) / self.scales
        r = Resource(milli_cpu=float(unscaled[0]), memory=float(unscaled[1]))
        for i in range(2, self.r):
            if unscaled[i]:
                r.set_scalar(self.names[i], float(unscaled[i]))
        return r

    def vec_capability(self, r: Resource) -> np.ndarray:
        """Capability-style vector: dimensions the resource does not mention
        are unbounded (the Infinity dimension default, resource_info.go:43)."""
        v = np.full(self.r, np.inf, np.float32)
        if r.milli_cpu > 0:
            v[0] = r.milli_cpu * self.scales[0]
        if r.memory > 0:
            v[1] = r.memory * self.scales[1]
        for name, quant in r.scalars.items():
            i = self.index.get(name)
            if i is not None:
                v[i] = quant * self.scales[i]
        return v


NODE_BUCKET = 256
TASK_BUCKET = 256
GROUP_BUCKET = 16


@dataclass
class NodeArrays:
    """Per-node resource state, padded to N_pad (valid mask marks real rows)."""

    rindex: ResourceIndex
    names: List[str]                 # real node names, index-aligned
    name_to_idx: Dict[str, int]
    n_pad: int
    valid: np.ndarray                # [N] bool
    idle: np.ndarray                 # [N, R] f32
    used: np.ndarray
    releasing: np.ndarray
    pipelined: np.ndarray
    allocatable: np.ndarray
    capability: np.ndarray
    max_tasks: np.ndarray            # [N] i32 (pods capacity; 0 => unlimited)
    n_tasks: np.ndarray              # [N] i32 current task count
    revocable: np.ndarray            # [N] bool
    oversubscription: np.ndarray     # [N] bool

    @classmethod
    def build(cls, nodes: Dict[str, NodeInfo], node_order: Sequence[str],
              rindex: Optional[ResourceIndex] = None,
              node_bucket: int = NODE_BUCKET) -> "NodeArrays":
        names = [n for n in node_order if n in nodes]
        if rindex is None:
            rindex = ResourceIndex.from_cluster(nodes, {})
        n_pad = bucket(len(names), node_bucket)
        r = rindex.r
        z = lambda: np.zeros((n_pad, r), np.float32)
        arr = cls(rindex=rindex, names=names,
                  name_to_idx={n: i for i, n in enumerate(names)},
                  n_pad=n_pad, valid=np.zeros(n_pad, bool),
                  idle=z(), used=z(), releasing=z(), pipelined=z(),
                  allocatable=z(), capability=z(),
                  max_tasks=np.zeros(n_pad, np.int32),
                  n_tasks=np.zeros(n_pad, np.int32),
                  revocable=np.zeros(n_pad, bool),
                  oversubscription=np.zeros(n_pad, bool))
        views = (arr.idle, arr.used, arr.releasing, arr.pipelined,
                 arr.allocatable, arr.capability)
        index = rindex.index
        n = len(names)
        infos = [nodes[name] for name in names]
        arr.valid[:n] = True
        if r == 2:
            # no scalar dimensions anywhere: column-wise fromiter fills
            # (the per-node row loop cost ~4 us x 10k nodes per build)
            for view, attr in zip(views, ("idle", "used", "releasing",
                                          "pipelined", "allocatable",
                                          "capability")):
                view[:n, 0] = np.fromiter(
                    (getattr(ni, attr).milli_cpu for ni in infos),
                    np.float32, n)
                view[:n, 1] = np.fromiter(
                    (getattr(ni, attr).memory for ni in infos),
                    np.float32, n)
        else:
            for i, ni in enumerate(infos):
                # direct field writes instead of rindex.vec() (6 temp-array
                # allocations per node dominated the encode at 10k nodes);
                # scaling applied once per block below
                for view, res in zip(views, (ni.idle, ni.used, ni.releasing,
                                             ni.pipelined, ni.allocatable,
                                             ni.capability)):
                    row = view[i]
                    row[0] = res.milli_cpu
                    row[1] = res.memory
                    if res.scalars:
                        for sname, quant in res.scalars.items():
                            si = index.get(sname)
                            if si is not None:
                                row[si] = quant
        arr.max_tasks[:n] = np.fromiter(
            (ni.allocatable.max_task_num for ni in infos), np.int32, n)
        arr.n_tasks[:n] = np.fromiter(
            (len(ni.tasks) for ni in infos), np.int32, n)
        arr.revocable[:n] = np.fromiter(
            (bool(ni.revocable_zone) for ni in infos), bool, n)
        arr.oversubscription[:n] = np.fromiter(
            (ni.oversubscription_node for ni in infos), bool, n)
        for view in views:
            view *= rindex.scales[None, :]
        return arr

    def update_rows(self, nodes: Dict[str, NodeInfo], names) -> List[int]:
        """Re-encode the rows of ``names`` in place from the live
        NodeInfos, with :meth:`build`'s field semantics: the incremental
        cycle (docs/design/incremental_cycle.md) keeps one NodeArrays
        across cycles and re-encodes only the dirty rows. Names outside
        the encoded order are skipped (a membership or order change is
        the caller's to rebuild). Returns the updated row indices."""
        views = ("idle", "used", "releasing", "pipelined", "allocatable",
                 "capability")
        index = self.rindex.index
        scales = self.rindex.scales
        rows: List[int] = []
        for name in names:
            i = self.name_to_idx.get(name)
            ni = nodes.get(name)
            if i is None or ni is None:
                continue
            rows.append(i)
            for attr in views:
                res = getattr(ni, attr)
                row = getattr(self, attr)[i]
                row[:] = 0.0
                row[0] = res.milli_cpu
                row[1] = res.memory
                if res.scalars:
                    for sname, quant in res.scalars.items():
                        si = index.get(sname)
                        if si is not None:
                            row[si] = quant
                row *= scales
            self.max_tasks[i] = ni.allocatable.max_task_num
            self.n_tasks[i] = len(ni.tasks)
            self.revocable[i] = bool(ni.revocable_zone)
            self.oversubscription[i] = ni.oversubscription_node
        return rows

    @property
    def future_idle(self) -> np.ndarray:
        return self.idle + self.releasing - self.pipelined

_SIG_INTERN: Dict[tuple, int] = {}
_SIG_LOCK = threading.Lock()
_SIG_NEXT = 0                      # monotone: ids are never reused
_SIG_INTERN_MAX = 1_000_000        # keys (incl. affinity reprs) are dropped
#                                    past this; a re-interned key gets a NEW
#                                    id, which can only split a group (safe),
#                                    never merge two distinct ones


def _group_sig(t: TaskInfo) -> int:
    """Small-int intern of (task template, request, constraints): the
    group identity of a task within its job, so the 50k-task encode loop
    hashes two ints per task instead of a nested tuple-of-tuples.

    Cached on the *Pod* object (not just the TaskInfo): session tasks are
    fresh clones every cycle, but they share the cache's pod until an
    update replaces it — exactly the lifetime over which all three key
    parts are immutable. The TaskInfo-level cache then short-circuits
    repeat encodes within one session (preempt/reclaim contexts)."""
    sig = t.group_sig_cache
    if sig is None:
        pod = t.pod
        sig = pod.__dict__.get("_sched_group_sig")
        if sig is None:
            global _SIG_NEXT
            key = (t.task_id, _req_key(t), _constraint_key(t))
            with _SIG_LOCK:
                sig = _SIG_INTERN.get(key)
                if sig is None:
                    if len(_SIG_INTERN) >= _SIG_INTERN_MAX:
                        _SIG_INTERN.clear()   # bound memory; ids stay unique
                    sig = _SIG_NEXT
                    _SIG_NEXT += 1
                    _SIG_INTERN[key] = sig
            pod._sched_group_sig = sig
        t.group_sig_cache = sig
    return sig


def _constraint_key(t: TaskInfo) -> tuple:
    """Scheduling-constraint fingerprint for grouping: tasks with identical
    constraints share predicate masks. Cached on the TaskInfo (constraints
    are immutable for a pod's lifetime; the repr() of affinity trees is the
    expensive part at 50k tasks)."""
    cached = t.constraint_key_cache
    if cached is not None:
        return cached
    spec = t.pod.spec
    if not spec.node_selector and not spec.tolerations \
            and spec.affinity is None and not spec.topology_spread:
        key = _TRIVIAL_CONSTRAINT          # the overwhelmingly common shape
    else:
        sel = tuple(sorted(spec.node_selector.items()))
        tol = tuple(sorted((x.key, x.operator, x.value, x.effect)
                           for x in spec.tolerations))
        aff = repr(spec.affinity) if spec.affinity is not None else ""
        spread = tuple((c.topology_key, c.max_skew, c.when_unsatisfiable,
                        repr(c.label_selector))
                       for c in spec.topology_spread)
        key = (sel, tol, aff, spread)
    t.constraint_key_cache = key
    return key


_TRIVIAL_CONSTRAINT = ((), (), "", ())


def derived_sig(base_sig: int, tag) -> int:
    """A stable intern id for a DERIVED group identity: the constraint
    compiler splits a spread-constrained task group into per-topology-slot
    subgroups (ops/constraints.py), and the subgroup sig must live in the
    same id space as :func:`_group_sig` without ever colliding with a
    pod-level sig. Same intern table, key namespaced by a marker."""
    global _SIG_NEXT
    key = ("__derived__", base_sig, tag)
    with _SIG_LOCK:
        sig = _SIG_INTERN.get(key)
        if sig is None:
            if len(_SIG_INTERN) >= _SIG_INTERN_MAX:
                _SIG_INTERN.clear()
            sig = _SIG_NEXT
            _SIG_NEXT += 1
            _SIG_INTERN[key] = sig
    return sig


def _req_key(t: TaskInfo) -> tuple:
    cached = t.req_key_cache
    if cached is not None:
        return cached
    r = t.resreq
    if r.scalars:
        key = (r.milli_cpu, r.memory, tuple(sorted(r.scalars.items())))
    else:
        key = (r.milli_cpu, r.memory)
    t.req_key_cache = key
    return key


@dataclass
class TaskBatch:
    """An ordered batch of pending tasks to place, with group compression.

    Jobs are regrouped so that each (namespace, queue) POOL's jobs form one
    contiguous span. Namespace indices follow first appearance (the caller
    feeds jobs namespace-sorted by the session's NamespaceOrderFn, so the
    static index order IS the session-open namespace order); queue indices
    follow first appearance across the batch. The kernel *dynamically*
    re-selects the namespace, then the queue, at every job boundary
    (allocate.go:120-162), so the encode order only decides ties.
    """

    rindex: ResourceIndex
    tasks: List[TaskInfo]            # real tasks, scan order
    t_pad: int
    g_pad: int
    j_pad: int
    q_pad: int
    task_valid: np.ndarray           # [T] bool
    task_group: np.ndarray           # [T] i32
    task_job: np.ndarray             # [T] i32
    group_req: np.ndarray            # [G, R] f32
    group_first: np.ndarray          # [G_real] i32 first task per group
    group_inverse: np.ndarray        # [T_real] group of each task
    job_uids: List[str]
    job_min_available: np.ndarray    # [J] i32 (padding rows incl. sentinel: 0)
    job_ready_base: np.ndarray       # [J] i32 already-occupied task count
    job_task_start: np.ndarray       # [J] i32 span starts in scan order
    job_task_end: np.ndarray         # [J] i32
    job_queue: np.ndarray            # [J] i32 queue index (padding: 0)
    queue_names: List[str]           # first-appearance queue order
    ns_names: List[str]              # first-appearance namespace order
    pool_queue: np.ndarray           # [P] i32 queue of each (ns, queue) pool
    pool_ns: np.ndarray              # [P] i32 namespace of each pool
    pool_job_start: np.ndarray       # [P] i32 jobs grouped by pool
    pool_njobs: np.ndarray           # [P] i32
    # per-task topology-domain restriction (ops/constraints.py
    # build_slot_tensors, set after the build by the solver's context
    # build): task_slot[t] indexes a slot_rows row; row S is all-true and
    # unconstrained tasks carry S. None = no batch task carries a slot.
    task_slot: Optional[np.ndarray] = None       # [T] i32
    slot_rows: Optional[np.ndarray] = None       # [S+1, n_pad] bool

    @property
    def job_n_tasks(self) -> np.ndarray:
        return self.job_task_end - self.job_task_start

    @classmethod
    def build(cls, ordered_jobs: Sequence[Tuple[JobInfo, Sequence[TaskInfo]]],
              rindex: ResourceIndex,
              task_bucket: int = TASK_BUCKET,
              group_bucket: int = GROUP_BUCKET,
              sig_override: Optional[Dict[str, int]] = None) -> "TaskBatch":
        # regroup jobs by (namespace, queue) pool, stable: namespace and
        # queue order = first appearance; zero-task jobs are excluded (each
        # job consumes scan steps equal to its task count, so empty jobs
        # would starve the T-step budget — the caller resolves their
        # readiness from existing occupancy instead)
        queue_names: List[str] = []
        queue_idx: Dict[str, int] = {}
        ns_names: List[str] = []
        ns_idx: Dict[str, int] = {}
        pool_order: List[Tuple[int, int]] = []     # (ns, queue) per pool
        by_pool: Dict[Tuple[int, int], list] = {}
        for job, jtasks in ordered_jobs:
            if not jtasks:
                continue
            qname = getattr(job, "queue", "") or ""
            if qname not in queue_idx:
                queue_idx[qname] = len(queue_names)
                queue_names.append(qname)
            nsname = getattr(job, "namespace", "") or ""
            if nsname not in ns_idx:
                ns_idx[nsname] = len(ns_names)
                ns_names.append(nsname)
            key = (ns_idx[nsname], queue_idx[qname])
            if key not in by_pool:
                by_pool[key] = []
                pool_order.append(key)
            by_pool[key].append((job, jtasks))

        tasks: List[TaskInfo] = []
        task_sig: List[int] = []
        task_job: List[int] = []
        job_uids: List[str] = []
        job_min: List[int] = []
        job_base: List[int] = []
        job_start: List[int] = []
        job_end: List[int] = []
        job_queue: List[int] = []
        pool_queue: List[int] = []
        pool_ns: List[int] = []
        pool_job_start: List[int] = []
        pool_njobs: List[int] = []

        for key in pool_order:
            ns_i, q_idx = key
            pool_ns.append(ns_i)
            pool_queue.append(q_idx)
            pool_job_start.append(len(job_uids))
            pool_njobs.append(len(by_pool[key]))
            for job, jtasks in by_pool[key]:
                j_idx = len(job_uids)
                job_uids.append(job.uid)
                job_min.append(job.min_available)
                job_base.append(job.ready_task_num())
                job_start.append(len(tasks))
                job_queue.append(q_idx)
                tasks.extend(jtasks)
                if sig_override:
                    # per-cycle derived sigs (spread slots) win over the
                    # pod-level identity
                    task_sig.extend(
                        ov if (ov := sig_override.get(t.uid)) is not None
                        else (t.group_sig_cache if t.group_sig_cache
                              is not None else _group_sig(t))
                        for t in jtasks)
                else:
                    task_sig.extend(t.group_sig_cache if t.group_sig_cache
                                    is not None else _group_sig(t)
                                    for t in jtasks)
                task_job.extend([j_idx] * len(jtasks))
                job_end.append(len(tasks))

        # group assignment, vectorized: pack (job, sig) into one int64 and
        # unique it. Group ids come out key-sorted (job-major) instead of
        # first-appearance — opaque to every consumer (they index rows).
        if tasks:
            sig_arr = np.asarray(task_sig, np.int64)
            if sig_arr.size and int(sig_arr.max()) >= (1 << 32):
                # the monotone intern ids passed 2^32 (years of churn):
                # densify this batch's sigs to 0..K-1 (K <= T) so the
                # 32-bit pack stays collision-free and exact
                _, sig_arr = np.unique(sig_arr, return_inverse=True)
                sig_arr = sig_arr.astype(np.int64)
            packed = (np.asarray(task_job, np.int64) << 32) | sig_arr
            uniq_keys, first_idx, inverse = np.unique(
                packed, return_index=True, return_inverse=True)
            task_group = inverse.astype(np.int32)
            reps = [tasks[i] for i in first_idx]
            if all(not r.resreq.scalars for r in reps):
                # no scalar dims: column-wise fill beats one rindex.vec
                # (6 temp arrays) per group — 6k groups per burst encode
                n_g = len(reps)
                group_reqs_arr = np.zeros((n_g, rindex.r), np.float32)
                group_reqs_arr[:, 0] = np.fromiter(
                    (r.resreq.milli_cpu for r in reps), np.float64, n_g)
                group_reqs_arr[:, 1] = np.fromiter(
                    (r.resreq.memory for r in reps), np.float64, n_g)
                group_reqs_arr *= rindex.scales[None, :]
                group_reqs = group_reqs_arr
            else:
                group_reqs = [rindex.vec(t.resreq) for t in reps]
            group_first = first_idx.astype(np.int32)
            group_inverse = inverse
        else:
            task_group = np.zeros(0, np.int32)
            group_reqs = []
            group_first = np.zeros(0, np.int32)
            group_inverse = np.zeros(0, np.int64)

        t_pad = bucket(len(tasks), task_bucket)
        g_pad = bucket(max(1, len(group_reqs)), group_bucket)
        # one spare sentinel job absorbs padding tasks: it is never selected
        # (it belongs to no pool span) and its ready/kept stay False
        sentinel = len(job_uids)
        j_pad = bucket(len(job_uids) + 1, group_bucket)
        q_pad = bucket(max(1, len(queue_names)), 8)
        p_pad = bucket(max(1, len(pool_queue)), 8)
        r = rindex.r

        def pad1(a, n, dtype, fill=0):
            out = np.full(n, fill, dtype)
            if len(a):
                out[:len(a)] = a
            return out

        greq = np.zeros((g_pad, r), np.float32)
        if len(group_reqs):
            if isinstance(group_reqs, np.ndarray):
                greq[:len(group_reqs)] = group_reqs
            else:
                greq[:len(group_reqs)] = np.stack(group_reqs)

        return cls(
            rindex=rindex, tasks=tasks, t_pad=t_pad, g_pad=g_pad, j_pad=j_pad,
            q_pad=q_pad,
            task_valid=pad1(np.ones(len(tasks), bool), t_pad, bool),
            task_group=pad1(task_group, t_pad, np.int32),
            task_job=pad1(task_job, t_pad, np.int32, fill=sentinel),
            group_req=greq,
            group_first=group_first,
            group_inverse=group_inverse,
            job_uids=job_uids,
            job_min_available=pad1(job_min, j_pad, np.int32),
            job_ready_base=pad1(job_base, j_pad, np.int32),
            job_task_start=pad1(job_start, j_pad, np.int32),
            job_task_end=pad1(job_end, j_pad, np.int32),
            job_queue=pad1(job_queue, j_pad, np.int32),
            queue_names=queue_names,
            ns_names=ns_names,
            pool_queue=pad1(pool_queue, p_pad, np.int32),
            pool_ns=pad1(pool_ns, p_pad, np.int32),
            pool_job_start=pad1(pool_job_start, p_pad, np.int32),
            pool_njobs=pad1(pool_njobs, p_pad, np.int32),
        )

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    @property
    def n_groups(self) -> int:
        return len(self.group_first)

    @property
    def group_members(self) -> List[List[int]]:
        """group -> member task indices, materialized on first use (most
        cycles only ever need a group's REPRESENTATIVE, group_first; the
        6k-list materialization cost real encode time per burst)."""
        cached = self.__dict__.get("_group_members")
        if cached is None:
            if len(self.group_inverse):
                order = np.argsort(self.group_inverse, kind="stable")
                counts = np.bincount(self.group_inverse,
                                     minlength=len(self.group_first))
                bounds = np.cumsum(counts)[:-1]
                cached = [m.tolist() for m in np.split(order, bounds)]
            else:
                cached = []
            self.__dict__["_group_members"] = cached
        return cached


# ---------------------------------------------------------------------------
# Feature matrices: label/taint/affinity matching as integer matmuls
# ---------------------------------------------------------------------------

@dataclass
class PredicateFeatures:
    """Boolean feature matrices for the predicate kernels.

    * ``node_pairs`` [N, F]: node has label pair f (pair = referenced
      (key,value) from any group's selector / required node affinity)
    * ``group_requires`` [G, F]: group's conjunctive required pairs
    * ``group_require_counts`` [G]: number of required pairs per group
    * ``node_taints`` [N, K]: node carries (NoSchedule|NoExecute) taint k
    * ``group_tolerates`` [G, K]: group tolerates taint k
    * ``group_affinity_ok`` [G, N]: OR-of-terms node affinity evaluated for
      expression forms beyond In-pairs (Exists/Gt/Lt/NotIn), host-encoded;
      ``None`` when no group carries required node affinity (a [G, N]
      all-ones matrix is ~64MB at 50k x 10k)
    """

    node_pairs: np.ndarray
    group_requires: np.ndarray
    group_require_counts: np.ndarray
    node_taints: np.ndarray
    group_tolerates: np.ndarray
    group_affinity_ok: Optional[np.ndarray]

    @classmethod
    def build(cls, nodes: Dict[str, NodeInfo], node_arrays: NodeArrays,
              batch: TaskBatch,
              slot_entries: Optional[Dict[str, tuple]] = None
              ) -> "PredicateFeatures":
        """``slot_entries`` ({task uid: ((key, values, hard), ...)}) are
        the constraint compiler's spread/anti-affinity domain
        assignments (ops/constraints.py): each lowers to a required
        (key, value) label pair (or, for an unsatisfiable empty
        assignment, a sentinel pair no node carries), so topology
        constraints ride the same selector matmul as node selectors."""
        n_pad = node_arrays.n_pad
        g_pad = batch.g_pad
        # one representative task per group (tasks group on identical
        # constraints, so the rep carries them for the whole group;
        # derived slot groups key on the entries, so the rep's slot
        # assignment is the whole group's)
        reps = [batch.tasks[i] for i in batch.group_first]

        # taints (NoSchedule/NoExecute block scheduling): node-side, needed
        # regardless of task constraints — an untolerated taint must mask
        # its node even for constraint-free pods
        taint_ids: Dict[tuple, int] = {}
        node_taint_list: List[List[int]] = [[] for _ in range(n_pad)]
        for name, i in node_arrays.name_to_idx.items():
            node = nodes[name].node
            for taint in (node.spec.taints if node else []):
                if taint.effect in ("NoSchedule", "NoExecute"):
                    tid = taint_ids.setdefault(
                        (taint.key, taint.value, taint.effect),
                        len(taint_ids))
                    node_taint_list[i].append(tid)
        k_pad = bucket(max(1, len(taint_ids)), 8)
        node_taints = np.zeros((n_pad, k_pad), np.float32)
        for i, tids in enumerate(node_taint_list):
            for tid in tids:
                node_taints[i, tid] = 1.0

        # fast path: no group carries any scheduling constraint — the
        # common burst shape; skip every per-group sweep (the group-side
        # matrices are all-zero / trivially empty)
        if not slot_entries and \
                all(t.constraint_key_cache is _TRIVIAL_CONSTRAINT or (
                    not t.pod.spec.node_selector
                    and not t.pod.spec.tolerations
                    and t.pod.spec.affinity is None
                    and not t.pod.spec.topology_spread) for t in reps):
            f_pad = bucket(1, 8)
            return cls(
                node_pairs=np.zeros((n_pad, f_pad), np.float32),
                group_requires=np.zeros((g_pad, f_pad), np.float32),
                group_require_counts=np.zeros(g_pad, np.float32),
                node_taints=node_taints,
                group_tolerates=np.zeros((g_pad, k_pad), np.float32),
                group_affinity_ok=None)

        # collect referenced selector pairs (and the compiler's assigned
        # topology domains: required pairs with identical semantics)
        pair_ids: Dict[Tuple[str, str], int] = {}
        group_pairs: List[List[int]] = [[] for _ in range(g_pad)]
        unsat = ("__constraint_unsat__", "__constraint_unsat__")
        for g, t in enumerate(reps):
            for k, v in sorted(t.pod.spec.node_selector.items()):
                pid = pair_ids.setdefault((k, v), len(pair_ids))
                group_pairs[g].append(pid)
            entries = slot_entries.get(t.uid) if slot_entries else None
            for key, values, _hard in entries or ():
                pair = (key, values[0]) if values else unsat
                pid = pair_ids.setdefault(pair, len(pair_ids))
                group_pairs[g].append(pid)

        f_pad = bucket(max(1, len(pair_ids)), 8)
        node_pairs = np.zeros((n_pad, f_pad), np.float32)
        if pair_ids:   # no referenced pairs -> skip the 10k-node label sweep
            for name, i in node_arrays.name_to_idx.items():
                labels = nodes[name].node.metadata.labels \
                    if nodes[name].node else {}
                for (k, v), pid in pair_ids.items():
                    if labels.get(k) == v:
                        node_pairs[i, pid] = 1.0

        group_requires = np.zeros((g_pad, f_pad), np.float32)
        for g, pids in enumerate(group_pairs):
            for pid in pids:
                group_requires[g, pid] = 1.0
        group_require_counts = group_requires.sum(axis=1).astype(np.float32)

        group_tolerates = np.zeros((g_pad, k_pad), np.float32)
        from .objects import Taint
        for g, t in enumerate(reps):
            for (key, value, effect), tid in taint_ids.items():
                taint = Taint(key=key, value=value, effect=effect)
                if any(tol.tolerates(taint) for tol in t.pod.spec.tolerations):
                    group_tolerates[g, tid] = 1.0

        # full node-affinity evaluation (any expression form), host-encoded
        # per group x node; built only when some group actually carries
        # required affinity (None otherwise — see class docstring)
        group_affinity_ok = None
        for g, t in enumerate(reps):
            aff = t.pod.spec.affinity
            if aff is None or aff.node_affinity is None or not aff.node_affinity.required:
                continue
            if group_affinity_ok is None:
                group_affinity_ok = np.ones((g_pad, n_pad), bool)
            terms = aff.node_affinity.required
            for name, i in node_arrays.name_to_idx.items():
                labels = nodes[name].node.metadata.labels if nodes[name].node else {}
                group_affinity_ok[g, i] = any(term.matches(labels) for term in terms)

        return cls(node_pairs=node_pairs, group_requires=group_requires,
                   group_require_counts=group_require_counts,
                   node_taints=node_taints, group_tolerates=group_tolerates,
                   group_affinity_ok=group_affinity_ok)
