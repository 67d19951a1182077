"""Synthetic clusters for benchmarks and scale tests, at two levels (this
port's own copy of volcano_tpu/utils/synth.py):

* ``synth_arrays`` builds what the scheduler sees after the cache snapshot
  has been encoded: a gang-heavy pending backlog over a partially utilized
  cluster, as numpy arrays. It gives byte-identical arrays to the JAX
  package's for the same arguments (the generator draws the same numpy
  bits in the same order), so both packages can be held against each
  other on one fixture.
* ``populate_store`` fills an ObjectStore with Nodes, Pods, PodGroups and
  Queues for the whole scheduling cycle; it is deterministic by index and
  builds the same objects as the JAX package's for the same arguments.
* ``populate_preempt_store`` and ``populate_reclaim_store`` build the
  reference harness's preemption and reclamation shapes
  (volcano_tpu/bench_suite.py:203-250, config 4, and :478-520,
  config_reclaim): full nodes of low-priority or over-share Running gangs
  and pending gangs that must evict to run. Deterministic by index.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.arrays import bucket


@dataclass
class SynthArrays:
    """Dense solver inputs for a T-task x N-node synthetic cluster."""
    task_group: np.ndarray      # [T] i32
    task_job: np.ndarray        # [T] i32
    task_valid: np.ndarray      # [T] bool
    group_req: np.ndarray       # [G, R] f32
    group_mask: np.ndarray      # [G, N] bool
    group_static_score: np.ndarray  # [G, N] f32
    task_bucket: np.ndarray     # [T] i32 (-1 = out of bucket)
    group_pack_bonus: np.ndarray  # [G] f32
    job_min_available: np.ndarray   # [J] i32
    job_ready_base: np.ndarray      # [J] i32
    job_task_start: np.ndarray      # [J] i32
    job_n_tasks: np.ndarray         # [J] i32
    job_queue: np.ndarray           # [J] i32
    pool_queue: np.ndarray          # [P] i32 (single-ns: pools == queues)
    pool_ns: np.ndarray             # [P] i32
    pool_job_start: np.ndarray      # [P] i32
    pool_njobs: np.ndarray          # [P] i32
    ns_weight: np.ndarray           # [NS] f32
    ns_alloc0: np.ndarray           # [NS, R] f32
    ns_total: np.ndarray            # [R] f32
    queue_deserved: np.ndarray      # [Q, R] f32
    queue_alloc0: np.ndarray        # [Q, R] f32
    node_idle: np.ndarray       # [N, R] f32
    node_future: np.ndarray     # [N, R] f32
    node_alloc: np.ndarray      # [N, R] f32
    node_ntasks: np.ndarray     # [N] i32
    node_max_tasks: np.ndarray  # [N] i32
    eps: np.ndarray             # [R] f32

    @property
    def args(self) -> list:
        """The 28 positional arrays of ops.allocate.gang_allocate, in order
        (weights excluded)."""
        return [getattr(self, f.name) for f in fields(self)]

    def as_dict(self) -> Dict[str, np.ndarray]:
        """{field: array} without copying (dataclasses.asdict deep-copies)."""
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @property
    def shapes(self) -> str:
        return (f"T={self.task_group.shape[0]} N={self.node_idle.shape[0]} "
                f"G={self.group_req.shape[0]} J={self.job_min_available.shape[0]} "
                f"R={self.node_idle.shape[1]}")


def synth_arrays(n_tasks: int, n_nodes: int, *, gang_size: int = 8,
                 n_racks: int = 32, r: int = 4, seed: int = 0,
                 utilization: float = 0.3, node_pad_to: Optional[int] = None,
                 rack_affinity: bool = True, n_queues: int = 1,
                 n_namespaces: int = 1) -> SynthArrays:
    """A gang-heavy pending backlog over a partially utilized cluster.

    Nodes: 64-core/256GiB-shaped with uniform random pre-existing usage around
    ``utilization``; resource dims are [cpu(milli), memory(MiB), pods-slack,
    accelerator]. Tasks: gangs of ``gang_size`` with per-gang resource shapes;
    each gang is one group (homogeneous replicas). Rack-affinity static score
    prefers a random rack per gang. Jobs are striped round-robin over
    ``n_queues`` queues and drawn at random into ``n_namespaces`` namespaces,
    then regrouped so each (namespace, queue) pool's jobs are contiguous.
    """
    rng = np.random.default_rng(seed)
    n_jobs = max(1, n_tasks // gang_size)
    n_tasks = n_jobs * gang_size
    n_groups = n_jobs

    t_pad = bucket(n_tasks, 256)
    g_pad = bucket(n_groups, 16)
    j_pad = bucket(n_jobs + 1, 16)          # + sentinel for padding tasks
    n_pad = node_pad_to if node_pad_to else bucket(n_nodes, 256)

    # nodes
    cap = np.zeros((n_pad, r), np.float32)
    cap[:n_nodes, 0] = 64_000.0                           # 64 cores (milli)
    cap[:n_nodes, 1] = 256 * 1024.0                       # 256 GiB in MiB
    cap[:n_nodes, 2] = 110.0                              # pods dimension
    cap[:n_nodes, 3] = 8.0                                # accelerators
    used_frac = rng.uniform(0.0, 2 * utilization, (n_pad, 1)).astype(np.float32)
    used = (cap * used_frac).astype(np.float32)
    idle = cap - used
    node_ntasks = np.zeros(n_pad, np.int32)
    node_ntasks[:n_nodes] = (used_frac[:n_nodes, 0] * 30).astype(np.int32)
    node_max_tasks = np.zeros(n_pad, np.int32)            # uncapped

    # gangs
    group_req = np.zeros((g_pad, r), np.float32)
    group_req[:n_groups, 0] = rng.choice([1000, 2000, 4000, 8000], n_groups)
    group_req[:n_groups, 1] = rng.choice([2048, 4096, 8192, 16384], n_groups)
    group_req[:n_groups, 2] = 1.0
    group_req[:n_groups, 3] = rng.choice([0, 0, 0, 1], n_groups)

    task_group = np.zeros(t_pad, np.int32)
    task_job = np.full(t_pad, n_jobs, np.int32)           # sentinel fill
    task_valid = np.zeros(t_pad, bool)
    ids = np.arange(n_tasks)
    task_group[:n_tasks] = ids // gang_size
    task_job[:n_tasks] = ids // gang_size
    task_valid[:n_tasks] = True

    job_min_available = np.zeros(j_pad, np.int32)
    job_min_available[:n_jobs] = gang_size
    job_ready_base = np.zeros(j_pad, np.int32)
    job_task_start = np.zeros(j_pad, np.int32)
    job_task_start[:n_jobs] = np.arange(n_jobs) * gang_size
    job_n_tasks = np.zeros(j_pad, np.int32)
    job_n_tasks[:n_jobs] = gang_size

    q_pad = bucket(n_queues, 8)
    job_queue = np.zeros(j_pad, np.int32)
    job_queue[:n_jobs] = np.arange(n_jobs) % n_queues
    job_ns = np.zeros(j_pad, np.int32)
    if n_namespaces > 1:
        job_ns[:n_jobs] = rng.integers(0, n_namespaces, n_jobs)
    if n_queues > 1 or n_namespaces > 1:
        key = job_ns[:n_jobs].astype(np.int64) * n_queues \
            + job_queue[:n_jobs]
        order = np.argsort(key, kind="stable")
        # rebuild task arrays in regrouped job order
        new_task_order = np.concatenate(
            [np.arange(j * gang_size, (j + 1) * gang_size) for j in order])
        task_group[:n_tasks] = task_group[:n_tasks][new_task_order]
        remap = np.empty(n_jobs, np.int64)
        remap[order] = np.arange(n_jobs)
        task_job[:n_tasks] = remap[task_job[:n_tasks][new_task_order]]
        job_queue[:n_jobs] = job_queue[:n_jobs][order]
        job_ns[:n_jobs] = job_ns[:n_jobs][order]
    queue_deserved = np.full((q_pad, r), np.inf, np.float32)
    queue_alloc0 = np.zeros((q_pad, r), np.float32)
    # pools: contiguous (ns, queue) runs over the regrouped jobs
    run_keys: list = []
    pool_queue_l: list = []
    pool_ns_l: list = []
    pool_start_l: list = []
    pool_n_l: list = []
    for j in range(n_jobs):
        k = (int(job_ns[j]), int(job_queue[j]))
        if not run_keys or run_keys[-1] != k:
            run_keys.append(k)
            pool_ns_l.append(k[0])
            pool_queue_l.append(k[1])
            pool_start_l.append(j)
            pool_n_l.append(0)
        pool_n_l[-1] += 1
    p_pad = bucket(max(1, len(run_keys)), 8)
    pool_queue = np.zeros(p_pad, np.int32)
    pool_queue[:len(run_keys)] = pool_queue_l
    pool_ns = np.zeros(p_pad, np.int32)
    pool_ns[:len(run_keys)] = pool_ns_l
    pool_job_start = np.zeros(p_pad, np.int32)
    pool_job_start[:len(run_keys)] = pool_start_l
    pool_njobs = np.zeros(p_pad, np.int32)
    pool_njobs[:len(run_keys)] = pool_n_l
    ns_pad = max(1, n_namespaces)
    ns_weight = np.ones(ns_pad, np.float32)
    ns_alloc0 = np.zeros((ns_pad, r), np.float32)
    ns_total = cap[:n_nodes].sum(axis=0).astype(np.float32)

    # static predicates: valid nodes only; static score: rack affinity
    group_mask = np.zeros((g_pad, n_pad), bool)
    group_mask[:, :n_nodes] = True
    group_static_score = np.zeros((g_pad, n_pad), np.float32)
    if rack_affinity and n_racks > 0:
        node_rack = rng.integers(0, n_racks, n_nodes)
        gang_rack = rng.integers(0, n_racks, n_groups)
        group_static_score[:n_groups, :n_nodes] = (
            (gang_rack[:, None] == node_rack[None, :]) * 50.0)

    eps = np.array([100.0, 0.1, 0.1, 0.1], np.float32)[:r]

    return SynthArrays(
        task_group=task_group, task_job=task_job, task_valid=task_valid,
        group_req=group_req, group_mask=group_mask,
        group_static_score=group_static_score,
        task_bucket=np.full(t_pad, -1, np.int32),
        group_pack_bonus=np.zeros(g_pad, np.float32),
        job_min_available=job_min_available, job_ready_base=job_ready_base,
        job_task_start=job_task_start, job_n_tasks=job_n_tasks,
        job_queue=job_queue, pool_queue=pool_queue, pool_ns=pool_ns,
        pool_job_start=pool_job_start, pool_njobs=pool_njobs,
        ns_weight=ns_weight, ns_alloc0=ns_alloc0, ns_total=ns_total,
        queue_deserved=queue_deserved, queue_alloc0=queue_alloc0,
        node_idle=idle, node_future=idle.copy(), node_alloc=cap,
        node_ntasks=node_ntasks, node_max_tasks=node_max_tasks, eps=eps)


def zone_slots(sa, zones: int, every: int = 2, unsat_every: int = 0,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-task domain slots over SynthArrays-shaped inputs (any object
    with their numpy fields), the kernel's ``task_slot`` [T] i32 and
    ``slot_ok`` [S+1, N] bool: real node i lies in zone i % zones, row z
    < zones holds zone z's nodes, row ``zones`` none and row S = zones + 1
    every node. The tasks of every ``every``-th job rotate over the zones
    from a random first zone (one replica per zone, as the constraint
    compiler assigns spread and anti-affinity gangs); with
    ``unsat_every`` > 0 the last task of every ``unsat_every``-th such job
    takes the empty row. Every other task, padding included, takes S."""
    rng = np.random.default_rng(seed)
    n = sa.node_idle.shape[0]
    real = np.flatnonzero(sa.node_alloc.any(axis=1))
    S = zones + 1
    slot_ok = np.zeros((S + 1, n), bool)
    slot_ok[real % zones, real] = True
    slot_ok[S] = True
    task_slot = np.full(sa.task_group.shape[0], S, np.int32)
    jobs = np.flatnonzero(sa.job_n_tasks > 0)
    for k, j in enumerate(jobs[::every]):
        start, size = int(sa.job_task_start[j]), int(sa.job_n_tasks[j])
        first = int(rng.integers(zones))
        task_slot[start:start + size] = (first + np.arange(size)) % zones
        if unsat_every and k % unsat_every == 0:
            task_slot[start + size - 1] = zones
    return task_slot, slot_ok


def populate_store(store, *, n_nodes: int, n_jobs: int, gang_size: int,
                   queues: Optional[List[Tuple[str, int]]] = None,
                   cpu_req: str = "2", mem_req: str = "4Gi",
                   node_cpu: str = "64", node_mem: str = "256Gi",
                   namespace: str = "default",
                   phase: str = "Inqueue", zones: int = 0,
                   spread_every: int = 0,
                   anti_every: int = 0) -> Dict[str, int]:
    """Object-level synthetic cluster in an ObjectStore.

    ``zones`` > 0 labels node i with topology.kubernetes.io/zone =
    zone-<i % zones>; ``spread_every`` / ``anti_every`` give every Nth
    job a hard zone topology-spread constraint (max_skew 1) / a required
    one-replica-per-zone self-anti-affinity term, which the constraint
    compiler lowers to per-task zone slots (ops/constraints.py).
    Deterministic by job index, no rng."""
    from ..models.objects import (Affinity, NodeSelectorRequirement,
                                  PodAffinity, PodAffinityTerm,
                                  TopologySpreadConstraint)
    from .test_utils import (build_node, build_pod, build_pod_group,
                             build_queue)
    queues = queues or [("default", 1)]
    for qname, weight in queues:
        if store.get("queues", qname) is None:
            store.create("queues", build_queue(qname, weight=weight))
    for i in range(n_nodes):
        labels = {"rack": f"rack-{i % 32}"}
        if zones > 0:
            labels["topology.kubernetes.io/zone"] = f"zone-{i % zones}"
        store.create("nodes", build_node(
            f"node-{i}", {"cpu": node_cpu, "memory": node_mem, "pods": "110"},
            labels=labels))
    for j in range(n_jobs):
        qname = queues[j % len(queues)][0]
        pg = build_pod_group(f"pg-{j}", namespace, qname, gang_size,
                             phase=phase)
        store.create("podgroups", pg)
        spread = zones > 0 and spread_every > 0 and j % spread_every == 0
        anti = zones > 0 and anti_every > 0 and not spread \
            and j % anti_every == 1 % max(1, anti_every)
        for t in range(gang_size):
            pod = build_pod(
                namespace, f"job{j}-task{t}", "", "Pending",
                {"cpu": cpu_req, "memory": mem_req}, groupname=f"pg-{j}",
                labels={"synth-job": f"pg-{j}"} if anti else None)
            if spread:
                pod.spec.topology_spread = [TopologySpreadConstraint(
                    max_skew=1,
                    topology_key="topology.kubernetes.io/zone",
                    when_unsatisfiable="DoNotSchedule")]
            elif anti:
                pod.spec.affinity = Affinity(pod_anti_affinity=PodAffinity(
                    required=[PodAffinityTerm(
                        label_selector=[NodeSelectorRequirement(
                            key="synth-job", operator="In",
                            values=[f"pg-{j}"])],
                        topology_key="topology.kubernetes.io/zone")]))
            store.create("pods", pod)
    return {"nodes": n_nodes, "jobs": n_jobs, "tasks": n_jobs * gang_size}


def _populate_victim_shape(store, *, n_nodes: int, n_victim: int,
                           n_pending: int, victim_queue: str,
                           pending_queue: str, victim_pc: str = "",
                           pending_pc: str = "", victim_prefix: str,
                           pending_prefix: str, victim_min: int = 8,
                           pending_request: Tuple[str, str] = ("8", "16Gi")
                           ) -> Dict[str, int]:
    """Nodes of 16 CPU and 32Gi; ``n_victim`` Running gangs of 8 pods of
    14 CPU and 28Gi (minMember ``victim_min``), pod k of them all on node
    k % n_nodes; ``n_pending`` Inqueue gangs of 8 pending pods of
    ``pending_request`` (cpu, memory)."""
    from .test_utils import build_node, build_pod, build_pod_group
    for i in range(n_nodes):
        store.create("nodes", build_node(f"node-{i}",
                                         {"cpu": "16", "memory": "32Gi"}))
    for j in range(n_victim):
        name = f"{victim_prefix}-{j}"
        store.create("podgroups", build_pod_group(
            name, "ns1", victim_queue, victim_min, phase="Running",
            priority_class=victim_pc))
        for t in range(8):
            store.create("pods", build_pod(
                "ns1", f"{name}-{t}", f"node-{(j * 8 + t) % n_nodes}",
                "Running", {"cpu": "14", "memory": "28Gi"}, name))
    for j in range(n_pending):
        name = f"{pending_prefix}-{j}"
        store.create("podgroups", build_pod_group(
            name, "ns1", pending_queue, 8, phase="Inqueue",
            priority_class=pending_pc))
        for t in range(8):
            store.create("pods", build_pod(
                "ns1", f"{name}-{t}", "", "Pending",
                {"cpu": pending_request[0], "memory": pending_request[1]},
                name))
    return {"nodes": n_nodes, "victim_pods": n_victim * 8,
            "pending_pods": n_pending * 8}


def populate_preempt_store(store, *, n_nodes: int = 10_000,
                           n_low: int = 1250, n_high: int = 625,
                           elastic: bool = False) -> Dict[str, int]:
    """The preemption shape (config 4): queue ``default``, priority
    classes high (100) and low (1); ``n_low`` low-priority Running gangs
    lo-<j> fill the nodes and ``n_high`` high-priority gangs hi-<j> wait.
    ``elastic``: the shape of the reference's victim-selection A/B
    (bench.py:556-584) instead, where the low gangs' minMember is 4, so
    that the gang plugin admits victims, and the high pods ask 14 CPU and
    28Gi."""
    from ..models.objects import ObjectMeta, PriorityClass
    from .test_utils import build_queue
    store.create("queues", build_queue("default", weight=1))
    for name, value in (("high", 100), ("low", 1)):
        store.create("priorityclasses", PriorityClass(
            metadata=ObjectMeta(name=name), value=value))
    return _populate_victim_shape(
        store, n_nodes=n_nodes, n_victim=n_low, n_pending=n_high,
        victim_queue="default", pending_queue="default", victim_pc="low",
        pending_pc="high", victim_prefix="lo", pending_prefix="hi",
        victim_min=4 if elastic else 8,
        pending_request=("14", "28Gi") if elastic else ("8", "16Gi"))


def populate_reclaim_store(store, *, n_nodes: int = 10_000,
                           n_running: int = 1250, n_pending: int = 625
                           ) -> Dict[str, int]:
    """The reclamation shape (config_reclaim): queues q-over and q-under
    of weight 1; q-over's ``n_running`` Running gangs ov-<j> fill the
    nodes and q-under's ``n_pending`` gangs un-<j> reclaim."""
    from .test_utils import build_queue
    store.create("queues", build_queue("q-over", weight=1))
    store.create("queues", build_queue("q-under", weight=1))
    return _populate_victim_shape(
        store, n_nodes=n_nodes, n_victim=n_running, n_pending=n_pending,
        victim_queue="q-over", pending_queue="q-under", victim_prefix="ov",
        pending_prefix="un")
