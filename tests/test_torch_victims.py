"""Victim selection of the port held against the JAX package: the
vectorized path (``ops/victims.py``) and the walk (``framework/victims.py``,
``victims.kernel: off``) on the victim-kernel parity cases of
tests/test_constraints.py, the host ``node_score`` against the reference's
``xp=np`` form, and the torch prefix functions of ``ops/preempt.py``
against the jnp ones.

Each scenario is one plain description (``Scenario``) that both packages
build into their own ObjectStore with their own builders; no object
crosses between the packages. ``run`` drives one package's actions on a
harness of a real cache with a fake binder and evictor and returns the
evicted pod keys in eviction order, the pipelined task -> node map read
from the session before close, and the PodGroup phases read back from the
store after close. Tolerance: exact, for every quantity here.

tests/test_torch_preempt.py and tests/test_torch_reclaim.py import the
harness from here.
"""

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import pytest
import torch

from tests.harness import Harness as RefHarness
from volcano_tpu.models.job_info import TaskStatus as RefStatus
from volcano_tpu.models.objects import ObjectMeta as RefMeta
from volcano_tpu.models.objects import PriorityClass as RefPC
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu_torch.apiserver import ObjectStore as PortStore
from volcano_tpu_torch.cache import SchedulerCache as PortCache
from volcano_tpu_torch.framework import (close_session, get_action,
                                         open_session, parse_scheduler_conf)
from volcano_tpu_torch.models.job_info import TaskStatus as PortStatus
from volcano_tpu_torch.models.objects import ObjectMeta as PortMeta
from volcano_tpu_torch.models.objects import PriorityClass as PortPC
from volcano_tpu_torch.utils import test_utils as port_tu


@dataclass
class Scenario:
    """A cluster as plain tuples: queues (name, weight, reclaimable),
    priority classes (name, value), nodes (name, cpu, memory), podgroups
    (name, namespace, queue, min_member, phase, priority class) and pods
    (namespace, name, node, phase, cpu, memory, group)."""
    queues: List[Tuple] = field(default_factory=list)
    classes: List[Tuple] = field(default_factory=list)
    nodes: List[Tuple] = field(default_factory=list)
    podgroups: List[Tuple] = field(default_factory=list)
    pods: List[Tuple] = field(default_factory=list)


class PortHarness:
    """tests/harness.py's Harness for the port: a real cache with a fake
    binder and evictor, sessions opened on the CPU."""

    def __init__(self, conf_text: str):
        self.store = PortStore()
        self.binder = port_tu.FakeBinder(self.store)
        self.evictor = port_tu.FakeEvictor(self.store)
        self.cache = PortCache(self.store, binder=self.binder,
                               evictor=self.evictor)
        self.cache.run()
        self.conf = parse_scheduler_conf(conf_text)
        self.ssn = None

    def add(self, kind, *objs):
        for o in objs:
            self.store.create(kind, o)
        return self

    def open_session(self):
        self.ssn = open_session(self.cache, self.conf.tiers,
                                self.conf.configurations, device="cpu")
        return self.ssn

    def run_actions(self, *names):
        if self.ssn is None:
            self.open_session()
        for name in names:
            get_action(name).execute(self.ssn)
        # the cache's store writes run on its executor: wait for them, as
        # the reference's Harness does
        self.cache.flush_executors()
        return self

    def close_session(self):
        if self.ssn is not None:
            close_session(self.ssn)
            self.ssn = None
        self.cache.flush_executors()
        return self

    @property
    def evicts(self):
        return self.evictor.evicts


class Pkg:
    def __init__(self, name, harness, tu, meta, pc, status):
        self.name, self.Harness, self.tu = name, harness, tu
        self.Meta, self.PC, self.Status = meta, pc, status


REF = Pkg("ref", RefHarness, ref_tu, RefMeta, RefPC, RefStatus)
PORT = Pkg("port", PortHarness, port_tu, PortMeta, PortPC, PortStatus)

WALK_OFF = """
configurations:
- name: solver
  arguments:
    victims.kernel: "off"
"""


def with_mode(conf: str, mode: str) -> str:
    """``conf`` under ``victims.kernel: auto`` (as given) or ``off``."""
    return conf + WALK_OFF if mode == "off" else conf


def build(pkg: Pkg, conf: str, sc: Scenario):
    """``pkg``'s harness with the scenario's objects in its store."""
    tu = pkg.tu
    h = pkg.Harness(conf)
    for name, weight, reclaimable in sc.queues:
        h.add("queues", tu.build_queue(name, weight=weight,
                                       reclaimable=reclaimable))
    for name, value in sc.classes:
        h.add("priorityclasses", pkg.PC(metadata=pkg.Meta(name=name),
                                        value=value))
    for name, cpu, mem in sc.nodes:
        h.add("nodes", tu.build_node(name, tu.build_resource_list(cpu, mem)))
    for name, ns, queue, minm, phase, pc in sc.podgroups:
        h.add("podgroups", tu.build_pod_group(name, ns, queue, minm,
                                              phase=phase,
                                              priority_class=pc))
    for ns, name, node, phase, cpu, mem, group in sc.pods:
        h.add("pods", tu.build_pod(ns, name, node, phase,
                                   tu.build_resource_list(cpu, mem), group))
    return h


def outcome_of(pkg: Pkg, h, actions):
    """Run ``actions`` in one session of ``h``: (evicted keys in order,
    pipelined "ns/name" -> node, PodGroup phases, the session)."""
    ssn = h.open_session()
    h.run_actions(*actions)
    pipelined = {f"{t.namespace}/{t.name}": t.node_name
                 for job in ssn.jobs.values()
                 for t in job.task_status_index.get(pkg.Status.Pipelined,
                                                    {}).values()}
    h.close_session()
    h.cache.stop()
    phases = {f"{g.metadata.namespace}/{g.metadata.name}": g.status.phase
              for g in h.store.list("podgroups")}
    return list(h.evicts), pipelined, phases, ssn


def run(pkg: Pkg, conf: str, sc: Scenario, actions):
    return outcome_of(pkg, build(pkg, conf, sc), actions)


def assert_same(conf: str, sc: Scenario, actions, expect_evicts=None):
    """Run the scenario through both packages; evictions, pipelines and
    phases must be equal. Returns the port's outcome."""
    r_ev, r_pipe, r_phase, _ = run(REF, conf, sc, actions)
    p_ev, p_pipe, p_phase, ssn = run(PORT, conf, sc, actions)
    assert p_ev == r_ev
    assert p_pipe == r_pipe
    assert p_phase == r_phase
    if expect_evicts is not None:
        assert len(p_ev) == expect_evicts, p_ev
    return p_ev, p_pipe, p_phase, ssn


# -- the victim-kernel parity cases (tests/test_constraints.py:430-560) -------

PREEMPT_CONF = """
actions: "preempt"
tiers:
- plugins:
  - name: priority
  - name: conformance
  - name: gang
- plugins:
  - name: predicates
  - name: nodeorder
"""

MULTI_TIER_CONF = """
actions: "preempt"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: conformance
"""

DRF_CONF = """
actions: "preempt"
tiers:
- plugins:
  - name: priority
  - name: conformance
  - name: gang
  - name: drf
- plugins:
  - name: predicates
  - name: nodeorder
"""

RECLAIM_CONF = """
actions: "reclaim"
tiers:
- plugins:
  - name: conformance
  - name: gang
  - name: proportion
"""


def preempt_cluster(n_nodes=6) -> Scenario:
    """Elastic low-priority residents fill every node (min_available 2 of
    4, so the gang plugin admits victims); three high-priority gangs of 2
    are pending."""
    sc = Scenario(queues=[("q1", 1, True)],
                  classes=[("high", 1000), ("low", 1)])
    sc.nodes = [(f"n{i}", "4", "4Gi") for i in range(n_nodes)]
    for j in range(n_nodes):
        sc.podgroups.append((f"lo-{j}", "c1", "q1", 2, "Inqueue", "low"))
        sc.pods += [("c1", f"lo{j}-{t}", f"n{j}", "Running", "1", "1Gi",
                     f"lo-{j}") for t in range(4)]
    for j in range(3):
        sc.podgroups.append((f"hi-{j}", "c1", "q1", 2, "Inqueue", "high"))
        sc.pods += [("c1", f"hi{j}-{t}", "", "Pending", "1", "1Gi",
                     f"hi-{j}") for t in range(2)]
    return sc


def reclaim_cluster(n_nodes=4) -> Scenario:
    """q1 fills every node; q2's two gangs of 2 reclaim."""
    sc = Scenario(queues=[("q1", 1, True), ("q2", 1, True)])
    sc.nodes = [(f"n{i}", "3", "3Gi") for i in range(n_nodes)]
    for j in range(n_nodes):
        sc.podgroups.append((f"own-{j}", "c1", "q1", 1, "Inqueue", ""))
        sc.pods += [("c1", f"own{j}-{t}", f"n{j}", "Running", "1", "1Gi",
                     f"own-{j}") for t in range(3)]
    for j in range(2):
        sc.podgroups.append((f"rc-{j}", "c1", "q2", 1, "Inqueue", ""))
        sc.pods += [("c1", f"rc{j}-{t}", "", "Pending", "1", "1Gi",
                     f"rc-{j}") for t in range(2)]
    return sc


KERNEL_CASES = {
    # case: (conf, scenario, action, path the port's runs must show)
    "preempt": (PREEMPT_CONF, preempt_cluster, "preempt", "kernel"),
    "preempt_multi_tier": (MULTI_TIER_CONF, preempt_cluster, "preempt",
                           "kernel"),
    "reclaim": (RECLAIM_CONF, reclaim_cluster, "reclaim", "kernel"),
    "preempt_drf_chain": (DRF_CONF, preempt_cluster, "preempt", "python"),
}


@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_victim_selection_matches_reference(case, mode):
    conf, make, action, path = KERNEL_CASES[case]
    evicts, _, _, ssn = assert_same(with_mode(conf, mode), make(), [action])
    assert evicts, f"{case}: no evictions"
    runs = ssn.victim_runs
    want = "python" if mode == "off" else path
    assert runs.get(want, 0) > 0, runs
    assert sum(runs.values()) == runs[want], runs


@pytest.mark.parametrize("case", ["preempt", "preempt_multi_tier",
                                  "reclaim"])
def test_kernel_and_walk_evict_alike(case):
    """The port's two paths against each other, eviction for eviction."""
    conf, make, action, _ = KERNEL_CASES[case]
    kern = run(PORT, conf, make(), [action])
    walk = run(PORT, with_mode(conf, "off"), make(), [action])
    assert kern[:3] == walk[:3]


def test_kernel_exception_propagates(monkeypatch):
    """No fall-back: an exception of the vectorized path reaches the
    caller instead of handing the action to the walk."""
    from volcano_tpu_torch.ops.victims import VictimKernel

    def boom(self, *a, **kw):
        raise RuntimeError("forced victim-kernel failure")
    monkeypatch.setattr(VictimKernel, "place", boom)
    h = build(PORT, PREEMPT_CONF, preempt_cluster())
    h.open_session()
    with pytest.raises(RuntimeError, match="forced victim-kernel failure"):
        h.run_actions("preempt")
    assert h.evicts == []


@pytest.mark.parametrize("make", [preempt_cluster, reclaim_cluster])
def test_host_context_matches_reference(make):
    """BatchSolver.build_host_context: the same node order, batch, static
    mask and static score as the reference's, on the same scenario."""
    conf = PREEMPT_CONF if make is preempt_cluster else RECLAIM_CONF
    out = []
    for pkg in (REF, PORT):
        h = build(pkg, conf, make())
        ssn = h.open_session()
        ordered = [(job, list(job.task_status_index.get(
            pkg.Status.Pending, {}).values())) for job in ssn.jobs.values()]
        ordered = [(j, ts) for j, ts in ordered if ts]
        narr, batch, gmask, static = ssn.solver.build_host_context(ordered)
        g, n = batch.n_groups, len(narr.names)
        out.append((narr.names, batch.job_uids, np.asarray(gmask)[:g, :n],
                    np.asarray(static)[:g, :n]))
        h.close_session()
    (r_names, r_jobs, r_mask, r_static), (names, jobs, mask, static) = out
    assert names == r_names and jobs == r_jobs
    np.testing.assert_array_equal(mask, r_mask)
    np.testing.assert_array_equal(static, r_static)


# -- the host node_score ---------------------------------------------------------


def _score_inputs(seed, n=64, r=3, ties=False):
    rng = np.random.default_rng(seed)
    alloc = rng.choice([0.0, 4000.0, 16000.0, 64000.0], (n, r)).astype(
        np.float32)
    idle = (alloc * rng.uniform(0, 1, (n, r))).round().astype(np.float32)
    if ties:
        alloc[:] = alloc[0]
        idle[:] = idle[0]
    req = rng.choice([0.0, 500.0, 8000.0, 14000.0], r).astype(np.float32)
    static = np.zeros(n, np.float32) if ties else \
        rng.choice([0.0, 0.5, 50.0], n).astype(np.float32)
    w = dict(binpack_res=rng.uniform(0, 2, r).astype(np.float32),
             binpack=float(rng.choice([0.0, 1.0, 3.0])),
             least=float(rng.choice([0.0, 1.0])), most=float(
                 rng.choice([0.0, 2.0])), balanced=float(
                 rng.choice([0.0, 1.0])))
    return req, idle, alloc, static, w


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True),
                                       (3, True), (4, False)])
def test_host_node_score_bitwise(seed, ties):
    from volcano_tpu.ops.score import ScoreWeights as RefW
    from volcano_tpu.ops.score import node_score as ref_score
    from volcano_tpu_torch.ops.score import ScoreWeights as PortW
    from volcano_tpu_torch.ops.score import host_node_score

    req, idle, alloc, static, w = _score_inputs(seed, ties=ties)
    r = req.shape[0]
    ref_w = RefW.make(r, **w).host()
    port_w = PortW.make(r, device="cpu", **w).host()
    want = np.asarray(ref_score(req, idle, alloc, ref_w, static, xp=np))
    got = host_node_score(req, idle, alloc, port_w, static)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if ties:
        assert (got == got[0]).all()


# -- ops/preempt.py against the jnp forms ----------------------------------------


def _prefix_inputs(seed, b=5, n=12, v=4, r=2):
    """Seeded integer-valued resources (the encode's milli-cpu and MiB are
    integers, so every sum is exact in float32 in any order)."""
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 9, (b, r)).astype(np.float32)
    node_ok = rng.uniform(size=(b, n)) < 0.8
    base = rng.integers(0, 4, (n, r)).astype(np.float32)
    vres = rng.integers(0, 5, (n, v, r)).astype(np.float32)
    vvalid = rng.uniform(size=(n, v)) < 0.7
    vvalid[0] = False                 # a node without victims
    eps = np.full(r, 0.1, np.float32)
    return req, node_ok, base, vres, vvalid, eps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_functions_match_jnp(seed):
    import jax.numpy as jnp
    from volcano_tpu.ops import preempt as ref_pre
    from volcano_tpu.ops import victims as ref_vic
    from volcano_tpu_torch.ops import preempt as port_pre

    req, node_ok, base, vres, vvalid, eps = _prefix_inputs(seed)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (req, node_ok, base, vres, vvalid, eps)]
    rng = np.random.default_rng(seed + 100)
    score = rng.choice([1.0, 2.0, 3.0], base.shape[0]).astype(np.float32)
    for k in range(req.shape[0]):
        args = (req[k], node_ok[k], base, vres, vvalid, eps)
        targs = (t[0][k], t[1][k], *t[2:])
        want = ref_pre.victim_prefix(*map(jnp.asarray, args))
        got = port_pre.victim_prefix(*targs)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        want_r = ref_pre.reclaim_prefix(*map(jnp.asarray, args))
        got_r = port_pre.reclaim_prefix(*targs)
        for g, w_ in zip(got_r, want_r):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        np.testing.assert_array_equal(
            port_pre.pick_best_node(got[0], torch.from_numpy(score)).numpy(),
            np.asarray(ref_pre.pick_best_node(want[0], jnp.asarray(score))))
    batch_args = [jnp.asarray(a) for a in (req, node_ok, base, vres,
                                           vvalid, eps)]
    want_b = ref_vic.victim_prefix_batch()(*batch_args)
    want_rb = ref_vic.reclaim_prefix_batch()(*batch_args)
    for chunk in (None, 2):
        got_b = port_pre.victim_prefix_batch(*t, device="cpu", chunk=chunk)
        for g, w_ in zip(got_b, want_b):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        got_rb = port_pre.reclaim_prefix_batch(*t, device="cpu", chunk=chunk)
        for g, w_ in zip(got_rb, want_rb):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    np.testing.assert_array_equal(
        port_pre.pick_best_node(got_b[0], torch.from_numpy(score)).numpy(),
        [int(ref_pre.pick_best_node(want_b[0][k], jnp.asarray(score)))
         for k in range(req.shape[0])])


def test_prefix_batch_needs_a_device(monkeypatch):
    from volcano_tpu_torch.ops import preempt as port_pre
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pre.victim_prefix_batch(*_prefix_inputs(0))


def test_pack_node_major():
    from volcano_tpu_torch.ops.preempt import pack_node_major
    node_of = np.array([0, 0, 2, 2, 2, 3])
    res = np.arange(12, dtype=np.float32).reshape(6, 2)
    vres, vvalid, seg_lo = pack_node_major(node_of, res, 5)
    assert vres.shape == (5, 3, 2)
    np.testing.assert_array_equal(vvalid.sum(axis=1), [2, 0, 3, 1, 0])
    np.testing.assert_array_equal(vres[2, :3], res[2:5])
    np.testing.assert_array_equal(seg_lo, [0, 2, 2, 5, 6])
