"""Candidate pruning in the port (ops/prune.py, trace/explain.py and the
solver's pruned place) against the JAX package.

Whole cycles: each package builds its own store from the same builders and
runs ``Scheduler.run_once``; the binds, PodGroup phases and conditions must
be equal, and so must every pruned place's summary (level, k, k_max, pairs,
union, nodes, truncated pairs, fallback and its pairs exactly; coverage
within 1e-6). The reference runs on one device with its scan kernel
(``kernel: scan``, ``mesh.enable: "false"``) except in the default-conf
cycles, where only the mesh is pinned off (pytest's conftest gives JAX
eight virtual CPU devices; the port runs on one card).

Functions: the fused top-k pass, the score rows and ``distill`` on seeded
inputs with ties, +-0.0 and infeasible entries; indices and unions exact,
scores to the tolerance of tests/test_torch_fit_score.py (XLA:CPU may
contract a multiply-add), coverage within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cycle import CASES as CYCLE_CASES
from tests.test_torch_cycle import PORT, REF, make_spec, outcome, populate
from tests.test_torch_cycle import conf as cycle_conf
from volcano_tpu.ops import prune as ref_prune
from volcano_tpu.ops.score import ScoreWeights as RefWeights
from volcano_tpu.trace import explain as ref_explain
from volcano_tpu_torch.ops import prune
from volcano_tpu_torch.ops.score import ScoreWeights
from volcano_tpu_torch.trace import explain

ZONE = "topology.kubernetes.io/zone"
COV_TOL = 1e-6
SCORE_RTOL, SCORE_ATOL = 1e-6, 1e-4
EXACT_KEYS = ("level", "k", "k_max", "pairs", "union", "nodes",
              "truncated_pairs", "fallback", "fallback_pairs")

BASE_CONF = """
actions: "enqueue, allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""


def solver_conf(base=BASE_CONF, pin_kernel=True, **args):
    """``base`` with a solver section: the reference on one device (and on
    its scan kernel with ``pin_kernel``), plus ``args``."""
    pin = {"kernel": "scan"} if pin_kernel else {}
    args = {**pin, "mesh.enable": "false", **args}
    lines = "\n".join(f'    {k}: "{v}"' for k, v in args.items())
    return base + f"configurations:\n- name: solver\n  arguments:\n{lines}\n"


# -- clusters (tests/test_prune.py's, built by either package) ----------------

def _queue(pkg, store):
    q = pkg.tu.build_queue("default", weight=1)
    q.metadata.creation_timestamp = 1.0
    store.create("queues", q)


def _node(pkg, store, name, alloc, labels=None):
    node = pkg.tu.build_node(name, alloc, labels=labels)
    node.metadata.creation_timestamp = 1.0
    store.create("nodes", node)


def _gang(pkg, store, j, name, size, req, phase="Inqueue", node="",
          pod_phase="Pending", spread=False):
    pg = pkg.tu.build_pod_group(name, "ns1", "default", size, phase=phase)
    pg.metadata.creation_timestamp = 10.0 + j
    store.create("podgroups", pg)
    for t in range(size):
        pod = pkg.tu.build_pod("ns1", f"{name}-p{t}", node, pod_phase, req,
                               groupname=name)
        pod.metadata.creation_timestamp = 10.0 + j
        if spread:
            pod.spec.topology_spread = [pkg.obj.TopologySpreadConstraint(
                max_skew=1, topology_key=ZONE,
                when_unsatisfiable="DoNotSchedule")]
        store.create("pods", pod)


def uniform_cluster(pkg, store, n_nodes=16, n_jobs=6, gang=4):
    _queue(pkg, store)
    for i in range(n_nodes):
        _node(pkg, store, f"node-{i}", {"cpu": "16", "memory": "32Gi"})
    for j in range(n_jobs):
        _gang(pkg, store, j, f"pg-{j}", gang, {"cpu": "2", "memory": "4Gi"})


def constrained_cluster(pkg, store, zones=4, per_zone=4, n_jobs=8, gang=4):
    """Zoned nodes and a hard-spread / plain mix: the slot tensors engage,
    so shortlists are distilled per (gang, domain) pair."""
    _queue(pkg, store)
    for i in range(zones * per_zone):
        _node(pkg, store, f"node-{i}", {"cpu": "16", "memory": "32Gi"},
              labels={ZONE: f"zone-{i // per_zone}"})
    for j in range(n_jobs):
        _gang(pkg, store, j, f"pg-{j}", gang, {"cpu": "2", "memory": "4Gi"},
              spread=j % 2 == 0)


def tight_cluster(pkg, store):
    """Two identical nodes and two single-task jobs that each need more
    than half a node: a k=1 shortlist holds only node-0 for both."""
    _queue(pkg, store)
    for i in range(2):
        _node(pkg, store, f"node-{i}", {"cpu": "16", "memory": "32Gi"})
    for j in range(2):
        _gang(pkg, store, j, f"pg-{j}", 1, {"cpu": "10", "memory": "8Gi"})


def skewed_cluster(pkg, store):
    """Three nodes at distinct fill levels: distinct binpack scores, so a
    top-1 shortlist covers little of the feasible score mass."""
    _queue(pkg, store)
    for i, used in enumerate(("2", "6", "10")):
        _node(pkg, store, f"node-{i}", {"cpu": "16", "memory": "32Gi"})
        _gang(pkg, store, i, f"fill-{i}", 1, {"cpu": used, "memory": "1Gi"},
              phase="Running", node=f"node-{i}", pod_phase="Running")
    _gang(pkg, store, 9, "pg-0", 1, {"cpu": "2", "memory": "2Gi"})


def oversized_cluster(pkg, store):
    """Every pod asks for more than any node has: nothing is feasible."""
    _queue(pkg, store)
    for i in range(4):
        _node(pkg, store, f"node-{i}", {"cpu": "16", "memory": "32Gi"})
    for j in range(2):
        _gang(pkg, store, j, f"pg-{j}", 2, {"cpu": "40", "memory": "8Gi"})


def big_batch(pkg, store):
    uniform_cluster(pkg, store, n_nodes=32, n_jobs=24, gang=4)


def synth_cluster(n_nodes, n_jobs, gang):
    def build(pkg, store):
        pkg.synth.populate_store(store, n_nodes=n_nodes, n_jobs=n_jobs,
                                 gang_size=gang)
    return build


# -- the harness --------------------------------------------------------------

def run(pkg, build, conf_text, **kw):
    """(outcome, the pruned places' summaries, the port's places or None)
    of one cycle of ``pkg`` on a store filled by ``build``."""
    store = pkg.Store()
    build(pkg, store)
    cache = pkg.Cache(store, binder=pkg.tu.FakeBinder(store))
    cache.run()
    sched = pkg.Scheduler(store, scheduler_conf=conf_text, cache=cache, **kw)
    if pkg is REF:
        ref_explain.reset()
    sched.run_once()
    cache.flush_executors()
    cache.stop()
    if pkg is REF:
        return outcome(store), ref_explain.prune_report()["recent"], None
    places = sched.last_cycle["places"]
    return outcome(store), [pl["prune"] for pl in places
                            if pl["prune"] is not None], places


def run_port(build, conf_text):
    return run(PORT, build, conf_text, device="cpu")


def assert_summaries(port, ref):
    assert len(port) == len(ref), (port, ref)
    for p, r in zip(port, ref):
        assert {k: p[k] for k in EXACT_KEYS} == \
            {k: r[k] for k in EXACT_KEYS}, (p, r)
        # the summaries round coverage to 6 decimals: two values within
        # 1e-6 may round one step apart
        for key in ("coverage_min", "coverage_mean"):
            assert round(abs(p[key] - r[key]), 9) <= COV_TOL, (key, p, r)


def assert_same(build, conf_text, n_binds=None):
    """Both packages' cycles on ``build``'s cluster: equal outcome and
    equal prune summaries. Returns the port's (outcome, summaries,
    places)."""
    ref = run(REF, build, conf_text)
    port = run_port(build, conf_text)
    (rb, rp, rc), (pb, pp, pc) = ref[0], port[0]
    assert pb == rb, sorted(set(pb.items()) ^ set(rb.items()))[:10]
    assert pp == rp
    assert pc == rc
    assert_summaries(port[1], ref[1])
    if n_binds is not None:
        assert len(pb) == n_binds
    return port


def served(summaries):
    return bool(summaries) and all(s["served"] and s["fallback"] is None
                                   for s in summaries)


# -- pruned against unpruned, and against the reference -----------------------

@pytest.mark.parametrize("k", [4, 16, 64, 256])
def test_uniform_fleet_bind_parity(k):
    """Across the k sweep (256 covers k >= N) the pruned run serves, binds
    what the reference's pruned run binds and what the port's unpruned run
    binds."""
    (binds, _, _), summaries, _ = assert_same(
        uniform_cluster, solver_conf(**{"prune.enable": "true",
                                        "prune.k": k}), n_binds=24)
    assert served(summaries)
    dense = run_port(uniform_cluster, solver_conf(**{"prune.enable": "off"}))
    assert dense[0][0] == binds and dense[1] == []


@pytest.mark.parametrize("k", [4, 16, 64])
def test_constrained_fleet_bind_parity(k):
    """The zoned hard-spread fleet: shortlists per (gang, domain) pair."""
    (binds, _, _), summaries, places = assert_same(
        constrained_cluster, solver_conf(**{"prune.enable": "true",
                                            "prune.k": k}), n_binds=32)
    assert served(summaries)
    assert places[0]["slots"] > 0
    assert summaries[0]["pairs"] > 8          # more pairs than gangs
    dense = run_port(constrained_cluster,
                     solver_conf(**{"prune.enable": "off"}))
    assert dense[0][0] == binds


def test_pruned_double_run_deterministic():
    conf_text = solver_conf(**{"prune.enable": "true", "prune.k": 8})
    a, b = (run_port(constrained_cluster, conf_text) for _ in range(2))

    def kept(summaries):
        return [{k: v for k, v in s.items() if k != "distill_ms"}
                for s in summaries]
    assert a[0] == b[0] and a[0][0]
    assert kept(a[1]) == kept(b[1]) and a[1]


def test_off_restores_exact_path(monkeypatch):
    """``prune.enable: off`` never distills."""
    def boom(*a, **k):
        raise AssertionError("distill ran with prune.enable: off")
    monkeypatch.setattr(prune, "distill", boom)
    (binds, _, _), summaries, places = run_port(
        uniform_cluster, solver_conf(**{"prune.enable": "off"}))
    assert len(binds) == 24 and summaries == []
    assert all(pl["launches"] == 1 for pl in places)


def test_auto_floor_keeps_small_fleets_unpruned(monkeypatch):
    """The default auto mode stays off below prune.min_nodes."""
    def boom(*a, **k):
        raise AssertionError("distill ran below the auto floor")
    monkeypatch.setattr(prune, "distill", boom)
    (binds, _, _), summaries, _ = run_port(uniform_cluster, BASE_CONF)
    assert len(binds) == 24 and summaries == []


# -- the loss guards ----------------------------------------------------------

TIGHT = {"prune.enable": "true", "prune.k": 1, "prune.coverage_floor": 0.0,
         "prune.demand_aware": "off"}


def test_exhausted_shortlist_red_without_guard():
    """With the guard off the k=1 shortlist loses job 2's placement in
    both packages: the guard is load-bearing."""
    (binds, _, _), summaries, places = assert_same(
        tight_cluster, solver_conf(**TIGHT, **{"prune.guard": "off"}),
        n_binds=1)
    assert served(summaries) and places[0]["launches"] == 1
    dense = run_port(tight_cluster, solver_conf(**{"prune.enable": "off"}))
    assert len(dense[0][0]) == 2


def test_exhausted_shortlist_green_with_guard():
    """With the guard the place falls back after the reduced run: two
    launches, both binds, as the reference."""
    _, summaries, places = assert_same(tight_cluster, solver_conf(**TIGHT),
                                       n_binds=2)
    assert summaries[0]["fallback"] == "shortlist_exhausted"
    assert not summaries[0]["served"]
    assert places[0]["launches"] == 2 and len(places[0]["launch_ms"]) == 2


def test_low_coverage_falls_back_before_the_kernel():
    _, summaries, places = assert_same(
        skewed_cluster, solver_conf(**{"prune.enable": "true", "prune.k": 1,
                                       "prune.coverage_floor": 0.99,
                                       "prune.demand_aware": "off"}),
        n_binds=4)
    assert summaries[0]["fallback"] == "low_coverage"
    assert summaries[0]["fallback_pairs"] == 1
    assert summaries[0]["coverage_min"] < 0.99
    assert places[0]["launches"] == 1


def test_demand_aware_widening_avoids_exhaustion():
    """Demand past k nodes widens the shortlist: every task places off
    the pruned run, no fallback."""
    _, summaries, _ = assert_same(
        big_batch, solver_conf(**{"prune.enable": "true", "prune.k": 2}),
        n_binds=96)
    assert served(summaries)
    assert summaries[0]["k_max"] > 2


@pytest.mark.parametrize("case", ["shortlist_exhausted", "low_coverage",
                                  "wide_union", "empty_union"])
def test_fallback_reasons_in_stats(case):
    """Every fallback reason, read from the place's stats entry, equals
    the reference's, with the launches the place made."""
    build, args = {
        "shortlist_exhausted": (tight_cluster, TIGHT),
        "low_coverage": (skewed_cluster, {
            "prune.enable": "true", "prune.k": 1,
            "prune.coverage_floor": 0.99, "prune.demand_aware": "off"}),
        "wide_union": (uniform_cluster, {"prune.min_nodes": 4,
                                         "prune.k": 16}),
        "empty_union": (oversized_cluster, {"prune.enable": "true"}),
    }[case]
    _, summaries, places = assert_same(build, solver_conf(**args))
    pruned = [pl for pl in places if pl["prune"] is not None]
    assert pruned and pruned[0]["prune"]["fallback"] == case
    assert case in prune.FALLBACK_REASONS
    for pl in pruned:
        want = 2 if pl["prune"]["fallback"] == "shortlist_exhausted" else 1
        assert pl["launches"] == want


def test_crash_inside_the_distill_propagates(monkeypatch):
    """No crash fallback: an exception in the distillation fails the
    cycle instead of running full width."""
    def boom(*a, **k):
        raise RuntimeError("fused pass failed")
    monkeypatch.setattr(explain, "fused", boom)
    with pytest.raises(RuntimeError, match="fused pass failed"):
        run_port(uniform_cluster, solver_conf(**{"prune.enable": "true"}))


@pytest.mark.parametrize("case", sorted(CYCLE_CASES))
def test_varied_fleets_prune_as_the_reference(case):
    """tests/test_torch_cycle.py's cycle cases (varied node sizes,
    selectors and taints, queues, namespaces, running, releasing and
    best-effort pods) under forced pruning with k = 8 and no coverage
    floor: the reduced run serves where its shortlists hold, else the
    exhaustion guard discards it, in both packages alike."""
    c = CYCLE_CASES[case]
    spec = make_spec(sorted(CYCLE_CASES).index(case) + 11, **c["kw"])
    conf_text = cycle_conf(**c["conf"]).replace(
        'prune.enable: "off"',
        'prune.enable: "true", prune.k: 8, prune.coverage_floor: 0.0')
    _, summaries, _ = assert_same(
        lambda pkg, store: populate(pkg, store, spec), conf_text)
    assert summaries and all(
        s["fallback"] in (None, "shortlist_exhausted") for s in summaries)


# -- the reference's default conf at full width -------------------------------

@pytest.mark.parametrize("n_nodes,n_jobs,gang", [(4096, 600, 8),
                                                 (5000, 900, 4)])
def test_default_conf_cycle_prunes_as_the_reference(n_nodes, n_jobs, gang):
    """populate_store under the reference's DEFAULT_SCHEDULER_CONF, auto
    mode: the reduced run serves in both packages, bind for bind."""
    from volcano_tpu.framework.conf import DEFAULT_SCHEDULER_CONF
    (binds, _, _), summaries, _ = assert_same(
        synth_cluster(n_nodes, n_jobs, gang),
        solver_conf(DEFAULT_SCHEDULER_CONF, pin_kernel=False),
        n_binds=n_jobs * gang)
    assert served(summaries)
    assert summaries[0]["nodes"] == n_nodes
    assert summaries[0]["union"] < 0.6 * n_nodes


# -- the functions on seeded inputs -------------------------------------------

class _Batch:
    """The TaskBatch fields ops/prune.distill reads."""

    def __init__(self, group_req, task_group, task_slot=None, slot_rows=None):
        self.group_req = np.asarray(group_req, np.float32)
        self.task_group = np.asarray(task_group, np.int32)
        self.task_valid = np.ones(len(task_group), bool)
        self.tasks = list(range(len(task_group)))
        self.n_groups = self.group_req.shape[0]
        self.task_slot = task_slot
        self.slot_rows = slot_rows


class _Narr:
    """The NodeArrays fields ops/prune.distill reads."""

    def __init__(self, idle, alloc, max_tasks=None, n_tasks=None):
        self.idle = np.asarray(idle, np.float32)
        self.allocatable = np.asarray(alloc, np.float32)
        n = self.idle.shape[0]
        self.names = [f"n{i}" for i in range(n)]
        self.max_tasks = np.zeros(n, np.int32) if max_tasks is None \
            else max_tasks
        self.n_tasks = np.zeros(n, np.int32) if n_tasks is None else n_tasks


def _weights(r, signed_zero=False):
    """(port, reference) weights: binpack, least and balanced on; with
    ``signed_zero`` every weight -0.0, so that a score is +0.0 or -0.0 as
    its static entry is."""
    kw = dict(binpack=-0.0, least=-0.0, most=-0.0, balanced=-0.0) \
        if signed_zero else dict(binpack=1.0)
    br = np.full(r, -0.0 if signed_zero else 1.0, np.float32)
    return ScoreWeights.make(r, binpack_res=br, **kw), \
        RefWeights.make(r, binpack_res=br, **kw)


def _problem(case, seed):
    """(batch, narr, gmask, static, signed_zero) of a seeded case."""
    rng = np.random.default_rng(seed)
    n, g, r = 96, 12, 2
    alloc = np.tile(np.array([[16000.0, 65536.0]], np.float32), (n, 1))
    idle = alloc.copy()
    gmask = np.ones((g, n), bool)
    static = np.zeros((g, n), np.float32)
    req = np.tile(np.array([[2000.0, 4096.0]], np.float32), (g, 1))
    task_group = np.repeat(np.arange(g), 4)
    slot = None
    if case == "varied":
        idle = (alloc * rng.integers(1, 9, (n, 1)) / 8).astype(np.float32)
        req = rng.integers(1, 5, (g, r)).astype(np.float32) * 1000
        gmask = rng.uniform(size=(g, n)) < 0.7
        gmask[3] = False                     # a group with no node
        gmask[4, :5] = True
        gmask[4, 5:] = False                 # fewer feasible nodes than k
        static = rng.integers(0, 4, (g, n)).astype(np.float32)
        task_group = np.repeat(np.arange(g), rng.integers(1, 30, g))
    elif case == "signed_zero":
        static = np.where(rng.uniform(size=(g, n)) < 0.5, 0.0,
                          -0.0).astype(np.float32)
    elif case == "slots":
        task_group = np.repeat(np.arange(g), 8)
        rows = np.zeros((5, n), bool)
        for d in range(4):
            rows[d, d::4] = True
        rows[4] = True
        task_slot = (np.arange(len(task_group)) % 5).astype(np.int32)
        slot = (task_slot, rows)
    # "ties": identical nodes and rows, every score equal
    batch = _Batch(req, task_group, *(slot or (None, None)))
    return batch, _Narr(idle, alloc), gmask, static, case == "signed_zero"


@pytest.mark.parametrize("case", ["varied", "ties", "signed_zero", "slots"])
@pytest.mark.parametrize("k,demand,dedupe", [(4, "on", False),
                                             (8, "off", False),
                                             (4, "on", True)])
def test_distill_matches_reference(case, k, demand, dedupe):
    batch, narr, gmask, static, signed_zero = _problem(case, 7 + k)
    w, rw = _weights(batch.group_req.shape[1], signed_zero)
    conf = prune.PruneConf(mode="true", k=k, demand_aware=demand == "on")
    rconf = ref_prune.PruneConf(mode="true", k=k,
                                demand_aware=demand == "on")
    got = prune.distill(batch, narr, torch.from_numpy(gmask),
                        torch.from_numpy(static), w, conf, dedupe=dedupe)
    want = ref_prune.distill(batch, narr, jnp.asarray(gmask),
                             jnp.asarray(static), rw, rconf, dedupe=dedupe)
    np.testing.assert_array_equal(got.union, want.union)
    np.testing.assert_array_equal(got.feasible, want.feasible)
    np.testing.assert_array_equal(got.count, want.count)
    np.testing.assert_array_equal(got.pair_of_task, want.pair_of_task)
    np.testing.assert_allclose(got.coverage, want.coverage, rtol=0,
                               atol=COV_TOL)
    assert got.k_max == want.k_max and got.u_pad == want.u_pad
    assert got.pre_guard() == want.pre_guard()
    assert_summaries([got.summary()], [want.summary()])
    assert got.union.size > 0
    if case == "signed_zero":
        # the scores are the static entries' signed zeros
        rows = prune.score_rows(
            torch.from_numpy(batch.group_req), torch.from_numpy(narr.idle),
            torch.from_numpy(narr.allocatable), torch.from_numpy(static),
            torch.from_numpy(gmask), w).numpy()
        np.testing.assert_array_equal(np.signbit(rows), np.signbit(static))


def _rows(seed, b=16, n=200, r=3):
    rng = np.random.default_rng(seed)
    alloc = rng.choice([8000.0, 16000.0, 64000.0], (n, r)).astype(np.float32)
    idle = (alloc * rng.integers(0, 9, (n, r)) / 8).astype(np.float32)
    req = (rng.integers(0, 5, (b, r)) * 500).astype(np.float32)
    static = rng.choice([0.0, -0.0, 1.0, 2.5], (b, n)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) < 0.6
    mask[0] = False
    mask[1, 3:] = False
    static[2] = 0.0
    return req, idle, alloc, static, mask


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 16), (2, 64), (3, 300)])
def test_fused_matches_topk_fn(seed, k):
    req, idle, alloc, static, mask = _rows(seed)
    w, rw = _weights(req.shape[1])
    got = explain.fused(*(torch.from_numpy(x) for x in
                          (req, idle, alloc, static, mask)), w, k)
    want = ref_explain._topk_fn(k, (k,))(*(jnp.asarray(x) for x in (
        req, idle, alloc, static, mask)), rw)
    feas, vals, idx, cov = (x.numpy() for x in got)
    np.testing.assert_array_equal(feas, np.asarray(want[0]))
    np.testing.assert_array_equal(idx, np.asarray(want[2]))
    np.testing.assert_allclose(vals, np.asarray(want[1]), rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(cov, np.asarray(want[3])[:, 0], rtol=0,
                               atol=COV_TOL)
    assert cov[0] == 1.0 and feas[0] == 0


@pytest.mark.parametrize("seed", range(2))
def test_score_rows_match_score_rows_fn(seed):
    req, idle, alloc, static, mask = _rows(seed + 10)
    w, rw = _weights(req.shape[1])
    got = prune.score_rows(*(torch.from_numpy(x) for x in
                             (req, idle, alloc, static, mask)), w).numpy()
    want = np.asarray(ref_prune._score_rows_fn()(*(jnp.asarray(x) for x in (
        req, idle, alloc, static, mask)), rw))
    np.testing.assert_array_equal(got == np.float32(prune.NEG), ~mask)
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("row", [
    [0.0, -0.0, 0.0, -0.0, 1.0, 1.0],
    [5.0] * 9,
    [-1e30, -1e30, 3.0, -1e30, -2.0, -0.0, 1e-40, -1e-40],
])
def test_top_k_ranks_as_lax_top_k(row):
    """+0.0 above -0.0, equal values in index order, NEG entries last."""
    x = np.asarray([row, row[::-1]], np.float32)
    want_v, want_i = jax.lax.top_k(x, x.shape[1])
    got_v, got_i = explain.top_k(torch.from_numpy(x), x.shape[1])
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))
