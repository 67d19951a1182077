"""The port's placement explainer (volcano_tpu_torch/trace/explain.py): the
cases of tests/test_explain.py through the port's Scheduler(device="cpu"),
the prune-width case of tests/test_prune.py, and the same seeded stores
through both packages with the explainer on: placement records, victim
decisions and the aggregates equal field by field.

Not carried over: the `vcctl debug explain` half of the HTTP case (the
port has no vcctl yet), and the simulator's double run and FlakyWatch
cases (the port has no simulator yet); the double run here is two fresh
stores through the port's scheduler.

Tolerance: integers, strings and booleans exact; floats (scores, margins,
coverage, shares, all rounded to 6 decimals by the explainer) within
1e-6 relative or one 1e-6 rounding step: torch sums the coverage's
[G, N] score mass in another order than XLA.
"""

import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import volcano_tpu.apiserver as ref_api
import volcano_tpu.cache as ref_cache
import volcano_tpu.scheduler as ref_sched
from volcano_tpu.models import objects as ref_obj
from volcano_tpu.trace import explain as ref_explain
from volcano_tpu.utils import test_utils as ref_tu
import volcano_tpu_torch.apiserver as port_api
import volcano_tpu_torch.cache as port_cache
import volcano_tpu_torch.scheduler as port_sched
from volcano_tpu_torch.metrics import metrics as m
from volcano_tpu_torch.metrics.server import MetricsServer
from volcano_tpu_torch.models import objects as port_obj
from volcano_tpu_torch.trace import explain, tracer
from volcano_tpu_torch.utils import test_utils as port_tu

CONF = """
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

CONF_EXPLAIN_OFF = CONF + """
configurations:
- name: solver
  arguments:
    explain.enable: "false"
"""

CONF_PREEMPT = """
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

CONF_RECLAIM = """
actions: "reclaim"
tiers:
- plugins:
  - name: priority
  - name: conformance
  - name: gang
- plugins:
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

REF = types.SimpleNamespace(api=ref_api, cache=ref_cache, sched=ref_sched,
                            tu=ref_tu, obj=ref_obj, explain=ref_explain,
                            kw={})
PORT = types.SimpleNamespace(api=port_api, cache=port_cache,
                             sched=port_sched, tu=port_tu, obj=port_obj,
                             explain=explain, kw={"device": "cpu"})


# the caches built by _env and _victim_env, stopped after each test
_CACHES: list = []


@pytest.fixture(autouse=True)
def _clean():
    tracer.reset()
    m.reset()
    for pkg in (REF, PORT):
        pkg.explain.disable()
        pkg.explain.reset()
    yield
    # the caches the test built stop with it (their executor threads)
    while _CACHES:
        _CACHES.pop().stop()
    for pkg in (REF, PORT):
        pkg.explain.disable()
        pkg.explain.reset()
    tracer.disable()
    tracer.reset()
    m.reset()


def _env(n_nodes=4, n_gangs=2, gang=3, conf=CONF, node_cpu="8", pkg=PORT,
         pin=False):
    store = pkg.api.ObjectStore()
    binder = pkg.tu.FakeBinder(store)
    cache = pkg.cache.SchedulerCache(store, binder=binder,
                                     evictor=pkg.tu.FakeEvictor(store))
    cache.run()
    _CACHES.append(cache)
    if pin:
        conf = conf + """
configurations:
- name: solver
  arguments:
    kernel: scan
    mesh.enable: "false"
    prune.enable: "%s"
""" % pin
    sched = pkg.sched.Scheduler(store, scheduler_conf=conf, cache=cache,
                                **pkg.kw)
    store.create("queues", pkg.tu.build_queue("default", weight=1))
    for i in range(n_nodes):
        store.create("nodes", pkg.tu.build_node(f"n{i}", {"cpu": node_cpu,
                                                          "memory": "16Gi"}))
    for j in range(n_gangs):
        store.create("podgroups", pkg.tu.build_pod_group(
            f"pg-{j}", "default", "default", gang, phase="Inqueue"))
        for t in range(gang):
            store.create("pods", pkg.tu.build_pod(
                "default", f"pg-{j}-{t}", "", "Pending",
                {"cpu": "1", "memory": "1Gi"}, groupname=f"pg-{j}"))
    return store, cache, binder, sched


# -- provenance records ------------------------------------------------------


def test_every_placed_gang_gets_a_record():
    explain.enable()
    tracer.enable()
    _, cache, binder, sched = _env(n_gangs=3)
    sched.run_once()
    cache.flush_executors()
    rep = explain.report()
    assert rep["enabled"] and rep["records"] == 3
    for j in range(3):
        rec = rep["jobs"][f"default/pg-{j}"]
        assert rec["kernel"] == "plain"
        assert rec["committed"] is True
        g = rec["groups"][0]
        # the gang's winner is a node its pods really bound to
        bound_nodes = {binder.binds[f"default/pg-{j}-{t}"]
                       for t in range(3)}
        assert g["winner"] in bound_nodes
        assert g["placed"] == g["tasks"] == 3
        # the elimination ladder telescopes exactly to the node axis
        assert g["feasible"] + sum(g["eliminations"].values()) \
            == g["nodes"] == 4
        assert 0.0 <= min(g["coverage"].values())
        assert max(g["coverage"].values()) <= 1.0


def test_elimination_ladder_counts_infeasible_nodes():
    """A node too small for the gang's tasks shows up as a 'fit'
    elimination, and feasible shrinks to the schedulable axis."""
    explain.enable()
    store, cache, _, sched = _env(n_nodes=3, n_gangs=1, gang=2)
    store.create("nodes", port_tu.build_node("tiny", {"cpu": "500m",
                                                      "memory": "1Gi"}))
    sched.run_once()
    cache.flush_executors()
    g = explain.job_record("default/pg-0")["groups"][0]
    assert g["nodes"] == 4
    assert g["feasible"] == 3
    assert g["eliminations"].get("fit") == 1


def test_topk_terms_and_margin():
    explain.enable()
    _, cache, _, sched = _env(n_gangs=1)
    sched.run_once()
    cache.flush_executors()
    g = explain.job_record("default/pg-0")["groups"][0]
    topk = g["topk"]
    assert 1 <= len(topk) <= explain.TOPK
    scores = [e["score"] for e in topk]
    assert scores == sorted(scores, reverse=True)
    assert topk[0]["node"] == g["winner"]
    assert "static" in topk[0]["terms"]
    assert any(k in topk[0]["terms"] for k in ("binpack", "least",
                                               "most", "balanced"))
    assert g["win_margin"] >= 0.0


def test_disabled_mode_records_nothing():
    _, cache, _, sched = _env()
    sched.run_once()
    cache.flush_executors()
    rep = explain.report()
    assert rep["enabled"] is False and rep["records"] == 0
    assert rep["jobs"] == {} and rep["victims"] == []
    assert explain.job_record("default/pg-0") is None


def test_conf_override_forces_off():
    """`explain.enable: "false"` in the solver conf beats the module
    switch."""
    explain.enable()
    _, cache, _, sched = _env(conf=CONF_EXPLAIN_OFF)
    sched.run_once()
    cache.flush_executors()
    assert explain.report()["records"] == 0


# -- aggregates + gauges -----------------------------------------------------


def test_aggregates_and_gauges():
    explain.enable()
    _, cache, _, sched = _env(n_gangs=2)
    sched.run_once()
    cache.flush_executors()
    agg = explain.aggregates()
    assert agg["feasible_nodes"]["count"] == 2
    assert set(agg["topk_coverage"]) == {str(k)
                                         for k in explain.COVERAGE_KS}
    assert agg["fragmentation_ratio"] is not None
    assert 0.0 <= agg["fragmentation_ratio"] <= 1.0
    snap = m.snapshot()
    gauges = {k[0] for k in snap["gauges"]}
    assert m.FRAGMENTATION_RATIO in gauges
    assert m.PADDED_WASTE in gauges
    hists = {k[0] for k in snap["histograms"]}
    assert m.GANG_FEASIBLE_NODES in hists
    assert m.TOPK_SCORE_COVERAGE in hists


def test_fragmentation_ratio_formula():
    """Two nodes at unit [2, 2] per slot: one with a whole free slot, one
    with a stranded half slot: ratio = 1 / 1.5."""
    narr = types.SimpleNamespace(
        names=["a", "b"],
        idle=np.array([[2.0, 2.0], [1.0, 1.0]], np.float32),
        allocatable=np.array([[8.0, 8.0], [8.0, 8.0]], np.float32),
        max_tasks=np.array([4, 4], np.int32))
    assert explain.fragmentation_ratio(narr) == pytest.approx(1 / 1.5)
    narr.idle = narr.allocatable.copy()
    assert explain.fragmentation_ratio(narr) == pytest.approx(1.0)


def test_kernel_subphase_spans():
    """/debug/trace has tensor_build / transfer / execute under the
    kernel span."""
    tracer.enable()
    _, cache, _, sched = _env()
    sched.run_once()
    cache.flush_executors()
    phases = tracer.flat_phases(tracer.last_record())
    assert any(p.endswith("kernel/tensor_build") for p in phases)
    assert any(p.endswith("tensor_build/transfer") for p in phases)
    assert any(p.endswith("kernel/execute") for p in phases)


def test_prune_k_joins_recorded_coverage_widths():
    explain.enable()
    conf = CONF + """
configurations:
- name: solver
  arguments:
    prune.enable: "true"
    prune.k: 32
    explain.enable: "true"
"""
    _, cache, binder, sched = _env(n_nodes=8, n_gangs=6, gang=4, conf=conf)
    sched.run_once()
    cache.flush_executors()
    assert len(binder.binds) == 24
    assert 32 in explain.coverage_ks()
    agg = explain.aggregates()
    assert "32" in agg["topk_coverage"]
    assert 32 in agg["coverage_ks"]
    rec = next(iter(explain.report(limit=0)["jobs"].values()))
    assert "32" in rec["groups"][0]["coverage"]
    # the per-cycle shortlist-loss surface rides the aggregates
    assert agg["prune"]["totals"]["runs"].get("single")


# -- victim provenance -------------------------------------------------------


def _victim_env(pkg=PORT, conf=CONF_PREEMPT, reclaim=False):
    o = pkg.obj
    store = pkg.api.ObjectStore()
    binder = pkg.tu.FakeBinder(store)
    cache = pkg.cache.SchedulerCache(store, binder=binder,
                                     evictor=pkg.tu.FakeEvictor(store))
    cache.run()
    _CACHES.append(cache)
    sched = pkg.sched.Scheduler(store, scheduler_conf=conf, cache=cache,
                                **pkg.kw)
    queues = ("over", "under") if reclaim else ("default", "default")
    for q in sorted(set(queues)):
        store.create("queues", pkg.tu.build_queue(q, weight=1))
    store.create("priorityclasses", o.PriorityClass(
        metadata=o.ObjectMeta(name="high"), value=100))
    store.create("priorityclasses", o.PriorityClass(
        metadata=o.ObjectMeta(name="low"), value=1))
    for i in range(4):
        store.create("nodes", pkg.tu.build_node(f"n{i}", {"cpu": "8",
                                                          "memory": "16Gi"}))
    for j in range(4):
        store.create("podgroups", pkg.tu.build_pod_group(
            f"lo-{j}", "default", queues[0], 1, phase="Running",
            priority_class="low"))
        for t in range(2):
            store.create("pods", pkg.tu.build_pod(
                "default", f"lo-{j}-{t}", f"n{j}", "Running",
                {"cpu": "3", "memory": "6Gi"}, f"lo-{j}"))
    store.create("podgroups", pkg.tu.build_pod_group(
        "hi", "default", queues[1], 2, phase="Inqueue",
        priority_class="high"))
    for t in range(2):
        store.create("pods", pkg.tu.build_pod(
            "default", f"hi-{t}", "", "Pending",
            {"cpu": "4", "memory": "8Gi"}, "hi"))
    return store, cache, binder, sched


def test_victim_decisions_recorded():
    explain.enable()
    store, cache, _, sched = _victim_env()
    sched.run_once()
    cache.flush_executors()
    victims = explain.report()["victims"]
    assert victims, "preemption ran but recorded no victim decisions"
    v = victims[0]
    assert v["preemptor"].startswith("default/hi")
    assert v["mode"] and v["node"].startswith("n")
    assert v["candidates"] > 0 and v["victims"]
    assert v["winning_tier"] is not None
    assert set(v["admissible"]) >= {"priority", "gang", "conformance"}
    assert any(e["selected"] for e in v["verdicts"])
    for e in v["verdicts"]:
        assert set(e["verdicts"]) == set(v["admissible"])


# -- HTTP --------------------------------------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}") as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_debug_explain_over_http():
    explain.enable()
    _, cache, _, sched = _env(n_gangs=2)
    sched.run_once()
    cache.flush_executors()
    server = MetricsServer(port=0)
    server.start()
    try:
        status, payload = _get(server.port, "/debug/explain")
        assert status == 200
        assert payload["enabled"] is True and payload["records"] == 2
        assert set(payload) >= {"jobs", "victims", "aggregates",
                                "fingerprint"}
        rec = payload["jobs"]["default/pg-0"]
        assert rec["groups"][0]["winner"]
        status, single = _get(server.port,
                              "/debug/explain?job=default/pg-1")
        assert status == 200 and single["job"] == "default/pg-1"
        status, err = _get(server.port, "/debug/explain?job=default/nope")
        assert status == 404 and "error" in err
        status, idx = _get(server.port, "/debug")
        assert "/debug/explain" in idx["endpoints"]
    finally:
        server.stop()


def test_debug_explain_disabled_mode_over_http():
    server = MetricsServer(port=0)
    server.start()
    try:
        status, payload = _get(server.port, "/debug/explain")
        assert status == 200
        assert payload["enabled"] is False and payload["records"] == 0
        status, err = _get(server.port, "/debug/explain?job=default/x")
        assert status == 404 and err["enabled"] is False
    finally:
        server.stop()


def test_fingerprint_bit_identical_across_double_run():
    explain.enable()
    fps = []
    for _ in range(2):
        explain.reset()
        _, cache, _, sched = _env(n_gangs=3)
        sched.run_once()
        cache.flush_executors()
        assert explain.report()["records"] == 3
        fps.append(explain.fingerprint())
    assert fps[0] == fps[1]


# -- the same stores through both packages ------------------------------------


def _same(a, b, path="record"):
    """a equals b: ints, strings, booleans and None exactly; floats
    within 1e-6 relative or one 1e-6 rounding step."""
    if isinstance(b, float) and not isinstance(a, bool):
        assert isinstance(a, (int, float)), (path, a, b)
        assert abs(a - b) <= max(1e-6 * abs(b), 1e-6) + 1e-12, (path, a, b)
    elif isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, a, b)
        for k in b:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _explained(pkg, env, **kw):
    pkg.explain.reset()
    pkg.explain.enable()
    store, cache, _, sched = env(pkg=pkg, **kw)
    if env is _env:
        store.create("nodes", pkg.tu.build_node("tiny", {"cpu": "500m",
                                                         "memory": "1Gi"}))
    sched.run_once()
    cache.flush_executors()
    rep = pkg.explain.report(limit=0)
    pkg.explain.disable()
    return rep


@pytest.mark.parametrize("prune", ["off", "true"])
def test_place_records_match_reference(prune):
    ref = _explained(REF, _env, n_nodes=6, n_gangs=4, pin=prune)
    port = _explained(PORT, _env, n_nodes=6, n_gangs=4, pin=prune)
    assert port["records"] == ref["records"] == 4
    for rep in (ref, port):
        rep.pop("fingerprint")
        for rec in rep["jobs"].values():
            # the kernel's route ("plain" here, a JAX tier there), the
            # session uid and the flight recorder's global sequence
            rec.pop("kernel")
            rec.pop("uid")
            rec.pop("cycle")
    _same(port, ref)


@pytest.mark.parametrize("conf,reclaim", [(CONF_PREEMPT, False),
                                          (CONF_RECLAIM, True)])
def test_victim_records_match_reference(conf, reclaim):
    ref = _explained(REF, _victim_env, conf=conf, reclaim=reclaim)
    port = _explained(PORT, _victim_env, conf=conf, reclaim=reclaim)
    assert ref["victims"], "no victim decision recorded"
    _same(port["victims"], ref["victims"], "victims")
