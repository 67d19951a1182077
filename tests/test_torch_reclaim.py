"""The port's reclaim action held against the JAX package's.

The scenarios of tests/test_reclaim_action.py, each built once per package
from one description (tests/test_torch_victims.py's ``Scenario``) and run
under both ``victims.kernel: auto`` and ``off``; then whole two-cycle runs
of ``utils.synth.populate_reclaim_store`` (the reference harness's
reclamation shape, volcano_tpu/bench_suite.py:478-520) at 400 nodes, 50
over-share gangs and 25 reclaiming gangs, the port's
``Scheduler(store, device="cpu")`` against ``volcano_tpu.scheduler.
Scheduler``. Tolerance: exact. Evicted pod keys (in eviction order),
pipelined task -> node, PodGroup phases and binds must be equal.
"""

import numpy as np
import pytest

import volcano_tpu.scheduler as ref_sched_mod
import volcano_tpu_torch.scheduler as port_sched_mod
from tests.test_torch_preempt import cycle_cmd, run_cycles, store_view
from tests.test_torch_victims import (PORT, Scenario, assert_same, build,
                                      with_mode)
from volcano_tpu.apiserver import ObjectStore as RefStore
from volcano_tpu.cache import SchedulerCache as RefCache
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu_torch.apiserver import ObjectStore as PortStore
from volcano_tpu_torch.cache import SchedulerCache as PortCache
from volcano_tpu_torch.framework.victims import CROSS_QUEUE, PreemptContext
from volcano_tpu_torch.utils import test_utils as port_tu
from volcano_tpu_torch.utils.synth import populate_reclaim_store

CONF = """
actions: "reclaim"
tiers:
- plugins:
  - name: conformance
  - name: gang
  - name: proportion
"""

WALK_CONF = """
actions: "reclaim"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: proportion
  - name: nodeorder
"""


def three_victims(q1_reclaimable=True, claimer_queue="q2") -> Scenario:
    """Node n1 (3 CPU) full of q1's three running pods; one pending pod of
    ``claimer_queue``."""
    return Scenario(
        queues=[("q1", 1, q1_reclaimable), ("q2", 1, True)],
        nodes=[("n1", "3", "3Gi")],
        podgroups=[("pg1", "c1", "q1", 1, "Inqueue", ""),
                   ("pg2", "c1", claimer_queue, 1, "Inqueue", "")],
        pods=[("c1", f"preemptee{i}", "n1", "Running", "1", "1Gi", "pg1")
              for i in (1, 2, 3)]
        + [("c1", "preemptor1", "", "Pending", "1", "1Gi", "pg2")])


def walk_until_covered() -> Scenario:
    """node-a's two small q1 victims cannot cover the 10-CPU request;
    node-b's big one can (reclaim.go:149-181: evictions stick)."""
    rp = "Running"
    return Scenario(
        queues=[("q1", 1, True), ("q2", 1, True)],
        nodes=[("node-a", "11", "64Gi"), ("node-b", "12", "64Gi")],
        podgroups=[("v1", "ns1", "q1", 1, rp, ""), ("v2", "ns1", "q1", 1, rp, ""),
                   ("v3", "ns1", "q1", 1, rp, ""),
                   ("rc", "ns1", "q2", 1, "Inqueue", ""),
                   ("rc2", "ns1", "q2", 1, "Inqueue", "")],
        pods=[("ns1", "va-1", "node-a", rp, "1", "1Gi", "v1"),
              ("ns1", "va-2", "node-a", rp, "1", "1Gi", "v2"),
              ("ns1", "vb-1", "node-b", rp, "12", "1Gi", "v3"),
              ("ns1", "rc-1", "", "Pending", "10", "1Gi", "rc"),
              ("ns1", "rc2-1", "", "Pending", "10", "1Gi", "rc2")])


SCENARIOS = {
    # test_reclaim_action.py: (conf, scenario, evictions)
    "reclaim_from_overused_queue": (CONF, three_victims(), 1),
    "no_reclaim_from_unreclaimable_queue": (
        CONF, three_victims(q1_reclaimable=False), 0),
    "no_reclaim_within_own_queue": (CONF, three_victims(claimer_queue="q1"),
                                    0),
    "reclaim_walks_nodes_until_covered": (WALK_CONF, walk_until_covered(),
                                          None),
}


@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_reclaim_matches_reference(case, mode):
    conf, sc, n_evicts = SCENARIOS[case]
    evicts, pipelined, _, ssn = assert_same(with_mode(conf, mode), sc,
                                            ["reclaim"], n_evicts)
    if case == "reclaim_from_overused_queue":
        assert pipelined == {"c1/preemptor1": "n1"}
    if case == "reclaim_walks_nodes_until_covered":
        assert pipelined.get("ns1/rc-1") == "node-b"
        assert "ns1/vb-1" in evicts
    if evicts:
        path = "python" if mode == "off" else "kernel"
        assert ssn.victim_runs.get(path, 0) > 0, ssn.victim_runs


def test_pipeline_invalidates_cross_queue_persisted_rejections():
    """A reclaimer pipeline raises its queue's live allocated
    (proportion), which can flip that queue's victims eligible for OTHER
    reclaimers: apply_pipeline clears persisted cross-queue rejections on
    every node holding that queue's candidates (and only those), and
    drops a resumed cross-queue walk."""
    sc = Scenario(
        queues=[("q1", 1, True), ("q2", 1, True)],
        nodes=[("n1", "3", "3Gi"), ("n2", "3", "3Gi")],
        podgroups=[("pg1", "c1", "q1", 1, "Inqueue", ""),
                   ("pg2", "c1", "q2", 1, "Inqueue", "")],
        pods=[("c1", "victim-a", "n1", "Running", "1", "1Gi", "pg2"),
              ("c1", "victim-b", "n2", "Running", "1", "1Gi", "pg1"),
              ("c1", "claimer", "", "Pending", "1", "1Gi", "pg2")])
    h = build(PORT, CONF, sc)
    ssn = h.open_session()
    job2 = next(j for j in ssn.jobs.values() if j.name == "pg2")
    claimer = next(t for t in job2.tasks.values() if t.name == "claimer")
    ctx = PreemptContext(ssn, [(job2, [claimer])])
    assert ctx._persist_ok_reclaim
    n_real = len(ctx.narr.names)
    ctx._persistent_reject[(CROSS_QUEUE, b"req-a", 0, 0)] = \
        np.ones(n_real, bool)
    ctx._persistent_reject[(CROSS_QUEUE, b"req-b", 1, 1)] = \
        np.ones(n_real, bool)
    ctx._walk_key = (CROSS_QUEUE, "some-task")
    ctx._walk_masked = np.zeros(n_real)
    q2_code = ctx.victims.queue_code["q2"]
    node_a = ctx.node_idx["n1"]
    ctx.apply_pipeline("n2", claimer)
    for pkey, mask in ctx._persistent_reject.items():
        if pkey[3] != q2_code:
            assert not mask[node_a], pkey
        else:
            expected = np.ones(n_real, bool)
            expected[ctx.node_idx["n2"]] = False
            assert (mask == expected).all(), pkey
    assert ctx._walk_key is None
    h.close_session()


# -- whole cycles at 400 nodes ---------------------------------------------------

CYCLE_CONF = """
actions: "enqueue, allocate, reclaim, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
configurations:
- name: solver
  arguments: {kernel: scan, prune.enable: "off", mesh.enable: "false"%s}
"""
SMALL = dict(n_nodes=400, n_running=50, n_pending=25)


def ref_populate_reclaim(store, n_nodes, n_running, n_pending):
    """The reference harness's reclamation shape
    (bench_suite.config_reclaim) with the JAX package's builders."""
    tu = ref_tu
    store.create("queues", tu.build_queue("q-over", weight=1))
    store.create("queues", tu.build_queue("q-under", weight=1))
    for i in range(n_nodes):
        store.create("nodes", tu.build_node(f"node-{i}",
                                            {"cpu": "16", "memory": "32Gi"}))
    for j in range(n_running):
        store.create("podgroups", tu.build_pod_group(
            f"ov-{j}", "ns1", "q-over", 8, phase="Running"))
        for t in range(8):
            store.create("pods", tu.build_pod(
                "ns1", f"ov-{j}-{t}", f"node-{(j * 8 + t) % n_nodes}",
                "Running", {"cpu": "14", "memory": "28Gi"}, f"ov-{j}"))
    for j in range(n_pending):
        store.create("podgroups", tu.build_pod_group(
            f"un-{j}", "ns1", "q-under", 8, phase="Inqueue"))
        for t in range(8):
            store.create("pods", tu.build_pod(
                "ns1", f"un-{j}-{t}", "", "Pending",
                {"cpu": "8", "memory": "16Gi"}, f"un-{j}"))


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_reclaim_cycles_match_reference(mode, monkeypatch):
    """Two cycles on the reclamation shape: the first evicts and
    pipelines q-under's tasks onto q-over's nodes, the second binds
    q-under's gangs onto the nodes the evictions freed."""
    opt = ', victims.kernel: "off"' if mode == "off" else ""
    conf = CYCLE_CONF % opt
    ref_store, port_store = RefStore(), PortStore()
    ref_populate_reclaim(ref_store, **SMALL)
    populate_reclaim_store(port_store, **SMALL)
    assert store_view(port_store) == store_view(ref_store)
    ref = run_cycles(ref_sched_mod, ref_store, RefCache, ref_tu, conf,
                     monkeypatch)
    port = run_cycles(port_sched_mod, port_store, PortCache, port_tu, conf,
                      monkeypatch, device="cpu")
    for c, (r, p) in enumerate(zip(ref, port)):
        assert p[0] == r[0], (c, len(p[0]), len(r[0]))
        assert p[1] == r[1], c
        assert p[2] == r[2], c
        assert p[3] == r[3], c
    (ev1, pipe1, _, _, split1), (_, _, binds2, _, _) = port
    assert len(ev1) == 58 and pipe1
    path = "python" if mode == "off" else "kernel"
    assert split1["victim_runs"][path] > 0, split1["victim_runs"]
    assert sum(split1["victim_runs"].values()) == \
        split1["victim_runs"][path]
    # the evictions freed whole nodes: the second cycle's allocate binds
    # q-under's gangs there
    assert any(k.startswith("ns1/un-") for k in binds2)
    assert store_view(port_store) == store_view(ref_store)



def test_cycle_cmd_reclaim_on_cpu():
    """``cmd.cycle --scenario reclaim``: one JSON line with reclaim_ms,
    the evictions, the pipelined tasks and the victim-selection paths."""
    cold = cycle_cmd("reclaim")
    assert cold["evictions"] == cold["pipelined"] == 10
    assert cold["reclaim_ms"] > 0
    assert cold["victim_runs"]["kernel"] > 0
    assert cold["victim_runs"]["python"] == 0
