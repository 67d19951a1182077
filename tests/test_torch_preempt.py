"""The port's preempt action held against the JAX package's.

The scenarios of tests/test_preempt_action.py, each built once per package
from one description (tests/test_torch_victims.py's ``Scenario``) and run
under both ``victims.kernel: auto`` and ``off``; then whole two-cycle runs
of ``utils.synth.populate_preempt_store`` (the reference harness's
preemption shape, volcano_tpu/bench_suite.py:203-250) at 400 nodes, 50
victim gangs and 25 preemptor gangs, the port's
``Scheduler(store, device="cpu")`` against ``volcano_tpu.scheduler.
Scheduler``. Tolerance: exact. Evicted pod keys (in eviction order),
pipelined task -> node, PodGroup phases and, after the second cycle, binds
must be equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import volcano_tpu.scheduler as ref_sched_mod
import volcano_tpu_torch.scheduler as port_sched_mod
from tests.test_torch_victims import (PORT, REF, Scenario, assert_same,
                                      build, with_mode)
from volcano_tpu.apiserver import ObjectStore as RefStore
from volcano_tpu.cache import SchedulerCache as RefCache
from volcano_tpu.models.objects import ObjectMeta as RefMeta
from volcano_tpu.models.objects import PriorityClass as RefPC
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu_torch.apiserver import ObjectStore as PortStore
from volcano_tpu_torch.cache import SchedulerCache as PortCache
from volcano_tpu_torch.framework.victims import PreemptContext
from volcano_tpu_torch.utils import test_utils as port_tu
from volcano_tpu_torch.utils.synth import populate_preempt_store

CONF = """
actions: "preempt"
tiers:
- plugins:
  - name: conformance
  - name: gang
"""

CLASSES = [("low-priority", 100), ("high-priority", 1000)]


def one_node(cpu, pods, groups, classes=()):
    """Queue q1, node n1 of ``cpu`` CPUs and as many Gi, the given
    podgroups (name, namespace, min_member, priority class) and pods
    (namespace, name, node, phase, cpu, group)."""
    return Scenario(
        queues=[("q1", 1, True)], classes=list(classes),
        nodes=[("n1", cpu, f"{cpu}Gi")],
        podgroups=[(n, ns, "q1", m, "Inqueue", pc) for n, ns, m, pc in groups],
        pods=[(ns, n, node, ph, c, f"{c}Gi", g)
              for ns, n, node, ph, c, g in pods])


SCENARIOS = {
    # test_preempt_action.py: (scenario, evictions)
    "no_preempt_with_idle_headroom": (one_node(
        "10", [("c1", "preemptee1", "n1", "Running", "1", "pg1"),
               ("c1", "preemptee2", "n1", "Running", "1", "pg1"),
               ("c1", "preemptor1", "", "Pending", "1", "pg1")],
        [("pg1", "c1", 3, "")]), 0),
    "no_preempt_when_only_pipelined": (one_node(
        "3", [("c1", "preemptee1", "n1", "Running", "1", "pg1"),
              ("c1", "preemptee2", "n1", "Running", "1", "pg1"),
              ("c1", "preemptee3", "n1", "Running", "1", "pg2"),
              ("c1", "preemptor2", "", "Pending", "1", "pg2")],
        [("pg1", "c1", 1, ""), ("pg2", "c1", 1, "")]), 0),
    "preempt_one_task_of_lower_priority_job": (one_node(
        "2", [("c1", "preemptee1", "n1", "Running", "1", "pg1"),
              ("c1", "preemptee2", "n1", "Running", "1", "pg1"),
              ("c1", "preemptor1", "", "Pending", "1", "pg2"),
              ("c1", "preemptor2", "", "Pending", "1", "pg2")],
        [("pg1", "c1", 1, "low-priority"), ("pg2", "c1", 1, "high-priority")],
        CLASSES), 1),
    "preempt_enough_tasks_for_large_preemptor": (one_node(
        "3", [("c1", "preemptee1", "n1", "Running", "1", "pg1"),
              ("c1", "preemptee2", "n1", "Running", "1", "pg1"),
              ("c1", "preemptee3", "n1", "Running", "1", "pg1"),
              ("c1", "preemptor1", "", "Pending", "2", "pg2")],
        [("pg1", "c1", 1, "low-priority"), ("pg2", "c1", 1, "high-priority")],
        CLASSES), 2),
    "preemptor_pipelined_onto_victim_node": (one_node(
        "2", [("c1", "preemptee1", "n1", "Running", "1", "pg1"),
              ("c1", "preemptee2", "n1", "Running", "1", "pg1"),
              ("c1", "preemptor1", "", "Pending", "1", "pg2")],
        [("pg1", "c1", 1, "low-priority"), ("pg2", "c1", 1, "high-priority")],
        CLASSES), 1),
    # a gang too big for the victims the gang plugin admits: its
    # statement is discarded (evictions and pipelines undone in reverse)
    # and the next job's preemption still sees the restored state
    "gang_rolls_back_then_next_job_preempts": (one_node(
        "3", [("c1", "preemptee1", "n1", "Running", "1", "pg1"),
              ("c1", "preemptee2", "n1", "Running", "1", "pg1"),
              ("c1", "preemptee3", "n1", "Running", "1", "pg1"),
              *[("c1", f"big{i}", "", "Pending", "1", "pg2")
                for i in range(4)],
              ("c1", "small1", "", "Pending", "1", "pg3")],
        [("pg1", "c1", 1, "low-priority"), ("pg2", "c1", 4, "high-priority"),
         ("pg3", "c1", 1, "high-priority")], CLASSES), 1),
    "conformance_shields_critical_pods": (one_node(
        "1", [("kube-system", "critical1", "n1", "Running", "1", "pg1"),
              ("c1", "preemptor1", "", "Pending", "1", "pg2")],
        [("pg1", "kube-system", 1, "low-priority"),
         ("pg2", "c1", 1, "high-priority")], CLASSES), 0),
}


@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_preempt_matches_reference(case, mode):
    sc, n_evicts = SCENARIOS[case]
    evicts, pipelined, _, ssn = assert_same(with_mode(CONF, mode), sc,
                                            ["preempt"], n_evicts)
    if case == "preemptor_pipelined_onto_victim_node":
        assert pipelined == {"c1/preemptor1": "n1"}
    if case == "gang_rolls_back_then_next_job_preempts":
        assert pipelined == {"c1/small1": "n1"}
    if n_evicts:
        path = "python" if mode == "off" else "kernel"
        assert ssn.victim_runs.get(path, 0) > 0, ssn.victim_runs


def _gate_scenario(mixed: bool) -> Scenario:
    sc = Scenario(queues=[("default", 1, True)], classes=[("high", 100)],
                  nodes=[("n0", "8", "16Gi")])
    for j, pc in enumerate(["high", "" if mixed else "high"]):
        sc.podgroups.append((f"pg{j}", "ns1", "default", 1, "Inqueue", pc))
        sc.pods.append(("ns1", f"p{j}", "", "Pending", "1", "1Gi", f"pg{j}"))
    return sc


@pytest.mark.parametrize("mixed", [False, True])
def test_persistent_rejection_gate(mixed):
    """Cross-job rejection persistence is sound only for the monotone
    builtin preemptable plugins with a share-monotone pop order: mixed
    preemptor priorities with drf on must disable it, in both packages."""
    from volcano_tpu.framework.victims import PreemptContext as RefContext
    conf = CONF + "- plugins:\n  - name: drf\n"
    gates = []
    for pkg, ctx_cls in ((REF, RefContext), (PORT, PreemptContext)):
        h = build(pkg, conf, _gate_scenario(mixed))
        ssn = h.open_session()
        ctx = ctx_cls(ssn, [(job, list(job.tasks.values()))
                            for job in ssn.jobs.values()])
        h.close_session()
        gates.append(ctx._persist_ok)
    assert gates == [not mixed, not mixed]


# -- whole cycles at 400 nodes ---------------------------------------------------

CYCLE_CONF = """
actions: "enqueue, allocate, preempt, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: nodeorder
configurations:
- name: solver
  arguments: {kernel: scan, prune.enable: "off", mesh.enable: "false"%s}
"""
# the reference's victim-selection A/B conf (bench.py:538-547): no drf,
# so its tier never decides and the vectorized path selects the victims
ELASTIC_CONF = """
actions: "enqueue, allocate, preempt, backfill"
tiers:
- plugins:
  - name: priority
  - name: conformance
  - name: gang
- plugins:
  - name: predicates
  - name: nodeorder
configurations:
- name: solver
  arguments: {kernel: scan, prune.enable: "off", mesh.enable: "false"%s}
"""
SMALL = dict(n_nodes=400, n_low=50, n_high=25)


def ref_populate_preempt(store, n_nodes, n_low, n_high, elastic=False):
    """The reference harness's preemption shape (bench_suite.config_4),
    or with ``elastic`` its victim-selection A/B shape (bench.py:556-584),
    with the JAX package's builders."""
    tu = ref_tu
    store.create("queues", tu.build_queue("default", weight=1))
    for name, value in (("high", 100), ("low", 1)):
        store.create("priorityclasses", RefPC(metadata=RefMeta(name=name),
                                              value=value))
    for i in range(n_nodes):
        store.create("nodes", tu.build_node(f"node-{i}",
                                            {"cpu": "16", "memory": "32Gi"}))
    for j in range(n_low):
        store.create("podgroups", tu.build_pod_group(
            f"lo-{j}", "ns1", "default", 4 if elastic else 8,
            phase="Running", priority_class="low"))
        for t in range(8):
            store.create("pods", tu.build_pod(
                "ns1", f"lo-{j}-{t}", f"node-{(j * 8 + t) % n_nodes}",
                "Running", {"cpu": "14", "memory": "28Gi"}, f"lo-{j}"))
    for j in range(n_high):
        store.create("podgroups", tu.build_pod_group(
            f"hi-{j}", "ns1", "default", 8, phase="Inqueue",
            priority_class="high"))
        for t in range(8):
            store.create("pods", tu.build_pod(
                "ns1", f"hi-{j}-{t}", "", "Pending",
                {"cpu": "14", "memory": "28Gi"} if elastic
                else {"cpu": "8", "memory": "16Gi"}, f"hi-{j}"))


def store_view(store):
    """What a cycle reads of a store: pods (key, node, phase, request),
    podgroups (key, phase), nodes, queues."""
    pods = sorted((p.metadata.namespace, p.metadata.name, p.spec.node_name,
                   p.status.phase,
                   tuple(sorted(p.spec.containers[0].requests.items())))
                  for p in store.list("pods"))
    pgs = sorted((g.metadata.namespace, g.metadata.name, g.status.phase,
                  g.spec.min_member, g.spec.queue,
                  g.spec.priority_class_name)
                 for g in store.list("podgroups"))
    nodes = sorted(n.metadata.name for n in store.list("nodes"))
    queues = sorted(q.metadata.name for q in store.list("queues"))
    return pods, pgs, nodes, queues


def run_cycles(sched_mod, store, cache_cls, tu, conf_text, monkeypatch,
               cycles=2, **kw):
    """Run ``cycles`` Scheduler cycles of one package on ``store``; per
    cycle: (evicted keys in order, pipelined task -> node at close, binds,
    PodGroup phases, the cycle's split)."""
    evictor = tu.FakeEvictor(store)
    cache = cache_cls(store, binder=tu.FakeBinder(store), evictor=evictor)
    cache.run()
    sched = sched_mod.Scheduler(store, scheduler_conf=conf_text, cache=cache,
                                **kw)
    seen = {}
    real_close = sched_mod.close_session

    def close(ssn):
        seen["pipelined"] = {
            f"{t.namespace}/{t.name}": t.node_name
            for job in ssn.jobs.values() for t in job.tasks.values()
            if t.status.name == "Pipelined"}
        real_close(ssn)
    monkeypatch.setattr(sched_mod, "close_session", close)
    out = []
    for _ in range(cycles):
        n0 = len(evictor.evicts)
        sched.run_once()
        cache.flush_executors()
        binds = {f"{p.metadata.namespace}/{p.metadata.name}": p.spec.node_name
                 for p in store.list("pods") if p.spec.node_name}
        phases = {f"{g.metadata.namespace}/{g.metadata.name}": g.status.phase
                  for g in store.list("podgroups")}
        out.append((evictor.evicts[n0:], seen["pipelined"], binds, phases,
                    getattr(sched, "last_cycle", None)))
    monkeypatch.setattr(sched_mod, "close_session", real_close)
    return out


@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("shape", ["config4", "elastic"])
def test_preempt_cycles_match_reference(shape, mode, monkeypatch):
    """Two cycles on the preemption shape: the first evicts a victim per
    preemptor and pipelines the preemptors, the second binds them. drf's
    tier selects the victims of config 4 (the walk, in both modes); the
    elastic shape's conf has no drf, so there ``auto`` takes the
    vectorized path."""
    opt = ', victims.kernel: "off"' if mode == "off" else ""
    elastic = shape == "elastic"
    conf = (ELASTIC_CONF if elastic else CYCLE_CONF) % opt
    ref_store, port_store = RefStore(), PortStore()
    ref_populate_preempt(ref_store, **SMALL, elastic=elastic)
    populate_preempt_store(port_store, **SMALL, elastic=elastic)
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
    (ev1, pipe1, _, _, split1), (_, _, binds2, phases2, _) = port
    assert len(ev1) == 200 and len(pipe1) == 200
    path = "kernel" if elastic and mode == "auto" else "python"
    runs = split1["victim_runs"]
    assert runs[path] > 0 and sum(runs.values()) == runs[path], runs
    assert all(binds2.get(k) == node for k, node in pipe1.items())
    assert sum(v == "Running" for k, v in phases2.items()
               if k.startswith("ns1/hi-")) == 25
    assert store_view(port_store) == store_view(ref_store)


def cycle_cmd(scenario: str, nodes: int = 64) -> dict:
    """Run ``python -m volcano_tpu_torch.cmd.cycle --device cpu
    --scenario <scenario>`` once; returns its cold run's record."""
    out = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.cmd.cycle", "--device",
         "cpu", "--scenario", scenario, "--nodes", str(nodes), "--warm",
         "0"], cwd=Path(__file__).resolve().parent.parent,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout)
    assert rec["scenario"] == scenario and rec["warm"] == []
    return rec["cold"]


def test_cycle_cmd_preempt_on_cpu():
    """``cmd.cycle --scenario preempt``: one JSON line with preempt_ms,
    the evictions, the pipelined tasks and the victim-selection paths."""
    cold = cycle_cmd("preempt")
    assert cold["evictions"] == cold["pipelined"] == 32
    assert cold["preempt_ms"] > 0
    assert cold["victim_runs"] == {"kernel": 0, "python": 32}
