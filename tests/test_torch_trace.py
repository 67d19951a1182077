"""The port's flight recorder (volcano_tpu_torch/trace/tracer.py) and "why
pending" (trace/pending.py): the cases of tests/test_trace.py through the
port's Scheduler(device="cpu"), then the same seeded store through both
packages: the same span-name tree (names, nesting, order), the same count
tags, and the same /debug/pending report.

The bind flush's spans: the cache's executor records ``bind_flush.apply``,
``bind_flush.store`` and ``bind_flush.echo`` after the cycle, as async
spans of the cycle (the chrome export's tid 2), as the reference's does.

Tolerance: exact for names, order and counts. The overhead test is the
reference's interleaved min-of-N with its flake shield.
"""

import json
import re
import time
import types
import urllib.request
from pathlib import Path

import pytest

import volcano_tpu.apiserver as ref_api
import volcano_tpu.cache as ref_cache
import volcano_tpu.scheduler as ref_sched
from volcano_tpu.metrics import metrics as ref_m
from volcano_tpu.trace import pending as ref_pending
from volcano_tpu.trace import tracer as ref_tracer
from volcano_tpu.utils import test_utils as ref_tu
import volcano_tpu_torch.apiserver as port_api
import volcano_tpu_torch.cache as port_cache
import volcano_tpu_torch.scheduler as port_sched
from volcano_tpu_torch.metrics import metrics as m
from volcano_tpu_torch.metrics.server import MetricsServer
from volcano_tpu_torch.trace import pending, tracer
from volcano_tpu_torch.utils import test_utils as port_tu

ROOT = Path(__file__).resolve().parent.parent

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

REF = types.SimpleNamespace(api=ref_api, cache=ref_cache, sched=ref_sched,
                            tu=ref_tu, tracer=ref_tracer, m=ref_m,
                            pending=ref_pending, kw={})
PORT = types.SimpleNamespace(api=port_api, cache=port_cache,
                             sched=port_sched, tu=port_tu, tracer=tracer,
                             m=m, pending=pending, kw={"device": "cpu"})


# the caches built by _env, stopped after each test
_CACHES: list = []


@pytest.fixture(autouse=True)
def _clean_tracer():
    for pkg in (REF, PORT):
        pkg.tracer.reset()
        pkg.tracer.set_budgets({})
    yield
    # the caches the test built stop with it (their executor threads)
    while _CACHES:
        _CACHES.pop().stop()
    for pkg in (REF, PORT):
        pkg.tracer.disable()
        pkg.tracer.reset()
        pkg.tracer.set_budgets({})


def _env(n_nodes=4, n_gangs=2, gang=3, pkg=PORT, conf=CONF):
    store = pkg.api.ObjectStore()
    binder = pkg.tu.FakeBinder(store)
    cache = pkg.cache.SchedulerCache(store, binder=binder,
                                     evictor=pkg.tu.FakeEvictor(store))
    cache.run()
    _CACHES.append(cache)
    sched = pkg.sched.Scheduler(store, scheduler_conf=conf, cache=cache,
                                **pkg.kw)
    store.create("queues", pkg.tu.build_queue("default", weight=1))
    for i in range(n_nodes):
        store.create("nodes", pkg.tu.build_node(f"n{i}", {"cpu": "8",
                                                          "memory": "16Gi"}))
    for j in range(n_gangs):
        store.create("podgroups", pkg.tu.build_pod_group(
            f"pg-{j}", "default", "default", gang, phase="Inqueue"))
        for t in range(gang):
            store.create("pods", pkg.tu.build_pod(
                "default", f"pg-{j}-{t}", "", "Pending",
                {"cpu": "1", "memory": "1Gi"}, groupname=f"pg-{j}"))
    return store, cache, binder, sched


def _add_stuck(pkg, store):
    """A synthetically unschedulable gang: no node has 64 cpus."""
    store.create("podgroups", pkg.tu.build_pod_group(
        "stuck", "default", "default", 2, phase="Inqueue"))
    for t in range(2):
        store.create("pods", pkg.tu.build_pod(
            "default", f"stuck-{t}", "", "Pending",
            {"cpu": "64", "memory": "1Gi"}, groupname="stuck"))


# -- tracer core -------------------------------------------------------------


def test_span_tree_and_ring():
    tracer.enable(capacity=4)
    with tracer.cycle(source="test"):
        with tracer.span("open_session"):
            with tracer.span("snapshot"):
                pass
        with tracer.span("action:allocate"):
            tracer.add_tags(placed=7)
            tracer.tag_cycle(binds=7)
    rec = tracer.last_record()
    assert rec is not None
    root = rec.root
    assert root.name == "cycle" and root.dur > 0
    assert [c.name for c in root.children] == ["open_session",
                                               "action:allocate"]
    assert root.children[0].children[0].name == "snapshot"
    assert root.children[1].tags == {"placed": 7}
    assert root.tags == {"source": "test", "binds": 7}
    # nested spans never outlive their parent
    assert root.children[0].dur <= root.dur


def test_ring_buffer_capacity_and_seq():
    tracer.enable(capacity=2)
    for _ in range(3):
        with tracer.cycle():
            pass
    recs = tracer.records()
    assert len(recs) == 2
    assert recs[0].seq + 1 == recs[1].seq
    assert tracer.get_record(recs[0].seq) is recs[0]
    assert tracer.get_record(recs[1].seq - 10) is None


def test_disabled_tracer_records_nothing():
    with tracer.cycle():
        with tracer.span("x"):
            pass
    assert tracer.last_record() is None
    # span outside any cycle is a no-op even when enabled
    tracer.enable()
    with tracer.span("orphan"):
        pass
    assert tracer.last_record() is None


def test_tag_span_merges_tags_into_a_closed_span():
    """The device time of an asynchronous launch is tagged onto its span
    after the span closed (at the decode's sync); off, it is a no-op."""
    tracer.tag_span(None, kernel_ms=1.0)
    tracer.enable()
    with tracer.cycle():
        with tracer.span("execute", route="plain") as sp:
            pass
        tracer.tag_span(sp, kernel_ms=2.5)
    ex = tracer.last_record().root.children[0]
    assert ex.tags == {"route": "plain", "kernel_ms": 2.5}


def test_chrome_trace_schema_and_validator():
    tracer.enable()
    with tracer.cycle():
        with tracer.span("open_session", plugin="gang"):
            pass
    ct = tracer.chrome_trace(tracer.last_record())
    tracer.validate_chrome_trace(ct)   # must not raise
    names = [e["name"] for e in ct["traceEvents"]]
    assert names[0] == "cycle" and "open_session" in names
    # events are complete-events with µs timestamps relative to the root
    assert all(e["ph"] == "X" and e["ts"] >= 0 for e in ct["traceEvents"])
    with pytest.raises(ValueError):
        tracer.validate_chrome_trace({"traceEvents": []})
    with pytest.raises(ValueError):
        tracer.validate_chrome_trace(
            {"traceEvents": [{"name": "x", "ph": "B", "ts": 0, "dur": 0,
                              "pid": 1, "tid": 1}]})


def test_budget_flags_and_metric():
    m.reset()
    tracer.enable()
    tracer.set_budgets({"cycle": 0.0, "nap": 0.0})
    with tracer.cycle():
        with tracer.span("nap"):
            pass
    s = tracer.summary(tracer.last_record())
    assert "cycle" in s["over_budget"] and "nap" in s["over_budget"]
    counters = m.snapshot()["counters"]
    assert any(name == f"{m.NS}_trace_phase_over_budget_total"
               for (name, _), _ in counters.items())


# -- real cycles -------------------------------------------------------------


def test_smoke_traced_cycle_and_debug_endpoints():
    """One small traced cycle through the port's scheduler, /debug/trace,
    /debug/cycles and /debug/pending fetched over HTTP, the trace
    validated against the span schema, and the pending surface reporting
    the per-reason counts of a synthetically unschedulable job."""
    m.reset()
    tracer.enable()
    store, cache, binder, sched = _env()
    _add_stuck(PORT, store)
    sched.run_once()
    cache.flush_executors()
    assert len(binder.binds) == 6   # both real gangs bound

    server = MetricsServer(port=0)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"

        def get(path):
            return json.loads(urllib.request.urlopen(
                base + path, timeout=5).read().decode())

        trace_json = get("/debug/trace")
        tracer.validate_chrome_trace(trace_json)
        names = {e["name"] for e in trace_json["traceEvents"]}
        assert {"cycle", "open_session", "snapshot", "plugin_open",
                "action:enqueue", "action:allocate", "solver.place",
                "build_context", "kernel", "close_session",
                "job_updater"} <= names

        cycles = get("/debug/cycles")
        assert cycles["enabled"] and len(cycles["cycles"]) == 1
        summary = cycles["cycles"][0]
        assert summary["cycle_ms"] > 0
        assert summary["tags"]["committed_tasks"] == 6
        assert get(f"/debug/trace?seq={summary['seq']}")["otherData"][
            "cycle_seq"] == summary["seq"]

        pend = get("/debug/pending")
        # joinable against /debug/trace?seq= on the same field
        assert pend["cycle_seq"] == summary["seq"]
        assert pend["pending_jobs"] == 1
        job = pend["jobs"]["default/stuck"]
        assert job["pending_tasks"] == 2
        assert job["reasons"] == {pending.REASON_SOLVER_MASKED: 2}
        assert pend["reasons"][pending.REASON_SOLVER_MASKED] == 2

        # prometheus export of the same counts
        body = urllib.request.urlopen(
            base + "/metrics", timeout=5).read().decode()
        assert 'volcano_unschedulable_reason_total{reason=' \
            '"predicates failed or insufficient resources"} 2.0' in body
    finally:
        server.stop()


def test_trace_coverage_of_cycle_wall_time():
    """Spans must attribute (nearly) all of the measured cycle: gate at
    90% on this small cycle, best of three."""
    tracer.enable()
    _, cache, _, sched = _env()
    sched.run_once()
    best = {"coverage": 0.0}
    for _ in range(3):
        sched.run_once()
        s = tracer.summary(tracer.last_record())
        if s["coverage"] > best["coverage"]:
            best = s
        if best["coverage"] >= 0.90:
            break
    assert best["coverage"] >= 0.90, best
    assert best["spans"] >= 15


def test_pending_report_empty_when_all_ready():
    tracer.enable()
    _, cache, _, sched = _env()
    sched.run_once()
    cache.flush_executors()
    sched.run_once()
    rep = tracer.pending_report()
    assert rep["pending_jobs"] == 0 and rep["reasons"] == {}


def test_awaiting_enqueue_counts_unready_not_zero():
    """A Pending-phase PodGroup has no pods yet, so its diagnosis counts
    the min_available shortfall, not the zero Pending-status tasks."""
    tracer.enable()
    store, cache, _, sched = _env(n_nodes=1, n_gangs=0,
                                  conf=CONF.replace("enqueue, allocate",
                                                    "allocate"))
    store.create("podgroups", port_tu.build_pod_group(
        "waiting", "default", "default", 4))   # Pending phase, no pods
    sched.run_once()
    rep = tracer.pending_report()
    assert rep["jobs"]["default/waiting"]["reasons"] == \
        {pending.REASON_AWAITING_ENQUEUE: 4}
    assert rep["reasons"][pending.REASON_AWAITING_ENQUEUE] == 4


def test_bind_flush_async_spans_recorded():
    """The executor records the bind flush's spans on the cycle's async
    track: bind_flush.store carries the binds, and
    bind_flush.echo (the watch echo) nests inside it."""
    tracer.enable()
    _, cache, _, sched = _env()
    sched.run_once()
    cache.flush_executors()
    rec = tracer.last_record()
    flushes = tracer._async_spans_for(rec.seq)
    assert any(s.name == "bind_flush.store" for s in flushes)
    n_binds = sum((s.tags or {}).get("binds", 0) for s in flushes
                  if s.name == "bind_flush.store")
    assert n_binds == 6
    assert any(c.name == "bind_flush.echo" for s in flushes
               if s.name == "bind_flush.store" for c in s.children or ())
    # and they ride tid 2 of the chrome export
    ct = tracer.chrome_trace(rec)
    assert any(e["tid"] == 2 and e["name"] == "bind_flush.store"
               for e in ct["traceEvents"])
    phases = tracer.async_phases(rec)
    assert {"bind_flush.apply", "bind_flush.store",
            "bind_flush.store/bind_flush.echo"} <= set(phases)
    assert tracer.summary(rec)["bind_flush_ms"] > 0


def test_tracer_overhead_under_two_percent():
    """The flight recorder must be cheap enough to leave on: steady-state
    cycles with tracing on vs off, interleaved min-of-N (min cancels
    co-tenant noise; 0.3 ms epsilon is the timer floor at this size)."""
    _, cache, _, sched = _env(n_nodes=16, n_gangs=8)
    sched.run_once()            # place
    cache.flush_executors()
    for _ in range(3):          # settle: nothing pending
        sched.run_once()

    def steady(n=12):
        best = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            sched.run_once()
            best = min(best, time.perf_counter() - t0)
        return best

    steady(3)                   # warm both code paths

    def measure():
        base = traced = float("inf")
        for _ in range(4):      # interleave to cancel machine drift
            tracer.disable()
            base = min(base, steady())
            tracer.enable()
            traced = min(traced, steady())
        return base, traced

    for _ in range(3):          # flake shield vs co-tenant bursts
        base, traced = measure()
        if traced <= base * 1.02 + 3e-4:
            break
    assert traced <= base * 1.02 + 3e-4, \
        f"tracing on {traced * 1e3:.2f} ms vs off {base * 1e3:.2f} ms"


def test_tracing_layer_never_reads_the_device():
    """No span or counter adds a device synchronisation or a
    device->host copy: the tracer, ledger, pending and metrics modules
    touch no tensor, and the launch's span reads its device time from
    the CUDA events at the decode's existing sync."""
    for rel in ("trace/tracer.py", "trace/ledger.py", "trace/pending.py",
                "metrics/metrics.py", "metrics/timeseries.py",
                "metrics/server.py"):
        src = (ROOT / "volcano_tpu_torch" / rel).read_text()
        assert "torch" not in src, rel
    solver = (ROOT / "volcano_tpu_torch/framework/solver.py").read_text()
    launch = solver[solver.index("    def launch(self, gmask"):
                    solver.index("class Placement(NamedTuple):")]
    # one sync in the launch: the one the decode already had
    assert len(re.findall(r"synchronize\(\)", launch)) == 1
    assert "tr.tag_span(execute, kernel_ms=kernel_ms)" in launch


# -- the same store through both packages -------------------------------------


def _tree(span):
    return (span.name, [_tree(c) for c in span.children or ()])


def _traced(pkg, conf, stuck=False, **env):
    pkg.tracer.reset()
    pkg.tracer.enable()
    store, cache, _, sched = _env(pkg=pkg, conf=conf, **env)
    if stuck:
        _add_stuck(pkg, store)
    sched.run_once()
    cache.flush_executors()
    rec = pkg.tracer.last_record()
    pending_report = dict(pkg.tracer.pending_report())
    pkg.tracer.disable()
    return rec, pending_report


PARITY_CONF = CONF.replace('"enqueue, allocate"',
                           '"enqueue, allocate, backfill"') + """
configurations:
- name: solver
  arguments: {kernel: scan, prune.enable: "%s", mesh.enable: "false"}
"""
COUNT_TAGS = ("jobs", "nodes", "queues", "tasks_considered",
              "committed_tasks", "committed", "pipelined", "placed",
              "discarded", "inqueued")


def _count_tags(span):
    out = [(span.name, {k: v for k, v in (span.tags or {}).items()
                        if k in COUNT_TAGS})]
    for c in span.children or ():
        out.extend(_count_tags(c))
    return out


@pytest.mark.parametrize("prune", ["off", "true"])
@pytest.mark.parametrize("stuck", [False, True])
def test_span_tree_and_count_tags_match_reference(prune, stuck):
    """The same seeded store through both packages (pruning off and
    forced): the same span-name tree, nesting and order, and the same
    count tags on every span."""
    conf = PARITY_CONF % prune
    ref, _ = _traced(REF, conf, stuck, n_nodes=6, n_gangs=3)
    port, _ = _traced(PORT, conf, stuck, n_nodes=6, n_gangs=3)
    assert _tree(port.root) == _tree(ref.root)
    assert _count_tags(port.root) == _count_tags(ref.root)
    assert port.root.tags["committed_tasks"] == 9


def test_pending_report_matches_reference():
    conf = PARITY_CONF % "off"
    _, ref = _traced(REF, conf, stuck=True)
    _, port = _traced(PORT, conf, stuck=True)
    for rep in (ref, port):
        rep.pop("cycle_seq")
        rep.pop("session_uid")
    assert port == ref
    assert port["pending_jobs"] == 1


def test_trace_overhead_command_alternates_and_reports(capsys):
    """cmd.trace_overhead runs placing cycles on fresh stores and steady
    cycles on one bound store, tracing off and on in off-on-on-off
    order, and prints the overheads (the placing cycle's on its cycle,
    its flush and the two together) with every run's times and the last
    traced cycle's span split."""
    from volcano_tpu_torch.cmd import trace_overhead
    assert trace_overhead.main(["--device", "cpu", "--tasks", "64",
                                "--nodes", "16", "--pairs", "2",
                                "--steady-rounds", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    placing = out["placing"]
    assert len(placing["on_ms"]) == len(placing["off_ms"]) == 2
    assert len(placing["on_flush_ms"]) == len(placing["off_flush_ms"]) == 2
    assert all(ms > 0 for ms in placing["on_flush_ms"]
               + placing["off_flush_ms"])
    for part in ("cycle", "flush", "to_bound"):
        assert set(placing[part]) == {"min_pct", "median_pct"}
    assert len(out["steady"]["on_ms"]) == len(out["steady"]["off_ms"]) == 2
    assert {"min_pct", "median_pct"} <= set(out["steady"])
    assert out["steady"]["launches"] == 0
    assert out["phases"]["tags"]["committed_tasks"] == 64
    assert "bind_flush.store" in out["phases"]["async"]
    assert not tracer.is_enabled()
    assert trace_overhead.overhead([2.0, 4.0], [1.0, 2.0]) == {
        "min_pct": 100.0, "median_pct": 100.0}
