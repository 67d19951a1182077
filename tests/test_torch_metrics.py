"""The port's metrics (volcano_tpu_torch/metrics/metrics.py, server.py):
the cases of tests/test_metrics.py (full histogram exposition, label
escaping, snapshot/reset under concurrent writers, a scrape of the
server), then one seeded store through both packages' schedulers: the same
metric names in ``render_prometheus`` and equal route-free values.

What the comparison leaves out, and why: the kernel-route label values
(``volcano_solver_kernel_runs_total{kernel}``: "cuda"/"plain" here, the
JAX package's tiers there); wall-time values; the metrics of the JAX
package's compile cache (``volcano_solver_compile_cache_total``, which
counts XLA compiles);
``volcano_trace_phase_over_budget_total`` (set by a cycle's wall time
against its budget).

Tolerance: exact for names and counts.
"""

import re
import threading
import urllib.request

import pytest

from volcano_tpu.apiserver import ObjectStore as RefStore
from volcano_tpu.cache import SchedulerCache as RefCache
from volcano_tpu.metrics import metrics as ref_m
from volcano_tpu.scheduler import Scheduler as RefScheduler
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu_torch.apiserver import ObjectStore as PortStore
from volcano_tpu_torch.cache import SchedulerCache as PortCache
from volcano_tpu_torch.metrics import metrics as m
from volcano_tpu_torch.metrics.server import MetricsServer
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler
from volcano_tpu_torch.trace import tracer as port_tracer
from volcano_tpu_torch.utils import test_utils as port_tu
from volcano_tpu.trace import tracer as ref_tracer

# one exposition line: name{labels} value  (labels optional)
LINE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'               # metric name
    r'(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\\n])*",?)*\})?'  # labels
    r' -?[0-9.e+\-]+(\n|$)')


@pytest.fixture(autouse=True)
def _fresh():
    m.reset()
    yield
    m.reset()


def _lines(body=None):
    body = body if body is not None else m.render_prometheus()
    return [ln for ln in body.splitlines() if ln]


class TestHistogramExposition:
    def test_bucket_lines_cumulative_with_inf(self):
        name = "volcano_test_latency"
        # one observation per bucket boundary (v <= bound lands in it),
        # plus one past the last bound (the overflow bucket)
        for v in m._Hist.BOUNDS:
            m.observe(name, v)
        m.observe(name, m._Hist.BOUNDS[-1] * 10)
        out = {}
        for ln in _lines():
            if ln.startswith(f"{name}_bucket"):
                le = re.search(r'le="([^"]+)"', ln).group(1)
                out[le] = float(ln.rsplit(" ", 1)[1])
        # cumulative: bucket i holds i+1 observations
        for i, bound in enumerate(m._Hist.BOUNDS):
            assert out[f"{bound:g}"] == i + 1, (bound, out)
        assert out["+Inf"] == len(m._Hist.BOUNDS) + 1
        body = m.render_prometheus()
        assert f"{name}_count 13" in body

    def test_bucket_boundary_is_inclusive(self):
        m.observe("volcano_edge", 0.001)   # exactly on a bound -> le bucket
        body = m.render_prometheus()
        assert 'volcano_edge_bucket{le="0.001"} 1' in body
        assert 'volcano_edge_bucket{le="0.0001"} 0' in body

    def test_buckets_carry_existing_labels(self):
        m.observe("volcano_lbl", 5.0, queue="q1")
        body = m.render_prometheus()
        assert 'volcano_lbl_bucket{queue="q1",le="10"} 1' in body
        assert 'volcano_lbl_count{queue="q1"} 1' in body

    def test_every_line_parses(self):
        m.observe("volcano_h", 0.5, queue="a")
        m.set_gauge("volcano_g", 1.25, node="n1")
        m.inc("volcano_c", 2.0)
        for ln in _lines():
            assert LINE_RE.match(ln), ln


class TestLabelEscaping:
    def test_quote_backslash_newline(self):
        m.set_gauge("volcano_esc", 1.0, queue='he said "hi"\\\n')
        (ln,) = _lines()
        assert ln == 'volcano_esc{queue="he said \\"hi\\"\\\\\\n"} 1.0'
        # exposition stays one line per sample
        assert len(m.render_prometheus().strip().splitlines()) == 1
        assert LINE_RE.match(ln), ln

    def test_escaping_applies_to_histogram_and_counter_labels(self):
        m.observe("volcano_esc_h", 1.0, job='a"b')
        m.inc("volcano_esc_c", job="x\ny")
        body = m.render_prometheus()
        assert '\\"' in body and "\\n" in body
        assert "\n".join(_lines(body)) == body.strip()


class TestThreadSafety:
    def test_concurrent_observe_inc_vs_snapshot_reset(self):
        stop = threading.Event()
        errors = []

        def writer(i):
            try:
                while not stop.is_set():
                    m.observe("volcano_ts_h", 0.5 * i, worker=str(i % 3))
                    m.inc("volcano_ts_c", worker=str(i % 3))
                    m.set_gauge("volcano_ts_g", i)
            except Exception as e:   # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        try:
            for _ in range(200):
                snap = m.snapshot()
                assert isinstance(snap["histograms"], dict)
                m.render_prometheus()
                m.reset()
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        assert not errors
        # post-reset state still consistent: counts match bucket sums
        m.reset()
        m.observe("volcano_ts_h", 1.0)
        with m._lock:
            (h,) = [h for (n, _), h in m._histograms.items()
                    if n == "volcano_ts_h"]
            assert sum(h.buckets) == h.count == 1


class TestEndToEndScrape:
    def test_server_returns_parseable_exposition(self):
        m.update_e2e_duration(0.5)
        m.observe(m.PLUGIN_LATENCY, 120.0, plugin="gang",
                  OnSession="OnSessionOpen")
        m.inc(m.UNSCHEDULABLE_REASON, 3.0,
              reason='node(s) had taints that the pod didn\'t tolerate')
        server = MetricsServer(port=0)
        server.start()
        try:
            resp = urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics", timeout=5)
            assert resp.headers["Content-Type"].startswith("text/plain")
            body = resp.read().decode()
        finally:
            server.stop()
        lines = _lines(body)
        assert lines and body.endswith("\n")
        for ln in lines:
            assert LINE_RE.match(ln), ln
        assert any(ln.startswith(
            "volcano_e2e_scheduling_latency_milliseconds_bucket{")
            for ln in lines)
        assert "volcano_unschedulable_reason_total" in body


# -- the same store through both packages -------------------------------------

CONF = """
actions: "enqueue, allocate, backfill"
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
configurations:
- name: solver
  arguments:
    kernel: scan
    prune.enable: "off"
    mesh.enable: "false"
    explain.enable: "true"
"""
# metrics of the JAX package's compile cache, and of cycle wall time
# against a budget (docstring)
NOT_COMPARED = {"volcano_solver_compile_cache_total",
                "volcano_trace_phase_over_budget_total"}
# route-free values: counters and gauges of binds, attempts, shares and
# gang states, and the observation counts of the e2e histograms
COMPARED_VALUES = ("volcano_schedule_attempts_total",
                   "volcano_bind_flush_binds_total",
                   "volcano_unschedule_task_count",
                   "volcano_unschedule_job_count",
                   "volcano_unschedulable_reason_total",
                   "volcano_queue_allocated_milli_cpu",
                   "volcano_queue_allocated_memory_bytes",
                   "volcano_queue_share", "volcano_job_share",
                   "volcano_padded_waste_ratio",
                   "volcano_fragmentation_ratio",
                   "volcano_cycle_mode_total", "volcano_dirty_set_size",
                   "volcano_solver_device_buffer_total",
                   "volcano_constraint_rows_total")
COMPARED_COUNTS = ("volcano_e2e_scheduling_latency_milliseconds",
                   "volcano_pod_e2e_latency_milliseconds",
                   "volcano_action_scheduling_latency_microseconds",
                   "volcano_plugin_scheduling_latency_microseconds",
                   "volcano_gang_feasible_nodes",
                   "volcano_topk_score_coverage")


def _cycle(store_cls, cache_cls, sched_cls, tu, tracer, metrics, **kw):
    metrics.reset()
    tracer.reset()
    tracer.enable()
    store = store_cls()
    cache = cache_cls(store, binder=tu.FakeBinder(store),
                      evictor=tu.FakeEvictor(store))
    cache.run()
    # no watchdog: the JAX package's first cycle compiles for seconds
    sched = sched_cls(store, scheduler_conf=CONF, cache=cache,
                      watchdog_multiple=0, **kw)
    store.create("queues", tu.build_queue("default", weight=1))
    for i in range(6):
        store.create("nodes", tu.build_node(f"n{i}", {"cpu": "8",
                                                      "memory": "16Gi"}))
    for j, size in enumerate((3, 3, 2, 40)):
        store.create("podgroups", tu.build_pod_group(
            f"pg-{j}", "default", "default", size, phase="Inqueue"))
        for t in range(size):
            store.create("pods", tu.build_pod(
                "default", f"pg-{j}-{t}", "", "Pending",
                {"cpu": "1", "memory": "1Gi"}, groupname=f"pg-{j}"))
    for _ in range(2):
        sched.run_once()
        cache.flush_executors()
    cache.stop()
    tracer.disable()
    snap = metrics.snapshot()
    body = metrics.render_prometheus()
    metrics.reset()
    return snap, body


def _names(snap):
    return {k[0] for part in ("counters", "gauges", "histograms")
            for k in snap[part]}


@pytest.fixture
def fresh_ref_compile_state(monkeypatch):
    """The JAX package counts a padded-shape recompile when a kernel it
    already compiled in this process meets a new shape bucket. Give its
    compile bookkeeping a fresh process's (empty) state for the test and
    put the worker's own back afterwards, so the reference's metric names
    do not depend on which tests ran before in the same worker."""
    import volcano_tpu.ops as ref_ops
    monkeypatch.setattr(ref_ops, "_seen_shape_buckets", set())
    monkeypatch.setattr(ref_ops, "_seen_kernels", set())


def test_metric_names_and_route_free_values_match_reference(
        fresh_ref_compile_state):
    from volcano_tpu.trace import explain as ref_explain
    from volcano_tpu_torch.trace import explain as port_explain
    try:
        ref, ref_body = _cycle(RefStore, RefCache, RefScheduler, ref_tu,
                               ref_tracer, ref_m)
        port, body = _cycle(PortStore, PortCache, PortScheduler, port_tu,
                            port_tracer, m, device="cpu")
    finally:
        for e in (ref_explain, port_explain):
            e.reset()
    assert _names(port) - NOT_COMPARED == _names(ref) - NOT_COMPARED
    for part in ("counters", "gauges"):
        for key, v in ref[part].items():
            if key[0] in COMPARED_VALUES:
                assert port[part].get(key) == pytest.approx(v), key
    for key, (count, _) in ref["histograms"].items():
        if key[0] in COMPARED_COUNTS:
            assert port["histograms"][key][0] == count, key
    # the kernel-runs counter labels the port's route
    assert port["counters"][(m.SOLVER_KERNEL_RUNS,
                             (("kernel", "plain"),))] >= 1
    for ln in body.splitlines():
        assert LINE_RE.match(ln), ln
