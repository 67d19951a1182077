"""The port's pod lifecycle ledger (volcano_tpu_torch/trace/ledger.py) and
metrics time series: the cases of tests/test_lifecycle.py that need no
async bind flush, through the port's Scheduler(device="cpu"), then one
store through both packages with equal ledger aggregates.

The port's binds are written behind the cycle by the cache's executor:
``bind_staged`` carries the gang's staging instant, ``store_committed``
and ``echo_confirmed`` are stamped at the store commit and its echo, and
each flush carries its own correlation id (``bind-<n>``). Not carried
over: the correlation cases that join the store's journal to a remote
store or a restarted scheduler (the port has no remote store yet), the
compile-cache and backend-probe counters (JAX's), and `vcctl debug`.

Tolerance: exact (a virtual clock makes every hop exact).
"""

import json
import re
import urllib.error
import urllib.request

import pytest

from volcano_tpu.apiserver import ObjectStore as RefStore
from volcano_tpu.cache import SchedulerCache as RefCache
from volcano_tpu.scheduler import Scheduler as RefScheduler
from volcano_tpu.trace import ledger as ref_ledger
from volcano_tpu.trace import tracer as ref_tracer
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu.utils.clock import FakeClock as RefClock
from volcano_tpu_torch.apiserver import ObjectStore
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.metrics import metrics as m
from volcano_tpu_torch.metrics import timeseries
from volcano_tpu_torch.metrics.server import MetricsServer
from volcano_tpu_torch.scheduler import Scheduler
from volcano_tpu_torch.trace import ledger, tracer
from volcano_tpu_torch.utils import test_utils as port_tu
from volcano_tpu_torch.utils.clock import FakeClock
from volcano_tpu_torch.utils.test_utils import (FakeBinder, FakeEvictor,
                                                build_node, build_pod,
                                                build_pod_group, build_queue)

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


# the caches built by _env, stopped after each test
_CACHES: list = []


@pytest.fixture(autouse=True)
def _clean():
    tracer.reset()
    tracer.set_budgets({})
    ledger.reset()
    timeseries.reset()
    m.reset()
    yield
    # the caches the test built stop with it (their executor threads)
    while _CACHES:
        _CACHES.pop().stop()
    tracer.disable()
    tracer.reset()
    tracer.set_budgets({})
    ledger.reset()
    timeseries.reset()


def _env(clock=None, n_nodes=4, n_gangs=2, gang=3, tu=port_tu,
         store_cls=ObjectStore, cache_cls=SchedulerCache,
         sched_cls=Scheduler, clock_cls=FakeClock, **kw):
    clock = clock if clock is not None else clock_cls(start=1.0)
    store = store_cls(clock=clock)
    binder = tu.FakeBinder(store)
    cache = cache_cls(store, binder=binder, evictor=tu.FakeEvictor(store))
    cache.run()
    _CACHES.append(cache)
    sched = sched_cls(store, scheduler_conf=CONF, cache=cache, clock=clock,
                      **(kw or {"device": "cpu"}))
    store.create("queues", tu.build_queue("default", weight=1))
    for i in range(n_nodes):
        store.create("nodes", tu.build_node(f"n{i}", {"cpu": "8",
                                                      "memory": "16Gi"}))
    for j in range(n_gangs):
        store.create("podgroups", tu.build_pod_group(
            f"pg-{j}", "default", "default", gang, phase="Inqueue"))
        for t in range(gang):
            store.create("pods", tu.build_pod(
                "default", f"pg-{j}-{t}", "", "Pending",
                {"cpu": "1", "memory": "1Gi"}, groupname=f"pg-{j}"))
    return store, cache, binder, sched, clock


def test_tracer_switch_covers_ledger():
    assert not ledger.is_enabled()
    tracer.enable()
    assert ledger.is_enabled()
    tracer.disable()
    assert not ledger.is_enabled()


def test_transition_ordering_and_creation_rules():
    ledger.enable()
    # only "submitted" creates entries: a stray later-stage stamp (e.g. a
    # store_committed arriving after the entry completed) is ignored
    ledger.stamp("ns/p0", "bind_staged", 5.0)
    assert ledger.stats()["open"] == 0
    ledger.stamp("ns/p0", "submitted", 1.0)
    assert ledger.stats()["open"] == 1
    # stages stamp once and never regress
    ledger.stamp("ns/p0", "kernel_placed", 3.0)
    ledger.stamp("ns/p0", "session_eligible", 2.0)   # late: ignored
    ledger.stamp("ns/p0", "bind_staged", 4.0)
    ledger.confirm("ns/p0", 6.0, queue="q")
    rep = ledger.report()
    assert ledger.stats() == {"enabled": True, "open": 0, "completed": 1,
                              "dropped": 0, "detours": {}}
    r = rep["recent"][0]
    # hops between consecutive PRESENT stamps only (session_eligible and
    # enqueued were skipped), and their sum is exactly the e2e
    assert set(r["hops"]) == {"submitted->kernel_placed",
                              "kernel_placed->bind_staged",
                              "bind_staged->store_committed",
                              "store_committed->echo_confirmed"}
    assert abs(sum(r["hops"].values()) - r["e2e_ms"]) < 1e-9
    assert r["e2e_ms"] == pytest.approx(5000.0)
    assert rep["per_queue_e2e"]["q"]["count"] == 1


def test_ledger_real_cycle_virtual_clock_hops_and_orphans():
    tracer.enable()
    store, cache, binder, sched, clock = _env()
    clock.advance(2.0)          # submission -> first eligible cycle
    sched.run_once()
    # NO advance before the flush barrier: the executor drains on its
    # own thread, so only clock advances WE make are deterministic —
    # every cycle/flush/echo stamp lands at the same virtual instant
    assert cache.flush_executors()
    assert len(binder.binds) == 6
    stats = ledger.stats()
    assert stats["completed"] == 6 and stats["open"] == 0
    rep = ledger.report()
    assert rep["hops"]["e2e"]["count"] == 6
    # the virtual clock makes the hops exact: submission waited 2.0 s,
    # everything after it happened "instantly"
    for r in rep["recent"]:
        assert abs(sum(r["hops"].values()) - r["e2e_ms"]) < 1e-6
        assert r["e2e_ms"] == pytest.approx(2000.0)
        assert r["hops"]["submitted->session_eligible"] == \
            pytest.approx(2000.0)
        assert r["queue"] == "default"
        # one correlation id a gang's store commit
        assert re.fullmatch(r"bind-\d+", r["trace"])
    assert ledger.orphans(store) == []
    cache.stop()


def test_ledger_double_run_bit_identical():
    fingerprints = []
    for _ in range(2):
        tracer.reset()
        ledger.reset()
        tracer.enable()
        store, cache, binder, sched, clock = _env()
        clock.advance(1.0)
        sched.run_once()
        # no advance before the barrier: executor thread timing must not
        # race a clock mutation (the sim advances only at tick barriers
        # for the same reason)
        assert cache.flush_executors()
        cache.stop()
        fingerprints.append(ledger.fingerprint())
        tracer.disable()
    assert fingerprints[0] == fingerprints[1]


def test_pod_delete_drops_open_entry():
    tracer.enable()
    store, cache, binder, sched, clock = _env()
    # synthetically unschedulable: stays open in the ledger
    store.create("podgroups", build_pod_group(
        "stuck", "default", "default", 1, phase="Inqueue"))
    store.create("pods", build_pod(
        "default", "stuck-0", "", "Pending",
        {"cpu": "64", "memory": "1Gi"}, groupname="stuck"))
    sched.run_once()
    cache.flush_executors()
    assert ledger.stats()["open"] == 1
    store.delete("pods", "stuck-0", "default")
    stats = ledger.stats()
    assert stats["open"] == 0 and stats["dropped"] == 1
    assert ledger.orphans(store) == []
    cache.stop()


def test_debug_latency_timeseries_http_and_404_body():
    tracer.enable()
    store, cache, binder, sched, clock = _env()
    sched.run_once()
    assert cache.flush_executors()
    server = MetricsServer(port=0)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"

        def get(path):
            return json.loads(urllib.request.urlopen(
                base + path, timeout=5).read().decode())

        lat = get("/debug/latency")
        assert lat["enabled"] and lat["completed"] == 6
        assert lat["hops"]["e2e"]["count"] == 6
        for agg in lat["hops"].values():
            assert {"count", "mean_ms", "p50", "p95", "p99"} <= set(agg)
        assert lat["per_queue_e2e"]["default"]["count"] == 6

        ts = get("/debug/timeseries")
        assert len(ts["samples"]) == 1
        row = ts["samples"][0]
        assert row["cycle_ms"] > 0 and row["seq"] >= 1
        assert get("/debug/timeseries?limit=1")["samples"] == [row]

        index = get("/debug")
        assert "/debug/latency" in index["endpoints"]
        assert "/debug/timeseries" in index["endpoints"]

        # unknown paths answer 404 WITH a JSON error body
        try:
            urllib.request.urlopen(base + "/nope", timeout=5)
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404
            body = json.loads(e.read().decode())
            assert body["error"] == "not found"
            assert "/debug/latency" in body["endpoints"]

        # prometheus exposition carries the new histograms
        metrics_body = urllib.request.urlopen(
            base + "/metrics", timeout=5).read().decode()
        assert "volcano_pod_e2e_latency_milliseconds_count" in metrics_body
        assert 'volcano_pod_hop_latency_milliseconds_count{hop=' \
            in metrics_body
    finally:
        server.stop()
        cache.stop()


def test_timeseries_counters_accumulate_across_cycles():
    tracer.enable()
    store, cache, binder, sched, clock = _env()
    sched.run_once()
    cache.flush_executors()
    clock.advance(1.0)
    sched.run_once()
    rows = timeseries.series()
    assert len(rows) == 2
    assert rows[1]["t"] > rows[0]["t"]
    assert rows[1][m.SCHEDULE_ATTEMPTS] >= 2
    assert rows[1][f"{m.POD_E2E_LATENCY}_count"] == 6


def test_ledger_aggregates_match_reference():
    """One store through both packages on virtual clocks: the same
    completions, hop names and per-queue counts, and the same e2e and
    per-hop sums."""
    reps = []
    for tr_mod, led, kw in (
            (ref_tracer, ref_ledger, dict(
                tu=ref_tu, store_cls=RefStore, cache_cls=RefCache,
                sched_cls=RefScheduler, clock_cls=RefClock,
                watchdog_multiple=0)),
            (tracer, ledger, dict(device="cpu"))):
        led.reset()
        tr_mod.enable()
        store, cache, binder, sched, clock = _env(n_gangs=3, **kw)
        clock.advance(2.0)
        sched.run_once()
        assert cache.flush_executors()
        rep = led.report()
        reps.append((led.stats(), {h: (a["count"], round(a["mean_ms"], 6))
                                   for h, a in rep["hops"].items()},
                     {q: a["count"] for q, a in
                      rep["per_queue_e2e"].items()}))
        tr_mod.disable()
        led.reset()
        cache.stop()
    assert reps[1] == reps[0]
    assert reps[1][0]["completed"] == 9
