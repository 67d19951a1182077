"""The port's cycle watchdog (volcano_tpu_torch/scheduler.py): the cases of
tests/test_resilience.py's watchdog section (334, 369) through the port's
Scheduler(device="cpu"), the health report over HTTP, and the cycle's
metrics that ride every cycle (e2e observations, the time-series sample
while tracing is on).

The watchdog only observes: a cycle over watchdog_multiple x the period
marks the scheduler degraded on /debug/health, bumps
volcano_cycle_deadline_exceeded_total and logs the in-flight phases; the
next cycle inside the deadline clears the mark.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from volcano_tpu_torch.apiserver import ObjectStore
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.metrics import metrics as m
from volcano_tpu_torch.metrics import timeseries
from volcano_tpu_torch.metrics.server import MetricsServer
from volcano_tpu_torch.scheduler import Scheduler
from volcano_tpu_torch.trace import tracer
from volcano_tpu_torch.utils.test_utils import (FakeBinder, FakeEvictor,
                                                build_queue)

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


@pytest.fixture(autouse=True)
def _clean():
    m.reset()
    timeseries.reset()
    yield
    tracer.disable()
    tracer.reset()
    m.reset()
    timeseries.reset()


class _SlowSnapshotCache(SchedulerCache):
    """Injected slow phase: every snapshot (open_session's first span)
    sleeps past the watchdog deadline."""

    SLEEP_S = 0.25

    def snapshot(self):
        time.sleep(self.SLEEP_S)
        return super().snapshot()


def test_watchdog_fires_on_slow_cycle_and_recovers():
    store = ObjectStore()
    cache = _SlowSnapshotCache(store, binder=FakeBinder(store),
                               evictor=FakeEvictor(store))
    cache.run()
    store.create("queues", build_queue("default", weight=1))
    sched = Scheduler(store, scheduler_conf=CONF, cache=cache,
                      schedule_period=0.05, watchdog_multiple=2.0,
                      device="cpu")
    was_on = tracer.is_enabled()
    tracer.enable()
    try:
        before = m.snapshot()["counters"].get(
            (m.CYCLE_DEADLINE_EXCEEDED, ()), 0)
        sched.run_once()
        time.sleep(0.05)       # let the (already fired) timer thread land
        assert sched.degraded
        assert sched.cycle_deadline_exceeded == 1
        after = m.snapshot()["counters"].get(
            (m.CYCLE_DEADLINE_EXCEEDED, ()), 0)
        assert after == before + 1
        report = m.health_report()
        assert not report["healthy"] and "scheduler" in report["degraded"]
        assert "watchdog deadline" in \
            report["components"]["scheduler"]["detail"]
        # recovery: an in-deadline cycle clears the degraded mark
        sched.watchdog_multiple = 1000.0
        sched.run_once()
        assert not sched.degraded
        assert m.health_report()["healthy"]
    finally:
        if not was_on:
            tracer.disable()
        cache.stop()


def test_watchdog_live_phase_breakdown():
    """While a cycle is stuck, live_phases() exposes the in-flight span
    tree: the watchdog's log names the guilty phase."""
    was_on = tracer.is_enabled()
    tracer.enable()
    try:
        captured = {}
        with tracer.cycle():
            with tracer.span("open_session"):
                captured.update(tracer.live_phases())
        assert captured.get("open_session", {}).get("open") is True
        assert captured.get("cycle", {}).get("open") is True
        assert tracer.live_phases() == {}    # cleared at cycle exit
    finally:
        if not was_on:
            tracer.disable()


def test_watchdog_logs_the_stuck_cycle_phases(caplog):
    store = ObjectStore()
    cache = _SlowSnapshotCache(store, binder=FakeBinder(store),
                               evictor=FakeEvictor(store))
    cache.run()
    store.create("queues", build_queue("default", weight=1))
    sched = Scheduler(store, scheduler_conf=CONF, cache=cache,
                      schedule_period=0.05, watchdog_multiple=2.0,
                      device="cpu")
    tracer.enable()
    with caplog.at_level("ERROR", logger="volcano_tpu_torch.scheduler"):
        sched.run_once()
        time.sleep(0.05)
    assert any("cycle watchdog" in r.getMessage()
               and "open_session" in r.getMessage()
               for r in caplog.records)
    cache.stop()


def test_health_endpoint_503_while_degraded():
    m.set_health("scheduler", False, "scheduling cycle exceeded its "
                                     "watchdog deadline")
    server = MetricsServer(port=0)
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}/debug/health"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url, timeout=5)
        assert err.value.code == 503
        body = json.loads(err.value.read().decode())
        assert body["degraded"] == ["scheduler"]
        m.set_health("scheduler", True, "back under the deadline")
        ok = json.loads(urllib.request.urlopen(url, timeout=5).read())
        assert ok["healthy"] is True
    finally:
        server.stop()


def test_every_cycle_observes_e2e_and_samples_when_tracing():
    store = ObjectStore()
    cache = SchedulerCache(store, binder=FakeBinder(store),
                           evictor=FakeEvictor(store))
    cache.run()
    store.create("queues", build_queue("default", weight=1))
    sched = Scheduler(store, scheduler_conf=CONF, cache=cache, device="cpu")
    sched.run_once()                  # tracing off: no sample
    assert timeseries.series() == []
    tracer.enable()
    sched.run_once()
    rows = timeseries.series()
    assert len(rows) == 1 and rows[0]["cycle_ms"] > 0
    assert rows[0]["seq"] == tracer.current_seq()
    count, _ = m.snapshot()["histograms"][(m.E2E_SCHEDULING_LATENCY, ())]
    assert count == 2
    # the cycle's last_cycle split keeps its fields
    assert {"open_session_ms", "snapshot_ms", "enqueue_ms", "allocate_ms",
            "close_session_ms", "cycle_ms", "places",
            "victim_runs"} <= set(sched.last_cycle)
    cache.stop()
