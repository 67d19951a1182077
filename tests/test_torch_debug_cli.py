"""`vcctl debug` in the port (volcano_tpu_torch/cli/debug.py) against the
JAX package's (volcano_tpu/cli/debug.py).

The cases of tests/test_lifecycle.py:390 (test_vcctl_debug_cli) and
tests/test_explain.py:335-339 (`vcctl debug explain` over HTTP) run on
the port's Scheduler(device="cpu") and MetricsServer; every verb's
rendered text is held equal to the reference renderer's on the payload
the port's server answered, and on hand-made payloads that reach every
branch of the renderers, and dispatch_debug's exit codes (1 while
/debug/health answers 503, for an unknown job, a lagging or diverged
replica set, a read-only store) equal the reference's.

Tolerance: exact (text).
"""

import argparse
import json

import pytest

from volcano_tpu.cli import debug as ref_debug
from volcano_tpu_torch.apiserver import ObjectStore
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.cli import debug
from volcano_tpu_torch.cli.vcctl import main as vcctl_main
from volcano_tpu_torch.metrics import metrics as m
from volcano_tpu_torch.metrics import timeseries
from volcano_tpu_torch.metrics.server import MetricsServer
from volcano_tpu_torch.scheduler import Scheduler
from volcano_tpu_torch.trace import explain, ledger, tracer
from volcano_tpu_torch.utils import test_utils as tu
from volcano_tpu_torch.utils.clock import FakeClock

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
    def reset():
        tracer.disable()
        tracer.reset()
        ledger.reset()
        timeseries.reset()
        explain.disable()
        explain.reset()
        m.reset()
    reset()
    yield
    reset()


@pytest.fixture
def served():
    """A traced cycle of 2 gangs of 3 on 4 nodes with the explainer on,
    and a MetricsServer over it; yields the server's URL."""
    tracer.enable()
    explain.enable()
    clock = FakeClock(start=1.0)
    store = ObjectStore(clock=clock)
    cache = SchedulerCache(store, binder=tu.FakeBinder(store),
                           evictor=tu.FakeEvictor(store))
    cache.run()
    sched = Scheduler(store, scheduler_conf=CONF, cache=cache, clock=clock,
                      device="cpu")
    store.create("queues", tu.build_queue("default", weight=1))
    for i in range(4):
        store.create("nodes", tu.build_node(f"n{i}", {"cpu": "8",
                                                      "memory": "16Gi"}))
    for j in range(2):
        store.create("podgroups", tu.build_pod_group(
            f"pg-{j}", "default", "default", 3, phase="Inqueue"))
        for t in range(3):
            store.create("pods", tu.build_pod(
                "default", f"pg-{j}-{t}", "", "Pending",
                {"cpu": "1", "memory": "1Gi"}, groupname=f"pg-{j}"))
    sched.run_once()
    assert cache.flush_executors()
    server = MetricsServer(port=0)
    server.start()
    try:
        yield f"http://127.0.0.1:{server.port}"
    finally:
        server.stop()
        cache.stop()


def test_vcctl_debug_cli(served, capsys):
    assert vcctl_main(["debug", "latency", "--metrics", served,
                       "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["completed"] == 6
    assert vcctl_main(["debug", "latency", "--metrics", served]) == 0
    out = capsys.readouterr().out
    assert "e2e" in out and "p95" in out
    assert vcctl_main(["debug", "timeseries", "--metrics", served]) == 0
    assert "cycle_ms" in capsys.readouterr().out
    assert vcctl_main(["debug", "health", "--metrics", served]) == 0
    assert vcctl_main(["debug", "cycles", "--metrics", served]) == 0
    out = capsys.readouterr().out
    assert "cycle_ms" in out and "top phases" in out


@pytest.mark.parametrize("verb", debug.VERBS)
def test_each_verb_renders_as_the_reference(served, verb, capsys):
    """The port's vcctl prints what the reference's renderer makes of the
    port server's payload, with the reference's exit code."""
    status, payload = debug.fetch(served, f"/debug/{verb}")
    assert (status, payload) == ref_debug.fetch(served, f"/debug/{verb}")
    code = vcctl_main(["debug", verb, "--metrics", served])
    out = capsys.readouterr().out
    args = argparse.Namespace(metrics=served, verb=verb, job=None,
                              json=False, max_lag=1000)
    assert ref_debug.dispatch_debug(args) == code
    assert capsys.readouterr().out == out
    assert out.startswith(ref_debug._RENDER[verb](payload))


def test_vcctl_debug_explain_over_http(served):
    """tests/test_explain.py:335-339 on the port: the newest records, one
    job's record, and an unknown job (exit 1)."""
    args = argparse.Namespace(metrics=served, verb="explain", job=None,
                              json=False)
    assert debug.dispatch_debug(args) == 0
    args.job = "default/pg-0"
    assert debug.dispatch_debug(args) == 0
    args.job = "default/nope"
    assert debug.dispatch_debug(args) == 1


# -- every renderer branch on hand-made payloads ------------------------------

_CYCLE = {"seq": 3, "cycle_ms": 12.5, "coverage": 0.97,
          "phases": {"allocate": {"ms": 8.1}, "enqueue": {"ms": 1.2},
                     "open_session": {"ms": 2.0}, "close": {"ms": 0.3}},
          "tags": {"mode": "incremental", "quiet": True, "dirty_jobs": 2,
                   "dirty_nodes": 5, "skipped_tasks": 1},
          "bind_flush_ms": 4.4, "over_budget": ["allocate"]}
_GROUP = {"gang": "g0", "placed": 3, "tasks": 3, "winner": "n1",
          "feasible": 4, "nodes": 4, "win_margin": 0.25,
          "eliminations": {"fit": 1, "taint": 2},
          "coverage": {"8": 1.0, "2": 0.5},
          "topk": [{"node": "n1", "score": 90.0,
                    "terms": {"binpack": 50.0, "least": 40.0}}]}
_REPLICA_SET = {"epoch": 4, "leader": {"rv": 120, "frames_shipped": 9,
                                       "events_shipped": 30,
                                       "snapshots_shipped": 1},
                "lag_rvs": {"f1": 2, "f2": 2000},
                "followers": [
                    {"name": n, "epoch": 4, "applied_rv": 118,
                     "frames_applied": 9, "gaps_detected": 0,
                     "catchup_relists": 0, "snapshot_bootstraps": 1,
                     "fenced_frames": 0} for n in ("f1", "f2")],
                "dead": ["f3"], "cursor_handoffs": 2,
                "last_audit": {"verdict": "diverged", "leader_rv": 118,
                               "divergent": ["pods"]}}
_WAL = {"attached": True, "data_dir": "/d", "generation": 2,
        "durable_rv": 40, "store_rv": 41, "lag_entries": 1, "segments": 3,
        "segment_bytes": 4096, "records_written": 50, "entries_written": 60,
        "fsyncs": 10, "fsync_p50_ms": 0.5, "fsync_p99_ms": 2.0,
        "append_p99_ms": 0.1, "compactions": 1, "rotations": 2}
_RECOVERY = {"snapshot_rv": 10, "final_rv": 40, "snapshot_objects": 5,
             "entries_replayed": 30, "torn_records_truncated": 1,
             "recovery_ms": 12.0}

PAYLOADS = {
    "cycles-empty": ("cycles", 200, {"cycles": [], "enabled": False}),
    "cycles": ("cycles", 200, {"cycles": [_CYCLE, {**_CYCLE, "tags": {}}]}),
    "pending": ("pending", 200, {
        "pending_jobs": 2, "idle_reason": "no-nodes", "detail": "x",
        "reasons": {"insufficient cpu": 4, "gang": 1},
        "jobs": {"ns/a": {"queue": "q", "pending_tasks": 3, "unready": 1,
                          "min_available": 2,
                          "reasons": {"insufficient cpu": 3}}}}),
    "health-ok": ("health", 200, {"healthy": True, "components": {
        "scheduler": {"healthy": True, "detail": ""}}}),
    "health-degraded": ("health", 503, {"healthy": False, "components": {
        "watchdog": {"healthy": False, "detail": "cycle over budget"}}}),
    "latency": ("latency", 200, {
        "enabled": True, "open": 1, "completed": 2, "dropped": 0,
        "detours": {}, "hops": {"e2e": {"count": 2, "mean_ms": 3.0,
                                        "p50": 3.0, "p95": 4.0, "p99": 4.0}},
        "per_queue_e2e": {"": {"count": 2, "p50": 3.0, "p95": 4.0,
                               "p99": 4.0}},
        "recent": [{"pod": "ns/p", "trace": None, "e2e_ms": 3.0}]}),
    "timeseries-empty": ("timeseries", 200, {"samples": []}),
    "timeseries": ("timeseries", 200, {"samples": [
        {"seq": 1, "cycle_ms": 2.0, "volcano_pending": 3},
        {"seq": 2, "cycle_ms": 2.5, "volcano_binds": 6}]}),
    "explain-unknown": ("explain", 404, {"error": "no record for ns/x",
                                         "enabled": True}),
    "explain-job": ("explain", 200, {"job": "ns/a", "cycle": 2,
                                     "kernel": "native", "queue": "q",
                                     "committed": True,
                                     "groups": [_GROUP]}),
    "explain": ("explain", 200, {
        "enabled": True, "records": 1, "fingerprint": "0123456789abcdefff",
        "aggregates": {"feasible_nodes": {"count": 1, "p50": 4, "p90": 4,
                                          "p99": 4, "mean": 4.0},
                       "topk_coverage": {"8": 1.0, "16": 1.0},
                       "fragmentation_ratio": 0.1},
        "jobs": {"ns/a": {"kernel": "native", "groups": [_GROUP]}},
        "victims": [{"preemptor": "ns/p", "mode": "preempt", "node": "n1",
                     "winning_tier": 1, "victims": ["ns/v"],
                     "candidates": 3}]}),
    "replication-none": ("replication", 200, {}),
    "replication-member": ("replication", 200, {"member": {
        "name": "a", "role": "degraded", "lease_holder": "", "token": 3,
        "takeovers": 1, "demotions": 1, "accepts_writes": False}}),
    "replication-follower": ("replication", 200, {"follower": {
        "name": "f1", "epoch": 2, "applied_rv": 9, "lag_rvs": 5000,
        "frames_applied": 3, "gaps_detected": 0, "catchup_relists": 0,
        "snapshot_bootstraps": 1, "fenced_frames": 0}}),
    "replication-set": ("replication", 200, {"replica_set": _REPLICA_SET}),
    "replication-healthy": ("replication", 200, {"replica_set": {
        **_REPLICA_SET, "lag_rvs": {"f1": 2}, "dead": [],
        "last_audit": None}}),
    "durability-none": ("durability", 200, {"attached": False}),
    "durability": ("durability", 200, {**_WAL,
                                       "last_recovery": _RECOVERY}),
    "durability-read-only": ("durability", 200, {
        **_WAL, "read_only": True, "degraded_reason": "ENOSPC"}),
}

# the cases whose dispatch exits 1
FAILING = {"health-degraded", "explain-unknown", "replication-member",
           "replication-follower", "replication-set", "durability-read-only"}


@pytest.mark.parametrize("case", sorted(PAYLOADS))
def test_renderers_and_exit_codes_equal_the_reference(case, monkeypatch,
                                                      capsys):
    verb, status, payload = PAYLOADS[case]
    assert debug._RENDER[verb](payload) == ref_debug._RENDER[verb](payload)
    codes, outs = [], []
    for mod in (debug, ref_debug):
        monkeypatch.setattr(mod, "fetch",
                            lambda server, path, timeout=10.0: (status,
                                                                payload))
        for as_json in (False, True):
            args = argparse.Namespace(metrics="http://127.0.0.1:1",
                                      verb=verb, job=None, json=as_json,
                                      max_lag=1000)
            codes.append(mod.dispatch_debug(args))
            outs.append(capsys.readouterr().out)
    assert codes[:2] == codes[2:] and outs[:2] == outs[2:], case
    assert codes[0] == codes[1] == int(case in FAILING), case
