"""The port's serving layer (volcano_tpu_torch/serving/, apiserver/http.py)
held against the JAX package's.

* The cases of tests/test_serving.py run on the port (``port_cases``): the
  hub's shards, coalesced frames, kind filters, frame chain, relists and
  rewinds, filter-flip parity with the store's own watches, the tenant
  token buckets and subscription caps, HTTP/1.1 keep-alive, the 429 with
  Retry-After, ``/watchstream``, ``/debug/serving``, and the RemoteStore's
  cursor-gap relist; the small storm runs on ``device="cpu"``.
* Side by side: the same writes through both packages' hubs give the
  same frames, and the hub's frame bytes on the wire are the same.
* The storm gate at a small shape: the port's run gives the reference's
  bind and ledger fingerprints and its deterministic counters.
* The port's own routes: the standalone ``/leader``, the read-only 503,
  ``/replicate`` and ``/replicate/snapshot``, the admission webhook
  registration, and the debug routes of the metrics server.

Tolerance: exact.
"""

import http.client
import json
import urllib.request

import pytest

from tests.torch_reference_cases import port_cases

_serving = port_cases("test_serving", replace=[(
    "v = run_storm(seed=43, ticks=12, nodes=64, subscribers=60,",
    "v = run_storm(device=\"cpu\", seed=43, ticks=12, nodes=64, "
    "subscribers=60,")])
TestHub = _serving.TestHub
TestFilterFlipParity = _serving.TestFilterFlipParity
TestAdmission = _serving.TestAdmission
TestServingHTTP = _serving.TestServingHTTP
TestRemoteStoreRelist = _serving.TestRemoteStoreRelist
TestStormSmall = _serving.TestStormSmall

PKGS = ("volcano_tpu", "volcano_tpu_torch")


def _mods(pkg):
    import importlib
    return (importlib.import_module(f"{pkg}.apiserver.store"),
            importlib.import_module(f"{pkg}.serving.hub"),
            importlib.import_module(f"{pkg}.utils.test_utils"))


def _frames_of(pkg):
    """A fixed write sequence (creates, a filter flip, a sharded patch,
    deletes) through one package's store and hub, three subscribers."""
    store_mod, hub_mod, tu = _mods(pkg)
    store = store_mod.ObjectStore()
    hub = hub_mod.ServingHub(store, shards=2)
    subs = [hub.subscribe("all", since_rv=0),
            hub.subscribe("pods", kinds=("pods",),
                          filter_attr=(("spec", "scheduler_name"),
                                       "volcano"), since_rv=0),
            hub.subscribe("nodes", kinds=("nodes",), since_rv=0)]
    for i in range(4):
        store.create("nodes", tu.build_node(f"n{i}", {"cpu": "4"}))
    for i in range(700):
        p = tu.build_pod("ns", f"p{i}", "", "Pending", {"cpu": "1"})
        p.spec.scheduler_name = "volcano" if i % 4 else "other"
        store.create("pods", p, skip_admission=True)
    hub.pump()

    def flip(new):
        new.spec.scheduler_name = "volcano"
        new.spec.node_name = "n1"
    store.patch_batch("pods", [(f"p{i}", "ns", flip) for i in range(700)])
    store.delete("nodes", "n3", skip_admission=True)
    hub.pump()
    out = []
    for s in subs:
        for f in s.take_frames():
            out.append({k: v for k, v in f.items() if k != "events"})
            out[-1]["events"] = [(rv, a, k, o.metadata.name)
                                 for rv, a, k, o in f["events"]]
    return out


def test_hub_frames_match_the_reference():
    assert _frames_of("volcano_tpu_torch") == _frames_of("volcano_tpu")


def _watchstream_lines(pkg, n_lines):
    """The first frames of a ``/watchstream`` over one package's server,
    as raw bytes."""
    import importlib
    store_mod, hub_mod, tu = _mods(pkg)
    http_mod = importlib.import_module(f"{pkg}.apiserver.http")
    store = store_mod.ObjectStore()
    hub = hub_mod.ServingHub(store, shards=2, poll_timeout=0.05)
    server = http_mod.StoreHTTPServer(store, port=0, hub=hub)
    server.start()
    try:
        for i in range(3):
            p = tu.build_pod("ns", f"w{i}", "", "Pending",
                             {"cpu": "1", "memory": "1Gi"})
            p.metadata.uid = f"uid-{i}"
            p.metadata.creation_timestamp = 5.0
            store.create("pods", p, skip_admission=True)
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=10)
        conn.request("GET", "/watchstream?cursor=0&heartbeat=1&client=c1"
                            "&kinds=pods")
        resp = conn.getresponse()
        assert resp.status == 200
        lines = []
        while len(lines) < n_lines:
            line = resp.readline()
            if b'"ping"' in line:
                continue
            lines.append(line)
        conn.close()
        return lines
    finally:
        server.stop()


def test_watchstream_bytes_match_the_reference():
    """Hello and the coalesced frame: byte for byte, the object bytes
    from the port's native encoder."""
    assert _watchstream_lines("volcano_tpu_torch", 2) == \
        _watchstream_lines("volcano_tpu", 2)


STORM_SHAPE = dict(seed=43, ticks=12, nodes=64, subscribers=60, shards=3,
                   drop_rate=0.08, resident=24, gap_tick=6)
# the counters that repeat from run to run (frames_total, events_total
# and final_rv vary in both packages: the hub's dispatch rounds see the
# journal at different points)
STORM_HELD = ("subscribers", "converged", "gaps_unrecovered",
              "noisy_throttled_writes", "noisy_subscription_throttles",
              "bind_fingerprint", "ledger_fingerprint", "violations",
              "watch_drops", "divergence_repairs")


def test_storm_gate_matches_reference_at_a_small_shape():
    from volcano_tpu.serving.storm import run_storm as ref_storm
    from volcano_tpu_torch.serving.storm import run_storm as port_storm
    ref = ref_storm(**STORM_SHAPE)
    port = port_storm(device="cpu", **STORM_SHAPE)
    assert {k: port[k] for k in STORM_HELD} == \
        {k: ref[k] for k in STORM_HELD}
    assert port["storm"]["outcome_fingerprint"] == \
        ref["storm"]["outcome_fingerprint"]
    assert port["storm"]["binds"] == ref["storm"]["binds"] > 0
    assert port["frames_dropped"] > 0 and port["relists"] >= 1


# -- the port's own routes ------------------------------------------------


def _server(**kw):
    from volcano_tpu_torch.apiserver.http import StoreHTTPServer
    from volcano_tpu_torch.apiserver.store import ObjectStore
    from volcano_tpu_torch.utils.test_utils import build_queue
    store = ObjectStore()
    store.create("queues", build_queue("default"))
    server = StoreHTTPServer(store, port=0, **kw)
    server.start()
    return store, server


def _get(server, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}{path}", timeout=10) as r:
        return json.loads(r.read())


def test_leader_route_is_standalone():
    store, server = _server()
    try:
        store.advance_fence(3)
        got = _get(server, "/leader")
        assert got == {"role": "standalone", "accepts_writes": True,
                       "holder": "", "url": "", "token": 3, "live": True}
    finally:
        server.stop()


def test_read_only_store_answers_503_with_retry_after():
    from volcano_tpu_torch.apiserver.http import ApiError, StoreClient
    from volcano_tpu_torch.utils.test_utils import build_queue
    store, server = _server()
    try:
        store.enter_read_only("WAL append failed: [ENOSPC] full")
        client = StoreClient(f"http://127.0.0.1:{server.port}")
        with pytest.raises(ApiError) as ei:
            client.create("queues", build_queue("q2"))
        assert ei.value.code == 503
        assert ei.value.retry_after and ei.value.retry_after >= 1
        assert store.get("queues", "q2") is None
        store.exit_read_only()
        client.create("queues", build_queue("q2"))
        assert store.get("queues", "q2") is not None
    finally:
        server.stop()


def test_replicate_routes_serve_the_leader_half():
    """``/replicate/snapshot`` is ``snapshot_payload``; ``/replicate``
    streams the journal range as NDJSON frames stamped with the epoch."""
    from volcano_tpu_torch.replication.leader import (ReplicationSource,
                                                      snapshot_payload)
    store, server = _server()
    try:
        store.advance_fence(2)
        snap = _get(server, "/replicate/snapshot")
        assert snap == json.loads(json.dumps(snapshot_payload(store)))
        assert snap["epoch"] == 2 and snap["rv"] == store.current_rv()
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=10)
        conn.request("GET", "/replicate?since=0&heartbeat=1")
        resp = conn.getresponse()
        hello = json.loads(resp.readline())
        frame = json.loads(resp.readline())
        conn.close()
        assert hello["hello"] and hello["epoch"] == 2
        assert frame["epoch"] == 2
        assert [e[0] for e in frame["entries"]] == [1]
        assert frame["entries"][0][3]["metadata"]["name"] == "default"
        src = ReplicationSource(store, epoch=2)
        entries, tail, gone, epoch = src.collect(0)
        assert (len(entries), tail, gone, epoch) == (1, 1, False, 2)
    finally:
        server.stop()


def test_admission_webhook_registration_gates_writes():
    """``/admissionwebhooks`` registers a RemoteAdmissionHook on the
    store; an unreachable webhook rejects (failurePolicy: Fail) with
    422."""
    from volcano_tpu_torch.apiserver.http import ApiError, StoreClient
    from volcano_tpu_torch.apiserver.remote import RemoteAdmissionHook
    from volcano_tpu_torch.utils.test_utils import build_queue
    store, server = _server()
    try:
        body = json.dumps({"kind": "queues", "path": "/queues/validate",
                           "url": "http://127.0.0.1:1/validate",
                           "operations": ["CREATE"]}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/admissionwebhooks", data=body,
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 201
        assert len(store._hooks) == 1
        assert isinstance(store._hooks[0], RemoteAdmissionHook)
        client = StoreClient(f"http://127.0.0.1:{server.port}")
        with pytest.raises(ApiError) as ei:
            client.create("queues", build_queue("gated"))
        assert ei.value.code == 422
        assert store.get("queues", "gated") is None
    finally:
        server.stop()


def test_admission_hook_chain_mutates_then_validates():
    from volcano_tpu_torch.apiserver.store import (AdmissionError,
                                                   AdmissionHook,
                                                   ObjectStore)
    from volcano_tpu_torch.utils.test_utils import build_queue
    store = ObjectStore()
    seen = []

    def mutate(op, new, old):
        seen.append(("mutate", op))
        new.spec.weight = 7

    def validate(op, new, old):
        seen.append(("validate", op))
        if new is not None and new.metadata.name == "bad":
            raise AdmissionError("denied")
    store.register_admission(AdmissionHook(
        "queues", "/q", mutate=mutate, validate=validate,
        operations=("CREATE", "UPDATE")))
    store.create("queues", build_queue("good"))
    assert store.get("queues", "good").spec.weight == 7
    with pytest.raises(AdmissionError):
        store.create("queues", build_queue("bad"))
    assert store.get("queues", "bad") is None
    store.create("queues", build_queue("skipped", weight=1),
                 skip_admission=True)
    assert store.get("queues", "skipped").spec.weight == 1
    assert seen == [("mutate", "CREATE"), ("validate", "CREATE")] * 2
    # replace=True drops the earlier hook of the same kind and path
    store.register_admission(AdmissionHook("queues", "/q"), replace=True)
    assert len(store._hooks) == 1


def test_debug_routes_of_the_metrics_server(tmp_path):
    from volcano_tpu_torch import serving
    from volcano_tpu_torch.apiserver.store import ObjectStore
    from volcano_tpu_torch.apiserver.wal import WriteAheadLog
    from volcano_tpu_torch.metrics.server import MetricsServer
    from volcano_tpu_torch.serving.admission import AdmissionController
    from volcano_tpu_torch.serving.hub import ServingHub
    store = ObjectStore()
    wal = WriteAheadLog(str(tmp_path))
    wal.attach(store)
    adm = AdmissionController()
    serving.set_active(hub=ServingHub(store, shards=2, admission=adm),
                       admission=adm)
    ms = MetricsServer(port=0)
    ms.start()
    try:
        base = f"http://127.0.0.1:{ms.port}"
        read = lambda p: json.loads(urllib.request.urlopen(
            base + p, timeout=10).read())
        assert read("/debug/serving")["hub"]["shards"] == 2
        assert read("/debug/replication") == {"replica_set": None}
        dur = read("/debug/durability")
        assert dur["attached"] and dur["data_dir"] == str(tmp_path)
        index = read("/debug")["endpoints"]
        assert {"/debug/serving", "/debug/replication",
                "/debug/durability"} <= set(index)
    finally:
        ms.stop()
        serving.clear_active()
        wal.close()
        from volcano_tpu_torch.apiserver import wal as wal_mod
        wal_mod.set_active(None)
