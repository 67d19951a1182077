"""The port's RemoteStore and HTTP client (volcano_tpu_torch/apiserver/
remote.py, http.py) held against the JAX package's.

* The cases of tests/test_failover.py:153-230 and :603-680 and of
  tests/test_lifecycle.py:204 run on the port (``port_cases``): the
  fenced write's 412 mapped to FencedError, the malformed fence's 400, the
  anti-entropy audit of a remote-backed cache against the mirror, the
  relist on a forced journal gap, the watch thread's backoff on a dead
  server, the transient-write retry, and the correlation ID's round trip.
* Wire compatibility in both directions: the port's client and RemoteStore
  against the reference's server, and the reference's against the port's
  (each against its own too), on one script of writes, reads, fence
  errors, a watch stream and a forced relist.
* A scheduler cache over a RemoteStore binds as over the store itself.

Tolerance: exact.
"""

import importlib
import time

import pytest

from tests.torch_reference_cases import port_cases

_failover = port_cases("test_failover")
TestRemoteFencing = _failover.TestRemoteFencing
TestWatchGapRelist = _failover.TestWatchGapRelist
TestWriteRetry = _failover.TestWriteRetry
test_correlation_id_remote_store_roundtrip = port_cases(
    "test_lifecycle").test_correlation_id_remote_store_roundtrip

PKGS = ("volcano_tpu", "volcano_tpu_torch")
PAIRS = [(s, c) for s in PKGS for c in PKGS]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS,
                         ids=[f"{s}-server-{c}-client" for s, c in PAIRS])
def test_wire_compatibility(server_pkg, client_pkg):
    store_mod = _mod(server_pkg, "apiserver.store")
    http_mod = _mod(server_pkg, "apiserver.http")
    hub_mod = _mod(server_pkg, "serving.hub")
    stu = _mod(server_pkg, "utils.test_utils")
    remote_mod = _mod(client_pkg, "apiserver.remote")
    cstore = _mod(client_pkg, "apiserver.store")
    ctu = _mod(client_pkg, "utils.test_utils")
    faults = _mod(server_pkg, "sim.faults")

    store = store_mod.ObjectStore()
    store.create("queues", stu.build_queue("default"))
    store.create("nodes", stu.build_node("n0", {"cpu": "8",
                                                "memory": "16Gi"}))
    for i in range(3):
        store.create("pods", stu.build_pod(
            "ns", f"p{i}", "", "Pending", {"cpu": "1", "memory": "1Gi"},
            groupname="pg"), skip_admission=True)
    hub = hub_mod.ServingHub(store, shards=2, poll_timeout=0.05)
    server = http_mod.StoreHTTPServer(store, port=0, hub=hub)
    server.start()
    remote = None
    try:
        remote = remote_mod.RemoteStore(f"http://127.0.0.1:{server.port}",
                                        poll_timeout=1.0)
        # list-primed mirror
        assert sorted(p.metadata.name for p in remote.mirror.list("pods")) \
            == ["p0", "p1", "p2"]
        remote.run()
        assert _wait(lambda: remote._use_stream and
                     remote._thread is not None)
        # writes: create, update (with a trace), delete
        remote.create("pods", ctu.build_pod(
            "ns", "new", "", "Pending", {"cpu": "1", "memory": "1Gi"}))
        live = remote.get("pods", "p0", "ns")
        live.spec.node_name = "n0"
        upd = remote.update("pods", live, trace="t-1")
        assert store.get("pods", "p0", "ns").spec.node_name == "n0"
        assert store.trace_of(upd.metadata.resource_version) == "t-1"
        remote.delete("pods", "p1", "ns")
        assert store.get("pods", "p1", "ns") is None
        # a write made on the server reaches the mirror over the stream
        store.create("pods", stu.build_pod(
            "ns", "server-side", "", "Pending", {"cpu": "1"}),
            skip_admission=True)
        assert _wait(lambda: remote.mirror.get("pods", "server-side", "ns")
                     is not None)
        assert remote.mirror.get("pods", "p1", "ns") is None
        assert remote.mirror.get("pods", "p0", "ns").spec.node_name == "n0"
        # fence and conflict errors map to the client's own types
        assert remote.advance_fence(4) == 4
        q = remote.get("queues", "default")
        with pytest.raises(cstore.FencedError):
            remote.update("queues", q, fence=2)
        stale = remote.get("queues", "default")
        remote.update("queues", remote.get("queues", "default"))
        with pytest.raises(cstore.ConflictError):
            remote.update("queues", stale)
        with pytest.raises(KeyError):
            remote.delete("pods", "nope", "ns")
        want = sorted(p.metadata.name for p in store.list("pods"))
        assert _wait(lambda: sorted(
            p.metadata.name for p in remote.mirror.list("pods")) == want)
        # a mirror left behind by a journal gap takes the structured
        # relist over the stream
        lagger = remote_mod.RemoteStore(f"http://127.0.0.1:{server.port}",
                                        poll_timeout=1.0)
        try:
            store.create("pods", stu.build_pod(
                "ns", "pre-gap", "", "Pending", {"cpu": "1"}),
                skip_admission=True)
            faults.FlakyWatch.force_gap(store)
            store.create("pods", stu.build_pod(
                "ns", "after-gap", "", "Pending", {"cpu": "1"}),
                skip_admission=True)
            lagger.run()
            assert _wait(lambda: lagger.mirror.get("pods", "after-gap", "ns")
                         is not None and lagger.mirror.get(
                             "pods", "pre-gap", "ns") is not None)
            assert lagger.watch_relists >= 1 and lagger._use_stream
            assert lagger.watch_restarts == 0
        finally:
            lagger.stop()
    finally:
        if remote is not None:
            remote.stop()
        server.stop()


@pytest.mark.parametrize("server_pkg", PKGS)
def test_remote_backed_cache_binds_as_the_store_does(server_pkg):
    """The port's scheduler cache over a RemoteStore (either package's
    server): the per-pod bind path, the echo through the mirror, and an
    audit that repairs nothing."""
    from volcano_tpu_torch.apiserver.remote import RemoteStore
    from volcano_tpu_torch.scheduler import Scheduler
    store_mod = _mod(server_pkg, "apiserver.store")
    http_mod = _mod(server_pkg, "apiserver.http")
    synth = _mod(server_pkg, "utils.synth")
    store = store_mod.ObjectStore()
    synth.populate_store(store, n_nodes=8, n_jobs=6, gang_size=4)
    server = http_mod.StoreHTTPServer(store, port=0)
    server.start()
    remote = RemoteStore(f"http://127.0.0.1:{server.port}", poll_timeout=1)
    remote.run()
    sched = Scheduler(remote, device="cpu")
    try:
        sched.cache.run()
        sched.run_once()
        assert sched.cache.flush_executors()
        bound = {p.metadata.key(): p.spec.node_name
                 for p in store.list("pods")}
        assert all(bound.values()) and len(bound) == 24
        assert sched.cache.anti_entropy()["divergent"] == []
        sched.run_once()
        assert sched.cache.flush_executors()
        assert {p.metadata.key(): p.spec.node_name
                for p in store.list("pods")} == bound
    finally:
        sched.cache.stop()
        remote.stop()
        server.stop()
