"""The port's write-ahead log (volcano_tpu_torch/apiserver/wal.py) held
against the JAX package's: every case of tests/test_wal.py runs on both
packages (``pkg``), and the same writes leave the same log records in
each. Then cross-recovery: a data directory written by either package's
WAL and checkpointer is recovered by the other, to the fingerprint the
writer's own recovery gives, in both directions.

The reference's mid-bulk compaction case runs twice: the anchor held
against the live store and the recovered one, and with a live HTTP
follower replicating throughout (the reference's own case), whose mirror
must end identical to both.

Tolerance: exact.
"""

import importlib
import json
import os
import struct
import threading
import zlib

import pytest

PKGS = ("volcano_tpu", "volcano_tpu_torch")


class Pkg:
    """One package's store, WAL, persistence, codec and fault helpers."""

    def __init__(self, name: str):
        self.name = name
        mod = lambda m: importlib.import_module(f"{name}.{m}")
        self.store_mod = mod("apiserver.store")
        self.wal = mod("apiserver.wal")
        self.persistence = mod("apiserver.persistence")
        self.codec = mod("apiserver.codec")
        self.faults = mod("sim.faults")
        self.test_utils = mod("utils.test_utils")
        self.ObjectStore = self.store_mod.ObjectStore
        self.ReadOnlyError = self.store_mod.ReadOnlyError


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


def _mk_wal(pkg, tmp_path, **kw):
    store = pkg.ObjectStore()
    wal = pkg.wal.WriteAheadLog(str(tmp_path), **kw)
    wal.attach(store)
    return store, wal


def _create(pkg, store, n, ns="wal", prefix="p"):
    for i in range(n):
        store.create("pods", pkg.test_utils.build_pod(
            ns, f"{prefix}{i}", "", "Pending",
            {"cpu": "1", "memory": "1Gi"}), skip_admission=True)


def _digest(store):
    lines = []
    for kind in ("pods", "nodes"):
        for o in store.list(kind):
            lines.append(f"{kind}/{o.metadata.namespace}/"
                         f"{o.metadata.name}/{o.metadata.resource_version}")
    return zlib.crc32("\n".join(sorted(lines)).encode())


def fingerprint(pkg, store) -> str:
    """Every stored object's key, rv and encoded bytes, the rv tail and
    the fence floor, hashed: one value per store, comparable across the
    packages (their codecs write the same bytes)."""
    h = zlib.crc32(f"rv={store.current_rv()} "
                   f"floor={store.fence_floor()}\n".encode())
    for kind in sorted(pkg.store_mod.KINDS):
        for o in sorted(store.list_refs(kind),
                        key=lambda o: store.key_of(kind, o)):
            line = json.dumps(pkg.codec.encode_object(kind, o),
                              sort_keys=True)
            h = zlib.crc32(f"{kind}/{store.key_of(kind, o)}@"
                           f"{o.metadata.resource_version}:{line}\n"
                           .encode(), h)
    return f"{h:08x}"


def _segments(tmp_path):
    return sorted(p for p in os.listdir(tmp_path)
                  if p.startswith("wal-") and p.endswith(".log"))


def test_round_trip_recovers_everything(pkg, tmp_path):
    store, wal = _mk_wal(pkg, tmp_path)
    _create(pkg, store, 17)
    store.bind_pods([(f"p{i}", "wal", f"node-{i % 3}") for i in range(17)])
    wal.pump()
    want = _digest(store)
    rv = store.current_rv()
    wal.close()
    rec, rep = pkg.wal.recover_store(str(tmp_path))
    assert rec.current_rv() == rv
    assert rep["entries_replayed"] == 34
    assert _digest(rec) == want


def test_round_trip_fingerprints_agree_across_packages(tmp_path):
    """The same writes through each package's WAL leave the same records
    (the encoder's parity at the record level; uids and timestamps are
    each store's own), and each log recovers to its store."""
    records = {}
    for name in PKGS:
        p = Pkg(name)
        d = tmp_path / name
        store, wal = _mk_wal(p, d)
        _create(p, store, 40)
        store.bind_pods([(f"p{i}", "wal", f"node-{i % 5}")
                         for i in range(40)])
        store.advance_fence(3)
        wal.pump()
        wal.close()
        live = fingerprint(p, store)
        rec, _ = p.wal.recover_store(str(d))
        assert fingerprint(p, rec) == live
        blobs = []
        for seg in _segments(d):
            data = (d / seg).read_bytes()
            off = 0
            while off < len(data):
                ln, _crc = struct.unpack_from("<II", data, off)
                payload = json.loads(data[off + 8:off + 8 + ln])
                if payload["t"] == "e":
                    # uids and timestamps are each store's own
                    for e in payload["e"]:
                        e[3]["metadata"].pop("uid", None)
                        e[3]["metadata"].pop("creation_timestamp", None)
                blobs.append(payload)
                off += 8 + ln
        records[name] = blobs
    assert records["volcano_tpu"] == records["volcano_tpu_torch"]


def test_record_framing_is_len_crc_payload(pkg, tmp_path):
    store, wal = _mk_wal(pkg, tmp_path)
    _create(pkg, store, 1)
    wal.pump()
    wal.close()
    data = (tmp_path / _segments(tmp_path)[0]).read_bytes()
    off = 0
    payloads = []
    while off < len(data):
        ln, crc = struct.unpack_from("<II", data, off)
        payload = data[off + 8:off + 8 + ln]
        assert zlib.crc32(payload) == crc
        payloads.append(json.loads(payload))
        off += 8 + ln
    assert payloads[0]["t"] == "seg"
    assert payloads[1]["t"] == "e"
    assert pkg.wal.pack_record(b"x")[:4] == struct.pack("<I", 1)


def test_rv_sequencer_reanchors_after_recovery(pkg, tmp_path):
    store, wal = _mk_wal(pkg, tmp_path)
    _create(pkg, store, 5)
    wal.pump()
    wal.close()
    rec, _ = pkg.wal.recover_store(str(tmp_path))
    rec.create("pods", pkg.test_utils.build_pod(
        "wal", "after", "", "Pending", {"cpu": "1", "memory": "1Gi"}),
        skip_admission=True)
    assert rec.current_rv() == 6


def test_torn_tail_truncates_to_clean_prefix(pkg, tmp_path):
    store, wal = _mk_wal(pkg, tmp_path)
    _create(pkg, store, 9)
    wal.pump()
    prefix = _digest(store)
    _create(pkg, store, 1, prefix="late")
    wal.pump()
    wal.close()
    pkg.faults.tear_tail(str(tmp_path / _segments(tmp_path)[-1]), 6)
    rec, rep = pkg.wal.recover_store(str(tmp_path))
    assert rep["torn_records_truncated"] == 1
    assert rep["truncated_bytes"] > 0
    assert rec.current_rv() == 9
    assert _digest(rec) == prefix
    rec2, rep2 = pkg.wal.recover_store(str(tmp_path))
    assert rep2["torn_records_truncated"] == 0
    assert _digest(rec2) == prefix


def test_mid_log_bit_flip_refuses_with_evidence(pkg, tmp_path):
    store, wal = _mk_wal(pkg, tmp_path)
    for i in range(6):
        _create(pkg, store, 1, prefix=f"r{i}-")
        wal.pump()
    wal.close()
    seg = str(tmp_path / _segments(tmp_path)[0])
    flipped = pkg.faults.flip_bit(seg, offset=os.path.getsize(seg) // 2)
    with pytest.raises(pkg.wal.WalCorruptionError) as ei:
        pkg.wal.recover_store(str(tmp_path))
    err = ei.value
    assert err.segment.endswith(_segments(tmp_path)[0])
    # the evidence: the damaged record's offset (at or before the flipped
    # byte) and both CRCs
    assert 0 <= err.offset <= flipped
    assert err.expected_crc is not None and err.got_crc is not None
    assert err.expected_crc != err.got_crc
    assert "refus" in str(err)


def test_rv_gap_inside_crc_valid_record_refuses(pkg, tmp_path):
    store, wal = _mk_wal(pkg, tmp_path)
    _create(pkg, store, 3)
    wal.pump()
    wal.close()
    enc = pkg.codec.encode_object("pods", pkg.test_utils.build_pod(
        "wal", "forged", "", "Pending", {"cpu": "1", "memory": "1Gi"}))
    rec = json.dumps({"t": "e", "lo": 4, "hi": 6,
                      "e": [[4, "ADDED", "pods", enc],
                            [6, "ADDED", "pods", enc]]},
                     separators=(",", ":")).encode()
    with open(tmp_path / _segments(tmp_path)[-1], "ab") as f:
        f.write(pkg.wal.pack_record(rec))
    with pytest.raises(pkg.wal.WalCorruptionError) as ei:
        pkg.wal.recover_store(str(tmp_path))
    assert "gap inside record" in str(ei.value)


def test_concurrent_flushers_never_reorder_records(pkg, tmp_path):
    store, wal = _mk_wal(pkg, tmp_path)
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            wal.flush()

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for i in range(40):
            _create(pkg, store, 5, prefix=f"b{i}-")
    finally:
        stop.set()
        for t in threads:
            t.join()
    rv = store.current_rv()
    wal.close()
    rec, rep = pkg.wal.recover_store(str(tmp_path))
    assert rec.current_rv() == rv == 200
    assert rep["entries_replayed"] == 200


def test_bulk_run_lands_as_one_record_per_shard(pkg, tmp_path):
    store, wal = _mk_wal(pkg, tmp_path)
    n = 4096
    _create(pkg, store, n)
    wal.pump()
    before = wal.report()["records_written"]
    store.bind_pods([(f"p{i}", "wal", "node-0") for i in range(n)])
    wal.pump()
    assert store._shard_count(n) == 2
    assert wal.report()["records_written"] == before + 2
    wal.close()


def test_segment_rotation(pkg, tmp_path):
    store, wal = _mk_wal(pkg, tmp_path, segment_max_bytes=4096,
                         compact_interval=0)
    for i in range(30):
        _create(pkg, store, 3, prefix=f"s{i}-")
        wal.pump()
    assert len(_segments(tmp_path)) > 1
    rv = store.current_rv()
    wal.close()
    rec, _ = pkg.wal.recover_store(str(tmp_path))
    assert rec.current_rv() == rv


def test_enospc_degrades_then_heals_contiguously(pkg, tmp_path):
    faults = pkg.faults.FileFaults(enospc_after_bytes=1500)
    store, wal = _mk_wal(pkg, tmp_path, opener=faults.opener)
    created = 0
    degraded_seen = False
    for i in range(40):
        try:
            _create(pkg, store, 1, prefix=f"d{i}-")
            created += 1
        except pkg.ReadOnlyError as e:
            degraded_seen = True
            assert e.retry_after > 0
            break
        wal.pump()
    assert degraded_seen and faults.enospc_hits >= 1
    assert wal.report()["read_only"]
    faults.refill()
    wal.pump()
    assert not wal.report()["read_only"]
    _create(pkg, store, 1, prefix="post-heal-")
    wal.pump()
    rv = store.current_rv()
    wal.close()
    rec, rep = pkg.wal.recover_store(str(tmp_path))
    assert rec.current_rv() == rv
    assert rep["entries_replayed"] == created + 1


def test_eio_fsync_poisons_permanently(pkg, tmp_path):
    faults = pkg.faults.FileFaults(fail_fsync_after=1)
    store, wal = _mk_wal(pkg, tmp_path, opener=faults.opener)
    _create(pkg, store, 1)
    wal.pump()
    _create(pkg, store, 1, prefix="x")
    wal.pump()
    assert wal.report()["read_only"]
    with pytest.raises(pkg.ReadOnlyError):
        _create(pkg, store, 1, prefix="rejected")
    wal.pump()
    assert wal.report()["read_only"]


def test_poisoned_wal_drops_appends_instead_of_leaking(pkg, tmp_path):
    faults = pkg.faults.FileFaults(fail_fsync_after=0)
    store, wal = _mk_wal(pkg, tmp_path, opener=faults.opener)
    _create(pkg, store, 1)
    wal.pump()
    assert wal.report()["read_only"]
    assert wal.report()["pending_entries"] == 0
    for t in range(50):
        store.advance_fence(t + 1)
    wal.append_entries([(99, "ADDED", "pods", object())])
    assert len(wal._pending) == 0
    assert wal.report()["pending_entries"] == 0


def test_degrade_with_inflight_writer_neither_blocks_nor_deadlocks(
        pkg, tmp_path):
    import errno
    in_fsync = threading.Event()
    release = threading.Event()

    class BlockingFsyncFile:
        def __init__(self, raw):
            self._raw = raw

        def write(self, data):
            return self._raw.write(data)

        def fsync(self):
            in_fsync.set()
            release.wait(timeout=10.0)
            raise OSError(errno.EIO, "injected: fsync failed")

        def fileno(self):
            return self._raw.fileno()

        def close(self):
            self._raw.close()

    store, wal = _mk_wal(
        pkg, tmp_path,
        opener=lambda p: BlockingFsyncFile(open(p, "ab", buffering=0)))
    _create(pkg, store, 1)
    flusher = threading.Thread(target=wal.flush, daemon=True)
    flusher.start()
    assert in_fsync.wait(5.0)
    writer = threading.Thread(
        target=lambda: _create(pkg, store, 1, prefix="inflight"),
        daemon=True)
    writer.start()
    writer.join(2.0)
    assert not writer.is_alive()
    release.set()
    flusher.join(5.0)
    assert not flusher.is_alive()
    assert wal.report()["read_only"]
    assert store.read_only_reason()
    with pytest.raises(pkg.ReadOnlyError):
        _create(pkg, store, 1, prefix="rejected")


def test_compaction_anchors_and_prunes_segments(pkg, tmp_path):
    store, wal = _mk_wal(pkg, tmp_path, segment_max_bytes=2048,
                         compact_interval=0)
    for i in range(20):
        _create(pkg, store, 2, prefix=f"c{i}-")
        wal.pump()
    assert len(_segments(tmp_path)) > 2
    anchor = wal.compact()
    assert anchor == store.current_rv()
    assert os.path.exists(tmp_path / "snapshot.json")
    assert len(_segments(tmp_path)) == 1
    _create(pkg, store, 1, prefix="tail-")
    wal.pump()
    rv = store.current_rv()
    want = _digest(store)
    wal.close()
    rec, rep = pkg.wal.recover_store(str(tmp_path))
    assert rep["snapshot_rv"] == anchor
    assert rec.current_rv() == rv
    assert _digest(rec) == want


def test_fence_floor_survives_recovery(pkg, tmp_path):
    store, wal = _mk_wal(pkg, tmp_path)
    _create(pkg, store, 3)
    store.advance_fence(7)
    wal.pump()
    wal.close()
    rec, rep = pkg.wal.recover_store(str(tmp_path))
    assert rep["fence_floor"] == 7
    assert rec.fence_floor() == 7


def test_snapshot_install_cuts_generation(pkg, tmp_path):
    store, wal = _mk_wal(pkg, tmp_path)
    _create(pkg, store, 4)
    wal.pump()
    old_gen = wal.report()["generation"]
    store.install_snapshot({"pods": []}, 100)
    wal.pump()
    assert wal.report()["generation"] == old_gen + 1
    _create(pkg, store, 1, prefix="post-")
    wal.pump()
    rv = store.current_rv()
    wal.close()
    rec, rep = pkg.wal.recover_store(str(tmp_path))
    assert rec.current_rv() == rv == 101
    assert rep["entries_replayed"] == 1


def test_compact_mid_bulk_recovers_the_live_store(pkg, tmp_path):
    """Compaction taken while a sharded bind is publishing (the settle
    barrier's hard case) leaves an anchor that recovers to the live
    store's fingerprint."""
    store, wal = _mk_wal(pkg, tmp_path)
    n = 4500
    _create(pkg, store, n, ns="sb")
    wal.pump()
    errs = []

    def bulk():
        try:
            pairs, missing = store.bind_pods(
                [(f"p{i}", "sb", f"node-{i % 7}") for i in range(n)])
            assert not missing and len(pairs) == n
        except Exception as e:
            errs.append(e)

    t = threading.Thread(target=bulk)
    t.start()
    compactions = 0
    while t.is_alive():
        wal.compact()
        compactions += 1
    t.join()
    assert not errs, errs
    assert compactions >= 1
    wal.pump()
    live = fingerprint(pkg, store)
    rv = store.current_rv()
    wal.close()
    rec, rep = pkg.wal.recover_store(str(tmp_path))
    assert rec.current_rv() == rv
    assert fingerprint(pkg, rec) == live
    assert rep["snapshot_rv"] > 0


def test_compact_mid_bulk_with_live_follower(pkg, tmp_path):
    """The same mid-bulk compaction with a follower replicating over
    HTTP from the first bind to the last: the mirror, the live store and
    the recovered store fingerprint the same."""
    http = importlib.import_module(f"{pkg.name}.apiserver.http")
    follower_mod = importlib.import_module(
        f"{pkg.name}.replication.follower")
    store, wal = _mk_wal(pkg, tmp_path)
    n = 4500
    _create(pkg, store, n, ns="sb")
    wal.pump()
    server = http.StoreHTTPServer(store, port=0)
    server.start()
    try:
        follower = follower_mod.FollowerReplica(
            "f1", follower_mod.HTTPReplicationSource(
                f"http://127.0.0.1:{server.port}"))
        follower.bootstrap()
        follower.start()
        errs = []

        def bulk():
            try:
                pairs, missing = store.bind_pods(
                    [(f"p{i}", "sb", f"node-{i % 7}") for i in range(n)])
                assert not missing and len(pairs) == n
            except Exception as e:
                errs.append(e)

        t = threading.Thread(target=bulk)
        t.start()
        compactions = 0
        while t.is_alive():
            wal.compact()
            compactions += 1
        t.join()
        assert not errs, errs
        assert compactions >= 1
        wal.pump()
        follower.stop()
        follower.sync_to_head()
        live = fingerprint(pkg, store)
        assert fingerprint(pkg, follower.store) == live
        rv = store.current_rv()
        wal.close()
        rec, rep = pkg.wal.recover_store(str(tmp_path))
        assert rec.current_rv() == rv
        assert fingerprint(pkg, rec) == live
        assert rep["snapshot_rv"] > 0
    finally:
        server.stop()


def test_report_shape(pkg, tmp_path):
    store, wal = _mk_wal(pkg, tmp_path)
    _create(pkg, store, 2)
    wal.pump()
    rep = wal.report()
    for key in ("durable_rv", "store_rv", "lag_entries", "segments",
                "fsyncs", "fsync_p99_ms", "append_p99_ms", "read_only",
                "generation"):
        assert key in rep
    assert rep["durable_rv"] == rep["store_rv"] == 2
    assert rep["lag_entries"] == 0
    wal.close()


def test_crash_point_kills_before_fsync(pkg, tmp_path):
    """The crash points (``pre-fsync``, ``post-fsync-pre-rename``,
    ``mid-compaction``): a child process SIGKILLed at the injection point
    leaves a directory that recovers to its last durable prefix. Each
    package reads its own variable."""
    import signal
    import subprocess
    import sys
    env_name = ("VOLCANO_WAL_CRASH" if pkg.name == "volcano_tpu"
                else pkg.wal.CRASH_ENV)
    script = (
        "import sys\n"
        f"from {pkg.name}.apiserver.store import ObjectStore\n"
        f"from {pkg.name}.apiserver.wal import WriteAheadLog\n"
        f"from {pkg.name}.utils.test_utils import build_pod\n"
        "s = ObjectStore(); w = WriteAheadLog(sys.argv[1]); w.attach(s)\n"
        "for r in range(4):\n"
        "    for i in range(5):\n"
        "        s.create('pods', build_pod('wal', f'r{r}-{i}', '', "
        "'Pending', {'cpu': '1', 'memory': '1Gi'}), skip_admission=True)\n"
        "    w.pump()\n"
        "    w.compact()\n")
    results = {}
    for point in ("pre-fsync", "post-fsync-pre-rename", "mid-compaction"):
        d = tmp_path / point
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env[env_name] = f"{point}:2"
        r = subprocess.run([sys.executable, "-c", script, str(d)], env=env,
                           cwd=os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))),
                           capture_output=True, timeout=120)
        assert r.returncode == -signal.SIGKILL, r.stderr.decode()
        rec, _ = pkg.wal.recover_store(str(d))
        results[point] = rec.current_rv()
    # pre-fsync: the second flush's record was written, not fsynced; the
    # page cache survives a process kill, so it recovers (5 or 10)
    assert results["pre-fsync"] in (5, 10)
    # the second compaction's snapshot or rename never completed: the
    # log still holds everything flushed
    assert results["post-fsync-pre-rename"] == 10
    assert results["mid-compaction"] == 10


@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]],
                         ids=["reference_to_port", "port_to_reference"])
def test_cross_recovery(writer, reader, tmp_path):
    """A data directory written by one package (checkpointer snapshot,
    compaction, WAL tail with binds, deletes and a fence) recovers in the
    other to the writer's own recovery fingerprint."""
    w, r = Pkg(writer), Pkg(reader)
    store, wal = _mk_wal(w, tmp_path, compact_interval=0)
    from_synth = importlib.import_module(f"{writer}.utils.synth")
    from_synth.populate_store(store, n_nodes=12, n_jobs=10, gang_size=4)
    wal.pump()
    wal.compact()
    store.bind_pods([(f"job{i}-task{k}", "default", f"node-{(i + k) % 12}")
                     for i in range(6) for k in range(4)])
    store.delete("pods", "job9-task3", "default", skip_admission=True)
    store.advance_fence(5)
    wal.pump()
    ckpt = w.persistence.StoreCheckpointer(store, str(tmp_path / "ckpt.json"))
    ckpt.checkpoint()
    wal.close()
    own, own_rep = w.wal.recover_store(str(tmp_path))
    other, other_rep = r.wal.recover_store(str(tmp_path))
    assert own_rep["entries_replayed"] == other_rep["entries_replayed"] > 0
    assert other_rep["snapshot_rv"] == own_rep["snapshot_rv"] > 0
    assert fingerprint(r, other) == fingerprint(w, own)
    # the checkpointer's snapshot loads in the other package too
    loaded, count = r.persistence.load_store(str(tmp_path / "ckpt.json"))
    assert count == sum(len(store.list_refs(k)) for k in
                        w.store_mod.KINDS)
    assert sorted(p.spec.node_name for p in loaded.list("pods")) == \
        sorted(p.spec.node_name for p in store.list("pods"))
