"""The durability gate (the port's own copy of volcano_tpu/sim/durability.py;
``python -m volcano_tpu_torch.sim.cli durability``,
docs/design/durability.md).

Proves the write-ahead journal's crash-consistency story end to end,
in two tiers:

**In-process fault episodes** — deterministic storage faults through
the WAL's ``opener=`` seam (:mod:`volcano_tpu_torch.sim.faults`):

* *torn tail*: a power cut mid-record (simulated by chopping bytes off
  the final record) is truncated away by recovery, and the recovered
  store is bit-identical to the durable prefix;
* *bit flip*: a CRC-failing record with durable records after it makes
  recovery REFUSE, loudly, with segment/offset/CRC evidence;
* *disk full*: ENOSPC mid-append winds the segment back to a clean
  prefix and flips the store read-only — the HTTP edge answers
  structured 503 + Retry-After — then a freed-space retry heals the
  gate and the log replays contiguously (no rv gap from the episode).

**Process crash episodes** — a REAL ``vc-apiserver`` child is
SIGKILLed (via ``VOLCANO_TPU_TORCH_WAL_CRASH``, apiserver/wal.py) at
each of the three injection points — ``pre-fsync`` (mid group-commit),
``post-fsync-pre-rename`` (compaction's snapshot is durable but not
yet installed), ``mid-compaction`` (snapshot installed, segment purge
interrupted) — then supervised back up, where it must replay its local
WAL. The writer reconciles its acked-op map (the bounded
acked-but-not-durable window is the documented contract, exactly
etcd's default), after which the journal/bind/ledger content
fingerprints must be bit-identical to an uninterrupted run of the same
seeded plan. The CLI runs the whole gate twice and requires the
fingerprints bit-identical across runs.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

from ..apiserver.wal import CRASH_ENV

#: the three SIGKILL injection points and the seeded count window for
#: how many crossings to allow before dying (pre-fsync crossings are
#: flushes — plentiful; the compaction points fire once per compact)
CRASH_POINTS = (("pre-fsync", 4, 14),
                ("post-fsync-pre-rename", 1, 2),
                ("mid-compaction", 1, 2))


# ---------------------------------------------------------------------------
# in-process episodes
# ---------------------------------------------------------------------------

def _mk_pod(name: str, ns: str = "dur"):
    from ..models.objects import ObjectMeta, Pod, PodSpec
    return Pod(metadata=ObjectMeta(name=name, namespace=ns),
               spec=PodSpec(scheduler_name="volcano"))


def _store_digest(store) -> int:
    """rv-inclusive content crc over every object — the in-process
    bit-identity check."""
    import zlib

    from ..apiserver.codec import encode_object
    from ..apiserver.store import KINDS
    crc = 0
    for kind in sorted(KINDS):
        objs = {f"{o.metadata.namespace}/{o.metadata.name}":
                encode_object(kind, o) for o in store.list(kind)}
        for key in sorted(objs):
            line = json.dumps(objs[key], sort_keys=True)
            crc = zlib.crc32(f"{kind}/{key}:{line}\n".encode(), crc)
    return crc


def episode_torn_tail(seed: int) -> dict:
    """Write, tear the final record, recover: the torn suffix is
    truncated and the survivor equals the durable prefix exactly."""
    from ..apiserver.store import ObjectStore
    from ..apiserver.wal import WriteAheadLog, recover_store
    from .faults import tear_tail
    d = tempfile.mkdtemp(prefix="vc-dur-torn-")
    try:
        store = ObjectStore()
        wal = WriteAheadLog(d, compact_interval=1e9)
        wal.attach(store)
        for i in range(12):
            store.create("pods", _mk_pod(f"torn-{i}"))
        wal.pump()
        prefix_digest = _store_digest(store)     # durable prefix state
        store.create("pods", _mk_pod("torn-last"))
        wal.pump()                               # the record to tear
        wal.close()
        seg = os.path.join(d, wal.segments()[-1])
        tear_tail(seg, nbytes=5 + (seed % 7))
        recovered, rep = recover_store(d)
        return {
            "torn_records_truncated": rep["torn_records_truncated"],
            "entries_replayed": rep["entries_replayed"],
            "prefix_identical":
                _store_digest(recovered) == prefix_digest,
            "rv_reanchored": recovered.current_rv() == 12,
        }
    finally:
        shutil.rmtree(d, ignore_errors=True)


def episode_bit_flip(seed: int) -> dict:
    """Mid-log corruption: recovery must refuse with evidence, never
    silently replay damaged history."""
    from ..apiserver.store import ObjectStore
    from ..apiserver.wal import (WalCorruptionError, WriteAheadLog,
                                 recover_store)
    from .faults import flip_bit
    d = tempfile.mkdtemp(prefix="vc-dur-flip-")
    try:
        store = ObjectStore()
        wal = WriteAheadLog(d, compact_interval=1e9)
        wal.attach(store)
        for i in range(6):                   # one record per pump so a
            store.create("pods", _mk_pod(f"flip-{i}"))
            wal.pump()                       # mid-file flip has records
        wal.close()                          # durable after it
        seg = os.path.join(d, wal.segments()[-1])
        flip_bit(seg, offset=os.path.getsize(seg) // 2, seed=seed)
        try:
            recover_store(d)
            return {"refused": False, "evidence": False}
        except WalCorruptionError as e:
            return {"refused": True,
                    "evidence": (e.offset >= 0 and bool(e.segment)
                                 and e.expected_crc is not None
                                 and e.got_crc is not None)}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def episode_disk_full(seed: int) -> dict:
    """ENOSPC mid-append: read-only degradation with a structured 503 +
    Retry-After at the HTTP edge, heal on freed space, and a contiguous
    log afterwards."""
    from ..apiserver.http import ApiError, StoreClient, StoreHTTPServer
    from ..apiserver.store import ObjectStore
    from ..apiserver.wal import WriteAheadLog, recover_store
    from .faults import FileFaults
    d = tempfile.mkdtemp(prefix="vc-dur-enospc-")
    server = None
    try:
        faults = FileFaults(enospc_after_bytes=2300)
        store = ObjectStore()
        wal = WriteAheadLog(d, compact_interval=1e9,
                            opener=faults.opener)
        wal.attach(store)
        server = StoreHTTPServer(store, host="127.0.0.1", port=0)
        server.start()
        client = StoreClient(f"http://127.0.0.1:{server.port}",
                             timeout=5.0, client_id="dur-enospc")
        accepted = 0
        got_503 = False
        retry_after = None
        for i in range(40):
            try:
                client.create("pods", _mk_pod(f"full-{i}"))
                accepted += 1
            except ApiError as e:
                if e.code == 503:
                    got_503 = True
                    retry_after = e.retry_after
                    break
            wal.pump()      # deterministic flush between writes
        degraded = wal.report()["read_only"]
        faults.refill()     # operator frees space
        wal.pump()          # retry re-lands the wound-back batch
        healed = not wal.report()["read_only"]
        client.create("pods", _mk_pod("full-after-heal"))
        wal.pump()
        wal.close()
        live_digest = _store_digest(store)
        recovered, rep = recover_store(d)
        return {
            "accepted_before_full": accepted,
            "degraded": degraded,
            "http_503": got_503,
            "retry_after": retry_after,
            "healed": healed,
            "contiguous_after_heal":
                _store_digest(recovered) == live_digest,
            "entries_replayed": rep["entries_replayed"],
        }
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# process crash episodes
# ---------------------------------------------------------------------------

def _proc_run(seed: int, pods: int, nodes: int, watchdog,
              crash: Optional[Tuple[str, int]] = None,
              label: str = "baseline") -> dict:
    """One seeded writer plan against a real ``vc-apiserver --data-dir``
    child; with ``crash=(point, nth)`` the child is armed to SIGKILL
    itself at that WAL injection point and is supervised back up
    mid-plan. Returns the writer verdict + content fingerprints."""
    from ..replication.chaos import (ChaosWriter, ReplicaProcess,
                                     _content_digests, _free_port,
                                     _http_json, _wait_until)
    d = tempfile.mkdtemp(prefix=f"vc-dur-{label}-")
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    argv = ["--host", "127.0.0.1", "--port", str(port),
            "--serving-shards", "0",
            "--data-dir", d,
            "--wal-flush-interval", "0.02",
            "--checkpoint-interval", "1.5"]
    extra_env = {}
    if crash is not None:
        extra_env[CRASH_ENV] = f"{crash[0]}:{crash[1]}"
    proc = ReplicaProcess(f"dur-{label}", argv, url, seed=seed,
                          max_restarts=3, extra_env=extra_env)
    out: dict = {"label": label}
    try:
        proc.start()
        if not proc.wait_ready(60.0):
            raise RuntimeError(f"{label}: apiserver failed to start:\n"
                               + "\n".join(proc.tail(10)))
        writer = ChaosWriter([url], seed, pods=pods, nodes=nodes)
        done = threading.Event()

        def _drive() -> None:
            # setup included: the armed crash may fire on the node
            # creates' flushes, so the whole plan runs under the
            # supervisor loop below
            try:
                writer.setup_nodes()
                writer.run_slice(0, len(writer.plan))
            finally:
                done.set()

        t = threading.Thread(target=_drive, daemon=True)
        t.start()
        crashed = restarted = False
        while not done.is_set():
            watchdog.check()
            if crash is not None and not proc.alive():
                crashed = True
                restarted = proc.supervise()   # crash env NOT re-armed
                if not proc.wait_ready(60.0):
                    raise RuntimeError(
                        f"{label}: restart failed:\n"
                        + "\n".join(proc.tail(10)))
            done.wait(0.1)
        t.join(timeout=30.0)
        if crash is not None and not crashed:
            # the plan finished before the injection point fired (can
            # happen when compaction pacing lags the plan): kill + wait
            # for the arm to trip, or fall back to a plain SIGKILL so
            # the recovery path still runs
            _wait_until(lambda: not proc.alive(), 8.0, watchdog,
                        interval=0.1)
            if not proc.alive():
                crashed = True
            else:
                proc.sigkill()
                crashed = True
            restarted = proc.supervise()
            if not proc.wait_ready(60.0):
                raise RuntimeError(f"{label}: restart failed:\n"
                                   + "\n".join(proc.tail(10)))
        # reconcile the acked-but-not-durable window, then the final
        # state must equal the expected map exactly
        writer.replay()
        lost = writer.verify()
        if lost:
            writer.replay()
            lost = writer.verify()
        snap = _http_json(url + "/replicate/snapshot", timeout=10.0)
        bind_fp, ledger_fp = _content_digests(snap)
        out.update({
            "crashed": crashed,
            "restarted": restarted,
            "recovered_wal": any("recovered rv=" in line
                                 for line in proc.log),
            "writer_repairs": writer.repairs,
            "lost_after_replay": len(lost),
            "bind_fingerprint": bind_fp,
            "ledger_fingerprint": ledger_fp,
            "restarts": proc.restarts,
        })
        return out
    finally:
        proc.terminate()
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def run_durability(seed: int = 47, pods: int = 72, nodes: int = 8,
                   watchdog_s: float = 420.0,
                   verbose: bool = False) -> dict:
    """One full durability run; returns the flat verdict dict the CLI
    gates on (module docstring has the scenario)."""
    from ..replication.chaos import _Watchdog
    rng = random.Random(seed ^ 0xD07A)
    verdict: dict = {"seed": seed, "watchdog_fired": False}
    watchdog = _Watchdog(watchdog_s, lambda: None)
    t0 = time.perf_counter()
    try:
        verdict["torn_tail"] = episode_torn_tail(seed)
        verdict["bit_flip"] = episode_bit_flip(seed)
        verdict["disk_full"] = episode_disk_full(seed)

        baseline = _proc_run(seed, pods, nodes, watchdog)
        verdict["baseline"] = baseline
        episodes = []
        for point, lo, hi in CRASH_POINTS:
            nth = rng.randint(lo, hi)
            ep = _proc_run(seed, pods, nodes, watchdog,
                           crash=(point, nth), label=point)
            ep["nth"] = nth
            ep["fingerprints_identical"] = (
                ep["bind_fingerprint"] == baseline["bind_fingerprint"]
                and ep["ledger_fingerprint"]
                == baseline["ledger_fingerprint"])
            episodes.append(ep)
            if verbose:
                print(f"  episode {point}: {json.dumps(ep)}")
        verdict["episodes"] = episodes
        verdict["bind_fingerprint"] = baseline["bind_fingerprint"]
        verdict["ledger_fingerprint"] = baseline["ledger_fingerprint"]
    except TimeoutError:
        verdict["watchdog_fired"] = True
    finally:
        watchdog.cancel()
    verdict["elapsed_s"] = round(time.perf_counter() - t0, 1)
    return verdict


def durability_checks(v1: dict, v2: dict) -> Dict[str, bool]:
    """The pass/fail map over a double run (bit-identity across runs is
    itself one of the checks)."""
    torn = v1.get("torn_tail", {})
    flip = v1.get("bit_flip", {})
    full = v1.get("disk_full", {})
    eps = v1.get("episodes", [])
    by_point = {e.get("label"): e for e in eps}
    checks = {
        "watchdog_quiet": not v1.get("watchdog_fired", True)
                          and not v2.get("watchdog_fired", True),
        "torn_tail_truncated":
            torn.get("torn_records_truncated", 0) >= 1
            and torn.get("prefix_identical", False)
            and torn.get("rv_reanchored", False),
        "bit_flip_refused": flip.get("refused", False)
                            and flip.get("evidence", False),
        "disk_full_503": full.get("degraded", False)
                         and full.get("http_503", False)
                         and full.get("retry_after") is not None,
        "disk_full_healed": full.get("healed", False)
                            and full.get("contiguous_after_heal",
                                         False),
        "baseline_clean":
            v1.get("baseline", {}).get("lost_after_replay", 1) == 0,
    }
    for point, _lo, _hi in CRASH_POINTS:
        ep = by_point.get(point, {})
        checks[f"{point}_crashed"] = ep.get("crashed", False) \
            and ep.get("restarted", False)
        checks[f"{point}_recovered"] = ep.get("recovered_wal", False)
        checks[f"{point}_fingerprints"] = \
            ep.get("lost_after_replay", 1) == 0 \
            and ep.get("fingerprints_identical", False)
    checks["double_run_identical"] = (
        v1.get("bind_fingerprint") is not None
        and v1.get("bind_fingerprint") == v2.get("bind_fingerprint")
        and v1.get("ledger_fingerprint")
        == v2.get("ledger_fingerprint"))
    return checks


__all__ = ["run_durability", "durability_checks", "episode_torn_tail",
           "episode_bit_flip", "episode_disk_full", "CRASH_POINTS"]
