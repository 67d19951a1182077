"""Store persistence: checkpoint and restore of the whole control-plane
state (the port's own copy of volcano_tpu/apiserver/persistence.py).

Every object is serialized through the JSON codec to one snapshot file
and restored into a fresh store, whose watches fire during the restore
as an informer's initial list does. The simulator's snapshot-mode
scheduler restart (sim/engine.py) is the caller.

The snapshot is also the anchor of the write-ahead log (apiserver/wal.py):
compaction writes it fsynced and settled through ``save_store_anchored``,
and recovery reads it with ``load_snapshot_payload``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Optional

from .codec import decode_object, encode_object
from .store import KINDS, ObjectStore

SNAPSHOT_VERSION = 1


def save_store(store: ObjectStore, path: str, fsync: bool = False) -> int:
    """Write an atomic snapshot; returns the number of objects saved.

    Safe to call while a sharded bulk patch has rvs reserved but
    unpublished (parked journal entries, non-contiguous tail): the
    snapshot is taken under the store lock, records the ALLOCATION
    counter ``_rv`` (not the journal tail), and object data committed by
    interleaved writers — even writers whose journal entry is still
    parked behind the reservation — is captured. Restore re-anchors the
    sequencer at that counter, so a snapshot mid-flight never loses
    writes or replays a torn journal (tests/test_failover.py,
    TestParkedJournalRestore).

    ``fsync=True`` makes the snapshot crash-durable (file fsynced
    before the rename, directory fsynced after) — the WAL compaction
    contract (docs/design/durability.md) requires it; the periodic
    checkpointer keeps the cheap page-cache write."""
    count, _rv = save_store_anchored(store, path, fsync=fsync)
    return count


def save_store_anchored(store: ObjectStore, path: str,
                        fsync: bool = False,
                        extra: Optional[dict] = None,
                        settle: bool = False) -> tuple:
    """:func:`save_store` returning ``(count, anchor_rv)`` — the rv the
    payload actually recorded, which WAL compaction needs to decide
    which segments the snapshot supersedes. ``extra`` merges additional
    top-level keys into the payload (the WAL stamps its generation and
    the store's fence floor rides along for recovery re-anchoring).

    ``settle=True`` waits for the journal settle barrier before reading
    the anchor. The plain checkpointer path deliberately tolerates a
    mid-flight anchor (the rv counter may be ahead of published
    content), but WAL compaction must NOT: it prunes every segment at
    or below the anchor, so a mid-bulk anchor taken above
    still-publishing shards would silently drop those entries from
    both the snapshot and the log. The settle wait releases the store
    lock while blocked, so in-flight shard publishes finish rather
    than deadlock."""
    payload = {"version": SNAPSHOT_VERSION, "resource_version": 0,
               "objects": {}}
    if extra:
        payload.update(extra)
    count = 0
    with store._lock:
        if settle:
            store._wait_journal_settled_locked()
        anchor = payload["resource_version"] = store._rv
        payload["fence_floor"] = store._fence_floor
        for kind in sorted(KINDS):
            items = list(store._objects[kind].values())
            payload["objects"][kind] = [encode_object(kind, o) for o in items]
            count += len(items)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".snapshot-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        if fsync:
            from .wal import _maybe_crash
            _maybe_crash("post-fsync-pre-rename")
        os.replace(tmp, path)   # atomic on POSIX
        if fsync:
            from .wal import _fsync_dir
            _fsync_dir(directory)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return count, anchor


def load_snapshot_payload(path: str) -> dict:
    """Read + version-check a snapshot file without installing it (the
    WAL recovery path installs rv-preserving itself)."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("version") != SNAPSHOT_VERSION:
        raise ValueError(f"unsupported snapshot version "
                         f"{payload.get('version')!r}")
    return payload


def load_store(path: str, store: Optional[ObjectStore] = None,
               clock=None):
    """Restore a snapshot into ``store`` (or a new one). Objects replay
    through create with admission skipped (they were admitted when first
    written), firing watches like an informer's initial list.

    Returns (store, object_count). The change journal is cleared after the
    replay: the replayed creates carry restart-local rvs that misrepresent
    history, and watchers from before the restart must see a journal gap
    (resync) rather than silently missing events.

    The write-fence floor is deliberately NOT restored: it is
    incarnation-local state that re-derives from the lease object's
    persisted ``fencingToken`` at the next acquisition (the lease
    ConfigMap itself is in the snapshot). A restorer that must close the
    window before that acquisition carries the old floor over explicitly
    (sim/engine.py ``_swap_store_from_snapshot``)."""
    payload = load_snapshot_payload(path)
    if store is None:
        store = ObjectStore(clock=clock) if clock is not None else ObjectStore()
    count = 0
    for kind, items in payload["objects"].items():
        if kind not in KINDS:
            continue
        for data in items:
            o = decode_object(kind, data)
            store.create(kind, o, skip_admission=True)
            count += 1
    with store._lock:
        store._rv = max(store._rv, int(payload.get("resource_version", 0)))
        store._journal.clear()
        # re-anchor the journal sequencer at the restored rv: the cleared
        # journal window starts fresh (clients resync on the gap) and no
        # parked entries can refer to pre-restore reservations
        store._journal_tail = store._rv
        store._journal_parked.clear()
    return store, count


class StoreCheckpointer:
    """Periodic snapshotting (the etcd WAL-interval equivalent)."""

    def __init__(self, store: ObjectStore, path: str, interval: float = 30.0):
        self.store = store
        self.path = path
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def checkpoint(self) -> int:
        return save_store(self.store, self.path)

    def start(self) -> threading.Thread:
        def loop():
            while not self._stop.is_set():
                # interval <= 0 means shutdown-checkpoint only (a zero
                # wait would busy-spin full-store serializations)
                self._stop.wait(self.interval if self.interval > 0
                                else None)
                if not self._stop.is_set():
                    try:
                        self.checkpoint()
                    except Exception:
                        pass   # next interval retries; state stays in memory
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self._thread

    def stop(self, final_checkpoint: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            # an in-flight periodic checkpoint must not finish AFTER the
            # final one and clobber it with older state
            self._thread.join(timeout=30.0)
            self._thread = None
        if final_checkpoint:
            try:
                self.checkpoint()
            except Exception:
                pass
