"""Store persistence: checkpoint and restore of the whole control-plane
state (the port's own copy of save_store and load_store from
volcano_tpu/apiserver/persistence.py).

Every object is serialized through the JSON codec to one snapshot file
and restored into a fresh store, whose watches fire during the restore
as an informer's initial list does. The simulator's snapshot-mode
scheduler restart (sim/engine.py) is the caller.

Left out of this port: the fsynced snapshot and the anchored save that
write-ahead-log compaction uses, and the periodic checkpointer.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

from .codec import decode_object, encode_object
from .store import KINDS, ObjectStore

SNAPSHOT_VERSION = 1


def save_store(store: ObjectStore, path: str) -> int:
    """Write an atomic snapshot; returns the number of objects saved.

    Safe to call while a sharded bulk patch has rvs reserved but
    unpublished (parked journal entries, a tail behind the allocation
    counter): the snapshot is taken under the store lock and records the
    allocation counter ``_rv``, not the journal tail, and the data of
    every committed object, even one whose journal entry is still parked.
    Restore re-anchors the sequencer at that counter, so a snapshot taken
    mid-flight never loses writes or replays a torn journal."""
    payload = {"version": SNAPSHOT_VERSION, "resource_version": 0,
               "objects": {}}
    count = 0
    with store._lock:
        payload["resource_version"] = store._rv
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
        os.replace(tmp, path)   # atomic on POSIX
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return count


def load_store(path: str, store: Optional[ObjectStore] = None,
               clock=None):
    """Restore a snapshot into ``store`` (or a new one). Objects replay
    through create, firing watches like an informer's initial list.

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
    with open(path) as f:
        payload = json.load(f)
    if payload.get("version") != SNAPSHOT_VERSION:
        raise ValueError(f"unsupported snapshot version "
                         f"{payload.get('version')!r}")
    if store is None:
        store = ObjectStore(clock=clock) if clock is not None else ObjectStore()
    count = 0
    for kind, items in payload["objects"].items():
        if kind not in KINDS:
            continue
        for data in items:
            store.create(kind, decode_object(kind, data))
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
