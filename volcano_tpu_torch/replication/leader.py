"""Leader half of journal replication (the port's own copy of
volcano_tpu/replication/leader.py, docs/design/federation.md).

The leader does not push: followers PULL contiguous journal ranges
through a :class:`ReplicationSource`, either in-process (the simulator
and gate) or over the apiserver's chunked-NDJSON ``/replicate`` routes
(:class:`~.follower.HTTPReplicationSource` is the client). Every frame
is stamped with the leader's fencing epoch — the same monotonic token the write fence enforces — so a deposed
leader's frames are rejectable at the follower no matter how late they
arrive.

Object payloads are CLONED once per ship: a follower mirror must never
alias the leader's live objects (two stores replacing "wholesale, never
mutating" is only safe when they don't share instances).
"""

from __future__ import annotations

from typing import Optional

from ..apiserver.codec import encode_object
from ..apiserver.store import KINDS, ObjectStore
from ..metrics import metrics as m
from ..utils.fastclone import fast_clone


def snapshot_payload(store: ObjectStore) -> dict:
    """Wire-format whole-store snapshot for cold-follower bootstrap
    (the ``/replicate/snapshot`` response): a consistent cut under the
    store lock — encoded objects keyed exactly as the follower's
    ``install_snapshot`` expects, the ALLOCATION counter as the anchor
    rv (the persistence-era rule: a snapshot mid-flight re-anchors the
    sequencer at the counter, never at the journal tail), and the
    newest observed leadership epoch."""
    payload: dict = {"objects": {}}
    with store._lock:
        payload["rv"] = store._rv
        for kind in sorted(KINDS):
            payload["objects"][kind] = {
                key: encode_object(kind, o)
                for key, o in store._objects[kind].items()}
    payload["epoch"] = store.fence_floor()
    return payload


class ReplicationSource:
    """In-process pull source over one leader store.

    ``epoch`` is the leadership token this source ships under. The gate
    deposes a leader by constructing a source with a stale epoch — the
    follower must reject its frames (the fencing contract) even though
    the journal bytes themselves are plausible.
    """

    def __init__(self, store: ObjectStore, epoch: int = 1):
        self.store = store
        self.epoch = int(epoch)
        self.frames_shipped = 0
        self.events_shipped = 0
        self.snapshots_shipped = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def current_rv(self) -> int:
        return self.store.current_rv()

    def collect(self, cursor: int, timeout: float = 0.0,
                epoch: Optional[int] = None) -> tuple:
        """``(entries, tail, gone, epoch)`` — the contiguous journal
        range ``(cursor, tail]`` as ``[(rv, action, kind, clone)]``.
        ``gone=True`` means the cursor fell off the journal window and
        the follower must bootstrap from :meth:`snapshot`. ``epoch``
        overrides the stamped epoch (the deposed-leader test)."""
        stamped = self.epoch if epoch is None else int(epoch)
        events, tail, resync = self.store.events_since(cursor, timeout)
        if resync:
            return [], tail, True, stamped
        entries = [(rv, action, kind, fast_clone(o))
                   for rv, action, kind, o in events]
        if entries:
            self.frames_shipped += 1
            self.events_shipped += len(entries)
            self._note_ship(len(entries))
        return entries, tail, False, stamped

    def snapshot(self) -> tuple:
        """``(objects, rv, epoch)`` with ``objects`` in the decoded
        ``{kind: {key: clone}}`` shape ``install_snapshot`` takes."""
        objects: dict = {}
        with self.store._lock:
            rv = self.store._rv
            for kind in KINDS:
                objects[kind] = {key: fast_clone(o)
                                 for key, o
                                 in self.store._objects[kind].items()}
        self.snapshots_shipped += 1
        return objects, rv, self.epoch

    @staticmethod
    def _note_ship(n_events: int) -> None:
        m.inc(m.REPLICATION_FRAMES)
        m.inc(m.REPLICATION_EVENTS, n_events)

    def report(self) -> dict:
        return {"epoch": self.epoch,
                "rv": self.store.current_rv(),
                "frames_shipped": self.frames_shipped,
                "events_shipped": self.events_shipped,
                "snapshots_shipped": self.snapshots_shipped}
