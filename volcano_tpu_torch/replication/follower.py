"""Follower half of journal replication (the port's own copy of
volcano_tpu/replication/follower.py, docs/design/federation.md).

A :class:`FollowerReplica` owns a full :class:`ObjectStore` mirror and
keeps it current by pulling contiguous journal ranges from a
replication source. Three contracts make the mirror trustworthy:

* **Leader rvs, verbatim** — frames install through
  :meth:`ObjectStore.apply_replicated`, which stamps the LEADER's rv on
  every object and extends the mirror journal at the same positions.
  The cross-replica anti-entropy fingerprint audit (count, max rv, crc
  over sorted ``key@rv`` lines) only proves anything because both sides
  speak the same rv space. This is the opposite of the RemoteStore
  cache, which deliberately re-stamps mirror-local rvs.
* **Fencing** — every frame carries the shipping leader's epoch; the
  follower advances its store's fence floor as newer epochs appear, so
  a deposed leader's late frames raise ``FencedError`` at the mirror
  install (counted, rejected, mirror untouched).
* **Gap recovery, structured** — a non-contiguous frame raises
  ``ReplicationGapError``; the follower retries from its applied rv
  (catch-up relist) and falls back to a whole-store snapshot bootstrap
  when the leader's journal window has rolled past it. The serving
  hub's cached bursts are dropped after a bootstrap — mirror consumers
  take the relist like any cursor that outlived the window.

Mirror progress state (``_epoch``, ``_applied``) is guarded by
``_lock``.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.parse
from typing import Optional

from ..apiserver.codec import decode_object
from ..apiserver.store import (FencedError, ObjectStore,
                               ReplicationGapError)
from ..metrics import metrics as m
from ..utils.backoff import seeded_backoff

log = logging.getLogger(__name__)


class HTTPReplicationSource:
    """The in-process :class:`ReplicationSource` contract spoken over
    the apiserver's chunked-NDJSON ``/replicate`` routes. One held
    streaming connection per catch-up; any transport failure surfaces
    to the caller's seeded-backoff restart (the RemoteStore idiom)."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.epoch = 0   # newest epoch observed on the wire

    def _get_json(self, path: str) -> dict:
        import http.client
        u = urllib.parse.urlsplit(self.base_url)
        conn = http.client.HTTPConnection(u.hostname or "127.0.0.1",
                                          u.port or 80,
                                          timeout=self.timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise ConnectionError(f"{path}: HTTP {resp.status}")
            return json.loads(data)
        finally:
            try:
                conn.close()
            except Exception:
                pass

    def current_rv(self) -> int:
        return int(self._get_json("/rv")["rv"])

    def collect(self, cursor: int, timeout: float = 0.0,
                epoch: Optional[int] = None) -> tuple:
        """One ``/replicate`` frame from ``cursor``: ``(entries, tail,
        gone, epoch)`` with decoded object payloads. Reads the stream
        until the first data/gone frame (pings keep waiting alive up to
        ``timeout``)."""
        import http.client
        u = urllib.parse.urlsplit(self.base_url)
        hb = max(1.0, min(self.timeout, max(timeout, 1.0)))
        conn = http.client.HTTPConnection(u.hostname or "127.0.0.1",
                                          u.port or 80,
                                          timeout=self.timeout + hb)
        try:
            conn.request("GET",
                         f"/replicate?since={int(cursor)}&heartbeat={hb}")
            resp = conn.getresponse()
            if resp.status != 200:
                resp.read()
                raise ConnectionError(f"/replicate: HTTP {resp.status}")
            while True:
                line = resp.readline()
                if not line:
                    raise ConnectionError("replication stream closed")
                frame = json.loads(line)
                if "epoch" in frame:
                    self.epoch = max(self.epoch, int(frame["epoch"]))
                if frame.get("hello"):
                    continue
                if frame.get("ping"):
                    if timeout <= 0:
                        return [], int(frame["rv"]), False, self.epoch
                    continue
                if frame.get("gone"):
                    return [], int(frame["rv"]), True, self.epoch
                entries = [(int(rv), action, kind,
                            decode_object(kind, data))
                           for rv, action, kind, data
                           in frame["entries"]]
                return (entries, int(frame["to_rv"]), False,
                        int(frame["epoch"]))
        finally:
            try:
                conn.close()
            except Exception:
                pass

    def snapshot(self) -> tuple:
        payload = self._get_json("/replicate/snapshot")
        objects = {kind: {key: decode_object(kind, data)
                          for key, data in items.items()}
                   for kind, items in payload["objects"].items()}
        self.epoch = max(self.epoch, int(payload.get("epoch", 0)))
        return objects, int(payload["rv"]), self.epoch


class FollowerReplica:
    """One follower apiserver replica: mirror store + sync loop."""

    BACKOFF_BASE_S = 0.1
    BACKOFF_CAP_S = 5.0

    def __init__(self, name: str, source, store: Optional[ObjectStore]
                 = None, hub=None):
        self.name = name
        self.source = source
        self.store = store if store is not None else ObjectStore()
        # the replica's serving hub (set by the ReplicaSet); frames it
        # emits carry the epoch this follower has observed
        self.hub = hub
        self._lock = threading.Lock()
        self._epoch = 0      # newest leadership epoch observed
        self._applied = self.store.current_rv()   # mirror journal tail
        self._source_head = self._applied   # newest source rv observed
        self.frames_applied = 0
        self.events_applied = 0
        self.gaps_detected = 0
        self.catchup_relists = 0
        self.snapshot_bootstraps = 0
        self.fenced_frames = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- state surface ------------------------------------------------------

    def applied_rv(self) -> int:
        with self._lock:
            return self._applied

    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def lag(self) -> int:
        """Replication lag in rvs behind the source (the
        ``volcano_replication_follower_lag_rvs`` gauge)."""
        try:
            head = self.source.current_rv()
        except Exception:
            return -1
        with self._lock:
            if head > self._source_head:
                self._source_head = head
        lag = max(0, head - self.applied_rv())
        m.set_gauge(m.REPLICATION_LAG, lag, follower=self.name)
        return lag

    def lag_estimate(self) -> int:
        """Staleness bound WITHOUT a network round-trip: rvs behind the
        newest source head this follower has ever observed (frame tails
        and explicit ``lag()`` probes both advance it). A follower
        serving reads in degraded mode annotates responses with this —
        a read path must never block on a dead leader's ``/rv``."""
        with self._lock:
            return max(0, self._source_head - self._applied)

    def _observe_head_locked(self, head: int) -> None:
        if head > self._source_head:
            self._source_head = head

    def _observe_epoch_locked(self, epoch: int) -> None:
        """Record a newer leadership epoch: the mirror's fence floor
        advances with it, so apply_replicated rejects anything staler.
        The hub's frame annotation follows — federated clients see the
        epoch change on their next frame."""
        if epoch > self._epoch:
            self._epoch = epoch
            self.store.advance_fence(epoch)
            if self.hub is not None:
                self.hub.set_epoch(epoch)

    def observe_epoch(self, epoch: int) -> None:
        """A leadership change announced out-of-band (the lease watch
        in a real deployment; the ReplicaSet's failover here)."""
        with self._lock:
            self._observe_epoch_locked(int(epoch))

    # -- sync ---------------------------------------------------------------

    def apply_frame(self, entries, epoch: int) -> int:
        """Install one shipped frame at the leader's rvs. Raises
        ``FencedError`` on a stale epoch (frame rejected, mirror
        untouched) and ``ReplicationGapError`` on non-contiguity."""
        with self._lock:
            if epoch < self._epoch:
                self.fenced_frames += 1
                self._note(fenced=1)
                raise FencedError(
                    f"replication frame epoch {epoch} below follower "
                    f"{self.name} epoch {self._epoch}")
            self._observe_epoch_locked(epoch)
        try:
            tail = self.store.apply_replicated(entries, epoch=epoch)
        except FencedError:
            with self._lock:
                self.fenced_frames += 1
            self._note(fenced=1)
            raise
        with self._lock:
            self._applied = tail
            self._observe_head_locked(tail)
            self.frames_applied += 1
            self.events_applied += len(entries)
        return tail

    def bootstrap(self) -> int:
        """Whole-store snapshot install: the cold-start path and the
        catch-up of last resort when the leader's journal window rolled
        past this mirror.

        Ordering matters: the snapshot transfer and the store install
        both happen BEFORE any follower state (epoch, fence, hub)
        advances. An interrupted bootstrap — killed source mid-stream,
        truncated payload, a malformed object that fails derivation —
        must leave the mirror exactly as it was and be retried from
        scratch, not leave a half-observed epoch around a missing
        install."""
        objects, rv, epoch = self.source.snapshot()
        anchor = self.store.install_snapshot(objects, rv, epoch=epoch)
        with self._lock:
            self._observe_epoch_locked(int(epoch))
            self._applied = anchor
            self._observe_head_locked(anchor)
            self.snapshot_bootstraps += 1
        if self.hub is not None:
            # cached bursts describe pre-bootstrap journal ranges
            self.hub.clear_bursts()
        self._note(snapshots=1)
        return anchor

    def sync_once(self, timeout: float = 0.0) -> int:
        """One pull+apply round; returns events applied. A gap inside
        the shipped range triggers ONE structured catch-up relist from
        the mirror's true applied rv; ``gone`` (or a catch-up that
        itself gaps) bootstraps from snapshot."""
        entries, tail, gone, epoch = self.source.collect(
            self.applied_rv(), timeout)
        if gone:
            self.bootstrap()
            return 0
        if not entries:
            with self._lock:
                self._observe_epoch_locked(int(epoch))
                self._observe_head_locked(int(tail))
            return 0
        try:
            self.apply_frame(entries, epoch)
            return len(entries)
        except ReplicationGapError:
            with self._lock:
                self.gaps_detected += 1
                self.catchup_relists += 1
            self._note(gaps=1)
            entries, tail, gone, epoch = self.source.collect(
                self.applied_rv(), timeout)
            if gone:
                self.bootstrap()
                return 0
            if not entries:
                return 0
            try:
                self.apply_frame(entries, epoch)
                return len(entries)
            except ReplicationGapError:
                # the source cannot produce a contiguous continuation
                # of this mirror (a restore moved its history): the
                # snapshot is the only consistent re-anchor
                self.bootstrap()
                return 0

    def sync_to_head(self, max_rounds: int = 64) -> int:
        """Drain until the mirror reaches the source head (bounded —
        the settle loops of the gate and tests)."""
        applied = 0
        for _ in range(max_rounds):
            applied += self.sync_once(timeout=0.0)
            if self.lag() <= 0:
                break
        return applied

    # -- threaded mode --------------------------------------------------------

    def start(self) -> threading.Thread:
        """Continuous replication: pull with a blocking timeout, apply,
        seeded-backoff restart on any transport failure (the RemoteStore
        poll-loop idiom — a sync thread dying silently would freeze the
        mirror at a stale rv with nothing noticing)."""
        self._stop.clear()

        def loop() -> None:
            failures = 0
            while not self._stop.is_set():
                try:
                    self.sync_once(timeout=1.0)
                    failures = 0
                except FencedError:
                    failures = 0   # stale shipper; mirror is fine
                except Exception:
                    if self._stop.is_set():
                        return
                    failures += 1
                    delay = seeded_backoff(self.name, failures,
                                           self.BACKOFF_BASE_S,
                                           self.BACKOFF_CAP_S)
                    log.warning("follower %s sync failed (failure %d); "
                                "retrying in %.2fs", self.name, failures,
                                delay, exc_info=True)
                    self._stop.wait(delay)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"replica-{self.name}")
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- accounting -----------------------------------------------------------

    def _note(self, gaps: int = 0, snapshots: int = 0,
              fenced: int = 0) -> None:
        if gaps:
            m.inc(m.REPLICATION_GAPS, gaps, follower=self.name)
        if snapshots:
            m.inc(m.REPLICATION_SNAPSHOTS, snapshots, follower=self.name)
        if fenced:
            m.inc(m.REPLICATION_FENCED, fenced, follower=self.name)

    def report(self) -> dict:
        with self._lock:
            return {"name": self.name,
                    "epoch": self._epoch,
                    "applied_rv": self._applied,
                    "frames_applied": self.frames_applied,
                    "events_applied": self.events_applied,
                    "gaps_detected": self.gaps_detected,
                    "catchup_relists": self.catchup_relists,
                    "snapshot_bootstraps": self.snapshot_bootstraps,
                    "fenced_frames": self.fenced_frames}


class FollowerRole:
    """The role a plain follower apiserver (``--replicate-from``) serves
    under, in the shape of a federation member: ``StoreHTTPServer(member=
    FollowerRole(f))`` answers writes with a structured 503 +
    Retry-After and the leader's url as the hint, ``/leader`` names the
    leader, and reads carry the mirror's staleness.

    The reference's follower apiserver serves as a standalone one:
    ``/leader`` calls it the write target and it takes writes into its
    mirror, at rvs that the leader's next frame then contradicts (the
    follower drops them with its next bootstrap). The port's mirror takes
    writes from the leader's journal only."""

    def __init__(self, follower: FollowerReplica):
        self.follower = follower
        self.name = follower.name

    def role(self) -> str:
        return "follower"

    def accepts_writes(self) -> bool:
        return False

    def leader_hint(self) -> dict:
        return {"holder": "", "url": self.follower.source.base_url,
                "token": self.follower.epoch(), "live": True}

    def staleness(self) -> dict:
        f = self.follower
        return {"applied_rv": f.applied_rv(), "lag_rvs": f.lag_estimate(),
                "epoch": f.epoch()}

    def retry_after(self) -> float:
        return 1.0
