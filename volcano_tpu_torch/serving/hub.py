"""Sharded watch hub: fan-out serving over the store journal (the port's
own copy of volcano_tpu/serving/hub.py, docs/design/serving.md).

The store's synchronous watch bus is built for the handful of in-process
informers (cache, controllers); a serving edge with thousands of remote
watchers needs a different shape. The hub subscribes NOTHING on the
store — it is a pure journal consumer:

* **Shards** — subscribers hash by client id onto N dispatch shards
  (crc32, so placement is a pure function of the id and double runs are
  identical). Each shard reads the journal once per round from the
  minimum cursor of its subscribers and fans the burst out; one shard's
  slow consumer never blocks another shard's dispatch.
* **Cursors** — every subscriber carries a persistent journal cursor
  (the rv-sorted, gap-free journal from the bind pipeline is the
  stream). A cursor that falls off the journal window gets a structured
  ``relist`` frame — the client re-lists and re-anchors, exactly the
  RemoteStore resync path — instead of silently missing events.
* **Coalescing** — everything a dispatch round finds for one subscriber
  lands in ONE frame: a 50k-bind flush reaches an interested client as
  a handful of framed batches (one per published journal extent seen),
  not 50k deliveries. ``volcano_serving_batches_total`` vs
  ``volcano_serving_events_total`` is the measured ratio.
* **Server-side filters** — per-subscriber kind sets and field filters
  evaluated in the hub, ONCE per distinct filter per burst (the native
  ``attr_eq_filter_pairs`` entry classifies a whole burst in one call
  when the filter is a declared attribute equality, while the store's
  ``NATIVE_PUBLISH`` switch is on; the Python filter otherwise). Filter
  FLIPS keep the store's watch lifecycle semantics: pass→fail delivers
  DELETED, fail→pass delivers ADDED, only pass→pass is MODIFIED.

Frames are plain dicts carrying journal object REFS (the store replaces
objects wholesale, never mutates — the same property the journal
relies on); the HTTP layer encodes them at the wire. Frame chain
integrity: each frame carries ``prev`` (the previous frame's ``to_rv``)
so a client can detect a lost frame and ``rewind`` — the storm gate's
fault-recovery contract.

Two drive modes: ``start()`` runs one dispatch thread per shard (the
serving process), ``pump()`` dispatches synchronously (the simulator's
deterministic tick hook and tests).
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from typing import Callable, List, Optional

from ..apiserver.store import KINDS, ObjectStore
from ..metrics import metrics as m
from ..models.job_info import _fastmodel
from .admission import AdmissionController


class Subscription:
    """One client's session on the hub. Owned by exactly one shard."""

    MAX_OUTBOX = 256   # frames; overflow resets the subscriber via relist
    #                    (a consumer that stopped draining re-lists rather
    #                    than pinning unbounded memory server-side)

    def __init__(self, client_id: str, tenant: str, kinds, filter_attr,
                 filter_fn, cursor: int):
        self.hub = None   # backref set at subscribe (relist accounting)
        self.client_id = client_id
        self.tenant = tenant
        self.kinds = frozenset(kinds) if kinds else None
        # ((a0, a1), expected) — declared attribute equality, the native
        # classification path; filter_fn is the authority when both given
        self.filter_attr = filter_attr
        self.filter_fn = filter_fn
        self.cursor = int(cursor)       # last journal rv this sub covered
        self.last_framed = int(cursor)  # to_rv of the last frame enqueued
        # the rv this session was anchored at, frozen at subscribe time.
        # The streaming handler's hello frame MUST advertise this, not
        # the live cursor: shard dispatch can enqueue frames and advance
        # ``cursor`` before the handler writes its hello, and a hello
        # ahead of the queued frames makes the client count every one of
        # them as a duplicate (or skip them as already-applied).
        self.anchor = int(cursor)
        self.outbox: deque = deque()
        self.cond = threading.Condition()
        # keys currently PASSING the filter from this subscriber's view —
        # the old_p half of the flip classification (the journal has no
        # old object). Primed from the store at subscribe time.
        self._passing: set = set()
        self.frames_sent = 0
        self.events_sent = 0
        self.relists = 0
        self.closed = False

    @property
    def filtered(self) -> bool:
        return self.filter_attr is not None or self.filter_fn is not None

    def filter_key(self):
        if self.filter_attr is not None:
            (a0, a1), exp = self.filter_attr
            return ("attr", a0, a1, exp)
        if self.filter_fn is not None:
            return ("fn", id(self.filter_fn))
        return None

    def _passes(self, o) -> bool:
        if self.filter_fn is not None:
            return bool(self.filter_fn(o))
        (a0, a1), exp = self.filter_attr
        return getattr(getattr(o, a0, None), a1, None) == exp

    # -- consumer side -----------------------------------------------------

    def take_frames(self) -> List[dict]:
        """Drain everything queued (non-blocking; the pump-mode client)."""
        with self.cond:
            frames = list(self.outbox)
            self.outbox.clear()
        return frames

    def next_frame(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Block for the next frame (the streaming HTTP handler)."""
        with self.cond:
            if not self.outbox:
                self.cond.wait(timeout)
            return self.outbox.popleft() if self.outbox else None

    # -- shard side (shard lock held) --------------------------------------

    def _enqueue(self, frame: dict) -> None:
        overflowed = False
        with self.cond:
            if len(self.outbox) >= self.MAX_OUTBOX:
                # slow consumer: reset via relist instead of growing
                frame = {"relist": True, "rv": frame.get("to_rv",
                                                         frame.get("rv", 0)),
                         "prev": self.last_framed}
                if self.hub is not None:
                    frame["epoch"] = self.hub.epoch
                self.outbox.clear()
                self.relists += 1
                overflowed = True
            self.outbox.append(frame)
            self.cond.notify_all()
        if overflowed and self.hub is not None:
            self.hub._note_relist()


class HubShard:
    """One dispatch shard: a set of subscribers + the journal read loop."""

    def __init__(self, index: int, store: ObjectStore, hub: "ServingHub"):
        self.index = index
        self.store = store
        self.hub = hub
        self.lock = threading.Lock()
        self.subs: List[Subscription] = []
        self._thread: Optional[threading.Thread] = None

    # -- membership --------------------------------------------------------

    def add(self, sub: Subscription) -> None:
        with self.lock:
            self.subs.append(sub)

    def remove(self, sub: Subscription) -> None:
        with self.lock:
            if sub in self.subs:
                self.subs.remove(sub)
        sub.closed = True
        with sub.cond:
            sub.cond.notify_all()

    def depth(self) -> int:
        with self.lock:
            return sum(len(s.outbox) for s in self.subs)

    def pressure(self) -> tuple:
        """(total queued frames, worst outbox fill fraction) — the
        backpressure surface: a fill fraction approaching 1.0 means a
        subscriber is about to take the overflow-relist reset."""
        with self.lock:
            depths = [len(s.outbox) for s in self.subs]
        total = sum(depths)
        worst = max(depths, default=0) / float(Subscription.MAX_OUTBOX)
        return total, worst

    # -- dispatch ----------------------------------------------------------

    def dispatch_once(self, timeout: float = 0.0) -> int:
        """One fan-out round: read the journal once from the shard's
        minimum cursor, deliver ONE coalesced frame per subscriber with
        news, relist cursors that fell off the window. Returns frames
        enqueued."""
        with self.lock:
            subs = list(self.subs)
        if not subs:
            if timeout:
                self.hub._stop.wait(timeout)
            return 0
        frames = 0
        head, tail = self.store.journal_window()
        # structured relist for cursors that fell off the journal window
        # (the window rolled past them, or a snapshot restore cleared it)
        for sub in subs:
            if sub.cursor + 1 < head:
                self._relist(sub, tail)
                frames += 1
        min_cursor = min(sub.cursor for sub in subs)
        burst, tail, resync = self.hub._shared_burst(min_cursor, head,
                                                     timeout)
        if resync:
            # the window moved between our check and the read (or the
            # journal was force-cleared): re-anchor every lagging cursor
            head, tail = self.store.journal_window()
            for sub in subs:
                if sub.cursor < tail and sub.cursor + 1 < head:
                    self._relist(sub, tail)
                    frames += 1
            return frames
        if burst is None:
            return frames
        events = burst.events
        epoch = self.hub.epoch
        encoder = self.hub.encoder
        enc = burst.encoded(encoder) if encoder is not None else None
        from bisect import bisect_right
        for sub in subs:
            if sub.cursor >= tail:
                continue
            # per-frame latency is attributed per SUBSCRIBER (the clock
            # starts when this subscriber's selection starts, not when
            # the round started) — the shared burst index means the
            # first consumer pays the build and everyone else measures
            # only their own slice
            t0 = time.perf_counter()
            start = bisect_right(burst.rvs, sub.cursor)
            delivered, idxs = self._select(sub, burst, start)
            considered = len(events) - start
            sub.cursor = tail
            if not delivered:
                continue   # cursor advanced silently: nothing of interest
            frame = {"prev": sub.last_framed,
                     "from_rv": events[start][0], "to_rv": tail,
                     "events": delivered, "coalesced_from": considered,
                     "epoch": epoch}
            if enc is not None:
                # shared per-event object bytes: encoded ONCE per burst,
                # every subscriber's frame carries refs into the same
                # list (the wire wrapper re-labels per-sub actions)
                frame["encoded"] = [enc[i] for i in idxs]
            sub.last_framed = tail
            sub._enqueue(frame)
            sub.frames_sent += 1
            sub.events_sent += len(delivered)
            frames += 1
            self.hub._note_frame(len(delivered),
                                 (time.perf_counter() - t0) * 1000.0)
        self.hub._note_depth(self.index, *self.pressure())
        return frames

    def _relist(self, sub: Subscription, tail: int) -> None:
        """Push the structured relist signal and re-anchor the cursor:
        the client must re-list and resume from ``rv`` (exactly the
        informer resync-after-watch-expiry contract)."""
        sub._enqueue({"relist": True, "rv": tail, "prev": sub.last_framed,
                      "epoch": self.hub.epoch})
        sub.cursor = tail
        sub.last_framed = tail
        sub._passing.clear()
        sub.relists += 1
        self.hub._note_relist()

    def _select(self, sub: Subscription, burst: "_BurstIndex",
                start: int):
        """Apply the subscriber's kind + field filters to the burst's
        ``[start:]`` slice, classifying flips as lifecycle transitions
        (see module doc). Per-sub cost is proportional to DELIVERED
        events, not burst size: the burst index precomputes, once per
        distinct filter per round, the verdict vector, the passing
        indices and a failing-key map — so 1k identically-filtered
        subscribers pay one classification plus their own slices.

        Returns ``(delivered, idxs)`` — the delivered event tuples plus
        their burst indices, so the caller can attach shared per-event
        encoded bytes without re-deriving positions."""
        from bisect import bisect_left
        events = burst.events
        kinds = sub.kinds
        if not sub.filtered:
            if kinds is None:
                # firehose: the tail slice is cached per start index and
                # SHARED across every unfiltered subscriber at the same
                # cursor (frames carry refs, never mutate)
                return burst.tail_slice(start), range(start, len(events))
            out = []
            for kind in kinds:
                idx = burst.kind_idx().get(kind)
                if idx:
                    out.extend(idx[bisect_left(idx, start):])
            if len(kinds) > 1:
                out.sort()
            return [events[i] for i in out], out
        pass_set, pass_idx = burst.filter_index(sub)
        keys = burst.keys()
        key_idx = burst.key_idx()
        passing = sub._passing
        # candidate indices: every passing event past the cursor, plus
        # FAILING events whose key this subscriber currently sees as
        # passing (the potential pass->fail flips) — including keys that
        # BECOME passing within this very burst (add-then-flip). Cost is
        # O(delivered + |passing|), never O(burst).
        cand = pass_idx[bisect_left(pass_idx, start):]
        flip_keys = set(passing)
        flip_keys.update(keys[i] for i in cand)
        fail_idx = []
        for key in flip_keys:
            for i in key_idx.get(key, ()):
                if i >= start and i not in pass_set:
                    fail_idx.append(i)
        if fail_idx:
            cand = sorted(set(cand).union(fail_idx))
        out = []
        idxs = []
        for i in cand:
            rv, action, kind, o = events[i]
            if kinds is not None and kind not in kinds:
                continue
            key = keys[i]
            old_p = key in passing
            if action == "DELETED":
                if old_p:
                    passing.discard(key)
                    out.append((rv, "DELETED", kind, o))
                    idxs.append(i)
                continue
            if i in pass_set:
                passing.add(key)
                # fail->pass (or a fresh ADDED) surfaces as ADDED; only
                # pass->pass is MODIFIED — the four delivery paths of
                # the store's filtered watches, evaluated hub-side
                out.append((rv, "MODIFIED" if old_p else "ADDED", kind, o))
                idxs.append(i)
            elif old_p:
                passing.discard(key)
                out.append((rv, "DELETED", kind, o))
                idxs.append(i)
        return out, idxs

    # -- threaded mode -----------------------------------------------------

    def run_loop(self) -> None:
        while not self.hub._stop.is_set():
            try:
                self.dispatch_once(timeout=self.hub.poll_timeout)
            except Exception:
                import logging
                logging.getLogger(__name__).exception(
                    "hub shard %d dispatch failed", self.index)
                self.hub._stop.wait(0.2)


class _BurstIndex:
    """Shared indexes over one fetched burst: rvs for cursor bisects,
    (kind, key) per event, per-kind and per-key index lists, the (o, o)
    pair list the native classifier consumes, per DISTINCT filter the
    passing index set, cached firehose tail slices, and (when the hub
    has an encoder) the per-event encoded object bytes. Everything here
    is computed at most once per BURST no matter how many subscribers —
    or how many SHARDS (the hub keeps a small cross-shard cache, see
    ``ServingHub._shared_burst``) — consume it: the server-side cost of
    1k identically-filtered watchers is ONE classification and ONE
    serialization pass.

    Lazy memoization is guarded by an RLock because shard dispatch
    threads share one index; builders are idempotent so the lock only
    prevents duplicated work and torn ``_pairs``/``_id2idx`` pairs."""

    def __init__(self, store, events: list):
        self.store = store
        self.events = events
        self.rvs = [e[0] for e in events]
        self._lock = threading.RLock()
        self._keys: Optional[list] = None
        self._kind_idx: Optional[dict] = None
        self._key_idx: Optional[dict] = None
        self._pairs: Optional[list] = None
        self._id2idx: Optional[dict] = None
        self._filters: dict = {}
        self._slices: dict = {}
        self._encoded: Optional[list] = None
        self._encoder = None

    def keys(self) -> list:
        with self._lock:
            if self._keys is None:
                key_of = self.store.key_of
                self._keys = [(e[2], key_of(e[2], e[3]))
                              for e in self.events]
            return self._keys

    def kind_idx(self) -> dict:
        with self._lock:
            if self._kind_idx is None:
                idx: dict = {}
                for i, e in enumerate(self.events):
                    idx.setdefault(e[2], []).append(i)
                self._kind_idx = idx
            return self._kind_idx

    def key_idx(self) -> dict:
        """(kind, key) -> [indices] over the whole burst (shared by
        every filtered subscriber's flip lookup)."""
        with self._lock:
            if self._key_idx is None:
                idx: dict = {}
                for i, key in enumerate(self.keys()):
                    idx.setdefault(key, []).append(i)
                self._key_idx = idx
            return self._key_idx

    def tail_slice(self, start: int) -> list:
        """``events[start:]``, cached per start index: N firehose
        subscribers at the same cursor share ONE slice instead of each
        copying the burst."""
        with self._lock:
            got = self._slices.get(start)
            if got is None:
                got = self._slices[start] = self.events[start:]
            return got

    def encoded(self, encoder) -> list:
        """Per-event encoded object bytes, serialized ONCE per burst.
        ``encoder(kind, obj) -> bytes`` is the hub's wire codec; the
        per-subscriber frame wrapper carries rv/action/kind, so the
        heavy object payload is byte-shared even when a filtered
        subscriber re-labels the action."""
        with self._lock:
            if self._encoded is None or self._encoder is not encoder:
                self._encoded = [encoder(e[2], e[3]) for e in self.events]
                self._encoder = encoder
            return self._encoded

    def _pair_list(self) -> list:
        if self._pairs is None:
            self._pairs = [(e[3], e[3]) for e in self.events]
            # the index key is the PAIR TUPLE's identity, not the
            # object's: a DELETED journal entry reuses the ADDED/
            # MODIFIED entry's object instance, but each pair tuple
            # here is freshly allocated and unique per index
            self._id2idx = {id(p): i
                            for i, p in enumerate(self._pairs)}
        return self._pairs

    def filter_index(self, sub: Subscription) -> tuple:
        """(pass_set, pass_idx) for the subscriber's filter, computed
        once per distinct filter per burst — natively via the
        ``attr_eq_filter_pairs`` entry for declared attribute equalities
        ((o, o) pairs: pass->pass membership IS the verdict, one C call
        per burst per filter), Python ``filter_fn`` otherwise."""
        with self._lock:
            fkey = sub.filter_key()
            got = self._filters.get(fkey)
            if got is not None:
                return got
            events = self.events
            pass_idx = None
            if sub.filter_attr is not None and sub.filter_fn is None \
                    and ObjectStore.NATIVE_PUBLISH:
                (a0, a1), exp = sub.filter_attr
                # missing_is_none: a burst holds every kind, and an
                # object without the attribute reads as None, as in
                # Subscription._passes
                delivery, _ = _fastmodel().attr_eq_filter_pairs(
                    self._pair_list(), a0, a1, exp, True)
                id2idx = self._id2idx
                pass_idx = sorted(id2idx[id(p)] for p in delivery)
            if pass_idx is None:
                pass_idx = [i for i, e in enumerate(events)
                            if sub._passes(e[3])]
            self._filters[fkey] = (set(pass_idx), pass_idx)
            return self._filters[fkey]


class ServingHub:
    """The multi-tenant watch hub over one store's journal."""

    def __init__(self, store: ObjectStore, shards: int = 4,
                 admission: Optional[AdmissionController] = None,
                 poll_timeout: float = 0.5, epoch: int = 0,
                 encoder: Optional[Callable] = None):
        self.store = store
        self.admission = admission
        self.poll_timeout = poll_timeout
        # replica epoch stamped into every frame: a federated client
        # whose cursor is handed to a PEER replica's hub sees the epoch
        # change and knows the prev-chain now names a different journal
        # mirror (docs/design/federation.md)
        self.epoch = int(epoch)
        # optional wire codec ``(kind, obj) -> bytes``; when set, frames
        # carry shared per-event encoded payloads (see _BurstIndex)
        self.encoder = encoder
        self.shards = [HubShard(i, store, self)
                       for i in range(max(1, int(shards)))]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        # small cross-shard burst cache: 8 shards fetching overlapping
        # journal ranges in the same storm reuse ONE index + encoding
        # (keyed by rv coverage; entries invalidated by window checks)
        self._bursts: deque = deque(maxlen=4)
        self._burst_lock = threading.Lock()
        # bounded rolling window of per-frame fan-out latencies (ms) for
        # the bench percentiles; the histogram metric is the full record
        self.fanout_ms: deque = deque(maxlen=65536)
        self.frames_total = 0
        self.events_total = 0
        self.relists_total = 0

    # -- shared burst cache --------------------------------------------------

    def _shared_burst(self, cursor: int, head: int,
                      timeout: float) -> tuple:
        """``(burst, tail, resync)`` covering ``(cursor, tail]``. A
        cached burst is reused when it starts exactly where this shard
        needs to resume AND is still inside the journal window (a
        snapshot install or force-clear moves ``head`` past every stale
        burst, invalidating the cache for free). Reuse may serve a tail
        slightly behind the store head — the shard's next round catches
        up; what it never does is skip or reorder journal rvs."""
        with self._burst_lock:
            for b in self._bursts:
                if (b.rvs and b.rvs[0] >= head
                        and b.rvs[0] <= cursor + 1 <= b.rvs[-1]):
                    return b, b.rvs[-1], False
        events, tail, resync = self.store.events_since(cursor, timeout)
        if resync:
            return None, tail, True
        if not events:
            return None, tail, False
        burst = _BurstIndex(self.store, events)
        with self._burst_lock:
            self._bursts.appendleft(burst)
        return burst, tail, False

    def clear_bursts(self) -> None:
        """Drop cached bursts (a follower calls this after a snapshot
        install replaces the mirror wholesale)."""
        with self._burst_lock:
            self._bursts.clear()

    def set_epoch(self, epoch: int) -> None:
        """Advance the replica epoch stamped into frames (leadership
        changed underneath this replica's mirror)."""
        self.epoch = int(epoch)

    # -- subscriber lifecycle ----------------------------------------------

    def shard_of(self, client_id: str) -> HubShard:
        return self.shards[zlib.crc32(client_id.encode())
                           % len(self.shards)]

    def subscribe(self, client_id: str, tenant: str = "default",
                  kinds=None, filter_attr=None,
                  filter_fn: Optional[Callable] = None,
                  since_rv: Optional[int] = None,
                  prime: bool = True) -> Subscription:
        """Create a session. ``since_rv=None`` anchors at the journal
        tail (new events only — the list half is the client's job);
        an explicit rv replays the journal from there, or relists if it
        already fell off the window. Raises ThrottledError past the
        tenant's subscription cap."""
        if self.admission is not None:
            self.admission.acquire_subscription(tenant)
        try:
            tail = self.store.current_rv()
            cursor = tail if since_rv is None else int(since_rv)
            sub = Subscription(client_id, tenant, kinds, filter_attr,
                               filter_fn, cursor)
            sub.hub = self
            if prime and sub.filtered and cursor == tail:
                # old_p baseline: what a list-then-watch client already
                # sees passing (kind-scoped; the whole store otherwise).
                # ONLY valid when the cursor anchors exactly at the tail
                # — the store's CURRENT state is neither the view at a
                # past rv nor at a FUTURE one (a failed-over cursor ahead
                # of a lagging mirror), so both replaying and ahead
                # subscribers start from an empty baseline instead
                # (first-pass events classify as ADDED, exactly informer
                # relist semantics; an ahead cursor just holds until the
                # mirror's journal passes it).
                for kind in (sub.kinds or KINDS):
                    for o in self.store.list_refs(kind):
                        if sub._passes(o):
                            sub._passing.add((kind,
                                              self.store.key_of(kind, o)))
            self.shard_of(client_id).add(sub)
            return sub
        except BaseException:
            if self.admission is not None:
                self.admission.release_subscription(tenant)
            raise

    def unsubscribe(self, sub: Subscription) -> None:
        self.shard_of(sub.client_id).remove(sub)
        if self.admission is not None:
            self.admission.release_subscription(sub.tenant)

    def rewind(self, sub: Subscription, rv: int) -> None:
        """Client-detected frame loss: replay the journal from ``rv``
        (the client's last applied frame chain point). If ``rv`` already
        fell off the window the next dispatch relists instead."""
        shard = self.shard_of(sub.client_id)
        with shard.lock:
            sub.cursor = min(sub.cursor, int(rv))
            sub.last_framed = int(rv)

    def subscriber_count(self) -> int:
        return sum(len(s.subs) for s in self.shards)

    # -- dispatch ----------------------------------------------------------

    def pump(self) -> int:
        """Synchronous dispatch round over every shard (deterministic —
        the simulator's tick hook and the tests)."""
        return sum(shard.dispatch_once(timeout=0.0)
                   for shard in self.shards)

    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        for shard in self.shards:
            t = threading.Thread(target=shard.run_loop, daemon=True,
                                 name=f"hub-shard-{shard.index}")
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        # wake the journal waiters so shard threads observe the stop
        try:
            with self.store._lock:
                self.store._journal_cond.notify_all()
        except Exception:
            pass
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

    # -- accounting ----------------------------------------------------------

    def _note_frame(self, n_events: int, latency_ms: float) -> None:
        with self._lock:
            self.frames_total += 1
            self.events_total += n_events
            self.fanout_ms.append(latency_ms)
        m.inc(m.SERVING_BATCHES)
        m.inc(m.SERVING_EVENTS, n_events)
        m.observe(m.SERVING_FANOUT_LATENCY, latency_ms)

    def _note_relist(self) -> None:
        with self._lock:
            self.relists_total += 1
        m.inc(m.SERVING_RELISTS)

    def _note_depth(self, shard: int, depth: int,
                    backpressure: float = 0.0) -> None:
        m.set_gauge(m.SERVING_SHARD_DEPTH, depth, shard=str(shard))
        m.set_gauge(m.SERVING_SHARD_BACKPRESSURE,
                    round(backpressure, 4), shard=str(shard))

    def fanout_percentiles(self) -> dict:
        with self._lock:
            lat = sorted(self.fanout_ms)
        if not lat:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "count": 0}
        at = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
        return {"p50": round(at(0.50), 3), "p95": round(at(0.95), 3),
                "p99": round(at(0.99), 3), "count": len(lat)}

    def report(self) -> dict:
        pressures = {s.index: s.pressure() for s in self.shards}
        return {
            "epoch": self.epoch,
            "shards": len(self.shards),
            "subscribers": self.subscriber_count(),
            "shard_depths": {i: p[0] for i, p in pressures.items()},
            "shard_backpressure": {i: round(p[1], 4)
                                   for i, p in pressures.items()},
            "frames_total": self.frames_total,
            "events_total": self.events_total,
            "relists_total": self.relists_total,
            "fanout_ms": self.fanout_percentiles(),
        }
