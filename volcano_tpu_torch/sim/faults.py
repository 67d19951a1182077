"""Fault injection for the simulator (the port's own copy of
volcano_tpu/sim/faults.py): flaky binds, API latency, node churn
schedules, evict storms, watch-delivery faults and mid-flush scheduler
crashes.

Four layers:

* **Live injectors** — :class:`FlakyBinder` wraps the recording binder
  with a seeded per-bind failure coin and a virtual-clock latency charge;
  failures take the production resync path (cache.resync_task →
  process_resync_tasks), which is exactly the machinery the simulator
  exists to stress. Its crash mode (:attr:`FlakyBinder.crash_after_binds`)
  commits a PREFIX of a flush and then dies, modeling a scheduler killed
  mid bind-flush — the store is left with partially bound gangs for the
  restarted scheduler to reconverge (docs/design/failover.md).
* **Watch faults** — :class:`FlakyWatch` wraps a subscriber's registered
  store watch and silently drops (or delays by one tick) a content-keyed
  fraction of deliveries, diverging the cache from the store exactly the
  way a lossy informer stream would; the anti-entropy reconciler
  (cache.anti_entropy) must detect and repair it. ``force_gap`` clears
  the store journal — the remote-watch "window rolled past" failure that
  forces a relist.
* **Scheduled faults** — :func:`synthesize_node_churn` /
  :func:`synthesize_evict_storms` emit plain events (drain/undrain,
  kill/re-add, storms) from a seeded RNG so they ride the same replayable
  stream as arrivals.
* **Storage faults** — :class:`FileFaults` feeds the write-ahead log's
  ``opener=`` seam (ENOSPC as a short write, EIO on fsync), and
  :func:`flip_bit` / :func:`tear_tail` damage a segment offline.
"""

from __future__ import annotations

import errno
import os
import random
import zlib
from dataclasses import dataclass, field
from typing import List, Optional

from ..utils.clock import Clock
from ..utils.test_utils import FakeBinder
from .events import Event, make_event


class SimulatedCrash(RuntimeError):
    """The injected scheduler death: raised by FlakyBinder's crash mode
    after a flush's prefix committed. Deliberately a batch-LEVEL error
    (raised from bind_batch, not per pod) so the dying cache takes the
    batch-failure path — resync-and-return, NO gang healing: a crashed
    process doesn't get to run compensation writes."""


@dataclass
class FaultConfig:
    seed: int = 0
    bind_fail_rate: float = 0.0      # per-pod store-bind failure probability
    api_latency_s: float = 0.0       # virtual seconds charged per store bind
    # targeted failure: pod keys ("ns/name") whose binds ALWAYS fail —
    # the deterministic poison-pod mode for quarantine testing (no
    # coin flips involved; the fail-rate RNG sequence is untouched)
    fail_pods: List[str] = field(default_factory=list)
    # node churn (over the workload horizon)
    flap_rate: float = 0.0           # drain+undrain pairs per virtual second
    flap_down_s: float = 5.0         # how long a flapped node stays drained
    kill_rate: float = 0.0           # node kill + re-add pairs per second
    kill_down_s: float = 10.0
    # evict storms
    storm_rate: float = 0.0          # storms per virtual second
    storm_fraction: float = 0.1      # fraction of bound pods deleted
    # watch-delivery faults (FlakyWatch over the cache's pod watch):
    # content-keyed per-delivery probabilities of a silent drop / a
    # one-tick delay — divergence for the anti-entropy pass to repair
    watch_drop_rate: float = 0.0
    watch_delay_rate: float = 0.0
    # fault-coin identity: "seq" keys on (key, per-key delivery
    # sequence), the commit-order key that sidesteps a timing-dependent
    # rv interleaving; "rv" keys on the delivered object's
    # resource_version directly. With the store's settle barrier
    # (docs/design/federation.md) rv assignment is itself a pure function
    # of commit order, so "rv" is just as stable, and a double run with
    # it is the proof
    watch_coin: str = "seq"


class FlakyBinder(FakeBinder):
    """Recording binder with deterministic failure + latency injection.

    Failure decisions come from one seeded RNG consumed in bind order;
    the cache executor is a single FIFO worker and the engine flushes it
    every tick, so the coin-flip sequence — and therefore the whole run —
    is reproducible from the seed. Failed binds raise, taking the
    production resilience path: resync with retry accounting, gang-atomic
    healing of the bound siblings, and quarantine past the retry budget
    (docs/design/resilience.md). ``failed_keys`` records every injected
    failure for test assertions. ``fail_pods`` is the targeted mode: the
    named pods ALWAYS fail (without consuming the fail-rate coin), so
    poison-pod quarantine is testable deterministically.
    """

    def __init__(self, store, clock: Clock, fail_rate: float = 0.0,
                 latency_s: float = 0.0, seed: int = 0, fail_pods=None):
        super().__init__(store)
        self.clock = clock
        self.fail_rate = fail_rate
        self.latency_s = latency_s
        self.fail_pods = set(fail_pods or ())
        self._rng = random.Random(seed ^ 0x5EED)
        self.failed_keys: List[str] = []
        self.attempts = 0
        # crash mode (docs/design/failover.md): when armed, the NEXT
        # bind_batch commits only its first `crash_after_binds` pods and
        # then raises SimulatedCrash — the scheduler died mid-flush,
        # leaving partial gangs in the store. `crashed` tells the engine
        # to perform the restart at its tick barrier.
        self.crash_after_binds: Optional[int] = None
        self.crashed = False
        # latency is ACCUMULATED here and charged to the clock by the
        # engine at the tick boundary (after the executor flush), never
        # from the executor thread: a mid-cycle clock mutation would
        # race concurrent ssn.clock.now() reads by time-dependent
        # plugins and break the bit-identical-replay contract
        self.pending_latency_s = 0.0

    def take_pending_latency(self) -> float:
        """Drain the accumulated virtual API latency. Called by the
        engine after flush_executors() — the flush barrier is the
        synchronization point, so no lock is needed."""
        charged, self.pending_latency_s = self.pending_latency_s, 0.0
        return charged

    def bind(self, pod, hostname: str) -> None:
        self.attempts += 1
        if self.latency_s:
            self.pending_latency_s += self.latency_s  # virtual round-trip
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        if key in self.fail_pods:
            self.failed_keys.append(key)
            raise RuntimeError(f"injected targeted bind failure for {key}")
        if self.fail_rate and self._rng.random() < self.fail_rate:
            self.failed_keys.append(key)
            raise RuntimeError(f"injected bind failure for {key}")
        super().bind(pod, hostname)

    def bind_batch(self, items) -> list:
        """Per-pod delegation through :meth:`bind` (failure injection
        keeps its coin order), with the crash mode layered on top: an
        armed crash commits only the burst's prefix, then raises —
        batch-level, so the dying cache resyncs WITHOUT healing (a dead
        process runs no compensation writes; the store keeps the partial
        gangs the restarted scheduler must reconverge)."""
        items = list(items)
        if self.crash_after_binds is not None:
            n = max(0, int(self.crash_after_binds))
            self.crash_after_binds = None
            self.crashed = True
            prefix = items[:n]
            if prefix:
                super().bind_batch(prefix)
            raise SimulatedCrash(
                f"scheduler killed mid-flush: {len(prefix)} of "
                f"{len(items)} binds committed")
        return super().bind_batch(items)


class FlakyWatch:
    """Seeded watch-delivery fault injector (docs/design/failover.md).

    Wraps ONE registered store :class:`~..apiserver.store.Watch`
    (typically the cache's pod watch) so a deterministic fraction of
    deliveries is silently dropped, or delayed until the engine's next
    tick — the informer-stream loss/reorder failure modes. The wrapped
    subscriber's view diverges from the store; nothing else in the system
    is told, which is the point: the anti-entropy reconciler has to FIND
    it.

    Determinism: each delivery's fate comes from a crc32 coin over
    ``(action, object key, per-key delivery sequence, seed)`` —
    commit-order-stable, so it is independent of thread timing AND of
    journal rv interleaving, identical across double runs (the same
    property the resync backoff jitter relies on). Where the journal's
    rv INTERLEAVING between the executor's bind/status-writeback commits
    and other writers is timing-dependent, every scheduling outcome stays
    bit-identical but an rv-keyed coin would turn the reordering
    semantic. A key's own delivery ORDER is commit order (writes to one
    object serialize), so the per-key sequence is the stable identity.
    ``coin="rv"`` keys on the delivered object's resource_version
    instead (FaultConfig.watch_coin). Bulk deliveries are coined per
    pair. Delayed
    deliveries are re-played in recorded order by
    :meth:`release_delayed` (the engine calls it at the top of each
    tick); the production handlers treat them like any stale event.
    """

    def __init__(self, seed: int = 0, drop_rate: float = 0.0,
                 delay_rate: float = 0.0, coin: str = "seq"):
        self.seed = seed
        self.drop_rate = drop_rate
        self.delay_rate = delay_rate
        # "seq" (default) or "rv": see FaultConfig.watch_coin
        self.coin = coin
        self.dropped = 0
        self.delayed = 0
        self._watch = None
        self._orig: dict = {}
        self._pending: List[tuple] = []
        # per-object-key delivery counter: survives wrap/unwrap cycles
        # (a restart re-wraps the new cache's watch mid-run; the commit
        # order of a key's writes is global, so the counter is too)
        self._key_seq: dict = {}

    # coin outcomes
    _DELIVER, _DROP, _DELAY = 0, 1, 2

    def _coin(self, action: str, o) -> int:
        key = o.metadata.key()
        if self.coin == "rv":
            ident = o.metadata.resource_version
        else:
            ident = self._key_seq.get(key, 0) + 1
            self._key_seq[key] = ident
        h = zlib.crc32(f"{action}:{key}:{ident}:{self.seed}".encode())
        u = (h % 10_000) / 10_000.0
        if u < self.drop_rate:
            return self._DROP
        if u < self.drop_rate + self.delay_rate:
            return self._DELAY
        return self._DELIVER

    def wrap(self, watch) -> None:
        """Interpose on a Watch's handlers in place (install AFTER the
        subscriber's initial sync replay — the list half of list+watch is
        not a stream and is not faulted)."""
        self.unwrap()
        self._watch = watch
        self._orig = {"on_add": watch.on_add, "on_update": watch.on_update,
                      "on_delete": watch.on_delete,
                      "on_bulk_update": watch.on_bulk_update}
        if watch.on_add is not None:
            watch.on_add = lambda o: self._deliver("ADDED", o,
                                                   self._orig["on_add"],
                                                   (o,))
        if watch.on_update is not None:
            watch.on_update = lambda old, new: self._deliver(
                "MODIFIED", new, self._orig["on_update"], (old, new))
        if watch.on_delete is not None:
            watch.on_delete = lambda o: self._deliver(
                "DELETED", o, self._orig["on_delete"], (o,))
        if watch.on_bulk_update is not None:
            watch.on_bulk_update = self._bulk

    def unwrap(self) -> None:
        """Restore the watch's original handlers AND drop any still-
        delayed deliveries: they hold closures over the unwrapped
        subscriber's handlers, and after a scheduler restart that
        subscriber is a discarded cache — replaying into it would mutate
        dead state (the restarted cache rebuilt from a full list, so the
        information is not lost, merely no longer an event)."""
        if self._watch is not None:
            for name, fn in self._orig.items():
                setattr(self._watch, name, fn)
        self._watch = None
        self._orig = {}
        self.dropped += len(self._pending)
        self._pending = []

    def _deliver(self, action: str, o, handler, args) -> None:
        fate = self._coin(action, o)
        if fate == self._DROP:
            self.dropped += 1
            return
        if fate == self._DELAY:
            self.delayed += 1
            self._pending.append((handler, args))
            return
        handler(*args)

    def _bulk(self, pairs) -> None:
        handler = self._orig["on_bulk_update"]
        keep = []
        for old, new in pairs:
            fate = self._coin("MODIFIED", new)
            if fate == self._DROP:
                self.dropped += 1
            elif fate == self._DELAY:
                self.delayed += 1
                self._pending.append((handler, ([(old, new)],)))
            else:
                keep.append((old, new))
        if keep:
            handler(keep)

    def release_delayed(self) -> int:
        """Deliver everything held back, in arrival order. Returns how
        many deliveries were released."""
        pending, self._pending = self._pending, []
        for handler, args in pending:
            handler(*args)
        return len(pending)

    @staticmethod
    def force_gap(store) -> None:
        """Roll the store's journal window past every subscriber: clears
        the journal so the next ``events_since`` from any older rv
        returns ``resync=True`` — the forced-relist path remote mirrors
        take when they fall behind the window."""
        with store._lock:
            store._journal.clear()


def synthesize_node_churn(cfg: FaultConfig, node_names: List[str],
                          horizon_s: float,
                          start_at: float = 0.0) -> List[Event]:
    """Drain/undrain flaps and kill/re-add cycles over ``horizon_s``.

    Every down event is paired with its recovery up front, so a dumped
    trace carries the full schedule (no RNG at apply time). Node specs
    for re-adds are resolved by the engine from its node catalog.
    """
    rng = random.Random(cfg.seed ^ 0xF1A9)
    events: List[Event] = []
    for rate, down_s, down_kind, up_kind in (
            (cfg.flap_rate, cfg.flap_down_s, "node_drain", "node_undrain"),
            (cfg.kill_rate, cfg.kill_down_s, "node_kill", "node_add")):
        if rate <= 0 or not node_names:
            continue
        t = start_at
        while True:
            t += rng.expovariate(rate)
            if t > start_at + horizon_s:
                break
            name = rng.choice(node_names)
            events.append(make_event(t, down_kind, name=name))
            events.append(make_event(t + down_s, up_kind, name=name))
    return events


def synthesize_evict_storms(cfg: FaultConfig, horizon_s: float,
                            start_at: float = 0.0) -> List[Event]:
    """Periodic storms deleting a seeded fraction of bound pods (the
    kubelet-pressure / node-OOM analogue)."""
    if cfg.storm_rate <= 0:
        return []
    rng = random.Random(cfg.seed ^ 0x5702)
    events: List[Event] = []
    t = start_at
    while True:
        t += rng.expovariate(cfg.storm_rate)
        if t > start_at + horizon_s:
            break
        events.append(make_event(t, "evict_storm",
                                 fraction=cfg.storm_fraction,
                                 seed=rng.randrange(1 << 30)))
    return events


def apply_evict_storm(store, event: Event) -> List[str]:
    """Delete ``fraction`` of currently bound pods, chosen by the event's
    own seed over the key-sorted pod list (order-independent of store
    internals). Returns the deleted keys."""
    bound = sorted((p.metadata.namespace, p.metadata.name)
                   for p in store.list_refs("pods") if p.spec.node_name)
    rng = random.Random(int(event.get("seed", 0)))
    k = int(len(bound) * float(event.get("fraction", 0.0)))
    victims = rng.sample(bound, k) if k else []
    deleted: List[str] = []
    for ns, name in victims:
        try:
            store.delete("pods", name, ns)
            deleted.append(f"{ns}/{name}")
        except KeyError:
            pass
    return deleted


# ---------------------------------------------------------------------------
# storage faults: the WAL's opener seam + offline segment damage
# ---------------------------------------------------------------------------

class FileFaults:
    """Deterministic storage-fault schedule for the WAL's ``opener=``
    seam (docs/design/durability.md).

    ``enospc_after_bytes`` — total bytes the "disk" accepts across every
    file opened through this schedule; the write that crosses the budget
    lands only its allowed PREFIX (real ENOSPC is a short write, which
    is exactly the torn record the WAL must wind back) and raises
    ``OSError(ENOSPC)``. Set to ``None`` for unlimited. ``refill()``
    models the operator freeing space — the next successful flush heals
    the read-only gate.

    ``fail_fsync_after`` — fsyncs to allow before every later fsync
    raises ``OSError(EIO)`` (the fsyncgate failure: page-cache state
    after a failed fsync is unknowable, so the WAL must poison itself,
    not retry). ``None`` disables.
    """

    def __init__(self, enospc_after_bytes: Optional[int] = None,
                 fail_fsync_after: Optional[int] = None):
        self.enospc_after_bytes = enospc_after_bytes
        self.fail_fsync_after = fail_fsync_after
        self.bytes_written = 0
        self.fsyncs = 0
        self.enospc_hits = 0
        self.eio_hits = 0

    def refill(self, budget: Optional[int] = None) -> None:
        """Free space: reset the byte budget (default: unlimited)."""
        self.bytes_written = 0
        self.enospc_after_bytes = budget

    def opener(self, path: str):
        """The ``WriteAheadLog(opener=...)`` entry point."""
        return FaultyFile(open(path, "ab", buffering=0), self)


class FaultyFile:
    """Unbuffered append file wrapper that injects the FileFaults
    schedule. Implements the exact surface the WAL touches: ``write``,
    ``fsync`` (the seam ``_do_fsync_locked`` prefers over
    ``os.fsync``), ``fileno``, ``close``."""

    def __init__(self, raw, faults: FileFaults):
        self._raw = raw
        self._faults = faults

    def write(self, data: bytes) -> int:
        f = self._faults
        if f.enospc_after_bytes is not None:
            allowed = f.enospc_after_bytes - f.bytes_written
            if len(data) > allowed:
                prefix = data[:max(0, allowed)]
                if prefix:                    # the torn partial write
                    self._raw.write(prefix)
                    f.bytes_written += len(prefix)
                f.enospc_hits += 1
                raise OSError(errno.ENOSPC, "injected: no space left "
                                             "on device")
        n = self._raw.write(data)
        f.bytes_written += n
        return n

    def fsync(self) -> None:
        f = self._faults
        if f.fail_fsync_after is not None \
                and f.fsyncs >= f.fail_fsync_after:
            f.eio_hits += 1
            raise OSError(errno.EIO, "injected: fsync I/O error")
        os.fsync(self._raw.fileno())
        f.fsyncs += 1

    def fileno(self) -> int:
        return self._raw.fileno()

    def close(self) -> None:
        self._raw.close()


def flip_bit(path: str, offset: Optional[int] = None,
             seed: int = 0) -> int:
    """Flip one bit in ``path`` (default: a seeded position past the
    first record so the segment header stays intact) — the latent media
    error recovery must refuse on when durable records follow. Returns
    the byte offset flipped."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if not data:
        raise ValueError(f"cannot flip a bit in empty file {path}")
    if offset is None:
        lo, hi = min(16, len(data) - 1), len(data)
        offset = lo + random.Random(seed ^ 0xB17).randrange(hi - lo)
    data[offset] ^= 1 << (seed % 8)
    with open(path, "r+b") as f:     # in-place damage, no truncation
        f.seek(offset)
        f.write(bytes([data[offset]]))
    return offset


def tear_tail(path: str, nbytes: int = 7) -> int:
    """Chop the last ``nbytes`` off ``path`` — the torn final record a
    power cut mid-write leaves. Recovery must truncate it away and
    continue (NOT refuse: nothing durable follows). Returns the new
    size."""
    size = os.path.getsize(path)
    new = max(0, size - int(nbytes))
    with open(path, "r+b") as f:
        f.truncate(new)
    return new
