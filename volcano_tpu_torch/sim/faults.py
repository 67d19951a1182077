"""Fault injection for the commit path (this port's own copy of the
live injectors of volcano_tpu/sim/faults.py, cut to what the port's
callers use).

* :class:`FlakyBinder` wraps the recording binder with a seeded per-bind
  failure coin and a targeted always-fail set; failures take the
  production resync path (cache.resync_task -> process_resync_tasks with
  retry accounting, gang healing and quarantine).
* :class:`FlakyWatch` wraps one registered store watch and silently
  drops, or delays to the next release, a content-keyed fraction of its
  deliveries, so the cache diverges from the store as over a lossy
  informer stream; the anti-entropy pass (cache.anti_entropy) must find
  and repair it.

The reference's FaultConfig, the binder's crash mode and virtual-clock
latency, the watch's rv-keyed coin and the forced journal gap serve its
simulator engine, and wait for the simulator's port together with its
scheduled faults (node churn, evict storms) and storage faults.
"""

from __future__ import annotations

import random
import zlib
from typing import List

from ..utils.clock import Clock
from ..utils.test_utils import FakeBinder


class FlakyBinder(FakeBinder):
    """Recording binder with deterministic failure injection.

    Failure decisions come from one seeded RNG consumed in bind order;
    the cache executor is a single FIFO worker and the caller flushes it
    every cycle, so the coin-flip sequence, and therefore the whole run,
    is reproducible from the seed. Failed binds raise, taking the
    production resilience path: resync with retry accounting, gang-atomic
    healing of the bound siblings, and quarantine past the retry budget.
    ``failed_keys`` records every injected failure for test assertions.
    ``fail_pods`` is the targeted mode: the named pods ALWAYS fail
    (without consuming the fail-rate coin), so poison-pod quarantine is
    testable deterministically.
    """

    def __init__(self, store, clock: Clock, fail_rate: float = 0.0,
                 seed: int = 0, fail_pods=None):
        super().__init__(store)
        self.clock = clock
        self.fail_rate = fail_rate
        self.fail_pods = set(fail_pods or ())
        self._rng = random.Random(seed ^ 0x5EED)
        self.failed_keys: List[str] = []
        self.attempts = 0

    def bind(self, pod, hostname: str) -> None:
        self.attempts += 1
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        if key in self.fail_pods:
            self.failed_keys.append(key)
            raise RuntimeError(f"injected targeted bind failure for {key}")
        if self.fail_rate and self._rng.random() < self.fail_rate:
            self.failed_keys.append(key)
            raise RuntimeError(f"injected bind failure for {key}")
        super().bind(pod, hostname)


class FlakyWatch:
    """Seeded watch-delivery fault injector.

    Wraps ONE registered store :class:`~volcano_tpu_torch.apiserver.store.Watch`
    (typically the cache's pod watch) so a deterministic fraction of
    deliveries is silently dropped, or held back until the caller
    releases it — the informer-stream loss/reorder failure modes. The wrapped
    subscriber's view diverges from the store; nothing else in the system
    is told, which is the point: the anti-entropy reconciler has to FIND
    it.

    Determinism: each delivery's fate comes from a crc32 coin over
    ``(action, object key, per-key delivery sequence, seed)`` —
    commit-order-stable, so it is independent of thread timing AND of
    journal rv interleaving, identical across double runs (the same
    property the resync backoff jitter relies on). A key's own delivery
    order is commit order (writes to one object serialize), so the
    per-key sequence is a stable identity. Bulk deliveries are coined
    per pair. Delayed deliveries are re-played in recorded order by
    :meth:`release_delayed`; the production handlers treat them like any
    stale event.
    """

    def __init__(self, seed: int = 0, drop_rate: float = 0.0,
                 delay_rate: float = 0.0):
        self.seed = seed
        self.drop_rate = drop_rate
        self.delay_rate = delay_rate
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
