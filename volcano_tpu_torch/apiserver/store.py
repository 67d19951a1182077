"""In-memory object store with watches, a change journal and lease
fencing (the in-memory core of volcano_tpu/apiserver/store.py).

Typed object collections with resource versions, and watch fan-out to
informers (the scheduler cache). Namespaced kinds key by
"namespace/name", cluster-scoped ones by "name". Reads hand out copies,
and stored objects are replaced on every write, never mutated in place,
so a watcher may keep the objects a bulk delivery hands it.

Every write appends to the change journal under the rv sequencer
(``current_rv``, ``journal_window``, ``events_since``), may carry a
fencing token (``fence=``: a write below the floor ``advance_fence`` set
raises FencedError before anything changes) and a correlation ID
(``trace=``, joined back by ``trace_of``). Bulk patches (``patch_batch``,
``bind_pods``) above ``SHARD_SERIAL_MAX`` items take the sharded
two-phase commit (docs/design/bind_pipeline.md): reserve an rv range,
clone the shards on a small worker pool, publish them in shard order and
hand each shard's watch delivery to a one-thread echo worker.

The sharded patch's clone (``bind_pods``), its ordered publish and the
classification of a bulk delivery by a watch's ``filter_attr`` run on the
native engine (native/fastmodel.c: ``bind_clone_pods``, ``publish_shard``,
``attr_eq_filter_pairs``) while ``NATIVE_PUBLISH`` is on, the default; the
Python bodies beside them are the plain version.

Left out of this port: admission hooks, the write-ahead log and
read-only mode, and replication (``apply_replicated``,
``install_snapshot``).
"""

from __future__ import annotations

import bisect
import itertools
import os
import threading
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

from ..metrics import metrics as m
from ..models import objects as obj
from ..models.job_info import _fastmodel
from ..trace import tracer
from ..utils.clock import GLOBAL_CLOCK, Clock
from ..utils.fastclone import fast_clone

NAMESPACED = {"pods", "podgroups", "resourcequotas", "configmaps",
              "persistentvolumeclaims"}
CLUSTER_SCOPED = {"nodes", "queues", "priorityclasses", "numatopologies",
                  "persistentvolumes"}
KINDS = NAMESPACED | CLUSTER_SCOPED

# the shared worker pool of the sharded patch's clone phase: module-wide,
# so every store (tests build hundreds) shares a few threads, created at
# the first sharded patch. It runs only pure clone-and-patch closures over
# inputs nobody mutates, and its size never changes a result: shard
# contents and publish order are fixed before any worker runs.
_FLUSH_POOL: Optional[ThreadPoolExecutor] = None
# the one-thread delivery worker (stage 3 of the flush pipeline): one
# worker keeps deliveries in shard order
_ECHO_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _flush_pool() -> ThreadPoolExecutor:
    global _FLUSH_POOL
    if _FLUSH_POOL is None:
        with _POOL_LOCK:
            if _FLUSH_POOL is None:
                _FLUSH_POOL = ThreadPoolExecutor(
                    max_workers=min(4, os.cpu_count() or 1),
                    thread_name_prefix="flush-shard")
    return _FLUSH_POOL


def _echo_pool() -> ThreadPoolExecutor:
    global _ECHO_POOL
    if _ECHO_POOL is None:
        with _POOL_LOCK:
            if _ECHO_POOL is None:
                _ECHO_POOL = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="flush-echo")
    return _ECHO_POOL


# per-delivery context for watch handlers: while the echo worker runs a
# shard's delivery, ``origin`` is the thread ident of the flush that
# produced it (the cache's expected-bind-echo hint is keyed by the
# writer's thread, and the worker delivers on its behalf) and
# ``commit_t`` the store-clock instant the shard published (the ledger's
# store_committed stamp). ``depth`` marks handlers already running on the
# echo worker, so a bulk patch inside a delivery delivers inline instead
# of deadlocking on the one worker.
_DELIVERY_CTX = threading.local()


def delivery_origin() -> int:
    """Thread ident of the flush a running watch delivery belongs to (the
    current thread outside the echo pipeline)."""
    return getattr(_DELIVERY_CTX, "origin", None) or threading.get_ident()


def delivery_commit_time() -> Optional[float]:
    """Store-clock instant the delivering shard published, or None outside
    the echo pipeline."""
    return getattr(_DELIVERY_CTX, "commit_t", None)


def trace_in_ranges(ranges: list, rv: int):
    """Resolve ``rv`` against a ``trace_ranges()`` snapshot: the ranges
    are disjoint and ascending by ``lo``, so a bisect finds the only
    candidate."""
    i = bisect.bisect_right(ranges, rv, key=lambda r: r[0]) - 1
    if i >= 0 and ranges[i][1] >= rv:
        return ranges[i][2]
    return None


class ConflictError(Exception):
    """Raised on update when the caller's copy is stale (optimistic
    concurrency, the apiserver 409). Re-get and retry."""


class FencedError(Exception):
    """Raised when a write carries a fencing token below the store's floor
    (docs/design/failover.md): the writer's lease was superseded, and a
    deposed leader's in-flight binds must not land after the standby took
    over. Not retryable by re-reading: the writer stops writing until it
    holds the lease (and a newer token) again."""


class Watch:
    def __init__(self, kind: str, on_add=None, on_update=None, on_delete=None,
                 filter_fn: Optional[Callable] = None,
                 on_bulk_update: Optional[Callable] = None,
                 filter_attr: Optional[tuple] = None):
        self.kind = kind
        self.on_add = on_add
        self.on_update = on_update
        self.on_delete = on_delete
        self.filter_fn = filter_fn
        # batched delivery of bulk patches: on_bulk_update([(old, new)]);
        # watchers without it get one on_update call per pair
        self.on_bulk_update = on_bulk_update
        # ((a0, a1), expected): a declaration that filter_fn is the
        # equality obj.<a0>.<a1> == expected, which lets the native engine
        # classify a whole delivery in one call
        self.filter_attr = filter_attr

    def passes(self, o) -> bool:
        return self.filter_fn is None or self.filter_fn(o)


class ObjectStore:
    """Thread-safe typed object store with a journal and watch delivery."""

    JOURNAL_CAPACITY = 65536
    EVENTS_CAPACITY = 16384

    # the sharded bulk patch's tuning (class attributes, so tests can tune
    # one store): bursts of at most SHARD_SERIAL_MAX items commit in one
    # lock pass; larger ones split into ceil(n / SHARD_TARGET) shards, at
    # most SHARD_MAX. The shard count is a function of the burst's size
    # alone, never of the CPU count or the pool, so runs repeat exactly.
    SHARD_SERIAL_MAX = 512
    SHARD_TARGET = 2048
    SHARD_MAX = 8
    # the native engine's switch for the bind clone, the ordered publish
    # and the filter classification (a class attribute, so tests can
    # force either engine)
    NATIVE_PUBLISH = True

    def __init__(self, clock: Clock = GLOBAL_CLOCK):
        self._objects: Dict[str, Dict[str, object]] = {k: {} for k in KINDS}
        self._watches: Dict[str, List[Watch]] = defaultdict(list)
        self._rv = 0
        self._lock = threading.RLock()
        self.clock = clock
        # (kind, key, type, reason, message) records, bounded like the
        # reference's TTL'd core/v1 Events
        self.events = deque(maxlen=self.EVENTS_CAPACITY)
        # the change journal, (rv, action, kind, object) entries; the
        # objects are never mutated after they are stored, so holding
        # them is safe
        self._journal = deque(maxlen=self.JOURNAL_CAPACITY)
        self._journal_cond = threading.Condition(self._lock)
        # the journal's sequencer: _rv counts allocations (a sharded patch
        # reserves a whole range up front); _journal_tail is the highest
        # rv whose entry is in the journal. The journal stays sorted and
        # gap-free: an entry above the tail parks in _journal_parked until
        # the range below it lands. Readers see the tail.
        self._journal_tail = 0
        self._journal_parked: Dict[int, tuple] = {}
        # keys of a reserved but unpublished patch, per kind
        self._inflight: Dict[str, set] = defaultdict(set)
        self._flush_cond = threading.Condition(self._lock)
        # lease fencing: the highest token the store was told of; writes
        # stamped with a lower one raise FencedError, unstamped writes
        # (fence=None) pass
        self._fence_floor = 0
        self.fenced_writes = 0
        # (lo, hi, trace) rv ranges of the writes stamped with a
        # correlation ID: one range for a whole bulk patch
        self._trace_ranges = deque(maxlen=4096)

    # -- trace correlation -------------------------------------------------

    def _record_trace_locked(self, lo: int, hi: int, trace) -> None:
        if trace is not None and hi >= lo:
            self._trace_ranges.append((lo, hi, str(trace)))

    def trace_ranges(self) -> list:
        """The recorded (lo, hi, trace) ranges, ascending by rv; join one
        rv with :func:`trace_in_ranges`."""
        with self._lock:
            return list(self._trace_ranges)

    def trace_of(self, rv: int):
        """Correlation ID of the write that produced ``rv`` (None when the
        write was unstamped or its record aged out)."""
        return trace_in_ranges(self.trace_ranges(), rv)

    # -- lease fencing -----------------------------------------------------

    def advance_fence(self, token: int) -> int:
        """Raise the write-fence floor to ``token`` (monotonic: an older
        token is a no-op). Returns the floor."""
        with self._lock:
            if token > self._fence_floor:
                self._fence_floor = token
            return self._fence_floor

    def fence_floor(self) -> int:
        with self._lock:
            return self._fence_floor

    def _check_fence_locked(self, fence: Optional[int]) -> None:
        """Refuse a write stamped with a superseded token, before any state
        changes; the caller holds the lock."""
        if fence is not None and fence < self._fence_floor:
            self.fenced_writes += 1
            m.inc(m.FENCED_WRITES)
            raise FencedError(
                f"write fenced: token {fence} is behind the floor "
                f"{self._fence_floor} (lease superseded)")

    # -- keys --------------------------------------------------------------

    @staticmethod
    def key_of(kind: str, o) -> str:
        meta = o.metadata
        return meta.name if kind in CLUSTER_SCOPED \
            else f"{meta.namespace}/{meta.name}"

    @staticmethod
    def _key(kind: str, name: str, namespace: str) -> str:
        return name if kind in CLUSTER_SCOPED else f"{namespace}/{name}"

    # -- the journal's sequencer (the caller holds self._lock) -------------

    def _journal_append_locked(self, rv: int, action: str, kind: str,
                               o) -> None:
        """Append one entry, keeping the journal sorted and gap-free: an
        entry above the tail parks until the range below it lands."""
        if rv == self._journal_tail + 1:
            self._journal.append((rv, action, kind, o))
            self._journal_tail = rv
            self._drain_parked_locked()
            self._journal_cond.notify_all()
        else:
            self._journal_parked[rv] = (rv, action, kind, o)

    def _journal_extend_locked(self, entries) -> None:
        """Append a contiguous ascending run of entries in one call (one a
        published shard): the whole run lands, then the parked entries
        above it, or the whole run parks."""
        if not entries:
            return
        if entries[0][0] == self._journal_tail + 1:
            self._journal.extend(entries)
            self._journal_tail = entries[-1][0]
            self._drain_parked_locked()
            self._journal_cond.notify_all()
        else:
            for e in entries:
                self._journal_parked[e[0]] = e

    def _drain_parked_locked(self) -> None:
        parked = self._journal_parked
        while parked:
            nxt = parked.pop(self._journal_tail + 1, None)
            if nxt is None:
                return
            self._journal.append(nxt)
            self._journal_tail += 1

    def _wait_journal_settled_locked(self) -> None:
        """Wait (releasing the lock) until every allocated rv is in the
        journal: every rv allocation waits here first, so rv order is a
        function of commit order alone, no writer slips in before or after
        an outstanding reservation, and no key is in flight. With it no
        entry should ever park; the parking stays as a safeguard."""
        if self._rv != self._journal_tail:
            self._flush_cond.wait_for(
                lambda: self._rv == self._journal_tail)

    # -- CRUD --------------------------------------------------------------

    def create(self, kind: str, o, fence: Optional[int] = None,
               trace: Optional[str] = None):
        if kind == "pods":
            # the aggregate request is parsed once here; every copy handed
            # out afterwards shares the memo
            o.resource_request()
        with self._lock:
            self._wait_journal_settled_locked()
            # the fence after the settle wait (which releases the lock): a
            # takeover may happen while this writer waits
            self._check_fence_locked(fence)
            key = self.key_of(kind, o)
            if key in self._objects[kind]:
                raise KeyError(f"{kind} {key!r} already exists")
            if not o.metadata.uid:
                o.metadata.uid = obj.new_uid(
                    kind[:-1] if kind.endswith("s") else kind)
            if not o.metadata.creation_timestamp:
                o.metadata.creation_timestamp = self.clock.now()
            self._rv += 1
            o.metadata.resource_version = self._rv
            self._objects[kind][key] = o
            self._journal_append_locked(self._rv, "ADDED", kind, o)
            self._record_trace_locked(self._rv, self._rv, trace)
            watches = list(self._watches[kind])
        for w in watches:
            if w.on_add and w.passes(o):
                # per-watcher copies: a watcher mutates what it is given
                w.on_add(fast_clone(o))
        return o

    def update(self, kind: str, o, fence: Optional[int] = None,
               trace: Optional[str] = None):
        if kind == "pods":
            o.resource_request()
        key = self.key_of(kind, o)
        with self._lock:
            self._wait_journal_settled_locked()
            self._check_fence_locked(fence)
            old = self._objects[kind].get(key)
            if old is None:
                raise KeyError(f"{kind} {key!r} not found")
            if o.metadata.resource_version and \
                    o.metadata.resource_version != old.metadata.resource_version:
                raise ConflictError(
                    f"{kind} {key!r}: stale resource_version "
                    f"{o.metadata.resource_version} != "
                    f"{old.metadata.resource_version}")
            self._rv += 1
            o.metadata.resource_version = self._rv
            self._objects[kind][key] = o
            self._journal_append_locked(self._rv, "MODIFIED", kind, o)
            self._record_trace_locked(self._rv, self._rv, trace)
            watches = list(self._watches[kind])
        self._deliver(watches, [(old, o)], bulk=False)
        return o

    def delete(self, kind: str, name: str, namespace: str = "default",
               fence: Optional[int] = None,
               trace: Optional[str] = None) -> int:
        """Returns the deletion's resource version."""
        key = self._key(kind, name, namespace)
        with self._lock:
            self._wait_journal_settled_locked()
            self._check_fence_locked(fence)
            old = self._objects[kind].get(key)
            if old is None:
                raise KeyError(f"{kind} {key!r} not found")
            self._rv += 1
            deleted_rv = self._rv
            self._journal_append_locked(self._rv, "DELETED", kind, old)
            self._record_trace_locked(self._rv, self._rv, trace)
            del self._objects[kind][key]
            watches = list(self._watches[kind])
        for w in watches:
            if w.on_delete and w.passes(old):
                w.on_delete(old)
        return deleted_rv

    def get(self, kind: str, name: str, namespace: str = "default"):
        with self._lock:
            o = self._objects[kind].get(self._key(kind, name, namespace))
        return fast_clone(o) if o is not None else None

    def list(self, kind: str, namespace: Optional[str] = None) -> list:
        return [fast_clone(o) for o in self.list_refs(kind, namespace)]

    def list_refs(self, kind: str, namespace: Optional[str] = None) -> list:
        """The stored objects themselves, no copies: stored objects are
        replaced, never mutated, so each is a consistent view, which
        callers must not mutate. The read path of audits such as the
        cache's anti-entropy pass."""
        with self._lock:
            items = list(self._objects[kind].values())
        if namespace is not None and kind in NAMESPACED:
            items = [o for o in items if o.metadata.namespace == namespace]
        return items

    # -- bulk patches ------------------------------------------------------

    def patch_batch(self, kind: str, patches, clone_fn=None,
                    fence: Optional[int] = None,
                    trace: Optional[str] = None) -> tuple:
        """Apply ``[(name, namespace, fn)]`` as one bulk commit: each fn
        mutates a fresh clone of the stored object (``clone_fn``, default
        a deep clone), which becomes the new stored version with its own
        rv and journal entry. Returns ``(pairs, missing)``: the applied
        [(old, new)] and the [(name, namespace)] whose object was gone.

        Watch delivery: a filter that flips over a pair is delivered as
        an add (fail to pass) or a delete (pass to fail); pairs that pass
        both go to the bulk handler, one call per commit unit (the whole
        burst on the serial path, a shard on the sharded path), with the
        store's own ``new`` objects, which the handler must not mutate,
        or to on_update with a private copy. See :meth:`_bulk_patch` for
        the two engines and their failure semantics."""
        return self._bulk_patch(kind, patches, clone_fn or fast_clone,
                                lambda new, fn: fn(new), None, fence=fence,
                                trace=trace)

    def bind_pods(self, bindings, fence: Optional[int] = None,
                  trace: Optional[str] = None) -> tuple:
        """``[(name, namespace, hostname)]`` -> pod.spec.node_name patches
        through the bulk engine; returns ``(pairs, missing)``. On the
        native engine a shard's clone, patch and rv step is one
        ``bind_clone_pods`` call."""
        def apply_fn(new, hostname):
            new.spec.node_name = hostname
            new.resource_request()

        batch_shard = None
        if self.NATIVE_PUBLISH:
            fm = _fastmodel()

            def batch_shard(shard, rv_base):
                # None hands the shard back to the Python loop
                return fm.bind_clone_pods([old for _, old, _ in shard],
                                          [h for _, _, h in shard],
                                          rv_base + 1)
        return self._bulk_patch("pods", bindings, obj.clone_pod_for_bind,
                                apply_fn, batch_shard, fence=fence,
                                trace=trace)

    def _shard_count(self, n: int) -> int:
        return min(self.SHARD_MAX, -(-n // self.SHARD_TARGET))

    def _bulk_patch(self, kind: str, items, clone_fn, apply_fn, batch_shard,
                    fence: Optional[int] = None,
                    trace: Optional[str] = None) -> tuple:
        """The engine behind patch_batch and bind_pods. ``items`` is
        [(name, namespace, payload)]; each applied item becomes ``new =
        clone_fn(old); apply_fn(new, payload)`` with a fresh rv;
        ``batch_shard(shard, rv_base)``, when given, does a whole shard's
        clone, patch and rv step on the sharded path (None: the shard
        takes the per-item loop).

        * Serial (n <= SHARD_SERIAL_MAX, or a key repeated in the burst):
          resolve, clone, patch, install and journal in one lock pass. A
          raising apply_fn aborts its item and every later one; the
          committed prefix is still delivered, then the error re-raises.
        * Sharded two-phase: a short lock pass reserves a contiguous rv
          range and splits the resolved items into K contiguous shards of
          the burst (gang order kept); the shards clone and patch on the
          worker pool without the lock, then publish strictly in shard
          order (install, journal, one bulk delivery each on the echo
          worker), so the echo of shard i overlaps the cloning of shard
          i+1. Until its shard publishes a key is in flight, and every
          other write waits for the journal to settle. A raising apply_fn
          cannot give back its reserved rv: its item commits a no-op
          version (a clone of the old object, delivered as an update),
          every other item commits, and the first error re-raises after
          delivery.

        Shard assignment, rv ranges and publish order are functions of
        the burst alone: pool size and thread timing change no
        observable order."""
        pairs: list = []
        missing: list = []
        watches: list = []
        resolved: list = []
        shards = bases = None
        cluster = kind in CLUSTER_SCOPED
        try:
            with self._lock:
                # a reservation is only taken against a settled sequencer,
                # so every rv range follows from commit order
                self._wait_journal_settled_locked()
                self._check_fence_locked(fence)
                objs = self._objects[kind]
                seen: set = set()
                for name, namespace, payload in items:
                    key = name if cluster else f"{namespace}/{name}"
                    old = objs.get(key)
                    if old is None:
                        missing.append((name, namespace))
                    else:
                        seen.add(key)
                        resolved.append((key, old, payload))
                n = len(resolved)
                if n == 0:
                    return [], missing
                # a repeated key must see the first patch's result as its
                # old version, which only the serial pass chains
                if n <= self.SHARD_SERIAL_MAX or self._shard_count(n) < 2 \
                        or len(seen) != n:
                    try:
                        for key, _, payload in resolved:
                            old = objs[key]
                            new = clone_fn(old)
                            apply_fn(new, payload)
                            self._rv += 1
                            new.metadata.resource_version = self._rv
                            objs[key] = new
                            self._journal_append_locked(
                                self._rv, "MODIFIED", kind, new)
                            pairs.append((old, new))
                    finally:
                        if pairs:
                            self._record_trace_locked(
                                pairs[0][1].metadata.resource_version,
                                pairs[-1][1].metadata.resource_version,
                                trace)
                            watches = list(self._watches[kind])
                    return pairs, missing
                k = self._shard_count(n)
                step = -(-n // k)
                shards = [resolved[i:i + step] for i in range(0, n, step)]
                bases = []
                rv = self._rv
                for s in shards:
                    bases.append(rv)
                    rv += len(s)
                # the whole reserved range commits (a failure installs a
                # no-op version), so one range record covers the burst
                self._record_trace_locked(self._rv + 1, rv, trace)
                self._rv = rv
                self._inflight[kind].update(key for key, _, _ in resolved)
                watches = list(self._watches[kind])
        finally:
            if shards is None:
                self._deliver(watches, pairs, bulk=True)
        m.observe(m.STORE_PATCH_SHARDS, len(shards), kind=kind)
        return self._publish_shards(kind, shards, bases, watches, clone_fn,
                                    apply_fn, batch_shard, missing)

    def _publish_shards(self, kind, shards, bases, watches, clone_fn,
                        apply_fn, batch_shard, missing) -> tuple:
        """Phases 2-4 of the sharded patch: the shards clone on the worker
        pool, this thread publishes them strictly in shard order, and each
        published shard's delivery goes to the echo worker. Every delivery
        has run before the patch returns."""
        first_err: list = [None]

        def run_shard(shard, rv_base):
            if batch_shard is not None:
                news = batch_shard(shard, rv_base)
                if news is not None:
                    return news
            news = []
            rv = rv_base
            for _, old, payload in shard:
                rv += 1
                try:
                    new = clone_fn(old)
                    apply_fn(new, payload)
                except BaseException as e:
                    if first_err[0] is None:
                        first_err[0] = e
                    # a no-op version keeps the reserved rv gap-free
                    new = clone_fn(old)
                new.metadata.resource_version = rv
                news.append(new)
            return news

        # transitive: a patch inside a delivery keeps the root writer
        origin = delivery_origin()
        deliver_err: list = [None]

        def deliver_task(spairs, commit_t):
            # every published shard delivers, even after an earlier
            # delivery raised (its state is committed); the context is
            # saved and restored for a nested inline delivery
            prev = (getattr(_DELIVERY_CTX, "origin", None),
                    getattr(_DELIVERY_CTX, "commit_t", None))
            _DELIVERY_CTX.origin = origin
            _DELIVERY_CTX.commit_t = commit_t
            _DELIVERY_CTX.depth = getattr(_DELIVERY_CTX, "depth", 0) + 1
            try:
                with tracer.async_span("store.patch.deliver",
                                       pairs=len(spairs)):
                    self._deliver(watches, spairs, bulk=True)
            except BaseException as e:
                if deliver_err[0] is None:
                    deliver_err[0] = e
            finally:
                _DELIVERY_CTX.depth -= 1
                _DELIVERY_CTX.origin, _DELIVERY_CTX.commit_t = prev

        # a patch issued from a delivery already runs on the echo worker:
        # its deliveries run inline, after every shard has published (a
        # handler may write, and the settle wait would otherwise block on
        # this thread's own unpublished shards)
        inline_echo = getattr(_DELIVERY_CTX, "depth", 0) > 0
        pairs_all: list = []
        published = 0
        deliveries: list = []
        inline_pending: list = []
        try:
            # until the last shard publishes, any failure (the pool, a
            # worker, a handler) must still land the reserved rvs and
            # release the in-flight keys, or every later write waits forever
            pool = _flush_pool()
            epool = None if inline_echo else _echo_pool()
            futures = [pool.submit(run_shard, s, b)
                       for s, b in zip(shards, bases)]
            for shard, base, fut in zip(shards, bases, futures):
                with tracer.async_span("store.patch.clone_wait"):
                    news = fut.result()
                with tracer.async_span("store.patch.publish"):
                    spairs = self._install_shard(kind, shard, news)
                published += 1
                pairs_all.extend(spairs)
                commit_t = self.clock.now()
                if epool is None:
                    inline_pending.append((spairs, commit_t))
                else:
                    deliveries.append(
                        epool.submit(deliver_task, spairs, commit_t))
        finally:
            if published < len(shards):
                for shard, base in list(zip(shards, bases))[published:]:
                    news = [clone_fn(old) for _, old, _ in shard]
                    for i, new in enumerate(news):
                        new.metadata.resource_version = base + i + 1
                    self._install_shard(kind, shard, news)
            for spairs, commit_t in inline_pending:
                deliver_task(spairs, commit_t)
            if deliveries:
                with tracer.async_span("store.patch.echo_wait"):
                    for f in deliveries:
                        f.result()
        if first_err[0] is not None:
            raise first_err[0]
        if deliver_err[0] is not None:
            raise deliver_err[0]
        return pairs_all, missing

    def _install_shard(self, kind, shard, news) -> list:
        """The ordered publish of one shard (takes the lock itself):
        install its new versions, journal them (the shard's contiguous
        reserved rvs) in one sequencer call and release their keys; on the
        native engine the loop is one ``publish_shard`` call. Returns the
        shard's [(old, new)]."""
        fm = _fastmodel() if self.NATIVE_PUBLISH else None
        with self._lock:
            objs = self._objects[kind]
            infl = self._inflight[kind]
            if fm is not None:
                entries, pairs = fm.publish_shard(objs, infl, kind, shard,
                                                  news)
                self._journal_extend_locked(entries)
                self._flush_cond.notify_all()
                return pairs
            entries = []
            for (key, _, _), new in zip(shard, news):
                objs[key] = new
                infl.discard(key)
                entries.append((new.metadata.resource_version, "MODIFIED",
                                kind, new))
            self._journal_extend_locked(entries)
            self._flush_cond.notify_all()
        return [(old, new) for (_, old, _), new in zip(shard, news)]

    def _deliver(self, watches, pairs, bulk: bool) -> None:
        """Deliver [(old, new)] updates: a filter that flips over the pair
        is delivered as an add or a delete; pairs that pass both go to the
        bulk handler (bulk commits) or to on_update with a private copy.
        A watch that declares ``filter_attr`` is classified by the native
        engine's ``attr_eq_filter_pairs`` while NATIVE_PUBLISH is on: the
        same flips, fired in pair order, then the same delivery."""
        if not pairs:
            return
        fm = _fastmodel() if self.NATIVE_PUBLISH else None
        for w in watches:
            if fm is not None and w.filter_attr is not None:
                (a0, a1), expected = w.filter_attr
                delivery, flips = fm.attr_eq_filter_pairs(
                    pairs, a0, a1, expected)
                for is_add, o in flips:
                    if is_add and w.on_add:
                        w.on_add(fast_clone(o))
                    elif not is_add and w.on_delete:
                        w.on_delete(o)
            else:
                delivery = []
                for old, new in pairs:
                    old_p, new_p = w.passes(old), w.passes(new)
                    if old_p and new_p:
                        delivery.append((old, new))
                    elif new_p and w.on_add:
                        w.on_add(fast_clone(new))
                    elif old_p and w.on_delete:
                        w.on_delete(old)
            if not delivery:
                continue
            if bulk and w.on_bulk_update is not None:
                w.on_bulk_update(delivery)
            elif w.on_update:
                for old, new in delivery:
                    w.on_update(old, fast_clone(new))

    # -- watch and journal readers -----------------------------------------

    def watch(self, kind: str, on_add=None, on_update=None, on_delete=None,
              filter_fn=None, sync: bool = True,
              on_bulk_update=None, filter_attr=None) -> Watch:
        """Subscribe to events of a kind; with sync=True, existing objects
        are replayed through on_add first (informer list+watch).
        ``filter_attr=((a0, a1), expected)`` declares filter_fn to be the
        equality obj.<a0>.<a1> == expected (see Watch)."""
        w = Watch(kind, on_add, on_update, on_delete, filter_fn,
                  on_bulk_update=on_bulk_update, filter_attr=filter_attr)
        with self._lock:
            # an in-flight sharded patch snapshotted its watch list at
            # reservation: a watch added meanwhile would miss part of it
            self._wait_journal_settled_locked()
            self._watches[kind].append(w)
            existing = list(self._objects[kind].values()) if sync else []
        for o in existing:
            if w.on_add and w.passes(o):
                w.on_add(fast_clone(o))
        return w

    def unwatch(self, w: Watch) -> None:
        with self._lock:
            if w in self._watches[w.kind]:
                self._watches[w.kind].remove(w)

    def current_rv(self) -> int:
        """The watch-visible resource version: the journal's contiguous
        tail (during a reservation it trails the allocation counter)."""
        with self._lock:
            return self._journal_tail

    def journal_window(self) -> tuple:
        """``(head_rv, tail_rv)`` of the journal: head is the first kept
        entry's rv (``tail + 1`` when the journal is empty); a cursor c
        can be served iff ``c + 1 >= head``."""
        with self._lock:
            head = self._journal[0][0] if self._journal \
                else self._journal_tail + 1
            return head, self._journal_tail

    def events_since(self, rv: int, timeout: float = 25.0):
        """Long-poll the journal: wait until an entry above ``rv`` exists
        (or the timeout), then return ``(events, current_rv, resync)``,
        events being [(rv, action, kind, object)]; resync=True means rv
        predates the journal's window and the caller must re-list."""
        with self._journal_cond:
            if not self._journal_cond.wait_for(
                    lambda: self._journal_tail > rv, timeout=timeout):
                return [], self._journal_tail, False
            if not self._journal or self._journal[0][0] > rv + 1:
                return [], self._journal_tail, True
            # the journal is contiguous up to the tail, so the slice
            # starts at an offset
            start = max(0, rv + 1 - self._journal[0][0])
            events = list(itertools.islice(self._journal, start, None))
            return events, self._journal_tail, False

    # -- events (Recorder equivalent) --------------------------------------

    def record_event(self, kind: str, o, event_type: str, reason: str,
                     message: str) -> None:
        self.events.append((kind, self.key_of(kind, o) if o is not None
                            else "", event_type, reason, message))
