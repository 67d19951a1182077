"""In-memory object store with synchronous watches (the in-memory core of
volcano_tpu/apiserver/store.py).

Typed object collections with resource versions, and watch fan-out to
informers (the scheduler cache): every write delivers its event to every
watch before it returns. Namespaced kinds key by "namespace/name",
cluster-scoped ones by "name". Reads hand out copies, and stored objects
are replaced on every write, never mutated in place, so a watcher may keep
the objects a bulk delivery hands it.

Left out of this port: admission hooks, the write-ahead log, lease fencing,
the change journal and its remote watchers, replication, read-only mode and
the sharded bulk-patch pipeline (bulk patches commit in one serial pass).
"""

from __future__ import annotations

import threading
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional

from ..models import objects as obj
from ..utils.clock import GLOBAL_CLOCK, Clock
from ..utils.fastclone import fast_clone

NAMESPACED = {"pods", "podgroups", "resourcequotas"}
CLUSTER_SCOPED = {"nodes", "queues", "priorityclasses"}
KINDS = NAMESPACED | CLUSTER_SCOPED


class ConflictError(Exception):
    """Raised on update when the caller's copy is stale (optimistic
    concurrency, the apiserver 409). Re-get and retry."""


class Watch:
    def __init__(self, kind: str, on_add=None, on_update=None, on_delete=None,
                 filter_fn: Optional[Callable] = None,
                 on_bulk_update: Optional[Callable] = None):
        self.kind = kind
        self.on_add = on_add
        self.on_update = on_update
        self.on_delete = on_delete
        self.filter_fn = filter_fn
        # batched delivery of bulk patches: on_bulk_update([(old, new)]);
        # watchers without it get one on_update call per pair
        self.on_bulk_update = on_bulk_update

    def passes(self, o) -> bool:
        return self.filter_fn is None or self.filter_fn(o)


class ObjectStore:
    """Thread-safe typed object store with synchronous watch delivery."""

    EVENTS_CAPACITY = 16384

    def __init__(self, clock: Clock = GLOBAL_CLOCK):
        self._objects: Dict[str, Dict[str, object]] = {k: {} for k in KINDS}
        self._watches: Dict[str, List[Watch]] = defaultdict(list)
        self._rv = 0
        self._lock = threading.RLock()
        self.clock = clock
        # (kind, key, type, reason, message) records, bounded like the
        # reference's TTL'd core/v1 Events
        self.events = deque(maxlen=self.EVENTS_CAPACITY)

    @staticmethod
    def key_of(kind: str, o) -> str:
        meta = o.metadata
        return meta.name if kind in CLUSTER_SCOPED \
            else f"{meta.namespace}/{meta.name}"

    @staticmethod
    def _key(kind: str, name: str, namespace: str) -> str:
        return name if kind in CLUSTER_SCOPED else f"{namespace}/{name}"

    # -- CRUD --------------------------------------------------------------

    def create(self, kind: str, o):
        if kind == "pods":
            # the aggregate request is parsed once here; every copy handed
            # out afterwards shares the memo
            o.resource_request()
        with self._lock:
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
            watches = list(self._watches[kind])
        for w in watches:
            if w.on_add and w.passes(o):
                # per-watcher copies: a watcher mutates what it is given
                w.on_add(fast_clone(o))
        return o

    def update(self, kind: str, o):
        if kind == "pods":
            o.resource_request()
        key = self.key_of(kind, o)
        with self._lock:
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
            watches = list(self._watches[kind])
        self._deliver(watches, [(old, o)], bulk=False)
        return o

    def delete(self, kind: str, name: str, namespace: str = "default") -> int:
        """Returns the deletion's resource version."""
        key = self._key(kind, name, namespace)
        with self._lock:
            old = self._objects[kind].get(key)
            if old is None:
                raise KeyError(f"{kind} {key!r} not found")
            self._rv += 1
            deleted_rv = self._rv
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
        with self._lock:
            items = list(self._objects[kind].values())
        if namespace is not None and kind in NAMESPACED:
            items = [o for o in items if o.metadata.namespace == namespace]
        return [fast_clone(o) for o in items]

    # -- bulk patches ------------------------------------------------------

    def patch_batch(self, kind: str, patches, clone_fn=None) -> tuple:
        """Apply ``[(name, namespace, fn)]`` as one commit: each fn mutates
        a fresh clone of the stored object (``clone_fn``, default a deep
        clone), which becomes the new stored version. Watchers with a bulk
        handler get one call with every [(old, new)] pair; ``new`` is the
        store's own object, which they must not mutate. Returns
        ``(pairs, missing)``, missing being the [(name, namespace)] whose
        object was gone."""
        return self._bulk_patch(kind, patches, clone_fn or fast_clone,
                                lambda new, fn: fn(new))

    def bind_pods(self, bindings) -> tuple:
        """``[(name, namespace, hostname)]`` -> pod.spec.node_name patches
        in one commit; returns ``(pairs, missing)``."""
        def apply_fn(new, hostname):
            new.spec.node_name = hostname
            new.resource_request()
        return self._bulk_patch("pods", bindings, obj.clone_pod_for_bind,
                                apply_fn)

    def _bulk_patch(self, kind: str, items, clone_fn, apply_fn) -> tuple:
        pairs: list = []
        missing: list = []
        with self._lock:
            objs = self._objects[kind]
            for name, namespace, payload in items:
                key = self._key(kind, name, namespace)
                old = objs.get(key)
                if old is None:
                    missing.append((name, namespace))
                    continue
                new = clone_fn(old)
                apply_fn(new, payload)
                self._rv += 1
                new.metadata.resource_version = self._rv
                objs[key] = new
                pairs.append((old, new))
            watches = list(self._watches[kind])
        self._deliver(watches, pairs, bulk=True)
        return pairs, missing

    @staticmethod
    def _deliver(watches, pairs, bulk: bool) -> None:
        """Deliver [(old, new)] updates: a filter that flips over the pair
        is delivered as an add or a delete; pairs that pass both go to the
        bulk handler (bulk commits) or to on_update with a private copy."""
        if not pairs:
            return
        for w in watches:
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

    # -- watch -------------------------------------------------------------

    def watch(self, kind: str, on_add=None, on_update=None, on_delete=None,
              filter_fn=None, sync: bool = True,
              on_bulk_update=None) -> Watch:
        """Subscribe to events of a kind; with sync=True, existing objects
        are replayed through on_add first (informer list+watch)."""
        w = Watch(kind, on_add, on_update, on_delete, filter_fn,
                  on_bulk_update=on_bulk_update)
        with self._lock:
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

    # -- events (Recorder equivalent) --------------------------------------

    def record_event(self, kind: str, o, event_type: str, reason: str,
                     message: str) -> None:
        self.events.append((kind, self.key_of(kind, o) if o is not None
                            else "", event_type, reason, message))
