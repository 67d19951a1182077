"""Multi-process deployment seam: a remote, watchable store client (the
port's own copy of volcano_tpu/apiserver/remote.py).

The reference deploys three binaries against the Kubernetes API server
(installer/volcano-development.yaml): informers watch-stream state in, and
writes go out as REST calls. :class:`RemoteStore` gives the standalone
framework the same topology over :mod:`volcano_tpu_torch.apiserver.http`:

* a local mirror ``ObjectStore`` is primed by a full list and kept current
  by a long-poll watch thread (`GET /watch?since=rv` against the serving
  process's change journal) — scheduler cache / controllers register their
  watches on the mirror exactly as they would in-process;
* writes (create/update/delete/events) are REST calls to the serving
  process, where admission runs (including webhook-manager callbacks,
  :class:`RemoteAdmissionHook`);
* a journal gap (client slower than the journal window) triggers a full
  re-list, like an informer's resync after watch expiry.

Deployment recipe: docs/deployment.md; the port's scheduler binary takes
it with ``--server URL`` (cmd/scheduler.py).
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from ..metrics import metrics as m
from ..utils.backoff import seeded_backoff
from ..utils.fastclone import fast_clone
from .codec import decode_object, encode_object
from .http import ApiError, StoreClient
from .store import CLUSTER_SCOPED as _CLUSTER_SCOPED
from .store import KINDS, AdmissionError, ObjectStore

log = logging.getLogger(__name__)

# HTTP statuses worth retrying: the server hiccuped, not the request.
# Everything else (404/409/412/422) is a semantic verdict that a replay
# would only repeat. 429 is transient BY CONTRACT (docs/design/
# serving.md): the admission edge says "later", names the horizon in
# Retry-After, and retry_transient honors it as the backoff floor.
_TRANSIENT_CODES = frozenset({429, 500, 502, 503, 504})


def _is_transient(e: Exception) -> bool:
    if isinstance(e, ApiError):
        return e.code in _TRANSIENT_CODES
    # connection refused/reset, DNS blips, timeouts — urllib wraps them
    # all in URLError (HTTPError is an ApiError by the time it's here)
    return isinstance(e, (urllib.error.URLError, TimeoutError,
                          ConnectionError))


class _StreamUnsupported(Exception):
    """/watchstream answered 404: a pre-serving server — downgrade to
    the long-poll transport without a backoff cycle."""


class RemoteAdmissionHook:
    """Server-side half of a remotely-registered webhook: POSTs the
    admission review to the webhook-manager's endpoint and applies the
    verdict (and any mutation) — the apiserver->webhook TLS call, with
    the serving certificate verified against the webhook configuration's
    CA bundle (the reference's caBundle trust bootstrap,
    cmd/webhook-manager/app/util.go:37-130)."""

    def __init__(self, kind: str, url: str, path: str = "",
                 operations: tuple = ("CREATE",), timeout: float = 10.0,
                 ca_bundle: str = ""):
        self.kind = kind
        self.path = path
        self.url = url
        self.operations = operations
        self.timeout = timeout
        self.validate = None   # the combined review runs in mutate()
        self._ssl_ctx = None
        if url.startswith("https"):
            import ssl
            if ca_bundle:
                # trust exactly the registered CA (hostname/IP-SAN checks
                # stay on — the serving cert carries the endpoint's SANs)
                self._ssl_ctx = ssl.create_default_context(
                    cadata=ca_bundle)
            else:
                # https endpoint registered without a bundle: system trust
                self._ssl_ctx = ssl.create_default_context()

    def mutate(self, operation: str, new_obj, old_obj=None) -> None:
        payload = {
            "path": self.path, "kind": self.kind, "operation": operation,
            "object": encode_object(self.kind, new_obj)
            if new_obj is not None else None,
            "old": encode_object(self.kind, old_obj)
            if old_obj is not None else None,
        }
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout,
                                        context=self._ssl_ctx) as resp:
                review = json.loads(resp.read().decode())
        except Exception as e:
            # failurePolicy: Fail (the reference's default for its
            # validating webhooks) — an unreachable webhook rejects
            raise AdmissionError(
                f"admission webhook {self.path!r} unreachable: {e}")
        if not review.get("allowed", False):
            raise AdmissionError(review.get("message", "denied"))
        mutated = review.get("object")
        if mutated is not None and new_obj is not None:
            patched = decode_object(self.kind, mutated)
            new_obj.__dict__.update(patched.__dict__)


def retry_transient(op: str, key: str, fn, *, attempts: int = 4,
                    base: float = 0.1, cap: float = 2.0, seed: int = 0,
                    sleep=None):
    """Run ``fn`` retrying transient HTTP failures with the shared
    seeded-jitter backoff (``volcano_store_write_retries_total`` per
    retry). Non-transient errors raise immediately; exhausting the
    budget logs loudly WITH the object key — a write the caller thought
    landed silently vanishing is the failure mode this exists to kill.

    At-least-once caveat: a write that COMMITTED server-side but whose
    response was lost (connection reset after commit) is replayed, and
    the replay surfaces as the semantic verdict of a duplicate — 409
    (create: already exists / update: stale resource_version). That is
    the conflict path every caller already handles with a re-get+retry
    round trip (the store's normal optimistic-concurrency contract), so
    the lost-response success degrades to one extra conflict loop, never
    to a silent loss or a silent double-apply."""
    import time as _time
    sleep = sleep if sleep is not None else _time.sleep
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:
            attempt += 1
            if not _is_transient(e) or attempt >= attempts:
                if _is_transient(e):
                    log.error("store write %s %s failed after %d "
                              "attempt(s): %s", op, key, attempt, e)
                raise
            m.inc(m.STORE_WRITE_RETRIES)
            delay = seeded_backoff(f"{op}:{key}", attempt, base, cap,
                                   seed=seed)
            # a throttled write (429) carries the server's own horizon:
            # honor it as the floor — retrying earlier is a guaranteed
            # second rejection that only burns the tenant's bucket
            retry_after = getattr(e, "retry_after", None)
            if retry_after:
                delay = max(delay, float(retry_after))
            log.warning("store write %s %s failed (%s); retry %d/%d in "
                        "%.3fs", op, key, e, attempt, attempts - 1, delay)
            sleep(delay)


class RemoteStore:
    """ObjectStore-compatible facade over a remote apiserver process."""

    # write-path retry budget for transient HTTP errors (a blip used to
    # raise straight through to the caller)
    WRITE_ATTEMPTS = 4
    WRITE_BACKOFF_BASE_S = 0.1
    WRITE_BACKOFF_CAP_S = 2.0
    # watch reconnect backoff: consecutive poll failures back off
    # exponentially instead of hammering a down server at 1 Hz forever
    WATCH_BACKOFF_BASE_S = 0.5
    WATCH_BACKOFF_CAP_S = 15.0

    def __init__(self, base_url, poll_timeout: float = 25.0):
        # ``base_url``: one endpoint, or a list of replica endpoints.
        # With a list, writes route to the fenced leader (StoreClient's
        # /leader discovery + 503/412 handling) while the WATCH stream
        # fails over independently — any replica serves watches, so a
        # broken stream migrates to the next endpoint and resumes from
        # the mirror's cursor (the prev-chain/relist contract; replays
        # dedup on server rv).
        self.client = StoreClient(base_url)
        self.endpoints = list(self.client.endpoints)
        self.base_url = self.endpoints[0]
        self._watch_url = self.endpoints[0]
        self.watch_failovers = 0
        self.mirror = ObjectStore()
        self.poll_timeout = poll_timeout
        self._rv = 0
        # read-your-writes: a component must observe its own successful
        # writes immediately (the in-process store's synchronous watches
        # gave controllers exactly that; without it, get+mutate+update
        # round trips conflict against the component's own lagging
        # mirror). Successful writes self-apply to the mirror; the poll
        # stream's redeliveries are deduped by server resource_version.
        self._seen: dict = {}
        self._seen_lock = threading.Lock()
        # correlation IDs observed on the watch stream (the server echoes
        # a write's ?trace= back as the journal event's "trace" field),
        # keyed by SERVER rv — the same join key trace_of uses on the
        # in-process store. Bounded: old entries age out with the deque.
        from collections import deque as _deque
        self._trace_events: _deque = _deque(maxlen=4096)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.watch_restarts = 0
        # explicit cursor-gap relists (the structured "gone" contract,
        # docs/design/serving.md): counted apart from restart backoff —
        # a gap is a re-anchor, not a failure
        self.watch_relists = 0
        # streaming transport (/watchstream): preferred; a 404 from a
        # pre-serving server downgrades to the long-poll /watch forever
        self._use_stream = True
        import os as _os
        self._client_id = f"remote-{_os.getpid()}-{id(self):x}"
        self._resync()
        self.events = self.mirror.events   # local event record view

    # -- sync loop ---------------------------------------------------------

    def _resync(self) -> None:
        """Prime (or re-prime) the mirror with a full list per kind.

        List+watch anchoring: the SERVER's current rv is read FIRST, the
        lists reflect state at or after it, and the poll resumes from that
        anchor — replayed events older than a listed object's server rv
        are skipped by the _seen dedup (the mirror stamps its own local
        rvs, which must never be confused with the server's)."""
        try:
            resp = json.loads(urllib.request.urlopen(
                f"{self.client.base_url}/rv", timeout=10.0).read().decode())
            anchor = int(resp.get("rv", 0))
        except Exception:
            log.exception("rv anchor fetch failed during resync")
            anchor = self._rv
        for kind in KINDS:
            try:
                remote = {self.mirror.key_of(kind, o): o
                          for o in self.client.list(kind)}
            except Exception:
                log.exception("list %s failed during resync", kind)
                continue
            with self.mirror._lock:
                local_keys = set(self.mirror._objects[kind])
            for key in local_keys - set(remote):
                ns, _, name = key.rpartition("/")
                with self._seen_lock:
                    self._seen[(kind, key)] = max(
                        self._seen.get((kind, key), 0), anchor)
                try:
                    self.mirror.delete(kind, name, ns or "default",
                                       skip_admission=True)
                except KeyError:
                    pass
            for key, o in remote.items():
                self._apply("MODIFIED" if key in local_keys else "ADDED",
                            kind, o, o.metadata.resource_version)
        self._rv = max(self._rv, anchor)

    def _apply(self, action: str, kind: str, o, rv: int = 0) -> None:
        key = self.mirror.key_of(kind, o)
        with self._seen_lock:
            if rv and self._seen.get((kind, key), 0) >= rv:
                return   # already applied (self-write or newer event)
            if rv:
                self._seen[(kind, key)] = rv
        if action == "DELETED":
            try:
                self.mirror.delete(kind, o.metadata.name,
                                   o.metadata.namespace, skip_admission=True)
            except KeyError:
                pass
            return
        with self.mirror._lock:
            exists = key in self.mirror._objects[kind]
        try:
            if exists:
                o.metadata.resource_version = 0   # mirror manages its own rv
                self.mirror.update(kind, o, skip_admission=True)
            else:
                self.mirror.create(kind, o, skip_admission=True)
        except KeyError:
            log.exception("mirror apply %s %s failed", action, kind)

    def _relist(self, anchor_rv: Optional[int] = None) -> None:
        """The structured cursor-gap path (docs/design/serving.md): the
        server said ``gone``/``relist`` — the cursor fell off the
        journal window — so re-list everything and re-anchor, explicitly
        and immediately, instead of burning a restart-backoff cycle on
        what is not a failure."""
        self.watch_relists += 1
        m.inc(m.WATCH_RELISTS)
        self._resync()
        if anchor_rv is not None:
            self._rv = max(self._rv, int(anchor_rv))

    def _apply_wire_event(self, ev: dict) -> None:
        o = decode_object(ev["kind"], ev["object"])
        if ev.get("trace") is not None:
            with self._seen_lock:
                self._trace_events.append((int(ev["rv"]), ev["trace"]))
        self._apply(ev["action"], ev["kind"], o, int(ev["rv"]))
        self._rv = max(self._rv, int(ev["rv"]))

    def _poll_once(self) -> None:
        """One long-poll round against /watch (the pre-serving
        transport, kept as the fallback)."""
        url = (f"{self._watch_url}/watch?since={self._rv}"
               f"&timeout={self.poll_timeout}")
        with urllib.request.urlopen(
                url, timeout=self.poll_timeout + 10.0) as resp:
            data = json.loads(resp.read().decode())
        if data.get("gone") or data.get("resync"):
            self._relist(data.get("rv"))
            return
        for ev in data.get("events", []):
            self._apply_wire_event(ev)

    def _stream_once(self) -> None:
        """One /watchstream session: hold the chunked connection and
        apply coalesced frames as the hub publishes them. Returns on a
        relist (after re-anchoring — the caller restarts the stream
        from the fresh cursor); raises on any transport failure (the
        caller's seeded-backoff restart, same as the long-poll)."""
        import http.client
        u = urllib.parse.urlsplit(self._watch_url)
        conn = http.client.HTTPConnection(
            u.hostname or "127.0.0.1", u.port or 80,
            timeout=self.poll_timeout + 10.0)
        try:
            hb = max(1.0, min(self.poll_timeout, 10.0))
            conn.request(
                "GET",
                f"/watchstream?cursor={self._rv}&heartbeat={hb}"
                f"&client={urllib.parse.quote(self._client_id)}")
            resp = conn.getresponse()
            if resp.status == 404:
                resp.read()
                raise _StreamUnsupported()
            if resp.status != 200:
                raise ApiError(resp.status,
                               f"watchstream HTTP {resp.status}")
            while not self._stop.is_set():
                line = resp.readline()
                if not line:
                    raise ConnectionError("watch stream closed")
                frame = json.loads(line)
                if frame.get("ping") or frame.get("hello"):
                    continue
                if frame.get("relist"):
                    self._relist(frame.get("rv"))
                    return   # restart the stream from the fresh anchor
                for ev in frame.get("events", []):
                    self._apply_wire_event(ev)
        finally:
            try:
                conn.close()
            except Exception:
                pass

    def _poll_loop(self) -> None:
        """Keep the mirror current forever — streaming /watchstream
        when the server offers it (one held connection, frames pushed
        as they publish), long-poll /watch otherwise. EVERY failure
        mode — a dead server, a poisoned event payload, a resync that
        itself fails — restarts the stream with capped seeded
        exponential backoff (``volcano_watch_restarts_total``) instead
        of killing the thread: a watch thread dying silently leaves the
        mirror frozen at a stale rv with nothing ever noticing (the
        pre-failover behavior). A cursor GAP is not a failure: the
        structured gone/relist signal takes the explicit re-anchor path
        (``volcano_watch_relists_total``) with no backoff."""
        failures = 0
        while not self._stop.is_set():
            try:
                if self._use_stream:
                    self._stream_once()
                else:
                    self._poll_once()
            except _StreamUnsupported:
                log.info("server has no /watchstream; long-polling")
                self._use_stream = False
                continue
            except Exception:
                if self._stop.is_set():
                    return
                failures += 1
                self.watch_restarts += 1
                m.inc(m.WATCH_RESTARTS)
                if len(self.endpoints) > 1:
                    # replica failover: any replica serves watches —
                    # resume from the mirror's cursor on the next
                    # endpoint (server-rv dedup absorbs replays, the
                    # relist contract covers a rolled-past cursor)
                    i = self.endpoints.index(self._watch_url)
                    self._watch_url = self.endpoints[
                        (i + 1) % len(self.endpoints)]
                    self.watch_failovers += 1
                delay = seeded_backoff(self._watch_url, failures,
                                       self.WATCH_BACKOFF_BASE_S,
                                       self.WATCH_BACKOFF_CAP_S)
                log.warning("watch poll failed (failure %d); restarting "
                            "the stream on %s in %.2fs", failures,
                            self._watch_url, delay, exc_info=True)
                self._stop.wait(delay)
                continue
            failures = 0   # a clean round closes the backoff window

    def run(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._poll_loop, daemon=True,
                                        name="remote-store-watch")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    # -- ObjectStore interface ---------------------------------------------

    key_of = staticmethod(ObjectStore.key_of)

    @property
    def clock(self):
        return self.mirror.clock

    @staticmethod
    def _map_error(e):
        """HTTP status -> the in-process store's exception types, so
        controllers' retry/conflict handling works unchanged."""
        from .http import ApiError
        from .store import ConflictError, FencedError
        if isinstance(e, ApiError):
            if e.code == 409 and "resource_version" in e.message:
                return ConflictError(e.message)
            if e.code in (404, 409):
                return KeyError(e.message)
            if e.code == 412:
                return FencedError(e.message)
            if e.code == 422:
                return AdmissionError(e.message)
        return e

    def _retrying(self, op: str, key: str, fn):
        return retry_transient(op, key, fn, attempts=self.WRITE_ATTEMPTS,
                               base=self.WRITE_BACKOFF_BASE_S,
                               cap=self.WRITE_BACKOFF_CAP_S)

    def advance_fence(self, token: int) -> int:
        """Announce a freshly-acquired fencing token to the serving
        process (LeaderElector duck-types this against both stores)."""
        return self._retrying("advance_fence", str(token),
                              lambda: self.client.advance_fence(token))

    def trace_of(self, server_rv: int):
        """Correlation ID the watch stream delivered for ``server_rv``
        (the remote twin of ``ObjectStore.trace_of``; None when the event
        was unstamped, aged out, or not yet polled)."""
        with self._seen_lock:
            events = list(self._trace_events)
        for rv, trace in reversed(events):
            if rv == server_rv:
                return trace
        return None

    def create(self, kind: str, o, skip_admission: bool = False,
               fence: Optional[int] = None, trace: Optional[str] = None):
        try:
            created = self._retrying(
                "create", f"{kind}/{self.key_of(kind, o)}",
                lambda: self.client.create(kind, o, fence=fence,
                                           trace=trace))
        except Exception as e:
            raise self._map_error(e) from None
        # the in-process store stamps uid/rv on the caller's object in
        # place; callers chain writes on the same object, so mirror that
        # contract (otherwise the very next update conflicts on rv)
        o.metadata.uid = created.metadata.uid
        o.metadata.creation_timestamp = created.metadata.creation_timestamp
        o.metadata.resource_version = created.metadata.resource_version
        # the mirror gets its own copy: _apply restamps mirror-local rvs
        # and retains the instance, and the caller's returned object must
        # keep the authoritative server rv untouched
        self._apply("ADDED", kind, fast_clone(created),
                    created.metadata.resource_version)
        return created

    def update(self, kind: str, o, skip_admission: bool = False,
               fence: Optional[int] = None, trace: Optional[str] = None):
        try:
            updated = self._retrying(
                "update", f"{kind}/{self.key_of(kind, o)}",
                lambda: self.client.update(kind, o, fence=fence,
                                           trace=trace))
        except Exception as e:
            raise self._map_error(e) from None
        o.metadata.resource_version = updated.metadata.resource_version
        self._apply("MODIFIED", kind, fast_clone(updated),
                    updated.metadata.resource_version)
        return updated

    def delete(self, kind: str, name: str, namespace: str = "default",
               skip_admission: bool = False, fence: Optional[int] = None,
               trace: Optional[str] = None):
        try:
            resp = self._retrying(
                "delete", f"{kind}/{namespace}/{name}",
                lambda: self.client.delete(kind, name, namespace,
                                           fence=fence, trace=trace))
        except Exception as e:
            raise self._map_error(e) from None
        rv = int((resp or {}).get("rv", 0)) if isinstance(resp, dict) else 0
        with self._seen_lock:
            if rv:
                key = name if kind in _CLUSTER_SCOPED \
                    else f"{namespace}/{name}"
                self._seen[(kind, key)] = rv
        try:
            self.mirror.delete(kind, name, namespace, skip_admission=True)
        except KeyError:
            pass

    def get(self, kind: str, name: str, namespace: str = "default"):
        # reads go to the source of truth: controllers do get+mutate+update
        # round trips that need the live resource_version
        return self.client.get(kind, name, namespace)

    def list(self, kind: str, namespace=None) -> list:
        return self.client.list(kind, namespace)

    # read-path offload (docs/design/serving.md): monitoring/read-heavy
    # consumers can serve from the watch-maintained, anti-entropy-
    # repaired mirror without an HTTP round trip or a per-object clone
    # (the list_refs no-copy contract: refs are consistent views, MUST
    # NOT be mutated). Mirror resource_versions are MIRROR-LOCAL — a
    # get+mutate+update round trip needs list()/get() for the server rv.

    def list_cached(self, kind: str, namespace=None) -> list:
        return self.mirror.list_refs(kind, namespace)

    def get_cached(self, kind: str, name: str,
                   namespace: str = "default"):
        return self.mirror.get_ref(kind, name, namespace)

    def watch(self, kind: str, on_add=None, on_update=None, on_delete=None,
              filter_fn=None, sync: bool = True, on_bulk_update=None):
        # bulk delivery is an in-process fast path; the remote mirror
        # replays journal events one at a time, so bulk subscribers simply
        # receive per-event on_update calls (same semantics)
        return self.mirror.watch(kind, on_add, on_update, on_delete,
                                 filter_fn, sync)

    def unwatch(self, w) -> None:
        self.mirror.unwatch(w)

    def register_admission(self, hook) -> None:
        raise NotImplementedError(
            "admission hooks register on the serving process; run a "
            "webhook-manager with --server to register remotely")

    def record_event(self, kind: str, o, event_type: str, reason: str,
                     message: str) -> None:
        payload = {"kind": kind,
                   "object": encode_object(kind, o) if o is not None else None,
                   "event_type": event_type, "reason": reason,
                   "message": message}
        req = urllib.request.Request(
            f"{self.client.base_url}/events",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            urllib.request.urlopen(req, timeout=10.0).close()
        except Exception:
            log.warning("event record failed", exc_info=True)
