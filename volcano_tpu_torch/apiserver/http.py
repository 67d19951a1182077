"""HTTP front-end for the object store + client (the port's own copy of
volcano_tpu/apiserver/http.py; its wire is the reference's, so either
package's client speaks to the other's server).

The reference's CLI and controllers speak REST to the Kubernetes API server;
this module gives the standalone framework the same seam: a threaded HTTP
server over an :class:`ObjectStore` and a client exposing the store's CRUD
interface over the wire. Watches stay in-process (scheduler/controllers run
in the serving process; SURVEY.md section 5.8).

Routes (namespaced kinds):
    GET    /apis/{kind}?namespace=ns      list
    GET    /apis/{kind}/{ns}/{name}       get
    POST   /apis/{kind}                   create
    PUT    /apis/{kind}/{ns}/{name}       update
    DELETE /apis/{kind}/{ns}/{name}       delete
Cluster-scoped kinds use /apis/{kind}/{name}.
Admission rejections -> 422, conflicts -> 409, missing -> 404.

Serving-hub era (docs/design/serving.md): the server speaks HTTP/1.1
with keep-alive (every response carries Content-Length or chunked
framing — one TCP connection serves a client's whole write stream), an
optional :class:`~volcano_tpu_torch.serving.hub.ServingHub` adds the chunked
``/watchstream?cursor=rv`` streaming endpoint (coalesced event-batch
frames pushed as they publish, heartbeat pings between), and an optional
:class:`~volcano_tpu_torch.serving.admission.AdmissionController` enforces
per-tenant write rate limits at the edge — throttled writes answer a
structured 429 with Retry-After, which :class:`StoreClient` surfaces as
``ApiError.retry_after`` and RemoteStore honors in its backoff.

With a federation member (``StoreHTTPServer(member=...)``) writes are
role-gated, ``/lease/<sender>`` takes peer lease pushes and a
non-leader's reads carry its staleness; without one the server is a
standalone apiserver and ``/leader`` names it the write target.
The object bytes of every body and frame are ``codec.dumps_compact``'s
(the native encoder while ``codec.NATIVE_ENCODE`` is on).
"""

from __future__ import annotations

import json
import math
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence, Union

from ..utils.backoff import seeded_backoff
from .codec import decode_object, dumps_compact, encode_object
from .store import (CLUSTER_SCOPED, KINDS, AdmissionError, ConflictError,
                    FencedError, ObjectStore, ReadOnlyError)


def _fence_of(query: dict):
    """Optional fencing token from a write request's query string
    (?fence=N). Fenced rejections map to HTTP 412 Precondition Failed —
    distinct from the 409 conflict, which is retryable by re-reading.
    Raises ValueError on a malformed token (handlers answer 400: a
    garbled fence must never silently degrade to an UNfenced write)."""
    raw = query.get("fence", [None])[0]
    return int(raw) if raw is not None else None


# correlation-ID wire format (docs/design/observability.md): writes carry
# ``?trace=<id>`` and journal deliveries echo it back as the event's
# ``trace`` field, so one bind stays traceable scheduler -> store journal
# -> remote mirror. IDs are opaque strings, length-capped so a hostile
# query string can't bloat the store's trace ranges.
TRACE_MAX_LEN = 128


def _trace_of(query: dict):
    raw = query.get("trace", [None])[0]
    return raw[:TRACE_MAX_LEN] if raw else None


class _CountingThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that counts accepted TCP connections — the
    keep-alive regression surface: two sequential ops over one client
    connection must leave ``connections_accepted`` at 1."""

    connections_accepted = 0
    # a subscriber storm SYN-floods the stdlib default backlog of 5 —
    # connects then time out at the client even though the server is
    # healthy, which reads as a dead replica to failover clients
    request_queue_size = 1024

    def get_request(self):
        req = super().get_request()
        self.connections_accepted += 1
        return req


def _tenant_of(query: dict) -> str:
    """Tenant identity on every request (docs/design/serving.md);
    absent = the default tenant, so single-tenant deployments never
    notice the edge exists."""
    return query.get("tenant", ["default"])[0] or "default"


def json_object_encoder(kind: str, o) -> bytes:
    """The hub's shared wire codec (docs/design/federation.md): one JSON
    serialization of the object payload per event per burst, shared by
    every subscriber's frame and spliced verbatim into NDJSON lines."""
    return dumps_compact(o)


class StoreHTTPServer:
    """The apiserver seam. ``hub``/``admission`` are optional: without
    them the server behaves exactly as the pre-serving era (no
    /watchstream, no write throttling) — cmd/apiserver wires both in
    for the production multi-tenant edge.

    ``member`` (a :class:`~volcano_tpu_torch.replication.election.
    FederationMember`) turns on federation process mode: ``/leader``
    answers leader discovery, ``/lease/<sender>`` takes peer lease
    pushes, object writes are role-gated (a follower or degraded
    replica answers a structured 503 + Retry-After + leader hint
    instead of silently forking the rv space), and follower reads are
    annotated with a staleness bound."""

    def __init__(self, store: ObjectStore, host: str = "127.0.0.1",
                 port: int = 8181, hub=None, admission=None,
                 member=None):
        self.store = store
        self.hub = hub
        self.admission = admission
        self.member = member
        if hub is not None and getattr(hub, "encoder", None) is None:
            # pre-serialize frames once per burst at the hub so the
            # watchstream fan-out shares object bytes across subscribers
            hub.encoder = json_object_encoder
        handler = self._make_handler()
        self.httpd = _CountingThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_port
        self._thread: Optional[threading.Thread] = None

    @property
    def connections_accepted(self) -> int:
        return self.httpd.connections_accepted

    def _make_handler(self):
        store = self.store
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 + accurate Content-Length (or chunked framing) on
            # EVERY response = persistent connections. The pre-serving
            # server answered HTTP/1.0-style — one request per TCP
            # connection, a fresh handshake per write on the seam that
            # carries every bind.
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY: a response goes out as two writes (the
            # headers, then the body), and with Nagle on the body waits
            # for the client's delayed ACK of the headers, 40 ms a
            # request on Linux (the reference's server waits so)
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, payload, headers=None) -> None:
                # keep-alive hygiene: a response sent BEFORE the request
                # body was read (throttled write, unknown route, bad
                # fence) must still drain that body, or its bytes parse
                # as the connection's next request line. self.headers is
                # fresh per request, so it carries the consumed flag.
                try:
                    remaining = int(self.headers.get("Content-Length",
                                                     0) or 0)
                    if remaining and not getattr(self.headers,
                                                 "_body_consumed", False):
                        self.headers._body_consumed = True
                        self.rfile.read(remaining)
                except (ValueError, OSError):
                    self.close_connection = True
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _gate_write(self) -> bool:
                """Federation role gate on the write path: only the
                fenced leader takes writes. False = a structured 503
                with Retry-After and the current leader hint already
                went out (retry_transient honors the delay; a failover
                client re-discovers the leader from the hint)."""
                member = server.member
                if member is None or member.accepts_writes():
                    return True
                hint = member.leader_hint()
                retry_after = member.retry_after()
                payload = {"error": f"replica {member.name} is "
                                    f"{member.role()}: writes go to the "
                                    f"leader",
                           "role": member.role(),
                           "retry_after": retry_after,
                           "leader": hint}
                stale = member.staleness()
                if stale is not None:
                    payload["staleness"] = stale
                self._send(503, payload,
                           headers={"Retry-After":
                                    str(max(1, math.ceil(retry_after)))})
                return False

            def _send_read_only(self, e: ReadOnlyError) -> None:
                """Durability degradation (docs/design/durability.md):
                the WAL can no longer persist writes (ENOSPC/EIO), so
                the store answers every mutation with the same
                structured 503 + Retry-After shape the federation role
                gate uses, which the client pacer honors."""
                retry_after = float(getattr(e, "retry_after", 5.0))
                self._send(503, {"error": str(e), "read_only": True,
                                 "reason": getattr(e, "reason", str(e)),
                                 "retry_after": retry_after},
                           headers={"Retry-After":
                                    str(max(1, math.ceil(retry_after)))})

            def _staleness_headers(self) -> Optional[dict]:
                """Read-path annotation: a non-leader replica stamps
                its role and staleness bound (applied rv + estimated
                lag) on every read so clients know how far behind the
                data may be."""
                member = server.member
                if member is None:
                    return None
                role = member.role()
                if role == "leader":
                    return None
                headers = {"X-Volcano-Role": role}
                stale = member.staleness()
                if stale is not None:
                    headers["X-Volcano-Applied-Rv"] = \
                        str(stale["applied_rv"])
                    headers["X-Volcano-Staleness-Rvs"] = \
                        str(stale["lag_rvs"])
                return headers

            def _admit_tenant(self, query: dict) -> bool:
                """Per-tenant write admission; False = throttled (the
                429 with Retry-After already went out)."""
                if server.admission is None:
                    return True
                from ..serving.admission import ThrottledError
                try:
                    server.admission.admit_write(_tenant_of(query))
                    return True
                except ThrottledError as e:
                    self._send(429, {"error": str(e),
                                     "retry_after": e.retry_after},
                               headers={"Retry-After":
                                        str(max(1, math.ceil(
                                            e.retry_after)))})
                    return False

            def _parse(self):
                parsed = urllib.parse.urlparse(self.path)
                parts = [p for p in parsed.path.split("/") if p]
                query = urllib.parse.parse_qs(parsed.query)
                if len(parts) < 2 or parts[0] != "apis" or parts[1] not in KINDS:
                    return None
                kind = parts[1]
                rest = parts[2:]
                if kind in CLUSTER_SCOPED:
                    name = rest[0] if rest else None
                    ns = "default"
                else:
                    ns = rest[0] if len(rest) >= 2 else \
                        (query.get("namespace", ["default"])[0])
                    name = rest[1] if len(rest) >= 2 else None
                return kind, ns, name, query

            def _body(self):
                length = int(self.headers.get("Content-Length", 0))
                self.headers._body_consumed = True
                return json.loads(self.rfile.read(length)) if length else None

            def _encode_events(self, events) -> list:
                # ONE trace-map snapshot for the whole batch (a
                # 50k-event response must not copy the map per event);
                # each rv resolves by bisect
                from .store import trace_in_ranges
                ranges = store.trace_ranges() if events else []
                payload = []
                for erv, action, kind, o in events:
                    ev = {"rv": erv, "action": action, "kind": kind,
                          "object": encode_object(kind, o)}
                    trace = trace_in_ranges(ranges, erv)
                    if trace is not None:
                        ev["trace"] = trace
                    payload.append(ev)
                return payload

            def _chunk_raw(self, body: bytes) -> None:
                self.wfile.write(f"{len(body):X}\r\n".encode() + body
                                 + b"\r\n")
                self.wfile.flush()

            def _chunk(self, payload: dict) -> None:
                self._chunk_raw(json.dumps(payload).encode() + b"\n")

            def _chunk_frame_shared(self, frame: dict) -> None:
                """One event frame on the shared-bytes fast path: the
                object payloads were serialized ONCE per burst by the
                hub (``frame["encoded"]`` pairs 1:1 with the events);
                this splices the shared bytes into a per-subscriber
                wrapper carrying the per-sub action labels."""
                from .store import trace_in_ranges
                ranges = store.trace_ranges()
                parts = []
                for (erv, action, kind, _o), ob in zip(frame["events"],
                                                       frame["encoded"]):
                    head = {"rv": erv, "action": action, "kind": kind}
                    trace = trace_in_ranges(ranges, erv)
                    if trace is not None:
                        head["trace"] = trace
                    hb = json.dumps(head)
                    parts.append(hb[:-1].encode()
                                 + b', "object": ' + ob + b"}")
                meta = json.dumps({
                    "prev": frame["prev"], "from_rv": frame["from_rv"],
                    "to_rv": frame["to_rv"],
                    "coalesced_from": frame["coalesced_from"],
                    "epoch": frame.get("epoch", 0)})
                self._chunk_raw(meta[:-1].encode() + b', "events": ['
                                + b", ".join(parts) + b"]}\n")

            def _watchstream(self, q: dict) -> None:
                """Chunked streaming watch: hold the connection and
                frame coalesced batches as the hub publishes them
                (docs/design/serving.md). One frame = one chunk-framed
                NDJSON line; heartbeat pings keep half-open detection
                cheap; a cursor off the journal window gets the
                structured relist frame."""
                hub = server.hub
                if hub is None:
                    return self._send(404, {
                        "error": "watchstream not enabled (no serving "
                                 "hub on this apiserver)"})
                from ..serving.admission import ThrottledError
                try:
                    cursor = int(q.get("cursor", ["-1"])[0])
                    # clamp: heartbeat=0 would spin ping chunks at full
                    # speed off one unauthenticated request; negative
                    # would crash the Condition wait
                    heartbeat = max(1.0, min(60.0, float(
                        q.get("heartbeat", ["10"])[0])))
                except ValueError:
                    return self._send(400, {"error": "malformed cursor/"
                                                     "heartbeat"})
                client = q.get("client", [""])[0] \
                    or f"anon-{threading.get_ident()}"
                kinds_raw = q.get("kinds", [""])[0]
                kinds = tuple(k for k in kinds_raw.split(",") if k) or None
                filter_attr = None
                filt = q.get("filter", [""])[0]
                if filt:
                    # an unsupported filter must REJECT, never silently
                    # degrade to an unfiltered firehose
                    path_, eq, expected = filt.partition("=")
                    parts = path_.split(".")
                    if not eq or len(parts) != 2 or not all(parts):
                        return self._send(400, {
                            "error": f"unsupported filter {filt!r} "
                                     "(want attr0.attr1=value)"})
                    filter_attr = ((parts[0], parts[1]), expected)
                try:
                    sub = hub.subscribe(
                        client, tenant=_tenant_of(q), kinds=kinds,
                        filter_attr=filter_attr,
                        since_rv=None if cursor < 0 else cursor)
                except ThrottledError as e:
                    return self._send(
                        429, {"error": str(e),
                              "retry_after": e.retry_after},
                        headers={"Retry-After":
                                 str(max(1, math.ceil(e.retry_after)))})
                # a stream monopolizes its connection; never keep-alive
                self.close_connection = True
                try:
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    # sub.anchor, NOT sub.cursor: dispatch may already
                    # have advanced the live cursor past frames sitting
                    # in the outbox, and a hello ahead of those frames
                    # turns them into client-visible duplicates
                    hello = {"hello": True, "rv": sub.anchor,
                             "client": client, "epoch": hub.epoch}
                    member = server.member
                    if member is not None:
                        hello["role"] = member.role()
                        stale = member.staleness()
                        if stale is not None:
                            hello["staleness_rvs"] = stale["lag_rvs"]
                    self._chunk(hello)
                    while True:
                        frame = sub.next_frame(timeout=heartbeat)
                        if sub.closed:
                            break
                        if frame is None:
                            ping = {"ping": True,
                                    "rv": store.current_rv(),
                                    "epoch": hub.epoch}
                            if member is not None:
                                ping["role"] = member.role()
                                stale = member.staleness()
                                if stale is not None:
                                    ping["staleness_rvs"] = \
                                        stale["lag_rvs"]
                            self._chunk(ping)
                            continue
                        if frame.get("relist"):
                            self._chunk({"relist": True,
                                         "rv": frame["rv"],
                                         "prev": frame.get("prev"),
                                         "epoch": frame.get(
                                             "epoch", hub.epoch)})
                            continue
                        if frame.get("encoded") is not None:
                            self._chunk_frame_shared(frame)
                            continue
                        self._chunk({
                            "prev": frame["prev"],
                            "from_rv": frame["from_rv"],
                            "to_rv": frame["to_rv"],
                            "coalesced_from": frame["coalesced_from"],
                            "epoch": frame.get("epoch", hub.epoch),
                            "events": self._encode_events(
                                frame["events"])})
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass   # client went away: normal stream teardown
                finally:
                    hub.unsubscribe(sub)

            def _replicate_stream(self, q: dict) -> None:
                """Leader half of journal replication (docs/design/
                federation.md): stream contiguous journal ranges to a
                follower replica as chunked NDJSON, every frame stamped
                with this replica's newest observed leadership epoch
                (the fence floor) so a deposed leader's frames are
                rejectable at the follower. A cursor off the journal
                window answers a ``gone`` frame — the follower must
                bootstrap from ``/replicate/snapshot``."""
                try:
                    since = int(q.get("since", ["0"])[0])
                    heartbeat = max(1.0, min(60.0, float(
                        q.get("heartbeat", ["10"])[0])))
                except ValueError:
                    return self._send(400, {"error": "malformed since/"
                                                     "heartbeat"})
                self.close_connection = True
                try:
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    self._chunk({"hello": True, "rv": store.current_rv(),
                                 "epoch": store.fence_floor()})
                    cursor = since
                    while True:
                        events, rv, resync = store.events_since(
                            cursor, heartbeat)
                        if resync:
                            self._chunk({"gone": True, "rv": rv,
                                         "epoch": store.fence_floor()})
                            return
                        if not events:
                            self._chunk({"ping": True, "rv": rv,
                                         "epoch": store.fence_floor()})
                            continue
                        self._chunk({
                            "from_rv": events[0][0], "to_rv": rv,
                            "epoch": store.fence_floor(),
                            "entries": [
                                [e[0], e[1], e[2],
                                 encode_object(e[2], e[3])]
                                for e in events]})
                        cursor = rv
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass   # follower went away: normal stream teardown

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                if parsed.path == "/rv":
                    return self._send(200, {"rv": store.current_rv()})
                if parsed.path == "/fence":
                    return self._send(200, {"floor": store.fence_floor()})
                if parsed.path == "/leader":
                    member = server.member
                    if member is None:
                        # a standalone apiserver is the write target
                        return self._send(200, {
                            "role": "standalone", "accepts_writes": True,
                            "holder": "", "url": "",
                            "token": store.fence_floor(), "live": True})
                    info = member.leader_hint()
                    info["role"] = member.role()
                    info["accepts_writes"] = member.accepts_writes()
                    stale = member.staleness()
                    if stale is not None:
                        info["staleness"] = stale
                    return self._send(200, info)
                if parsed.path == "/watchstream":
                    return self._watchstream(
                        urllib.parse.parse_qs(parsed.query))
                if parsed.path == "/replicate":
                    return self._replicate_stream(
                        urllib.parse.parse_qs(parsed.query))
                if parsed.path == "/replicate/snapshot":
                    from ..replication.leader import snapshot_payload
                    return self._send(200, snapshot_payload(store))
                if parsed.path == "/watch":
                    q = urllib.parse.parse_qs(parsed.query)
                    since = int(q.get("since", ["0"])[0])
                    timeout = min(60.0, float(q.get("timeout", ["25"])[0]))
                    events, rv, resync = store.events_since(since, timeout)
                    payload = self._encode_events(events)
                    # "gone" is the structured signal that the cursor
                    # fell off the journal window: the client MUST
                    # re-list and re-anchor at "rv" ("resync" kept for
                    # pre-serving clients — same meaning)
                    return self._send(200, {"rv": rv, "resync": resync,
                                            "gone": resync,
                                            "events": payload})
                route = self._parse()
                if route is None:
                    return self._send(404, {"error": "not found"})
                kind, ns, name, query = route
                # read-path offload (docs/design/serving.md): serve from
                # live refs — encoding only READS, stored objects are
                # replaced never mutated, so the per-request deep copy
                # bought nothing but writer-lock contention
                stale_headers = self._staleness_headers()
                if name is None:
                    namespace = query.get("namespace", [None])[0]
                    items = store.list_refs(kind, namespace)
                    return self._send(200, {"items": [
                        encode_object(kind, o) for o in items]},
                        headers=stale_headers)
                o = store.get_ref(kind, name, ns)
                if o is None:
                    return self._send(404, {"error": f"{kind} {name} not found"})
                return self._send(200, encode_object(kind, o),
                                  headers=stale_headers)

            def do_POST(self):
                parsed = urllib.parse.urlparse(self.path)
                if not self._admit_tenant(
                        urllib.parse.parse_qs(parsed.query)):
                    return
                if parsed.path.startswith("/lease/"):
                    # a peer's leader lease push (process-mode election
                    # side channel — NEVER the replicated rv space)
                    member = server.member
                    if not hasattr(member, "receive_lease"):
                        # standalone, or a plain follower: no election
                        return self._send(404, {
                            "error": "not a federation member"})
                    body = self._body() or {}
                    view = member.receive_lease(
                        body.get("holder", ""),
                        int(body.get("token", 0)),
                        body.get("url", ""))
                    return self._send(200, view)
                if parsed.path == "/fence":
                    # the LeaderElector of a remote process announcing its
                    # freshly-acquired token; floor advance is monotonic
                    body = self._body() or {}
                    floor = store.advance_fence(int(body.get("token", 0)))
                    return self._send(200, {"floor": floor})
                if parsed.path == "/events":
                    if not self._gate_write():
                        return
                    body = self._body()
                    o = decode_object(body["kind"], body["object"]) \
                        if body.get("object") else None
                    store.record_event(body["kind"], o, body["event_type"],
                                       body["reason"], body["message"])
                    return self._send(201, {"status": "recorded"})
                if parsed.path == "/admissionwebhooks":
                    # the webhook-manager's self-registration: the store
                    # calls back over HTTPS on matching operations,
                    # verifying the webhook's serving certificate against
                    # the registered CA bundle (the reference registers
                    # WebhookConfigurations carrying caBundle,
                    # cmd/webhook-manager/app/server.go:64-87 +
                    # util.go:37-130)
                    body = self._body()
                    from .remote import RemoteAdmissionHook
                    store.register_admission(RemoteAdmissionHook(
                        kind=body["kind"], path=body.get("path", ""),
                        url=body["url"],
                        operations=tuple(body.get("operations",
                                                  ("CREATE",))),
                        ca_bundle=body.get("ca_bundle", "")),
                        replace=True)
                    return self._send(201, {"status": "registered"})
                route = self._parse()
                if route is None:
                    return self._send(404, {"error": "not found"})
                if not self._gate_write():
                    return
                kind, _ns, _name, query = route
                try:
                    fence = _fence_of(query)
                except ValueError:
                    return self._send(400, {"error": "malformed fence token"})
                try:
                    o = decode_object(kind, self._body())
                    created = store.create(kind, o, fence=fence,
                                           trace=_trace_of(query))
                    return self._send(201, encode_object(kind, created))
                except ReadOnlyError as e:
                    return self._send_read_only(e)
                except FencedError as e:
                    return self._send(412, {"error": str(e)})
                except AdmissionError as e:
                    return self._send(422, {"error": str(e)})
                except KeyError as e:
                    return self._send(409, {"error": str(e)})

            def do_PUT(self):
                route = self._parse()
                if route is None:
                    return self._send(404, {"error": "not found"})
                kind, _ns, _name, query = route
                if not self._admit_tenant(query):
                    return
                if not self._gate_write():
                    return
                try:
                    fence = _fence_of(query)
                except ValueError:
                    return self._send(400, {"error": "malformed fence token"})
                try:
                    o = decode_object(kind, self._body())
                    updated = store.update(kind, o, fence=fence,
                                           trace=_trace_of(query))
                    return self._send(200, encode_object(kind, updated))
                except ReadOnlyError as e:
                    return self._send_read_only(e)
                except FencedError as e:
                    return self._send(412, {"error": str(e)})
                except ConflictError as e:
                    return self._send(409, {"error": str(e)})
                except AdmissionError as e:
                    return self._send(422, {"error": str(e)})
                except KeyError as e:
                    return self._send(404, {"error": str(e)})

            def do_DELETE(self):
                route = self._parse()
                if route is None or route[2] is None:
                    return self._send(404, {"error": "not found"})
                kind, ns, name, query = route
                if not self._admit_tenant(query):
                    return
                if not self._gate_write():
                    return
                try:
                    fence = _fence_of(query)
                except ValueError:
                    return self._send(400, {"error": "malformed fence token"})
                try:
                    rv = store.delete(kind, name, ns, fence=fence,
                                      trace=_trace_of(query))
                    return self._send(200, {"status": "deleted", "rv": rv})
                except ReadOnlyError as e:
                    return self._send_read_only(e)
                except FencedError as e:
                    return self._send(412, {"error": str(e)})
                except AdmissionError as e:
                    return self._send(422, {"error": str(e)})
                except KeyError as e:
                    return self._send(404, {"error": str(e)})

        return Handler

    def start(self) -> threading.Thread:
        if self.hub is not None:
            self.hub.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        if self.hub is not None:
            self.hub.stop()
        self.httpd.shutdown()
        self.httpd.server_close()


class ApiError(Exception):
    def __init__(self, code: int, message: str,
                 retry_after: Optional[float] = None):
        super().__init__(message)
        self.code = code
        self.message = message
        # the 429 edge's Retry-After, parsed so RemoteStore's backoff
        # can honor the server's own horizon instead of guessing
        self.retry_after = retry_after


class PooledConnection:
    """Per-thread persistent HTTP/1.1 connections to one base URL.

    The pre-serving client opened a fresh ``urllib.urlopen`` (TCP
    handshake + slow-start) PER WRITE — on the seam that carries every
    bind. With the server speaking HTTP/1.1 this keeps one
    ``http.client.HTTPConnection`` per (thread, endpoint) and replays a
    request once when a cached connection turns out to have been closed
    idle by the peer (``RemoteDisconnected`` before any response bytes —
    the same at-least-once caveat ``retry_transient`` documents)."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        u = urllib.parse.urlsplit(base_url)
        if u.scheme not in ("http", ""):
            raise ValueError(f"PooledConnection is http-only, got "
                             f"{base_url!r}")
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 80
        self.timeout = timeout
        self._local = threading.local()

    def _conn(self, fresh: bool = False):
        import http.client
        conn = getattr(self._local, "conn", None)
        if fresh and conn is not None:
            try:
                conn.close()
            except Exception:
                pass
            conn = None
        if conn is None:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout)
            self._local.conn = conn
        return conn

    def request(self, method: str, path: str, body: Optional[bytes] = None,
                headers: Optional[dict] = None) -> tuple:
        """(status, headers, body bytes); retries once on a stale cached
        connection, never on a fresh one."""
        import http.client
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        for attempt in (0, 1):
            conn = self._conn(fresh=attempt > 0)
            reused = attempt == 0 and getattr(self._local, "used", False)
            try:
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
                self._local.used = True
                if resp.will_close:
                    self.close()
                return resp.status, resp.headers, data
            except (http.client.RemoteDisconnected,
                    http.client.BadStatusLine,
                    http.client.CannotSendRequest,
                    BrokenPipeError, ConnectionResetError):
                self.close()
                if not reused:
                    raise
                # stale keep-alive connection: reconnect and replay once
            except BaseException:
                # ANY other failure (connection refused, timeout, ...)
                # must DROP the cached connection: http.client leaves a
                # half-started request state behind a failed connect,
                # and every later request on that object would raise
                # CannotSendRequest forever
                self.close()
                raise

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
            self._local.conn = None
            self._local.used = False


class StoreClient:
    """Remote client mirroring the ObjectStore CRUD surface, over a
    pooled keep-alive connection (writes reuse one TCP connection; the
    RemoteStore watch loop streams on its own).

    ``base_url`` may be a single endpoint (the pre-federation shape —
    behavior is unchanged) or a LIST of replica endpoints. With a list
    the client fails over: a dead endpoint rotates to the next one
    (reads) or re-discovers the leader via ``GET /leader`` (writes),
    a 503 role rejection re-discovers and retries, and a 412 fence
    rejection re-discovers for the NEXT operation but re-raises —
    a fenced write is a correctness signal, never silently absorbed.
    Retry pacing shares :func:`~volcano_tpu.utils.backoff.
    seeded_backoff` with the replication follower (deterministic
    jitter, no third ad-hoc retry loop)."""

    FAILOVER_BASE_S = 0.05
    FAILOVER_CAP_S = 1.0

    def __init__(self, base_url: Union[str, Sequence[str]],
                 timeout: float = 10.0, client_id: str = ""):
        if isinstance(base_url, str):
            endpoints = [base_url]
        else:
            endpoints = list(base_url)
        if not endpoints:
            raise ValueError("StoreClient needs at least one endpoint")
        self.endpoints: List[str] = [e.rstrip("/") for e in endpoints]
        self.timeout = timeout
        self.client_id = client_id or "store-client"
        self._pools = {e: PooledConnection(e, timeout=timeout)
                       for e in self.endpoints}
        self.base_url = self.endpoints[0]
        self.pool = self._pools[self.base_url]
        self.failovers = 0
        self.leader_redirects = 0

    # -- endpoint routing --------------------------------------------------

    def _use(self, endpoint: str) -> None:
        self.base_url = endpoint
        self.pool = self._pools[endpoint]

    def _rotate(self) -> str:
        """Next endpoint in declaration order (deterministic)."""
        i = self.endpoints.index(self.base_url)
        self._use(self.endpoints[(i + 1) % len(self.endpoints)])
        return self.base_url

    def _probe_leader(self, endpoint: str) -> dict:
        status, _headers, body = self._pools[endpoint].request(
            "GET", "/leader")
        if status != 200:
            raise ApiError(status, f"leader probe: HTTP {status}")
        return json.loads(body)

    def discover_leader(self) -> Optional[str]:
        """Find the replica currently accepting writes: probe every
        endpoint (active first, then declaration order) for
        ``GET /leader``; follow a holder-url hint when it names a known
        endpoint. Returns the endpoint (now active) or None when no
        replica claims the lease (degraded set — the caller's 503
        handling paces the retry)."""
        order = [self.base_url] + [e for e in self.endpoints
                                   if e != self.base_url]
        hints: List[str] = []
        for ep in order:
            try:
                info = self._probe_leader(ep)
            except Exception:
                continue
            if info.get("accepts_writes") and info.get("role") in (
                    "leader", "standalone"):
                self._use(ep)
                return ep
            hint = (info.get("url") or "").rstrip("/")
            if hint and hint in self.endpoints and hint not in hints:
                hints.append(hint)
        for ep in hints:
            try:
                info = self._probe_leader(ep)
            except Exception:
                continue
            if info.get("accepts_writes"):
                self._use(ep)
                return ep
        return None

    def _request(self, method: str, path: str, payload=None):
        import http.client
        data = json.dumps(payload).encode() if payload is not None else None
        is_write = method in ("POST", "PUT", "DELETE")
        single = len(self.endpoints) == 1
        attempts = 1 if single else 2 * len(self.endpoints)
        last_exc: Optional[Exception] = None
        for attempt in range(1, attempts + 1):
            if attempt > 1:
                delay = seeded_backoff(
                    f"{self.client_id}:{method}:{path}", attempt - 1,
                    self.FAILOVER_BASE_S, self.FAILOVER_CAP_S)
                if delay:
                    time.sleep(delay)
            try:
                status, headers, body = self.pool.request(method, path,
                                                          body=data)
            except (OSError, http.client.HTTPException) as e:
                # keep the pre-pool error contract: connection-level
                # blips surface as URLError (what retry_transient
                # classifies)
                last_exc = urllib.error.URLError(e)
                if single:
                    raise last_exc from None
                self.failovers += 1
                if is_write:
                    self.discover_leader()
                else:
                    self._rotate()
                continue
            if status >= 400:
                try:
                    decoded = json.loads(body)
                except Exception:
                    decoded = {}
                message = decoded.get("error", "") or f"HTTP {status}"
                retry_after = None
                ra = headers.get("Retry-After") \
                    if headers is not None else None
                if ra:
                    try:
                        retry_after = float(ra)
                    except ValueError:
                        pass
                err = ApiError(status, message, retry_after=retry_after)
                if status == 412 and not single:
                    # fenced: OUR regime knowledge is stale. Re-discover
                    # so the next op routes right, but surface the
                    # rejection — a silent retry into a deposed leader
                    # (or with a dead token) is the failure mode fencing
                    # exists to stop
                    self.leader_redirects += 1
                    self.discover_leader()
                    raise err
                if status == 503 and not single and is_write \
                        and attempt < attempts:
                    # role rejection: a follower/degraded replica.
                    # Honor its Retry-After, then re-discover
                    self.failovers += 1
                    if retry_after:
                        time.sleep(min(retry_after,
                                       self.FAILOVER_CAP_S))
                    self.discover_leader()
                    last_exc = err
                    continue
                raise err
            return json.loads(body) if body else None
        raise last_exc if last_exc is not None else \
            urllib.error.URLError("no endpoint reachable")

    def _path(self, kind: str, name: Optional[str] = None,
              namespace: str = "default") -> str:
        if name is None:
            return f"/apis/{kind}"
        if kind in CLUSTER_SCOPED:
            return f"/apis/{kind}/{name}"
        return f"/apis/{kind}/{namespace}/{name}"

    def get(self, kind: str, name: str, namespace: str = "default"):
        try:
            data = self._request("GET", self._path(kind, name, namespace))
        except ApiError as e:
            if e.code == 404:
                return None
            raise
        return decode_object(kind, data)

    def list(self, kind: str, namespace: Optional[str] = None) -> list:
        path = self._path(kind)
        if namespace is not None:
            path += f"?namespace={urllib.parse.quote(namespace)}"
        data = self._request("GET", path)
        return [decode_object(kind, item) for item in data["items"]]

    @staticmethod
    def _with_params(path: str, fence, trace=None) -> str:
        params = []
        if fence is not None:
            params.append(f"fence={int(fence)}")
        if trace is not None:
            params.append(f"trace={urllib.parse.quote(str(trace))}")
        return f"{path}?{'&'.join(params)}" if params else path

    def create(self, kind: str, o, fence=None, trace=None):
        data = self._request("POST",
                             self._with_params(self._path(kind), fence,
                                               trace),
                             encode_object(kind, o))
        return decode_object(kind, data)

    def update(self, kind: str, o, fence=None, trace=None):
        path = self._path(kind, o.metadata.name, o.metadata.namespace)
        data = self._request("PUT", self._with_params(path, fence, trace),
                             encode_object(kind, o))
        return decode_object(kind, data)

    def delete(self, kind: str, name: str, namespace: str = "default",
               fence=None, trace=None):
        return self._request(
            "DELETE", self._with_params(self._path(kind, name, namespace),
                                        fence, trace))

    def advance_fence(self, token: int) -> int:
        return int(self._request("POST", "/fence",
                                 {"token": int(token)}).get("floor", 0))
