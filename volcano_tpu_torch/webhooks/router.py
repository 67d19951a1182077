"""Admission router: service registry + manager
(reference: pkg/webhooks/router/{interface,admission,server}.go and
cmd/webhook-manager/app/server.go).

An ``AdmissionService`` declares a path, the kind/operations it covers, and
mutate/validate callables. The ``WebhookManager`` (the vc-webhook-manager
process equivalent) registers every enabled service as an admission hook on
the in-process store — the store's admission chain plays the role of the
apiserver calling out to the webhook's TLS endpoint.

The port's own copy of volcano_tpu/webhooks/router.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ..apiserver.store import AdmissionError, AdmissionHook, ObjectStore


class AdmissionDenied(AdmissionError):
    """A validating webhook rejected the object."""


@dataclass
class AdmissionService:
    """interface.go:38-48"""
    path: str
    kind: str
    operations: Sequence[str] = ("CREATE",)
    # mutate(store, operation, new_obj, old_obj) edits new_obj in place
    mutate: Optional[Callable] = None
    # validate(store, operation, new_obj, old_obj) raises AdmissionDenied
    validate: Optional[Callable] = None


_services: Dict[str, AdmissionService] = {}


def register_admission(service: AdmissionService) -> None:
    """router.RegisterAdmission equivalent (each webhook file's init())."""
    _services[service.path] = service


def get_service(path: str) -> Optional[AdmissionService]:
    return _services.get(path)


def all_services() -> List[AdmissionService]:
    return list(_services.values())


def enabled_services(enabled_admission: Optional[str]):
    """Filter registered services by the --enabled-admission flag
    (None enables all) — shared by the in-process manager and the
    multi-process admission endpoint."""
    if enabled_admission is None:
        enabled = None
    else:
        enabled = {p.strip() for p in enabled_admission.split(",")
                   if p.strip()}
    return [s for s in all_services()
            if enabled is None or s.path in enabled]


class WebhookManager:
    """Registers enabled admission services with the store
    (cmd/webhook-manager/app/server.go:64-87 registers webhook
    configurations with the apiserver)."""

    def __init__(self, store: ObjectStore,
                 enabled_admission: Optional[str] = None):
        """enabled_admission: comma-separated service paths
        (the --enabled-admission flag); None enables all."""
        self.store = store
        self.services: List[AdmissionService] = \
            enabled_services(enabled_admission)
        self._hooks: List[AdmissionHook] = []
        for svc in self.services:
            hook = AdmissionHook(
                kind=svc.kind, path=svc.path,
                mutate=self._bind(svc.mutate), validate=self._bind(svc.validate),
                operations=tuple(svc.operations))
            self._hooks.append(hook)
            store.register_admission(hook)

    def _bind(self, fn):
        if fn is None:
            return None
        store = self.store

        def bound(operation, new_obj, old_obj):
            return fn(store, operation, new_obj, old_obj)
        return bound


class AdmissionHTTPServer:
    """The webhook-manager's serving half in multi-process mode: exposes
    the enabled admission services over HTTPS and self-registers them —
    with the CA bundle — with a remote apiserver, which calls back per
    matching operation, verifying the serving certificate against that
    bundle (cmd/webhook-manager/app/server.go:64-87 + util.go:37-130 +
    router/server.go).

    ``tls_cert_dir``: directory for the self-signed CA + CA-signed serving
    pair (generated on first start, utils/certs.py); ``None`` serves plain
    HTTP (the --insecure-http escape hatch).

    Request:  POST <service path> {"operation", "object", "old"}
    Response: {"allowed": bool, "message": str, "object": mutated-or-null}
    """

    def __init__(self, store, enabled_admission: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 tls_cert_dir: Optional[str] = None):
        import json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from ..apiserver.codec import decode_object, encode_object

        self.services: Dict[str, AdmissionService] = {
            s.path: s for s in enabled_services(enabled_admission)}
        self.host = host
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def do_POST(self):
                svc = outer.services.get(self.path)
                if svc is None:
                    return self._send(404, {"allowed": False,
                                            "message": "unknown path"})
                body = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))).decode())
                new_obj = decode_object(svc.kind, body["object"]) \
                    if body.get("object") else None
                old_obj = decode_object(svc.kind, body["old"]) \
                    if body.get("old") else None
                op = body.get("operation", "CREATE")
                try:
                    if svc.mutate is not None:
                        svc.mutate(store, op, new_obj, old_obj)
                    if svc.validate is not None:
                        svc.validate(store, op, new_obj, old_obj)
                except AdmissionError as e:
                    return self._send(200, {"allowed": False,
                                            "message": str(e)})
                return self._send(200, {
                    "allowed": True, "message": "",
                    "object": encode_object(svc.kind, new_obj)
                    if new_obj is not None else None})

            def _send(self, code, payload):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        class TLSServer(ThreadingHTTPServer):
            """Handshake runs in the per-request thread, NOT the accept
            loop: wrapping the listening socket would let one stalled
            client park accept() inside do_handshake and block every
            admission callback cluster-wide (fail-closed means all writes
            rejected)."""

            ssl_context = None

            def finish_request(self, request, client_address):
                if self.ssl_context is not None:
                    request.settimeout(10.0)   # bound a stalled handshake
                    try:
                        request = self.ssl_context.wrap_socket(
                            request, server_side=True)
                    except OSError:
                        return   # bad handshake: drop this connection only
                    request.settimeout(None)
                super().finish_request(request, client_address)

        self.scheme = "http"
        self.ca_bundle: Optional[str] = None
        if tls_cert_dir is not None:
            import ssl

            from ..utils.certs import ensure_webhook_certs, read_pem
            ca_crt, tls_crt, tls_key = ensure_webhook_certs(
                tls_cert_dir, hosts=(host, "localhost"))
            # stdlib-hardened server defaults (TLS >= 1.2, vetted ciphers)
            ctx = ssl.create_default_context(ssl.Purpose.CLIENT_AUTH)
            ctx.load_cert_chain(tls_crt, tls_key)
            self.httpd = TLSServer((host, port), Handler)
            self.httpd.ssl_context = ctx
            self.scheme = "https"
            self.ca_bundle = read_pem(ca_crt)
        else:
            self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_port

    def start(self):
        import threading
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                             name="webhook-admission-server")
        t.start()
        return t

    def stop(self):
        self.httpd.shutdown()

    def register_with(self, apiserver_url: str) -> None:
        """Self-register every service — CA bundle included — with the
        remote apiserver (the reference registers Validating/Mutating
        WebhookConfigurations carrying caBundle, util.go:37-101)."""
        import json
        import urllib.request
        for svc in self.services.values():
            payload = {"kind": svc.kind, "path": svc.path,
                       "operations": list(svc.operations),
                       "url": f"{self.scheme}://{self.host}:{self.port}"
                              f"{svc.path}"}
            if self.ca_bundle is not None:
                payload["ca_bundle"] = self.ca_bundle
            req = urllib.request.Request(
                f"{apiserver_url.rstrip('/')}/admissionwebhooks",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            urllib.request.urlopen(req, timeout=10.0).close()
