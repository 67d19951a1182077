"""The vc-webhook-manager binary (the port's own copy of
volcano_tpu/cmd/webhook_manager.py; reference:
cmd/webhook-manager/app/server.go): registers the enabled admission
services on a store and exposes it over HTTP.

    python -m volcano_tpu_torch.cmd.webhook_manager --server URL \
        [--port 8443] [--tls-cert-dir DIR] [--enabled-admission PATHS]

With ``--server`` it serves the admission endpoint over TLS (a
self-signed CA and serving pair, utils/certs.py) and registers every
enabled service, with the CA bundle, at the apiserver's
``/admissionwebhooks``. The process places nothing: it initialises no
CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import threading

from ..apiserver.http import StoreHTTPServer
from ..apiserver.store import ObjectStore
from ..webhooks import WebhookManager


def add_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--enabled-admission", default=None,
                        help="comma-separated admission service paths")
    parser.add_argument("--port", type=int, default=8443)
    parser.add_argument("--server", default=None,
                        help="remote apiserver URL: serve the admission "
                             "endpoint and self-register the webhooks "
                             "(multi-process mode)")
    parser.add_argument("--tls-cert-dir", default=None,
                        help="directory for the self-signed CA + serving "
                             "cert (generated on first start; default: a "
                             "per-process temp dir). The CA is registered "
                             "as the webhooks' trust bundle.")
    parser.add_argument("--insecure-http", action="store_true",
                        help="serve the admission endpoint over plain "
                             "HTTP (TLS is on by default in --server "
                             "mode, matching the reference)")
    parser.add_argument("--version", action="store_true")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vc-webhook-manager")
    add_flags(parser)
    args = parser.parse_args(argv)
    if args.version:
        from ..version import print_version_and_exit
        print_version_and_exit()
    if args.server:
        # multi-process mode: serve the admission endpoint; the apiserver
        # calls back per matching operation after self-registration
        from ..apiserver.remote import RemoteStore
        from ..webhooks.router import AdmissionHTTPServer
        lookups = RemoteStore(args.server)
        lookups.run()
        tls_dir = None
        if not args.insecure_http:
            tls_dir = args.tls_cert_dir
            if tls_dir is None:
                import atexit
                import shutil
                import tempfile
                tls_dir = tempfile.mkdtemp(prefix="vc-webhook-certs-")
                # ephemeral keys: regenerated + re-registered every start,
                # so nothing needs them after exit
                atexit.register(shutil.rmtree, tls_dir, ignore_errors=True)
        endpoint = AdmissionHTTPServer(
            lookups, enabled_admission=args.enabled_admission,
            port=args.port, tls_cert_dir=tls_dir)
        endpoint.start()
        endpoint.register_with(args.server)
        print(f"vc-webhook-manager serving {len(endpoint.services)} "
              f"admission services on {endpoint.scheme}://127.0.0.1:"
              f"{endpoint.port}, registered with {args.server}", flush=True)
        threading.Event().wait()
        return 0
    store = ObjectStore()
    manager = WebhookManager(store, enabled_admission=args.enabled_admission)
    server = StoreHTTPServer(store, port=args.port)
    server.start()
    print(f"vc-webhook-manager serving {len(manager.services)} admission "
          f"services on :{server.port}", flush=True)
    threading.Event().wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
