"""Self-signed CA + serving-certificate generation for the webhook TLS
endpoint (reference: cmd/webhook-manager/app/util.go:37-130
GenerateSelfSignedCert — a CA keypair, a CA-signed serving cert for the
webhook host, and the CA cert registered as the webhook configuration's
CA bundle).

Uses the ``openssl`` CLI (baked into the image) so no Python crypto
package is required.

The port's own copy of volcano_tpu/utils/certs.py."""

from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Sequence, Tuple

CA_CERT = "ca.crt"
CA_KEY = "ca.key"
TLS_CERT = "tls.crt"
TLS_KEY = "tls.key"


def _run(args: Sequence[str]) -> None:
    proc = subprocess.run(args, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"openssl failed ({' '.join(args[:3])}...): {proc.stderr[-400:]}")


def ensure_webhook_certs(cert_dir: str,
                         hosts: Sequence[str] = ("127.0.0.1", "localhost"),
                         days: int = 3650) -> Tuple[str, str, str]:
    """Generate (once) a CA and a CA-signed serving pair covering
    ``hosts`` into ``cert_dir``; reuses existing files. Returns
    (ca_cert_path, tls_cert_path, tls_key_path)."""
    os.makedirs(cert_dir, exist_ok=True)
    ca_crt = os.path.join(cert_dir, CA_CERT)
    ca_key = os.path.join(cert_dir, CA_KEY)
    tls_crt = os.path.join(cert_dir, TLS_CERT)
    tls_key = os.path.join(cert_dir, TLS_KEY)
    hosts_marker = os.path.join(cert_dir, "hosts")
    want_hosts = ",".join(sorted(hosts))
    have_hosts = ""
    if os.path.exists(hosts_marker):
        with open(hosts_marker) as f:
            have_hosts = f.read().strip()
    if all(os.path.exists(p) for p in (ca_crt, tls_crt, tls_key)) \
            and have_hosts == want_hosts:
        return ca_crt, tls_crt, tls_key

    san = ",".join(
        (f"IP:{h}" if h.replace(".", "").isdigit() else f"DNS:{h}")
        for h in hosts)
    if not (os.path.exists(ca_crt) and os.path.exists(ca_key)):
        # never regenerate an existing CA: previously registered bundles
        # (and any persisted trust) must stay valid — only the serving
        # pair is re-minted below when the host set changed
        _run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-sha256",
              "-nodes", "-keyout", ca_key, "-out", ca_crt,
              "-days", str(days), "-subj", "/CN=volcano-webhook-ca"])
    csr = os.path.join(cert_dir, "tls.csr")
    _run(["openssl", "req", "-newkey", "rsa:2048", "-sha256", "-nodes",
          "-keyout", tls_key, "-out", csr, "-subj", f"/CN={hosts[0]}"])
    with tempfile.NamedTemporaryFile("w", suffix=".ext",
                                     delete=False) as ext:
        ext.write(f"subjectAltName={san}\n")
        ext_path = ext.name
    try:
        _run(["openssl", "x509", "-req", "-sha256", "-in", csr,
              "-CA", ca_crt, "-CAkey", ca_key, "-CAcreateserial",
              "-out", tls_crt, "-days", str(days), "-extfile", ext_path])
    finally:
        os.unlink(ext_path)
        if os.path.exists(csr):
            os.unlink(csr)
    for key_path in (ca_key, tls_key):
        os.chmod(key_path, 0o600)
    with open(hosts_marker, "w") as f:
        f.write(want_hosts)
    return ca_crt, tls_crt, tls_key


def read_pem(path: str) -> str:
    with open(path) as f:
        return f.read()
