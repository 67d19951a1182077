"""Prometheus exposition + flight-recorder debug endpoints (this port's
own copy of volcano_tpu/metrics/server.py; reference: the scheduler's
/metrics on --listen-address, cmd/scheduler/app/server.go:85).

Routes:
  /metrics           Prometheus text exposition
  /debug             index of the debug endpoints below
  /debug/cycles      ring-buffer summaries of the last N traced cycles
  /debug/trace       Chrome trace-event JSON for one cycle (?seq=N, default
                     the newest; load in chrome://tracing or Perfetto)
  /debug/pending     "why pending": per-job / per-reason unschedulable counts
  /debug/health      component health (cycle watchdog et al.); HTTP 503 when
                     any component reports degraded
  /debug/latency     pod lifecycle ledger: per-hop and e2e latency
                     percentiles, per-queue e2e, recent completions
  /debug/timeseries  last N cycles of key gauges/counters (metrics ring)
  /debug/explain     placement decision provenance (?job=ns/name) and the
                     pruning-readiness aggregates
  /debug/serving     the serving hub's shard depths and fan-out latency, and
                     the per-tenant admission counters
  /debug/replication the replica-set state: epoch, follower lag and applied
                     rvs, gap/bootstrap/fence counters, last audit
  /debug/durability  the write-ahead log: durable rv and lag, fsyncs,
                     segments, read-only mode, the last recovery

Unknown paths answer 404 with a JSON error body (never a bare status
line), like every other route.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import metrics as m


# the /debug index: route -> one-line description
DEBUG_ENDPOINTS = {
    "/debug/cycles": "ring-buffer summaries of the last N traced cycles",
    "/debug/trace": "Chrome trace-event JSON for one cycle (?seq=N)",
    "/debug/pending": "why-pending: per-job/per-reason unschedulable counts",
    "/debug/health": "component health (503 while degraded)",
    "/debug/latency": "pod lifecycle ledger: per-hop/e2e latency percentiles",
    "/debug/timeseries": "last N cycles of key gauges/counters",
    "/debug/explain": "placement decision provenance (?job=ns/name) + "
                      "pruning-readiness aggregates",
    "/debug/serving": "serving hub shard depths / fan-out latency + "
                      "per-tenant admission counters",
    "/debug/replication": "replica-set state: epoch, follower lag/applied "
                          "rvs, gap/bootstrap/fence counters, last audit",
    "/debug/durability": "write-ahead-log state: durable rv / lag, fsync "
                         "latency, segments, read-only degradation, last "
                         "recovery",
}


def _debug_response(path: str, query: dict):
    """(status, payload dict) for a /debug/* path, None for unknown."""
    from ..trace import tracer
    if path == "/debug":
        return 200, {"endpoints": DEBUG_ENDPOINTS}
    if path == "/debug/latency":
        from ..trace import ledger
        return 200, ledger.report()
    if path == "/debug/timeseries":
        from . import timeseries
        limit = query.get("limit")
        try:
            n = int(limit[0]) if limit else None
        except ValueError:
            return 400, {"error": f"bad limit {limit[0]!r}"}
        return 200, {"samples": timeseries.series(limit=n)}
    if path == "/debug/cycles":
        return 200, {"enabled": tracer.is_enabled(),
                     "cycles": [tracer.summary(r) for r in tracer.records()]}
    if path == "/debug/trace":
        seq = query.get("seq")
        if seq is not None:
            try:
                rec = tracer.get_record(int(seq[0]))
            except ValueError:
                return 400, {"error": f"bad seq {seq[0]!r}"}
        else:
            rec = tracer.last_record()
        if rec is None:
            return 404, {"error": "no traced cycle in the ring buffer",
                         "enabled": tracer.is_enabled()}
        return 200, tracer.chrome_trace(rec)
    if path == "/debug/health":
        report = m.health_report()
        return (200 if report["healthy"] else 503), report
    if path == "/debug/serving":
        from ..serving import serving_report
        return 200, serving_report()
    if path == "/debug/replication":
        from ..replication import replication_report
        return 200, replication_report()
    if path == "/debug/durability":
        from ..apiserver.wal import durability_report
        return 200, durability_report()
    if path == "/debug/explain":
        from ..trace import explain
        job = query.get("job")
        if job:
            rec = explain.job_record(job[0])
            if rec is None:
                return 404, {"error": "no explanation recorded for job "
                                      f"{job[0]!r}",
                             "enabled": explain.is_enabled()}
            return 200, rec
        limit = query.get("limit")
        try:
            n = int(limit[0]) if limit else 64
        except ValueError:
            return 400, {"error": f"bad limit {limit[0]!r}"}
        return 200, explain.report(limit=n)
    if path == "/debug/pending":
        report = tracer.pending_report()
        if report is None:
            return 200, {"enabled": tracer.is_enabled(), "pending_jobs": 0,
                         "reasons": {}, "jobs": {}}
        return 200, report
    return None


class MetricsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 8080):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, status: int, body: bytes, ctype: str) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urllib.parse.urlsplit(self.path)
                path = parsed.path.rstrip("/")
                if path == "/debug" or path.startswith("/debug/"):
                    res = _debug_response(
                        path, urllib.parse.parse_qs(parsed.query))
                    if res is not None:
                        status, payload = res
                        self._send(status, json.dumps(payload).encode(),
                                   "application/json")
                        return
                if path not in ("", "/metrics"):
                    # JSON error body like every other route (a bare 404
                    # status line broke piped `curl | jq` diagnostics)
                    self._send(404, json.dumps(
                        {"error": "not found", "path": path,
                         "endpoints": ["/metrics"]
                         + sorted(DEBUG_ENDPOINTS)}).encode(),
                        "application/json")
                    return
                self._send(200, m.render_prometheus().encode(),
                           "text/plain; version=0.0.4")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_port
        self._thread: Optional[threading.Thread] = None

    def start(self) -> threading.Thread:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
