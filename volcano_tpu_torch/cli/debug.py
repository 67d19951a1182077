"""`vcctl debug`: fetch and pretty-print a running scheduler's /debug/*
(the port's own copy of volcano_tpu/cli/debug.py; metrics/server.py serves
the routes).

    vcctl debug cycles          last N traced cycles (seq, wall, phases)
    vcctl debug pending         why-pending per job / per reason
    vcctl debug health          component health (exit 1 while degraded)
    vcctl debug latency         pod lifecycle ledger percentiles
    vcctl debug timeseries      last N cycles of key gauges/counters
    vcctl debug explain [job]   placement decision provenance (one job's
                                record, or the newest records + the
                                pruning-readiness aggregates)
    vcctl debug replication     replica-set state: epoch, follower lag /
                                applied rvs, gap/bootstrap/fence counters,
                                last anti-entropy audit
    vcctl debug durability      write-ahead-log state: durable rv / lag,
                                fsync latency, segments, last recovery
                                (exit 1 while the store is read-only)

Talks to the metrics server (`--metrics` / $VOLCANO_METRICS, default
http://127.0.0.1:8080), not the apiserver; `--json` prints the raw
payload for piping into jq.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import List

DEFAULT_METRICS = os.environ.get("VOLCANO_METRICS",
                                 "http://127.0.0.1:8080")
VERBS = ("cycles", "pending", "health", "latency", "timeseries",
         "explain", "replication", "durability")


def fetch(server: str, path: str, timeout: float = 10.0):
    """(status, payload) for one /debug GET; non-2xx still parses the
    JSON error body (health serves 503 while degraded by design)."""
    url = server.rstrip("/") + path
    if not url.startswith("http"):
        url = "http://" + url
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode())
        except Exception:
            return e.code, {"error": str(e)}


def _table(rows: List[List[str]], header: List[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*header), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*(str(c) for c in r)) for r in rows]
    return "\n".join(lines)


def _render_cycles(payload: dict) -> str:
    cycles = payload.get("cycles", [])
    if not cycles:
        return ("no traced cycles (tracer "
                f"{'enabled' if payload.get('enabled') else 'DISABLED'})")
    rows = []
    for c in cycles[-20:]:
        top = sorted(c.get("phases", {}).items(),
                     key=lambda kv: -kv[1]["ms"])[:3]
        tags = c.get("tags") or {}
        mode = tags.get("mode", "-")
        if tags.get("quiet"):
            mode = f"{mode}*"      # * = quiet fast path taken
        dirty = f"{tags.get('dirty_jobs', '-')}/" \
                f"{tags.get('dirty_nodes', '-')}" \
            if "dirty_jobs" in tags else "-"
        rows.append([c["seq"], c["cycle_ms"],
                     f"{c.get('coverage', 0):.2f}",
                     mode, dirty, tags.get("skipped_tasks", "-"),
                     c.get("bind_flush_ms", ""),
                     ",".join(c.get("over_budget", [])) or "-",
                     " ".join(f"{n}={e['ms']}" for n, e in top)])
    return _table(rows, ["seq", "cycle_ms", "cover", "mode", "dirty j/n",
                         "skipped", "flush_ms", "over_budget",
                         "top phases (ms)"])


def _render_pending(payload: dict) -> str:
    lines = [f"pending jobs: {payload.get('pending_jobs', 0)}"]
    if payload.get("idle_reason"):
        lines.append(f"idle: {payload['idle_reason']} "
                     f"({payload.get('detail', '')})")
    reasons = payload.get("reasons") or {}
    if reasons:
        lines.append(_table(
            [[r, n] for r, n in sorted(reasons.items(),
                                       key=lambda kv: -kv[1])],
            ["reason", "tasks"]))
    jobs = payload.get("jobs") or {}
    if jobs:
        rows = [[k, j["queue"], j["pending_tasks"], j["unready"],
                 j["min_available"],
                 "; ".join(f"{r} x{n}" for r, n in j["reasons"].items())]
                for k, j in sorted(jobs.items())]
        lines.append(_table(rows, ["job", "queue", "pending", "unready",
                                   "min", "reasons"]))
    return "\n".join(lines)


def _render_health(payload: dict) -> str:
    lines = [f"healthy: {payload.get('healthy')}"]
    comps = payload.get("components") or {}
    if comps:
        rows = [[name, c["healthy"], c.get("detail", "")]
                for name, c in sorted(comps.items())]
        lines.append(_table(rows, ["component", "healthy", "detail"]))
    return "\n".join(lines)


def _render_latency(payload: dict) -> str:
    lines = [f"ledger: enabled={payload.get('enabled')} "
             f"open={payload.get('open')} "
             f"completed={payload.get('completed')} "
             f"dropped={payload.get('dropped')} "
             f"detours={payload.get('detours')}"]
    hops = payload.get("hops") or {}
    if hops:
        rows = [[h, a["count"], a["mean_ms"], a["p50"], a["p95"], a["p99"]]
                for h, a in hops.items()]
        lines.append(_table(rows, ["hop", "count", "mean_ms", "p50",
                                   "p95", "p99"]))
    per_q = payload.get("per_queue_e2e") or {}
    if per_q:
        rows = [[q or "(unknown)", a["count"], a["p50"], a["p95"],
                 a["p99"]] for q, a in per_q.items()]
        lines.append("per-queue e2e:")
        lines.append(_table(rows, ["queue", "count", "p50", "p95", "p99"]))
    recent = payload.get("recent") or []
    if recent:
        rows = [[r["pod"], r.get("trace") or "-", r["e2e_ms"]]
                for r in recent[-10:]]
        lines.append("recent completions:")
        lines.append(_table(rows, ["pod", "trace", "e2e_ms"]))
    return "\n".join(lines)


def _render_timeseries(payload: dict) -> str:
    samples = payload.get("samples") or []
    if not samples:
        return "no samples (tracer off, or no cycle has run)"
    cols: List[str] = []
    for s in samples:
        for k in s:
            if k not in cols:
                cols.append(k)
    short = {c: c.replace("volcano_", "") for c in cols}
    rows = [[s.get(c, "") for c in cols] for s in samples[-15:]]
    return _table(rows, [short[c] for c in cols])


def _fmt_elims(elims: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(elims.items())) or "-"


def _render_explain(payload: dict) -> str:
    if "error" in payload:     # structured 404 (unknown job)
        return (f"{payload['error']} (explainer "
                f"{'enabled' if payload.get('enabled') else 'DISABLED'})")
    if "groups" in payload:    # single-job record (?job=)
        lines = [f"job {payload.get('job')}  cycle={payload.get('cycle')} "
                 f"kernel={payload.get('kernel')} "
                 f"queue={payload.get('queue')} "
                 f"committed={payload.get('committed')}"]
        for g in payload.get("groups", []):
            lines.append(
                f"  gang {g['gang']}: placed {g['placed']}/{g['tasks']} "
                f"winner={g['winner']} feasible={g['feasible']}/"
                f"{g['nodes']} margin={g['win_margin']}")
            lines.append(f"    eliminations: "
                         f"{_fmt_elims(g.get('eliminations', {}))}")
            lines.append("    coverage: " + " ".join(
                f"k={k}:{v}" for k, v in sorted(
                    g.get("coverage", {}).items(), key=lambda kv:
                    int(kv[0]))))
            for e in g.get("topk", [])[:8]:
                terms = " ".join(f"{k}={v}" for k, v in
                                 sorted(e.get("terms", {}).items()))
                lines.append(f"    cand {e['node']} score={e['score']} "
                             f"{terms}")
        return "\n".join(lines)
    lines = [f"explain: enabled={payload.get('enabled')} "
             f"records={payload.get('records')} "
             f"fingerprint={str(payload.get('fingerprint'))[:16]}…"]
    agg = payload.get("aggregates") or {}
    feas = agg.get("feasible_nodes") or {}
    if feas.get("count"):
        lines.append(f"feasible nodes/gang: n={feas['count']} "
                     f"p50={feas.get('p50')} p90={feas.get('p90')} "
                     f"p99={feas.get('p99')} mean={feas.get('mean')}")
    cov = agg.get("topk_coverage") or {}
    if cov:
        lines.append("top-k score coverage: " + " ".join(
            f"k={k}:{v}" for k, v in sorted(cov.items(),
                                            key=lambda kv: int(kv[0]))))
    if agg.get("fragmentation_ratio") is not None:
        lines.append(f"fragmentation ratio: "
                     f"{agg['fragmentation_ratio']}")
    jobs = payload.get("jobs") or {}
    if jobs:
        rows = []
        for key, rec in list(jobs.items())[-20:]:
            g = (rec.get("groups") or [{}])[0]
            rows.append([key, rec.get("kernel"), g.get("winner"),
                         f"{g.get('feasible')}/{g.get('nodes')}",
                         g.get("win_margin"),
                         _fmt_elims(g.get("eliminations", {}))])
        lines.append(_table(rows, ["job", "kernel", "winner",
                                   "feasible", "margin",
                                   "eliminations"]))
    victims = payload.get("victims") or []
    if victims:
        rows = [[v["preemptor"], v["mode"], v["node"],
                 v.get("winning_tier"), len(v.get("victims", [])),
                 v.get("candidates")] for v in victims[-10:]]
        lines.append("victim decisions:")
        lines.append(_table(rows, ["preemptor", "mode", "node", "tier",
                                   "victims", "candidates"]))
    return "\n".join(lines)


def _render_replication(payload: dict) -> str:
    lines_pre = []
    m = payload.get("member")
    if m:   # elector-driven federation process mode
        lines_pre.append(
            f"member {m.get('name')}: role={m.get('role')} "
            f"lease={m.get('lease_holder') or '-'}"
            f"@{m.get('lease_token')} token={m.get('token')} "
            f"takeovers={m.get('takeovers')} "
            f"demotions={m.get('demotions')} "
            f"accepts_writes={m.get('accepts_writes')}")
    f = payload.get("follower")
    if f:   # this process IS a follower apiserver replica
        return "\n".join(lines_pre + [
            f"follower {f['name']}: epoch={f['epoch']} "
            f"applied_rv={f['applied_rv']} lag={f.get('lag_rvs')} "
            f"frames={f['frames_applied']} gaps={f['gaps_detected']} "
            f"catchup={f['catchup_relists']} "
            f"bootstraps={f['snapshot_bootstraps']} "
            f"fenced={f['fenced_frames']}"])
    rs = payload.get("replica_set")
    if not rs:
        return "\n".join(lines_pre) if lines_pre else \
            "no replica set registered (single-replica deployment)"
    leader = rs.get("leader") or {}
    lines = lines_pre + [
        f"epoch: {rs.get('epoch')}  leader rv={leader.get('rv')} "
             f"frames_shipped={leader.get('frames_shipped')} "
             f"events_shipped={leader.get('events_shipped')} "
             f"snapshots_shipped={leader.get('snapshots_shipped')}"]
    lag = rs.get("lag_rvs") or {}
    followers = rs.get("followers") or []
    if followers:
        rows = [[f["name"], f["epoch"], f["applied_rv"],
                 lag.get(f["name"], "-"), f["frames_applied"],
                 f["gaps_detected"], f["catchup_relists"],
                 f["snapshot_bootstraps"], f["fenced_frames"]]
                for f in followers]
        lines.append(_table(rows, ["follower", "epoch", "applied_rv",
                                   "lag", "frames", "gaps", "catchup",
                                   "bootstraps", "fenced"]))
    if rs.get("dead"):
        lines.append(f"dead: {', '.join(rs['dead'])}")
    lines.append(f"cursor handoffs: {rs.get('cursor_handoffs', 0)}")
    audit = rs.get("last_audit")
    if audit:
        lines.append(f"last audit: {audit['verdict']} "
                     f"@ leader rv {audit['leader_rv']}"
                     + (f" divergent: {', '.join(audit['divergent'])}"
                        if audit.get("divergent") else ""))
    else:
        lines.append("last audit: (none run)")
    return "\n".join(lines)


def _render_durability(payload: dict) -> str:
    if not payload.get("attached"):
        lines = ["no WAL attached (started without --data-dir)"]
    else:
        lines = [
            f"wal {payload.get('data_dir')}: gen={payload.get('generation')} "
            f"durable_rv={payload.get('durable_rv')} "
            f"store_rv={payload.get('store_rv')} "
            f"lag={payload.get('lag_entries')} entries",
            _table([[payload.get("segments"), payload.get("segment_bytes"),
                     payload.get("records_written"),
                     payload.get("entries_written"),
                     payload.get("fsyncs"),
                     payload.get("fsync_p50_ms"),
                     payload.get("fsync_p99_ms"),
                     payload.get("append_p99_ms"),
                     payload.get("compactions"),
                     payload.get("rotations")]],
                   ["segs", "bytes", "records", "entries", "fsyncs",
                    "fsync_p50", "fsync_p99", "append_p99", "compact",
                    "rotate"]),
        ]
        if payload.get("read_only"):
            lines.append(f"READ-ONLY: {payload.get('degraded_reason')} "
                         "(writes 503 + Retry-After until the append "
                         "path heals)")
    rec = payload.get("last_recovery")
    if rec:
        lines.append(
            f"last recovery: rv {rec.get('snapshot_rv')} -> "
            f"{rec.get('final_rv')} "
            f"({rec.get('snapshot_objects')} snapshot objects, "
            f"{rec.get('entries_replayed')} WAL entries, "
            f"{rec.get('torn_records_truncated')} torn records truncated, "
            f"{rec.get('recovery_ms')}ms)")
    return "\n".join(lines)


_RENDER = {"cycles": _render_cycles, "pending": _render_pending,
           "health": _render_health, "latency": _render_latency,
           "timeseries": _render_timeseries, "explain": _render_explain,
           "replication": _render_replication,
           "durability": _render_durability}


def _replication_degraded(payload: dict, max_lag: int):
    """The reason `vcctl debug replication` should exit nonzero, or
    None: follower lag past the threshold, a diverged last audit, or a
    member with no electable leader — the same exit-1-while-degraded
    convention `vcctl debug health` follows."""
    reasons = []
    rs = payload.get("replica_set") or {}
    for name, lag in sorted((rs.get("lag_rvs") or {}).items()):
        if lag > max_lag:
            reasons.append(f"follower {name} lag {lag} rvs "
                           f"> --max-lag {max_lag}")
    audit = rs.get("last_audit")
    if audit and audit.get("verdict") not in (None, "identical"):
        reasons.append(
            f"last audit {audit.get('verdict')}"
            + (f" (divergent: {', '.join(audit['divergent'])})"
               if audit.get("divergent") else ""))
    f = payload.get("follower")
    if f and (f.get("lag_rvs") or 0) > max_lag:
        reasons.append(f"follower {f.get('name')} lag "
                       f"{f.get('lag_rvs')} rvs > --max-lag {max_lag}")
    m = payload.get("member")
    if m and m.get("role") == "degraded":
        reasons.append(f"member {m.get('name')} degraded "
                       "(no electable leader)")
    return "; ".join(reasons) if reasons else None


def dispatch_debug(args) -> int:
    path = f"/debug/{args.verb}"
    if args.verb == "explain" and getattr(args, "job", None):
        path += "?job=" + urllib.parse.quote(args.job)
    status, payload = fetch(args.metrics, path)
    if args.json:
        print(json.dumps(payload, indent=1))
    else:
        print(_RENDER[args.verb](payload))
    # /debug/health 503s while degraded — the exit code should say so
    # (and an unknown-job explain lookup exits 1 the same way)
    if args.verb == "replication" and status < 400:
        reason = _replication_degraded(
            payload, getattr(args, "max_lag", 1000))
        if reason:
            print(f"DEGRADED: {reason}")
            return 1
    # a read-only store (ENOSPC/EIO degradation) is operationally
    # degraded even though the endpoint itself serves 200
    if args.verb == "durability" and status < 400 \
            and payload.get("read_only"):
        print(f"DEGRADED: store read-only "
              f"({payload.get('degraded_reason')})")
        return 1
    return 0 if status < 400 else 1


def add_debug_parser(sub) -> None:
    dbg = sub.add_parser(
        "debug", help="fetch and pretty-print a running scheduler's "
                      "/debug endpoints")
    dbg.add_argument("verb", choices=VERBS)
    dbg.add_argument("job", nargs="?", default=None,
                     help="explain only: one job's record (ns/name)")
    dbg.add_argument("--metrics", "-m", default=DEFAULT_METRICS,
                     help="metrics server endpoint "
                          "(default $VOLCANO_METRICS or "
                          "http://127.0.0.1:8080)")
    dbg.add_argument("--json", action="store_true",
                     help="print the raw JSON payload")
    dbg.add_argument("--max-lag", type=int, default=1000,
                     help="replication only: exit 1 when any follower "
                          "lags the leader by more than this many rvs "
                          "(default 1000)")
