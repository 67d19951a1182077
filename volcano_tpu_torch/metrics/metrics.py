"""Prometheus-style metrics (this port's own copy of
volcano_tpu/metrics/metrics.py; reference: pkg/scheduler/metrics/*.go).

The metric names mirror the reference's (namespace ``volcano``) so dashboards
translate directly. Without a hard prometheus_client dependency, metrics are
kept in-process (counters/gauges/histogram summaries) and can be scraped via
``render_prometheus()`` which emits the text exposition format.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Tuple

_lock = threading.Lock()


class _Hist:
    __slots__ = ("count", "total", "buckets")
    # log-spaced to cover metrics recorded in seconds, milliseconds and
    # microseconds alike (the reference's units vary per metric)
    BOUNDS = (0.0001, 0.001, 0.01, 0.1, 1.0, 10.0, 100.0,
              1e3, 1e4, 1e5, 1e6, 1e7)

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.buckets = [0] * (len(self.BOUNDS) + 1)

    def observe(self, v: float):
        self.count += 1
        self.total += v
        for i, b in enumerate(self.BOUNDS):
            if v <= b:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1


_histograms: Dict[Tuple[str, Tuple], _Hist] = defaultdict(_Hist)
_gauges: Dict[Tuple[str, Tuple], float] = {}
_counters: Dict[Tuple[str, Tuple], float] = defaultdict(float)

NS = "volcano"

E2E_SCHEDULING_LATENCY = f"{NS}_e2e_scheduling_latency_milliseconds"
E2E_JOB_SCHEDULING_LATENCY = f"{NS}_e2e_job_scheduling_latency_milliseconds"
PLUGIN_LATENCY = f"{NS}_plugin_scheduling_latency_microseconds"
ACTION_LATENCY = f"{NS}_action_scheduling_latency_microseconds"
TASK_LATENCY = f"{NS}_task_scheduling_latency_milliseconds"
SCHEDULE_ATTEMPTS = f"{NS}_schedule_attempts_total"
PREEMPTION_VICTIMS = f"{NS}_pod_preemption_victims"
PREEMPTION_ATTEMPTS = f"{NS}_total_preemption_attempts"
UNSCHEDULE_TASK_COUNT = f"{NS}_unschedule_task_count"
UNSCHEDULE_JOB_COUNT = f"{NS}_unschedule_job_count"
QUEUE_ALLOCATED = f"{NS}_queue_allocated_milli_cpu"
QUEUE_DESERVED = f"{NS}_queue_deserved_milli_cpu"
QUEUE_SHARE = f"{NS}_queue_share"
QUEUE_WEIGHT = f"{NS}_queue_weight"
NAMESPACE_SHARE = f"{NS}_namespace_share"
NAMESPACE_WEIGHT = f"{NS}_namespace_weight"
SOLVER_KERNEL_LATENCY = f"{NS}_tpu_solver_kernel_latency_milliseconds"
UNSCHEDULABLE_REASON = f"{NS}_unschedulable_reason_total"
# bind-flush pipeline (docs/design/bind_pipeline.md): wall latency of one
# coalesced drain (apply + store write + echo ingest), binds it carried,
# and the shard fan-out of each sharded store commit
BIND_FLUSH_LATENCY = f"{NS}_bind_flush_latency_milliseconds"
BIND_FLUSH_BINDS = f"{NS}_bind_flush_binds_total"
STORE_PATCH_SHARDS = f"{NS}_store_patch_shards"
# the flush_wall residue (docs/design/bind_pipeline.md): the two
# non-bind executor tasks the post-cycle drain also waits on — the
# session's PodGroup status writeback and the inter-cycle snapshot
# prebuild — split into their own budget lines so the commit-path tail
# stays attributable at the 10x shape
STATUS_WRITEBACK_LATENCY = f"{NS}_status_writeback_latency_milliseconds"
SNAPSHOT_PREBUILD_LATENCY = f"{NS}_snapshot_prebuild_latency_milliseconds"
# commit-path resilience (docs/design/resilience.md): bind failures by
# reason, resync retry volume, pods quarantined after budget exhaustion,
# gang-atomic heal events, the cycle watchdog, and the solver kernel
# circuit breaker's fallback transitions / open state
BIND_ERRORS = f"{NS}_bind_errors_total"
RESYNC_RETRIES = f"{NS}_resync_retries_total"
QUARANTINED_TASKS = f"{NS}_quarantined_tasks"
GANG_HEALS = f"{NS}_gang_heal_total"
CYCLE_DEADLINE_EXCEEDED = f"{NS}_cycle_deadline_exceeded_total"
SOLVER_FALLBACK = f"{NS}_solver_fallback_total"
SOLVER_BREAKER_OPEN = f"{NS}_solver_breaker_open"
# which route ran each placement launch: in this port "cuda" (the hand
# kernel, csrc/gang_allocate.cu) or "plain" (the plain loop on the CPU);
# the JAX package labels its tiers (sharded / pallas / native / chunked /
# scan) here
SOLVER_KERNEL_RUNS = f"{NS}_solver_kernel_runs_total"
# control-plane failover (docs/design/failover.md): writes rejected for a
# superseded fencing token, cache-vs-store anti-entropy divergences by
# kind, remote-store transient write retries, and watch-stream restarts
FENCED_WRITES = f"{NS}_fenced_writes_total"
CACHE_DIVERGENCE = f"{NS}_cache_divergence_total"
STORE_WRITE_RETRIES = f"{NS}_store_write_retries_total"
WATCH_RESTARTS = f"{NS}_watch_restarts_total"
# pod lifecycle telemetry (docs/design/observability.md): end-to-end
# submission->echo-confirmed latency per queue and per-hop latency of the
# ledger's transition chain (trace/ledger.py), observed at completion
POD_E2E_LATENCY = f"{NS}_pod_e2e_latency_milliseconds"
POD_HOP_LATENCY = f"{NS}_pod_hop_latency_milliseconds"
# solver & backend profiling hooks: placement-kernel dispatches by
# compile-cache outcome (result="hit"|"miss"), recompiles forced by a NEW
# padded-shape bucket of an already-seen kernel (the shape-churn signal),
# host->device bytes staged as kernel inputs, and backend-init probe
# verdicts (outcome="alive"|"dead"|"hang")
SOLVER_COMPILE_CACHE = f"{NS}_solver_compile_cache_total"
SOLVER_SHAPE_RECOMPILES = f"{NS}_solver_padded_shape_recompile_total"
DEVICE_TRANSFER_BYTES = f"{NS}_solver_device_transfer_bytes_total"
BACKEND_PROBE = f"{NS}_backend_probe_total"
# incremental steady-state cycle (docs/design/incremental_cycle.md):
# snapshots by mode (mode="full"|"incremental"), the dirty-set sizes the
# last snapshot consumed (kind="jobs"|"nodes"), and the solver's
# persistent device-resident node buffers (event="reuse"|"rebuild")
CYCLE_MODE = f"{NS}_cycle_mode_total"
DIRTY_SET_SIZE = f"{NS}_dirty_set_size"
SOLVER_DEVICE_BUFFER = f"{NS}_solver_device_buffer_total"
# constraint compilation (docs/design/constraints.md): per-pass build
# latency, node rows refreshed by the persistent-state sync
# (event="refresh"), compile crashes that fell back to the per-task
# Python reference, and victim-selection kernel engagements
# (mode="kernel"|"python")
CONSTRAINT_BUILD_LATENCY = f"{NS}_constraint_build_latency_milliseconds"
CONSTRAINT_BUILD_RUNS = f"{NS}_constraint_build_runs_total"
CONSTRAINT_ROWS = f"{NS}_constraint_rows_total"
CONSTRAINT_FALLBACK = f"{NS}_constraint_fallback_total"
VICTIM_SELECT_RUNS = f"{NS}_victim_select_runs_total"
VICTIM_SELECT_LATENCY = f"{NS}_victim_select_latency_milliseconds"
# multi-tenant serving hub (docs/design/serving.md): per-frame fan-out
# latency, coalesced frame/event volumes (their ratio is the coalescing
# proof), structured cursor relists pushed by the hub, per-tenant
# admission verdicts at the write/watch edge, per-shard outbox depth,
# and the RemoteStore's explicit cursor-gap relists (the client half of
# the structured "gone" contract)
SERVING_FANOUT_LATENCY = f"{NS}_serving_fanout_latency_milliseconds"
SERVING_BATCHES = f"{NS}_serving_batches_total"
SERVING_EVENTS = f"{NS}_serving_events_total"
SERVING_RELISTS = f"{NS}_serving_relists_total"
SERVING_ADMITTED = f"{NS}_serving_admitted_total"
SERVING_THROTTLED = f"{NS}_serving_throttled_total"
SERVING_SHARD_DEPTH = f"{NS}_serving_hub_shard_depth"
SERVING_SHARD_BACKPRESSURE = f"{NS}_serving_hub_shard_backpressure"
WATCH_RELISTS = f"{NS}_watch_relists_total"
# placement explainer + pruning-readiness surface (docs/design/
# observability.md): per-gang feasible-node-count and top-k
# score-mass-coverage histograms (labeled k=<shortlist width>) — the
# baseline the candidate-pruning ROADMAP item shortlists against —
# plus the fleet fragmentation gauge (largest schedulable uniform-gang
# vs total free capacity, the Tesserae defrag pre-metric), per-shard
# occupancy/pressure gauges off the ShardPlan, and padded-vs-live
# waste ratios per kernel axis
GANG_FEASIBLE_NODES = f"{NS}_gang_feasible_nodes"
TOPK_SCORE_COVERAGE = f"{NS}_topk_score_coverage"
FRAGMENTATION_RATIO = f"{NS}_fragmentation_ratio"
SHARD_OCCUPANCY = f"{NS}_shard_occupancy"
SHARD_PRESSURE = f"{NS}_shard_pressure"
SHARD_PRESSURE_IMBALANCE = f"{NS}_shard_pressure_imbalance"
PADDED_WASTE = f"{NS}_padded_waste_ratio"
# candidate pruning + two-level placement (docs/design/pruning.md):
# place() calls served by the reduced shortlist kernel
# (level="single"|"two_level"), fallbacks to the full-width kernel by
# reason (reason="low_coverage"|"shortlist_exhausted"|"wide_union"|
# "empty_union"|"crash" — the loss-guard contract: pruning never loses
# a placement the dense kernel would have made), and the width of the
# last reduced node axis (the union of every gang's shortlist)
PRUNE_RUNS = f"{NS}_prune_runs_total"
PRUNE_FALLBACK = f"{NS}_prune_fallback_total"
PRUNE_UNION_WIDTH = f"{NS}_prune_union_width"
# federated control plane (docs/design/federation.md): journal frames /
# events replicated leader->follower, contiguity gaps detected at the
# follower (each one triggers a structured catch-up), snapshot
# bootstraps, frames REJECTED because they carried a stale leader epoch
# (the fencing-token contract — a deposed leader cannot ship history),
# per-follower replication lag in rvs, cursor handoffs served by a peer
# replica's hub after failover, and cross-replica anti-entropy
# fingerprint audits by verdict (verdict="identical"|"divergent")
REPLICATION_FRAMES = f"{NS}_replication_frames_total"
REPLICATION_EVENTS = f"{NS}_replication_events_total"
REPLICATION_GAPS = f"{NS}_replication_gaps_total"
REPLICATION_SNAPSHOTS = f"{NS}_replication_snapshots_total"
REPLICATION_FENCED = f"{NS}_replication_fenced_frames_total"
REPLICATION_LAG = f"{NS}_replication_follower_lag_rvs"
REPLICATION_HANDOFFS = f"{NS}_replication_cursor_handoffs_total"
REPLICATION_AUDITS = f"{NS}_replication_fingerprint_audits_total"

# write-ahead-log durability (docs/design/durability.md):
# append batches accepted from the store's journal hook, framed records
# and journal entries written, group-commit fsyncs + their latency, the
# durable rv watermark (everything at or below survived a crash), the
# read-only degradation gauge (1 while ENOSPC/EIO has the write path
# returning structured 503s), live segment count, snapshot-anchored
# compactions, recoveries replayed at startup, and torn final records
# truncated by recovery (expected after a mid-flush crash; anything
# further in is corruption and refuses to load)
WAL_APPENDS = f"{NS}_wal_appends_total"
WAL_RECORDS = f"{NS}_wal_records_total"
WAL_ENTRIES = f"{NS}_wal_entries_total"
WAL_FSYNCS = f"{NS}_wal_fsyncs_total"
WAL_FSYNC_MS = f"{NS}_wal_fsync_latency_milliseconds"
WAL_DURABLE_RV = f"{NS}_wal_durable_rv"
WAL_READ_ONLY = f"{NS}_wal_read_only"
WAL_SEGMENTS = f"{NS}_wal_segments"
WAL_COMPACTIONS = f"{NS}_wal_compactions_total"
WAL_RECOVERIES = f"{NS}_wal_recoveries_total"
WAL_TORN_TRUNCATIONS = f"{NS}_wal_torn_truncations_total"

# component health registry behind /debug/health: a component absent from
# the registry is healthy by default; the watchdog (scheduler.py) flips
# "scheduler" on a cycle-deadline breach and back on recovery
_health: Dict[str, Tuple[bool, str]] = {}


def set_health(component: str, healthy: bool, detail: str = ""):
    with _lock:
        _health[component] = (bool(healthy), detail)


def health_report() -> dict:
    """{"healthy": bool, "degraded": [component], "components": {...}} —
    the /debug/health payload (non-healthy renders as HTTP 503)."""
    with _lock:
        comps = {name: {"healthy": ok, "detail": detail}
                 for name, (ok, detail) in _health.items()}
    return {
        "healthy": all(c["healthy"] for c in comps.values()),
        "degraded": sorted(n for n, c in comps.items() if not c["healthy"]),
        "components": comps,
    }


def observe(name: str, value: float, **labels):
    with _lock:
        _histograms[(name, tuple(sorted(labels.items())))].observe(value)


def observe_bulk(name: str, values, **labels):
    """Observe a whole batch under ONE lock pass — the pod lifecycle
    ledger exports per-hop latencies for 50k-bind flush deliveries, and
    per-value locking would put ~300k lock acquisitions on the flush
    executor. Buckets resolve by bisect instead of the per-value bound
    scan (same first-bound->=value semantics), and the running total
    accumulates in the same per-value order as repeated observe()."""
    from bisect import bisect_left
    key = (name, tuple(sorted(labels.items())))
    with _lock:
        h = _histograms[key]
        bounds = h.BOUNDS
        buckets = h.buckets
        nb = len(bounds)
        h.count += len(values)
        total = h.total
        for v in values:
            total += v
            i = bisect_left(bounds, v)
            buckets[i if i < nb else -1] += 1
        h.total = total


def set_gauge(name: str, value: float, **labels):
    # single-label fast path: one-item tuples need no sort (the gauge
    # sweeps at session close set ~3 per job)
    items = tuple(labels.items())
    if len(items) > 1:
        items = tuple(sorted(items))
    with _lock:
        _gauges[(name, items)] = value


def inc(name: str, value: float = 1.0, **labels):
    with _lock:
        _counters[(name, tuple(sorted(labels.items())))] += value


def counter_total(name: str, **labels) -> float:
    """Current value of a counter series (exact labels), or the sum over
    every series of ``name`` when no labels are given — the read half
    the smoke gates use to assert a path actually ran."""
    with _lock:
        if labels:
            return _counters.get((name, tuple(sorted(labels.items()))), 0.0)
        return sum(v for (n, _), v in _counters.items() if n == name)


def histogram_total(name: str) -> float:
    """Summed observation total over every series of a histogram — the
    bench workers' delta reads (kernel/flush/constraint-build latency)."""
    with _lock:
        return sum(h.total for (n, _), h in _histograms.items()
                   if n == name)


@contextmanager
def plugin_timer(plugin: str, phase: str):
    start = time.perf_counter()
    try:
        yield
    finally:
        observe(PLUGIN_LATENCY, (time.perf_counter() - start) * 1e6,
                plugin=plugin, OnSession=phase)


@contextmanager
def action_timer(action: str):
    start = time.perf_counter()
    try:
        yield
    finally:
        observe(ACTION_LATENCY, (time.perf_counter() - start) * 1e6,
                action=action)


def update_e2e_duration(seconds: float):
    observe(E2E_SCHEDULING_LATENCY, seconds * 1000.0)


def update_unschedulable_task_count(job: str, count: int):
    set_gauge(UNSCHEDULE_TASK_COUNT, count, job=job)


def register_schedule_attempt(result: str):
    inc(SCHEDULE_ATTEMPTS, result=result)


def update_queue_allocated(queue: str, milli_cpu: float, memory: float):
    set_gauge(QUEUE_ALLOCATED, milli_cpu, queue_name=queue)
    set_gauge(f"{NS}_queue_allocated_memory_bytes", memory, queue_name=queue)


def update_queue_request(queue: str, milli_cpu: float, memory: float):
    set_gauge(f"{NS}_queue_request_milli_cpu", milli_cpu, queue_name=queue)
    set_gauge(f"{NS}_queue_request_memory_bytes", memory, queue_name=queue)


def update_queue_deserved(queue: str, milli_cpu: float, memory: float):
    set_gauge(QUEUE_DESERVED, milli_cpu, queue_name=queue)
    set_gauge(f"{NS}_queue_deserved_memory_bytes", memory, queue_name=queue)


def update_queue_share(queue: str, share: float):
    set_gauge(QUEUE_SHARE, share, queue_name=queue)


def update_queue_weight(queue: str, weight: int):
    set_gauge(QUEUE_WEIGHT, weight, queue_name=queue)


def update_queue_overused(queue: str, overused: bool):
    set_gauge(f"{NS}_queue_overused", 1.0 if overused else 0.0,
              queue_name=queue)


def update_namespace_share(namespace: str, share: float):
    set_gauge(NAMESPACE_SHARE, share, namespace=namespace)


def update_namespace_weight(namespace: str, weight: int):
    set_gauge(NAMESPACE_WEIGHT, weight, namespace=namespace)


def update_namespace_weighted_share(namespace: str, share: float):
    set_gauge(f"{NS}_namespace_weighted_share", share, namespace=namespace)


def update_job_share(namespace: str, job: str, share: float):
    set_gauge(f"{NS}_job_share", share, job_ns=namespace, job_id=job)


def update_preemption_victims(count: int):
    set_gauge(PREEMPTION_VICTIMS, count)


def register_preemption_attempt():
    inc(PREEMPTION_ATTEMPTS)


def reset():
    with _lock:
        _histograms.clear()
        _gauges.clear()
        _counters.clear()
        _health.clear()


def snapshot() -> dict:
    """Structured dump for tests and the /metrics endpoint."""
    with _lock:
        return {
            "histograms": {k: (h.count, h.total) for k, h in _histograms.items()},
            "gauges": dict(_gauges),
            "counters": dict(_counters),
        }


def collect(counter_names, gauge_names, hist_names) -> tuple:
    """Whitelist extraction in ONE locked pass with no registry copies:
    ``({counter: sum}, {gauge: sum}, {hist: (count, sum)})`` summed over
    label sets. The per-cycle timeseries sampler calls this on the hot
    path — ``snapshot()``'s three full dict copies per cycle measurably
    dented the <2% tracer-overhead budget at micro scale."""
    cset, gset, hset = set(counter_names), set(gauge_names), set(hist_names)
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, tuple] = {}
    with _lock:
        for (n, _), v in _counters.items():
            if n in cset:
                counters[n] = counters.get(n, 0.0) + v
        for (n, _), v in _gauges.items():
            if n in gset:
                gauges[n] = gauges.get(n, 0.0) + v
        for (n, _), h in _histograms.items():
            if n in hset:
                c, s = hists.get(n, (0.0, 0.0))
                hists[n] = (c + h.count, s + h.total)
    return counters, gauges, hists


def _escape_label_value(v) -> str:
    """Prometheus text format: backslash, double-quote and newline must
    be escaped inside label values (exposition_formats.md)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def render_prometheus() -> str:
    """Text exposition format, with full histogram exposition:
    cumulative ``_bucket{le="..."}`` lines per _Hist.BOUNDS bound plus
    ``le="+Inf"``, then ``_count``/``_sum``."""
    lines: List[str] = []

    def fmt_labels(labels: Tuple) -> str:
        if not labels:
            return ""
        inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                         for k, v in labels)
        return "{" + inner + "}"

    with _lock:
        for (name, labels), h in _histograms.items():
            cum = 0
            for bound, n in zip(h.BOUNDS, h.buckets):
                cum += n
                le = fmt_labels(labels + (("le", f"{bound:g}"),))
                lines.append(f"{name}_bucket{le} {cum}")
            le = fmt_labels(labels + (("le", "+Inf"),))
            lines.append(f"{name}_bucket{le} {h.count}")
            lines.append(f"{name}_count{fmt_labels(labels)} {h.count}")
            lines.append(f"{name}_sum{fmt_labels(labels)} {h.total}")
        for (name, labels), v in _gauges.items():
            lines.append(f"{name}{fmt_labels(labels)} {v}")
        for (name, labels), v in _counters.items():
            lines.append(f"{name}{fmt_labels(labels)} {v}")
    return "\n".join(lines) + "\n"
