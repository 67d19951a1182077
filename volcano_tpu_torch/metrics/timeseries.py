"""Metrics time-series ring: the last N cycles of key gauges/counters
(this port's own copy of volcano_tpu/metrics/timeseries.py).

``/metrics`` answers "what is the value now"; a hung cycle, a bind-error
burst or a fenced-write spike is only diagnosable from the SHAPE of the
last few minutes. ``sample()`` — called once per scheduling cycle from
``Scheduler.run_once`` while tracing is enabled — snapshots a fixed
whitelist of counters/gauges plus caller-supplied extras (cycle wall
time, cycle seq) into a bounded ring served at ``/debug/timeseries``,
written into sim repro bundles (``timeseries.json``) and attached to
``bench.py``'s JSON row.

Sizing: ``CAPACITY`` = 512 samples. At the production 1 s schedule
period that is ~8.5 minutes of history; one sample is a flat dict of a
dozen floats (~300 B), so the ring tops out around 150 KB — cheap
enough to leave on. Timestamps come from the caller's clock (virtual
under the sim), but wall-time extras (cycle_ms) make the ring itself
excluded from the sim's bit-identical fingerprints by design.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

from . import metrics as m

CAPACITY = 512

_lock = threading.Lock()
_ring: deque = deque(maxlen=CAPACITY)

# counters sampled by name (summed over label sets) — the signals every
# open ROADMAP item is gated on
COUNTER_KEYS = (
    m.SCHEDULE_ATTEMPTS,
    m.BIND_FLUSH_BINDS,
    m.BIND_ERRORS,
    m.RESYNC_RETRIES,
    m.GANG_HEALS,
    m.FENCED_WRITES,
    m.CACHE_DIVERGENCE,
    m.WATCH_RESTARTS,
    m.UNSCHEDULABLE_REASON,
    m.SOLVER_FALLBACK,
    m.SOLVER_SHAPE_RECOMPILES,
    m.DEVICE_TRANSFER_BYTES,
)
GAUGE_KEYS = (m.QUARANTINED_TASKS,)
# histograms sampled as (count, sum) pairs
HIST_KEYS = (m.E2E_SCHEDULING_LATENCY, m.POD_E2E_LATENCY,
             m.BIND_FLUSH_LATENCY, m.SOLVER_KERNEL_LATENCY)


def configure(capacity: int) -> None:
    global _ring
    capacity = max(1, int(capacity))
    with _lock:
        if _ring.maxlen != capacity:
            _ring = deque(_ring, maxlen=capacity)


def reset() -> None:
    with _lock:
        _ring.clear()


def sample(now: float, extra: Optional[Dict] = None) -> dict:
    """Capture one per-cycle sample into the ring and return it. Uses
    ``metrics.collect`` — one locked registry pass, no copies — because
    this runs on the cycle hot path whenever tracing is on."""
    counters, gauges, hists = m.collect(COUNTER_KEYS, GAUGE_KEYS,
                                        HIST_KEYS)
    row: Dict[str, float] = {"t": round(now, 6)}
    for name, total in counters.items():
        if total:
            row[name] = round(total, 3)
    for name, total in gauges.items():
        if total:
            row[name] = round(total, 3)
    for name, (count, total) in hists.items():
        if count:
            row[f"{name}_count"] = count
            row[f"{name}_sum"] = round(total, 3)
    if extra:
        row.update(extra)
    with _lock:
        _ring.append(row)
    return row


def series(limit: Optional[int] = None) -> list:
    """Ring contents, oldest first (``limit`` keeps only the newest N)."""
    with _lock:
        rows = list(_ring)
    return rows[-limit:] if limit else rows
