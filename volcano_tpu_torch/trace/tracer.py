"""Cycle flight recorder: nested span tracing for the scheduling cycle
(this port's own copy of volcano_tpu/trace/tracer.py).

Every scheduling cycle is recorded as a tree of spans — cycle →
open_session → snapshot → plugin opens → each action → solver context
build → kernel invocation → stage/finalize → close_session — with wall
time, counts (tasks considered, binds, victims) and outcome tags. The
last N cycles live in a ring buffer (default 64) and export as Chrome
trace-event JSON (chrome://tracing / Perfetto) or as compact per-cycle
summaries; the metrics server surfaces both under ``/debug/*``.

Designed to be LEFT ON in production: when disabled every ``span()``
call is one module-global check returning a shared null context; when
enabled a cycle creates a few dozen span objects (never one per task),
targeting <2% overhead on the steady-state cycle
(tests/test_trace.py::test_tracer_overhead).

Thread model: spans nest per-thread (the cycle runs on one thread); a
``span()`` on a thread with no open cycle is a no-op. Executor threads
record into the flight recorder through ``async_span`` (the bind flush),
which tags its spans with the cycle sequence they follow.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

_perf = time.perf_counter

DEFAULT_CAPACITY = 64

_enabled = False
_lock = threading.Lock()
_ring: deque = deque(maxlen=DEFAULT_CAPACITY)
# spans from executor threads (bind flush), bucketed by the cycle seq
# they follow so per-cycle lookup is O(1); bounded independently of the
# ring (total spans, oldest cycle evicted first) so a burst can't grow
# it without limit
_async: Dict[int, List["Span"]] = {}
_async_count = 0
_ASYNC_SPAN_CAP = 4096
_seq = 0            # sequence of the cycle currently (or last) recording
_tls = threading.local()

# per-phase wall budgets in ms (docs/design/perf.md's budget rows); a
# cycle whose phase exceeds its budget is flagged in the summary and
# counted in volcano_trace_phase_over_budget_total
_budgets: Dict[str, float] = {}
DEFAULT_BUDGETS = {"cycle": 1000.0}

# latest "why pending" diagnosis (trace/pending.py), refreshed each
# cycle at session close while tracing is enabled
_pending_report: Optional[dict] = None

# root span of the cycle currently in flight (None between cycles) —
# read cross-thread by the cycle watchdog via live_phases()
_live_cycle: Optional["Span"] = None


class Span:
    __slots__ = ("name", "t0", "dur", "tags", "children")

    def __init__(self, name: str, t0: float):
        self.name = name
        self.t0 = t0
        self.dur = 0.0
        self.tags: Optional[dict] = None
        self.children: Optional[list] = None


class CycleRecord:
    __slots__ = ("seq", "wall_time", "root")

    def __init__(self, seq: int, wall_time: float, root: Span):
        self.seq = seq
        self.wall_time = wall_time
        self.root = root


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class _SpanCtx:
    __slots__ = ("_span", "_stack")

    def __init__(self, span: Span, stack: list):
        self._span = span
        self._stack = stack

    def __enter__(self):
        return self._span

    def __exit__(self, *exc):
        s = self._span
        s.dur = _perf() - s.t0
        st = self._stack
        if st and st[-1] is s:
            st.pop()
        return False


class _CycleCtx:
    __slots__ = ("_root", "_seq")

    def __init__(self, root: Span, seq: int):
        self._root = root
        self._seq = seq

    def __enter__(self):
        return self._root

    def __exit__(self, *exc):
        global _live_cycle
        root = self._root
        root.dur = _perf() - root.t0
        _tls.stack = None
        if _live_cycle is root:
            _live_cycle = None
        _finish_cycle(root, self._seq)
        return False


class _AsyncCtx:
    __slots__ = ("_span", "_seq")

    def __init__(self, span: Span, seq: int):
        self._span = span
        self._seq = seq

    def __enter__(self):
        return self._span

    def __exit__(self, *exc):
        s = self._span
        s.dur = _perf() - s.t0
        _tls.astack = None
        global _async_count
        with _lock:
            _async.setdefault(self._seq, []).append(s)
            _async_count += 1
            while _async_count > _ASYNC_SPAN_CAP and len(_async) > 1:
                _async_count -= len(_async.pop(next(iter(_async))))
        return False


class _AsyncChildCtx:
    """A nested async span: child of the thread's innermost open async
    span (NOT a new _async root — flush-wide aggregates like summary()'s
    bind_flush_ms sum roots only, so sub-phases never double-count)."""

    __slots__ = ("_span", "_stack")

    def __init__(self, span: Span, stack: list):
        self._span = span
        self._stack = stack

    def __enter__(self):
        return self._span

    def __exit__(self, *exc):
        s = self._span
        s.dur = _perf() - s.t0
        st = self._stack
        if st and st[-1] is s:
            st.pop()
        return False


# -- control ----------------------------------------------------------------


def enable(capacity: Optional[int] = None) -> None:
    """Turn the flight recorder on (idempotent). The pod lifecycle
    ledger (trace/ledger.py) rides the same switch: one production
    toggle covers both, and the <2% overhead gate measures both."""
    global _enabled
    if capacity is not None:
        configure(capacity=capacity)
    _enabled = True
    from . import ledger
    ledger.enable()


def disable() -> None:
    global _enabled
    _enabled = False
    _tls.stack = None
    _tls.astack = None
    from . import ledger
    ledger.disable()


def is_enabled() -> bool:
    return _enabled


def configure(capacity: int) -> None:
    """Resize the ring buffer, keeping the newest records."""
    global _ring
    capacity = max(1, int(capacity))
    with _lock:
        if _ring.maxlen != capacity:
            _ring = deque(_ring, maxlen=capacity)


def reset() -> None:
    """Drop all recorded cycles (tests)."""
    global _pending_report, _async_count
    with _lock:
        _ring.clear()
        _async.clear()
        _async_count = 0
    _pending_report = None
    _tls.stack = None
    _tls.astack = None


def set_budgets(budgets: Dict[str, float]) -> None:
    """Replace the per-phase wall budgets ({span name: ms})."""
    global _budgets
    _budgets = dict(budgets)


def budgets() -> Dict[str, float]:
    return dict(_budgets)


def env_capacity() -> Optional[int]:
    """VOLCANO_TRACE_CAPACITY as an int, or None when unset or malformed
    (a bad value for an optional diagnostics knob must not kill the
    scheduler at startup)."""
    cap = os.environ.get("VOLCANO_TRACE_CAPACITY")
    if not cap:
        return None
    try:
        return int(cap)
    except ValueError:
        import logging
        logging.getLogger(__name__).warning(
            "ignoring malformed VOLCANO_TRACE_CAPACITY=%r", cap)
        return None


def enable_from_env() -> bool:
    """Honor VOLCANO_TRACE / VOLCANO_TRACE_CAPACITY (entry points call
    this once at startup); returns whether tracing ended up enabled."""
    if os.environ.get("VOLCANO_TRACE", "").lower() in ("1", "true", "yes"):
        enable(capacity=env_capacity())
    return _enabled


# -- recording --------------------------------------------------------------


def cycle(**tags):
    """Open the root span of one scheduling cycle on this thread."""
    global _seq, _live_cycle
    if not _enabled:
        return _NULL
    root = Span("cycle", _perf())
    if tags:
        root.tags = tags
    with _lock:
        _seq += 1
        seq = _seq
    _tls.stack = [root]
    _live_cycle = root
    return _CycleCtx(root, seq)


def span(name: str, **tags):
    """A nested span under the innermost open span of this thread's
    cycle; a no-op context when tracing is off or no cycle is open."""
    if not _enabled:
        return _NULL
    stack = getattr(_tls, "stack", None)
    if not stack:
        return _NULL
    s = Span(name, _perf())
    if tags:
        s.tags = tags
    parent = stack[-1]
    if parent.children is None:
        parent.children = []
    parent.children.append(s)
    stack.append(s)
    return _SpanCtx(s, stack)


def add_tags(**tags) -> None:
    """Merge tags into the innermost open span (for counts known only
    mid-span: tasks considered, binds, victims)."""
    if not _enabled:
        return
    stack = getattr(_tls, "stack", None)
    if not stack:
        return
    s = stack[-1]
    if s.tags is None:
        s.tags = tags
    else:
        s.tags.update(tags)


def tag_span(span: Optional["Span"], **tags) -> None:
    """Merge tags into a given span, open or closed: the device time of an
    asynchronous launch is known only at a later synchronisation, after
    its span has closed. ``span`` None (tracing off) is a no-op."""
    if span is None:
        return
    if span.tags is None:
        span.tags = tags
    else:
        span.tags.update(tags)


def tag_cycle(**tags) -> None:
    """Merge tags into the cycle's root span from anywhere inside it."""
    if not _enabled:
        return
    stack = getattr(_tls, "stack", None)
    if not stack:
        return
    root = stack[0]
    if root.tags is None:
        root.tags = tags
    else:
        root.tags.update(tags)


def async_span(name: str, **tags):
    """A span recorded from a non-cycle thread (the bind-flush executor),
    attached to the newest cycle's sequence number. Nests per-thread: an
    async_span opened inside another (the flush's store pass opening its
    echo-ingest sub-phase) becomes a CHILD of the open one rather than a
    second root, so per-cycle flush totals never double-count."""
    if not _enabled:
        return _NULL
    s = Span(name, _perf())
    if tags:
        s.tags = tags
    stack = getattr(_tls, "astack", None)
    if stack:
        parent = stack[-1]
        if parent.children is None:
            parent.children = []
        parent.children.append(s)
        stack.append(s)
        return _AsyncChildCtx(s, stack)
    _tls.astack = [s]
    return _AsyncCtx(s, _seq)


def _finish_cycle(root: Span, seq: int) -> None:
    rec = CycleRecord(seq, time.time(), root)
    with _lock:
        _ring.append(rec)
    budget = _budgets or DEFAULT_BUDGETS
    if budget:
        over = _over_budget(rec, budget)
        if over:
            from ..metrics import metrics as m
            for phase in over:
                m.inc(f"{m.NS}_trace_phase_over_budget_total", phase=phase)


def current_seq() -> int:
    """Sequence number of the cycle currently (or last) recording —
    joinable against /debug/trace?seq= and /debug/cycles entries."""
    return _seq


def live_phases() -> Dict[str, dict]:
    """Phase breakdown of the cycle currently IN FLIGHT — the cycle
    watchdog's view of a stuck ``run_once`` (a completed cycle's record
    comes from the ring buffer instead). Top-level child spans of the
    live root, name -> {ms, count, open}; an open span (dur not yet
    written) reports its elapsed wall time so far. Reads deliberately
    race the recording thread: children lists are append-only and spans
    are never removed, so a snapshot is always structurally sound —
    durations of spans closing mid-read may be a frame stale."""
    root = _live_cycle
    if root is None:
        return {}
    now = _perf()
    out: Dict[str, dict] = {}
    total = now - root.t0
    for s in list(root.children or ()):
        is_open = s.dur == 0.0
        ms = ((now - s.t0) if is_open else s.dur) * 1000.0
        ent = out.setdefault(s.name, {"ms": 0.0, "count": 0, "open": False})
        ent["ms"] = round(ent["ms"] + ms, 3)
        ent["count"] += 1
        ent["open"] = ent["open"] or is_open
    out["cycle"] = {"ms": round(total * 1000.0, 3), "count": 1,
                    "open": True}
    return out


def set_pending_report(report: Optional[dict]) -> None:
    global _pending_report
    _pending_report = report


def pending_report() -> Optional[dict]:
    return _pending_report


# -- reading ----------------------------------------------------------------


def records() -> List[CycleRecord]:
    """Snapshot of the ring buffer, oldest first."""
    with _lock:
        return list(_ring)


def last_record() -> Optional[CycleRecord]:
    with _lock:
        return _ring[-1] if _ring else None


def get_record(seq: int) -> Optional[CycleRecord]:
    with _lock:
        for rec in _ring:
            if rec.seq == seq:
                return rec
    return None


def _async_spans_for(seq: int) -> List[Span]:
    with _lock:
        return list(_async.get(seq, ()))


# -- exports ----------------------------------------------------------------


def chrome_trace(rec: CycleRecord) -> dict:
    """Chrome trace-event JSON (load in chrome://tracing or Perfetto):
    complete ('X') events, ts/dur in microseconds relative to cycle
    start; the async bind-flush spans ride a second tid."""
    events: List[dict] = []
    base = rec.root.t0

    def emit(s: Span, tid: int) -> None:
        ev = {"name": s.name, "ph": "X", "pid": 1, "tid": tid,
              "ts": round((s.t0 - base) * 1e6, 3),
              "dur": round(s.dur * 1e6, 3)}
        if s.tags:
            ev["args"] = dict(s.tags)
        events.append(ev)
        for c in s.children or ():
            emit(c, tid)

    emit(rec.root, 1)
    for s in _async_spans_for(rec.seq):
        emit(s, 2)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"cycle_seq": rec.seq, "wall_time": rec.wall_time}}


def flat_phases(rec: CycleRecord) -> Dict[str, dict]:
    """'/'-joined span paths -> {ms, count}, aggregated over the tree
    (the per-phase breakdown behind bench.py --trace and the phase-timer
    table)."""
    out: Dict[str, dict] = {}

    def walk(s: Span, prefix: str) -> None:
        path = f"{prefix}/{s.name}" if prefix else s.name
        e = out.get(path)
        if e is None:
            out[path] = e = {"ms": 0.0, "count": 0}
        e["ms"] += s.dur * 1000.0
        e["count"] += 1
        for c in s.children or ():
            walk(c, path)

    for c in rec.root.children or ():
        walk(c, "")
    for e in out.values():
        e["ms"] = round(e["ms"], 3)
    return out


def async_phases(rec: CycleRecord) -> Dict[str, dict]:
    """'/'-joined span paths -> {ms, count} over the cycle's ASYNC spans
    (the bind flush that follows it): the flat_phases twin for the
    executor side, behind bench.py's flush sub-phase attribution
    (bind_flush.apply / bind_flush.store / bind_flush.store/bind_flush.echo)."""
    out: Dict[str, dict] = {}

    def walk(s: Span, prefix: str) -> None:
        path = f"{prefix}/{s.name}" if prefix else s.name
        e = out.get(path)
        if e is None:
            out[path] = e = {"ms": 0.0, "count": 0}
        e["ms"] += s.dur * 1000.0
        e["count"] += 1
        for c in s.children or ():
            walk(c, path)

    for s in _async_spans_for(rec.seq):
        walk(s, "")
    for e in out.values():
        e["ms"] = round(e["ms"], 3)
    return out


def _span_count(s: Span) -> int:
    return 1 + sum(_span_count(c) for c in s.children or ())


def _over_budget(rec: CycleRecord, budget: Dict[str, float]) -> List[str]:
    over = []
    cycle_budget = budget.get("cycle")
    if cycle_budget is not None and rec.root.dur * 1000.0 > cycle_budget:
        over.append("cycle")

    def walk(s: Span) -> None:
        b = budget.get(s.name)
        if b is not None and s.dur * 1000.0 > b:
            over.append(s.name)
        for c in s.children or ():
            walk(c)

    for c in rec.root.children or ():
        walk(c)
    return over


def summary(rec: CycleRecord) -> dict:
    """Compact per-cycle record for /debug/cycles: wall time, top-level
    phase breakdown, attribution coverage, tags, budget verdicts."""
    cycle_ms = rec.root.dur * 1000.0
    phases: Dict[str, dict] = {}
    covered = 0.0
    for c in rec.root.children or ():
        e = phases.get(c.name)
        if e is None:
            phases[c.name] = e = {"ms": 0.0, "count": 0}
        e["ms"] += c.dur * 1000.0
        e["count"] += 1
        covered += c.dur * 1000.0
    for e in phases.values():
        e["ms"] = round(e["ms"], 3)
    budget = _budgets or DEFAULT_BUDGETS
    flush_ms = sum(s.dur for s in _async_spans_for(rec.seq)) * 1000.0
    out = {"seq": rec.seq, "wall_time": rec.wall_time,
           "cycle_ms": round(cycle_ms, 3),
           "covered_ms": round(covered, 3),
           "coverage": round(covered / cycle_ms, 4) if cycle_ms > 0 else 1.0,
           "spans": _span_count(rec.root),
           "phases": phases,
           "tags": dict(rec.root.tags) if rec.root.tags else {},
           "over_budget": _over_budget(rec, budget)}
    if flush_ms:
        out["bind_flush_ms"] = round(flush_ms, 3)
    return out


def validate_chrome_trace(obj: dict) -> None:
    """Assert ``obj`` is a well-formed Chrome trace-event export of one
    cycle (the span schema behind `make trace-smoke`); raises ValueError
    on the first violation."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("missing traceEvents")
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents must be a non-empty list")
    roots = 0
    for ev in events:
        for key in ("name", "ph", "ts", "dur", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event missing {key!r}: {ev}")
        if ev["ph"] != "X":
            raise ValueError(f"expected complete ('X') events, got {ev['ph']!r}")
        if not isinstance(ev["name"], str) or not ev["name"]:
            raise ValueError("event name must be a non-empty string")
        for key in ("ts", "dur"):
            if not isinstance(ev[key], (int, float)) or ev[key] < 0:
                raise ValueError(f"event {key} must be a non-negative number")
        args = ev.get("args")
        if args is not None and not isinstance(args, dict):
            raise ValueError("event args must be a dict")
        if ev["name"] == "cycle" and ev["tid"] == 1:
            roots += 1
    if roots != 1:
        raise ValueError(f"expected exactly one cycle root, got {roots}")
