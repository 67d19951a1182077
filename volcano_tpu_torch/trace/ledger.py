"""Pod lifecycle ledger: per-pod transition timestamps and latency hops
(this port's own copy of volcano_tpu/trace/ledger.py).

The flight recorder (tracer.py) answers "where did this CYCLE spend its
time"; this module answers the question a control plane serving live
traffic is judged on: "how long did this POD take from submission to
confirmed bind, and which hop ate it?" Every schedulable pod gets one
ledger entry stamped with monotonic transition timestamps as it flows
through the cache, the actions and the sharded bind flush:

    submitted          watch ingest of a pending, responsible pod
    enqueued           its PodGroup gated Pending -> Inqueue (enqueue
                       action; skipped when the group arrives Inqueue)
    session_eligible   first cycle the pod entered the allocate batch
    kernel_placed      the placement kernel assigned it a node
    bind_staged        the cache recorded its bind for the flush
    store_committed    the store write landed (binder pass succeeded)
    echo_confirmed     the bind's watch echo re-ingested into the cache
                       (terminal: the hop/e2e aggregates absorb the entry)

plus *detour* counters that never advance the chain: ``retry`` (a bind
failure entered backoff), ``quarantined`` (retry budget exhausted),
``healed`` (gang-atomic unbind of a bound sibling). Stages stamp ONCE —
a pod re-placed after a retry keeps its original timestamps, so the
bind_staged->store_committed hop absorbs the whole retry window, which
is exactly the attribution an operator wants.

Hop latencies are computed between consecutive *present* stamps (a
skipped stage — e.g. ``enqueued`` for a group created Inqueue — skips
its hop), so per-hop sums always equal the e2e latency
(tests/test_lifecycle.py holds that identity).

All timestamps come from the caller (the store's clock), so a simulator
on a virtual clock produces bit-identical aggregates across double runs
(``fingerprint()``); the live scheduler stamps wall time. Aggregates
export as ``volcano_pod_e2e_latency_milliseconds{queue}`` /
``volcano_pod_hop_latency_milliseconds{hop}`` histograms and the
``/debug/latency`` endpoint serves p50/p95/p99 over a bounded sample
window. Enabled/disabled together with the tracer (one production
switch); a disabled ledger's ``stamp`` is one flag check.

``confirm_runs`` (the bind echo's completions) runs on the native engine
(native/fastmodel.c ``ledger_confirm_runs``) while ``NATIVE_CONFIRM`` is
on, the default; its Python body is the plain version.
"""

from __future__ import annotations

import hashlib
import threading
from collections import deque
from typing import Dict, List, Optional

STAGES = ("submitted", "enqueued", "session_eligible", "kernel_placed",
          "bind_staged", "store_committed", "echo_confirmed")
_STAGE_IDX = {s: i for i, s in enumerate(STAGES)}
DETOURS = ("retry", "quarantined", "healed")

# interned hop names, indexed [from_idx][to_idx] — a 50k-bind flush
# completes 50k entries and building "a->b" strings per completion was
# a measurable slice of the commit path (tools/flush_bench.py --profile)
_HOP_NAME = [[f"{a}->{b}" for b in STAGES] for a in STAGES]
_COMMIT_IDX = _STAGE_IDX["store_committed"]
_ECHO_IDX = _STAGE_IDX["echo_confirmed"]

# /debug/latency percentile window per hop (deterministic: the LAST N
# completions, not a randomized reservoir)
SAMPLE_WINDOW = 1024
# completed-bind ring for /debug/latency's recent view (key, trace, e2e)
RECENT_CAPACITY = 64

_enabled = False
_lock = threading.Lock()
# stamping calls held for complete_deferred, in order, and the lock that
# runs one held batch at a time
_deferred: list = []
_deferred_run_lock = threading.Lock()


class _Entry:
    __slots__ = ("stamps", "detours", "trace", "queue", "job")

    def __init__(self):
        self.stamps: List[tuple] = []       # [(stage_idx, t)] ascending
        self.detours: Optional[dict] = None
        self.trace: Optional[str] = None
        self.queue: Optional[str] = None
        self.job: Optional[str] = None


class _Agg:
    __slots__ = ("count", "total", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.samples: deque = deque(maxlen=SAMPLE_WINDOW)

    def add(self, ms: float) -> None:
        self.count += 1
        self.total += ms
        self.samples.append(ms)

    def percentiles(self) -> dict:
        if not self.samples:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        import math
        s = sorted(self.samples)
        n = len(s)
        # nearest-rank: index ceil(q*n) - 1 (int(q*n) alone reads one
        # rank high — p50 of two samples must be the first); the round
        # guards float fuzz like 0.95*20 == 19.000000000000004
        at = lambda q: s[min(n - 1, max(0, math.ceil(round(q * n, 9))
                                        - 1))]
        return {"p50": round(at(0.50), 3), "p95": round(at(0.95), 3),
                "p99": round(at(0.99), 3)}

    def report(self) -> dict:
        out = {"count": self.count,
               "mean_ms": round(self.total / self.count, 3)
               if self.count else 0.0}
        out.update(self.percentiles())
        return out


_entries: Dict[str, _Entry] = {}
_hops: Dict[str, _Agg] = {}          # "submitted->enqueued", ..., "e2e"
_queue_e2e: Dict[str, _Agg] = {}     # queue name -> e2e agg
_detour_totals: Dict[str, int] = {}
# completion ring: raw (key, trace, queue, e2e_ms, stamps, detours)
# tuples, FORMATTED lazily by report() — only the surviving
# RECENT_CAPACITY entries ever pay the dict/round work, not all 50k
# completions of a flush
_recent: deque = deque(maxlen=RECENT_CAPACITY)
_completed = 0
_dropped = 0
# prometheus exports staged by completions under _lock, drained to
# metrics.observe_bulk AFTER release by the public entry points: one
# metrics-lock pass per (metric, label) per delivery instead of ~6 per
# completed pod (a 50k-bind flush echo otherwise pays ~300k lock
# acquisitions on the executor thread)
_pending_exports: Dict[tuple, list] = {}
# staged-export key tuples, interned per (metric, label) — rebuilt
# per completion they were another per-pod allocation
_export_keys: Dict[tuple, tuple] = {}
_metrics_mod = None


def _metrics():
    """The metrics module, imported once (the per-completion
    ``from ..metrics import metrics`` showed up in flush profiles)."""
    global _metrics_mod
    if _metrics_mod is None:
        from ..metrics import metrics as m
        _metrics_mod = m
    return _metrics_mod


# the native completion's switch: a module attribute, so tests can force
# either engine
NATIVE_CONFIRM = True
_native = None


def _ledger_native():
    """The native engine, registered with this module's _Entry and _Agg
    layouts and hop table at first use. A failed build raises."""
    global _native
    if _native is None:
        from ..native.build import fastmodel
        fm = fastmodel()
        fm.register_ledger_types(_Entry, _Agg, _HOP_NAME, _COMMIT_IDX,
                                 _ECHO_IDX)
        _native = fm
    return _native


# -- control ----------------------------------------------------------------


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def reset() -> None:
    global _completed, _dropped
    with _lock:
        _deferred.clear()
        _entries.clear()
        _hops.clear()
        _queue_e2e.clear()
        _detour_totals.clear()
        _recent.clear()
        _pending_exports.clear()
        _export_keys.clear()
        _completed = 0
        _dropped = 0


def _drain_exports() -> None:
    """Push staged histogram observations out (called by every public
    stamping entry point after releasing the ledger lock)."""
    if not _pending_exports:
        return
    with _lock:
        if not _pending_exports:
            return
        staged = dict(_pending_exports)
        _pending_exports.clear()
    m = _metrics()
    for (name, labels), values in staged.items():
        m.observe_bulk(name, values, **dict(labels))


# -- stamping ---------------------------------------------------------------


def _stamp_locked(key: str, idx: int, now: float, queue, job, trace) -> None:
    e = _entries.get(key)
    if e is None:
        # ONLY the "submitted" stamp creates entries: a late stamp for a
        # pod whose entry already completed (the in-process store echoes
        # synchronously, so a store_committed stamp can arrive after the
        # echo confirmed and absorbed the entry) must never resurrect it
        # as a phantom open entry.
        if idx != 0:
            return
        e = _entries[key] = _Entry()
    if queue is not None:
        e.queue = queue
    if job is not None:
        e.job = job
    if trace is not None:
        e.trace = trace
    stamps = e.stamps
    if stamps:
        last_i, last_t = stamps[-1]
        # stamp indexes are strictly ascending, so "already stamped" and
        # "earlier than the newest stage" (a replay — restart relist,
        # duplicate echo) collapse to one compare
        if idx <= last_i:
            return
        if now < last_t:
            now = last_t   # clamp: hops are never negative
    stamps.append((idx, now))
    if idx == _ECHO_IDX:
        _complete_locked(key, e)


def stamp(key: str, stage: str, now: float, queue: Optional[str] = None,
          job: Optional[str] = None, trace: Optional[str] = None) -> None:
    """Record ``stage`` for pod ``key`` at time ``now`` (set-once)."""
    if not _enabled:
        return
    idx = _STAGE_IDX[stage]
    with _lock:
        _stamp_locked(key, idx, now, queue, job, trace)
    _drain_exports()


def stamp_bulk(keys, stage: str, now: float, trace: Optional[str] = None,
               queue: Optional[str] = None) -> None:
    """One lock pass for a batch point (the allocate batch, a flush's
    committed list, a shard's echo delivery)."""
    if not _enabled:
        return
    idx = _STAGE_IDX[stage]
    with _lock:
        for key in keys:
            _stamp_locked(key, idx, now, queue, None, trace)
    _drain_exports()


def stamp_runs(runs, stage: str, trace: Optional[str] = None) -> None:
    """``stamp_bulk`` for several key batches with different instants in
    one lock pass, ``runs = [(keys, t)]``: the coalesced bind drain stamps
    every gang's ``bind_staged`` at its own staging instant."""
    if not _enabled:
        return
    idx = _STAGE_IDX[stage]
    with _lock:
        for keys, t in runs:
            for key in keys:
                _stamp_locked(key, idx, t, None, None, trace)
    _drain_exports()


def _confirm_one_locked(key: str, queue, commit_t: float,
                        echo_t: float) -> None:
    """Stamp ``store_committed`` @commit_t then ``echo_confirmed``
    @echo_t on one entry — the flat form of two ``_stamp_locked`` calls,
    specialized for the bind-echo hot path (one dict probe, no per-stage
    re-validation)."""
    e = _entries.get(key)
    if e is None:
        return   # completed/dropped already, or never submitted
    if queue is not None:
        e.queue = queue
    stamps = e.stamps
    last_i, last_t = stamps[-1] if stamps else (-1, 0.0)
    if last_i >= _ECHO_IDX:
        return
    if last_i < _COMMIT_IDX:
        t = commit_t if commit_t >= last_t else last_t
        stamps.append((_COMMIT_IDX, t))
        last_t = t
    t = echo_t if echo_t >= last_t else last_t
    stamps.append((_ECHO_IDX, t))
    _complete_locked(key, e)


def confirm(key: str, now: float, queue: Optional[str] = None,
            commit_t: Optional[float] = None) -> None:
    """Bind-echo ingest: stamp ``store_committed`` then
    ``echo_confirmed`` in one lock pass. ``commit_t`` (default ``now``)
    is the instant the owning shard PUBLISHED to the store, so the
    ``store_committed->echo_confirmed`` hop measures the echo pipeline's
    internal queue wait instead of folding into staged->committed. With
    no commit_t the two stamps coincide (a zero hop); a remote mirror's
    delayed echo leaves the earlier write-time store_committed stamp in
    place (set-once) and the hop measures the real propagation delay."""
    if not _enabled:
        return
    with _lock:
        _confirm_one_locked(key, queue, commit_t if commit_t is not None
                            else now, now)
    _drain_exports()


def defer(fn) -> None:
    """Run ``fn()`` (a stamping call, its instants already fixed) at the
    next :func:`complete_deferred`, in the order deferred. The cycle's own
    stamps (session_eligible, kernel_placed, a per-task bind_staged) are
    held here and applied on the cache's flush executor, off the cycle,
    before the executor stamps the same pods' commit; a key list is
    built then, not in the cycle. No-op while disabled."""
    if _enabled:
        with _lock:
            _deferred.append(fn)


def complete_deferred() -> int:
    """Apply the held stamping calls, in order; returns how many ran.
    Callers on two threads (the executor, a flush barrier) take turns, so
    a later batch never runs before an earlier one."""
    with _deferred_run_lock:
        with _lock:
            held = list(_deferred)
            _deferred.clear()
        for fn in held:
            fn()
    return len(held)


def confirm_runs(runs, now: float, commit_t: Optional[float] = None) -> None:
    """``confirm`` for a whole echo delivery grouped into per-job runs —
    ``runs = [(keys, queue)]``, ONE ledger call per delivery with one
    queue lookup per run instead of one (key, queue) pair per pod.

    This is the commit path's hottest ledger loop (50k completions per
    flush), so the per-run invariants — queue aggregate, e2e export
    list, the per-hop aggregate/export resolution — are hoisted out of
    the per-pod body, and the entry completion is inlined for the
    common shape (no out-of-order stamps). Aggregation arithmetic is
    IDENTICAL to :func:`_complete_locked` — fingerprints must not see
    which loop ran. On the native engine the loop is one
    ``ledger_confirm_runs`` call."""
    if not _enabled:
        return
    global _completed
    ct = commit_t if commit_t is not None else now
    m = _metrics()
    if NATIVE_CONFIRM:
        fm = _ledger_native()
        with _lock:
            _completed += fm.ledger_confirm_runs(
                _entries, _hops, _queue_e2e, _pending_exports,
                _export_keys, _recent, m.POD_HOP_LATENCY,
                m.POD_E2E_LATENCY, runs, ct, float(now))
        _drain_exports()
        return
    with _lock:
        hop_cache: dict = {}

        def hop_sinks(hop):
            agg = _hops.get(hop)
            if agg is None:
                agg = _hops[hop] = _Agg()
            ek = _export_keys.get(hop)
            if ek is None:
                ek = _export_keys[hop] = (m.POD_HOP_LATENCY,
                                          (("hop", hop),))
            lst = _pending_exports.get(ek)
            if lst is None:
                lst = _pending_exports[ek] = []
            sinks = hop_cache[hop] = (agg, agg.samples, lst)
            return sinks

        e2e_agg = _hops.get("e2e")
        if e2e_agg is None:
            e2e_agg = _hops["e2e"] = _Agg()
        for keys, queue in runs:
            q = queue or ""
            qagg = _queue_e2e.get(q)
            if qagg is None:
                qagg = _queue_e2e[q] = _Agg()
            ek = _export_keys.get(("q", q))
            if ek is None:
                ek = _export_keys[("q", q)] = (m.POD_E2E_LATENCY,
                                               (("queue", q),))
            q_exports = _pending_exports.get(ek)
            if q_exports is None:
                q_exports = _pending_exports[ek] = []
            for key in keys:
                e = _entries.get(key)
                if e is None:
                    continue
                stamps = e.stamps
                last_i, last_t = stamps[-1] if stamps else (-1, 0.0)
                if last_i >= _ECHO_IDX:
                    continue
                if queue is not None:
                    e.queue = queue
                if last_i < _COMMIT_IDX:
                    t = ct if ct >= last_t else last_t
                    stamps.append((_COMMIT_IDX, t))
                    last_t = t
                stamps.append((_ECHO_IDX,
                               now if now >= last_t else last_t))
                # inline completion (the _complete_locked body with the
                # per-run lookups above already resolved)
                del _entries[key]
                _completed += 1
                e2e_ms = (stamps[-1][1] - stamps[0][1]) * 1000.0
                hop_list: list = []
                prev_i, prev_t = stamps[0]
                for i1, t1 in stamps[1:]:
                    hop = _HOP_NAME[prev_i][i1]
                    ms = (t1 - prev_t) * 1000.0
                    prev_i, prev_t = i1, t1
                    hop_list.append((hop, ms))
                    sinks = hop_cache.get(hop)
                    if sinks is None:
                        sinks = hop_sinks(hop)
                    agg, samples, exports = sinks
                    agg.count += 1
                    agg.total += ms
                    samples.append(ms)
                    exports.append(ms)
                e2e_agg.count += 1
                e2e_agg.total += e2e_ms
                e2e_agg.samples.append(e2e_ms)
                qagg.count += 1
                qagg.total += e2e_ms
                qagg.samples.append(e2e_ms)
                q_exports.append(e2e_ms)
                _recent.append((key, e.trace, q, e2e_ms, hop_list,
                                e.detours))
    _drain_exports()


def detour(key: str, kind: str) -> None:
    """Count a retry/quarantined/healed detour on the pod's entry (a
    no-op for pods the ledger never saw submitted)."""
    if not _enabled:
        return
    with _lock:
        e = _entries.get(key)
        if e is None:
            return
        if e.detours is None:
            e.detours = {}
        e.detours[kind] = e.detours.get(kind, 0) + 1
        _detour_totals[kind] = _detour_totals.get(kind, 0) + 1


def reopen(key: str, kind: str, now: float) -> None:
    """A CONFIRMED bind was reverted (gang-atomic heal unbinding a bound
    sibling whose echo already completed its entry): count the detour
    unconditionally and restart the pod's lifecycle — a fresh entry
    re-submitted at the heal instant — so its eventual re-placement is
    tracked instead of every later stamp being dropped on the floor. An
    entry still OPEN (the remote-store shape, where the heal can run
    before the echo) just takes the detour; its original stamps stand
    and the staged->committed hop absorbs the heal window."""
    if not _enabled:
        return
    with _lock:
        _detour_totals[kind] = _detour_totals.get(kind, 0) + 1
        e = _entries.get(key)
        if e is None:
            e = _entries[key] = _Entry()
            e.stamps.append((0, now))
        if e.detours is None:
            e.detours = {}
        e.detours[kind] = e.detours.get(kind, 0) + 1


def drop(key: str) -> None:
    """The pod was deleted before confirmation: retire its entry so it
    can never show up as an orphan."""
    if not _enabled:
        return
    global _dropped
    with _lock:
        if _entries.pop(key, None) is not None:
            _dropped += 1


def _complete_locked(key: str, e: _Entry) -> None:
    global _completed
    del _entries[key]
    _completed += 1
    m = _metrics()
    stamps = e.stamps
    e2e_ms = (stamps[-1][1] - stamps[0][1]) * 1000.0
    hop_list: list = []   # stamp idxs are strictly ascending: no dup keys
    prev_i, prev_t = stamps[0]
    for i1, t1 in stamps[1:]:
        hop = _HOP_NAME[prev_i][i1]
        ms = (t1 - prev_t) * 1000.0
        prev_i, prev_t = i1, t1
        hop_list.append((hop, ms))
        agg = _hops.get(hop)
        if agg is None:
            agg = _hops[hop] = _Agg()
        agg.add(ms)
        # prometheus export rides the completion (staged here under
        # _lock with an interned key tuple, drained in bulk by the
        # public entry point that triggered it)
        ek = _export_keys.get(hop)
        if ek is None:
            ek = _export_keys[hop] = (m.POD_HOP_LATENCY, (("hop", hop),))
        lst = _pending_exports.get(ek)
        if lst is None:
            lst = _pending_exports[ek] = []
        lst.append(ms)
    agg = _hops.get("e2e")
    if agg is None:
        agg = _hops["e2e"] = _Agg()
    agg.add(e2e_ms)
    q = e.queue or ""
    qagg = _queue_e2e.get(q)
    if qagg is None:
        qagg = _queue_e2e[q] = _Agg()
    qagg.add(e2e_ms)
    _recent.append((key, e.trace, q, e2e_ms, hop_list,
                    e.detours))   # formatted lazily by report()
    ek = _export_keys.get(("q", q))
    if ek is None:
        ek = _export_keys[("q", q)] = (m.POD_E2E_LATENCY, (("queue", q),))
    lst = _pending_exports.get(ek)
    if lst is None:
        lst = _pending_exports[ek] = []
    lst.append(e2e_ms)


# -- reading ----------------------------------------------------------------


def trace_of(key: str) -> Optional[str]:
    """The correlation ID recorded on a pod's OPEN ledger entry (completed
    binds surface theirs in ``report()['recent']``)."""
    with _lock:
        e = _entries.get(key)
        return e.trace if e is not None else None


def stats() -> dict:
    with _lock:
        return {"enabled": _enabled, "open": len(_entries),
                "completed": _completed, "dropped": _dropped,
                "detours": dict(_detour_totals)}


def orphans(store) -> List[str]:
    """Open entries whose pod no longer exists in the store — a stamp
    path that forgot to ``drop()`` on delete shows up here (the
    obs-smoke gate requires zero)."""
    with _lock:
        keys = list(_entries)
    out = []
    for key in keys:
        ns, _, name = key.partition("/")
        if store.get("pods", name, ns) is None:
            out.append(key)
    return out


def report() -> dict:
    """The ``/debug/latency`` payload: per-hop and e2e percentiles,
    per-queue e2e, detour totals, open/completed counts and the recent
    completion ring (pod -> trace id join)."""
    with _lock:
        return {
            "enabled": _enabled,
            "open": len(_entries),
            "completed": _completed,
            "dropped": _dropped,
            "detours": dict(_detour_totals),
            "hops": {hop: agg.report() for hop, agg in sorted(_hops.items())},
            "per_queue_e2e": {q: agg.report()
                              for q, agg in sorted(_queue_e2e.items())},
            "recent": [
                {"pod": key, "trace": trace, "queue": q,
                 "e2e_ms": round(e2e_ms, 3),
                 "hops": {h: round(ms, 3) for h, ms in hop_list},
                 "detours": dict(detours) if detours else {}}
                for key, trace, q, e2e_ms, hop_list, detours in _recent],
        }


def fingerprint() -> str:
    """Deterministic digest of the aggregate state — two virtual-clock
    sim runs from one seed must produce identical ledgers (the obs-smoke
    double-run gate)."""
    h = hashlib.sha256()
    with _lock:
        h.update(f"completed={_completed} dropped={_dropped}\n".encode())
        for kind in sorted(_detour_totals):
            h.update(f"detour {kind}={_detour_totals[kind]}\n".encode())
        for hop in sorted(_hops):
            agg = _hops[hop]
            h.update(f"hop {hop} n={agg.count} "
                     f"sum={agg.total:.9f}\n".encode())
        for q in sorted(_queue_e2e):
            agg = _queue_e2e[q]
            h.update(f"queue {q} n={agg.count} "
                     f"sum={agg.total:.9f}\n".encode())
    return h.hexdigest()
