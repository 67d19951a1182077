"""Placement explainer: decision provenance for the solver's kernels (this
port's own copy of volcano_tpu/trace/explain.py, its device pass in
torch).

The flight recorder (tracer.py) makes the scheduler's *time*
observable; this module makes its *decisions* observable — for every
placed gang it answers "why did gang G land on node N, what eliminated
the other nodes, and what would a top-k candidate shortlist lose?"
(Tesserae — arxiv 2508.04953 — makes the same point for scalable
policies, and the priority-packing work — arxiv 2511.08373 — motivates
the score-term decomposition).

Three surfaces, all derived from the [G, N] mask/score tensors the
solver already compiles (framework/solver.py, ops/constraints.py) via
cheap reductions on the solver's device — never a second placement pass.
The reductions are ``fused``, the pass candidate pruning (ops/prune.py)
distills its shortlists with: one top-k over ``rank_keys``, which ranks
as ``jax.lax.top_k`` does (the float32 total order, +0.0 above -0.0,
equal values by the lower node index; ``torch.topk`` keeps neither
rule):

* **Decision provenance** — per placed gang: the winning node, the
  per-constraint-mask elimination ladder (fit / selector / taint /
  affinity / spread / podcap / ...; counts telescope so ``feasible +
  sum(eliminations) == nodes`` exactly), the top-k surviving candidates
  with a score-term decomposition (binpack / least / most / balanced /
  static, plus the constraint compiler's tieredpack and soft-spread
  terms and the queue's proportion share), and the win margin (top-1 vs
  top-2 static score). Preempt/reclaim record the victim kernel's tier
  dispatch and per-victim admissibility verdicts (ops/victims.py).
  Scores are the SESSION-OPEN static formulation (the kernel's in-scan
  idle updates are not replayed) — the mask ladder and the winning node
  are exact, the candidate ordering is the pre-scan view the pruning
  work will shortlist from, which is precisely what it must measure.

* **Pruning-readiness aggregates** — per-gang feasible-node counts and
  top-k score-mass coverage (``volcano_gang_feasible_nodes``,
  ``volcano_topk_score_coverage{k}``): coverage is the fraction of a
  gang's total feasible score mass (min-shifted so it is >= 0) held by
  its k best candidates — 1.0 means a k-wide shortlist loses nothing.
  Exported into the bench row so the pruning PR has a baseline.

* **Fleet fragmentation** — ``volcano_fragmentation_ratio``: the
  largest schedulable uniform-gang (whole task-unit slots summed over
  nodes) vs the total free capacity in the same units; 1.0 = every free
  byte is reachable by a uniform gang, lower = per-node fragments below
  one task unit strand capacity (the Tesserae defrag pre-metric).

Gating: everything rides ``explain.enable`` (solver conf:
``explain.enable: "true"|"false"``, or :func:`enable` for tests/sim/
bench). When off, the only hot-path residue is one attribute check per
place() — the explain-smoke gate measures the off-mode overhead at <2%
alongside the tracer's own gate. Records are bounded (``RECORD_CAP``
jobs, LRU; ``VICTIM_CAP`` victim decisions) and the per-record score
decomposition caps at ``DETAIL_CAP`` per cycle so a 50k-gang bench
cycle pays aggregates-only cost for the tail.

Determinism: records carry no wall-clock state (cycle sequence comes
from the flight recorder), floats are rounded to 6 decimals, and
:func:`fingerprint` digests records in insertion order — bit-identical
across same-seed double runs (the `make explain-smoke` contract), and
folded into sim repro bundles (sim/replay.py).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.score import ScoreWeights, node_score

NEG = -1e30
# rows of the [G, N] pass at a time in record_place (bounds the score
# block on the device at 1024 x N floats)
RECORD_BLOCK = 1024


def rank_keys(x: torch.Tensor) -> torch.Tensor:
    """[B, N] float32 -> [B, N] int64 keys, unique within a row, that order
    as ``lax.top_k`` ranks: by the float's total order (its bits as a signed
    integer, the magnitude bits of a negative flipped), then by the lower
    column (N - 1 - column in the low 32 bits)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    n = x.shape[-1]
    rev = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=x.device)
    return ordered * (1 << 32) + rev


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of each row's k largest entries of float32 ``x``
    [B, N], in ``lax.top_k``'s order."""
    idx = torch.topk(rank_keys(x), k, dim=1, largest=True, sorted=True).indices
    return x.gather(1, idx), idx


def fused(group_req: torch.Tensor, idle: torch.Tensor, alloc: torch.Tensor,
          static: torch.Tensor, mask: torch.Tensor, weights: ScoreWeights,
          k: int, ks: Optional[Tuple[int, ...]] = None):
    """(feasible [B], vals [B, k], idx [B, k], cov) for B rows:
    ``group_req`` [B, R] against the node state ``idle``/``alloc`` [N, R]
    with ``static`` [B, N] and ``mask`` [B, N] (``_topk_fn``'s pass). The
    coverage of width w is the top-w min-shifted masked values over the
    row's min-shifted total (1 where the total is 0): ``cov`` [B] at width
    k, or [B, len(ks)] at each width of ``ks`` (the explainer's recorded
    widths). Widths are clamped to N."""
    n_ax = mask.shape[1]
    kmax = max(k, max(ks)) if ks else k
    score = node_score(group_req, idle, alloc, weights, static)
    masked = torch.where(mask, score, NEG)
    vals, idx = top_k(masked, min(kmax, n_ax))
    feasible = mask.sum(dim=1)
    minf = torch.where(mask, score, 1e30).amin(dim=1)
    total = torch.where(mask, score - minf[:, None], 0.0).sum(dim=1)
    # the top-k min-shifted mass is the top-k masked values shifted and
    # clipped: an infeasible NEG entry clips to the 0 its column adds
    svals = torch.clamp(vals - minf[:, None], min=0.0)
    if ks is None:
        cov = torch.where(total > 0.0, svals.sum(dim=1) / total, 1.0)
    else:
        cov = torch.stack(
            [torch.where(total > 0.0,
                         svals[:, :min(kk, n_ax)].sum(dim=1) / total, 1.0)
             for kk in ks], dim=1)
    return feasible, vals[:, :k], idx[:, :k], cov


RECORD_CAP = 8192          # job records kept (LRU)
VICTIM_CAP = 1024          # victim-decision records kept (ring)
DETAIL_CAP = 1024          # per-cycle records that get the full top-k
#                            score-term decomposition (the rest keep the
#                            aggregate fields only)
TOPK = 8                   # candidates kept per record
COVERAGE_KS = (4, 16, 64)  # shortlist widths the coverage histograms
#                            measure (the pruning baseline axis)
_SAMPLE_CAP = 65536        # bounded aggregate sample window

PRUNE_RECENT_CAP = 256     # per-place prune/shortlist-loss records kept

_enabled = False
_lock = threading.Lock()
_records: "OrderedDict[str, dict]" = OrderedDict()   # job key -> record
_victims: deque = deque(maxlen=VICTIM_CAP)
_fp = hashlib.sha256()
_feas_samples: deque = deque(maxlen=_SAMPLE_CAP)
_cov_sum: Dict[int, float] = {}
_cov_count: Dict[int, int] = {}
_frag_ratio: Optional[float] = None
_detail_budget = DETAIL_CAP
# the operator-chosen shortlist width (solver conf `prune.k`) must
# always be one of the recorded coverage widths — a prune.k outside the
# static COVERAGE_KS would otherwise be flying blind on its loss budget
_extra_cov_ks: set = set()
# per-cycle shortlist-loss aggregates (ops/prune.py): recent per-place
# summaries + monotone totals, surfaced on /debug/explain
_prune_recent: deque = deque(maxlen=PRUNE_RECENT_CAP)
_prune_totals: Dict[str, Dict[str, int]] = {"runs": {}, "fallbacks": {}}


def _r(x) -> float:
    return round(float(x), 6)


# -- control ----------------------------------------------------------------


def enable() -> None:
    """Turn the explainer on process-wide (tests / sim / bench); the
    solver conf's ``explain.enable`` overrides per session."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop every record and aggregate (tests, double-run gates)."""
    global _fp, _frag_ratio, _detail_budget
    with _lock:
        _records.clear()
        _victims.clear()
        _fp = hashlib.sha256()
        _feas_samples.clear()
        _cov_sum.clear()
        _cov_count.clear()
        _frag_ratio = None
        _detail_budget = DETAIL_CAP
        _extra_cov_ks.clear()
        _prune_recent.clear()
        _prune_totals["runs"] = {}
        _prune_totals["fallbacks"] = {}


def register_prune_k(k: int) -> None:
    """Fold the solver conf's ``prune.k`` into the recorded coverage
    widths (sticky for the process; re-registered by every session that
    parses a prune-enabled conf, cleared by :func:`reset`)."""
    with _lock:
        _extra_cov_ks.add(int(k))


def coverage_ks() -> tuple:
    """The shortlist widths the coverage histograms measure: the static
    baseline axis plus any registered operator-chosen ``prune.k``."""
    with _lock:
        return tuple(sorted(set(COVERAGE_KS) | _extra_cov_ks))


def note_prune(rec: dict) -> None:
    """One place() call's shortlist-loss summary (ops/prune.py
    ``PruneContext.summary()``): pushed whether the reduced kernel
    served or a guard fell the cycle back — the per-cycle loss surface
    /debug/explain exposes. No wall-clock state, floats pre-rounded."""
    with _lock:
        _prune_recent.append(dict(rec))
        if rec.get("fallback"):
            key = str(rec["fallback"])
            _prune_totals["fallbacks"][key] = \
                _prune_totals["fallbacks"].get(key, 0) + 1
        else:
            key = str(rec.get("level", "single"))
            _prune_totals["runs"][key] = \
                _prune_totals["runs"].get(key, 0) + 1


def prune_report() -> dict:
    """The shortlist-loss aggregate block: totals + newest per-place
    summaries (the /debug/explain "prune" section)."""
    with _lock:
        recent = list(_prune_recent)
        totals = {"runs": dict(_prune_totals["runs"]),
                  "fallbacks": dict(_prune_totals["fallbacks"])}
    return {"totals": totals,
            "last": recent[-1] if recent else None,
            "recent": recent[-32:]}


def session_enabled(solver_args) -> bool:
    """The per-session switch the BatchSolver caches: the solver conf's
    ``explain.enable`` wins ("true"/"on" forces on, "false"/"off"
    forces off); unset defers to the module flag."""
    if solver_args is not None and hasattr(solver_args, "get_str"):
        v = (solver_args.get_str("explain.enable", "") or "").strip().lower()
        if v in ("true", "1", "yes", "on"):
            return True
        if v in ("false", "0", "no", "off"):
            return False
    return _enabled


# -- fleet fragmentation ----------------------------------------------------


def fragmentation_ratio(narr) -> float:
    """Largest schedulable uniform-gang vs total free capacity, from the
    (persistent) NodeArrays.

    The task unit is the fleet's median per-slot capability
    (allocatable / max_tasks over pod-capped ready nodes; the whole
    allocatable row when nothing is capped). Each node contributes
    ``min_r(idle_r / unit_r)`` fractional task slots; the largest
    uniform gang the fleet can schedule is the sum of the WHOLE slots,
    and the ratio is whole/fractional — 1.0 = unfragmented, lower =
    sub-unit fragments strand free capacity."""
    n = len(narr.names)
    if n == 0:
        return 1.0
    idle = narr.idle[:n]
    alloc = narr.allocatable[:n]
    max_t = narr.max_tasks[:n].astype(np.float64)
    capped = max_t > 0
    if capped.any():
        per_slot = alloc[capped] / np.maximum(max_t[capped, None], 1.0)
    else:
        per_slot = alloc
    unit = np.median(per_slot, axis=0)
    unit = np.where(unit > 0, unit, 1.0)
    frac = np.min(np.maximum(idle, 0.0) / unit[None, :], axis=1)
    whole = np.floor(frac)
    tot = float(frac.sum())
    if tot <= 0.0:
        return 1.0
    return float(whole.sum()) / tot


def note_fragmentation(narr) -> float:
    """Compute + publish the gauge; returns the ratio."""
    global _frag_ratio
    from ..metrics import metrics as m
    ratio = fragmentation_ratio(narr)
    _frag_ratio = ratio
    m.set_gauge(m.FRAGMENTATION_RATIO, round(ratio, 6))
    return ratio


# -- provenance capture (called from framework/solver._place) ---------------


def record_place(ssn, batch, narr, stages, gmask, static_score, weights,
                 assign, result, tier: str) -> None:
    """Build provenance records for every placed gang of one place()
    call. ``stages`` is the cumulative mask ladder the context build
    captured, already reduced to per-group survivor counts:
    ``[(label, survivors [G]), ...]`` (tensors on the solver's device);
    ``gmask`` is the final [G, n_pad] mask itself (padding columns
    False) and ``static_score`` [G, n_pad], both on that device;
    ``weights`` the solver's ScoreWeights there. The aggregate pass runs
    ``fused`` on that device in blocks of RECORD_BLOCK groups."""
    from ..metrics import metrics as m
    from ..trace import tracer

    global _detail_budget
    _detail_budget = DETAIL_CAP   # the detail cap is per place() batch
    if not stages:
        return
    n_real = len(narr.names)
    n_groups = int(batch.n_groups)
    if n_real == 0 or n_groups == 0:
        return
    dev = gmask.device

    # -- the elimination ladder: the captured per-stage survivor counts
    # plus the two final stages the kernels apply beyond the group mask
    pods_ok = (narr.max_tasks == 0) | (narr.n_tasks < narr.max_tasks)
    final = gmask & torch.from_numpy(pods_ok).to(dev)[None, :]
    ladder: List[Tuple[str, object]] = list(stages) \
        + [("podcap", final.sum(dim=1))]
    if batch.task_slot is not None and batch.slot_rows is not None:
        # tensor-mode spread: the gang's per-task domain rows ride the
        # kernel's task_slot input, not the group mask — the record uses
        # the gang's FIRST task's row (domain-rotating gangs are
        # summarized by their first slot; the ladder still telescopes)
        group_slot = np.full(batch.g_pad, batch.slot_rows.shape[0] - 1,
                             np.int64)
        group_slot[:n_groups] = batch.task_slot[batch.group_first]
        rows = torch.from_numpy(batch.slot_rows).to(dev)
        final = final & rows[torch.from_numpy(group_slot).to(dev)]
        ladder.append(("spread", final.sum(dim=1)))
    counts = [c.cpu().numpy().astype(np.int64) for _, c in ladder]

    # -- the fused aggregate pass (top-k, coverage, margin) -------------
    cov_ks = coverage_ks()
    req = torch.from_numpy(batch.group_req).to(dev)
    idle = torch.from_numpy(narr.idle).to(dev)
    alloc = torch.from_numpy(narr.allocatable).to(dev)
    parts = []
    for lo in range(0, int(final.shape[0]), RECORD_BLOCK):
        hi = lo + RECORD_BLOCK
        parts.append([x.cpu() for x in fused(
            req[lo:hi], idle, alloc, static_score[lo:hi], final[lo:hi],
            weights, TOPK, ks=cov_ks)])
    feasible, top_vals, top_idx, coverage = (
        torch.cat(xs).numpy() for xs in zip(*parts))
    feasible = feasible.astype(np.int64)
    # the top-1 vs top-2 win margin, host-side
    margin = np.where(feasible > 1, top_vals[:, 0] - top_vals[:, 1], 0.0)

    real = np.arange(n_groups)
    m.observe_bulk(m.GANG_FEASIBLE_NODES, feasible[real].tolist())
    for i, kk in enumerate(cov_ks):
        vals = coverage[real, i].tolist()
        m.observe_bulk(m.TOPK_SCORE_COVERAGE, vals, k=str(kk))
        with _lock:
            _cov_sum[kk] = _cov_sum.get(kk, 0.0) + float(sum(vals))
            _cov_count[kk] = _cov_count.get(kk, 0) + len(vals)
    with _lock:
        _feas_samples.extend(feasible[real].tolist())

    # -- per-gang records for the placed jobs ---------------------------
    n_tasks = len(batch.tasks)
    a_real = np.asarray(assign[:n_tasks])
    task_group = batch.task_group[:n_tasks]
    host_w = weights.host()
    cycle_seq = tracer.current_seq()
    elim_labels = [lab for lab, _ in ladder]
    names = narr.names
    share_by_queue = _queue_shares(ssn, batch)

    new_records: List[Tuple[str, dict]] = []
    for j, uid in enumerate(batch.job_uids):
        placements = result.placements.get(uid) or []
        if not placements:
            continue
        job = ssn.jobs.get(uid)
        jkey = f"{job.namespace}/{job.name}" if job is not None else uid
        lo, hi = int(batch.job_task_start[j]), int(batch.job_task_end[j])
        span = np.arange(lo, min(hi, n_tasks))
        placed_mask = a_real[span] >= 0
        groups_placed = sorted(
            set(task_group[span[placed_mask]].tolist()))
        qname = batch.queue_names[int(batch.job_queue[j])] \
            if int(batch.job_queue[j]) < len(batch.queue_names) else ""
        rec_groups = []
        for g in groups_placed:
            in_g = span[task_group[span] == g]
            placed_g = in_g[a_real[in_g] >= 0]
            winner = names[int(a_real[placed_g[0]])] \
                if len(placed_g) else None
            elims = {}
            prev = n_real
            for li, lab in enumerate(elim_labels):
                cur = int(counts[li][g])
                gone = prev - cur
                if gone > 0:
                    elims[lab] = elims.get(lab, 0) + gone
                prev = cur
            grec = {
                "gang": int(g),
                "tasks": int(len(in_g)),
                "placed": int(len(placed_g)),
                "winner": winner,
                "nodes": n_real,
                "feasible": int(feasible[g]),
                "eliminations": elims,
                "win_margin": _r(margin[g]),
                "coverage": {str(kk): _r(coverage[g, i])
                             for i, kk in enumerate(cov_ks)},
            }
            if _detail_budget > 0:
                _detail_budget -= 1
                grec["topk"] = _topk_detail(
                    ssn, batch, narr, host_w, static_score, g,
                    top_vals[g], top_idx[g])
            rec_groups.append(grec)
        if not rec_groups:
            continue
        rec = {
            "job": jkey, "uid": uid, "cycle": cycle_seq, "kernel": tier,
            "queue": qname,
            "proportion_share": share_by_queue.get(qname),
            "committed": bool(result.committed.get(uid)),
            "pipelined_only": bool(result.kept.get(uid)
                                   and not result.committed.get(uid)),
            "groups": rec_groups,
        }
        new_records.append((jkey, rec))

    if not new_records:
        return
    with _lock:
        for jkey, rec in new_records:
            _records.pop(jkey, None)
            _records[jkey] = rec
            while len(_records) > RECORD_CAP:
                _records.popitem(last=False)
            _fp.update(_fp_line(rec).encode())


def _queue_shares(ssn, batch) -> Dict[str, Optional[float]]:
    """The proportion context per queue: max over resources of
    allocated/deserved from the live queue budgets (None when no budget
    fn is registered or the queue has no finite deserved row)."""
    shares: Dict[str, Optional[float]] = {}
    solver = getattr(ssn, "solver", None)
    fns = getattr(solver, "queue_budget_fns", None) or []
    for qname in batch.queue_names:
        share = None
        for fn in fns:
            budget = fn(qname, solver.rindex)
            if budget is None:
                continue
            allocated, deserved = budget
            finite = np.isfinite(deserved) & (deserved > 0)
            if finite.any():
                share = _r(np.max(allocated[finite] / deserved[finite]))
            break
        shares[qname] = share
    return shares


def _topk_detail(ssn, batch, narr, host_w, static_score, g,
                 vals, idx) -> List[dict]:
    """Score-term decomposition for one gang's top-k candidates:
    the kernel's additive terms recomputed host-side for just those
    nodes, plus the constraint compiler's per-term values."""
    from ..ops import constraints
    from ..ops.score import (_host_balanced, _host_binpack, _host_least,
                             _host_most)
    n_real = len(narr.names)
    keep = [i for i in range(len(idx))
            if vals[i] > -1e29 and 0 <= int(idx[i]) < n_real]
    if not keep:
        return []
    nodes = np.asarray([int(idx[i]) for i in keep])
    req = batch.group_req[g]
    idle = narr.idle[nodes]
    alloc = narr.allocatable[nodes]
    used = alloc - idle
    terms = {}
    if float(host_w.binpack):
        terms["binpack"] = float(host_w.binpack) * _host_binpack(
            req, used, alloc, host_w.binpack_res)
    if float(host_w.least):
        terms["least"] = float(host_w.least) * _host_least(req, used, alloc)
    if float(host_w.most):
        terms["most"] = float(host_w.most) * _host_most(req, used, alloc)
    if float(host_w.balanced):
        terms["balanced"] = float(host_w.balanced) * \
            _host_balanced(req, used, alloc)
    static_vals = static_score[g, torch.from_numpy(nodes).to(
        static_score.device)].cpu().numpy()
    rep = batch.tasks[int(batch.group_first[g])]
    cterms = constraints.score_terms_for(
        ssn, rep, [narr.names[i] for i in nodes],
        tiered_weight=getattr(ssn, "_tieredpack_weight", 0.0))
    out = []
    for pos, i in enumerate(keep):
        entry = {"node": narr.names[int(idx[i])],
                 "score": _r(vals[i]),
                 "terms": {name: _r(col[pos])
                           for name, col in terms.items()}}
        entry["terms"]["static"] = _r(static_vals[pos])
        for name, col in cterms.items():
            entry["terms"][name] = _r(col[pos])
        out.append(entry)
    return out


# -- victim provenance (called from ops/victims.py) -------------------------


def record_victims(preemptor_key: str, mode: str, node: str,
                   tiers, admissible: Dict[str, int], candidates: int,
                   winning_tier: Optional[int], victims: List[str],
                   verdicts: List[dict], covered: bool) -> None:
    """One preempt/reclaim decision: which tier dispatched, how many
    candidates each plugin admitted, and the per-victim verdicts on the
    winning node."""
    rec = {
        "preemptor": preemptor_key, "mode": mode, "node": node,
        "tiers": [[int(ti), list(names)] for ti, names in tiers],
        "winning_tier": winning_tier,
        "candidates": int(candidates),
        "admissible": {k: int(v) for k, v in admissible.items()},
        "victims": list(victims),
        "covered": bool(covered),
        "verdicts": verdicts,
    }
    with _lock:
        _victims.append(rec)
        _fp.update(_fp_victim_line(rec).encode())


# -- reading ----------------------------------------------------------------


def _fp_line(rec: dict) -> str:
    # the cycle seq is display metadata: it rides the flight recorder's
    # GLOBAL sequence, which keeps counting across same-process runs —
    # hashing it would break the double-run identity the smoke asserts
    parts = [rec["job"], rec["kernel"]]
    for g in rec["groups"]:
        elims = ",".join(f"{k}={v}" for k, v in sorted(
            g["eliminations"].items()))
        topk = ";".join(e["node"] for e in g.get("topk", []))
        parts.append(f"g{g['gang']}:{g['winner']}:{g['feasible']}"
                     f":{elims}:{g['win_margin']}:{topk}")
    return "|".join(parts) + "\n"


def _fp_victim_line(rec: dict) -> str:
    return (f"victim|{rec['preemptor']}|{rec['mode']}|{rec['node']}|"
            f"{rec['winning_tier']}|{','.join(rec['victims'])}\n")


def fingerprint() -> str:
    """Deterministic digest of every record in insertion order — the
    double-run identity the explain-smoke gate asserts."""
    with _lock:
        return _fp.hexdigest()


def job_record(key: str) -> Optional[dict]:
    """The latest record for a job ("ns/name" key or uid)."""
    with _lock:
        rec = _records.get(key)
        if rec is not None:
            return dict(rec)
        for r in _records.values():
            if r.get("uid") == key:
                return dict(r)
    return None


def _percentiles(samples: List[int]) -> dict:
    if not samples:
        return {"count": 0}
    import math
    s = sorted(samples)
    n = len(s)
    # nearest-rank: index ceil(q*n) - 1 (trace/ledger.py's form — int(q*n)
    # alone reads one rank high: p50 of two samples must be the first)
    at = lambda q: s[min(n - 1, max(0, math.ceil(round(q * n, 9)) - 1))]
    return {"count": n, "mean": _r(sum(s) / n),
            "min": int(s[0]), "p50": int(at(0.5)), "p90": int(at(0.9)),
            "p99": int(at(0.99)), "max": int(s[-1])}


def aggregates() -> dict:
    """The pruning-readiness surface: feasible-node percentiles, mean
    top-k score-mass coverage per shortlist width, fragmentation."""
    with _lock:
        feas = list(_feas_samples)
        cov = {str(k): _r(_cov_sum[k] / _cov_count[k])
               for k in sorted(_cov_sum) if _cov_count.get(k)}
        frag = _frag_ratio
    return {"feasible_nodes": _percentiles(feas),
            "topk_coverage": cov,
            "coverage_ks": list(coverage_ks()),
            "fragmentation_ratio": _r(frag) if frag is not None else None,
            "prune": prune_report()}


def report(limit: int = 64) -> dict:
    """The /debug/explain payload: records (newest ``limit``; 0 = all),
    victim decisions, aggregates, fingerprint."""
    with _lock:
        jobs = list(_records.items())
        victims = list(_victims)
        n_records = len(_records)
        fp = _fp.hexdigest()
    if limit and len(jobs) > limit:
        jobs = jobs[-limit:]
    return {
        "enabled": _enabled,
        "records": n_records,
        "fingerprint": fp,
        "jobs": {k: v for k, v in jobs},
        "victims": victims[-limit:] if limit else victims,
        "aggregates": aggregates(),
    }
