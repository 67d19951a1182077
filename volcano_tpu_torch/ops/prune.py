"""Candidate pruning (counterpart of volcano_tpu/ops/prune.py, single
level).

Before the gang-allocate kernel runs, each gang (each (gang, topology
domain) pair when the batch carries per-task domain slots) gets a
shortlist of its top-k candidate nodes by the session-open masked score,
taken by the explainer's fused pass (trace/explain.py:fused) in blocks of
at most PAIR_BLOCK pairs, so that no [G, N] score is ever held at once. A
shortlist is widened past ``prune.k`` when its tasks need more capacity
than k nodes hold (``_demand_k``); the wide ones are selected on the host
from their score rows (``score_rows``) with numpy's argpartition, as the
reference selects them. The union of the shortlists, sorted ascending (so
the kernel's lowest-index tie-break maps one to one) and padded to a
bucket, is the node axis the unmodified kernel then runs over; the solver
(framework/solver.py) gathers its inputs down and maps placements back.

The guards are decision rules: ``pre_guard`` sends the place to the
full-width kernel before the reduced run (an empty union, a union of at
least ``prune.max_union_frac`` of the nodes in auto mode, a pair whose
score-mass coverage at its width is under ``prune.coverage_floor``);
``post_guard`` discards a reduced run in which a feasible task went
unplaced while any pair's shortlist was truncated. There is no crash
fallback: an exception propagates.

The two-level form over a device mesh's partitions
(``_twolevel_restrict_fn``) waits for the multi-GPU sharding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.arrays import bucket
from ..ops.score import ScoreWeights, node_score
from ..trace import explain

NEG = explain.NEG

# pair-block height of the distillation pass: bounds the transient [B, N]
# score (B x N x R float32 terms at once)
PAIR_BLOCK = 1024
# reps a block of the wide extension pulls to the host at once
WIDE_BLOCK = 128

# demand-aware shortlist sizing: capacity headroom over the estimated
# nodes the pair's tasks will drain (the post-kernel guard catches an
# estimate that still came up short)
DEMAND_HEADROOM = 1.5

# every way a place can fall back to the full-width kernel
FALLBACK_REASONS = ("low_coverage", "shortlist_exhausted", "wide_union",
                    "empty_union")


@dataclass
class PruneConf:
    """The ``solver`` conf's ``prune.*`` arguments.

    ``prune.enable`` "auto" (default) engages at ``prune.min_nodes`` ready
    nodes or more; "true" forces it at any scale; "false"/"off" keeps the
    unpruned path (distillation never runs). ``prune.demand_aware``
    (default on) widens a shortlist past ``prune.k`` when the tasks that
    will drain it need more capacity than k nodes hold. ``prune.guard``
    off disables the loss guards (tests show them load-bearing with it).
    The reference's ``prune.partitions`` chooses among a device mesh's
    partitions (the two-level form) and is accepted and ignored."""
    mode: str = "auto"
    k: int = 64
    coverage_floor: float = 0.9
    min_nodes: int = 4096
    max_union_frac: float = 0.6
    guard: bool = True
    demand_aware: bool = True

    @classmethod
    def from_args(cls, solver_args) -> "PruneConf":
        conf = cls()
        if solver_args is None:
            return conf
        conf.mode = (solver_args.get_str("prune.enable", "auto")
                     or "auto").strip().lower()
        conf.guard = (solver_args.get_str("prune.guard", "on")
                      or "on").strip().lower() not in (
            "off", "false", "0", "no")
        conf.demand_aware = (solver_args.get_str(
            "prune.demand_aware", "on") or "on").strip().lower() \
            not in ("off", "false", "0", "no")
        conf.k = max(1, solver_args.get_int("prune.k", cls.k))
        conf.min_nodes = solver_args.get_int("prune.min_nodes",
                                             cls.min_nodes)
        conf.coverage_floor = solver_args.get_float("prune.coverage_floor",
                                                    cls.coverage_floor)
        conf.max_union_frac = solver_args.get_float("prune.max_union_frac",
                                                    cls.max_union_frac)
        return conf

    @property
    def off(self) -> bool:
        return self.mode in ("off", "false", "0", "no")

    def active(self, n_nodes: int) -> bool:
        """Does pruning engage for a place over ``n_nodes`` ready nodes?
        Forced ("true") still needs a node to prune toward."""
        if self.off or n_nodes <= 0:
            return False
        if self.mode in ("true", "1", "yes", "on"):
            return True
        return n_nodes >= self.min_nodes


class PruneContext:
    """One place's distilled shortlists and their union."""

    __slots__ = ("conf", "level", "k", "k_max", "n_real", "n_pad",
                 "pair_g", "pair_s", "pair_of_task",
                 "feasible", "count", "coverage",
                 "union", "m_real", "u_pad", "union_padded", "live",
                 "fallback", "fallback_pairs")

    def __init__(self, conf, k, n_real, n_pad, pair_g, pair_s,
                 pair_of_task, feasible, count, coverage):
        self.conf = conf
        self.level = "single"
        self.k = k
        self.k_max = k              # widest demand-sized shortlist
        self.fallback_pairs = 0     # pairs behind a pre-guard fallback
        self.n_real = n_real
        self.n_pad = n_pad
        self.pair_g = pair_g
        self.pair_s = pair_s        # None without slot tensors
        self.pair_of_task = pair_of_task   # [T_real] -> pair index (-1)
        self.feasible = feasible    # [P] full-mask feasible node count
        self.count = count          # [P] live shortlist entries kept
        self.coverage = coverage    # [P] score-mass coverage at the width
        self.union = None
        self.m_real = 0
        self.u_pad = 0
        self.union_padded = None
        self.live = None
        self.fallback = None

    def set_union(self, union: np.ndarray, bucket_size: int = 256) -> None:
        self.union = union
        self.m_real = int(union.shape[0])
        self.u_pad = bucket(max(self.m_real, 1), bucket_size)
        padded = np.zeros(self.u_pad, np.int64)
        padded[:self.m_real] = union
        self.union_padded = padded
        live = np.zeros(self.u_pad, bool)
        live[:self.m_real] = True
        self.live = live

    @property
    def truncated(self) -> np.ndarray:
        """[P] bool: the pair's shortlist kept fewer candidates than its
        mask had feasible nodes (the pairs the post guard watches)."""
        return self.feasible > self.count

    def pre_guard(self) -> Optional[tuple]:
        """(reason, pairs) when the place must run full width before the
        reduced run, else None."""
        if self.m_real == 0:
            # nothing feasible anywhere: the full-width kernel decides, so
            # fit errors come from the unpruned path
            return ("empty_union", 1)
        if self.conf.mode == "auto" and self.m_real >= max(
                1.0, self.conf.max_union_frac * self.n_real):
            # an economy rule, not a loss guard: forced mode skips it
            return ("wide_union", 1)
        low = int((self.coverage < self.conf.coverage_floor).sum())
        if low and self.conf.guard:
            return ("low_coverage", low)
        return None

    def post_guard(self, assign_full: np.ndarray, batch) -> bool:
        """True when the reduced run must be discarded: a valid task whose
        pair has a feasible node went unplaced while any pair's shortlist
        was truncated (batch-wide: a truncated gang's choices shift the
        state every later gang sees)."""
        if not self.conf.guard:
            return False
        if not self.truncated.any():
            return False
        n = self.pair_of_task.shape[0]
        a = np.asarray(assign_full[:n])
        valid = np.asarray(batch.task_valid[:n], bool)
        pt = self.pair_of_task
        unplaced = (a < 0) & valid & (pt >= 0)
        if not unplaced.any():
            return False
        return bool((self.feasible[pt[unplaced]] > 0).any())

    def map_assign(self, assign) -> np.ndarray:
        """Reduced node indices -> global node indices (padding columns
        are infeasible, so only live entries appear)."""
        a = np.asarray(assign)
        lut = np.full(self.u_pad, -1, np.int64)
        lut[:self.m_real] = self.union
        return np.where(a >= 0, lut[np.clip(a, 0, self.u_pad - 1)],
                        -1).astype(np.int32)

    def summary(self) -> dict:
        cov = self.coverage
        return {
            "level": self.level,
            "k": int(self.k),
            "k_max": int(self.k_max),
            "pairs": int(self.pair_g.shape[0]),
            "union": int(self.m_real),
            "nodes": int(self.n_real),
            "truncated_pairs": int(self.truncated.sum()),
            "coverage_min": round(float(cov.min()), 6) if cov.size else 1.0,
            "coverage_mean": round(float(cov.mean()), 6)
            if cov.size else 1.0,
            "fallback": self.fallback,
            "fallback_pairs": int(self.fallback_pairs),
        }


def score_rows(group_req: torch.Tensor, idle: torch.Tensor,
               alloc: torch.Tensor, static: torch.Tensor, mask: torch.Tensor,
               weights: ScoreWeights) -> torch.Tensor:
    """[B, N] masked session-open scores (NEG where ``mask`` is false), no
    top-k: the rows the wide extension selects from on the host
    (counterpart of _score_rows_fn's ``rows``)."""
    score = node_score(group_req, idle, alloc, weights, static)
    return torch.where(mask, score, NEG)


def _demand_k(conf, batch, narr, rep_g, rep_of_pair, pair_of_task,
              n_pairs: int, k: int, n_pad: int) -> np.ndarray:
    """Per-representative shortlist width: at least ``k``, widened so the
    shortlist's estimated capacity (the fleet-median idle over the rep's
    request row) covers the tasks that will drain it, with
    DEMAND_HEADROOM."""
    n_reps = int(rep_g.shape[0])
    k_eff = np.full(n_reps, k, np.int64)
    if not conf.demand_aware:
        return k_eff
    valid_pairs = pair_of_task[pair_of_task >= 0]
    demand_pair = np.bincount(valid_pairs, minlength=n_pairs)
    demand_rep = np.bincount(rep_of_pair, weights=demand_pair,
                             minlength=n_reps)
    n_real = len(narr.names)
    if n_real == 0:
        return k_eff
    med_idle = np.median(np.asarray(narr.idle[:n_real], np.float64),
                         axis=0)
    req = np.asarray(batch.group_req, np.float64)[rep_g]
    pos = req > 1e-9
    ratios = np.where(pos, med_idle[None, :] / np.where(pos, req, 1.0),
                      np.inf)
    per_node = np.maximum(np.floor(ratios.min(axis=1)), 1.0)
    need = np.ceil(demand_rep * DEMAND_HEADROOM / per_node)
    has_pos = pos.any(axis=1)   # zero-demand requests keep k candidates
    k_eff[has_pos] = np.minimum(
        n_pad, np.maximum(k, need[has_pos])).astype(np.int64)
    return k_eff


class _Rows:
    """The device inputs both distillation passes gather rows from."""

    def __init__(self, batch, narr, gmask, static_score, rep_g, rep_s):
        dev = gmask.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        self.gmask, self.static = gmask, static_score
        self.rep_g, self.rep_s = rep_g, rep_s
        self.idle = up(narr.idle)
        self.alloc = up(narr.allocatable)
        self.pods_ok = up((narr.max_tasks == 0)
                          | (narr.n_tasks < narr.max_tasks))
        self.group_req = up(batch.group_req)
        self.slot_rows = up(batch.slot_rows) if rep_s is not None else None
        self.up = up

    def take(self, reps: np.ndarray):
        """(request rows, static rows, mask rows) of the reps ``reps``:
        the group's mask row, the node's pod cap and, with slots, the
        pair's domain row."""
        g = self.up(self.rep_g[reps].astype(np.int64))
        mask = self.gmask[g] & self.pods_ok[None, :]
        if self.rep_s is not None:
            mask = mask & self.slot_rows[
                self.up(self.rep_s[reps].astype(np.int64))]
        return self.group_req[g], self.static[g], mask


def _extend_wide_reps(rows: _Rows, weights, k_eff, k, rep_feasible,
                      rep_count, rep_coverage, union_parts) -> None:
    """Host-side selection for the reps whose demand-sized width exceeds
    the fused pass's k: pull their masked score rows and argpartition
    (shortlist membership on score ties is numpy's, as in the reference).
    Overwrites the fused stats of those reps."""
    wide = np.flatnonzero(k_eff > k)
    n_pad = int(rows.idle.shape[0])
    for lo in range(0, wide.size, WIDE_BLOCK):
        sel = wide[lo:lo + WIDE_BLOCK]
        req, static, mask = rows.take(sel)
        masked = score_rows(req, rows.idle, rows.alloc, static, mask,
                            weights).cpu().numpy()
        for j in range(sel.shape[0]):
            r = int(sel[j])
            row = masked[j]
            live_full = row > NEG * 0.5
            feas = int(live_full.sum())
            rep_feasible[r] = feas
            if feas == 0:
                rep_count[r] = 0
                rep_coverage[r] = 1.0
                continue
            minf = row[live_full].min()
            shifted_total = float((row[live_full] - minf).sum())
            ke = int(min(k_eff[r], n_pad))
            if ke >= n_pad:
                cand = np.arange(n_pad)
            else:
                cand = np.argpartition(row, n_pad - ke)[n_pad - ke:]
            cand = cand[row[cand] > NEG * 0.5]
            rep_count[r] = int(cand.shape[0])
            if shifted_total > 0.0:
                rep_coverage[r] = float(
                    np.maximum(row[cand] - minf, 0.0).sum()
                    / shifted_total)
            else:
                rep_coverage[r] = 1.0
            if cand.size:
                union_parts.append(np.unique(cand.astype(np.int64)))


def _build_pairs(batch):
    """The (group, slot) pairs shortlists are distilled for: one per real
    group without slot tensors; one per distinct (group, domain row) among
    valid tasks with them. Returns (pair_g, pair_s or None, pair_of_task)."""
    n_tasks = len(batch.tasks)
    tg = np.asarray(batch.task_group[:n_tasks], np.int64)
    valid = np.asarray(batch.task_valid[:n_tasks], bool)
    if batch.task_slot is None or batch.slot_rows is None:
        n_groups = int(batch.n_groups)
        pair_g = np.arange(n_groups, dtype=np.int32)
        pair_of_task = np.where(
            valid & (tg < n_groups), tg, -1).astype(np.int32)
        return pair_g, None, pair_of_task
    ts = np.asarray(batch.task_slot[:n_tasks], np.int64)
    keys = np.stack([tg[valid], ts[valid]], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    pair_of_task = np.full(n_tasks, -1, np.int32)
    pair_of_task[valid] = inv.reshape(-1).astype(np.int32)
    return uniq[:, 0].astype(np.int32), uniq[:, 1].astype(np.int32), \
        pair_of_task


def _dedupe_reps(batch, pair_g, pair_s):
    """Exact pair dedupe under the solver's license (identical request
    rows imply identical mask and score rows when no mask or score
    contribution beyond the capability fit ran): representatives keyed on
    (request-row bytes, slot). Returns (rep_g, rep_s, rep_of_pair)."""
    keys: Dict[tuple, int] = {}
    rep_of_pair = np.zeros(pair_g.shape[0], np.int64)
    rep_rows: List[int] = []
    req = np.asarray(batch.group_req)
    for p in range(pair_g.shape[0]):
        s = int(pair_s[p]) if pair_s is not None else -1
        key = (req[pair_g[p]].tobytes(), s)
        r = keys.get(key)
        if r is None:
            r = len(rep_rows)
            keys[key] = r
            rep_rows.append(p)
        rep_of_pair[p] = r
    rep_idx = np.asarray(rep_rows, np.int64)
    rep_g = pair_g[rep_idx]
    rep_s = pair_s[rep_idx] if pair_s is not None else None
    return rep_g, rep_s, rep_of_pair


def distill(batch, narr, gmask: torch.Tensor, static_score: torch.Tensor,
            weights: ScoreWeights, conf: PruneConf,
            dedupe: bool = False) -> PruneContext:
    """Distill per-pair shortlists from the [G, N] static mask ``gmask``
    and score ``static_score`` (on one device, with ``weights``) and
    reduce them to the union of candidate nodes. ``batch`` and ``narr``
    are the place's TaskBatch and NodeArrays. ``dedupe`` (granted by the
    solver only when mask and score rows are a function of the request
    row) collapses identical pairs onto one representative. The caller
    applies the guards and the union gather."""
    n_real = len(narr.names)
    n_pad = int(narr.idle.shape[0])
    k = min(int(conf.k), n_pad)
    pair_g, pair_s, pair_of_task = _build_pairs(batch)
    n_pairs = int(pair_g.shape[0])
    if n_pairs == 0:
        ctx = PruneContext(conf, k, n_real, n_pad, pair_g, pair_s,
                           pair_of_task, np.zeros(0, np.int64),
                           np.zeros(0, np.int64), np.zeros(0, np.float32))
        ctx.set_union(np.zeros(0, np.int64))
        return ctx

    if dedupe:
        rep_g, rep_s, rep_of_pair = _dedupe_reps(batch, pair_g, pair_s)
    else:
        rep_g, rep_s = pair_g, pair_s
        rep_of_pair = np.arange(n_pairs, dtype=np.int64)
    n_reps = int(rep_g.shape[0])
    k_eff = _demand_k(conf, batch, narr, rep_g, rep_of_pair, pair_of_task,
                      n_pairs, k, n_pad)
    rows = _Rows(batch, narr, gmask, static_score, rep_g, rep_s)

    rep_feasible = np.zeros(n_reps, np.int64)
    rep_count = np.zeros(n_reps, np.int64)
    rep_coverage = np.ones(n_reps, np.float32)
    union_parts: List[np.ndarray] = []
    for lo in range(0, n_reps, PAIR_BLOCK):
        reps = np.arange(lo, min(lo + PAIR_BLOCK, n_reps))
        req, static, mask = rows.take(reps)
        feas, vals, idx, cov = explain.fused(req, rows.idle, rows.alloc,
                                             static, mask, weights, k)
        vals = vals.cpu().numpy()
        idx = idx.cpu().numpy()
        live = vals > NEG * 0.5
        rep_feasible[reps] = feas.cpu().numpy()
        rep_count[reps] = live.sum(axis=1)
        rep_coverage[reps] = cov.cpu().numpy()
        if live.any():
            union_parts.append(np.unique(idx[live]))

    # demand-sized widths past k: the host-side argpartition extension
    # (overwrites those reps' stats; their fused top-k joined the union
    # above and stays in it)
    _extend_wide_reps(rows, weights, k_eff, k, rep_feasible, rep_count,
                      rep_coverage, union_parts)

    ctx = PruneContext(conf, k, n_real, n_pad, pair_g, pair_s, pair_of_task,
                       rep_feasible[rep_of_pair], rep_count[rep_of_pair],
                       rep_coverage[rep_of_pair])
    ctx.k_max = int(k_eff.max()) if k_eff.size else k
    union = np.unique(np.concatenate(union_parts)) if union_parts \
        else np.zeros(0, np.int64)
    # candidates land on real rows only (padding columns are masked false
    # before the top-k), but clip as the reference does
    union = union[(union >= 0) & (union < n_pad)]
    ctx.set_union(union)
    return ctx
