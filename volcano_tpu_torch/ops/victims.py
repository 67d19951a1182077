"""Vectorized victim selection for preempt/reclaim (the port's own copy of
volcano_tpu/ops/victims.py, in numpy on the host).

The reference's preempt walk runs the plugin victim chain per visited
node and pops victims one by one (preempt.go:192-271, reclaim.go:114-182)
— a per-candidate Python loop. framework/victims.py already batched the
*encode* and made the walk lazy; this module replaces the walk itself
for the builtin plugin sets: every candidate victim is scored task x
node in ONE vectorized pass —

* per-victim channels: the victim job's priority TIER, its gang
  allowance (evicting a member of a gang sitting at ``min_available``
  is priced as breaking the whole gang — such members are simply not
  admissible, the gang plugin's rule), the resources a victim prefix
  RECOVERS vs the preemptor's request (the smallest-feasible-prefix
  cumsum of ops/preempt.py);
* plugin acceptance compiled to array ops per tier with the reference's
  first-non-empty-tier dispatch (session._victims_dispatch) applied
  node-wise;
* node choice = highest score, ties to the lowest node index — exactly
  the Python walk's best-first visit order, so results are
  bit-identical (tests/test_constraints.py pins kernel-vs-Python parity
  on preemption storms, and the seeded/stable tie-breaks carry over
  unchanged).

Supported plugin sets (anything else takes the Python walk, which stays
the reference implementation):

* preempt:  {priority, gang, conformance}
* reclaim:  {gang, conformance, proportion}

drf's what-if share tree is deliberately NOT vectorized — its
acceptance depends on a running cluster-wide simulation that has no
closed per-victim form.

The torch forms over a preemptor batch (``victim_prefix_batch`` /
``reclaim_prefix_batch``) live in ops/preempt.py; the in-action path uses
this module's numpy forms — the action applies evictions between
preemptors, so batching across preemptors would change its answers.
While the explainer is on (the solver's ``explain``), each decision is
recorded by trace/explain.py:record_victims (``_record_explain``); each
selection counts on volcano_victim_select_runs_total{mode="kernel"}.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..metrics import metrics as m
from ..plugins.conformance import is_critical
from .preempt import pack_node_major

PREEMPT_VECTORIZABLE = frozenset({"priority", "gang", "conformance"})
RECLAIM_VECTORIZABLE = frozenset({"gang", "conformance", "proportion"})

class _PreemptView:
    """Incrementally-maintained acceptance state for one preempt
    (mode, preemptor-job, queue) key.

    The Python walk amortizes across a job's preemptor tasks through its
    resumed-walk and rejection caches; a kernel that recomputes the full
    acceptance pass per place() call loses that race even though each
    pass is vectorized. This view makes the kernel's steady-state cost
    O(affected) instead of O(candidates): the builtin preempt chain
    {priority, gang, conformance} never reads the preemptor's REQUEST,
    so acceptance is a pure function of (mode, pj, pq) and the live
    victim set — an eviction invalidates only the evicted job's gang
    ranks and the touched nodes' packs, which `refresh` recomputes
    exactly as a from-scratch pass would (the parity tests pin this).
    """

    __slots__ = ("rows", "node_of", "job_of", "local", "live",
                 "accept", "per_name", "seg_lo", "seg_hi", "counts",
                 "total", "dirty_jobs", "dead", "by_job",
                 "serve_key", "serve_order", "serve_rejected",
                 "serve_ptr", "log_pos", "gang_allpass")

    def __init__(self):
        self.dirty_jobs: set = set()
        self.dead: List[Tuple[int, bool]] = []   # (local, live flag)
        self.by_job: Dict[int, np.ndarray] = {}  # jc -> ascending locals
        self.log_pos = 0          # consumed prefix of the kernel event log
        # jc -> upper bound on the job's per-(node, job)-segment gang
        # rank + 1, recorded at the last full re-rank: while the live
        # allowance stays >= this bound, an eviction can only flip the
        # dead row itself (segment-mates' ranks only shrink) — the O(1)
        # steady-state refresh
        self.gang_allpass: Dict[int, int] = {}
        # serve state (the kernel twin of the walk's resumed order +
        # persistent per-node rejection): the static score-sorted node
        # order is scanned from a resume pointer to the first feasible
        # node; a failing node is marked rejected — sound, not just a
        # heuristic, because without an evict/pipeline/rollback event on
        # a node (all of which clear its flag) its feasibility is
        # monotone non-increasing within the action
        self.serve_key: Optional[tuple] = None
        self.serve_order: Optional[list] = None
        self.serve_rejected: Optional[np.ndarray] = None
        self.serve_ptr = 0


class VictimKernel:
    """Per-PreemptContext vectorized victim-selection state.

    Built once per action execution from the VictimIndex. Preempt modes
    keep a per-(mode, preemptor-job) `_PreemptView` — plugin acceptance
    and per-node totals maintained incrementally across place() calls,
    with node choice a single masked argmax (highest score, ties to the
    lowest node index — the walk's best-first visit order) and the
    smallest-feasible-prefix walk run only on the winning node. Reclaim
    (CROSS_QUEUE) recomputes per call: proportion's acceptance depends
    on the reclaimer's request and the live queue budgets, so there is
    no request-independent state to maintain.
    """

    def __init__(self, ctx):
        from ..framework.victims import CROSS_QUEUE
        self._CQ = CROSS_QUEUE
        self.ctx = ctx
        self._explain_cached: Optional[bool] = None
        ssn = ctx.ssn
        vi = ctx.victims
        mv = len(vi.tasks)
        # --- static per-victim channels ---------------------------------
        # victim job per code (live gang occupancy reads go through these)
        code_of_job: Dict[str, int] = vi.job_code
        self.jobs_by_code: List = [None] * max(1, len(code_of_job))
        for uid, c in code_of_job.items():
            self.jobs_by_code[c] = ssn.jobs.get(uid)
        self.job_prio = np.array(
            [j.priority if j is not None else 0 for j in self.jobs_by_code],
            np.int64)
        # candidates whose job vanished from the session: the priority
        # plugin's explicit jobs.get() guard rejects them (gang rejects
        # them too, via a zero allowance)
        self.job_missing = np.array(
            [j is None for j in self.jobs_by_code], bool)
        self.job_minav = np.array(
            [j.min_available if j is not None else 0
             for j in self.jobs_by_code], np.int64)
        self.critical = np.zeros(mv, bool)
        for v, t in enumerate(vi.tasks):
            self.critical[v] = is_critical(t)
        self.queue_names = [""] * max(1, len(vi.queue_code))
        for name, c in vi.queue_code.items():
            self.queue_names[c] = name
        # --- tier structure (the _victims_dispatch chain) ---------------
        self.preempt_tiers = self._tier_chain(ssn, "enabledPreemptable",
                                              ssn.preemptable_fns)
        self.reclaim_tiers = self._tier_chain(ssn, "enabledReclaimable",
                                              ssn.reclaimable_fns)
        self.preempt_ok = all(set(names) <= PREEMPT_VECTORIZABLE
                              for _, names in self.preempt_tiers)
        self.reclaim_ok = all(set(names) <= RECLAIM_VECTORIZABLE
                              for _, names in self.reclaim_tiers)
        self.n_real = len(ctx.narr.names)
        # CROSS_QUEUE multi-step walk memory (consumed nodes), keyed by
        # the reclaimer; reset on rollback / pipeline invalidation
        self.visited_key: Optional[tuple] = None
        self.visited: Optional[np.ndarray] = None
        # preempt-mode incremental views, keyed (mode, pj, pq); kept
        # exact across evictions AND rollbacks via note_evict/note_revive.
        # A preemptor job with NO rows in the victim index (the pending-
        # gang burst shape) shares one view per (mode, pq, priority):
        # its pj-exclusion excludes nothing and the preempt chain reads
        # nothing else of the preemptor, so the view — including its
        # serve cache — is identical across every such preemptor.
        self._views: Dict[tuple, _PreemptView] = {}
        self._job_rows = np.bincount(
            vi.job_of, minlength=len(self.jobs_by_code)) \
            if len(vi.tasks) else np.zeros(len(self.jobs_by_code),
                                           np.int64)
        # shared invalidation log (rows evicted/revived, nodes whose
        # future/pods moved); each view consumes its un-seen tail lazily
        self._event_log: List[tuple] = []
        # live per-job ready counts, refreshed lazily for dirty jobs only
        # (the gang allowance input; a full listcomp per acceptance pass
        # was the dominant build cost)
        self._ready: Optional[np.ndarray] = None
        self._ready_dirty: set = set()

    @staticmethod
    def _tier_chain(ssn, flag: str, fn_map) -> List[Tuple[int, List[str]]]:
        by_tier: Dict[int, List[str]] = {}
        for ti, tier in enumerate(ssn.tiers):
            for opt in tier.plugins:
                if opt.is_enabled(flag) and opt.name in fn_map:
                    by_tier.setdefault(ti, []).append(opt.name)
        return sorted(by_tier.items())

    def supports(self, mode: str) -> bool:
        return self.reclaim_ok if mode == self._CQ else self.preempt_ok

    # -- decision provenance (trace/explain.py) -----------------------------

    def _explain_on(self) -> bool:
        """The session solver's explain switch, read once: place() runs
        per preemptor on the action's hot path."""
        if self._explain_cached is None:
            solver = getattr(self.ctx.ssn, "solver", None)
            self._explain_cached = bool(getattr(solver, "explain", False))
        return self._explain_cached

    _VERDICT_CAP = 64   # per-victim verdict rows kept per decision

    def _record_explain(self, preemptor, mode: str, tiers, best: int,
                        rows_all, per_name: Dict[str, np.ndarray],
                        live, seg_rows, selected_rows, victims,
                        covered: bool) -> None:
        """One victim decision into the explain registry: the tier chain,
        per-plugin admissible counts over the candidate set, and the
        winning node's per-victim verdicts. ``seg_rows`` are the winning
        node's candidate indices into ``rows_all``'s index space
        (``per_name`` and ``live`` are indexed the same way)."""
        from ..trace import explain
        vi = self.ctx.victims
        live_arr = live if live is not None else np.ones(len(rows_all),
                                                         bool)
        admissible = {nm: int((arr & live_arr).sum())
                      for nm, arr in per_name.items()}
        winning_tier = None
        for tier_idx, names in tiers:
            acc = live_arr[seg_rows].copy()
            for nm in names:
                arr = per_name.get(nm)
                acc &= arr[seg_rows] if arr is not None else False
            if acc.any():
                winning_tier = int(tier_idx)
                break
        sel_set = set(int(r) for r in selected_rows)
        verdicts = []
        for off in seg_rows[:self._VERDICT_CAP]:
            off = int(off)
            row = int(rows_all[off])
            t = vi.tasks[row]
            verdicts.append({
                "task": f"{t.namespace}/{t.name}",
                "live": bool(live_arr[off]),
                "verdicts": {nm: bool(arr[off])
                             for nm, arr in per_name.items()},
                "selected": row in sel_set,
            })
        explain.record_victims(
            f"{preemptor.namespace}/{preemptor.name}", mode,
            self.ctx.narr.names[best], tiers, admissible,
            len(rows_all), winning_tier,
            [f"{v.namespace}/{v.name}" for v in victims], verdicts,
            covered)

    def reset_walk(self) -> None:
        """Reset the CROSS_QUEUE multi-step walk memory and the views'
        serve rejections (a rollback restored state wholesale). Preempt
        views' acceptance stays — it is kept exact through
        note_evict/note_revive."""
        self.visited_key = None
        self.visited = None
        for view in self._views.values():
            if view.serve_rejected is not None:
                view.serve_rejected[:] = False
                view.serve_ptr = 0

    def _gmask_h(self, g: int) -> int:
        """Content id of the group's predicate-mask row (the context's
        interning cache): serve state keyed on it survives the per-job
        group-index rotation of identical jobs."""
        ctx = self.ctx
        h = ctx._gmask_hash.get(g)
        if h is None:
            row = ctx.gmask[g].tobytes()
            h = ctx._gmask_intern.setdefault(row, len(ctx._gmask_intern))
            ctx._gmask_hash[g] = h
        return h

    def _note(self, row: Optional[int], live: bool) -> None:
        if row is None:
            return
        jc = int(self.ctx.victims.job_of[row])
        self._ready_dirty.add(jc)
        # views consume the shared log lazily at their next place() —
        # a push loop over every live view per eviction dominated the
        # kernel's A/B profile
        self._event_log.append((row, live))

    def _consume(self, view: _PreemptView) -> None:
        """Fold the un-consumed tail of the shared event log into this
        view: row events queue exact dead/dirty-job invalidations (when
        the view holds the row) and stale the row's node for every view
        (the node's future idle is shared state); node events stale the
        node."""
        log = self._event_log
        if view.log_pos >= len(log):
            return
        vi = self.ctx.victims
        rej = view.serve_rejected
        if rej is not None and len(self.preempt_tiers) > 1:
            # the tier dispatch couples nodes: an eviction on node A can
            # shrink a job's tier-1 acceptance on node B, ACTIVATING B's
            # tier-2 rows and growing its totals — the per-node
            # monotonicity the rejection flags rely on only holds for
            # the single-tier chain, so any event resets them wholesale
            rej[:] = False
            view.serve_ptr = 0
            rej = None   # skip the per-event clearing below
        for ev, arg in log[view.log_pos:]:
            if arg is None:
                b = ev        # node event (pipeline apply / rollback)
            else:
                row = ev
                b = int(vi.node_of[row])
                local = int(view.local[row]) \
                    if row < len(view.local) else -1
                if local >= 0:
                    view.dead.append((local, arg))
                    view.dirty_jobs.add(int(vi.job_of[row]))
            # the node's state moved: its serve rejection (if any) no
            # longer follows from the monotonicity argument
            if rej is not None and b < len(rej) and rej[b]:
                rej[b] = False
                view.serve_ptr = 0
        view.log_pos = len(log)

    def note_evict(self, row: Optional[int]) -> None:
        """A victim died (eviction applied or mark_dead): queue the exact
        invalidation for every view holding it — processed lazily at the
        next place() so the job's post-evict ready count is read AFTER
        the session status flip."""
        self._note(row, False)

    def note_revive(self, row: Optional[int]) -> None:
        """A rollback revived a victim: the symmetric invalidation."""
        self._note(row, True)

    def note_node(self, i: Optional[int]) -> None:
        """Node ``i``'s state (future idle / pod count) changed outside
        the eviction bookkeeping — a pipeline apply or its rollback.
        Every view's serve cache must re-derive that node's entry."""
        if i is None:
            return
        self._event_log.append((int(i), None))

    def _ready_vec(self) -> np.ndarray:
        if self._ready is None:
            self._ready = np.array(
                [j.ready_task_num() if j is not None else 0
                 for j in self.jobs_by_code], np.int64)
            self._ready_dirty.clear()
        elif self._ready_dirty:
            for jc in self._ready_dirty:
                job = self.jobs_by_code[jc]
                self._ready[jc] = job.ready_task_num() \
                    if job is not None else 0
            self._ready_dirty.clear()
        return self._ready

    # -- acceptance ---------------------------------------------------------

    def _structural_rows(self, mode: str, pj: int, pq: int) -> np.ndarray:
        """Alive candidates passing the mode's structural filter (the
        node_candidates() selection over the whole index at once)."""
        from ..framework.victims import CROSS_QUEUE, INTER_JOB, INTRA_JOB
        vi = self.ctx.victims
        sel = vi.alive.copy()
        if mode == INTER_JOB:
            sel &= (vi.queue_of == pq) & (vi.job_of != pj)
        elif mode == INTRA_JOB:
            sel &= vi.job_of == pj
        else:
            assert mode == CROSS_QUEUE
            sel &= vi.queue_of != pq
            if len(vi.q_reclaimable):
                sel &= vi.q_reclaimable[vi.queue_of]
        return np.flatnonzero(sel)

    def _dispatch(self, tiers, per_name: Dict[str, np.ndarray],
                  node_of: np.ndarray,
                  sel: Optional[np.ndarray] = None) -> np.ndarray:
        """First-non-empty-tier dispatch applied node-wise over the given
        rows (or the ``sel`` subset — dispatch is per node, so running it
        over any union of whole node segments is exact)."""
        idx = np.arange(len(node_of)) if sel is None else sel
        nodes = node_of[idx]
        final = np.zeros(len(idx), bool)
        undecided = np.ones(self.n_real, bool)
        for _, names in tiers:
            acc = np.ones(len(idx), bool)
            for name in names:
                acc &= per_name[name][idx]
            node_any = np.zeros(self.n_real, bool)
            if acc.any():
                node_any[nodes[acc]] = True
            take = undecided & node_any
            if take.any():
                final |= acc & take[nodes]
                undecided &= ~node_any
        if sel is None:
            return final
        out = np.zeros(len(node_of), bool)
        out[idx] = final
        return out

    def _accept(self, mode: str, rows: np.ndarray, preemptor,
                req: np.ndarray, want_parts: bool = False):
        """[len(rows)] bool: the per-tier plugin chain, vectorized, with
        first-non-empty-tier dispatch applied per node. With
        ``want_parts``, also returns the per-plugin acceptance arrays
        (the view's recombine inputs)."""
        from ..framework.victims import CROSS_QUEUE
        ctx = self.ctx
        vi = ctx.victims
        ssn = ctx.ssn
        node_of = vi.node_of[rows]
        job_of = vi.job_of[rows]
        tiers = self.reclaim_tiers if mode == CROSS_QUEUE \
            else self.preempt_tiers
        if not tiers:
            return np.zeros(len(rows), bool)

        def _segments(key: np.ndarray):
            """(order, seg_start) for a stable sort by ``key``: rows of a
            segment stay in eviction order, seg_start[i] is the sorted
            index where row i's segment begins."""
            order = np.argsort(key, kind="stable")
            sk = key[order]
            seg_start = np.zeros(len(sk), np.int64)
            new_seg = np.flatnonzero(np.diff(sk)) + 1
            seg_start[new_seg] = new_seg
            np.maximum.accumulate(seg_start, out=seg_start)
            return order, seg_start

        # gang: rank of each candidate within its (node, job) segment in
        # eviction order vs the job's LIVE allowance (ready - min_avail —
        # the gang-integrity price: members of a gang at min_available
        # are inadmissible, so evicting into gang collapse never happens)
        def gang_accept() -> np.ndarray:
            if not len(rows):
                return np.zeros(0, bool)
            allowance = np.maximum(self._ready_vec() - self.job_minav, 0)
            jmax = int(job_of.max()) + 1 if len(job_of) else 1
            order, seg_start = _segments(
                node_of.astype(np.int64) * jmax + job_of)
            rank = np.empty(len(order), np.int64)
            rank[order] = np.arange(len(order)) - seg_start
            return rank < allowance[job_of]

        # proportion (reclaim): acceptance depends only on the queue's
        # RUNNING allocated (candidate resources are subtracted on
        # accept, and both reject conditions leave it untouched), so per
        # (node, queue) segment the accepted set is the maximal prefix
        # over which "allocated above deserved AND not short of the
        # reclaimer's request" holds (proportion.go:211-236)
        def proportion_accept() -> np.ndarray:
            if not len(rows):
                return np.zeros(0, bool)
            rindex = ctx.rindex
            qn = len(self.queue_names)
            q_alloc = np.zeros((qn, rindex.r), np.float64)
            q_deserved = np.full((qn, rindex.r), np.inf, np.float64)
            q_known = np.zeros(qn, bool)
            for qc, qname in enumerate(self.queue_names):
                for fn in ssn.solver.queue_budget_fns:
                    budget = fn(qname, rindex)
                    if budget is not None:
                        q_alloc[qc], q_deserved[qc] = budget
                        q_known[qc] = True
                        break
            queue_of = vi.queue_of[rows]
            order, seg_start = _segments(
                node_of.astype(np.int64) * (qn + 1) + queue_of)
            res_s = vi.res[rows][order].astype(np.float64)
            qos = queue_of[order]
            idx = np.arange(len(order))
            cum0 = np.concatenate(
                [np.zeros((1, rindex.r)), np.cumsum(res_s, axis=0)], axis=0)
            prior = cum0[idx] - cum0[seg_start]   # prefix sum before row
            running = q_alloc[qos] - prior
            eps = rindex.eps
            cond = q_known[qos] \
                & ~np.all(running <= q_deserved[qos] + eps[None, :], axis=1) \
                & ~np.any(running < req[None, :], axis=1)
            # prefix: accepted iff cond holds here AND at every earlier
            # in-segment row (count of blocked rows before == at segment
            # start)
            blocked0 = np.concatenate([[0], np.cumsum(~cond)])
            accept_sorted = cond & (blocked0[idx] == blocked0[seg_start])
            accept = np.empty(len(order), bool)
            accept[order] = accept_sorted
            return accept

        preemptor_job = ssn.jobs.get(preemptor.job)
        p_prio = preemptor_job.priority if preemptor_job is not None else 0

        per_name: Dict[str, np.ndarray] = {}

        def plugin_accept(name: str) -> np.ndarray:
            cached = per_name.get(name)
            if cached is not None:
                return cached
            if name == "priority":
                # a preemptor with no session job yields an EMPTY victim
                # set in the reference (tier veto), not an all-pass
                if preemptor_job is None:
                    out = np.zeros(len(rows), bool)
                else:
                    out = (self.job_prio[job_of] < p_prio) \
                        & ~self.job_missing[job_of]
            elif name == "conformance":
                out = ~self.critical[rows]
            elif name == "gang":
                out = gang_accept()
            elif name == "proportion":
                out = proportion_accept()
            else:   # unreachable behind supports()
                raise RuntimeError(f"unvectorized plugin {name}")
            per_name[name] = out
            return out

        for _, names in tiers:
            for name in names:
                plugin_accept(name)
        final = self._dispatch(tiers, per_name, node_of)
        if want_parts:
            return final, per_name
        return final

    # -- preempt-mode incremental views -------------------------------------

    def _recount(self, view: _PreemptView, nodes) -> None:
        """Per-node accepted-victim counts + resource totals; ``nodes``
        None rebuilds every row, else only the given node list."""
        vi = self.ctx.victims
        r = self.ctx.rindex.r
        ok = view.accept & view.live
        if nodes is None:
            idx = np.flatnonzero(ok)
            view.counts = np.bincount(
                view.node_of[idx], minlength=self.n_real)[:self.n_real]
            view.total = np.zeros((self.n_real, r), np.float64)
            if len(idx):
                np.add.at(view.total, view.node_of[idx],
                          vi.res[view.rows[idx]].astype(np.float64))
            return
        for b in nodes:
            lo, hi = int(view.seg_lo[b]), int(view.seg_hi[b])
            sel = np.flatnonzero(ok[lo:hi]) + lo
            view.counts[b] = len(sel)
            view.total[b] = vi.res[view.rows[sel]].astype(
                np.float64).sum(axis=0) if len(sel) else 0.0

    def _refresh(self, view: _PreemptView) -> None:
        """Apply the queued invalidations exactly as a from-scratch pass
        at the current state would: dead rows drop out, the dirty jobs'
        gang ranks re-rank among their LIVE rows against the job's
        post-evict allowance, and the touched nodes' tier dispatch +
        packs recombine.

        Per-eviction cost is O(affected rows): the dirty job's locals
        come from the view's per-job index and the recombine touches
        only the affected nodes' (small) segments — a whole-index numpy
        sweep per eviction was what made the kernel LOSE the A/B race
        against the Python walk's rejection caches."""
        vi = self.ctx.victims
        if len(self.preempt_tiers) == 1:
            # single-tier chain (the common conf): acceptance is a plain
            # AND, so every dirty job's rows re-derive in one pure-Python
            # pass over its (gang-sized) locals with O(1) flip detection
            names = self.preempt_tiers[0][1]
            per = view.per_name
            others = [per[nm] for nm in names
                      if nm != "gang" and nm in per]
            gang = per.get("gang")
            dead_by_job: Dict[int, list] = {}
            revived = set()
            for local, live in view.dead:
                view.live[local] = live
                jcd = int(view.job_of[local])
                dead_by_job.setdefault(jcd, []).append(local)
                if live:
                    revived.add(jcd)
            view.dead.clear()
            dirty_nodes = set()
            for jc in view.dirty_jobs:
                lj = view.by_job.get(jc)
                if lj is None:
                    continue
                job = self.jobs_by_code[jc]
                allowance = max((job.ready_task_num() if job is not None
                                 else 0) - int(self.job_minav[jc]), 0)
                if gang is not None and jc not in revived \
                        and allowance >= view.gang_allpass.get(jc,
                                                               1 << 30):
                    # every occupied rank still passes and nothing came
                    # back alive: only the dead rows' own accepts flip
                    # (surviving segment-mates' ranks only shrink)
                    for li in dead_by_job.get(jc, ()):
                        gang[li] = False
                        if view.accept[li]:
                            view.accept[li] = False
                            dirty_nodes.add(int(view.node_of[li]))
                    continue
                alive = view.live[lj]
                nodes_j = view.node_of[lj]
                if gang is not None:
                    # locals are ascending == node-major: rank live rows
                    # within each node run, in eviction order (small
                    # vectorized pass — a scalar loop here ran once per
                    # eviction and showed up in the A/B profile)
                    run_start = np.empty(len(lj), bool)
                    run_start[0] = True
                    np.not_equal(nodes_j[1:], nodes_j[:-1],
                                 out=run_start[1:])
                    prev = np.cumsum(alive) - alive   # exclusive live count
                    seg_base = np.maximum.accumulate(
                        np.where(run_start, prev, 0))
                    rank = prev - seg_base
                    acc = alive & (rank < allowance)
                    gang[lj] = acc
                    # the occupied-rank bound (ranks only shrink as rows
                    # die, so this stays an upper bound until a revive)
                    view.gang_allpass[jc] = \
                        int(np.max(np.where(alive, rank, 0))) + 1 \
                        if alive.any() else 1
                else:
                    acc = alive
                for o in others:
                    acc = acc & o[lj]
                diff = view.accept[lj] != acc
                if diff.any():
                    view.accept[lj] = acc
                    dirty_nodes.update(nodes_j[diff].tolist())
            view.dirty_jobs.clear()
            for b in dirty_nodes:
                lo, hi = int(view.seg_lo[b]), int(view.seg_hi[b])
                sel = np.flatnonzero(view.accept[lo:hi])
                view.counts[b] = len(sel)
                view.total[b] = vi.res[view.rows[lo + sel]].astype(
                    np.float64).sum(axis=0) if len(sel) else 0.0
            return
        # general multi-tier path: per-node recombine over the affected
        # segments (the tier dispatch is per node — first tier with any
        # live accepted row on that node wins, _dispatch's semantics on
        # a segment slice)
        affected = set()
        for local, live in view.dead:
            view.live[local] = live
            affected.add(int(view.node_of[local]))
        view.dead.clear()
        gang = view.per_name.get("gang")
        for jc in view.dirty_jobs:
            locals_j = view.by_job.get(jc)
            if locals_j is None:
                continue
            job = self.jobs_by_code[jc]
            allowance = max((job.ready_task_num() if job is not None
                             else 0) - int(self.job_minav[jc]), 0)
            rank = 0
            prev_node = -1
            for li in locals_j:
                li = int(li)
                b = int(view.node_of[li])
                affected.add(b)
                if gang is None:
                    continue
                if not view.live[li]:
                    gang[li] = False
                    continue
                if b != prev_node:
                    prev_node = b
                    rank = 0
                gang[li] = rank < allowance
                rank += 1
        view.dirty_jobs.clear()
        if not affected:
            return
        for b in sorted(affected):
            lo, hi = int(view.seg_lo[b]), int(view.seg_hi[b])
            if lo >= hi:
                continue
            live = view.live[lo:hi]
            final = np.zeros(hi - lo, bool)
            for _, names in self.preempt_tiers:
                acc = live.copy()
                for name in names:
                    acc &= view.per_name[name][lo:hi]
                if acc.any():
                    final = acc
                    break
            view.accept[lo:hi] = final
            sel = np.flatnonzero(final)
            view.counts[b] = len(sel)
            view.total[b] = vi.res[view.rows[lo + sel]].astype(
                np.float64).sum(axis=0) if len(sel) else 0.0

    def _view(self, mode: str, pj: int, pq: int, preemptor,
              req: np.ndarray) -> _PreemptView:
        if pj < 0 or (pj < len(self._job_rows)
                      and self._job_rows[pj] == 0):
            # row-less preemptor job: the view (and serve cache) is
            # preemptor-independent up to the priority plugin's inputs
            pjob = self.ctx.ssn.jobs.get(preemptor.job)
            key = (mode, -1, pq,
                   pjob.priority if pjob is not None else None)
        else:
            key = (mode, pj, pq)
        view = self._views.get(key)
        if view is not None:
            self._consume(view)
            if view.dead or view.dirty_jobs:
                self._refresh(view)
            return view
        view = _PreemptView()
        view.log_pos = len(self._event_log)   # fresh build = current truth
        vi = self.ctx.victims
        rows = self._structural_rows(mode, pj, pq)
        view.rows = rows
        view.node_of = vi.node_of[rows]
        view.job_of = vi.job_of[rows]
        view.local = np.full(len(vi.tasks), -1, np.int64)
        view.local[rows] = np.arange(len(rows))
        view.live = np.ones(len(rows), bool)
        if len(rows):
            # per-job locals index (stable sort keeps locals ascending,
            # i.e. node-major within each job) — the _refresh seek
            order = np.argsort(view.job_of, kind="stable")
            jo = view.job_of[order]
            splits = np.flatnonzero(np.diff(jo)) + 1
            view.by_job = {
                int(seg_jo[0]): seg
                for seg, seg_jo in zip(np.split(order, splits),
                                       np.split(jo, splits))}
        if len(rows):
            view.accept, view.per_name = self._accept(
                mode, rows, preemptor, req, want_parts=True)
        else:
            view.accept, view.per_name = np.zeros(0, bool), {}
        view.seg_lo = np.searchsorted(view.node_of, np.arange(self.n_real))
        view.seg_hi = np.searchsorted(view.node_of,
                                      np.arange(self.n_real) + 1)
        self._recount(view, None)
        self._views[key] = view
        return view

    # -- the place ----------------------------------------------------------

    def place(self, preemptor, mode: str, g: int, pj: int, pq: int,
              req: np.ndarray, score: np.ndarray):
        """The kernel twin of PreemptContext.place's lazy walk: same
        return contract, bit-identical node/victim choice."""
        CROSS_QUEUE = self._CQ
        ctx = self.ctx
        vi = ctx.victims
        n_real = self.n_real
        eps = ctx.eps
        future = ctx.future[:n_real]

        if mode != CROSS_QUEUE:
            # the preempt chain never reads the request, so acceptance
            # rides the incremental view; feasibility is the maintained
            # per-node totals (monotone cumsum: a prefix covers iff the
            # full sum does), and the smallest-prefix walk runs only on
            # the winning node (float64 running sums, the walk's scalar
            # form). The masked feasible-score vector is CACHED per
            # (group, request) and patched per stale node — a full [N]
            # recompute per place() lost the A/B race against the walk's
            # resumed-walk caches even though each pass was vectorized.
            view = self._view(mode, pj, pq, preemptor, req)
            # Serve = the first currently-feasible node of a STATIC
            # score-sorted order (descending score, stable → ties to
            # the lowest node index, exactly np.argmax's pick over the
            # masked vector). The order is keyed on request bytes + the
            # score ARRAY identity (the framework's _score_cache hands
            # back the same object for the same (req, static-row)
            # content, so identity implies value-equality); per-node
            # feasibility is derived fresh at visit time from the
            # maintained counts/totals — the walk's own sorted-resume
            # trick, with no cache-invalidation protocol to maintain.
            rkey = (req.tobytes(), id(score), self._gmask_h(g))
            order = view.serve_order
            if order is None or view.serve_key != rkey:
                order = np.argsort(-score[:n_real],
                                   kind="stable").tolist()
                view.serve_order = order
                view.serve_key = rkey
                view.serve_rejected = np.zeros(n_real, bool)
                view.serve_ptr = 0
            rejected = view.serve_rejected
            static_ok = ctx.gmask[g]
            counts = view.counts
            total = view.total
            max_t = ctx.max_tasks
            n_t = ctx.n_tasks
            rr = req.shape[0]
            reqf = [float(req[r]) for r in range(rr)]
            epsf = [float(eps[r]) for r in range(rr)]
            n_ord = len(order)
            ptr = view.serve_ptr
            while ptr < n_ord and rejected[order[ptr]]:
                ptr += 1
            view.serve_ptr = ptr
            best = -1
            for i in range(ptr, n_ord):
                b = order[i]
                if rejected[b]:
                    continue
                if counts[b] and static_ok[b] \
                        and (max_t[b] == 0 or n_t[b] < max_t[b]):
                    for r in range(rr):
                        if reqf[r] > float(future[b, r]) \
                                + float(total[b, r]) + epsf[r]:
                            break
                    else:
                        best = b
                        break
                rejected[b] = True
            if best < 0:
                return None
            lo, hi = int(view.seg_lo[best]), int(view.seg_hi[best])
            ok = view.accept[lo:hi] & view.live[lo:hi]
            sel = view.rows[lo:hi][ok]
            victims = [vi.tasks[v] for v in sel]
            # smallest-feasible-prefix walk in scalar f64 (same
            # arithmetic as the array form: f64 running sums over the
            # f32 rows; a numpy reduction per prefix step was measurable
            # at bench scale)
            rr = req.shape[0]
            run = [float(future[best, r]) for r in range(rr)]
            reqf = [float(req[r]) for r in range(rr)]
            epsf = [float(eps[r]) for r in range(rr)]
            k = len(victims)
            for p in range(len(victims) + 1):
                if all(reqf[r] <= run[r] + epsf[r] for r in range(rr)):
                    k = p
                    break
                if p < len(victims):
                    row = vi.res[sel[p]]
                    for r in range(rr):
                        run[r] += float(row[r])
            m.inc(m.VICTIM_SELECT_RUNS, mode="kernel")
            if self._explain_on():
                self._record_explain(
                    preemptor, mode, self.preempt_tiers, best, view.rows,
                    view.per_name, view.live, np.arange(lo, hi), sel[:k],
                    victims[:k], True)
            return ctx.narr.names[best], victims[:k], True

        # CROSS_QUEUE (reclaim): one-shot — proportion's acceptance
        # depends on the reclaimer's request and the live queue budgets
        pods_ok = (ctx.max_tasks[:n_real] == 0) | \
            (ctx.n_tasks[:n_real] < ctx.max_tasks[:n_real])
        rows = self._structural_rows(mode, pj, pq)
        if not len(rows):
            return None
        rows0 = rows
        explain_parts: Optional[Dict[str, np.ndarray]] = None
        if self._explain_on():
            accept, explain_parts = self._accept(mode, rows, preemptor,
                                                 req, want_parts=True)
        else:
            accept = self._accept(mode, rows, preemptor, req)
        rows = rows[accept]
        if not len(rows):
            return None
        # pack accepted victims node-major (already sorted) into [N, V, R]
        vres, vvalid, seg_lo = pack_node_major(vi.node_of[rows],
                                               vi.res[rows], n_real)
        counts = vvalid.sum(axis=1)

        node_ok = ctx.gmask[g][:n_real] & pods_ok & (counts > 0)
        key = (CROSS_QUEUE, preemptor.uid)
        if self.visited_key != key or self.visited is None:
            self.visited_key = key
            self.visited = np.zeros(n_real, bool)
        node_ok &= ~self.visited
        if not node_ok.any():
            return None

        vmask = vvalid[..., None]
        cum = np.cumsum(np.where(vmask, vres, 0.0), axis=1)   # [N,V,R]
        total = cum[:, -1, :]
        validate = np.all(req[None, :] <= future + total + eps[None, :],
                          axis=-1)
        feasible = node_ok & validate
        if not feasible.any():
            return None
        best = int(np.argmax(np.where(feasible, score[:n_real], -np.inf)))
        covers = np.all(req[None, :] <= cum[best] + eps[None, :],
                        axis=-1) & vvalid[best]
        covered = bool(covers.any())
        k = int(np.argmax(covers)) + 1 if covered else int(counts[best])
        self.visited[best] = True

        sel = rows[seg_lo[best]:seg_lo[best] + int(counts[best])]
        victims = [vi.tasks[v] for v in sel]
        m.inc(m.VICTIM_SELECT_RUNS, mode="kernel")
        if explain_parts is not None:
            seg = np.flatnonzero(accept)[seg_lo[best]:
                                         seg_lo[best] + int(counts[best])]
            self._record_explain(
                preemptor, mode, self.reclaim_tiers, best, rows0,
                explain_parts, None, seg, sel[:k], victims[:k], covered)
        return ctx.narr.names[best], victims[:k], covered
