"""Constraint compilation: placement constraints lowered into the solver's
dense task-group x node mask and additive-score inputs, and into the
kernel's per-task topology-domain inputs (the port's own copy of
volcano_tpu/ops/constraints.py).

* **Pod affinity / anti-affinity** (required): the cycle-static inter-pod
  index (plugins/interpod.py) evaluated per constraint-carrying group,
  as mask rows, including the rule that an existing pod's required
  anti-affinity blocks incoming pods it matches.

* **Topology spread** (``PodSpec.topology_spread``) hard constraints
  (DoNotSchedule) are lowered by *slot assignment*: a spread-constrained
  job's pending tasks are distributed over the topology domains,
  greedy-balanced against the job's existing per-domain counts, ties by
  domain value and then node order, and each task may use only its
  assigned domain. Because the distribution itself satisfies
  ``max_skew``, a gang placed in one cycle cannot break the skew bound.
  A task is pinned to its domain even where another domain would also
  have kept the bound; the gang then pipelines or rolls back as if the
  domain were full. Soft constraints (ScheduleAnyway) become an additive
  score penalty proportional to the domain's existing load.

  Self-anti-affinity (a required pod-anti-affinity term whose selector
  matches the pod's own labels: the "one replica per zone or host" gang
  idiom) goes through the same assignment with a cap of one per domain:
  pending replicas get distinct empty domains, and replicas beyond the
  free domains get an empty assignment, which no node satisfies.

* **Priority-tiered packing**: an additive score that draws each group
  to nodes resident to its own-or-higher priority tier and away from
  lower-tier nodes (``tieredpack.weight``, off by default).

An assignment reaches the kernel in one of two forms (framework/solver.py
``BatchSolver._context``): as the per-task ``task_slot``/``slot_rows``
inputs with groups keeping their base sigs (:func:`build_slot_tensors`,
the GPU place path), or split into per-domain derived group sigs whose
domains ride the selector feature pairs (host contexts, ``constraints.
compile: off``, and batches of more than ``SLOT_CAP`` distinct slots).
Both give the same placements.

The node rows (topology codes, per-tier resident counts) are rebuilt
every session. ``reference_mask`` is the per-pair Python evaluation of
what ``compile_mask`` computes; ``constraints.compile: off`` selects it.
A failure in any of these passes raises: no pass falls back to another.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.arrays import _group_sig, derived_sig
from ..models.job_info import TaskStatus, allocated_status

ZONE_KEY = "topology.kubernetes.io/zone"
RACK_KEY = "topology.kubernetes.io/rack"
HOSTNAME_KEY = "kubernetes.io/hostname"


def _charged(fn):
    """Time ``fn(ssn, ...)`` into the session's constraint time (ms),
    which BatchSolver.place reports as ``constraint_ms``. A charged call
    inside another is counted once, by the outer one."""
    @functools.wraps(fn)
    def timed(ssn, *args, **kwargs):
        if getattr(ssn, "_constraint_timing", False):
            return fn(ssn, *args, **kwargs)
        ssn._constraint_timing = True
        t0 = time.perf_counter()
        try:
            return fn(ssn, *args, **kwargs)
        finally:
            ssn._constraint_timing = False
            ssn._constraint_ms = getattr(ssn, "_constraint_ms", 0.0) \
                + (time.perf_counter() - t0) * 1000.0
    return timed


# ---------------------------------------------------------------------------
# node-side encodings
# ---------------------------------------------------------------------------


def _task_tier(ssn, t) -> int:
    """A task's priority TIER: its job's priority (the PodGroup priority
    class, what the priority plugin's Preemptable compares) when the job
    is in session, else the pod-level priority."""
    job = ssn.jobs.get(t.job) if t.job else None
    return job.priority if job is not None else t.priority


def _topo_row(ssn, names: List[str],
              key: str) -> Tuple[np.ndarray, Dict[str, int]]:
    """[n_real] i32 topology code per node for ``key`` (-1 = label
    absent) and the value -> code vocabulary."""
    vocab: Dict[str, int] = {}
    row = np.full(len(names), -1, np.int32)
    for i, name in enumerate(names):
        ni = ssn.nodes.get(name)
        v = ni.topology_value(key) if ni is not None else None
        if v is not None:
            row[i] = vocab.setdefault(v, len(vocab))
    return row, vocab


def _tier_mass(ssn, names: List[str]) -> Tuple[np.ndarray, Dict[int, int]]:
    """[n_real, T] resident-task count per priority tier per node."""
    n = len(names)
    vocab: Dict[int, int] = {}
    mass = np.zeros((n, 8), np.float32)
    for i, name in enumerate(names):
        ni = ssn.nodes.get(name)
        if ni is None:
            continue
        for t in ni.tasks.values():
            tier = _task_tier(ssn, t)
            col = vocab.get(tier)
            if col is None:
                col = vocab[tier] = len(vocab)
                if mass.shape[1] <= col:
                    mass = np.concatenate(
                        [mass, np.zeros((n, 8), np.float32)], axis=1)
            mass[i, col] += 1.0
    return mass, vocab


# ---------------------------------------------------------------------------
# spread-slot assignment (the task x node lowering)
# ---------------------------------------------------------------------------


def _self_anti_terms(task) -> list:
    """Required pod-anti-affinity terms whose selector matches the task's
    OWN labels in its own namespace: the per-domain-exclusive gang idiom,
    lowered by slot assignment."""
    aff = task.pod.spec.affinity
    if aff is None or aff.pod_anti_affinity is None:
        return []
    from ..plugins.interpod import _term_matches
    labels = task.pod.metadata.labels
    ns = task.namespace
    return [t for t in aff.pod_anti_affinity.required
            if _term_matches(t, labels, ns, ns)]


def _job_domain_counts(ssn, job, key: str, vocab: Dict[str, int],
                       selector, pairs=None) -> np.ndarray:
    """Existing per-domain counts the spread/anti lowering starts from:
    the job's own assigned (resource-occupying) tasks when the selector
    is empty (the gang case), else every assigned pod in the cluster the
    selector matches. Domains outside ``vocab`` are ignored.

    ``pairs`` is an optional precomputed ``[(pod labels, domain code)]``
    list of every resident pod on a labelled node (assign_spread_slots
    builds it once per call and key)."""
    counts = np.zeros(max(1, len(vocab)), np.float64)
    if not selector:
        if job is None:
            return counts
        for t in job.tasks.values():
            if not t.node_name or not (allocated_status(t.status)
                                       or t.status == TaskStatus.Running):
                continue
            ni = ssn.nodes.get(t.node_name)
            v = ni.topology_value(key) if ni is not None else None
            c = vocab.get(v) if v is not None else None
            if c is not None:
                counts[c] += 1.0
        return counts
    if pairs is not None:
        for labels, c in pairs:
            if all(req.matches(labels) for req in selector):
                counts[c] += 1.0
        return counts
    for ni in ssn.nodes.values():
        v = ni.topology_value(key)
        c = vocab.get(v) if v is not None else None
        if c is None:
            continue
        for t in ni.tasks.values():
            if all(req.matches(t.pod.metadata.labels) for req in selector):
                counts[c] += 1.0
    return counts


def has_constraints(ordered_jobs) -> bool:
    """Does any pending task carry a constraint whose lowering is a
    topology-domain restriction (hard or soft spread, required pod
    anti-affinity)?"""
    for _, jtasks in ordered_jobs:
        for t in jtasks:
            spec = t.pod.spec
            if spec.topology_spread:
                return True
            aff = spec.affinity
            if aff is not None and aff.pod_anti_affinity is not None \
                    and aff.pod_anti_affinity.required:
                return True
    return False


@_charged
def assign_spread_slots(ssn, ordered_jobs, names: List[str],
                        split: bool = True):
    """Assign every hard-spread / self-anti-affinity pending task a
    topology domain and record the per-task allowed-domain entries in
    ``ssn._constraint_slots = {task_uid: ((key, values, hard), ...)}``
    (later calls in a session add to it, never drop).

    With ``split`` (the split lowering), also derive per-slot group sigs
    and return ``{task_uid: derived_sig}`` for TaskBatch.build's
    ``sig_override`` (None when nothing is split). With ``split=False``
    (the tensor lowering) groups keep their base sigs, the assignment
    lowers to ``task_slot``/``slot_rows`` through
    :func:`build_slot_tensors`, and the return is None."""
    rows_memo: Dict[str, tuple] = {}
    pairs_memo: Dict[str, list] = {}
    live_memo: Dict[str, frozenset] = {}

    def topo(key: str):
        got = rows_memo.get(key)
        if got is None:
            got = rows_memo[key] = _topo_row(ssn, names, key)
        return got

    def live_codes(key: str) -> frozenset:
        """Domain codes with at least one current node."""
        got = live_memo.get(key)
        if got is None:
            row, _vocab = topo(key)
            got = live_memo[key] = frozenset(
                int(c) for c in np.unique(row) if c >= 0)
        return got

    def resident_pairs(key: str) -> list:
        got = pairs_memo.get(key)
        if got is None:
            row, _vocab = topo(key)
            got = pairs_memo[key] = [
                (t.pod.metadata.labels, int(row[i]))
                for i, name in enumerate(names)
                if row[i] >= 0
                for ni in (ssn.nodes.get(name),) if ni is not None
                for t in ni.tasks.values()]
        return got

    slots: Dict[str, tuple] = {}
    override: Dict[str, int] = {}
    for job, jtasks in ordered_jobs:
        # constraints are per task spec, but the greedy balance state is
        # shared per (job, constraint identity), so same-constraint
        # siblings spread against each other in task order
        spread_state: Dict[tuple, tuple] = {}   # ck -> (values, proj)
        anti_state: Dict[tuple, list] = {}      # ak -> mutable [free, next]
        for t in jtasks:
            spec = t.pod.spec
            hard = [c for c in spec.topology_spread
                    if c.when_unsatisfiable == "DoNotSchedule"]
            anti = _self_anti_terms(t)
            if not hard and not anti:
                continue
            entries: list = []
            for c in hard:
                ck = (c.topology_key, repr(c.label_selector))
                cached = spread_state.get(ck)
                if cached is None:
                    _, vocab = topo(c.topology_key)
                    base = _job_domain_counts(
                        ssn, job, c.topology_key, vocab, c.label_selector,
                        pairs=resident_pairs(c.topology_key)
                        if c.label_selector else None) \
                        if vocab else np.zeros(1)
                    live = live_codes(c.topology_key)
                    # [(value, code)] over live domains, sorted by domain
                    # value: stable across node-order churn
                    cached = (sorted((v, c2) for v, c2 in vocab.items()
                                     if c2 in live), base.copy())
                    spread_state[ck] = cached
                values, proj = cached
                if not values:
                    # no ready node carries the label: no node qualifies
                    entries.append((c.topology_key, (), True))
                    continue
                best = min(values, key=lambda vc: (proj[vc[1]], vc[0]))
                proj[best[1]] += 1.0
                entries.append((c.topology_key, (best[0],), True))
            for term in anti:
                ak = ("anti", term.topology_key, repr(term.label_selector))
                st = anti_state.get(ak)
                if st is None:
                    _, vocab = topo(term.topology_key)
                    base = _job_domain_counts(
                        ssn, job, term.topology_key, vocab,
                        term.label_selector,
                        pairs=resident_pairs(term.topology_key)
                        if term.label_selector else None) \
                        if vocab else np.zeros(1)
                    live = live_codes(term.topology_key)
                    free = sorted(v for v, c2 in vocab.items()
                                  if base[c2] == 0.0 and c2 in live)
                    st = anti_state[ak] = [free, 0]
                free, nxt = st
                vals = (free[nxt],) if nxt < len(free) else ()
                st[1] += 1
                entries.append((term.topology_key, vals, True))
            ent = tuple(entries)
            slots[t.uid] = ent
            if split:
                base_sig = t.group_sig_cache \
                    if t.group_sig_cache is not None else _group_sig(t)
                override[t.uid] = derived_sig(base_sig, ent)
    existing = getattr(ssn, "_constraint_slots", None)
    if existing is None:
        ssn._constraint_slots = slots
    else:
        existing.update(slots)
    return override or None


# A batch whose slot assignments intern to more distinct domain tuples
# than this goes to the split lowering: the kernel's slot rows are one
# [N] row a slot, and an unbounded slot axis would let a workload balloon
# them.
SLOT_CAP = 64


def count_batch_slots(ssn, ordered_jobs) -> int:
    """Distinct slot-entry tuples among the batch's pending tasks (the
    height of the slot axis, checked against SLOT_CAP before the tensor
    lowering is chosen)."""
    slots = getattr(ssn, "_constraint_slots", None)
    if not slots:
        return 0
    seen = set()
    for _job, jtasks in ordered_jobs:
        for t in jtasks:
            ent = slots.get(t.uid)
            if ent is not None:
                seen.add(ent)
    return len(seen)


def derive_sig_overrides(ssn, ordered_jobs) -> Optional[Dict[str, int]]:
    """The split lowering's sig overrides from already-stored slot entries
    (assignment ran with split=False, then the batch turned out to need
    the split lowering)."""
    slots = getattr(ssn, "_constraint_slots", None)
    if not slots:
        return None
    override: Dict[str, int] = {}
    for _job, jtasks in ordered_jobs:
        for t in jtasks:
            ent = slots.get(t.uid)
            if ent is None:
                continue
            base_sig = t.group_sig_cache if t.group_sig_cache is not None \
                else _group_sig(t)
            override[t.uid] = derived_sig(base_sig, ent)
    return override or None


@_charged
def lower_slots(ssn, ordered_jobs, names: List[str], tensors: bool):
    """Assign the batch's topology domains and choose their lowering
    (volcano_tpu/framework/solver.py:528-617): (use_tensors,
    sig_override). ``tensors`` (the place path) asks for the kernel's
    per-task slot inputs (:func:`build_slot_tensors`); the split lowering's
    derived sigs come back instead under ``constraints.compile: off``, or
    when the batch holds more than SLOT_CAP distinct slots."""
    if not has_constraints(ordered_jobs):
        return False, None
    if not tensors or compile_conf(ssn) == "off":
        return False, assign_spread_slots(ssn, ordered_jobs, names)
    assign_spread_slots(ssn, ordered_jobs, names, split=False)
    if count_batch_slots(ssn, ordered_jobs) > SLOT_CAP:
        return False, derive_sig_overrides(ssn, ordered_jobs)
    return True, None


@_charged
def build_slot_tensors(ssn, batch, narr):
    """The stored slot assignments as the kernel's per-task domain
    inputs: (task_slot [t_pad] i32, slot_rows [S+1, n_pad] bool), or None
    when no batch task carries a slot.

    Slot ids intern on the entries tuple, so every job's "zone-3" tasks
    share one row: S stays O(domains), not O(tasks). Row S is all-true
    and unconstrained and padding tasks carry S; an empty assignment
    compiles to an all-false row (no node can take the task this cycle,
    and the gang pipelines or rolls back as if the domain were full)."""
    slots = getattr(ssn, "_constraint_slots", None)
    if not slots:
        return None
    names = narr.names
    n = len(names)
    t_pad = int(batch.task_group.shape[0])
    ids: Dict[tuple, int] = {}
    task_slot: Optional[np.ndarray] = None
    for i, t in enumerate(batch.tasks):
        ent = slots.get(t.uid)
        if ent is None:
            continue
        sid = ids.get(ent)
        if sid is None:
            sid = ids[ent] = len(ids)
        if task_slot is None:
            task_slot = np.full(t_pad, -1, np.int32)
        task_slot[i] = sid
    if task_slot is None:
        return None
    S = len(ids)
    task_slot[task_slot < 0] = S
    rows = np.zeros((S + 1, narr.n_pad), bool)
    rows[S] = True
    topo: Dict[str, tuple] = {}
    for ent, sid in ids.items():
        row = np.ones(n, bool)
        for key, values, _hard in ent:
            if key not in topo:
                topo[key] = _topo_row(ssn, names, key)
            trow, vocab = topo[key]
            codes = [vocab[v] for v in values if v in vocab]
            if codes:
                row &= np.isin(trow, np.asarray(codes, np.int32))
            else:
                row[:] = False
                break
        rows[sid, :n] = row
    return task_slot, rows


def task_slot_entries(ssn, task) -> Optional[tuple]:
    """The task's assigned-domain entries for the host per-pair predicate;
    computed on demand (a one-task assignment) when the task was never
    part of a batch."""
    slots = getattr(ssn, "_constraint_slots", None)
    if slots is not None and task.uid in slots:
        return slots[task.uid]
    spec = task.pod.spec
    hard = [c for c in spec.topology_spread
            if c.when_unsatisfiable == "DoNotSchedule"]
    anti = _self_anti_terms(task)
    if not hard and not anti:
        return None
    names = [n.name for n in ssn.node_list]
    job = ssn.jobs.get(task.job)
    assign_spread_slots(ssn, [(job, [task])], names)
    return ssn._constraint_slots.get(task.uid)


def node_satisfies_slots(ssn, task, node) -> bool:
    """Host-path twin of the compiled slot mask."""
    entries = task_slot_entries(ssn, task)
    if not entries:
        return True
    for key, values, _hard in entries:
        v = node.topology_value(key)
        if v is None or v not in values:
            return False
    return True


# ---------------------------------------------------------------------------
# the [G, N] compile passes
# ---------------------------------------------------------------------------


def compile_mask(ssn, batch, narr) -> Optional[np.ndarray]:
    """The compiled constraint MASK for the batch: inter-pod required
    (anti-)affinity and the spread/anti slot rows. None = all-pass."""
    from ..plugins import interpod
    names = narr.names
    mask: Optional[np.ndarray] = None
    n = len(names)

    def buf() -> np.ndarray:
        nonlocal mask
        if mask is None:
            mask = np.ones((batch.g_pad, narr.n_pad), bool)
        return mask

    # inter-pod required terms (and the existing-pod symmetry rule)
    needs = {g for g, ti in enumerate(batch.group_first)
             if interpod.task_has_pod_affinity(batch.tasks[ti])}
    existing_aff = any(interpod.task_has_pod_affinity(t)
                       for node in ssn.nodes.values()
                       for t in node.tasks.values())
    if needs or existing_aff:
        index = interpod.get_index(ssn, names)
        if index.anti_required:
            needs = set(range(batch.n_groups))
        for g in needs:
            row = index.required_mask(batch.tasks[batch.group_first[g]])
            if row is not None:
                buf()[g, :n] &= row

    # spread/anti slot rows, only where the context build did not lower
    # them already (through the selector feature pairs or the batch's
    # per-task slot tensors). A tensor-carrying batch must skip them: its
    # groups are base groups, and a group-wide row would pin every task to
    # its representative's domain.
    slots = getattr(ssn, "_constraint_slots", None)
    if slots and getattr(batch, "task_slot", None) is not None:
        slots = None
    if slots and not getattr(ssn, "_constraint_slots_lowered", False):
        topo: Dict[str, tuple] = {}
        for g, ti in enumerate(batch.group_first):
            entries = slots.get(batch.tasks[ti].uid)
            if not entries:
                continue
            for key, values, _hard in entries:
                if key not in topo:
                    topo[key] = _topo_row(ssn, names, key)
                row, vocab = topo[key]
                codes = [vocab[v] for v in values if v in vocab]
                if codes:
                    buf()[g, :n] &= np.isin(row, codes)
                else:
                    buf()[g, :n] = False
    return mask


@_charged
def compile_score(ssn, batch, narr, tiered_weight: float = 0.0,
                  spread_weight: float = 10.0) -> Optional[np.ndarray]:
    """The compiled additive SCORE: soft topology spread (ScheduleAnyway,
    a penalty proportional to a domain's existing load above the least
    loaded) and priority-tiered packing. None = all-zero."""
    names = narr.names
    n = len(names)
    score: Optional[np.ndarray] = None

    def buf() -> np.ndarray:
        nonlocal score
        if score is None:
            score = np.zeros((batch.g_pad, narr.n_pad), np.float32)
        return score

    topo: Dict[str, tuple] = {}
    for g, ti in enumerate(batch.group_first):
        if not spread_weight:
            break
        rep = batch.tasks[ti]
        soft = [c for c in rep.pod.spec.topology_spread
                if c.when_unsatisfiable != "DoNotSchedule"]
        for c in soft:
            if c.topology_key not in topo:
                topo[c.topology_key] = _topo_row(ssn, names, c.topology_key)
            row, vocab = topo[c.topology_key]
            if not vocab:
                continue
            job = ssn.jobs.get(rep.job)
            base = _job_domain_counts(ssn, job, c.topology_key, vocab,
                                      c.label_selector)
            rel = base - base.min()
            per_node = np.where(row >= 0, rel[np.maximum(row, 0)],
                                rel.max() + 1.0)
            buf()[g, :n] -= (spread_weight *
                             per_node).astype(np.float32)

    if tiered_weight:
        mass, vocab = _tier_mass(ssn, names)
        if vocab:
            prios = np.full(max(vocab.values()) + 1, 0, np.int64)
            for prio, col in vocab.items():
                prios[col] = prio
            total = mass[:, :len(prios)]
            for g, ti in enumerate(batch.group_first):
                p = _task_tier(ssn, batch.tasks[ti])
                ge = total[:, prios >= p].sum(axis=1)
                lt = total[:, prios < p].sum(axis=1)
                raw = ge - lt
                span = float(np.abs(raw).max())
                if span > 0.0:
                    buf()[g, :n] += (tiered_weight * 100.0 *
                                     raw / span).astype(np.float32)
    return score


def reference_mask(ssn, batch, narr) -> Optional[np.ndarray]:
    """Per-(group, node) Python evaluation of exactly what
    :func:`compile_mask` computes, one predicate call a pair."""
    from ..plugins import interpod
    names = narr.names
    mask: Optional[np.ndarray] = None
    existing_aff = any(interpod.task_has_pod_affinity(t)
                       for node in ssn.nodes.values()
                       for t in node.tasks.values())
    index = interpod.get_index(ssn, names)
    # a tensor-carrying batch keeps base groups: its per-task domains
    # ride the kernel's task_slot/slot_ok inputs, never a group row
    tensor_batch = getattr(batch, "task_slot", None) is not None
    for g, ti in enumerate(batch.group_first):
        rep = batch.tasks[ti]
        rows_needed = interpod.task_has_pod_affinity(rep) or existing_aff
        irow = index.required_mask(rep) if rows_needed else None
        entries = None if tensor_batch else task_slot_entries(ssn, rep)
        if irow is None and not entries:
            continue
        if mask is None:
            mask = np.ones((batch.g_pad, narr.n_pad), bool)
        for i, name in enumerate(names):
            ok = True
            if irow is not None and not irow[i]:
                ok = False
            if ok and entries:
                ok = node_satisfies_slots(ssn, rep, ssn.nodes[name])
            mask[g, i] &= ok
    return mask


def compile_conf(ssn) -> str:
    """The ``constraints.compile`` solver argument: "auto" (the default,
    the compiled passes and the tensor lowering) or "off" (the per-pair
    reference mask and the split lowering: the control whose binds must
    equal the compiled mode's)."""
    args = (getattr(ssn, "configurations", None) or {}).get("solver")
    if args is not None and hasattr(args, "get_str"):
        return (args.get_str("constraints.compile", "auto")
                or "auto").strip().lower()
    return "auto"


@_charged
def constraint_mask(ssn, batch, narr) -> Optional[np.ndarray]:
    """The mask the conf selects: ``compile_mask``, or ``reference_mask``
    under ``constraints.compile: off``."""
    if compile_conf(ssn) == "off":
        return reference_mask(ssn, batch, narr)
    return compile_mask(ssn, batch, narr)
