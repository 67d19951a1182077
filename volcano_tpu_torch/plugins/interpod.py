"""Inter-pod affinity/anti-affinity: predicate + batch scorer support (the
port's own copy of volcano_tpu/plugins/interpod.py).

Reference wiring: the upstream k8s InterPodAffinity plugin runs as a filter
(pkg/scheduler/plugins/predicates/predicates.go:262-341) and as the batch
scorer (pkg/scheduler/plugins/nodeorder/nodeorder.go:271-295). Both
evaluate against the k8s snapshot built once at session open
(plugins/util/k8s.Snapshot) — in-cycle placements are NOT visible to them
in the reference either, so the cycle-static index here is semantically
faithful, not a simplification.

Vector shape: topology keys become integer-coded node vectors and each
(pod-affinity term) becomes a set of allowed/blocked topology codes; the
per-group node mask / score vector falls out of `np.isin`-style vector ops
instead of the upstream's per-node pod loops.

Semantics implemented (upstream interpodaffinity):

* required affinity: every term must find >=1 existing pod whose labels
  match the term selector (in the term's namespaces, defaulting to the
  incoming pod's) on a node sharing the candidate node's topology value;
  the self-match bootstrap exception applies (a pod whose own labels match
  the term may found a new topology).
* required anti-affinity: no matching existing pod may share the candidate
  node's topology value; plus existing-pod symmetry — an existing pod with
  a required anti-affinity term matching the incoming pod blocks its own
  topology.
* preferred (anti-)affinity: weighted matches per topology, including the
  symmetric contributions of existing pods' preferred terms, normalized to
  0..100 like the upstream NormalizeScore.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..models.objects import PodAffinityTerm


def _term_matches(term: PodAffinityTerm, labels: Dict[str, str],
                  pod_ns: str, default_ns: str) -> bool:
    """Does a pod (labels, pod_ns) fall under the term's selector+ns?"""
    namespaces = term.namespaces or [default_ns]
    if pod_ns not in namespaces:
        return False
    return all(req.matches(labels) for req in term.label_selector)


class InterPodIndex:
    """Cycle-static index of assigned pods for affinity evaluation.

    ``names`` fixes the node order every returned vector uses (the solver
    passes NodeArrays.names; the host predicate passes the session node
    list — identical ordering by construction).
    """

    def __init__(self, ssn, names: List[str]):
        self.names = list(names)
        self.node_labels: List[Dict[str, str]] = []
        # (labels, ns, node_idx) of every snapshot-assigned pod
        self.pods: List[Tuple[Dict[str, str], str, int]] = []
        # existing pods carrying affinity terms, for symmetry rules:
        # (terms, labels, ns, node_idx)
        self.anti_required: List[Tuple[list, str, int]] = []
        self.pref_terms: List[Tuple[list, str, int, float]] = []
        for i, name in enumerate(self.names):
            node = ssn.nodes.get(name)
            labels = node.node.metadata.labels \
                if node is not None and node.node is not None else {}
            self.node_labels.append(labels)
            if node is None:
                continue
            for t in node.tasks.values():
                pod = t.pod
                self.pods.append((pod.metadata.labels, t.namespace, i))
                aff = pod.spec.affinity
                if aff is None:
                    continue
                if aff.pod_anti_affinity is not None \
                        and aff.pod_anti_affinity.required:
                    self.anti_required.append(
                        (aff.pod_anti_affinity.required, t.namespace, i))
                for wt in ((aff.pod_affinity.preferred
                            if aff.pod_affinity else []) or []):
                    self.pref_terms.append(
                        ([wt.term], t.namespace, i, float(wt.weight)))
                for wt in ((aff.pod_anti_affinity.preferred
                            if aff.pod_anti_affinity else []) or []):
                    self.pref_terms.append(
                        ([wt.term], t.namespace, i, -float(wt.weight)))
        self._topo_codes: Dict[str, np.ndarray] = {}
        self._topo_values: Dict[str, Dict[str, int]] = {}
        # lazy vector encodings over the assigned-pod set: label values and
        # namespaces become integer codes once per cycle, so each term's
        # selector is evaluated on the (tiny) distinct-value vocabulary and
        # applied to all pods with isin/bincount — O(pods) Python sweeps
        # per (term x group) would dominate the encode at 10k nodes
        self._pod_node: Optional[np.ndarray] = None     # [M] node idx
        self._pod_ns: Optional[np.ndarray] = None       # [M] ns code
        self._ns_vocab: Dict[str, int] = {}
        self._pod_label_codes: Dict[str, tuple] = {}    # key -> (codes, vocab)
        self._term_match_cache: Dict[tuple, np.ndarray] = {}
        self._pod_topo_cache: Dict[str, np.ndarray] = {}  # key -> [M] codes

    def topo_codes(self, key: str) -> Tuple[np.ndarray, Dict[str, int]]:
        """[n_real] int topology code per node (-1 = label missing)."""
        cached = self._topo_codes.get(key)
        if cached is not None:
            return cached, self._topo_values[key]
        values: Dict[str, int] = {}
        codes = np.full(len(self.node_labels), -1, np.int32)
        for i, labels in enumerate(self.node_labels):
            v = labels.get(key)
            if v is not None:
                codes[i] = values.setdefault(v, len(values))
        self._topo_codes[key] = codes
        self._topo_values[key] = values
        return codes, values

    # -- vector encodings ----------------------------------------------------

    def _ensure_pod_arrays(self) -> None:
        if self._pod_node is not None:
            return
        m = len(self.pods)
        self._pod_node = np.fromiter((i for _, _, i in self.pods),
                                     np.int64, m)
        ns_codes = np.empty(m, np.int32)
        for p, (_, ns, _) in enumerate(self.pods):
            ns_codes[p] = self._ns_vocab.setdefault(ns, len(self._ns_vocab))
        self._pod_ns = ns_codes

    def _pod_codes(self, key: str) -> tuple:
        """([M] value code per pod (-1 = label absent), value vocab)."""
        cached = self._pod_label_codes.get(key)
        if cached is not None:
            return cached
        self._ensure_pod_arrays()
        vocab: Dict[str, int] = {}
        codes = np.full(len(self.pods), -1, np.int32)
        for p, (labels, _, _) in enumerate(self.pods):
            v = labels.get(key)
            if v is not None:
                codes[p] = vocab.setdefault(v, len(vocab))
        self._pod_label_codes[key] = (codes, vocab)
        return codes, vocab

    @staticmethod
    def _term_signature(term: PodAffinityTerm, namespaces: tuple) -> tuple:
        return (namespaces,
                tuple((r.key, r.operator, tuple(r.values or []))
                      for r in term.label_selector))

    def _term_match(self, term: PodAffinityTerm,
                    default_ns: str) -> np.ndarray:
        """[M] bool: pods the term selects. Semantically identical to
        mapping _term_matches over self.pods — each selector requirement is
        evaluated once per *distinct label value* through the same
        ``req.matches`` oracle, then broadcast by code."""
        self._ensure_pod_arrays()
        namespaces = tuple(term.namespaces or [default_ns])
        sig = self._term_signature(term, namespaces)
        cached = self._term_match_cache.get(sig)
        if cached is not None:
            return cached
        ns_codes = [self._ns_vocab[n] for n in namespaces
                    if n in self._ns_vocab]
        out = np.isin(self._pod_ns, ns_codes) if ns_codes \
            else np.zeros(len(self.pods), bool)
        for req in term.label_selector:
            codes, vocab = self._pod_codes(req.key)
            ok_codes = [c for v, c in vocab.items()
                        if req.matches({req.key: v})]
            if req.matches({}):   # absent-label semantics via the oracle
                ok_codes.append(-1)
            out = out & np.isin(codes, ok_codes)
        self._term_match_cache[sig] = out
        return out

    def _pod_topo(self, key: str) -> np.ndarray:
        """[M] topology code of each pod's node under `key`, cached."""
        pc = self._pod_topo_cache.get(key)
        if pc is None:
            codes, _ = self.topo_codes(key)
            self._ensure_pod_arrays()
            pc = codes[self._pod_node]
            self._pod_topo_cache[key] = pc
        return pc

    def matching_topologies(self, term: PodAffinityTerm,
                            default_ns: str) -> Set[int]:
        """Topology codes (under term.topology_key) hosting >=1 pod the
        term selects."""
        if not self.pods:
            return set()
        pc = self._pod_topo(term.topology_key)
        sel = self._term_match(term, default_ns) & (pc >= 0)
        return {int(c) for c in np.unique(pc[sel])}

    # -- predicate ---------------------------------------------------------

    def required_mask(self, task) -> Optional[np.ndarray]:
        """[n_real] bool for the task's required (anti-)affinity incl. the
        existing-pod symmetry rule; None when nothing applies."""
        aff = task.pod.spec.affinity
        pod_labels = task.pod.metadata.labels
        ns = task.namespace
        n = len(self.node_labels)
        mask: Optional[np.ndarray] = None

        terms = (aff.pod_affinity.required
                 if aff is not None and aff.pod_affinity is not None else [])
        for term in terms:
            codes, _ = self.topo_codes(term.topology_key)
            allowed = self.matching_topologies(term, ns)
            if not allowed:
                # bootstrap: the pod's own labels satisfy the term — any
                # node with the topology label may found the group
                if _term_matches(term, pod_labels, ns, ns):
                    ok = codes >= 0
                else:
                    ok = np.zeros(n, bool)
            else:
                ok = np.isin(codes, list(allowed))
            mask = ok if mask is None else (mask & ok)

        anti = (aff.pod_anti_affinity.required
                if aff is not None and aff.pod_anti_affinity is not None
                else [])
        for term in anti:
            codes, _ = self.topo_codes(term.topology_key)
            blocked = self.matching_topologies(term, ns)
            if blocked:
                ok = ~np.isin(codes, list(blocked))
                mask = ok if mask is None else (mask & ok)

        # symmetry: existing pods' required anti-affinity blocks the
        # incoming pod on their topology when it matches their terms
        for terms_e, ns_e, i in self.anti_required:
            for term in terms_e:
                if not _term_matches(term, pod_labels, ns, ns_e):
                    continue
                codes, _ = self.topo_codes(term.topology_key)
                c = codes[i]
                if c >= 0:
                    ok = codes != c
                    mask = ok if mask is None else (mask & ok)
        return mask

    # -- batch scorer ------------------------------------------------------

    def preference_score(self, task) -> Optional[np.ndarray]:
        """[n_real] float raw preferred-affinity score (pre-normalization),
        including symmetric contributions; None when nothing applies."""
        aff = task.pod.spec.affinity
        pod_labels = task.pod.metadata.labels
        ns = task.namespace
        n = len(self.node_labels)
        raw = np.zeros(n, np.float64)
        touched = False

        pref = (aff.pod_affinity.preferred
                if aff is not None and aff.pod_affinity is not None else [])
        anti_pref = (aff.pod_anti_affinity.preferred
                     if aff is not None and aff.pod_anti_affinity is not None
                     else [])
        for weighted, sign in ((pref, 1.0), (anti_pref, -1.0)):
            for wt in weighted:
                term = wt.term
                codes, values = self.topo_codes(term.topology_key)
                pc = self._pod_topo(term.topology_key)
                sel = self._term_match(term, ns) & (pc >= 0)
                if sel.any():
                    touched = True
                    counts = np.bincount(pc[sel],
                                         minlength=max(1, len(values)))
                    raw += sign * wt.weight * np.where(
                        codes >= 0, counts[np.maximum(codes, 0)], 0)

        # symmetry: existing pods' preferred terms toward the incoming pod
        for terms_e, ns_e, i, w in self.pref_terms:
            for term in terms_e:
                if not _term_matches(term, pod_labels, ns, ns_e):
                    continue
                codes, _ = self.topo_codes(term.topology_key)
                c = codes[i]
                if c >= 0:
                    touched = True
                    raw[codes == c] += w
        return raw if touched else None


def normalize(raw: np.ndarray, weight: float) -> np.ndarray:
    """Upstream NormalizeScore: linear map of [min, max] onto [0, 100]."""
    lo, hi = float(raw.min()), float(raw.max())
    if hi <= lo:
        return np.zeros_like(raw, np.float32)
    return ((raw - lo) / (hi - lo) * 100.0 * weight).astype(np.float32)


def task_has_pod_affinity(task) -> bool:
    aff = task.pod.spec.affinity
    if aff is None:
        return False
    return ((aff.pod_affinity is not None
             and bool(aff.pod_affinity.required
                      or aff.pod_affinity.preferred))
            or (aff.pod_anti_affinity is not None
                and bool(aff.pod_anti_affinity.required
                         or aff.pod_anti_affinity.preferred)))


def get_index(ssn, names: List[str]) -> InterPodIndex:
    """Session-cached index (assignments are cycle-static, see module
    docstring)."""
    cached = getattr(ssn, "_interpod_index", None)
    if cached is not None and cached.names == list(names):
        return cached
    index = InterPodIndex(ssn, names)
    ssn._interpod_index = index
    return index
