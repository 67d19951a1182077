"""nodeorder plugin (the port's own copy of volcano_tpu/plugins/
nodeorder.py; reference: pkg/scheduler/plugins/nodeorder/nodeorder.go).

Weighted sum of the standard k8s scorers: LeastRequested, MostRequested,
BalancedResourceAllocation, NodeAffinity (preferred terms), TaintToleration
(PreferNoSchedule) -- weights from arguments (nodeorder.go:39-135):

    leastrequested.weight    (default 1)
    mostrequested.weight     (default 0)
    balancedresource.weight  (default 1)
    nodeaffinity.weight      (default 1)
    tainttoleration.weight   (default 1)
    podaffinity.weight       (default 1)

least/most/balanced run inside the gang-allocate kernel (dynamic state);
nodeaffinity-preferred, PreferNoSchedule taints and inter-pod preferred
affinity (the reference's BatchNodeOrder scorer, nodeorder.go:271-295,
evaluated against the session-open snapshot there too; plugins/
interpod.py) are encoded per group x node once and added as a static
score term.
"""

from __future__ import annotations

import numpy as np

from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from . import interpod

NAME = "nodeorder"


def _preferred_affinity_score(task, labels) -> float:
    aff = task.pod.spec.affinity
    if aff is None or aff.node_affinity is None:
        return 0.0
    total = 0.0
    max_total = 0.0
    for pref in aff.node_affinity.preferred:
        max_total += pref.weight
        if pref.preference.matches(labels):
            total += pref.weight
    if max_total <= 0:
        return 0.0
    return total / max_total * 100.0


def _prefer_no_schedule_score(task, node) -> float:
    """Fewer untolerated PreferNoSchedule taints -> higher score."""
    if node.node is None:
        return 100.0
    intolerable = 0
    total = 0
    for taint in node.node.spec.taints:
        if taint.effect != "PreferNoSchedule":
            continue
        total += 1
        if not any(tol.tolerates(taint) for tol in task.pod.spec.tolerations):
            intolerable += 1
    if total == 0:
        return 100.0
    return (1.0 - intolerable / total) * 100.0


class NodeOrderPlugin(Plugin):
    def __init__(self, arguments=None):
        args = arguments or {}
        get = args.get_int if hasattr(args, "get_int") else \
            (lambda k, d: int(args.get(k, d)))
        self.least_w = get("leastrequested.weight", 1)
        self.most_w = get("mostrequested.weight", 0)
        self.balanced_w = get("balancedresource.weight", 1)
        self.node_affinity_w = get("nodeaffinity.weight", 1)
        self.taint_w = get("tainttoleration.weight", 1)
        self.pod_affinity_w = get("podaffinity.weight", 1)

    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn) -> None:
        if ssn.solver is not None and ssn.plugin_enabled(NAME, "enabledNodeOrder"):
            ssn.solver.add_weight("least", float(self.least_w))
            ssn.solver.add_weight("most", float(self.most_w))
            ssn.solver.add_weight("balanced", float(self.balanced_w))
            ssn.solver.mark_vectorized(NAME)
            if self.node_affinity_w or self.taint_w:
                ssn.solver.add_static_score_fn(self._static_score(ssn))

        def node_order_fn(task, node) -> float:
            """Host-side mirror for single-pair paths."""
            score = 0.0
            alloc = node.allocatable
            used = node.used
            if alloc.milli_cpu > 0 and alloc.memory > 0:
                cpu_frac = min(1.0, (used.milli_cpu + task.resreq.milli_cpu) / alloc.milli_cpu)
                mem_frac = min(1.0, (used.memory + task.resreq.memory) / alloc.memory)
                score += self.least_w * (((1 - cpu_frac) + (1 - mem_frac)) / 2) * 100
                score += self.most_w * ((cpu_frac + mem_frac) / 2) * 100
                score += self.balanced_w * (100 - abs(cpu_frac - mem_frac) * 100)
            labels = node.node.metadata.labels if node.node is not None else {}
            score += self.node_affinity_w * _preferred_affinity_score(task, labels)
            score += self.taint_w * _prefer_no_schedule_score(task, node)
            return score

        ssn.add_node_order_fn(NAME, node_order_fn)

        def batch_node_order_fn(task, nodes):
            """Inter-pod preferred affinity over a node set (the
            reference's BatchNodeOrderFn, nodeorder.go:278-300)."""
            if not self.pod_affinity_w:
                return {}
            names = [n.name for n in ssn.node_list]
            index = interpod.get_index(ssn, names)
            raw = index.preference_score(task)
            if raw is None:
                return {}
            norm = interpod.normalize(raw, float(self.pod_affinity_w))
            by_name = dict(zip(names, norm))
            return {node.name: float(by_name.get(node.name, 0.0))
                    for node in nodes}

        ssn.add_batch_node_order_fn(NAME, batch_node_order_fn)

    def _static_score(self, ssn):
        def fn(batch, narr, feats):
            # the [G, N] score materializes ONLY on first touch: the
            # all-pass case previously paid a ~256 MB zeros alloc per
            # context build at 50k x 10k before returning None
            score = None
            touched = False   # all-zero -> return None (no [G,N] transfer)
            n = len(narr.names)

            def buf():
                nonlocal score
                if score is None:
                    score = np.zeros((batch.g_pad, narr.n_pad), np.float32)
                return score
            if self.pod_affinity_w:
                # inter-pod preferred (anti-)affinity batch scorer
                # (nodeorder.go:271-295); symmetry can score affinity-free
                # groups, so gate on any affinity existing at all
                own = {g for g, i in enumerate(batch.group_first)
                       if interpod.task_has_pod_affinity(batch.tasks[i])}
                existing = any(interpod.task_has_pod_affinity(t)
                               for node in ssn.nodes.values()
                               for t in node.tasks.values())
                if own or existing:
                    index = interpod.get_index(ssn, narr.names)
                    groups = set(range(batch.n_groups)) \
                        if index.pref_terms else own
                    for g in groups:
                        rep = batch.tasks[batch.group_first[g]]
                        raw = index.preference_score(rep)
                        if raw is not None:
                            buf()[g, :n] += interpod.normalize(
                                raw, float(self.pod_affinity_w))
                            touched = True
            # PreferNoSchedule taints are rare: sweep only nodes that carry
            # one (taint-free nodes score a constant, which can't change the
            # per-task argmax and is omitted)
            taint_nodes = [
                (name, i) for name, i in narr.name_to_idx.items()
                if ssn.nodes[name].node is not None
                and any(t.effect == "PreferNoSchedule"
                        for t in ssn.nodes[name].node.spec.taints)]
            for g, ti in enumerate(batch.group_first):
                rep = batch.tasks[ti]
                has_pref = (rep.pod.spec.affinity is not None
                            and rep.pod.spec.affinity.node_affinity is not None
                            and rep.pod.spec.affinity.node_affinity.preferred)
                if has_pref and self.node_affinity_w:
                    for name, i in narr.name_to_idx.items():
                        labels = ssn.nodes[name].node.metadata.labels \
                            if ssn.nodes[name].node else {}
                        buf()[g, i] += self.node_affinity_w * \
                            _preferred_affinity_score(rep, labels)
                    touched = True
                if self.taint_w and taint_nodes:
                    touched = True
                    for name, i in taint_nodes:
                        # relative to the taint-free constant of 100
                        buf()[g, i] += self.taint_w * (
                            _prefer_no_schedule_score(rep, ssn.nodes[name]) - 100.0)
            return score if touched else None
        return fn


register_plugin_builder(NAME, NodeOrderPlugin)
