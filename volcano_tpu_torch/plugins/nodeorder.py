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
nodeaffinity-preferred and PreferNoSchedule taints are encoded per group x
node once and added as a static score term. Inter-pod preferred affinity
(the reference's BatchNodeOrder scorer, nodeorder.go:271-295) arrives with
the placement-constraint port: with ``podaffinity.weight`` set, a session
holding a pod with pod (anti-)affinity raises NotImplementedError.
"""

from __future__ import annotations

import numpy as np

from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from .predicates import refuse_pod_constraints

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
        if self.pod_affinity_w:
            refuse_pod_constraints(ssn, NAME)
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

    def _static_score(self, ssn):
        def fn(batch, narr, feats):
            # the [G, N] score materializes ONLY on first touch: the
            # all-pass case previously paid a ~256 MB zeros alloc per
            # context build at 50k x 10k before returning None
            score = None
            touched = False   # all-zero -> return None (no [G,N] transfer)

            def buf():
                nonlocal score
                if score is None:
                    score = np.zeros((batch.g_pad, narr.n_pad), np.float32)
                return score
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
