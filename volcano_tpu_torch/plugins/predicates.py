"""predicates plugin (the port's own copy of volcano_tpu/plugins/
predicates.py; reference: pkg/scheduler/plugins/predicates/predicates.go).

Wraps the standard node filters: NodeUnschedulable (handled by the cache --
NotReady nodes never reach the snapshot), node selector / required node
affinity, taints/tolerations, pod-count cap, host ports, and GPU-share fit.

For the batch solver these predicates are *vectorized* -- the plugin flips
on the solver's feature-matrix masks (selector/taint/affinity matmuls built
at snapshot time, models/arrays.py PredicateFeatures) and adds mask fns for
ports and GPU sharing. The same checks are also registered as a host-side
PredicateFn for actions that probe single task x node pairs.

Inter-pod (anti-)affinity and topology spread are lowered by the
placement-constraint compiler (ops/constraints.py): a mask fn adds its
required (anti-)affinity and spread-slot rows, a static score fn its soft
spread score; the host predicate checks the same per pair.
"""

from __future__ import annotations

import numpy as np

from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from ..models.resource import GPU_MEMORY_RESOURCE
from ..models.unschedule_info import (FitError, NODE_AFFINITY_FAILED,
                                      NODE_POD_NUMBER_EXCEEDED,
                                      NODE_PORT_FAILED, NODE_SELECTOR_FAILED,
                                      TAINT_FAILED)
from ..ops import constraints
from . import interpod

POD_AFFINITY_FAILED = "node(s) didn't match pod affinity/anti-affinity"
POD_TEMPLATE_KEY = "volcano.sh/template-uid"   # batch/v1alpha1/labels.go:37


class PredicateCache:
    """Per-(node, pod-template-uid) fit memo (predicates/cache.go): pods
    stamped with the same template annotation share one predicate verdict
    per node. The vectorized solver path gets the same effect from task
    grouping; this serves the host predicate path when
    ``predicate.CacheEnable`` is set."""

    def __init__(self):
        self._cache = {}   # node -> {template_uid: fit}

    @staticmethod
    def template_uid(pod) -> str:
        return pod.metadata.annotations.get(POD_TEMPLATE_KEY, "")

    def get(self, node_name: str, pod):
        uid = self.template_uid(pod)
        if not uid:
            return None
        return self._cache.get(node_name, {}).get(uid)

    def update(self, node_name: str, pod, fit: bool) -> None:
        uid = self.template_uid(pod)
        if uid:
            self._cache.setdefault(node_name, {})[uid] = fit


def _parse_proportional(args) -> dict:
    """predicate.resources.<name>.{cpu,memory} rates
    (predicates.go:124-151)."""
    get_str = args.get_str if hasattr(args, "get_str") else \
        (lambda k, d="": str(args.get(k, d) or d))
    get_f = args.get_float if hasattr(args, "get_float") else \
        (lambda k, d: float(args.get(k, d) or d))
    out = {}
    for res in get_str("predicate.resources", "").split(","):
        res = res.strip()
        if not res:
            continue
        cpu = get_f(f"predicate.resources.{res}.cpu", 1.0)
        mem = get_f(f"predicate.resources.{res}.memory", 1.0)
        out[res] = (cpu if cpu >= 0 else 1.0, mem if mem >= 0 else 1.0)
    return out


def _proportional_ok(task, node, proportional: dict) -> bool:
    """Reserve cpu/memory in proportion to a node's idle special resource
    (predicates/proportional.go): tasks NOT requesting the resource must
    leave idle_cpu >= idle_res * rate_cpu and likewise for memory."""
    for res in proportional:
        if task.resreq.get(res) > 0:
            return True   # requesters are exempt
    for res, (cpu_rate, mem_rate) in proportional.items():
        idle_res = node.idle.get(res)
        if idle_res <= 0:
            continue
        cpu_reserved = idle_res * cpu_rate
        mem_reserved = idle_res * mem_rate * 1000 * 1000
        if node.idle.milli_cpu - task.resreq.milli_cpu < cpu_reserved or \
                node.idle.memory - task.resreq.memory < mem_reserved:
            return False
    return True

NAME = "predicates"


class FitException(Exception):
    def __init__(self, fit_error: FitError):
        super().__init__(fit_error.error())
        self.fit_error = fit_error


def _node_selector_ok(task, node) -> bool:
    labels = node.node.metadata.labels if node.node is not None else {}
    for k, v in task.pod.spec.node_selector.items():
        if labels.get(k) != v:
            return False
    return True


def _node_affinity_ok(task, node) -> bool:
    aff = task.pod.spec.affinity
    if aff is None or aff.node_affinity is None or not aff.node_affinity.required:
        return True
    labels = node.node.metadata.labels if node.node is not None else {}
    return any(term.matches(labels) for term in aff.node_affinity.required)


def _taints_ok(task, node) -> bool:
    if node.node is None:
        return True
    for taint in node.node.spec.taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(tol.tolerates(taint) for tol in task.pod.spec.tolerations):
            return False
    return True


def _ports_ok(task, node) -> bool:
    want = set(task.pod.spec.host_ports)
    if not want:
        return True
    used = set()
    for t in node.tasks.values():
        used.update(t.pod.spec.host_ports)
    return not (want & used)


def _gpu_share_ok(task, node) -> bool:
    """GPU-share fit: some card must have enough free gpu-memory
    (predicates.go:343-352 + gpu.go checkNodeGPUSharingPredicate)."""
    mem = task.resreq.get(GPU_MEMORY_RESOURCE) / 1000.0
    if mem <= 0:
        return True
    idle = node.get_devices_idle_gpu_memory()
    return any(free >= mem for free in idle.values())


class PredicatesPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        args = self.arguments
        get_bool = args.get_bool if hasattr(args, "get_bool") else \
            (lambda k, d=False: str(args.get(k, d)).lower() in
             ("true", "1", "yes"))
        self.cache_enable = get_bool("predicate.CacheEnable", False)
        self.proportional = _parse_proportional(args) \
            if get_bool("predicate.ProportionalEnable", False) else {}
        self._pcache = PredicateCache()

    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn) -> None:
        # vectorized path: selector/taints/affinity matrices + extra masks
        if ssn.solver is not None and ssn.plugin_enabled(NAME, "enabledPredicate"):
            ssn.solver.enable_default_predicates = True
            ssn.solver.mark_vectorized(NAME)
            ssn.solver.add_mask_fn(self._ports_and_gpu_mask(ssn))
            ssn.solver.add_mask_fn(self._constraint_mask(ssn))
            ssn.solver.add_static_score_fn(self._constraint_score(ssn))
            if self.proportional:
                ssn.solver.add_mask_fn(self._proportional_mask())

        def stable_predicates(task, node):
            """Selector/affinity/taints — the template-cacheable filters
            (predicateByStablefilter, predicates.go:280-301)."""
            if not _node_selector_ok(task, node):
                return NODE_SELECTOR_FAILED
            if not _node_affinity_ok(task, node):
                return NODE_AFFINITY_FAILED
            if not _taints_ok(task, node):
                return TAINT_FAILED
            return None

        def predicate_fn(task, node):
            """Host path for single-pair probes."""
            cap = node.allocatable.max_task_num
            if cap and len(node.tasks) >= cap:
                raise FitException(FitError(task=task, node=node,
                                            reasons=[NODE_POD_NUMBER_EXCEEDED]))
            if self.cache_enable and PredicateCache.template_uid(task.pod):
                fit = self._pcache.get(node.name, task.pod)
                if fit is None:
                    reason = stable_predicates(task, node)
                    self._pcache.update(node.name, task.pod, reason is None)
                    if reason is not None:
                        raise FitException(FitError(task=task, node=node,
                                                    reasons=[reason]))
                elif not fit:
                    raise FitException(FitError(
                        task=task, node=node,
                        reasons=["equivalence cache predicates failed"]))
            else:
                reason = stable_predicates(task, node)
                if reason is not None:
                    raise FitException(FitError(task=task, node=node,
                                                reasons=[reason]))
            if not _ports_ok(task, node):
                raise FitException(FitError(task=task, node=node,
                                            reasons=[NODE_PORT_FAILED]))
            if not _gpu_share_ok(task, node):
                raise FitException(FitError(
                    task=task, node=node,
                    reasons=["node(s) didn't have enough free gpu memory"]))
            # InterPodAffinity filter (predicates.go:334-341)
            names = [n.name for n in ssn.node_list]
            index = interpod.get_index(ssn, names)
            if index.anti_required or interpod.task_has_pod_affinity(task):
                mask = index.required_mask(task)
                if mask is not None:
                    try:
                        i = names.index(node.name)
                    except ValueError:
                        i = -1
                    if i >= 0 and not mask[i]:
                        raise FitException(FitError(
                            task=task, node=node,
                            reasons=[POD_AFFINITY_FAILED]))
            # topology-spread / self-anti slot assignment (the per-pair
            # twin of the compiled constraint mask)
            if not constraints.node_satisfies_slots(ssn, task, node):
                raise FitException(FitError(
                    task=task, node=node,
                    reasons=["node(s) didn't satisfy topology spread "
                             "constraints"]))
            # proportional resource reserve (predicates.go:353-361)
            if self.proportional and \
                    not _proportional_ok(task, node, self.proportional):
                raise FitException(FitError(
                    task=task, node=node,
                    reasons=["proportional resource reserve check failed"]))

        ssn.add_predicate_fn(NAME, predicate_fn)

    def _proportional_mask(self):
        def mask_fn(batch, narr, feats):
            """Vectorized proportional reserve: for groups NOT requesting a
            proportional resource, nodes must keep idle cpu/mem above
            idle_res x rate after placement (proportional.go)."""
            mask = None   # None = pass-through (no dense [G,N] transfer)
            rindex = narr.rindex
            for res, (cpu_rate, mem_rate) in self.proportional.items():
                ri = rindex.index.get(res)
                if ri is None:
                    continue
                if mask is None:
                    mask = np.ones((batch.g_pad, narr.n_pad), bool)
                idle_res = narr.idle[:, ri] / rindex.scales[ri]   # raw units
                applies_node = idle_res > 0                        # [N]
                cpu_reserved = idle_res * cpu_rate                 # millicores
                mem_reserved = idle_res * mem_rate * 1e6 * \
                    rindex.scales[1]                               # scaled mem
                for g, ti in enumerate(batch.group_first):
                    rep = batch.tasks[ti]
                    if rep.resreq.get(res) > 0:
                        continue   # requesters are exempt
                    left_cpu = narr.idle[:, 0] - batch.group_req[g, 0]
                    left_mem = narr.idle[:, 1] - batch.group_req[g, 1]
                    ok = ~applies_node | ((left_cpu >= cpu_reserved)
                                          & (left_mem >= mem_reserved))
                    mask[g] &= ok
            return mask
        mask_fn.explain_label = "proportional"
        return mask_fn

    def _constraint_mask(self, ssn):
        """The constraint MASK (ops/constraints.py): inter-pod required
        (anti-)affinity and the topology-spread / self-anti slot rows,
        compiled, or per pair under ``constraints.compile: off``."""
        def mask_fn(batch, narr, feats):
            return constraints.constraint_mask(ssn, batch, narr)
        return mask_fn

    def _constraint_score(self, ssn):
        """The constraint SCORE: soft (ScheduleAnyway) topology spread;
        priority-tiered packing rides the priority plugin."""
        def score_fn(batch, narr, feats):
            return constraints.compile_score(ssn, batch, narr)
        return score_fn

    def _ports_and_gpu_mask(self, ssn):
        def mask_fn(batch, narr, feats):
            mask = None   # None = pass-through (no dense [G,N] transfer)
            # only sweep groups that actually use host ports or shared GPUs
            for g, ti in enumerate(batch.group_first):
                rep = batch.tasks[ti]
                uses_ports = bool(rep.pod.spec.host_ports)
                uses_gpu = rep.resreq.get(GPU_MEMORY_RESOURCE) > 0
                if not (uses_ports or uses_gpu):
                    continue
                if mask is None:
                    mask = np.ones((batch.g_pad, narr.n_pad), bool)
                for name, i in narr.name_to_idx.items():
                    node = ssn.nodes[name]
                    if uses_ports and not _ports_ok(rep, node):
                        mask[g, i] = False
                    elif uses_gpu and not _gpu_share_ok(rep, node):
                        mask[g, i] = False
            return mask
        mask_fn.explain_label = "ports_gpu"
        return mask_fn


register_plugin_builder(NAME, PredicatesPlugin)
