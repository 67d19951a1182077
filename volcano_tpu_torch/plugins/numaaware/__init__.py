"""numaaware plugin (the port's own copy of
volcano_tpu/plugins/numaaware/; reference: pkg/scheduler/plugins/
numaaware/numaaware.go): topology-manager-style NUMA admission and scoring.

Extension points: Predicate (per-task policy admission + tentative CPU-set
assignment), BatchNodeOrder (fewer NUMA nodes spanned scores higher),
EventHandler (allocate/release assigned sets against the session view), and
OnSessionClose (push allocated sets back through the cache,
UpdateSchedulerNumaInfo).

Host-side by design: NUMA admission runs only for Guaranteed pods with a
topology policy, a rare, deeply branchy per-node decision (hint powersets
over <=8 NUMA nodes). Its predicate is a host predicate: the solver sweeps
it over every (task group, node) pair into the static mask
(framework/solver.py:host_predicate_mask), which the gang-allocate kernel
reads with the rest of the mask.

The per-pair verdict (admission and the tentative CPU sets) is a pure
function of the task's NUMA-relevant shape (its topology policy and each
container's exclusive CPU count), the node's topology (policies, CPU
layout, reserved CPUs, NUMA ids) and the node's free id-sets at that
moment; the plugin evaluates it once per distinct triple in a session
(``_verdict``) and reuses it, with the reference's vetoes and messages.
An assignment may thus be shared by many (task, node) entries of
``assign_res``: nothing mutates one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ...framework.plugin import Plugin
from ...framework.registry import register_plugin_builder
from ...models.resource import CPU, milli_value
from . import policy as numa_policy
from .cpumanager import CPUDetails, CpuManager, guaranteed_cpus
from .policy import (CPU_MANAGER_POLICY, POLICY_NONE,
                     TOPOLOGY_MANAGER_POLICY, accumulate_providers_hints,
                     get_policy, mask_bits)

NAME = "numa-aware"
WEIGHT_ARG = "weight"

# the kinds of a memoized verdict: an assignment (or None, out of scope),
# a policy-filter veto reason, or the index of the container the policy
# refused
_ASSIGN, _REASON, _REFUSED = 0, 1, 2
_UNSEEN = object()


def is_guaranteed(pod) -> bool:
    """k8s Guaranteed QoS: every container's requests == limits with both
    cpu and memory set (v1qos.GetPodQOS, numaaware.go:117)."""
    containers = pod.spec.containers + pod.spec.init_containers
    if not containers:
        return False
    for c in containers:
        if not c.requests or not c.limits:
            return False
        if CPU not in c.requests or "memory" not in c.requests:
            return False
        for res, req in c.requests.items():
            lim = c.limits.get(res)
            if lim is None or milli_value(lim) != milli_value(req):
                return False
    return True


def generate_numa_nodes(nodes) -> Dict[str, List[int]]:
    """api.GenerateNumaNodes — NUMA node ids per node."""
    out = {}
    for name, node in nodes.items():
        if node.numa_scheduler_info is not None:
            out[name] = CPUDetails(
                node.numa_scheduler_info.cpu_detail).numa_nodes()
    return out


def generate_node_res_numa_sets(nodes) -> Dict[str, Dict[str, Set[int]]]:
    """api.GenerateNodeResNumaSets — allocatable id-sets per node/resource."""
    out = {}
    for name, node in nodes.items():
        if node.numa_scheduler_info is None:
            continue
        out[name] = {res: set(ri.allocatable)
                     for res, ri in node.numa_scheduler_info.numa_res_map.items()}
    return out


class NumaAwarePlugin(Plugin):
    def __init__(self, arguments=None):
        args = arguments or {}
        if hasattr(args, "get_int"):
            self.weight = args.get_int(WEIGHT_ARG, 1)
        else:
            self.weight = int(args.get(WEIGHT_ARG, 1))
        self.hint_providers = [CpuManager()]
        # taskUID -> {node name -> {res -> set of ids}} (numaaware.go:52-55)
        self.assign_res: Dict[str, Dict[str, Dict[str, Set[int]]]] = {}
        self.node_res_sets: Dict[str, Dict[str, Set[int]]] = {}
        self.task_bind_node: Dict[str, str] = {}
        # the session's verdict memo (_verdict): task uid -> task key
        # (None: not Guaranteed), node name -> (its free-set version, node
        # key id), the interned node keys, the per-node versions bumped by
        # every change of node_res_sets, and (task key, node key id) ->
        # verdict
        self._task_keys: Dict[str, Optional[tuple]] = {}
        self._node_keys: Dict[str, Tuple[int, int]] = {}
        self._node_key_ids: Dict[tuple, int] = {}
        self._versions: Dict[str, int] = {}
        self._verdicts: Dict[Tuple[tuple, int], tuple] = {}

    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn) -> None:
        numa_nodes = generate_numa_nodes(ssn.nodes)
        self.node_res_sets = generate_node_res_numa_sets(ssn.nodes)

        from ...framework.session import EventHandler

        def on_allocate(event) -> None:
            """numaaware.go:86-100. The batch solver evaluates host
            predicates once per task group, so a non-representative task may
            arrive here without a tentative assignment — compute it now
            against the current NUMA view (feasibility was already checked
            group-wide; this keeps per-task CPU sets exact)."""
            task = event.task
            per_node = self.assign_res.get(task.uid)
            sets = per_node.get(task.node_name) if per_node else None
            if sets is None:
                node = ssn.nodes.get(task.node_name)
                if node is None:
                    return
                try:
                    sets = self._compute_assign(task, node, numa_nodes)
                except ValueError:
                    sets = None
                if sets is None:
                    return
                self.assign_res.setdefault(task.uid, {})[task.node_name] = sets
            node_sets = self.node_res_sets.get(task.node_name)
            if node_sets is not None:
                for res, taken in sets.items():
                    node_sets.setdefault(res, set()).difference_update(taken)
                self._bump(task.node_name)
            self.task_bind_node[task.uid] = task.node_name

        def on_deallocate(event) -> None:
            """numaaware.go:101-114"""
            task = event.task
            per_node = self.assign_res.get(task.uid)
            if per_node is None:
                return
            sets = per_node.get(task.node_name)
            if sets is None:
                return
            self.task_bind_node.pop(task.uid, None)
            node_sets = self.node_res_sets.get(task.node_name)
            if node_sets is not None:
                for res, returned in sets.items():
                    node_sets.setdefault(res, set()).update(returned)
                self._bump(task.node_name)

        ssn.add_event_handler(EventHandler(allocate_func=on_allocate,
                                           deallocate_func=on_deallocate))

        task_keys = self._task_keys

        def predicate_fn(task, node) -> None:
            """numaaware.go:116-157 — policy admission + tentative assign
            (a task that is not Guaranteed returns at the first lookup:
            the host sweep calls this for every group and node)."""
            tkey = task_keys.get(task.uid, _UNSEEN)
            if tkey is _UNSEEN:
                tkey = self._task_key(task)
            if tkey is None:
                return
            sets = self._assign_of(tkey, task, node, numa_nodes)
            if sets is not None:
                self.assign_res.setdefault(task.uid, {})[node.name] = sets

        ssn.add_predicate_fn(NAME, predicate_fn)

        def batch_node_order_fn(task, node_infos) -> Dict[str, float]:
            """numaaware.go:160-183 — fewer NUMA nodes spanned is better."""
            scores: Dict[str, float] = {}
            if task.topology_policy in ("", POLICY_NONE):
                return scores
            per_node = self.assign_res.get(task.uid)
            if not per_node:
                return scores
            numa_counts: Dict[str, int] = {}
            for node in node_infos:
                sets = per_node.get(node.name)
                if sets is None or node.numa_scheduler_info is None:
                    continue
                details = CPUDetails(node.numa_scheduler_info.cpu_detail)
                spanned = {details.numa_of(c) for c in sets.get(CPU, set())
                           if c in details.detail}
                numa_counts[node.name] = len(spanned)
            if not numa_counts:
                return scores
            # NormalizeScore(100, reverse=True): fewest NUMA nodes -> 100
            max_count = max(numa_counts.values()) or 1
            for name, count in numa_counts.items():
                scores[name] = (100.0 * (max_count - count) / max_count) \
                    * self.weight
            return scores

        ssn.add_batch_node_order_fn(NAME, batch_node_order_fn)

    def _compute_assign(self, task, node, numa_nodes):
        """Policy admission + per-container CPU-set assignment
        (numaaware.go:116-157). Returns {res: set} or None when the task is
        out of scope; raises ValueError when the node must be rejected."""
        tkey = self._task_key(task)
        if tkey is None:
            return None
        return self._assign_of(tkey, task, node, numa_nodes)

    # -- the verdict memo ---------------------------------------------------

    def _task_key(self, task) -> Optional[tuple]:
        """What of the task the verdict reads: None when it is not
        Guaranteed (out of scope), else its topology policy and each
        container's exclusive CPU count."""
        key = None
        if is_guaranteed(task.pod):
            key = (task.topology_policy,
                   tuple(guaranteed_cpus(c) for c in task.pod.spec.containers))
        self._task_keys[task.uid] = key
        return key

    def _bump(self, node_name: str) -> None:
        self._versions[node_name] = self._versions.get(node_name, 0) + 1

    def _node_key(self, node, numa_nodes) -> int:
        """The interned id of what of the node the verdict reads: its
        topology (None without one) and its free id-sets now."""
        name = node.name
        version = self._versions.get(name, 0)
        hit = self._node_keys.get(name)
        if hit is not None and hit[0] == version:
            return hit[1]
        info = node.numa_scheduler_info
        shape = None
        if info is not None:
            shape = (tuple(sorted(info.policies.items())),
                     tuple(sorted(info.res_reserved.items())),
                     tuple((i, c.numa_id, c.socket_id, c.core_id)
                           for i, c in info.cpu_detail.items()),
                     tuple(numa_nodes.get(name, ())))
        sets = self.node_res_sets.get(name)
        free = None if sets is None else \
            tuple((res, frozenset(ids)) for res, ids in sets.items())
        key = (shape, free)
        kid = self._node_key_ids.get(key)
        if kid is None:
            kid = self._node_key_ids[key] = len(self._node_key_ids)
        self._node_keys[name] = (version, kid)
        return kid

    def _assign_of(self, tkey, task, node, numa_nodes):
        """The memoized verdict of a Guaranteed task on ``node``: the
        assignment, or the reference's ValueError."""
        mkey = (tkey, self._node_key(node, numa_nodes))
        verdict = self._verdicts.get(mkey)
        if verdict is None:
            verdict = self._verdicts[mkey] = self._verdict(task, node,
                                                          numa_nodes)
        kind, value = verdict
        if kind == _ASSIGN:
            return value
        if kind == _REASON:
            raise ValueError(value)
        raise ValueError(
            f"plugin {NAME} predicates failed for task {task.name} "
            f"container {task.pod.spec.containers[value].name} on node "
            f"{node.name}")

    def _verdict(self, task, node, numa_nodes) -> tuple:
        """The reference's admission and assignment of a Guaranteed task
        on ``node`` (numaaware.go:116-157), as (kind, value)."""
        fit, reason = self._filter_node_by_policy(task, node)
        if not fit:
            if reason:
                return _REASON, reason
            return _ASSIGN, None
        res_numa_sets = {res: set(ids) for res, ids in
                         self.node_res_sets.get(node.name, {}).items()}
        task_policy = get_policy(node, numa_nodes.get(node.name, []))
        all_assign: Dict[str, Set[int]] = {}
        for idx, container in enumerate(task.pod.spec.containers):
            providers_hints = accumulate_providers_hints(
                container, node.numa_scheduler_info, res_numa_sets,
                self.hint_providers)
            best_hint, admit = task_policy.predicate(providers_hints)
            if not admit:
                return _REFUSED, idx
            assign = numa_policy.allocate(
                container, best_hint, node.numa_scheduler_info,
                res_numa_sets, self.hint_providers)
            for res, ids in assign.items():
                all_assign.setdefault(res, set()).update(ids)
                res_numa_sets.setdefault(res, set()).difference_update(ids)
        return _ASSIGN, all_assign

    def _filter_node_by_policy(self, task, node):
        """numaaware.go:186-225 -> (fit, error_reason|None)"""
        info = node.numa_scheduler_info
        if task.topology_policy not in ("", POLICY_NONE):
            if info is None:
                return False, "numa info is empty"
            if info.policies.get(CPU_MANAGER_POLICY) != "static":
                return False, "cpu manager policy isn't static"
            if task.topology_policy != info.policies.get(TOPOLOGY_MANAGER_POLICY):
                return False, (
                    f"task topology policy[{task.topology_policy}] is "
                    f"different with node"
                    f"[{info.policies.get(TOPOLOGY_MANAGER_POLICY)}]")
            if node.name not in self.node_res_sets:
                return False, "no topo information"
            if not self.node_res_sets[node.name].get(CPU):
                return False, "cpu allocatable map is empty"
            return True, None
        # tasks without a policy: NUMA-manage them only on static+managed
        # nodes, silently skip elsewhere
        if info is None:
            return False, None
        if info.policies.get(CPU_MANAGER_POLICY) != "static":
            return False, None
        if info.policies.get(TOPOLOGY_MANAGER_POLICY, "") in ("", POLICY_NONE):
            return False, None
        return True, None

    def on_session_close(self, ssn) -> None:
        """numaaware.go:251-279 — aggregate bound assignments, push to cache."""
        if not self.task_bind_node:
            return
        allocated: Dict[str, Dict[str, Set[int]]] = {}
        for task_uid, node_name in self.task_bind_node.items():
            sets = self.assign_res.get(task_uid, {}).get(node_name)
            if sets is None:
                continue
            node_alloc = allocated.setdefault(node_name, {})
            for res, ids in sets.items():
                node_alloc.setdefault(res, set()).update(ids)
        ssn.cache.update_scheduler_numa_info(allocated)


register_plugin_builder(NAME, NumaAwarePlugin)
