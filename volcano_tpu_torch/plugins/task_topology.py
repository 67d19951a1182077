"""task-topology plugin (the port's own copy of volcano_tpu/plugins/
task_topology.py; reference: pkg/scheduler/plugins/task-topology/
{topology,manager,bucket,util}.go).

Affinity/anti-affinity between task *types* within a job, read from
PodGroup annotations (volcano.sh/task-topology-affinity,
-anti-affinity, -task-order; "a,b;c" -> [[a,b],[c]]):

* buckets are greedily constructed per job, most-constrained tasks first
  (manager.go:266-319);
* TaskOrder interleaves buckets: bucketed before bucketless, bigger
  buckets first, same-bucket ties by affinity priority (topology.go:51-132);
* node score counts the task's bucket-mates already bound to the node,
  penalized by anti-affinity and by bucket overflow beyond the node's
  idle+releasing (topology.go:134-201), normalized by the job's max bucket
  size x plugin weight;
* allocate events migrate tasks from bucket pending-sets to per-node bound
  counts (topology.go:203-211, bucket.go:102-109).

Scores reach the placement kernel through a solver static-score fn that
re-reads the live bucket state at every ``place()`` call, so phase-level
placements see fresh bound counts; inside one call, the solver's bucket fn
(``BatchSolver.set_bucket_fn``) gives same-bucket tasks the kernel's pack
bonus, which stands in for the reference's per-task rescoring.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from ..framework.arguments import Arguments
from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from ..framework.session import EventHandler
from ..models.job_info import TaskStatus
from ..models.objects import TASK_SPEC_KEY
from ..models.resource import ZERO

NAME = "task-topology"

PLUGIN_WEIGHT = "task-topology.weight"
AFFINITY_ANNOTATION = "volcano.sh/task-topology-affinity"
ANTI_AFFINITY_ANNOTATION = "volcano.sh/task-topology-anti-affinity"
TASK_ORDER_ANNOTATION = "volcano.sh/task-topology-task-order"
OUT_OF_BUCKET = -1
MAX_NODE_SCORE = 100.0

# topology type -> priority (manager.go:40-46)
PRIO_SELF_ANTI_AFFINITY = 4
PRIO_INTER_AFFINITY = 3
PRIO_SELF_AFFINITY = 2
PRIO_INTER_ANTI_AFFINITY = 1


def get_task_name(task) -> str:
    return task.pod.metadata.annotations.get(TASK_SPEC_KEY, "")


def _req_score(res) -> float:
    """1 milli-cpu == 1 Mi == 1 scalar milli-unit (bucket.go:63-74)."""
    return (res.milli_cpu + res.memory / 1024 / 1024
            + sum(res.scalars.values()))


class Bucket:
    def __init__(self, index: int):
        self.index = index
        self.tasks: Dict[str, object] = {}       # uid -> TaskInfo (pending)
        self.task_name_set: Dict[str, int] = {}
        self.req_score = 0.0
        self.request = None                       # lazily cloned Resource
        self.bound_task = 0
        self.node: Dict[str, int] = {}            # node -> bound count

    def add_task(self, task_name: str, task) -> None:
        self.task_name_set[task_name] = self.task_name_set.get(task_name, 0) + 1
        if task.node_name:
            self.node[task.node_name] = self.node.get(task.node_name, 0) + 1
            self.bound_task += 1
            return
        self.tasks[task.uid] = task
        self.req_score += _req_score(task.resreq)
        if self.request is None:
            self.request = task.resreq.clone()
        else:
            self.request.add(task.resreq)

    def task_bound(self, task) -> None:
        self.node[task.node_name] = self.node.get(task.node_name, 0) + 1
        self.bound_task += 1
        if task.uid in self.tasks:
            del self.tasks[task.uid]
            self.req_score -= _req_score(task.resreq)
            if self.request is not None:
                for name in task.resreq.resource_names():
                    self.request.set(name, max(
                        0.0, self.request.get(name) - task.resreq.get(name)))


class JobManager:
    def __init__(self, job_uid: str):
        self.job_uid = job_uid
        self.buckets: List[Bucket] = []
        self.pod_in_bucket: Dict[str, int] = {}
        self.pod_in_task: Dict[str, str] = {}
        self.task_affinity_priority: Dict[str, int] = {}
        self.task_exist_order: Dict[str, int] = {}
        self.inter_affinity: Dict[str, Set[str]] = {}
        self.self_affinity: Set[str] = set()
        self.inter_anti_affinity: Dict[str, Set[str]] = {}
        self.self_anti_affinity: Set[str] = set()
        self.bucket_max_size = 0
        self.node_task_set: Dict[str, Dict[str, int]] = {}

    # -- topology ingestion (manager.go:103-150) ---------------------------

    def _mark(self, task_name: str, priority: int) -> None:
        if priority > self.task_affinity_priority.get(task_name, 0):
            self.task_affinity_priority[task_name] = priority

    def apply_task_topology(self, affinity, anti_affinity, task_order) -> None:
        for aff in affinity or []:
            if len(aff) == 1:
                self.self_affinity.add(aff[0])
                self._mark(aff[0], PRIO_SELF_AFFINITY)
                continue
            for i, src in enumerate(aff):
                for dst in aff[:i]:
                    self.inter_affinity.setdefault(src, set()).add(dst)
                    self.inter_affinity.setdefault(dst, set()).add(src)
                self._mark(src, PRIO_INTER_AFFINITY)
        for aff in anti_affinity or []:
            if len(aff) == 1:
                self.self_anti_affinity.add(aff[0])
                self._mark(aff[0], PRIO_SELF_ANTI_AFFINITY)
                continue
            for i, src in enumerate(aff):
                for dst in aff[:i]:
                    self.inter_anti_affinity.setdefault(src, set()).add(dst)
                    self.inter_anti_affinity.setdefault(dst, set()).add(src)
                self._mark(src, PRIO_INTER_ANTI_AFFINITY)
        order = task_order or []
        for i, task_name in enumerate(order):
            self.task_exist_order[task_name] = len(order) - i

    # -- bucket construction (manager.go:203-319) --------------------------

    def task_affinity_order(self, l, r) -> int:
        lname = self.pod_in_task.get(l.uid, "")
        rname = self.pod_in_task.get(r.uid, "")
        if lname == rname:
            return 0
        lo = self.task_exist_order.get(lname, 0)
        ro = self.task_exist_order.get(rname, 0)
        if lo != ro:
            return 1 if lo > ro else -1
        lp = self.task_affinity_priority.get(lname, 0)
        rp = self.task_affinity_priority.get(rname, 0)
        if lp != rp:
            return 1 if lp > rp else -1
        return 0

    def check_task_set_affinity(self, task_name: str,
                                task_name_set: Dict[str, int],
                                only_anti: bool) -> int:
        score = 0
        if not task_name:
            return score
        for name_in_bucket, count in task_name_set.items():
            same = name_in_bucket == task_name
            if not only_anti:
                affinity = (task_name in self.self_affinity) if same else \
                    (name_in_bucket in self.inter_affinity.get(task_name, ()))
                if affinity:
                    score += count
            anti = (task_name in self.self_anti_affinity) if same else \
                (name_in_bucket in self.inter_anti_affinity.get(task_name, ()))
            if anti:
                score -= count
        return score

    def construct_buckets(self, tasks: Dict[str, object]) -> None:
        import functools
        without_bucket = []
        for task in tasks.values():
            task_name = get_task_name(task)
            if not task_name or task_name not in self.task_affinity_priority:
                self.pod_in_bucket[task.uid] = OUT_OF_BUCKET
                continue
            self.pod_in_task[task.uid] = task_name
            without_bucket.append(task)

        def order(l, r):
            """Bound tasks first, then by affinity order descending
            (util.go:88-119 reversed)."""
            lb, rb = bool(l.node_name), bool(r.node_name)
            if lb or rb:
                if lb != rb:
                    return -1 if lb else 1
                return -1 if l.node_name > r.node_name else 1
            v = self.task_affinity_order(l, r)
            if v == 0:
                return -1 if l.name > r.name else 1
            return -v

        without_bucket.sort(key=functools.cmp_to_key(order))
        self._build_buckets(without_bucket)

    def _build_buckets(self, ordered) -> None:
        node_bucket: Dict[str, Bucket] = {}
        for task in ordered:
            task_name = get_task_name(task)
            selected: Optional[Bucket] = None
            max_affinity = -(2 ** 31)
            if task.node_name:
                max_affinity = 0
                selected = node_bucket.get(task.node_name)
            else:
                for bucket in self.buckets:
                    aff = self.check_task_set_affinity(
                        task_name, bucket.task_name_set, False)
                    if aff > max_affinity:
                        max_affinity = aff
                        selected = bucket
                    elif (aff == max_affinity and selected is not None
                          and bucket.req_score < selected.req_score):
                        selected = bucket
            if max_affinity < 0 or selected is None:
                selected = Bucket(len(self.buckets))
                self.buckets.append(selected)
                if task.node_name:
                    node_bucket[task.node_name] = selected
            self.pod_in_bucket[task.uid] = selected.index
            selected.add_task(task_name, task)
            size = len(selected.tasks) + selected.bound_task
            if size > self.bucket_max_size:
                self.bucket_max_size = size

    def get_bucket(self, task) -> Optional[Bucket]:
        idx = self.pod_in_bucket.get(task.uid, OUT_OF_BUCKET)
        if idx == OUT_OF_BUCKET:
            return None
        return self.buckets[idx]

    def task_bound(self, task) -> None:
        task_name = get_task_name(task)
        if task_name:
            self.node_task_set.setdefault(task.node_name, {})
            s = self.node_task_set[task.node_name]
            s[task_name] = s.get(task_name, 0) + 1
        bucket = self.get_bucket(task)
        if bucket is not None:
            bucket.task_bound(task)


def parse_affinity_annotation(raw: Optional[str],
                              valid_names: Set[str]) -> Optional[List[List[str]]]:
    """"a,b;c" -> [[a, b], [c]], validated against the job's task-spec names
    (topology.go:239-287; validation keys off TaskSpecKey annotations rather
    than the reference's pod-name parsing)."""
    if raw is None:
        return None
    groups = []
    for part in str(raw).split(";"):
        names = [n for n in (x.strip() for x in part.split(",")) if n]
        if not names:
            continue
        seen = set()
        for n in names:
            if n not in valid_names or n in seen:
                return None
            seen.add(n)
        groups.append(names)
    return groups or None


class TaskTopologyPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = Arguments(arguments or {})
        self.weight = self.arguments.get_int(PLUGIN_WEIGHT, 1)
        self.managers: Dict[str, JobManager] = {}

    def name(self) -> str:
        return NAME

    # -- session wiring ----------------------------------------------------

    def _init_buckets(self, ssn) -> None:
        for uid, job in ssn.jobs.items():
            if not job.task_status_index.get(TaskStatus.Pending, {}):
                continue
            if job.pod_group is None:
                continue
            ann = job.pod_group.metadata.annotations
            raws = (ann.get(AFFINITY_ANNOTATION),
                    ann.get(ANTI_AFFINITY_ANNOTATION),
                    ann.get(TASK_ORDER_ANNOTATION))
            if all(r is None for r in raws):
                continue
            valid = {get_task_name(t) for t in job.tasks.values()} - {""}
            # any present-but-invalid annotation aborts the whole job's
            # topology (topology.go:289-334 returns error on any parse
            # failure)
            affinity = anti = order = None
            invalid = False
            if raws[0] is not None:
                affinity = parse_affinity_annotation(raws[0], valid)
                invalid |= affinity is None
            if raws[1] is not None:
                anti = parse_affinity_annotation(raws[1], valid)
                invalid |= anti is None
            if raws[2] is not None:
                parsed = parse_affinity_annotation(raws[2], valid)
                if parsed:
                    order = [n for grp in parsed for n in grp]
                else:
                    invalid = True
            if invalid:
                continue
            manager = JobManager(uid)
            manager.apply_task_topology(affinity, anti, order)
            manager.construct_buckets(job.tasks)
            self.managers[uid] = manager

    def task_order_fn(self, l, r) -> int:
        """Interleave: bucketed < bucketless; bigger bucket first; older
        bucket first; same bucket by affinity order (topology.go:51-132)."""
        lm, rm = self.managers.get(l.job), self.managers.get(r.job)
        if lm is None or rm is None:
            return 0
        lb, rb = lm.get_bucket(l), rm.get_bucket(r)
        if (lb is not None) != (rb is not None):
            return -1 if lb is not None else 1
        if l.job != r.job:
            return 0
        if lb is None and rb is None:
            return 0
        if len(lb.tasks) != len(rb.tasks):
            return -1 if len(lb.tasks) > len(rb.tasks) else 1
        if lb.index == rb.index:
            return -lm.task_affinity_order(l, r)
        return -1 if lb.index < rb.index else 1

    def calc_bucket_score(self, task, node) -> tuple:
        """(score, manager) for one task x node (topology.go:134-187)."""
        max_resource = node.idle.clone().add(node.releasing)
        if task.resreq is not None and \
                max_resource.less_partly(task.resreq, ZERO):
            return 0, None
        manager = self.managers.get(task.job)
        if manager is None:
            return 0, None
        bucket = manager.get_bucket(task)
        if bucket is None:
            return 0, manager
        score = bucket.node.get(node.name, 0)
        node_task_set = manager.node_task_set.get(node.name)
        if node_task_set:
            aff = manager.check_task_set_affinity(
                get_task_name(task), node_task_set, True)
            if aff < 0:
                score += aff
        score += len(bucket.tasks)
        if bucket.request is None or bucket.request.less_equal(max_resource,
                                                               ZERO):
            return score, manager
        remains = bucket.request.clone()
        for uid, btask in bucket.tasks.items():
            if uid == task.uid or btask.resreq is None:
                continue
            for name in btask.resreq.resource_names():
                remains.set(name, max(0.0, remains.get(name)
                                      - btask.resreq.get(name)))
            score -= 1
            if remains.less_equal(max_resource, ZERO):
                break
        return score, manager

    def node_order_fn(self, task, node) -> float:
        score, manager = self.calc_bucket_score(task, node)
        fscore = float(score * self.weight)
        if manager is not None and manager.bucket_max_size != 0:
            fscore = fscore * MAX_NODE_SCORE / manager.bucket_max_size
        return fscore

    def _vector_scores(self, ssn, batch, narr) -> np.ndarray:
        """calc_bucket_score over all (group, node) pairs as numpy array
        math: bound-mate counts and anti-affinity penalties are scattered
        from the (small) bucket dicts, the bucket-overflow reduction is a
        cumsum/argmax over bucket mates — no per-node Python scoring."""
        rindex = ssn.solver.rindex
        n_pad = narr.idle.shape[0]
        if not self.managers:
            return None   # pass-through (no dense [G,N] transfer)
        relevant = [(g, batch.tasks[m[0]]) for g, m in
                    enumerate(batch.group_members)
                    if batch.tasks[m[0]].job in self.managers]
        if not relevant:
            return None
        out = np.zeros((batch.g_pad, n_pad), np.float32)
        # idle + releasing per node (topology.go:136), one host pass
        max_res = np.zeros((n_pad, rindex.r), np.float32)
        for i, name in enumerate(narr.names):
            node = ssn.nodes.get(name)
            if node is not None:
                max_res[i] = (rindex.vec(node.idle)
                              + rindex.vec(node.releasing))
        eps = rindex.eps
        for g, rep in relevant:
            manager = self.managers[rep.job]
            bucket = manager.get_bucket(rep)
            if bucket is None:
                continue
            req = rindex.vec(rep.resreq)
            prefit_ok = ~np.any(max_res + eps[None, :] < req[None, :], axis=1)
            score = np.zeros(n_pad, np.float32)
            for node_name, cnt in bucket.node.items():
                i = narr.name_to_idx.get(node_name)
                if i is not None:
                    score[i] += cnt
            task_name = get_task_name(rep)
            for node_name, tset in manager.node_task_set.items():
                i = narr.name_to_idx.get(node_name)
                if i is None:
                    continue
                aff = manager.check_task_set_affinity(task_name, tset, True)
                if aff < 0:
                    score[i] += aff
            score += len(bucket.tasks)
            if bucket.request is not None:
                # evict mates from the virtual bucket until it fits each
                # node: cumsum + first-fit argmax (topology.go:166-186)
                breq = rindex.vec(bucket.request)
                mates = [t for uid, t in bucket.tasks.items()
                         if uid != rep.uid and t.resreq is not None]
                mres = (np.stack([rindex.vec(t.resreq) for t in mates])
                        if mates else np.zeros((0, rindex.r), np.float32))
                cum = np.concatenate(
                    [np.zeros((1, rindex.r), np.float32),
                     np.cumsum(mres, axis=0)], axis=0)        # [V+1, R]
                rem = breq[None, :] - cum                      # [V+1, R]
                fits = np.all(rem[None, :, :] <= max_res[:, None, :]
                              + eps[None, None, :], axis=2)    # [N, V+1]
                kmin = np.argmax(fits, axis=1)
                k = np.where(np.any(fits, axis=1), kmin, len(mates))
                score = score - k
            fscore = score * float(self.weight)
            if manager.bucket_max_size:
                fscore = fscore * MAX_NODE_SCORE / manager.bucket_max_size
            out[g] = np.where(prefit_ok, fscore, 0.0)
        return out

    def on_session_open(self, ssn) -> None:
        self._init_buckets(ssn)
        ssn.add_task_order_fn(NAME, self.task_order_fn)
        ssn.add_node_order_fn(NAME, self.node_order_fn)

        def allocate_fn(event):
            manager = self.managers.get(event.task.job)
            if manager is not None:
                manager.task_bound(event.task)

        ssn.add_event_handler(EventHandler(allocate_func=allocate_fn))

        if ssn.solver is not None and ssn.plugin_enabled(NAME,
                                                         "enabledNodeOrder"):
            def score_fn(batch, narr, feats):
                return self._vector_scores(ssn, batch, narr)
            ssn.solver.add_static_score_fn(score_fn)

            def bucket_fn(task):
                """Same-bucket mates attract inside the scan: per-mate bonus
                mirrors one bound bucket mate's worth of node score."""
                manager = self.managers.get(task.job)
                if manager is None:
                    return None
                bucket = manager.get_bucket(task)
                if bucket is None:
                    return None
                bonus = float(self.weight)
                if manager.bucket_max_size:
                    bonus = bonus * MAX_NODE_SCORE / manager.bucket_max_size
                return (task.job, bucket.index), bonus
            ssn.solver.set_bucket_fn(bucket_fn)

    def on_session_close(self, ssn) -> None:
        self.managers = {}


register_plugin_builder(NAME, TaskTopologyPlugin)
