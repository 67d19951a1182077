"""tdm (time-division multiplexing) plugin (the port's own copy of
volcano_tpu/plugins/tdm.py; reference: pkg/scheduler/plugins/tdm/
tdm.go).

Revocable nodes carry a ``tdm.revocable-zone.<name>`` time window argument
("HH:MM-HH:MM"); inside the window only revocable-zone-annotated tasks may
land there (predicate + max-score node order). Outside the window,
VictimTasks drains preemptable pods from the zone's nodes in
``tdm.evict.period`` steps bounded by the job's disruption budget.
Preemptable jobs order first for placement and cannot themselves preempt.

The predicate/score pair is contributed to the batch solver as a
vectorized [G, N] mask/score (computed from the zone clock host-side),
so the allocate scan and preempt/backfill feasibility see it natively.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from ..framework.session import PERMIT, REJECT
from ..models.job_info import TaskStatus, parse_duration

NAME = "tdm"

REVOCABLE_ZONE_PREFIX = "tdm.revocable-zone."
EVICT_PERIOD = "tdm.evict.period"
EVICT_MAX_STEP = "tdm.evict.max-step"
DEFAULT_POD_EVICT_NUM = 1
MAX_NODE_SCORE = 100.0

_last_evict_at = 0.0


def parse_revocable_zone(raw: str) -> Optional[tuple]:
    """"HH:MM-HH:MM" -> (start_min, end_min) minutes-of-day; an end at or
    before the start rolls into the next day (tdm.go:89-117)."""
    parts = str(raw).strip().split("-")
    if len(parts) != 2:
        return None
    try:
        h1, m1 = (int(x) for x in parts[0].split(":"))
        h2, m2 = (int(x) for x in parts[1].split(":"))
    except ValueError:
        return None
    start, end = h1 * 60 + m1, h2 * 60 + m2
    if start >= end:
        end += 24 * 60
    return start, end


class TdmPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        self.revocable_zone: Dict[str, str] = {}
        self.evict_period = 60.0
        for k, v in self.arguments.items():
            if REVOCABLE_ZONE_PREFIX in str(k):
                self.revocable_zone[str(k).replace(REVOCABLE_ZONE_PREFIX,
                                                   "", 1)] = v
        if EVICT_PERIOD in self.arguments:
            d = parse_duration(self.arguments[EVICT_PERIOD])
            if d is not None:
                self.evict_period = d

    def name(self) -> str:
        return NAME

    # -- zone clock --------------------------------------------------------

    def available_revocable_zone(self, rz: str) -> bool:
        raw = self.revocable_zone.get(rz)
        if raw is None:
            return False
        window = parse_revocable_zone(raw)
        if window is None:
            return False
        start, end = window
        lt = time.localtime()
        now_min = lt.tm_hour * 60 + lt.tm_min
        return start <= now_min <= end or start <= now_min + 24 * 60 <= end

    # -- session hooks -----------------------------------------------------

    def on_session_open(self, ssn) -> None:
        def predicate_fn(task, node):
            """Revocable nodes only admit revocable-zone tasks inside the
            active window (tdm.go:146-167)."""
            if not node.revocable_zone:
                return
            if not self.available_revocable_zone(node.revocable_zone):
                raise RuntimeError(
                    f"plugin {NAME} predicates: current time beyond "
                    f"revocable zone {node.revocable_zone}")
            if not task.revocable_zone:
                raise RuntimeError(
                    f"plugin {NAME} predicates: task {task.namespace}/"
                    f"{task.name} not allowed on revocable node {node.name}")

        ssn.add_predicate_fn(NAME, predicate_fn)

        def node_order_fn(task, node):
            """Max score steers revocable tasks onto active revocable nodes
            (tdm.go:169-190)."""
            if not node.revocable_zone:
                return 0.0
            if not self.available_revocable_zone(node.revocable_zone):
                return 0.0
            if not task.revocable_zone:
                return 0.0
            return MAX_NODE_SCORE

        ssn.add_node_order_fn(NAME, node_order_fn)

        if ssn.solver is not None:
            if ssn.plugin_enabled(NAME, "enabledPredicate"):
                ssn.solver.mark_vectorized(NAME)
                ssn.solver.add_mask_fn(self._solver_mask(ssn))
            if ssn.plugin_enabled(NAME, "enabledNodeOrder"):
                ssn.solver.add_static_score_fn(self._solver_score(ssn))

        def preemptable_fn(preemptor, preemptees):
            """Preemptable / revocable workloads cannot preempt; victims are
            preemptable Running tasks on non-revocable nodes, bounded per
            job by its disruption budget (tdm.go:192-230)."""
            if preemptor.preemptable or preemptor.revocable_zone:
                return [], REJECT
            tasks_by_job: Dict[str, List] = {}
            for task in preemptees:
                if not task.preemptable or task.status != TaskStatus.Running:
                    continue
                node = ssn.nodes.get(task.node_name)
                if node is None or node.revocable_zone:
                    continue
                tasks_by_job.setdefault(task.job, []).append(task)
            victims = []
            for job_uid, tasks in tasks_by_job.items():
                job = ssn.jobs.get(job_uid)
                if job is not None:
                    victims.extend(self._max_victims(job, tasks))
            return victims, PERMIT

        ssn.add_preemptable_fn(NAME, preemptable_fn)

        def victims_fn():
            """Outside the window, drain preemptable pods from the zone's
            nodes once per evict period (tdm.go:232-260)."""
            # wall time on purpose (not ssn.clock): tdm is time-of-day
            # multiplexing — the zone windows above parse against
            # time.localtime() — and _last_evict_at is a module global
            # shared across schedulers in-process, so mixing timebases
            # here would leak virtual stamps into production pacing
            global _last_evict_at
            if _last_evict_at + self.evict_period > time.time():   # lint: allow(clock-discipline): time-of-day multiplexing is wall-clock by design (windows parse against localtime; see comment above)
                return []
            victims = []
            for rz in self.revocable_zone:
                if self.available_revocable_zone(rz):
                    continue
                tasks_by_job: Dict[str, List] = {}
                for node in ssn.revocable_nodes.values():
                    if node.revocable_zone != rz:
                        continue
                    for task in node.tasks.values():
                        if task.preemptable and task.status == TaskStatus.Running:
                            tasks_by_job.setdefault(task.job, []).append(task)
                for job_uid, tasks in tasks_by_job.items():
                    job = ssn.jobs.get(job_uid)
                    if job is not None:
                        victims.extend(self._max_victims(job, tasks))
            _last_evict_at = time.time()   # lint: allow(clock-discipline): wall-clock by design — shared module-global evict pacing, see comment above
            return victims

        ssn.add_victim_tasks_fns(NAME, victims_fn)

        def job_order_fn(l, r):
            """Non-preemptable jobs place first (tdm.go:262-275)."""
            if l.preemptable == r.preemptable:
                return 0
            return -1 if not l.preemptable else 1

        ssn.add_job_order_fn(NAME, job_order_fn)

        def job_pipelined_fn(job):
            occupied = job.waiting_task_num() + job.ready_task_num()
            return PERMIT if occupied >= job.min_available else REJECT

        ssn.add_job_pipelined_fn(NAME, job_pipelined_fn)

        def job_starving_fn(job):
            """Preemptable (elastic) jobs never count as starving; others
            starve while they have pending tasks (tdm.go:287-294)."""
            if job.preemptable:
                return False
            return len(job.task_status_index.get(TaskStatus.Pending, {})) > 0

        ssn.add_job_starving_fns(NAME, job_starving_fn)

    # -- vectorized contributions -----------------------------------------

    def _node_zone_state(self, ssn, narr):
        """Per node: (is_revocable, zone_active) numpy arrays."""
        n_pad = narr.idle.shape[0]
        revocable = np.zeros(n_pad, bool)
        active = np.zeros(n_pad, bool)
        for i, name in enumerate(narr.names):
            node = ssn.nodes.get(name)
            if node is None or not node.revocable_zone:
                continue
            revocable[i] = True
            active[i] = self.available_revocable_zone(node.revocable_zone)
        return revocable, active

    def _solver_mask(self, ssn):
        def mask_fn(batch, narr, feats):
            revocable, active = self._node_zone_state(ssn, narr)
            if not revocable.any():
                return None   # no revocable nodes: nothing to mask
            task_rz = np.zeros(batch.g_pad, bool)
            for g, members in enumerate(batch.group_members):
                task_rz[g] = bool(batch.tasks[members[0]].revocable_zone)
            ok = ~revocable[None, :] | (active[None, :] & task_rz[:, None])
            return ok
        mask_fn.explain_label = "tdm"
        return mask_fn

    def _solver_score(self, ssn):
        def score_fn(batch, narr, feats):
            revocable, active = self._node_zone_state(ssn, narr)
            if not (revocable & active).any():
                return None   # nothing to attract: no [G,N] transfer
            task_rz = np.zeros(batch.g_pad, bool)
            for g, members in enumerate(batch.group_members):
                task_rz[g] = bool(batch.tasks[members[0]].revocable_zone)
            score = (revocable & active)[None, :] & task_rz[:, None]
            return score.astype(np.float32) * MAX_NODE_SCORE
        return score_fn

    # -- disruption budget -------------------------------------------------

    @staticmethod
    def _parse_int_or_percent(value: str, total: int) -> int:
        import math
        v = str(value).strip()
        if v.endswith("%"):
            try:
                return math.ceil(float(v[:-1]) * total / 100.0)
            except ValueError:
                return 0
        try:
            return int(v)
        except ValueError:
            return 0

    def _max_victims(self, job, victims):
        """Clip a job's victim list to its disruption budget
        (tdm.go:305-334)."""
        return victims[:self._get_max_pod_evict_num(job)]

    def _get_max_pod_evict_num(self, job) -> int:
        running = len(job.task_status_index.get(TaskStatus.Running, {}))
        n_tasks = len(job.tasks)
        if job.budget.max_unavailable:
            max_unavailable = self._parse_int_or_percent(
                job.budget.max_unavailable, n_tasks)
            final = (len(job.task_status_index.get(TaskStatus.Succeeded, {}))
                     + len(job.task_status_index.get(TaskStatus.Failed, {})))
            real_unavailable = n_tasks - final - running
            if real_unavailable >= max_unavailable:
                return 0
            return max_unavailable - real_unavailable
        if job.budget.min_available:
            min_available = self._parse_int_or_percent(
                job.budget.min_available, n_tasks)
            if running >= min_available:
                return running - min_available
        return DEFAULT_POD_EVICT_NUM


register_plugin_builder(NAME, TdmPlugin)
