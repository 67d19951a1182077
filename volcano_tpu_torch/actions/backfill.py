"""backfill: place zero-request (BestEffort) tasks (the port's own copy of
volcano_tpu/actions/backfill.py).

Mirrors pkg/scheduler/actions/backfill/backfill.go:40-90: every Pending
task with an empty InitResreq is bound to the first node passing
predicates; resource fit is irrelevant by construction. Feasibility over
all nodes comes from one solver mask evaluation per task.
"""

from __future__ import annotations

import numpy as np

from ..framework.plugin import Action
from ..framework.registry import register_action
from ..models.job_info import TaskStatus
from ..models.objects import PodGroupPhase
from ..models.unschedule_info import FitErrors


class BackfillAction(Action):
    def name(self) -> str:
        return "backfill"

    def execute(self, ssn) -> None:
        jobs_tasks = []
        for job in list(ssn.jobs.values()):
            if job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            tasks = [t for t in job.task_status_index.get(
                         TaskStatus.Pending, {}).values()
                     if t.init_resreq.is_empty()]
            if tasks:
                jobs_tasks.append((job, tasks))
        if not jobs_tasks:
            return

        # one host-side predicate context for ALL best-effort tasks
        # (previously one device context build per task)
        narr, batch, gmask, _ = ssn.solver.build_host_context(jobs_tasks)
        n_real = len(narr.names)
        n_tasks = narr.n_tasks.copy()
        max_tasks = narr.max_tasks
        uid_to_g = {t.uid: g for t, g in zip(batch.tasks, batch.task_group)}
        for job, tasks in jobs_tasks:
            for task in tasks:
                g = uid_to_g.get(task.uid)
                if g is None:
                    continue
                pods_ok = (max_tasks[:n_real] == 0) | \
                    (n_tasks[:n_real] < max_tasks[:n_real])
                mask = gmask[g, :n_real] & pods_ok
                allocated = False
                for i in np.flatnonzero(mask):
                    node = ssn.nodes.get(narr.names[int(i)])
                    if node is None:
                        continue
                    try:
                        ssn.allocate(task, node)
                    except (KeyError, RuntimeError):
                        continue
                    n_tasks[int(i)] += 1
                    allocated = True
                    break
                if not allocated:
                    fe = FitErrors()
                    fe.set_error("no node passed predicates for "
                                 "best-effort task")
                    job.nodes_fit_errors[task.uid] = fe


register_action(BackfillAction())
