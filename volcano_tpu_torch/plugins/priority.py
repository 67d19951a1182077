"""priority plugin (the port's own copy of volcano_tpu/plugins/priority.py;
reference: pkg/scheduler/plugins/priority/priority.go).

TaskOrder/JobOrder by priority; Preemptable admits only strictly
lower-priority victims. With ``tieredpack.weight`` set, the plugin also
contributes the priority-tiered packing score (lowered by
ops/constraints.py): groups pack toward nodes resident to their
own-or-higher priority tier and away from lower-tier nodes.
"""

from __future__ import annotations

from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from ..framework.session import PERMIT
from ..ops import constraints

NAME = "priority"


class PriorityPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        args = self.arguments
        get_f = args.get_float if hasattr(args, "get_float") else \
            (lambda k, d: float(args.get(k, d) or d))
        self.tieredpack_w = get_f("tieredpack.weight", 0.0)

    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn) -> None:
        if self.tieredpack_w and ssn.solver is not None:
            def tiered_score(batch, narr, feats):
                return constraints.compile_score(
                    ssn, batch, narr, tiered_weight=self.tieredpack_w,
                    spread_weight=0.0)   # spread rides the predicates plugin
            ssn.solver.add_static_score_fn(tiered_score)

        def task_order_fn(l, r):
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        # marker: this comparator is EXACTLY the dispatch fallback's
        # (priority desc) — hot callers key-sort instead of running a
        # cmp dispatch per comparison (actions/allocate._pending_tasks)
        task_order_fn.standard_priority_order = True
        ssn.add_task_order_fn(NAME, task_order_fn)

        def job_order_fn(l, r):
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_job_order_fn(NAME, job_order_fn)

        def preemptable_fn(preemptor, preemptees):
            """Only strictly lower priority tasks are victims
            (priority.go:79-108)."""
            preemptor_job = ssn.jobs.get(preemptor.job)
            if preemptor_job is None:
                return [], PERMIT
            victims = [t for t in preemptees
                       if ssn.jobs.get(t.job) is not None
                       and ssn.jobs[t.job].priority < preemptor_job.priority]
            return victims, PERMIT

        ssn.add_preemptable_fn(NAME, preemptable_fn)


register_plugin_builder(NAME, PriorityPlugin)
