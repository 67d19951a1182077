"""binpack plugin (the port's own copy of volcano_tpu/plugins/binpack.py;
reference: pkg/scheduler/plugins/binpack/binpack.go).

Best-fit node scoring: score_r = (used_r + request_r) / allocatable_r,
weighted per resource and normalized x100 (binpack.go:200-260). Arguments
(binpack.go:105-150):

    binpack.weight               -- overall plugin weight (default 1)
    binpack.cpu                  -- per-resource weights (default 1)
    binpack.memory
    binpack.resources            -- "nvidia.com/gpu,example.com/foo"
    binpack.resources.<name>     -- weight for each extra resource

The scoring itself runs inside the gang-allocate kernel (ops/score.py
binpack_score) against the live idle state; this plugin just
feeds the weights into the session solver and registers the host-side
NodeOrderFn for single-pair paths.
"""

from __future__ import annotations

from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from ..models.resource import CPU, MEMORY

NAME = "binpack"


class BinpackPlugin(Plugin):
    def __init__(self, arguments=None):
        args = arguments or {}
        self.weight = args.get_int("binpack.weight", 1) if hasattr(args, "get_int") \
            else int(args.get("binpack.weight", 1))
        get = args.get_int if hasattr(args, "get_int") else \
            (lambda k, d: int(args.get(k, d)))
        self.res_weights = {CPU: get("binpack.cpu", 1),
                            MEMORY: get("binpack.memory", 1)}
        resources = str(args.get("binpack.resources", "") or "")
        for res in resources.split(","):
            res = res.strip()
            if res:
                self.res_weights[res] = get(f"binpack.resources.{res}", 1)

    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn) -> None:
        if ssn.solver is not None and ssn.plugin_enabled(NAME, "enabledNodeOrder"):
            ssn.solver.add_weight("binpack", float(self.weight))
            ssn.solver.set_binpack_resources(
                {k: float(v) for k, v in self.res_weights.items()})
            ssn.solver.mark_vectorized(NAME)

        def node_order_fn(task, node) -> float:
            return self._score(task, node)

        ssn.add_node_order_fn(NAME, node_order_fn)

    def _score(self, task, node) -> float:
        """Host-side mirror of ops/score.py binpack_score."""
        score = 0.0
        weight_sum = 0.0
        for res, w in self.res_weights.items():
            request = task.resreq.get(res)
            if request <= 0 or w <= 0:
                continue
            alloc = node.allocatable.get(res)
            if alloc <= 0:
                continue
            used = node.used.get(res)
            # an overflowing resource contributes 0 but stays in the
            # normalization, matching ops/score.py binpack_score
            if used + request <= alloc:
                score += w * (used + request) * 100.0 / alloc
            weight_sum += w
        if weight_sum == 0:
            return 0.0
        return score / weight_sum * self.weight


register_plugin_builder(NAME, BinpackPlugin)
