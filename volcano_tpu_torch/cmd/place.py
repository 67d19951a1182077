"""Place a synthetic backlog once or more and print one JSON line.

    python -m volcano_tpu_torch.cmd.place --tasks 50000 --nodes 10000 \\
        [--queues 1] [--namespaces 1] [--seed 42] [--device cpu] [--runs 3]

Builds ``synth_arrays(tasks, nodes, gang_size=8, seed, utilization=0.3)``
(the snapshot the scheduler sees after encoding), solves it with
``DenseSolver`` on the GPU (or on ``--device``), one untimed warm-up and
``--runs`` timed runs, and prints placed tasks, committed (ready) jobs, the
kernel's time and the end-to-end ``place`` time of each run.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import torch

from ..framework.solver import DenseSolver
from ..ops.score import ScoreWeights
from ..utils.platform import default_device
from ..utils.synth import synth_arrays


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="volcano_tpu_torch.cmd.place",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--tasks", type=int, default=50_000)
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--queues", type=int, default=1)
    ap.add_argument("--namespaces", type=int, default=1)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain loop)")
    ap.add_argument("--runs", type=int, default=3)
    opts = ap.parse_args(argv)

    device = default_device(opts.device)
    sa = synth_arrays(opts.tasks, opts.nodes, gang_size=8, seed=opts.seed,
                      utilization=0.3, n_queues=opts.queues,
                      n_namespaces=opts.namespaces)
    solver = DenseSolver(sa, ScoreWeights.make(sa.group_req.shape[1],
                                               binpack=1.0), device)
    ns_live = opts.namespaces > 1

    def run():
        t0 = time.perf_counter()
        out = solver.place(ns_live=ns_live)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, (time.perf_counter() - t0) * 1000.0

    run()   # warm-up: builds the kernel on first use
    kernel_ms, place_ms = [], []
    for _ in range(opts.runs):
        out, ms = run()
        kernel_ms.append(out.kernel_ms)
        place_ms.append(ms)
    print(json.dumps({
        "device": torch.cuda.get_device_name(device)
        if device.type == "cuda" else str(device),
        "shapes": sa.shapes, "queues": opts.queues,
        "namespaces": opts.namespaces, "seed": opts.seed,
        "placed": out.n_placed, "committed_jobs": int(out.ready.sum()),
        "kept_jobs": int(out.kept.sum()),
        "kernel_ms": kernel_ms, "place_ms": place_ms}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
