"""Measure what tracing costs the scheduling cycle and print one JSON line.

    python -m volcano_tpu_torch.cmd.trace_overhead [--pairs 10] \\
        [--steady-rounds 10] [--tasks 50000 --nodes 10000] [--device cpu]

Tracing is the flight recorder (trace/tracer.py) with the pod lifecycle
ledger it turns on, as ``tracer.enable()`` sets them in production. Two
measurements, each alternating tracing off and on in off-on-on-off order
so that a drift of the host cancels:

* placing cycles: ``cmd.cycle.run_cycle`` on a fresh store each time
  (populate_store's gangs of 8, the default conf plus binpack), ``--pairs``
  runs of each (even), tracing switched before the store is built, so the
  ledger's entries exist from ingest as they would in production;
* steady cycles: one store those cycles bound, a cache and scheduler of
  its own, nothing left to place: after a full snapshot and one patch,
  the quiet incremental cycles of the steady state (no plugin opens, as
  in the reference); 4 x ``--steady-rounds`` cycles.

Each run waits for the cache's executor to drain before the next starts.
A placing cycle's binds, statuses and ledger stamps are written by that
executor after the cycle (``flush_ms``, the ``flush_executors()`` wait),
so the placing runs give the overhead three times: on the cycle
(``cycle``), on its flush (``flush``) and on the two together
(``to_bound``, what a pending gang waits to be bound). The steady cycles
bind nothing; their overhead is on the cycle.

The line gives every run's cycle ms, flush ms and kernel launches, each
overhead in percent by the minima (the least traced run over the least
untraced one) and by the medians, and the span split of the last traced
placing cycle. Each overhead is only as good as the host's spread, which
the runs show.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
from typing import List, Optional

import torch

from ..cache import SchedulerCache
from ..metrics import metrics
from ..ops.cuda_allocate import gang_allocate_cuda
from ..scheduler import Scheduler
from ..trace import ledger, tracer
from ..utils.platform import default_device
from . import cycle as cycle_cmd

ORDER = ("off", "on", "on", "off")


def _switch(mode: str) -> None:
    if mode == "on":
        tracer.reset()
        ledger.reset()
        metrics.reset()
        tracer.enable()
    else:
        tracer.disable()


def placing(n_tasks: int, n_nodes: int, device, pairs: int) -> dict:
    """``pairs`` placing cycles each way (even) on fresh stores. Returns
    {"off"|"on": [run_cycle's results, each with its "kernel_launches"]},
    "record": the last traced cycle's flight-recorder record, "store": a
    store an untraced cycle bound (for ``steady``)."""
    runs = {"off": [], "on": []}
    out = {"record": None, "store": None}
    for mode in ORDER * (pairs // 2):
        _switch(mode)
        gang_allocate_cuda.launches = 0
        r = cycle_cmd.run_cycle(n_tasks, n_nodes, 1, device)
        r["kernel_launches"] = gang_allocate_cuda.launches
        store = r.pop("store")
        if mode == "on":
            out["record"] = tracer.last_record()
        elif out["store"] is None:
            out["store"] = store
        runs[mode].append(r)
    tracer.disable()
    out.update(runs)
    return out


def steady(store, device, rounds: int) -> dict:
    """4 x ``rounds`` steady cycles on ``store`` (everything on it bound),
    tracing alternated. Returns {"off"|"on": [cycle ms]} and the kernel
    launches they made (none: there is nothing to place)."""
    cache = SchedulerCache(store)
    cache.run()
    sched = Scheduler(store, scheduler_conf=cycle_cmd.CONF, cache=cache,
                      device=device)
    out = {"off": [], "on": [], "launches": 0}
    gc.collect()
    gc.freeze()
    try:
        for mode in ORDER * rounds:
            _switch(mode)
            gang_allocate_cuda.launches = 0
            sched.run_once()
            out["launches"] += gang_allocate_cuda.launches
            out[mode].append(sched.last_cycle["cycle_ms"])
            # the executor's writes land between cycles, not in the next
            if not cache.flush_executors(timeout=cycle_cmd.FLUSH_TIMEOUT_S):
                raise RuntimeError("the cache's executor did not drain")
    finally:
        tracer.disable()
        gc.unfreeze()
        cache.stop()
    return out


def overhead(on: List[float], off: List[float]) -> dict:
    """Tracing's overhead in percent, by the minima and by the medians."""
    return {"min_pct": (min(on) / min(off) - 1.0) * 100.0,
            "median_pct": (statistics.median(on)
                           / statistics.median(off) - 1.0) * 100.0}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="volcano_tpu_torch.cmd.trace_overhead",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--tasks", type=int, default=50_000)
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--pairs", type=int, default=10,
                    help="placing cycles each way (even)")
    ap.add_argument("--steady-rounds", type=int, default=10,
                    help="rounds of four steady cycles")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain loop)")
    opts = ap.parse_args(argv)
    if opts.pairs < 2 or opts.pairs % 2:
        ap.error("--pairs must be even and at least 2")
    device = default_device(opts.device)
    if device.type == "cuda":
        torch.cuda.init()
    runs = placing(opts.tasks, opts.nodes, device, opts.pairs)
    still = steady(runs.pop("store"), device, opts.steady_rounds)
    ms = {mode: {key: [r[key] for r in runs[mode]]
                 for key in ("cycle_ms", "flush_ms")} for mode in ORDER}
    for mode in ms:
        ms[mode]["to_bound_ms"] = [c + f for c, f in
                                   zip(ms[mode]["cycle_ms"],
                                       ms[mode]["flush_ms"])]
    print(json.dumps({
        "device": torch.cuda.get_device_name(device)
        if device.type == "cuda" else str(device),
        "tasks": opts.tasks, "nodes": opts.nodes,
        "placing": {"on_ms": ms["on"]["cycle_ms"],
                    "off_ms": ms["off"]["cycle_ms"],
                    "on_flush_ms": ms["on"]["flush_ms"],
                    "off_flush_ms": ms["off"]["flush_ms"],
                    **{part: overhead(ms["on"][f"{part}_ms"],
                                      ms["off"][f"{part}_ms"])
                       for part in ("cycle", "flush", "to_bound")},
                    "launches": [r["kernel_launches"]
                                 for r in runs["off"] + runs["on"]]},
        "steady": {"on_ms": still["on"], "off_ms": still["off"],
                   **overhead(still["on"], still["off"]),
                   "launches": still["launches"]},
        "phases": runs["on"][-1]["trace"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
