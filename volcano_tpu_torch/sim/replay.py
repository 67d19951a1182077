"""Repro bundles + deterministic replay (the port's own copy of
volcano_tpu/sim/replay.py).

A bundle is a directory holding everything needed to re-run a failing
simulation up to the violating tick:

* ``bundle.json`` — ``{seed, tick, config, violations, bind_fingerprint,
  events_applied}`` (the one-line repro is the ``{seed, tick}`` pair:
  same config + same seed reproduces the identical bind sequence)
* ``events.jsonl`` — the applied event stream, verbatim, in application
  order (replayable standalone via ``SimConfig(trace_path=...)``)
* ``trace.json`` — the offending cycle's flight-recorder export
  (Chrome trace-event JSON, Perfetto-loadable), when the tracer has a
  record
* ``timeseries.json`` — the metrics time-series ring (last N cycles of
  key gauges/counters, ``/debug/timeseries``'s payload) plus the pod
  lifecycle ledger report at violation time

``replay_bundle()`` reconstructs the config and re-runs it; because the
generators are seeded the re-run needs nothing but ``bundle.json``, and
the event stream is carried anyway so a bundle stays replayable even if
generator code drifts (``use_trace=True``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .workload import dump_trace


def write_repro_bundle(base_dir: str, engine, tick: int,
                       violations) -> str:
    """Dump a replayable bundle for a violation at ``tick``; returns the
    bundle directory path."""
    from ..trace import tracer
    cfg = engine.cfg
    path = os.path.join(base_dir,
                        f"sim_repro_seed{cfg.seed}_tick{tick}")
    os.makedirs(path, exist_ok=True)
    dump_trace(os.path.join(path, "events.jsonl"),
               engine.result.events_applied)
    bundle = {
        "seed": cfg.seed,
        "tick": tick,
        "repro": f"python -m volcano_tpu_torch.sim.cli replay --bundle {path}",
        "config": cfg.to_dict(),
        "violations": [{"invariant": v.invariant, "detail": v.detail}
                       for v in violations],
        "bind_fingerprint": engine.result.bind_fingerprint(),
        "binds": len(engine.result.bind_sequence),
        "events_applied": len(engine.result.events_applied),
    }
    with open(os.path.join(path, "bundle.json"), "w") as f:
        json.dump(bundle, f, indent=1, sort_keys=True)
    rec = tracer.last_record()
    if rec is not None:
        with open(os.path.join(path, "trace.json"), "w") as f:
            json.dump(tracer.chrome_trace(rec), f)
    from ..metrics import timeseries
    from ..trace import ledger
    with open(os.path.join(path, "timeseries.json"), "w") as f:
        json.dump({"samples": timeseries.series(),
                   "latency": ledger.report()}, f, indent=1)
    # placement decision provenance at violation time (the explain
    # layer, docs/design/observability.md) — only when the explainer
    # recorded anything, so legacy bundles stay byte-identical
    from ..trace import explain
    if explain.is_enabled():
        with open(os.path.join(path, "explain.json"), "w") as f:
            json.dump(explain.report(limit=0), f, indent=1)
    return path


def load_bundle(path: str) -> dict:
    with open(os.path.join(path, "bundle.json")) as f:
        return json.load(f)


def replay_bundle(path: str, use_trace: bool = False,
                  ticks: Optional[int] = None, device=None):
    """Re-run a bundle's simulation: seeded re-generation by default, or
    the recorded event stream verbatim (``use_trace=True``). Runs up to
    (and including) the violating tick unless ``ticks`` overrides, on
    ``device`` (None: the card, whatever the bundle's run used).
    Returns the new :class:`.engine.SimResult`."""
    from .engine import SimConfig, run_sim
    bundle = load_bundle(path)
    cfg = SimConfig.from_dict(bundle["config"])
    cfg.ticks = ticks if ticks is not None else int(bundle["tick"]) + 1
    if use_trace:
        cfg.trace_path = os.path.join(path, "events.jsonl")
    cfg.repro_dir = None   # a replay must not recursively dump bundles
    cfg.device = device
    return run_sim(cfg)
