"""Synthetic workload generation + JSONL trace I/O for the simulator (the
port's own copy of volcano_tpu/sim/workload.py).

The generator draws a multi-hour job arrival process from one seeded
``random.Random``: Poisson arrivals (exponential inter-arrival times),
categorical gang sizes / resource shapes, and log-uniform service
durations. Everything is emitted up front as a flat event list — the
engine never consults the RNG, so a dumped trace replays bit-identically
(the same property Gavel/Tesserae-style trace-driven simulators build
their policy evaluation on).
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import dataclass, field
from typing import Dict, List

from .events import Event, make_event, validate_event

ZONE_KEY = "topology.kubernetes.io/zone"


@dataclass
class WorkloadConfig:
    """Arrival-process knobs (all randomness keyed off ``seed``)."""
    seed: int = 0
    horizon_s: float = 200.0            # virtual time covered by arrivals
    arrival_rate: float = 1.0           # jobs per virtual second (Poisson)
    gang_sizes: List[int] = field(default_factory=lambda: [1, 2, 4, 8])
    gang_weights: List[float] = field(default_factory=lambda: [2, 3, 3, 2])
    cpu_choices: List[str] = field(default_factory=lambda: ["1", "2", "4"])
    mem_choices: List[str] = field(
        default_factory=lambda: ["1Gi", "2Gi", "4Gi"])
    duration_min_s: float = 20.0        # service time after full bind
    duration_max_s: float = 200.0
    queues: List[str] = field(default_factory=lambda: ["default"])
    namespace: str = "default"
    priority_class_rate: float = 0.0    # fraction tagged "high"
    # placement-constraint mix (docs/design/constraints.md): fractions of
    # arriving gangs carrying a HARD zone topology-spread (max-skew 1,
    # min_available == size so the per-tick skew invariant is exact), a
    # SOFT (ScheduleAnyway) spread, or pair self-anti-affinity over the
    # zone key (one replica per zone). Disjoint draws off the same rng.
    spread_rate: float = 0.0
    soft_spread_rate: float = 0.0
    anti_affinity_rate: float = 0.0
    # fraction of UNCONSTRAINED gangs arriving elastic (min_available =
    # size // 2): the gang plugin only admits preemption victims from
    # jobs above min_available, so a cluster of full gangs is
    # preemption-proof — storms need elastic filler to evict
    elastic_rate: float = 0.0


def synthesize_arrivals(cfg: WorkloadConfig, start_at: float = 0.0,
                        name_prefix: str = "sj") -> List[Event]:
    """The full arrival stream for ``cfg``, as ``job_arrival`` events.

    Durations are drawn here and ride the arrival record: a job's
    completion is scheduled by the engine at (full-bind time + duration),
    so the RNG never has to be consulted mid-run.
    """
    rng = random.Random(cfg.seed)
    events: List[Event] = []
    t = start_at
    i = 0
    while True:
        t += rng.expovariate(cfg.arrival_rate)
        if t > start_at + cfg.horizon_s:
            break
        size = rng.choices(cfg.gang_sizes, weights=cfg.gang_weights)[0]
        # log-uniform service times: mixes quick batch jobs with the
        # multi-hour stragglers that keep residency high
        lo, hi = math.log(cfg.duration_min_s), math.log(cfg.duration_max_s)
        duration = math.exp(rng.uniform(lo, hi))
        # constraint draw: ONE coin partitions [0, 1) into disjoint
        # hard-spread / soft-spread / anti-affinity / unconstrained bands
        # so enabling one band never perturbs another's job sequence
        extra = {}
        coin = rng.random() if (cfg.spread_rate or cfg.soft_spread_rate
                                or cfg.anti_affinity_rate) else 1.0
        if coin < cfg.spread_rate:
            extra = {"spread_key": ZONE_KEY, "spread_skew": 1,
                     "spread_mode": "hard"}
        elif coin < cfg.spread_rate + cfg.soft_spread_rate:
            extra = {"spread_key": ZONE_KEY, "spread_skew": 1,
                     "spread_mode": "soft"}
        elif coin < (cfg.spread_rate + cfg.soft_spread_rate
                     + cfg.anti_affinity_rate):
            extra = {"anti_key": ZONE_KEY}
            size = 2   # the pair idiom: one replica per zone
        min_available = size
        if not extra and cfg.elastic_rate \
                and rng.random() < cfg.elastic_rate:
            min_available = max(1, size // 2)
        events.append(make_event(
            t, "job_arrival",
            name=f"{name_prefix}-{i}",
            namespace=cfg.namespace,
            queue=cfg.queues[i % len(cfg.queues)],
            size=size,
            min_available=min_available,
            cpu=rng.choice(cfg.cpu_choices),
            mem=rng.choice(cfg.mem_choices),
            duration=round(duration, 3),
            priority_class=("high" if rng.random() < cfg.priority_class_rate
                            else ""),
            **extra))
        i += 1
    return events


def resident_backlog(n_jobs: int, gang: int, cpu: str = "2",
                     mem: str = "4Gi", queue: str = "default",
                     namespace: str = "default",
                     duration_s: float = 1e9,
                     name_prefix: str = "rj",
                     min_available: int = 0) -> List[Event]:
    """A cold backlog: ``n_jobs`` gangs all arriving at t=0 (the sim's
    analogue of bench.py's one-shot populate; near-infinite duration keeps
    them resident unless faults kill them). ``min_available`` below the
    gang size makes the residents elastic — preemptable down to min."""
    return [make_event(0.0, "job_arrival", name=f"{name_prefix}-{j}",
                       namespace=namespace, queue=queue, size=gang,
                       min_available=min_available or gang, cpu=cpu, mem=mem,
                       duration=duration_s, priority_class="")
            for j in range(n_jobs)]


# -- constraint-heavy scenario (docs/design/constraints.md) ------------------
# The compiled constraint tensors and the batched victim-selection
# kernel must be proven under CHURN, not just in unit parity tests: the
# same seeded stream of spread gangs / anti-affinity pairs / priority
# preemption storms is run with the compiled kernels on and with the
# per-task Python reference forced, and the bind+evict outcomes must be
# bit-identical (plus a compiled double run for determinism).

CONSTRAINT_CONF = """
actions: "enqueue, allocate, backfill, preempt, reclaim"
tiers:
- plugins:
  - name: priority
  - name: conformance
  - name: gang
- plugins:
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""
# no drf here by design: drf's what-if share tree is the one builtin
# victim filter with no closed vectorized form (ops/victims.py), so a
# conf carrying it falls back to the Python walk — this scenario exists
# to prove the KERNEL, with {priority, gang, conformance} preempt and
# {gang, conformance, proportion} reclaim chains

CONSTRAINT_REFERENCE_CONF = CONSTRAINT_CONF + """
configurations:
- name: solver
  arguments:
    constraints.compile: "off"
    victims.kernel: "off"
"""


def constraint_scenario_workload(seed: int, ticks: int,
                                 arrival_rate: float = 0.35,
                                 queue: str = "default") -> WorkloadConfig:
    """The constraint-smoke churn shape: a Poisson stream through the
    first 60% of the horizon where ~45% of gangs carry a constraint
    (hard zone spread / soft spread / one-per-zone anti pairs), mixed
    with unconstrained filler, then a quiet drain tail."""
    return WorkloadConfig(
        seed=seed, horizon_s=float(ticks) * 0.6,
        arrival_rate=arrival_rate, queues=[queue],
        gang_sizes=[2, 4, 6], gang_weights=[3, 3, 1],
        duration_min_s=15.0, duration_max_s=90.0,
        spread_rate=0.2, soft_spread_rate=0.1, anti_affinity_rate=0.15,
        elastic_rate=0.6)


def preempt_storm(at: float, n_jobs: int, gang: int = 2, cpu: str = "2",
                  mem: str = "4Gi", queue: str = "default",
                  namespace: str = "default",
                  duration_s: float = 30.0,
                  name_prefix: str = "storm") -> List[Event]:
    """A burst of high-priority gangs arriving at one instant — the
    priority preemption storm that drives the batched victim-selection
    kernel through eviction-heavy cycles."""
    return [make_event(at, "job_arrival", name=f"{name_prefix}-{j}",
                       namespace=namespace, queue=queue, size=gang,
                       min_available=gang, cpu=cpu, mem=mem,
                       duration=duration_s, priority_class="storm-high")
            for j in range(n_jobs)]


# -- JSONL trace I/O ---------------------------------------------------------


def dump_trace(path: str, events: List[Dict]) -> int:
    """One JSON object per line, sorted by (at) stably — the on-disk
    format for both workload traces and repro bundles."""
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e, sort_keys=True) + "\n")
    return len(events)


def load_trace(path: str) -> List[Event]:
    events: List[Event] = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: bad JSON ({e})")
            validate_event(rec)
            ev = Event(rec)
            events.append(ev)
    return events
