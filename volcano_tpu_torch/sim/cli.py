"""``python -m volcano_tpu_torch.sim.cli``: the simulator CLI (the port of
volcano_tpu/sim/cli.py).

    python -m volcano_tpu_torch.sim.cli run --seed 7 --ticks 200 --nodes 512
    python -m volcano_tpu_torch.sim.cli smoke            # the CI gate
    python -m volcano_tpu_torch.sim.cli replay --bundle sim_repro_seed7_tick42/

Every verb that schedules takes ``--device``: the card (cuda:0) by
default, ``cpu`` for the kernels' plain versions; without a GPU and
without ``--device cpu`` a verb exits non-zero. The simulator owns its
whole control plane in-process (that is the point — a violation shrinks
to ``{seed, tick}`` with no cluster state to capture).

The gates (smoke, chaos, failover, obs, incr, constraints, explain,
prune, storm, federation, durability) keep the reference's configs,
checks and exit codes. ``durability`` and ``federation --procs`` run
apiserver child processes and no scheduler: they are host-only, and
``durability`` takes no ``--device`` (``federation --procs`` leaves it
unread). ``mesh`` waits for the multi-GPU solver: it exits 2 with a
message and runs nothing in its place.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

# engine/faults/workload (and through them torch + the scheduler stack)
# are imported inside the dispatch helpers, so that attaching the
# parser costs nothing

# the verbs whose layers the port does not have yet, and where each
# waits (ROADMAP.md)
WAITING = {
    "mesh": "the multi-GPU sharded solver (ROADMAP item 13)",
}
# the verbs that run no scheduler, and so take no --device
HOST_ONLY = ("durability",)


# run_storm's counters beside the verdict's own keys (``port_facts``)
STORM_FACTS = ("final_rv", "converged", "gaps_detected", "gaps_unrecovered",
               "frames_dropped", "frames_total", "events_total", "relists",
               "noisy_throttled_writes", "noisy_subscription_throttles",
               "bind_fingerprint", "ledger_fingerprint", "violations",
               "watch_drops", "divergence_repairs")
# run_federation's counters and fingerprints beside the verdict's own keys
FEDERATION_FACTS = ("final_rv", "converged", "gaps_detected",
                    "gaps_unrecovered", "frames_dropped", "frames_total",
                    "events_total", "relists", "cursor_handoffs",
                    "handed_off_clients", "fenced_frames",
                    "snapshot_bootstraps", "catchup_relists",
                    "replication_gaps", "audit_verdict",
                    "mirror_fingerprint", "bind_fingerprint",
                    "ledger_fingerprint", "violations", "watch_drops",
                    "divergence_repairs")


def add_sim_parser(sub) -> None:
    """Attach the `sim` group to a subparser set."""
    sim = sub.add_parser(
        "sim", help="cluster churn simulator").add_subparsers(
        dest="verb", required=True)

    run = sim.add_parser("run", help="one seeded churn run")
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--ticks", type=int, default=100)
    run.add_argument("--tick-seconds", type=float, default=1.0)
    run.add_argument("--nodes", type=int, default=64)
    run.add_argument("--node-cpu", default="64")
    run.add_argument("--node-mem", default="256Gi")
    run.add_argument("--resident-jobs", type=int, default=0)
    run.add_argument("--resident-gang", type=int, default=8)
    run.add_argument("--arrival-rate", type=float, default=1.0,
                     help="jobs per virtual second (Poisson)")
    run.add_argument("--bind-fail-rate", type=float, default=0.0)
    run.add_argument("--api-latency", type=float, default=0.0,
                     help="virtual seconds charged per store bind")
    run.add_argument("--flap-rate", type=float, default=0.0,
                     help="node drain+undrain pairs per virtual second")
    run.add_argument("--kill-rate", type=float, default=0.0)
    run.add_argument("--storm-rate", type=float, default=0.0)
    run.add_argument("--fail-rate", type=float, default=0.0,
                     help="fraction of gangs losing a pod mid-run")
    run.add_argument("--trace", default=None, metavar="EVENTS_JSONL",
                     help="replay this event trace instead of synthesizing "
                          "(live injection — --bind-fail-rate/--api-latency "
                          "— is config, not events: pass the original "
                          "flags too, or use `sim replay --bundle` which "
                          "carries the full config)")
    run.add_argument("--trace-out", default=None, metavar="PATH",
                     help="dump the applied event stream after the run")
    run.add_argument("--repro-dir", default=".",
                     help="where violation repro bundles are written")
    run.add_argument("--no-invariants", action="store_true")
    run.add_argument("--keep-going", action="store_true",
                     help="do not stop at the first violating tick")
    run.add_argument("--json", action="store_true",
                     help="print the full summary as one JSON object")

    smoke = sim.add_parser(
        "smoke", help="CI gate: seeded churn twice, invariants on, "
                      "bit-identical bind sequences required")
    smoke.add_argument("--seed", type=int, default=7)
    smoke.add_argument("--ticks", type=int, default=200)
    smoke.add_argument("--nodes", type=int, default=512)
    smoke.add_argument("--json", action="store_true")

    chaos = sim.add_parser(
        "chaos", help="CI gate: 2%% bind-failure injection plus a poison "
                      "pod — gang atomicity must be HEALED (no waiver), "
                      "the poison pod must reach quarantine with a "
                      "why-pending reason, and a double run must be "
                      "bit-identical")
    chaos.add_argument("--seed", type=int, default=13)
    chaos.add_argument("--ticks", type=int, default=120)
    chaos.add_argument("--nodes", type=int, default=128)
    chaos.add_argument("--json", action="store_true")

    failover = sim.add_parser(
        "failover", help="CI gate: control-plane chaos — a leader-lease "
                         "lapse with a mid-flush crash, scheduler kills "
                         "(stateless + snapshot restart), watch-delivery "
                         "drops and 2%% bind failures together; asserts "
                         "zero invariant violations, >=1 fenced write "
                         "rejection, >=1 anti-entropy repair, the "
                         "standby why-pending reason, and a bit-"
                         "identical double run")
    failover.add_argument("--seed", type=int, default=29)
    failover.add_argument("--ticks", type=int, default=120)
    failover.add_argument("--nodes", type=int, default=128)
    failover.add_argument("--json", action="store_true")

    obs = sim.add_parser(
        "obs", help="CI gate: short churn run asserting the pod "
                    "lifecycle ledger fills (nonzero e2e/hop "
                    "histograms), leaves zero orphaned entries, stamps "
                    "traceable bind correlation IDs, and double-runs "
                    "bit-identically (bind + ledger fingerprints)")
    obs.add_argument("--seed", type=int, default=17)
    obs.add_argument("--ticks", type=int, default=60)
    obs.add_argument("--nodes", type=int, default=128)
    obs.add_argument("--json", action="store_true")

    incr = sim.add_parser(
        "incr", help="CI gate: the same seeded churn (quiet tail, "
                     "bursty backlog, node flaps) run twice — "
                     "incremental persistent-snapshot cycles vs "
                     "forced-full rebuilds — requiring bit-identical "
                     "bind AND ledger fingerprints, zero violations, "
                     "and proof the incremental/quiet paths engaged")
    incr.add_argument("--seed", type=int, default=23)
    incr.add_argument("--ticks", type=int, default=200)
    incr.add_argument("--nodes", type=int, default=256)
    incr.add_argument("--json", action="store_true")

    cons = sim.add_parser(
        "constraints", help="CI gate (make constraint-smoke): seeded "
                            "churn of zone-spread gangs, anti-affinity "
                            "pairs and a priority preemption storm run "
                            "with the compiled constraint tensors + "
                            "vmapped victim-selection kernel, with the "
                            "per-task Python reference forced, and as a "
                            "compiled double run — spread/anti "
                            "invariants clean every audited tick, all "
                            "three bind+evict outcomes bit-identical, "
                            "and both kernels provably the ones that ran")
    cons.add_argument("--seed", type=int, default=41)
    cons.add_argument("--ticks", type=int, default=160)
    cons.add_argument("--nodes", type=int, default=96)
    cons.add_argument("--zones", type=int, default=4)
    cons.add_argument("--json", action="store_true")

    exp = sim.add_parser(
        "explain", help="CI gate (make explain-smoke): constrained churn "
                        "+ a preemption storm with the placement "
                        "explainer on — every placed gang must carry a "
                        "provenance record whose elimination ladder sums "
                        "to the node axis, victim decisions must be "
                        "recorded, the explain fingerprint must be "
                        "bit-identical across a double run, and the "
                        "off-mode hook overhead must measure <2%%")
    exp.add_argument("--seed", type=int, default=47)
    exp.add_argument("--ticks", type=int, default=80)
    exp.add_argument("--nodes", type=int, default=64)
    exp.add_argument("--zones", type=int, default=4)
    exp.add_argument("--json", action="store_true")

    pr = sim.add_parser(
        "prune", help="CI gate (make prune-smoke): seeded constrained "
                      "churn (zoned topology, spread gangs, anti pairs) "
                      "run three ways — pruned (prune.enable true, "
                      "k = the node count so every shortlist is "
                      "COMPLETE), a pruned double run, and a "
                      "dense-forced control — gating bit-identical "
                      "bind AND ledger fingerprints across all three "
                      "runs, zero prune-crash fallbacks, and the "
                      "pruned kernel provably serving")
    pr.add_argument("--seed", type=int, default=53)
    pr.add_argument("--ticks", type=int, default=120)
    pr.add_argument("--nodes", type=int, default=96)
    pr.add_argument("--zones", type=int, default=4)
    pr.add_argument("--k", type=int, default=0,
                    help="shortlist width (0 = node count: the "
                         "complete-shortlist exactness regime)")
    pr.add_argument("--json", action="store_true")

    storm = sim.add_parser(
        "storm", help="CI gate: watcher storm — 1k+ "
                      "hub subscribers across tenants with seeded frame "
                      "drops, a mid-storm journal gap and real cache "
                      "watch faults, through a bind-flush storm; every "
                      "cursor must converge to the final rv with zero "
                      "unrecovered gaps, >=1 structured relist, >=1 "
                      "throttled tenant, coalesced (not per-event) "
                      "delivery, and a bit-identical double run on bind "
                      "AND ledger fingerprints")
    storm.add_argument("--seed", type=int, default=43)
    storm.add_argument("--ticks", type=int, default=80)
    storm.add_argument("--nodes", type=int, default=192)
    storm.add_argument("--subscribers", type=int, default=1024)
    storm.add_argument("--shards", type=int, default=8)
    storm.add_argument("--drop-rate", type=float, default=0.03)
    storm.add_argument("--json", action="store_true")

    fed = sim.add_parser(
        "federation", help="CI gate: federated control plane — the "
                           "bind storm on the leader replicated to "
                           "follower mirrors, 1k+ "
                           "subscribers served across 3 replicas' hubs, "
                           "one replica killed mid-storm (cursors hand "
                           "off to peers), a forced journal gap "
                           "(snapshot bootstrap) and a deposed-leader "
                           "frame (fenced); every cursor must converge "
                           "with zero unrecovered gaps, every settled "
                           "mirror must fingerprint-identical to the "
                           "leader, and the double run must be "
                           "bit-identical on bind AND ledger "
                           "fingerprints")
    fed.add_argument("--seed", type=int, default=43)
    fed.add_argument("--ticks", type=int, default=60)
    fed.add_argument("--nodes", type=int, default=128)
    fed.add_argument("--subscribers", type=int, default=1024)
    fed.add_argument("--shards", type=int, default=4)
    fed.add_argument("--followers", type=int, default=2)
    fed.add_argument("--drop-rate", type=float, default=0.02)
    # process mode: 3 real vc-apiserver OS processes behind
    # fault-injecting proxies, elector-driven epochs, a half-open
    # partition + a leader SIGKILL, client replica failover
    fed.add_argument("--procs", action="store_true",
                     help="run the chaos process-mode gate: real "
                          "apiserver child processes, seeded fault "
                          "proxies, elector takeovers, client failover")
    fed.add_argument("--pods", type=int, default=192,
                     help="(--procs) writer workload size")
    fed.add_argument("--watchdog", type=float, default=240.0,
                     help="(--procs) per-run hard deadline, seconds")
    fed.add_argument("--json", action="store_true")

    dur = sim.add_parser(
        "durability", help="CI gate: the WAL's crash-consistency "
                           "story — torn-tail "
                           "truncation, mid-log bit-flip refusal (with "
                           "offset+CRC evidence), ENOSPC read-only "
                           "degradation (structured 503) + heal, and "
                           "real vc-apiserver children SIGKILLed at "
                           "three injection points (pre-fsync, "
                           "post-fsync-pre-rename, mid-compaction) "
                           "whose recovered journal/bind/ledger "
                           "fingerprints must be bit-identical to an "
                           "uninterrupted run; double run bit-identical")
    dur.add_argument("--seed", type=int, default=47)
    dur.add_argument("--pods", type=int, default=72,
                     help="writer workload size per process run")
    dur.add_argument("--nodes", type=int, default=8)
    dur.add_argument("--watchdog", type=float, default=420.0,
                     help="per-run hard deadline, seconds")
    dur.add_argument("--json", action="store_true")

    rep = sim.add_parser("replay", help="re-run a violation repro bundle")
    rep.add_argument("--bundle", required=True)
    rep.add_argument("--use-trace", action="store_true",
                     help="replay the recorded event stream verbatim "
                          "instead of re-generating from the seed")
    rep.add_argument("--ticks", type=int, default=None)
    rep.add_argument("--json", action="store_true")

    for verb, why in WAITING.items():
        sim.add_parser(verb, help=f"not ported yet: waits for {why}")

    for verb, parser in sim.choices.items():
        if verb not in WAITING and verb not in HOST_ONLY:
            parser.add_argument(
                "--device", default=None,
                help="torch device (default: the GPU, cuda:0; 'cpu' runs "
                     "the kernels' plain versions)")


def _config_from_args(args):
    from .engine import SimConfig
    from .faults import FaultConfig
    from .workload import WorkloadConfig
    horizon = args.ticks * args.tick_seconds
    return SimConfig(
        seed=args.seed,
        ticks=args.ticks,
        tick_s=args.tick_seconds,
        n_nodes=args.nodes,
        node_cpu=args.node_cpu,
        node_mem=args.node_mem,
        resident_jobs=args.resident_jobs,
        resident_gang=args.resident_gang,
        workload=WorkloadConfig(seed=args.seed, horizon_s=horizon,
                                arrival_rate=args.arrival_rate),
        faults=FaultConfig(seed=args.seed,
                           bind_fail_rate=args.bind_fail_rate,
                           api_latency_s=args.api_latency,
                           flap_rate=args.flap_rate,
                           kill_rate=args.kill_rate,
                           storm_rate=args.storm_rate),
        fail_rate=args.fail_rate,
        trace_path=args.trace,
        check_invariants=not args.no_invariants,
        stop_on_violation=not args.keep_going,
        repro_dir=args.repro_dir,
        device=args.device)


def smoke_config(seed: int = 7, ticks: int = 200, nodes: int = 512,
                 device=None):
    """The `make sim-smoke` shape: >= 2k tasks through >= 512 nodes over
    >= 200 virtual-time ticks with node flaps and bind-failure injection
    on. A resident backlog of 216 gangs-of-8 (1728 tasks) plus a Poisson
    arrival stream (~0.5 jobs/s x 200 s x ~4.2 avg gang ≈ 400 tasks)
    clears 2k comfortably while keeping each cycle fast enough that the
    double run (determinism half) fits the 60 s budget."""
    from .engine import SimConfig
    from .faults import FaultConfig
    from .workload import WorkloadConfig
    horizon = float(ticks)
    return SimConfig(
        seed=seed, ticks=ticks, tick_s=1.0, n_nodes=nodes,
        node_cpu="16", node_mem="32Gi",
        queues=[("default", 2, None),
                ("capped", 1, {"cpu": str(nodes * 8), "memory": "99999Gi"})],
        resident_jobs=216, resident_gang=8,
        workload=WorkloadConfig(
            seed=seed, horizon_s=horizon, arrival_rate=0.5,
            duration_min_s=20.0, duration_max_s=150.0,
            queues=["default", "capped"]),
        faults=FaultConfig(
            seed=seed, bind_fail_rate=0.02, api_latency_s=0.001,
            flap_rate=0.05, flap_down_s=6.0,
            kill_rate=0.01, kill_down_s=12.0,
            storm_rate=0.01, storm_fraction=0.05),
        fail_rate=0.05,
        repro_dir=".", device=device)


POISON_POD = "default/rj-0-0"


def chaos_config(seed: int = 13, ticks: int = 120, nodes: int = 128,
                 device=None):
    """The `make chaos-smoke` shape (docs/design/resilience.md): a
    resident gang backlog plus a Poisson stream under 2% injected bind
    failures AND one targeted poison pod (task 0 of resident gang rj-0,
    whose binds always fail). Node churn and evict storms stay off so
    every partial gang the audit sees comes from the bind-failure path —
    the gang-atomic healing must hold with NO waiver, and the poison pod
    must exhaust its retry budget into quarantine."""
    from .engine import SimConfig
    from .faults import FaultConfig
    from .workload import WorkloadConfig
    return SimConfig(
        seed=seed, ticks=ticks, tick_s=1.0, n_nodes=nodes,
        node_cpu="16", node_mem="32Gi",
        resident_jobs=80, resident_gang=8,
        workload=WorkloadConfig(
            seed=seed, horizon_s=float(ticks), arrival_rate=0.3,
            duration_min_s=20.0, duration_max_s=120.0),
        faults=FaultConfig(
            seed=seed, bind_fail_rate=0.02, api_latency_s=0.001,
            fail_pods=[POISON_POD]),
        fail_rate=0.0,
        repro_dir=".", device=device)


def failover_config(seed: int = 29, ticks: int = 120, nodes: int = 128,
                    device=None):
    """The `make failover-smoke` shape (docs/design/failover.md): a
    resident gang backlog plus a Poisson stream under leader election on
    the virtual clock, with ALL the control-plane failure modes scripted
    into one run:

    * tick 30 — ``leader_lapse`` with a mid-flush crash: the leader dies
      5 binds into its flush without releasing the lease; a fresh
      candidate waits out the 5s lease (why-pending says "standby"),
      takes over with a bumped fencing token, and the deposed
      incarnation's leftover write MUST be rejected (``FencedError``);
    * tick 60 — ``scheduler_kill`` (stateless) mid-flush: same-identity
      restart rebuilds the cache from the surviving store;
    * tick 85 — ``scheduler_kill`` (snapshot): the whole store is
      checkpointed via persistence.save_store and restored into a fresh
      one (journal cleared + sequencer re-anchored), the etcd-restore
      drill;
    * throughout — 2% bind-failure injection AND 2% watch-delivery drops
      (FlakyWatch), with anti-entropy every tick so each dropped
      delivery is detected and repaired before that tick's audit.

    ``gang_converge_ticks`` widens to lease+5: a gang left partial by
    the mid-flush crash cannot converge before the standby wins the
    lease — the checker still requires convergence, just within the
    whole failover window instead of the usual 2 ticks. Node churn and
    storms stay off so every partial gang the audit sees comes from the
    crash/fencing path."""
    from .engine import SimConfig
    from .faults import FaultConfig
    from .workload import WorkloadConfig
    lease_s = 5.0
    return SimConfig(
        seed=seed, ticks=ticks, tick_s=1.0, n_nodes=nodes,
        node_cpu="16", node_mem="32Gi",
        resident_jobs=64, resident_gang=8,
        workload=WorkloadConfig(
            seed=seed, horizon_s=float(ticks), arrival_rate=0.3,
            duration_min_s=20.0, duration_max_s=120.0),
        faults=FaultConfig(
            seed=seed, bind_fail_rate=0.02, api_latency_s=0.001,
            watch_drop_rate=0.02),
        fail_rate=0.0,
        elections=True, lease_s=lease_s,
        gang_converge_ticks=int(lease_s) + 5,
        anti_entropy_every_ticks=1,
        control_events=[
            {"at": 30.0, "kind": "leader_lapse", "mid_flush_binds": 5},
            {"at": 60.0, "kind": "scheduler_kill", "mode": "stateless",
             "mid_flush_binds": 3},
            {"at": 85.0, "kind": "scheduler_kill", "mode": "snapshot"},
        ],
        repro_dir=".", device=device)


def obs_config(seed: int = 17, ticks: int = 60, nodes: int = 128,
               device=None):
    """The `make obs-smoke` shape (docs/design/observability.md): a
    resident backlog plus a Poisson stream with 2% bind failures and
    mid-run gang pod losses, short enough for a double run in well under
    a minute. Every pod that completes the pipeline must land in the
    lifecycle ledger's e2e/hop histograms; pods deleted mid-flight must
    be dropped (zero orphans); and the virtual clock makes both runs'
    ledger aggregates bit-identical."""
    from .engine import SimConfig
    from .faults import FaultConfig
    from .workload import WorkloadConfig
    return SimConfig(
        seed=seed, ticks=ticks, tick_s=1.0, n_nodes=nodes,
        node_cpu="16", node_mem="32Gi",
        resident_jobs=40, resident_gang=8,
        workload=WorkloadConfig(
            seed=seed, horizon_s=float(ticks), arrival_rate=0.3,
            duration_min_s=10.0, duration_max_s=40.0),
        faults=FaultConfig(
            seed=seed, bind_fail_rate=0.02, api_latency_s=0.001),
        fail_rate=0.05,
        repro_dir=".", device=device)


def incr_config(seed: int = 23, ticks: int = 200, nodes: int = 256,
                incremental: bool = True, device=None):
    """The `make incr-smoke` shape (docs/design/incremental_cycle.md):
    200 ticks covering the three churn regimes the incremental cycle
    must survive — a BURSTY resident backlog at t=0, a Poisson arrival
    stream with node FLAPS through the first 60% of the horizon, and a
    QUIET tail (arrivals stop, completions drain, steady-state cycles go
    dirty-free) where the quiet fast path must engage. Run twice —
    ``incremental`` on vs off — the bind and ledger fingerprints must be
    bit-identical: the persistent patched snapshot is required to be
    indistinguishable, bind for bind, from a full rebuild every tick."""
    from .engine import SimConfig
    from .faults import FaultConfig
    from .workload import WorkloadConfig
    return SimConfig(
        seed=seed, ticks=ticks, tick_s=1.0, n_nodes=nodes,
        node_cpu="16", node_mem="32Gi",
        resident_jobs=96, resident_gang=8,
        workload=WorkloadConfig(
            seed=seed, horizon_s=float(ticks) * 0.6, arrival_rate=0.4,
            duration_min_s=15.0, duration_max_s=90.0),
        faults=FaultConfig(
            seed=seed, flap_rate=0.04, flap_down_s=6.0),
        fail_rate=0.05,
        incremental=incremental,
        repro_dir=".", device=device)


def constraint_config(seed: int = 41, ticks: int = 160, nodes: int = 96,
                      zones: int = 4, reference: bool = False,
                      device=None):
    """The `make constraint-smoke` shape (docs/design/constraints.md):
    zoned nodes, a churn stream where ~45% of gangs carry constraints
    (hard/soft zone spread, one-per-zone anti pairs) over elastic
    unconstrained filler, and a scripted high-priority preemption storm
    at 70% of the horizon driving the victim-selection kernel through
    eviction-heavy cycles. ``reference`` forces the per-task Python
    predicate path and the Python victim walk — the control run the
    compiled run must match bind-for-bind and evict-for-evict."""
    from .engine import SimConfig
    from .faults import FaultConfig
    from .workload import (CONSTRAINT_CONF, CONSTRAINT_REFERENCE_CONF,
                           constraint_scenario_workload, preempt_storm)
    storm_at = float(ticks) * 0.7
    storms = [dict(e) for e in preempt_storm(
        storm_at, n_jobs=6, gang=2, cpu="4", mem="8Gi",
        queue="batch", name_prefix="storm-p")]     # same-queue preempt
    storms += [dict(e) for e in preempt_storm(
        storm_at, n_jobs=6, gang=2, cpu="4", mem="8Gi",
        queue="prod", name_prefix="storm-r")]      # cross-queue reclaim
    return SimConfig(
        seed=seed, ticks=ticks, tick_s=1.0, n_nodes=nodes,
        node_cpu="8", node_mem="16Gi", node_zones=zones,
        conf_text=(CONSTRAINT_REFERENCE_CONF if reference
                   else CONSTRAINT_CONF),
        queues=[("batch", 1, None), ("prod", 1, None)],
        priority_classes=[("storm-high", 1000)],
        resident_jobs=40, resident_gang=8, resident_min=4,
        workload=constraint_scenario_workload(seed, ticks, queue="batch"),
        control_events=storms,
        repro_dir=".", device=device)


PRUNE_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""


def prune_config(seed: int = 53, ticks: int = 120, nodes: int = 96,
                 zones: int = 4, k: int = 0, pruned: bool = True,
                 device=None):
    """The `make prune-smoke` shape (docs/design/pruning.md): zoned
    nodes and the constraint-heavy churn stream (hard/soft zone spread
    gangs, one-per-zone anti pairs over elastic filler) with the
    candidate-pruning regime FORCED on (``prune.min_nodes`` floor
    bypassed via ``prune.enable: "true"``) at ``k`` = the node count —
    complete shortlists, so pruned placements are bit-identical with
    the dense control BY CONTRACT, and any fingerprint divergence is a
    pruning bug, not a documented tie-break. ``pruned=False`` is the
    dense-forced control leg."""
    from .engine import SimConfig
    from .faults import FaultConfig
    from .workload import constraint_scenario_workload
    k = int(k) or int(nodes)
    arg = (f'    prune.enable: "true"\n    prune.k: "{k}"'
           if pruned else '    prune.enable: "off"')
    conf_text = PRUNE_CONF + f"""
configurations:
- name: solver
  arguments:
{arg}
"""
    return SimConfig(
        seed=seed, ticks=ticks, tick_s=1.0, n_nodes=nodes,
        node_cpu="8", node_mem="16Gi", node_zones=zones,
        conf_text=conf_text,
        queues=[("batch", 1, None)],
        resident_jobs=40, resident_gang=8, resident_min=4,
        workload=constraint_scenario_workload(seed, ticks, queue="batch"),
        faults=FaultConfig(seed=seed),
        repro_dir=".", device=device)


def _explain_overhead_probe(device=None) -> float:
    """The explain-smoke overhead leg: interleaved min-of-N steady
    run_once cycles with the tracer+explain hook sites fully OFF vs ON
    their production off-path (tracer enabled, ``explain.enable`` off —
    the shipping default). Returns the measured overhead in percent;
    mirrors tests/test_trace.py's tracer gate, extended over the
    explain layer's off-mode residue (one cached bool per place)."""
    import time as _time

    from ..apiserver import ObjectStore
    from ..cache import SchedulerCache
    from ..scheduler import Scheduler
    from ..trace import tracer
    from ..utils.test_utils import (FakeBinder, FakeEvictor, build_node,
                                    build_pod, build_pod_group,
                                    build_queue)
    from .engine import DEFAULT_CONF
    store = ObjectStore()
    cache = SchedulerCache(store, binder=FakeBinder(store),
                           evictor=FakeEvictor(store))
    cache.run()
    sched = Scheduler(store, scheduler_conf=DEFAULT_CONF, cache=cache,
                      device=device)
    store.create("queues", build_queue("default", weight=1))
    for i in range(16):
        store.create("nodes", build_node(
            f"n{i}", {"cpu": "8", "memory": "16Gi"}))
    for j in range(8):
        store.create("podgroups", build_pod_group(
            f"pg-{j}", "default", "default", 3, phase="Inqueue"))
        for t in range(3):
            store.create("pods", build_pod(
                "default", f"pg-{j}-{t}", "", "Pending",
                {"cpu": "1", "memory": "1Gi"}, groupname=f"pg-{j}"))
    trace_was_on = tracer.is_enabled()
    try:
        sched.run_once()
        cache.flush_executors()
        for _ in range(3):      # settle: binds echoed, nothing pending
            sched.run_once()

        def steady(n=12):
            best = float("inf")
            for _ in range(n):
                t0 = _time.perf_counter()
                sched.run_once()
                best = min(best, _time.perf_counter() - t0)
            return best

        steady(3)               # warm both code paths
        pct = float("inf")
        for _ in range(3):      # flake shield vs co-tenant bursts
            base = hooked = float("inf")
            for _ in range(4):  # interleave to cancel machine drift
                tracer.disable()
                base = min(base, steady())
                tracer.enable()
                hooked = min(hooked, steady())
            # the 0.3 ms epsilon is the timer floor at this tiny scale
            pct = min(pct, (hooked - base - 3e-4) / base * 100.0)
            if pct < 2.0:
                break
        return max(pct, 0.0)
    finally:
        if not trace_was_on:
            tracer.disable()
        sched.stop()
        cache.stop()


def _print_summary(summary: dict, as_json: bool) -> None:
    if as_json:
        print(json.dumps(summary, indent=1))
        return
    c = summary["cycle_ms"]
    print(f"ticks={summary['ticks']} vtime={summary['vtime_s']}s "
          f"jobs arrived={summary['arrived_jobs']} "
          f"completed={summary['completed_jobs']} "
          f"binds={summary['binds']}")
    print(f"cycle latency ms: p50={c['p50']} p95={c['p95']} max={c['max']}")
    print(f"bind fingerprint: {summary['bind_fingerprint'][:16]}…")
    if summary["violations"]:
        print(f"INVARIANT VIOLATIONS: {len(summary['violations'])}")
        for v in summary["violations"][:10]:
            print(f"  tick {v['tick']}: [{v['invariant']}] {v['detail']}")
        for p in summary["repro_bundles"]:
            print(f"  repro bundle: {p}")
    else:
        print("invariants: clean")


def dispatch_sim(args) -> int:
    if args.verb in WAITING:
        print(f"sim {args.verb}: not ported yet; it waits for "
              f"{WAITING[args.verb]}", file=sys.stderr)
        return 2
    if args.verb == "durability":
        return _durability(args)
    if args.verb == "federation" and args.procs:
        return _federation_procs(args)
    from ..utils.platform import default_device
    try:
        default_device(args.device)
    except RuntimeError as e:
        print(f"sim {args.verb}: {e}", file=sys.stderr)
        return 2
    from .engine import run_sim
    if args.verb == "run":
        result = run_sim(_config_from_args(args))
        if args.trace_out:
            from .workload import dump_trace
            dump_trace(args.trace_out, result.events_applied)
        _print_summary(result.summary(), args.json)
        return 1 if result.violations else 0

    if args.verb == "smoke":
        cfg = smoke_config(seed=args.seed, ticks=args.ticks,
                           nodes=args.nodes, device=args.device)
        r1 = run_sim(cfg)
        s1 = r1.summary()
        tasks_through = sum(
            int(e["size"]) for e in r1.events_applied
            if e.get("kind") == "job_arrival")
        ok = not r1.violations and s1["ticks"] >= args.ticks \
            and tasks_through >= 2000
        # determinism half: same seed, same config, fresh engine — the
        # bind sequences must be bit-identical. Skipped when the first
        # run already failed: re-running a red gate doubles time-to-red
        # for no extra signal.
        deterministic = False
        if ok:
            r2 = run_sim(smoke_config(seed=args.seed, ticks=args.ticks,
                                      nodes=args.nodes, device=args.device))
            deterministic = r1.bind_fingerprint() == r2.bind_fingerprint()
        verdict = {
            "smoke": s1,
            "tasks_through": tasks_through,
            "deterministic_replay": deterministic,
            "pass": bool(ok and deterministic),
        }
        if args.json:
            print(json.dumps(verdict, indent=1))
        else:
            _print_summary(s1, False)
            print(f"tasks through the sim: {tasks_through}")
            print(f"same-seed bind sequence identical: {deterministic}")
            print(f"sim-smoke: {'PASS' if verdict['pass'] else 'FAIL'}")
        return 0 if verdict["pass"] else 1

    if args.verb == "chaos":
        from ..trace import tracer
        from ..trace.pending import REASON_QUARANTINED
        r1 = run_sim(chaos_config(seed=args.seed, ticks=args.ticks,
                                  nodes=args.nodes, device=args.device))
        rep1 = tracer.pending_report() or {}
        r2 = run_sim(chaos_config(seed=args.seed, ticks=args.ticks,
                                  nodes=args.nodes, device=args.device))
        checks = {
            # atomicity healed, not waived: the checker ran with no
            # bind-failure exemption and stayed clean
            "no_violations": not r1.violations and not r2.violations,
            "bind_failures_fired": r1.resync_retries > 0
                                   and bool(r1.bind_sequence),
            "quarantine_reached": POISON_POD in r1.quarantined,
            "why_pending_quarantine":
                REASON_QUARANTINED in (rep1.get("reasons") or {}),
            "deterministic_replay":
                r1.bind_fingerprint() == r2.bind_fingerprint()
                and r1.quarantined == r2.quarantined
                and r1.resync_retries == r2.resync_retries,
        }
        verdict = {
            "chaos": r1.summary(),
            "checks": checks,
            "pass": all(checks.values()),
        }
        if args.json:
            print(json.dumps(verdict, indent=1))
        else:
            _print_summary(r1.summary(), False)
            print(f"resync retries: {r1.resync_retries}  "
                  f"quarantined: {r1.quarantined}")
            for name, ok in checks.items():
                print(f"  {name}: {'ok' if ok else 'FAIL'}")
            print(f"chaos-smoke: {'PASS' if verdict['pass'] else 'FAIL'}")
        return 0 if verdict["pass"] else 1

    if args.verb == "failover":
        from ..trace import ledger as _ledger
        from ..trace.pending import REASON_NOT_LEADER
        from .engine import SimEngine
        eng1 = SimEngine(failover_config(seed=args.seed, ticks=args.ticks,
                                         nodes=args.nodes, device=args.device))
        r1 = eng1.run()
        # observability acceptance: even across kills/handover/snapshot-
        # restore, a confirmed bind's ledger correlation ID must join
        # back to the (current) store's journal trace map
        led_traces = {rec["trace"] for rec in _ledger.report()["recent"]
                      if rec.get("trace")}
        store_traces = {t for _, _, t in eng1.store.trace_ranges()}
        trace_joinable = bool(led_traces & store_traces)
        r2 = run_sim(failover_config(seed=args.seed, ticks=args.ticks,
                                     nodes=args.nodes, device=args.device))
        checks = {
            # the rebuilt/restored control planes satisfied the whole
            # catalog every audited tick — crash-left partial gangs
            # reconverged, journal stayed gap-free, no silent rebinds
            "no_violations": not r1.violations and not r2.violations,
            "restarts_ran": r1.restarts == 3,
            # the deposed incarnation's stale-token write was rejected
            "fenced_write_rejected": r1.fenced_writes >= 1,
            # FlakyWatch diverged the cache and anti-entropy repaired it
            "divergence_repaired": r1.divergence_repairs >= 1
                                   and r1.watch_drops >= 1,
            # the standby window said WHY nothing was being scheduled
            "standby_reason_surfaced":
                REASON_NOT_LEADER in r1.pending_reasons_seen,
            # a bind stays traceable scheduler -> store journal -> watch
            # echo across the failover scenarios (the obs layer)
            "bind_trace_joinable": trace_joinable,
            "bind_failures_fired": r1.resync_retries > 0
                                   and bool(r1.bind_sequence),
            "deterministic_replay":
                r1.bind_fingerprint() == r2.bind_fingerprint()
                and r1.fenced_writes == r2.fenced_writes
                and r1.divergence_repairs == r2.divergence_repairs
                and r1.restarts == r2.restarts
                and r1.resync_retries == r2.resync_retries,
        }
        verdict = {
            "failover": r1.summary(),
            "checks": checks,
            "pass": all(checks.values()),
        }
        if args.json:
            print(json.dumps(verdict, indent=1))
        else:
            _print_summary(r1.summary(), False)
            print(f"restarts: {r1.restarts}  fenced writes: "
                  f"{r1.fenced_writes}  divergence repairs: "
                  f"{r1.divergence_repairs}  watch drops: "
                  f"{r1.watch_drops}")
            for name, ok in checks.items():
                print(f"  {name}: {'ok' if ok else 'FAIL'}")
            print(f"failover-smoke: {'PASS' if verdict['pass'] else 'FAIL'}")
        return 0 if verdict["pass"] else 1

    if args.verb == "obs":
        from .engine import SimEngine
        eng1 = SimEngine(obs_config(seed=args.seed, ticks=args.ticks,
                                    nodes=args.nodes, device=args.device))
        r1 = eng1.run()
        led1 = r1.ledger
        # end-to-end correlation: a confirmed bind's ledger entry and
        # the store's journal trace map must agree on the flush's
        # correlation ID (the pod's CURRENT rv may already belong to a
        # later unstamped write — the kubelet's Running echo — so the
        # join runs over the recorded IDs, not live object rvs)
        from ..trace import ledger as _ledger
        led_traces = {r["trace"] for r in _ledger.report()["recent"]
                      if r.get("trace")}
        store_traces = {t for _, _, t in eng1.store.trace_ranges()}
        traceable = bool(led_traces & store_traces)
        r2 = run_sim(obs_config(seed=args.seed, ticks=args.ticks,
                                nodes=args.nodes, device=args.device))
        led2 = r2.ledger
        checks = {
            "no_violations": not r1.violations and not r2.violations,
            # the ledger filled: completions flowed into nonzero e2e and
            # per-hop histograms
            "ledger_nonzero": led1.get("completed", 0) > 0
                              and led1.get("e2e", {}).get("count", 0) > 0,
            "zero_orphans": led1.get("orphans") == []
                            and led2.get("orphans") == [],
            "bind_trace_joinable": traceable,
            "detours_recorded": bool(led1.get("detours"))
                                == (r1.resync_retries > 0),
            "deterministic_replay":
                r1.bind_fingerprint() == r2.bind_fingerprint()
                and led1.get("fingerprint") == led2.get("fingerprint"),
        }
        verdict = {
            "obs": r1.summary(),
            "checks": checks,
            "pass": all(checks.values()),
        }
        if args.json:
            print(json.dumps(verdict, indent=1))
        else:
            _print_summary(r1.summary(), False)
            print(f"ledger: completed={led1.get('completed')} "
                  f"open={led1.get('open')} dropped={led1.get('dropped')} "
                  f"detours={led1.get('detours')}")
            e2e = led1.get("e2e", {})
            print(f"pod e2e ms: p50={e2e.get('p50')} p95={e2e.get('p95')} "
                  f"p99={e2e.get('p99')} (n={e2e.get('count')})")
            for name, ok in checks.items():
                print(f"  {name}: {'ok' if ok else 'FAIL'}")
            print(f"obs-smoke: {'PASS' if verdict['pass'] else 'FAIL'}")
        return 0 if verdict["pass"] else 1

    if args.verb == "incr":
        r_incr = run_sim(incr_config(seed=args.seed, ticks=args.ticks,
                                     nodes=args.nodes, incremental=True,
                                     device=args.device))
        r_full = run_sim(incr_config(seed=args.seed, ticks=args.ticks,
                                     nodes=args.nodes, incremental=False,
                                     device=args.device))
        checks = {
            "no_violations": not r_incr.violations
                             and not r_full.violations,
            # the machinery actually engaged: patched cycles ran and the
            # quiet tail took the fast path
            "incremental_cycles_ran":
                r_incr.cycle_modes.get("incremental", 0) > 0,
            "quiet_cycles_ran": r_incr.quiet_cycles > 0,
            "full_run_forced_full":
                r_full.cycle_modes.get("incremental", 0) == 0,
            # the whole point: the patched persistent snapshot is
            # bind-for-bind AND ledger-for-ledger indistinguishable
            # from rebuilding the cluster every tick
            "bind_fingerprints_identical":
                r_incr.bind_fingerprint() == r_full.bind_fingerprint(),
            "ledger_fingerprints_identical":
                r_incr.ledger.get("fingerprint") ==
                r_full.ledger.get("fingerprint"),
        }
        verdict = {
            "incremental": r_incr.summary(),
            "forced_full": {
                "binds": len(r_full.bind_sequence),
                "bind_fingerprint": r_full.bind_fingerprint(),
                "ledger_fingerprint": r_full.ledger.get("fingerprint"),
                "cycle_ms": r_full.cycle_ms_percentiles(skip=1),
            },
            "checks": checks,
            "pass": all(checks.values()),
        }
        if args.json:
            print(json.dumps(verdict, indent=1))
        else:
            _print_summary(r_incr.summary(), False)
            c_full = r_full.cycle_ms_percentiles(skip=1)
            c_incr = r_incr.cycle_ms_percentiles(skip=1)
            print(f"cycle modes: {r_incr.cycle_modes} "
                  f"(quiet={r_incr.quiet_cycles})")
            print(f"steady p50 ms: incremental={c_incr['p50']} "
                  f"forced-full={c_full['p50']}")
            for name, ok in checks.items():
                print(f"  {name}: {'ok' if ok else 'FAIL'}")
            print(f"incr-smoke: {'PASS' if verdict['pass'] else 'FAIL'}")
        return 0 if verdict["pass"] else 1

    if args.verb == "constraints":
        from ..metrics import metrics as m

        def counters():
            return {
                "compiled": m.counter_total(m.CONSTRAINT_BUILD_RUNS,
                                            mode="compiled"),
                "reference": m.counter_total(m.CONSTRAINT_BUILD_RUNS,
                                             mode="reference"),
                "vk_kernel": m.counter_total(m.VICTIM_SELECT_RUNS,
                                             mode="kernel"),
                "vk_python": m.counter_total(m.VICTIM_SELECT_RUNS,
                                             mode="python"),
                "fallbacks": m.counter_total(m.CONSTRAINT_FALLBACK),
            }

        def cfg(reference=False):
            return constraint_config(seed=args.seed, ticks=args.ticks,
                                     nodes=args.nodes, zones=args.zones,
                                     reference=reference, device=args.device)

        c0 = counters()
        r1 = run_sim(cfg())                    # compiled
        c1 = counters()
        r2 = run_sim(cfg())                    # compiled double run
        c2 = counters()
        r3 = run_sim(cfg(reference=True))      # Python reference control
        c3 = counters()
        checks = {
            "no_violations": not r1.violations and not r2.violations
                             and not r3.violations,
            # both lowered paths demonstrably ran in the compiled runs,
            # with zero crash fallbacks across ALL THREE runs (c0->c3
            # spans the double compiled run and the control); the
            # control demonstrably ran the per-task reference and the
            # Python victim walk
            "compiled_masks_ran": c1["compiled"] > c0["compiled"],
            "victim_kernel_ran": c1["vk_kernel"] > c0["vk_kernel"],
            "no_compile_fallbacks": c3["fallbacks"] == c0["fallbacks"],
            "control_ran_reference":
                c3["reference"] > c2["reference"]
                and c3["compiled"] == c2["compiled"]
                and c3["vk_kernel"] == c2["vk_kernel"]
                and c3["vk_python"] > c2["vk_python"],
            # preemption actually exercised the victim path
            "evictions_happened": len(r1.evict_sequence) > 0,
            # kernel-vs-reference parity: bind AND evict sequences
            # identical, ledger too
            "outcome_parity_with_reference":
                r1.outcome_fingerprint() == r3.outcome_fingerprint(),
            "ledger_parity_with_reference":
                r1.ledger.get("fingerprint") == r3.ledger.get("fingerprint"),
            # and deterministic with itself across a double run
            "deterministic_replay":
                r1.outcome_fingerprint() == r2.outcome_fingerprint()
                and r1.ledger.get("fingerprint")
                == r2.ledger.get("fingerprint"),
        }
        verdict = {
            "constraints": r1.summary(),
            "counters": {k: c1[k] - c0[k] for k in c1},
            "checks": checks,
            "pass": all(checks.values()),
        }
        if args.json:
            print(json.dumps(verdict, indent=1))
        else:
            _print_summary(r1.summary(), False)
            print(f"evictions: {len(r1.evict_sequence)}  compiled builds: "
                  f"{int(c1['compiled'] - c0['compiled'])}  victim-kernel "
                  f"runs: {int(c1['vk_kernel'] - c0['vk_kernel'])}")
            for name, ok in checks.items():
                print(f"  {name}: {'ok' if ok else 'FAIL'}")
            print("constraint-smoke: "
                  f"{'PASS' if verdict['pass'] else 'FAIL'}")
        return 0 if verdict["pass"] else 1

    if args.verb == "explain":
        from ..trace import explain as ex

        def cfg():
            return constraint_config(seed=args.seed, ticks=args.ticks,
                                     nodes=args.nodes, zones=args.zones,
                                     device=args.device)

        # overhead leg FIRST (explain must be off): min-of-N interleaved
        # steady cycles, hooks-off vs hooks-on-switch-off
        ex.disable()
        overhead_pct = _explain_overhead_probe(args.device)
        ex.enable()
        try:
            ex.reset()
            r1 = run_sim(cfg())
            rep1 = ex.report(limit=0)
            fp1 = rep1["fingerprint"]
            ex.reset()
            r2 = run_sim(cfg())
            fp2 = ex.fingerprint()
        finally:
            ex.disable()
        bound_jobs = {f"{key.rsplit('-', 1)[0]}"
                      for key, _host in r1.bind_sequence}
        explained = set(rep1["jobs"])
        missing = sorted(bound_jobs - explained)
        bad_sums = []
        for jkey, rec in rep1["jobs"].items():
            for g in rec["groups"]:
                if g["feasible"] + sum(g["eliminations"].values()) \
                        != g["nodes"]:
                    bad_sums.append((jkey, g["gang"]))
        checks = {
            "no_violations": not r1.violations and not r2.violations,
            # every bound pod's job carries a provenance record
            "every_bind_explained": not missing and bool(bound_jobs),
            # the elimination ladder telescopes exactly to the node axis
            "eliminations_sum_to_nodes": not bad_sums,
            # the preemption storm's victim decisions were recorded
            "victim_decisions_recorded": len(rep1["victims"]) > 0,
            "evictions_happened": len(r1.evict_sequence) > 0,
            # bit-identical provenance across a same-seed double run
            "fingerprint_deterministic":
                fp1 == fp2
                and r1.bind_fingerprint() == r2.bind_fingerprint(),
            # the off-mode hook residue on the steady cycle
            "overhead_under_2pct": overhead_pct < 2.0,
        }
        verdict = {
            "explain": r1.summary(),
            "records": rep1["records"],
            "victim_records": len(rep1["victims"]),
            "aggregates": rep1["aggregates"],
            "fingerprint": fp1,
            "overhead_off_pct": round(overhead_pct, 3),
            "missing_records": missing[:10],
            "checks": checks,
            "pass": all(checks.values()),
        }
        if args.json:
            print(json.dumps(verdict, indent=1))
        else:
            _print_summary(r1.summary(), False)
            agg = rep1["aggregates"]
            print(f"records={rep1['records']} victim_records="
                  f"{len(rep1['victims'])} feasible/gang="
                  f"{agg['feasible_nodes']} coverage="
                  f"{agg['topk_coverage']} frag="
                  f"{agg['fragmentation_ratio']}")
            print(f"off-mode overhead: {overhead_pct:.2f}%")
            for name, ok in checks.items():
                print(f"  {name}: {'ok' if ok else 'FAIL'}")
            print(f"explain-smoke: {'PASS' if verdict['pass'] else 'FAIL'}")
        return 0 if verdict["pass"] else 1

    if args.verb == "prune":
        from ..metrics import metrics as m
        from ..ops.prune import FALLBACK_REASONS
        from ..trace import explain as ex

        # the port has no crash fallback (a failing kernel raises), so
        # the "crash" counter stays at zero; it stays in the verdict so
        # that its checks and fallbacks compare key for key with the
        # reference's (tests/test_torch_sim_verbs.py)
        reasons = FALLBACK_REASONS + ("crash",)

        def counters():
            c = {"runs": m.counter_total(m.PRUNE_RUNS, level="single")
                 + m.counter_total(m.PRUNE_RUNS, level="two_level")}
            for r in reasons:
                c[r] = m.counter_total(m.PRUNE_FALLBACK, reason=r)
            return c

        def cfg(pruned=True):
            return prune_config(seed=args.seed, ticks=args.ticks,
                                nodes=args.nodes, zones=args.zones,
                                k=args.k, pruned=pruned, device=args.device)

        ex.reset()
        c0 = counters()
        r1 = run_sim(cfg())                    # pruned
        c1 = counters()
        r2 = run_sim(cfg())                    # pruned double run
        c2 = counters()
        r3 = run_sim(cfg(pruned=False))        # dense-forced control
        c3 = counters()
        prune_rep = ex.prune_report()
        checks = {
            "no_violations": not r1.violations and not r2.violations
                             and not r3.violations,
            # the pruned kernel provably served (and the dense control
            # provably never pruned)
            "pruned_kernel_ran": c1["runs"] > c0["runs"],
            "control_ran_dense": c3["runs"] == c2["runs"],
            # a crash fallback anywhere across the three runs means the
            # reduced-problem plumbing broke (guard fallbacks would be
            # contract-legal, but at k = node count the shortlists are
            # COMPLETE, so exhaustion/low-coverage cannot fire either)
            "zero_prune_crash_fallbacks": c3["crash"] == c0["crash"],
            "zero_guard_fallbacks":
                c3["shortlist_exhausted"] == c0["shortlist_exhausted"]
                and c3["low_coverage"] == c0["low_coverage"],
            # the exactness contract: complete shortlists make the
            # pruned run bit-identical with the dense control, bind for
            # bind AND ledger for ledger
            "bind_parity_with_dense":
                r1.bind_fingerprint() == r3.bind_fingerprint(),
            "ledger_parity_with_dense":
                r1.ledger.get("fingerprint") == r3.ledger.get("fingerprint"),
            # and deterministic with itself across a double run
            "deterministic_replay":
                r1.bind_fingerprint() == r2.bind_fingerprint()
                and r1.ledger.get("fingerprint")
                == r2.ledger.get("fingerprint"),
        }
        verdict = {
            "prune": r1.summary(),
            "prune_runs": c1["runs"] - c0["runs"],
            "prune_fallbacks": {r: c3[r] - c0[r] for r in reasons},
            "shortlist_loss": prune_rep["last"],
            "checks": checks,
            "pass": all(checks.values()),
        }
        if args.json:
            print(json.dumps(verdict, indent=1))
        else:
            _print_summary(r1.summary(), False)
            print(f"pruned kernel runs: {int(verdict['prune_runs'])}  "
                  f"binds: {len(r1.bind_sequence)}  "
                  f"last shortlist: {prune_rep['last']}")
            for name, ok in checks.items():
                print(f"  {name}: {'ok' if ok else 'FAIL'}")
            print(f"prune-smoke: {'PASS' if verdict['pass'] else 'FAIL'}")
        return 0 if verdict["pass"] else 1

    if args.verb == "storm":
        from ..serving.storm import run_storm

        def one_run():
            return run_storm(seed=args.seed, ticks=args.ticks,
                             nodes=args.nodes,
                             subscribers=args.subscribers,
                             shards=args.shards, drop_rate=args.drop_rate,
                             device=args.device)

        v1 = one_run()
        v2 = one_run()
        checks = {
            # the engine's own invariant catalog (journal order incl.)
            # stayed clean under the storm in both runs
            "no_violations": v1["violations"] == 0
                             and v2["violations"] == 0,
            # every subscriber session reached the final store rv
            "all_converged": v1["converged"] == v1["subscribers"]
                             and v2["converged"] == v2["subscribers"]
                             and v1["subscribers"] >= args.subscribers
                             - max(16, args.subscribers // 50),
            # and no frame-chain hole survived recovery
            "zero_gaps": v1["gaps_unrecovered"] == 0
                         and v2["gaps_unrecovered"] == 0,
            # the faults provably fired: frames dropped + chain gaps
            # detected and recovered client-side
            "faults_fired": v1["frames_dropped"] > 0
                            and v1["gaps_detected"] > 0,
            # cache-side watch faults at storm scale (the
            # commit-order-stable fault coin makes them replayable
            # here), diverging the scheduler's cache and repaired by
            # anti-entropy before each tick's audit
            "cache_watch_faults_fired": v1["watch_drops"] > 0
                                        and v1["divergence_repairs"] > 0,
            # the mid-storm journal gap took the structured relist path
            "relist_taken": v1["relists"] >= 1,
            # the noisy tenant was throttled at the admission edge
            "throttled_tenant_observed":
                v1["noisy_throttled_writes"] >= 1
                or v1["noisy_subscription_throttles"] >= 1,
            # a storm burst reaches a client as coalesced frames, not
            # per-event deliveries
            "coalesced_delivery": v1["coalesce_ratio"] >= 5.0,
            "deterministic_replay":
                v1["bind_fingerprint"] == v2["bind_fingerprint"]
                and v1["ledger_fingerprint"] == v2["ledger_fingerprint"]
                and v1["noisy_throttled_writes"]
                == v2["noisy_throttled_writes"]
                and v1["watch_drops"] == v2["watch_drops"],
        }
        verdict = {
            "storm": v1["storm"],
            "fanout_ms": v1["fanout_ms"],
            "subscribers": v1["subscribers"],
            "frames_total": v1["frames_total"],
            "events_total": v1["events_total"],
            "coalesce_ratio": v1["coalesce_ratio"],
            "relists": v1["relists"],
            "throttled": v1["throttled"],
            "checks": checks,
            "pass": all(checks.values()),
            # the port's additions: the rest of the gate's counters of
            # both runs, which the port's tests and chip_smoke hold to
            # the reference's record
            "port_facts": {k: [v[k] for v in (v1, v2)] for k in STORM_FACTS},
        }
        if args.json:
            print(json.dumps(verdict, indent=1))
        else:
            _print_summary(v1["storm"], False)
            print(f"subscribers={v1['subscribers']} "
                  f"converged={v1['converged']} "
                  f"frames={v1['frames_total']} "
                  f"events={v1['events_total']} "
                  f"(x{v1['coalesce_ratio']} coalesced) "
                  f"dropped={v1['frames_dropped']} "
                  f"gaps={v1['gaps_detected']} relists={v1['relists']}")
            f = v1["fanout_ms"]
            print(f"fan-out ms: p50={f['p50']} p95={f['p95']} "
                  f"p99={f['p99']} (n={f['count']})")
            print(f"throttled: {v1['throttled']}")
            for name, ok in checks.items():
                print(f"  {name}: {'ok' if ok else 'FAIL'}")
            print(f"storm-smoke: {'PASS' if verdict['pass'] else 'FAIL'}")
        return 0 if verdict["pass"] else 1

    if args.verb == "federation":
        from ..metrics import metrics as _metrics
        from ..replication.gate import run_federation

        def one_run():
            _metrics.reset()
            return run_federation(
                seed=args.seed, ticks=args.ticks, nodes=args.nodes,
                subscribers=args.subscribers, shards=args.shards,
                drop_rate=args.drop_rate, followers=args.followers,
                device=args.device)

        v1 = one_run()
        v2 = one_run()
        checks = {
            # the engine's invariant catalog stayed clean in both runs
            "no_violations": v1["violations"] == 0
                             and v2["violations"] == 0,
            # every cursor — including every handed-off one — reached
            # the final leader rv on whichever replica now serves it
            "all_converged": v1["converged"] == v1["subscribers"]
                             and v2["converged"] == v2["subscribers"],
            "zero_gaps": v1["gaps_unrecovered"] == 0
                         and v2["gaps_unrecovered"] == 0,
            # a replica died mid-storm and its cursors moved to peers
            "replica_killed": len(v1["dead"]) >= 1,
            "cursors_handed_off": v1["cursor_handoffs"] >= 1
                                  and v1["handed_off_clients"] >= 1,
            # the deposed leader's stale-epoch frame was fenced
            "stale_leader_fenced": v1["fenced_frames"] >= 1
                                   and v2["fenced_frames"] >= 1,
            # the forced journal gap took the snapshot-bootstrap path
            "snapshot_bootstrap_taken": v1["snapshot_bootstraps"] >= 1,
            # every settled mirror fingerprints identical to the leader
            # (the PR-5 anti-entropy machinery pointed across replicas)
            "mirrors_identical": v1["audit_verdict"] == "identical"
                                 and v2["audit_verdict"] == "identical",
            # client-side faults provably fired and recovered
            "faults_fired": v1["frames_dropped"] > 0
                            and v1["gaps_detected"] > 0,
            "coalesced_delivery": v1["coalesce_ratio"] >= 5.0,
            # the storm gate's determinism contract: decision outputs
            # bit-identical (rv COUNTS may differ — async status
            # writers commit a timing-dependent number of no-decision
            # updates; rv ORDER per commit order is gated by
            # tests/test_torch_replication.py's double-run identity test)
            "deterministic_replay":
                v1["bind_fingerprint"] == v2["bind_fingerprint"]
                and v1["ledger_fingerprint"] == v2["ledger_fingerprint"]
                and v1["watch_drops"] == v2["watch_drops"]
                and v1["cursor_handoffs"] == v2["cursor_handoffs"],
        }
        verdict = {
            "federation": v1["storm"],
            "epoch": v1["epoch"],
            "replicas": v1["replicas"],
            "dead": v1["dead"],
            "subscribers": v1["subscribers"],
            "converged": v1["converged"],
            "cursor_handoffs": v1["cursor_handoffs"],
            "fenced_frames": v1["fenced_frames"],
            "snapshot_bootstraps": v1["snapshot_bootstraps"],
            "catchup_relists": v1["catchup_relists"],
            "follower_lag_rvs": v1["follower_lag_rvs"],
            "audit_verdict": v1["audit_verdict"],
            "coalesce_ratio": v1["coalesce_ratio"],
            "relists": v1["relists"],
            "fanout_ms": v1["fanout_ms"],
            "checks": checks,
            "pass": all(checks.values()),
            # the port's additions: the rest of the gate's counters and
            # fingerprints of both runs, which the port's tests and
            # chip_smoke hold to the reference's record
            "port_facts": {k: [v[k] for v in (v1, v2)]
                           for k in FEDERATION_FACTS},
        }
        if args.json:
            print(json.dumps(verdict, indent=1))
        else:
            _print_summary(v1["storm"], False)
            print(f"replicas={v1['replicas']} dead={v1['dead']} "
                  f"epoch={v1['epoch']} "
                  f"subscribers={v1['subscribers']} "
                  f"converged={v1['converged']} "
                  f"handoffs={v1['cursor_handoffs']} "
                  f"fenced={v1['fenced_frames']} "
                  f"bootstraps={v1['snapshot_bootstraps']}")
            print(f"audit: {v1['audit_verdict']} "
                  f"(divergent: {v1['audit_divergent']}) "
                  f"lag: {v1['follower_lag_rvs']}")
            for name, ok in checks.items():
                print(f"  {name}: {'ok' if ok else 'FAIL'}")
            print(f"federation-smoke: "
                  f"{'PASS' if verdict['pass'] else 'FAIL'}")
        return 0 if verdict["pass"] else 1

    if args.verb == "replay":
        from .replay import load_bundle, replay_bundle
        bundle = load_bundle(args.bundle)
        result = replay_bundle(args.bundle, use_trace=args.use_trace,
                               ticks=args.ticks, device=args.device)
        summary = result.summary()
        summary["original_violations"] = bundle["violations"]
        summary["reproduced"] = bool(result.violations)
        _print_summary(summary, args.json)
        if not args.json:
            print(f"violation reproduced: {summary['reproduced']}")
        # same convention as `run`: nonzero when the replay violates —
        # so `sim.cli replay --bundle d && echo fixed` means what it says
        # in a bisect script
        return 1 if result.violations else 0

    raise ValueError(f"unknown sim verb {args.verb!r}")


def _durability(args) -> int:
    """The durability gate, twice (host-only: apiserver children)."""
    from .durability import durability_checks, run_durability

    def one_dur_run():
        return run_durability(seed=args.seed, pods=args.pods,
                              nodes=args.nodes,
                              watchdog_s=args.watchdog)

    v1 = one_dur_run()
    v2 = one_dur_run()
    checks = durability_checks(v1, v2)
    verdict = dict(v1, checks=checks, pass_=all(checks.values()))
    verdict["pass"] = verdict.pop("pass_")
    if args.json:
        print(json.dumps(verdict, indent=1))
    else:
        eps = v1.get("episodes", [])
        print(f"crash episodes: "
              + " ".join(f"{e['label']}(nth={e.get('nth')},"
                         f"repairs={e.get('writer_repairs')})"
                         for e in eps))
        print(f"fingerprints: bind={v1.get('bind_fingerprint')} "
              f"ledger={v1.get('ledger_fingerprint')} "
              f"elapsed={v1.get('elapsed_s')}s"
              f"+{v2.get('elapsed_s')}s")
        for name, ok in checks.items():
            print(f"  {name}: {'ok' if ok else 'FAIL'}")
        print(f"durability-smoke: "
              f"{'PASS' if verdict['pass'] else 'FAIL'}")
    return 0 if verdict["pass"] else 1


def federation_procs_checks(v1: dict, v2: dict) -> dict:
    """The process-mode federation gate's pass/fail map over a double
    run (bit-identity across runs is itself one of the checks)."""
    return {
        "replicas_ready": v1.get("replicas_ready", False)
                          and v2.get("replicas_ready", False),
        "watchdog_quiet": not v1["watchdog_fired"]
                          and not v2["watchdog_fired"],
        # two elector-driven takeovers: the partitioned leader
        # deposed (token 2), then the SIGKILLed leader replaced
        # (token 3) — the harness never calls advance_epoch
        "elector_takeovers": v1.get("takeovers") == 2
                             and v2.get("takeovers") == 2,
        "deposed_leader_demoted":
            v1.get("deposed_leader_demoted", False),
        # >=1 write under the deposed regime's fence token rejected
        "fenced_deposed_write":
            v1.get("fenced_deposed_writes", 0) >= 1
            and v2.get("fenced_deposed_writes", 0) >= 1,
        # no-leader window: structured 503 + Retry-After, reads
        # still annotated with the staleness bound
        "degraded_fail_fast": v1.get("degraded_503", False)
                              and v1.get("degraded_retry_after")
                              is not None,
        "staleness_annotated": v1.get("staleness_annotated",
                                      False),
        "supervisor_restarted":
            v1.get("supervisor_restarts", 0) >= 1
            and v1.get("restarted_ready", False),
        # the SIGKILLed replica came back through local WAL replay
        # (--data-dir on every replica; docs/design/durability.md)
        "restarted_recovered_wal":
            v1.get("restarted_recovered_wal", False)
            and v2.get("restarted_recovered_wal", False),
        # every watch client's chain converged on a live replica
        # with zero duplicated frames; every acked write survives
        # the takeovers (post-replay diff empty)
        "all_converged": v1.get("unconverged", 1) == 0
                         and v2.get("unconverged", 1) == 0,
        "zero_lost_events": v1.get("lost_events", 1) == 0
                            and v2.get("lost_events", 1) == 0,
        "clients_failed_over": v1.get("client_failovers", 0) > 0
                               and v2.get("client_failovers",
                                          0) > 0,
        # every proxy fault class provably fired
        "faults_fired": all(
            v1.get("faults_total", {}).get(k, 0) > 0
            for k in ("reset", "stall", "truncate",
                      "lease_blocked")),
        # cross-replica audit: every mirror bit-identical at the
        # leader's rvs
        "audit_identical": v1.get("audit_identical", False)
                           and v2.get("audit_identical", False),
        # double run bit-identical on the CONTENT fingerprints
        "deterministic_replay":
            v1.get("bind_fingerprint")
            == v2.get("bind_fingerprint")
            and v1.get("ledger_fingerprint")
            == v2.get("ledger_fingerprint"),
    }


def _federation_procs(args) -> int:
    """The process-mode federation gate, twice (host-only: apiserver
    children behind the chaos proxies)."""
    from ..replication.chaos import run_federation_procs

    def one_proc_run():
        return run_federation_procs(
            seed=args.seed, subscribers=args.subscribers,
            pods=args.pods, watchdog_s=args.watchdog)

    v1 = one_proc_run()
    v2 = one_proc_run()
    checks = federation_procs_checks(v1, v2)
    verdict = dict(v1, checks=checks, pass_=all(checks.values()))
    verdict["pass"] = verdict.pop("pass_")
    if args.json:
        print(json.dumps(verdict, indent=1))
    else:
        print(f"procs={v1['procs']} epoch={v1.get('final_epoch')} "
              f"takeovers={v1.get('takeovers')} "
              f"fenced={v1.get('fenced_deposed_writes')} "
              f"restarts={v1.get('supervisor_restarts')} "
              f"subscribers={v1.get('subscribers')} "
              f"converged={v1.get('converged')} "
              f"client_failovers={v1.get('client_failovers')} "
              f"lost={v1.get('lost_events')}")
        print(f"faults: {v1.get('faults_total')} "
              f"rv={v1.get('final_rv')} "
              f"elapsed={v1.get('elapsed_s')}s"
              f"+{v2.get('elapsed_s')}s")
        for name, ok in checks.items():
            print(f"  {name}: {'ok' if ok else 'FAIL'}")
        print(f"federation-proc-smoke: "
              f"{'PASS' if verdict['pass'] else 'FAIL'}")
    return 0 if verdict["pass"] else 1


def main(argv: Optional[List[str]] = None) -> int:
    """``argv``: a verb and its options, e.g. ``["smoke", "--device",
    "cpu"]`` (default: the command line)."""
    parser = argparse.ArgumentParser(
        prog="python -m volcano_tpu_torch.sim.cli",
        description="cluster churn simulator")
    sub = parser.add_subparsers(dest="group", required=True)
    add_sim_parser(sub)
    args, extra = parser.parse_known_args(
        ["sim"] + list(argv if argv is not None else sys.argv[1:]))
    if extra and args.verb not in WAITING:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return dispatch_sim(args)


if __name__ == "__main__":
    sys.exit(main())
