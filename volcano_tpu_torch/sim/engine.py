"""Discrete-event cluster churn simulator driving the REAL scheduler (the
port's own copy of volcano_tpu/sim/engine.py).

No mocks anywhere on the decision path: the engine builds an
``ObjectStore`` on a virtual clock, a production ``SchedulerCache`` (live
executors, write-behind applies, snapshot prebuild) and a ``Scheduler``
over the real conf/plugins/actions on ``SimConfig.device`` (the card by
default, where every placing tick launches the gang-allocate kernel),
then interleaves event application (job arrivals, pod lifecycle, node
churn, fault injection) with ``scheduler.run_once()`` ticks. The only
fakes are at the cluster edge — the recording (optionally flaky)
binder/evictor that production tests already use — which is exactly
where the reference's kubelet would sit.

Determinism contract: all randomness lives in the seeded event
generators (workload/faults) and the seeded :class:`FlakyBinder`; the
engine itself never consults an RNG, the cache executor is one FIFO
worker flushed every tick, and the event queue breaks timestamp ties by
insertion order. Two runs with the same config in one process produce
bit-identical bind sequences (:meth:`SimResult.bind_fingerprint`); across
processes additionally pin ``PYTHONHASHSEED`` (set-iteration order is
the one hash-dependent surface). The same config gives the same three
fingerprints on the card as on the CPU, and as the reference's
simulator.

On an invariant violation the engine dumps a replayable repro bundle —
``{seed, tick}``, the full applied-event stream as JSONL, and the
offending cycle's flight-recorder trace (``trace/``) — via
:mod:`.replay`.
"""

from __future__ import annotations

import hashlib
import logging
import time
import zlib
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

from ..apiserver.store import ObjectStore
from ..cache import SchedulerCache
from ..scheduler import Scheduler
from ..utils.clock import FakeClock
from ..utils.test_utils import (FakeEvictor, build_node, build_pod,
                                build_pod_group, build_queue)
from .events import Event, EventQueue, make_event
from .faults import (FaultConfig, FlakyBinder, apply_evict_storm,
                     synthesize_evict_storms, synthesize_node_churn)
from .invariants import (CycleContext, Violation, allocated_task_count,
                         check_all, queues_over_capability)
from .workload import (WorkloadConfig, load_trace, resident_backlog,
                       synthesize_arrivals)

log = logging.getLogger(__name__)

DEFAULT_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""


@dataclass
class SimConfig:
    seed: int = 0
    ticks: int = 100
    tick_s: float = 1.0                   # virtual seconds per tick
    n_nodes: int = 64
    node_cpu: str = "64"
    node_mem: str = "256Gi"
    node_pods: str = "110"
    # (name, weight, capability resource-list or None)
    queues: List[tuple] = field(
        default_factory=lambda: [("default", 1, None)])
    # topology labels for the placement constraints
    # (docs/design/constraints.md): >0 stamps every node with
    # topology.kubernetes.io/zone = zone-<idx % node_zones> (derived from
    # the node NAME, so a killed node re-adds into its old zone and
    # replays stay deterministic)
    node_zones: int = 0
    # PriorityClass objects created at base setup: [(name, value)] —
    # preemption storms need real priority tiers, which the arrival
    # events reference by class name
    priority_classes: List[tuple] = field(default_factory=list)
    conf_text: str = DEFAULT_CONF
    resident_jobs: int = 0                # t=0 backlog gangs
    resident_gang: int = 8
    resident_min: int = 0                 # 0 = full gang; lower = elastic
    workload: WorkloadConfig = field(default_factory=WorkloadConfig)
    faults: FaultConfig = field(default_factory=FaultConfig)
    # fraction of jobs whose gang loses a pod mid-run (lifecycle "fail")
    fail_rate: float = 0.0
    # gang-atomicity convergence window (invariants.py): audited ticks a
    # gang may sit partially bound before violating. Bind failures heal
    # within their own flush, so this is slack for multi-tick cascades
    # (a heal racing a storm), not a waiver. Failover scenarios widen it
    # to cover the leaderless window of a lease handover: a gang left
    # partial by a mid-flush crash cannot converge before a standby wins
    # the lease and schedules again.
    gang_converge_ticks: int = 2
    trace_path: Optional[str] = None      # replay this JSONL instead of
    #                                       synthesizing workload/faults
    check_invariants: bool = True
    stop_on_violation: bool = True
    repro_dir: Optional[str] = None       # where violation bundles land
    flush_timeout_s: float = 120.0
    # control-plane failover (docs/design/failover.md): run the scheduler
    # under leader election on the virtual clock (lease fencing on every
    # bind/patch write), with scheduler_kill / leader_lapse control
    # events driving crash/restart and handover
    elections: bool = False
    lease_s: float = 5.0
    # cache<->store anti-entropy cadence in ticks (0 = off). The default
    # rides along every run so bench --sim measures steady state WITH
    # the reconciler on; failover scenarios drop it to 1 so a dropped
    # watch delivery is repaired before the same tick's invariant audit.
    anti_entropy_every_ticks: int = 10
    # extra scheduled events injected verbatim (the failover scenario's
    # scripted kills/lapses ride the same replayable stream as arrivals)
    control_events: List[dict] = field(default_factory=list)
    # incremental steady-state cycle (docs/design/incremental_cycle.md):
    # run the scheduler on the persistent patched snapshot instead of a
    # full rebuild per tick. Off by default so the legacy smoke gates
    # keep their exact historical path; the `incr` verb runs the same
    # churn twice — incremental vs forced-full — and requires
    # bit-identical bind + ledger fingerprints.
    incremental: bool = False
    # the scheduler's device: None is the card (cuda:0), "cpu" runs the
    # kernels' plain versions
    device: Optional[str] = None

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        d = dict(d)
        d["workload"] = WorkloadConfig(**d.get("workload", {}))
        d["faults"] = FaultConfig(**d.get("faults", {}))
        d["queues"] = [tuple(q) for q in d.get("queues", [])]
        return cls(**d)


@dataclass
class TickStats:
    tick: int
    vtime: float
    cycle_ms: float
    events: int
    new_binds: int
    pods: int
    nodes: int
    violations: int
    # wall ms of the tick's executor flush (the write-behind commit of
    # the cycle's binds, evictions and statuses) and of its invariant
    # audit; neither enters a fingerprint
    flush_ms: float = 0.0
    audit_ms: float = 0.0


class SimResult:
    def __init__(self):
        self.bind_sequence: List[Tuple[str, str]] = []   # (pod key, node)
        self.evict_sequence: List[str] = []              # pod keys, in order
        self.violations: List[Tuple[int, Violation]] = []  # (tick, v)
        self.ticks: List[TickStats] = []
        self.events_applied: List[Event] = []
        self.repro_paths: List[str] = []
        self.completed_jobs = 0
        self.arrived_jobs = 0
        # resilience counters (read off the cache at end of run):
        # lifetime bind-failure resyncs, and the quarantined pod keys
        self.resync_retries = 0
        self.quarantined: List[str] = []
        # failover counters (docs/design/failover.md): scheduler
        # crash/restarts performed, writes the store rejected for a
        # stale fencing token, objects the anti-entropy pass repaired,
        # watch deliveries dropped/delayed by FlakyWatch, and every
        # why-pending reason observed during the run (the standby window
        # must surface "scheduler not leader", not silence)
        self.restarts = 0
        self.fenced_writes = 0
        self.divergence_repairs = 0
        self.watch_drops = 0
        self.watch_delays = 0
        self.pending_reasons_seen: set = set()
        # pod lifecycle ledger (docs/design/observability.md): stats +
        # orphan audit + deterministic aggregate fingerprint, read off
        # trace/ledger.py at end of run (the obs-smoke gate's surface)
        self.ledger: dict = {}
        # incremental-cycle accounting: snapshot mode per tick
        # ("full"/"incremental"/"legacy") and how many ticks took the
        # quiet fast path — the `incr` gate's evidence that the
        # incremental machinery actually engaged
        self.cycle_modes: Dict[str, int] = {}
        self.quiet_cycles = 0

    def bind_fingerprint(self) -> str:
        h = hashlib.sha256()
        for key, host in self.bind_sequence:
            h.update(f"{key}->{host}\n".encode())
        return h.hexdigest()

    def outcome_fingerprint(self) -> str:
        """Binds AND evictions in one digest — the constraint-smoke
        parity surface (victim selection shows up in WHO got evicted,
        not just in where the preemptors later bind)."""
        h = hashlib.sha256()
        for key, host in self.bind_sequence:
            h.update(f"bind {key}->{host}\n".encode())
        for key in self.evict_sequence:
            h.update(f"evict {key}\n".encode())
        return h.hexdigest()

    def cycle_ms_percentiles(self, skip: int = 0) -> Dict[str, float]:
        """Nearest-rank percentiles over the tick cycle latencies;
        ``skip`` drops leading ticks (bench's steady-state view excludes
        the cold backlog-populate tick)."""
        lat = sorted(t.cycle_ms for t in self.ticks[skip:])
        if not lat:
            return {"p50": 0.0, "p95": 0.0, "max": 0.0}
        at = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
        return {"p50": round(at(0.50), 3), "p95": round(at(0.95), 3),
                "max": round(lat[-1], 3)}

    def summary(self) -> dict:
        return {
            "ticks": len(self.ticks),
            "vtime_s": round(self.ticks[-1].vtime, 3) if self.ticks else 0.0,
            "arrived_jobs": self.arrived_jobs,
            "completed_jobs": self.completed_jobs,
            "binds": len(self.bind_sequence),
            "evictions": len(self.evict_sequence),
            "bind_fingerprint": self.bind_fingerprint(),
            "outcome_fingerprint": self.outcome_fingerprint(),
            "resync_retries": self.resync_retries,
            "quarantined": list(self.quarantined),
            "restarts": self.restarts,
            "cycle_modes": dict(self.cycle_modes),
            "quiet_cycles": self.quiet_cycles,
            "fenced_writes": self.fenced_writes,
            "divergence_repairs": self.divergence_repairs,
            "watch_drops": self.watch_drops,
            "pending_reasons_seen": sorted(self.pending_reasons_seen),
            "ledger": dict(self.ledger),
            "cycle_ms": self.cycle_ms_percentiles(),
            "violations": [
                {"tick": t, "invariant": v.invariant, "detail": v.detail}
                for t, v in self.violations],
            "repro_bundles": list(self.repro_paths),
        }


class SimEngine:
    """One simulator run. Build, call :meth:`run`, read :attr:`result`."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.clock = FakeClock(start=1.0)   # nonzero: creation_timestamp
        #                                     falsiness means "unset"
        self.store = ObjectStore(clock=self.clock)
        # seeded from faults.seed like every other injector (churn
        # schedules, storms) — varying the fault seed must vary the
        # bind-failure coin sequence too
        self.binder = FlakyBinder(self.store, self.clock,
                                  fail_rate=cfg.faults.bind_fail_rate,
                                  latency_s=cfg.faults.api_latency_s,
                                  seed=cfg.faults.seed,
                                  fail_pods=cfg.faults.fail_pods)
        self.evictor = FakeEvictor(self.store)
        # failover state (docs/design/failover.md): the scheduler's
        # current elector incarnation, the deposed incarnation's token
        # awaiting its fence probe, a pending restart request from a
        # kill/lapse event, and accumulators that survive cache/store
        # swaps
        self.elector = None
        self._elector_seq = 0
        self._probe_token: Optional[int] = None
        self._pending_restart: Optional[dict] = None
        self._resync_base = 0
        self._fenced_base = 0
        self._flaky_watch = None
        self._bind_ledger: Dict[str, str] = {}
        if cfg.elections:
            self.elector = self._make_elector()
        self.cache: SchedulerCache = None
        self.scheduler: Scheduler = None
        self._build_scheduler()
        self.queue = EventQueue()
        self.result = SimResult()
        # job key -> its arrival event (duration/outcome live there)
        self._job_specs: Dict[str, Event] = {}
        self._dirty_jobs: set = set()
        self._ever_ready: set = set()
        self._completed_scheduled: set = set()
        # node name -> (cpu, mem, pods) for kill/re-add cycles
        self._node_catalog: Dict[str, tuple] = {}
        self._bind_cursor = 0
        self._evict_cursor = 0
        # per-tick observer hooks, called at the tick barrier (after the
        # flush + kubelet step, before the next tick's clock advance)
        # with the tick index. Observers only: the watcher-storm gate
        # (serving/storm.py) pumps its hub fan-out here — hooks must not
        # mutate scheduler/cache/store state or determinism breaks.
        self.tick_hooks: List = []
        # gang-atomicity convergence streaks (invariants.py): persists
        # across per-tick CycleContexts
        self._partial_streaks: Dict[str, int] = {}

    # -- control-plane lifecycle (docs/design/failover.md) -----------------

    def _make_elector(self, identity: Optional[str] = None):
        """A fresh elector INCARNATION (its first acquisition always
        bumps the fencing token, even when re-taking its own lease —
        restarted processes must fence their previous selves).
        Deterministic identities: sched-<seq>."""
        from ..utils.leaderelection import LeaderElector
        if identity is None:
            identity = f"sched-{self._elector_seq}"
            self._elector_seq += 1
        return LeaderElector(self.store, identity, lease_name="vc-sim",
                             lease_duration=self.cfg.lease_s,
                             clock=self.clock)

    def _build_scheduler(self) -> None:
        """(Re)build the scheduler half of the control plane against the
        current store — the stateless-restart shape: a brand-new cache
        rebuilds from watches, retry/quarantine state is deliberately
        NOT carried over (docs/design/resilience.md), and bind writes
        are fenced with the current elector incarnation's token."""
        elector = self.elector
        fence_source = (lambda: elector.fencing_token) \
            if elector is not None else None
        self.cache = SchedulerCache(self.store, binder=self.binder,
                                    evictor=self.evictor,
                                    fence_source=fence_source)
        self.scheduler = Scheduler(self.store,
                                   scheduler_conf=self.cfg.conf_text,
                                   cache=self.cache, clock=self.clock,
                                   elector=elector, anti_entropy_every=0,
                                   incremental=self.cfg.incremental,
                                   device=self.cfg.device)

    def _install_watch_faults(self) -> None:
        f = self.cfg.faults
        if f.watch_drop_rate <= 0 and f.watch_delay_rate <= 0:
            return
        if self._flaky_watch is None:
            from .faults import FlakyWatch
            self._flaky_watch = FlakyWatch(seed=f.seed,
                                           drop_rate=f.watch_drop_rate,
                                           delay_rate=f.watch_delay_rate,
                                           coin=f.watch_coin)
        for w in self.cache._watches:
            if w.kind == "pods":
                self._flaky_watch.wrap(w)
                return

    def _election_step(self) -> None:
        if self.elector is None:
            return
        was_leader = self.elector.is_leader
        self.elector.step()
        if self.elector.is_leader and not was_leader and \
                self._probe_token is not None:
            self._probe_deposed_write(self._probe_token)
            self._probe_token = None

    def _probe_deposed_write(self, token: int) -> None:
        """Replay the deposed incarnation's leftover in-flight write the
        instant a new incarnation takes over: a no-op pod patch stamped
        with the OLD token. The store must reject it (FencedError — the
        whole point of lease fencing); if it ever lands, the fenced-write
        counter stays flat and the failover gate fails loudly."""
        from ..apiserver.store import FencedError
        keys = sorted(p.metadata.key() for p in self.store.list_refs("pods"))
        if not keys:
            return
        ns, name = keys[0].split("/", 1)

        def noop(p):
            pass

        try:
            self.store.patch_batch("pods", [(name, ns, noop)], fence=token)
            log.error("deposed-leader probe write with stale token %d was "
                      "NOT fenced", token)
        except FencedError:
            pass   # store.fenced_writes counted it

    def _restart_scheduler(self) -> None:
        """Kill + restart the scheduler at the tick barrier: the old
        cache (with whatever it believed about in-flight binds) is
        discarded exactly as a process death would, and a fresh one
        rebuilds from the surviving store — or, in snapshot mode, from a
        persistence.save_store checkpoint restored into a fresh store
        (the etcd-restore drill). The restarted incarnation's first
        acquisition bumps the fencing token, shutting the old
        incarnation out of the store."""
        info, self._pending_restart = self._pending_restart, None
        self.binder.crashed = False
        self.binder.crash_after_binds = None
        self.result.restarts += 1
        self._resync_base += self.cache.resync_retry_total
        self.scheduler.stop()
        if self._flaky_watch is not None:
            self._flaky_watch.unwrap()
        self.cache.stop()
        old_token = self.elector.fencing_token \
            if self.elector is not None else None
        if info.get("mode") == "snapshot":
            self._swap_store_from_snapshot()
        if self.elector is not None:
            self._probe_token = old_token
            if info.get("handover"):
                # the lease was never released: a NEW candidate identity
                # must wait out the old lease before leading (the
                # standby window run_once reports on /debug/pending)
                self.elector = self._make_elector()
            else:
                # same identity, new incarnation: re-acquires its own
                # lease immediately, with a bumped token
                self.elector = self._make_elector(self.elector.identity)
        self._build_scheduler()
        self.cache.run()
        self._install_watch_faults()
        log.warning("scheduler restarted (mode=%s, handover=%s)",
                    info.get("mode", "stateless"),
                    bool(info.get("handover")))

    def _swap_store_from_snapshot(self) -> None:
        import os
        import tempfile

        from ..apiserver.persistence import load_store, save_store
        fd, path = tempfile.mkstemp(prefix="sim-failover-", suffix=".json")
        os.close(fd)
        try:
            save_store(self.store, path)
            new_store = ObjectStore(clock=self.clock)
            load_store(path, store=new_store)
        finally:
            os.unlink(path)
        # the fence floor is in-memory state: it re-derives from the
        # lease's persisted token at the next acquisition, but carrying
        # it across the swap closes the window in between
        new_store.advance_fence(self.store.fence_floor())
        self._fenced_base += self.store.fenced_writes
        self.store = new_store
        self.binder.store = new_store
        self.evictor.store = new_store

    # -- setup -------------------------------------------------------------

    def _seed_events(self) -> None:
        cfg = self.cfg
        if cfg.trace_path:
            events = load_trace(cfg.trace_path)
        else:
            horizon = cfg.ticks * cfg.tick_s
            events = []
            events += resident_backlog(cfg.resident_jobs, cfg.resident_gang,
                                       queue=cfg.queues[0][0],
                                       min_available=cfg.resident_min)
            events += synthesize_arrivals(cfg.workload)
            node_names = [f"node-{i}" for i in range(cfg.n_nodes)]
            events += synthesize_node_churn(cfg.faults, node_names, horizon)
            events += synthesize_evict_storms(cfg.faults, horizon)
        for spec in cfg.control_events:
            events.append(Event(spec))
        for e in events:
            self.queue.push(e)

    def _create_base(self) -> None:
        cfg = self.cfg
        for name, weight, capability in cfg.queues:
            self.store.create("queues", build_queue(
                name, weight=weight, capability=capability))
        for name, value in cfg.priority_classes:
            from ..models.objects import ObjectMeta, PriorityClass
            self.store.create("priorityclasses", PriorityClass(
                metadata=ObjectMeta(name=name), value=int(value)))
        for i in range(cfg.n_nodes):
            self._add_node(f"node-{i}", cfg.node_cpu, cfg.node_mem,
                           cfg.node_pods)
        self.cache.run()

    def _node_labels(self, name: str) -> Dict[str, str]:
        """Deterministic topology labels from the node NAME (zone
        membership must survive kill/re-add cycles and trace replays)."""
        if self.cfg.node_zones <= 0:
            return {}
        try:
            idx = int(name.rsplit("-", 1)[1])
        except (IndexError, ValueError):
            idx = sum(name.encode()) % max(1, self.cfg.node_zones)
        from .workload import ZONE_KEY
        return {ZONE_KEY: f"zone-{idx % self.cfg.node_zones}"}

    def _add_node(self, name: str, cpu: str, mem: str, pods: str) -> None:
        self._node_catalog[name] = (cpu, mem, pods)
        self.store.create("nodes", build_node(
            name, {"cpu": cpu, "memory": mem, "pods": pods},
            labels=self._node_labels(name)))

    # -- event application -------------------------------------------------

    def _apply(self, e: Event) -> None:
        self.result.events_applied.append(e)
        kind = e.kind
        fn = getattr(self, f"_ev_{kind}", None)
        if fn is None:
            raise ValueError(f"unknown sim event kind {kind!r}")
        fn(e)

    def _ev_job_arrival(self, e: Event) -> None:
        ns, name = e["namespace"], e["name"]
        self.result.arrived_jobs += 1
        self._job_specs[f"{ns}/{name}"] = e
        self.store.create("podgroups", build_pod_group(
            name, ns, e["queue"], int(e["min_available"]), phase="Inqueue",
            priority_class=e.get("priority_class", "")))
        for t in range(int(e["size"])):
            pod = build_pod(
                ns, f"{name}-{t}", "", "Pending",
                {"cpu": e["cpu"], "memory": e["mem"]}, groupname=name,
                labels={"sim-job": name} if e.get("anti_key") else None)
            self._apply_constraints(pod, e)
            self.store.create("pods", pod)

    @staticmethod
    def _apply_constraints(pod, e: Event) -> None:
        """Materialize the arrival event's optional placement-constraint
        fields onto the pod spec (docs/design/constraints.md)."""
        if e.get("spread_key"):
            from ..models.objects import TopologySpreadConstraint
            pod.spec.topology_spread = [TopologySpreadConstraint(
                max_skew=int(e.get("spread_skew", 1)),
                topology_key=e["spread_key"],
                when_unsatisfiable=("DoNotSchedule"
                                    if e.get("spread_mode", "hard") == "hard"
                                    else "ScheduleAnyway"))]
        if e.get("anti_key"):
            from ..models.objects import (Affinity, NodeSelectorRequirement,
                                          PodAffinity, PodAffinityTerm)
            pod.spec.affinity = Affinity(pod_anti_affinity=PodAffinity(
                required=[PodAffinityTerm(
                    label_selector=[NodeSelectorRequirement(
                        key="sim-job", operator="In",
                        values=[e["name"]])],
                    topology_key=e["anti_key"])]))

    def _ev_job_complete(self, e: Event) -> None:
        ns, name = e["namespace"], e["name"]
        spec = self._job_specs.get(f"{ns}/{name}")
        size = int(spec["size"]) if spec is not None else 0
        for t in range(size):
            try:
                self.store.delete("pods", f"{name}-{t}", ns,
                                  )
            except KeyError:
                pass
        try:
            self.store.delete("podgroups", name, ns)
            self.result.completed_jobs += 1
        except KeyError:
            pass

    def _ev_pod_fail(self, e: Event) -> None:
        ns, name, task = e["namespace"], e["name"], int(e["task"])
        self._dirty_jobs.add(f"{ns}/{name}")
        try:
            self.store.delete("pods", f"{name}-{task}", ns,
                              )
        except KeyError:
            pass

    def _ev_node_add(self, e: Event) -> None:
        name = e["name"]
        if self.store.get("nodes", name) is not None:
            return
        cpu, mem, pods = self._node_catalog.get(
            name, (self.cfg.node_cpu, self.cfg.node_mem, self.cfg.node_pods))
        cpu = e.get("cpu", cpu)
        mem = e.get("mem", mem)
        pods = e.get("pods", pods)
        self._add_node(name, cpu, mem, pods)

    def _ev_node_drain(self, e: Event) -> None:
        node = self.store.get("nodes", e["name"])
        if node is None:
            return
        node.spec.unschedulable = True
        self.store.update("nodes", node)

    def _ev_node_undrain(self, e: Event) -> None:
        node = self.store.get("nodes", e["name"])
        if node is None:
            return
        node.spec.unschedulable = False
        self.store.update("nodes", node)

    def _ev_node_kill(self, e: Event) -> None:
        name = e["name"]
        if self.store.get("nodes", name) is None:
            return
        # resident pods die with the node (lost VM) — keeping them would
        # manufacture orphaned bindings the checker rightly flags
        for p in self.store.list_refs("pods"):
            if p.spec.node_name == name:
                self._dirty_jobs.add(
                    f"{p.metadata.namespace}/"
                    f"{self._job_of_pod(p.metadata.name)}")
                try:
                    self.store.delete("pods", p.metadata.name,
                                      p.metadata.namespace,
                                      )
                except KeyError:
                    pass
        self.store.delete("nodes", name)

    def _ev_evict_storm(self, e: Event) -> None:
        for key in apply_evict_storm(self.store, e):
            ns, pod_name = key.split("/", 1)
            self._dirty_jobs.add(f"{ns}/{self._job_of_pod(pod_name)}")

    def _ev_fault_set(self, e: Event) -> None:
        if "bind_fail_rate" in e:
            self.binder.fail_rate = float(e["bind_fail_rate"])
        if "api_latency_s" in e:
            self.binder.latency_s = float(e["api_latency_s"])
        if "fail_pods" in e:
            self.binder.fail_pods = set(e["fail_pods"])

    def _ev_scheduler_kill(self, e: Event) -> None:
        """Crash the scheduler this tick: with ``mid_flush_binds`` the
        binder dies partway through the tick's bind flush (the store
        keeps the committed prefix — partial gangs included); the
        restart itself runs at the tick barrier, ``mode`` choosing
        stateless (rebuild from the surviving store) or snapshot
        (save_store -> fresh store -> restore). Same identity re-leads
        immediately with a bumped fencing token."""
        if "mid_flush_binds" in e:
            self.binder.crash_after_binds = int(e["mid_flush_binds"])
        self._pending_restart = {"mode": e.get("mode", "stateless"),
                                 "handover": False}

    def _ev_leader_lapse(self, e: Event) -> None:
        """The leader process dies WITHOUT releasing its lease (crash,
        zombie GC pause): its final flush can die midway like a kill,
        but the replacement runs as a fresh candidate identity that must
        wait out the lease — the standby window — and the deposed
        incarnation's leftover write is probed against the fence at
        takeover. Requires elections; degrades to a plain kill without
        them."""
        if "mid_flush_binds" in e:
            self.binder.crash_after_binds = int(e["mid_flush_binds"])
        self._pending_restart = {"mode": e.get("mode", "stateless"),
                                 "handover": self.elector is not None}

    @staticmethod
    def _job_of_pod(pod_name: str) -> str:
        # pod names are "<job>-<index>" by construction
        return pod_name.rsplit("-", 1)[0]

    # -- kubelet + lifecycle -----------------------------------------------

    def _kubelet_step(self) -> None:
        """Bound Pending pods become Running; a fully-bound gang gets its
        completion (and optional mid-run pod failure) scheduled once, at
        bind time + its arrival-drawn duration."""
        now = self.clock.now()
        # scan live refs (no clone), re-fetch only the few pods actually
        # transitioning — newly-bound pods per tick, not the whole cluster
        for ref in self.store.list_refs("pods"):
            if ref.spec.node_name and ref.status.phase == "Pending":
                p = self.store.get("pods", ref.metadata.name,
                                   ref.metadata.namespace)
                if p is None or not p.spec.node_name:
                    continue
                p.status.phase = "Running"
                self.store.update("pods", p)
        for jkey, job in list(self.cache.jobs.items()):
            if job.pod_group is None or jkey in self._completed_scheduled:
                continue
            spec = self._job_specs.get(jkey)
            if spec is None:
                continue
            if allocated_task_count(job) < int(spec["min_available"]):
                continue
            self._ever_ready.add(jkey)
            self._completed_scheduled.add(jkey)
            duration = float(spec.get("duration", 60.0))
            ns, name = jkey.split("/", 1)
            # deterministic per-job outcome: crc32 keeps it independent of
            # PYTHONHASHSEED (hash() of str is per-process randomized)
            fails = self.cfg.fail_rate > 0 and (
                (zlib.crc32(jkey.encode()) ^ self.cfg.seed) % 10_000
                < self.cfg.fail_rate * 10_000)
            if fails:
                self.queue.push(make_event(
                    now + duration * 0.3, "pod_fail", namespace=ns,
                    name=name, task=0))
            self.queue.push(make_event(
                now + duration, "job_complete", namespace=ns, name=name))

    def _collect_binds(self) -> int:
        chan = self.binder.channel
        new = 0
        while self._bind_cursor < len(chan):
            key = chan[self._bind_cursor]
            self._bind_cursor += 1
            self.result.bind_sequence.append((key, self.binder.binds[key]))
            new += 1
        echan = self.evictor.channel
        while self._evict_cursor < len(echan):
            self.result.evict_sequence.append(echan[self._evict_cursor])
            self._evict_cursor += 1
        return new

    # -- main loop ---------------------------------------------------------

    def run(self) -> SimResult:
        from ..metrics import timeseries
        from ..trace import ledger, tracer
        cfg = self.cfg
        trace_was_on = tracer.is_enabled()
        tracer.enable()
        tracer.set_pending_report(None)   # a previous run's report must
        #                                   not leak into reasons_seen
        # the ledger and timeseries ring are module-global: a previous
        # run's aggregates must not leak into this run's fingerprint
        ledger.reset()
        timeseries.reset()
        try:
            self._create_base()
            self._install_watch_faults()
            self._seed_events()
            if self.elector is not None:
                self._election_step()   # first incarnation takes the lease
            for tick in range(cfg.ticks):
                self.clock.advance(cfg.tick_s)
                if self._flaky_watch is not None:
                    self._flaky_watch.release_delayed()
                self._election_step()
                events = self.queue.pop_until(self.clock.now())
                for e in events:
                    self._apply(e)
                queues_over = queues_over_capability(self.cache) \
                    if cfg.check_invariants else set()
                t0 = time.perf_counter()
                self.scheduler.run_once()
                cycle_ms = (time.perf_counter() - t0) * 1000.0
                stats = self.cache.last_snapshot_stats \
                    if self.cache.incremental else None
                mode = stats.get("mode") if stats else "legacy"
                self.result.cycle_modes[mode] = \
                    self.result.cycle_modes.get(mode, 0) + 1
                if stats and stats.get("quiet"):
                    self.result.quiet_cycles += 1
                t0 = time.perf_counter()
                if not self.cache.flush_executors(
                        timeout=cfg.flush_timeout_s):
                    raise RuntimeError(
                        f"tick {tick}: executor flush timed out")
                flush_ms = (time.perf_counter() - t0) * 1000.0
                # charge the tick's accumulated virtual API latency here,
                # on the engine thread, after the flush barrier — see
                # FlakyBinder.take_pending_latency
                self.clock.advance(self.binder.take_pending_latency())
                # NOTE: injected bind failures are deliberately NOT added
                # to dirty_jobs — the commit path heals partial gangs
                # (resilience.md) and the atomicity checker holds it to
                # that, with a small convergence window instead of a
                # waiver
                new_binds = self._collect_binds()
                rep = tracer.pending_report()
                if rep:
                    self.result.pending_reasons_seen.update(
                        (rep.get("reasons") or {}).keys())
                # restart BEFORE the audit: the rebuilt (or restored)
                # control plane is what must satisfy the invariants —
                # including any partial gangs its predecessor's crashed
                # flush left in the store
                if self._pending_restart is not None or \
                        self.binder.crashed:
                    if self._pending_restart is None:
                        self._pending_restart = {"mode": "stateless",
                                                 "handover": False}
                    self._restart_scheduler()
                if cfg.anti_entropy_every_ticks > 0 and \
                        tick % cfg.anti_entropy_every_ticks == 0:
                    ae = self.cache.anti_entropy()
                    self.result.divergence_repairs += ae["repaired"]
                violations: List[Violation] = []
                t0 = time.perf_counter()
                if cfg.check_invariants:
                    ctx = CycleContext(
                        store=self.store, cache=self.cache, tick=tick,
                        dirty_jobs=self._dirty_jobs,
                        ever_ready=self._ever_ready,
                        queues_over_before=queues_over,
                        gang_converge_ticks=cfg.gang_converge_ticks,
                        partial_streaks=self._partial_streaks,
                        bind_ledger=self._bind_ledger)
                    violations = check_all(ctx)
                    # ever_ready updates AFTER the check: a gang must be
                    # complete the first tick it shows up allocated
                    for jkey, job in self.cache.jobs.items():
                        if job.pod_group is not None and \
                                allocated_task_count(job) >= \
                                max(1, job.min_available):
                            self._ever_ready.add(jkey)
                audit_ms = (time.perf_counter() - t0) * 1000.0
                # simulated kubelet runs after the audit: the checkers see
                # the scheduler's output state, not the lifecycle echo
                self._kubelet_step()
                for hook in self.tick_hooks:
                    hook(tick)
                self.result.ticks.append(TickStats(
                    tick=tick, vtime=self.clock.now(), cycle_ms=cycle_ms,
                    events=len(events), new_binds=new_binds,
                    pods=len(self.store.list_refs("pods")),
                    nodes=len(self.store.list_refs("nodes")),
                    violations=len(violations), flush_ms=flush_ms,
                    audit_ms=audit_ms))
                if violations:
                    for v in violations:
                        self.result.violations.append((tick, v))
                        log.error("sim tick %d invariant violation: %s",
                                  tick, v)
                    if cfg.repro_dir:
                        from .replay import write_repro_bundle
                        self.result.repro_paths.append(write_repro_bundle(
                            cfg.repro_dir, self, tick, violations))
                    if cfg.stop_on_violation:
                        break
            self.result.resync_retries = self._resync_base + \
                self.cache.resync_retry_total
            # quarantine/backoff state is stateless-rebuild scoped by
            # design (docs/design/resilience.md): only the CURRENT
            # incarnation's quarantine set is reported
            self.result.quarantined = sorted(self.cache.quarantined)
            self.result.fenced_writes = self._fenced_base + \
                self.store.fenced_writes
            if self._flaky_watch is not None:
                self.result.watch_drops = self._flaky_watch.dropped
                self.result.watch_delays = self._flaky_watch.delayed
            lstats = ledger.stats()
            lstats["orphans"] = ledger.orphans(self.store)
            lstats["fingerprint"] = ledger.fingerprint()
            e2e = ledger.report()["hops"].get("e2e", {})
            lstats["e2e"] = e2e
            self.result.ledger = lstats
            return self.result
        finally:
            if not trace_was_on:
                tracer.disable()
            self.scheduler.stop()
            self.cache.stop()


def run_sim(cfg: SimConfig) -> SimResult:
    return SimEngine(cfg).run()
