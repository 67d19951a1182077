"""Watcher-storm gate runner (the port's own copy of
volcano_tpu/serving/storm.py; ``python -m volcano_tpu_torch.sim.cli
storm``, docs/design/serving.md).

The scenario: the REAL scheduler churns through a seeded workload whose
resident backlog flushes a bind storm in the opening ticks, while the
serving hub fans the journal out to 1k+ subscribers across dozens of
tenants — most filtered to the scheduler's pods (the production watch
shape), some kind-scoped, some unfiltered — with THREE fault layers on:

* seeded FRAME drops between hub and client (the FlakyWatch coin idiom,
  content-keyed crc32 over the frame chain) — the client detects the
  broken frame chain and rewinds;
* a mid-storm ``force_gap`` clearing the journal — every lagging cursor
  must take the structured relist, not silently skip;
* cache-side FlakyWatch drops on the scheduler's own pod watch —
  enabled at storm scale since the fault coin re-keyed from
  resource_version to the commit-order-stable (key, per-key sequence)
  identity (sim/faults.py; the journal's rv interleaving used to
  confine these faults to the failover gate), with anti-entropy
  every tick so each divergence is repaired before that tick's audit.

A noisy tenant hammers the admission edge (writes past its token bucket,
subscriptions past its cap) and must be throttled without starving the
other tenants.

Gate (all checked twice — the double run must be bit-identical on bind
AND ledger fingerprints): every subscriber cursor converges to the final
store rv, zero unrecovered frame-chain gaps, >=1 relist taken, >=1
throttled tenant, coalescing ratio (events per frame) >> 1, and the
engine's own invariant catalog clean on every audited tick.
"""

from __future__ import annotations

import zlib
from typing import List, Optional

from .admission import AdmissionController, TenantPolicy, ThrottledError
from .hub import ServingHub, Subscription

# the bind-storm shape: a large resident gang backlog flushes through
# the opening cycles while Poisson arrivals + node flaps keep churning
STORM_TENANTS = 16
NOISY_TENANT = "noisy"
NOISY_WRITES_PER_TICK = 6
NOISY_WRITE_RATE = 2.0          # tokens per virtual second
NOISY_SUB_CAP = 2


def storm_config(seed: int = 43, ticks: int = 80, nodes: int = 192,
                 resident: int = 192, device=None):
    """The storm gate's churn (``device``: the scheduler's, None for the
    card): a resident backlog big enough that
    the opening flushes are a genuine bind storm (~1.5k binds), Poisson
    arrivals, node flaps and bind failures.

    Cache-side FlakyWatch drops run here too now: the fault coin was
    re-keyed from resource_version to the commit-order-stable (object
    key, per-key delivery sequence) identity (sim/faults.py), so the
    journal's timing-dependent rv interleaving at storm scale, which
    used to confine these faults to the failover gate, can no longer
    flip which deliveries drop. Anti-entropy runs
    every tick so each divergence is detected and repaired before that
    tick's invariant audit, exactly the failover gate's discipline."""
    from ..sim.engine import SimConfig
    from ..sim.faults import FaultConfig
    from ..sim.workload import WorkloadConfig
    return SimConfig(
        seed=seed, ticks=ticks, tick_s=1.0, n_nodes=nodes,
        node_cpu="16", node_mem="32Gi",
        resident_jobs=resident, resident_gang=8,
        workload=WorkloadConfig(
            seed=seed, horizon_s=float(ticks) * 0.7, arrival_rate=0.4,
            duration_min_s=15.0, duration_max_s=60.0),
        faults=FaultConfig(
            seed=seed, bind_fail_rate=0.01, api_latency_s=0.001,
            flap_rate=0.02, flap_down_s=6.0,
            watch_drop_rate=0.02),
        fail_rate=0.02,
        anti_entropy_every_ticks=1,
        repro_dir=".", device=device)


class StormClient:
    """One subscriber session plus the client half of the frame-chain
    contract: seeded frame drops (the fault), gap detection via the
    ``prev`` chain, recovery via ``hub.rewind``, re-anchor on ``relist``
    frames. Event application is counting + rv dedup — the gate is about
    stream integrity, not object state."""

    def __init__(self, hub: ServingHub, sub: Subscription, seed: int,
                 drop_rate: float):
        self.hub = hub
        self.sub = sub
        self.seed = seed
        self.drop_rate = drop_rate
        self.faults_on = True
        self.applied = sub.last_framed   # frame-chain position
        self.events_applied = 0
        self.frames_applied = 0
        self.frames_dropped = 0
        self.gaps_detected = 0
        self.gaps_unrecovered = 0
        self.relists = 0

    def _drop(self, frame: dict) -> bool:
        if not self.faults_on or self.drop_rate <= 0:
            return False
        h = zlib.crc32(f"{self.sub.client_id}:{frame.get('prev')}:"
                       f"{frame.get('to_rv', frame.get('rv'))}:"
                       f"{self.seed}".encode())
        return (h % 10_000) / 10_000.0 < self.drop_rate

    def drain(self) -> None:
        for frame in self.sub.take_frames():
            if frame.get("relist"):
                # structured re-anchor: the client re-lists (modeled as
                # accepting the snapshot) and resumes from rv
                self.applied = int(frame["rv"])
                self.relists += 1
                continue
            if self._drop(frame):
                self.frames_dropped += 1
                continue   # silent loss: detected by the NEXT frame
            if int(frame["prev"]) != self.applied:
                # broken chain: a frame before this one was lost —
                # rewind the cursor to the last applied position and
                # discard the rest of this drain (it replays)
                self.gaps_detected += 1
                self.hub.rewind(self.sub, self.applied)
                break
            for rv, _action, _kind, _o in frame["events"]:
                if rv > self.applied:
                    self.events_applied += 1
            self.applied = int(frame["to_rv"])
            self.frames_applied += 1

    def converged(self, final_rv: int) -> bool:
        """Converged = the hub walked this session's cursor to the final
        rv AND the client applied every frame the hub framed for it (no
        chain position outstanding). A cursor can pass rvs the filter
        delivered nothing for — the client legitimately never sees those
        — so convergence is the pair, not a client-side rv race."""
        return self.sub.cursor >= final_rv \
            and self.applied == self.sub.last_framed


def _build_clients(hub: ServingHub, n: int, seed: int,
                   drop_rate: float) -> List[StormClient]:
    """Deterministic subscriber population: ~70% filtered to the
    scheduler's pods (the production informer shape), ~15% node-scoped,
    the rest unfiltered firehose consumers. Tenants round-robin over
    STORM_TENANTS, with a slice owned by the noisy tenant so its
    throttling is observable on a real population."""
    clients: List[StormClient] = []
    for i in range(n):
        cid = f"watch-{i:05d}"
        tenant = NOISY_TENANT if i % 97 == 0 \
            else f"tenant-{i % STORM_TENANTS}"
        kinds = filter_attr = None
        r = i % 20
        if r < 14:
            kinds = ("pods",)
            filter_attr = (("spec", "scheduler_name"), "volcano")
        elif r < 17:
            kinds = ("nodes",)
        try:
            sub = hub.subscribe(cid, tenant=tenant, kinds=kinds,
                                filter_attr=filter_attr, since_rv=0)
        except ThrottledError:
            continue   # the noisy tenant's cap kicking in IS the test
        clients.append(StormClient(hub, sub, seed ^ (i * 2654435761),
                                   drop_rate))
    return clients


def run_storm(seed: int = 43, ticks: int = 80, nodes: int = 192,
              subscribers: int = 1000, shards: int = 8,
              drop_rate: float = 0.03,
              gap_tick: Optional[int] = None,
              resident: int = 192, device=None) -> dict:
    """One full storm run. Returns the flat verdict dict the CLI gates
    on (`checks` all-true = pass); see the module docstring for what
    each check means."""
    from ..sim.engine import SimEngine
    from ..sim.faults import FlakyWatch
    cfg = storm_config(seed=seed, ticks=ticks, nodes=nodes,
                       resident=resident, device=device)
    eng = SimEngine(cfg)
    admission = AdmissionController(
        tenants={NOISY_TENANT: TenantPolicy(
            write_rate=NOISY_WRITE_RATE, write_burst=NOISY_WRITE_RATE,
            max_subscriptions=NOISY_SUB_CAP)},
        now_fn=eng.clock.now)
    hub = ServingHub(eng.store, shards=shards, admission=admission)
    clients = _build_clients(hub, subscribers, seed, drop_rate)
    sub_throttles = admission.throttled.get(NOISY_TENANT, 0)
    if gap_tick is None:
        gap_tick = max(2, ticks // 2)
    noisy_throttled_writes = [0]

    def tick_hook(tick: int) -> None:
        if tick == gap_tick:
            # the journal window rolls past every cursor: the next
            # dispatch must take the structured relist, not skip events
            FlakyWatch.force_gap(eng.store)
        # the noisy tenant's write traffic at the admission edge (its
        # bucket refills off the virtual clock: deterministic verdicts)
        for _ in range(NOISY_WRITES_PER_TICK):
            try:
                admission.admit_write(NOISY_TENANT)
            except ThrottledError:
                noisy_throttled_writes[0] += 1
        hub.pump()
        for c in clients:
            c.drain()

    eng.tick_hooks.append(tick_hook)
    result = eng.run()

    # settle: the storm is over, the faults stop, everyone must converge
    # — lagging clients rewind/relist their way to the final rv
    final_rv = eng.store.current_rv()
    for c in clients:
        c.faults_on = False
    for _ in range(64):
        hub.pump()
        for c in clients:
            c.drain()
        if all(c.converged(final_rv) for c in clients):
            break
        for c in clients:
            # a broken chain (lost frame never followed by another) only
            # heals by rewinding; a merely-lagging cursor just needs the
            # next pump
            if c.applied != c.sub.last_framed:
                hub.rewind(c.sub, c.applied)
    converged = sum(1 for c in clients if c.converged(final_rv))
    unrecovered = sum(c.gaps_unrecovered for c in clients) \
        + sum(1 for c in clients if not c.converged(final_rv))
    coalesce_ratio = hub.events_total / max(1, hub.frames_total)
    summary = result.summary()
    verdict = {
        "storm": summary,
        "final_rv": final_rv,
        "subscribers": len(clients),
        "converged": converged,
        "gaps_detected": sum(c.gaps_detected for c in clients),
        "gaps_unrecovered": unrecovered,
        "frames_dropped": sum(c.frames_dropped for c in clients),
        "frames_total": hub.frames_total,
        "events_total": hub.events_total,
        "coalesce_ratio": round(coalesce_ratio, 1),
        "relists": hub.relists_total,
        "throttled": dict(admission.throttled),
        "noisy_throttled_writes": noisy_throttled_writes[0],
        "noisy_subscription_throttles": sub_throttles,
        "fanout_ms": hub.fanout_percentiles(),
        "bind_fingerprint": result.bind_fingerprint(),
        "ledger_fingerprint": result.ledger.get("fingerprint"),
        "violations": len(result.violations),
        "watch_drops": result.watch_drops,
        "divergence_repairs": result.divergence_repairs,
    }
    return verdict
