"""Federation storm gate (the port's own copy of
volcano_tpu/replication/gate.py; ``python -m volcano_tpu_torch.sim.cli
federation``, docs/design/federation.md).

The scenario: the real scheduler churns a seeded bind storm on the
LEADER store while a :class:`ReplicaSet` replicates the journal to two
follower mirrors and 1k+ subscribers watch — spread across all THREE
replicas' hubs by the deterministic placement hash — with the storm
gate's client-side frame-drop faults on. Mid-storm:

* one FOLLOWER replica is killed; every cursor it served is handed off
  to a live peer at the client's applied rv (``prev``-chain + rewind/
  relist do the resume; the frame epoch annotation tells the client its
  stream moved);
* the leader journal is force-cleared; followers take the structured
  ``gone`` and bootstrap from snapshot, their mirror consumers relist;
* a leadership election advances the epoch and the DEPOSED leader ships
  one more frame under its stale token — the mirrors must fence it.

Gate (checked twice; the double run must be bit-identical on bind,
ledger AND mirror fingerprints): every surviving cursor converges to
the final leader rv, zero unrecovered frame-chain gaps, >=1 cursor
handoff, >=1 snapshot bootstrap, >=1 fenced stale-leader frame, and the
cross-replica anti-entropy audit reports every settled mirror
fingerprint-identical to the leader.
"""

from __future__ import annotations

import zlib
from typing import List, Optional

from ..apiserver.store import FencedError
from ..serving.storm import STORM_TENANTS, StormClient, storm_config
from .election import elector_for_replicaset
from .federation import ReplicaSet


class FederationClient(StormClient):
    """A storm client that knows which replica serves it and can adopt
    a handed-off subscription mid-stream (epoch changes observed from
    the frame annotation)."""

    def __init__(self, hub, sub, seed: int, drop_rate: float,
                 replica: str):
        super().__init__(hub, sub, seed, drop_rate)
        self.replica = replica
        self.handoffs = 0
        self.epochs_seen: set = set()

    def drain(self) -> None:
        for frame in self.sub.take_frames():
            if "epoch" in frame:
                self.epochs_seen.add(int(frame["epoch"]))
            if frame.get("relist"):
                self.applied = int(frame["rv"])
                self.relists += 1
                continue
            if self._drop(frame):
                self.frames_dropped += 1
                continue
            if int(frame["prev"]) != self.applied:
                self.gaps_detected += 1
                self.hub.rewind(self.sub, self.applied)
                break
            for rv, _action, _kind, _o in frame["events"]:
                if rv > self.applied:
                    self.events_applied += 1
            self.applied = int(frame["to_rv"])
            self.frames_applied += 1

    def adopt(self, replica: str, hub, sub) -> None:
        """The cursor moved to a peer replica: same chain position,
        new stream."""
        self.replica = replica
        self.hub = hub
        self.sub = sub
        self.handoffs += 1


def _build_clients(rs: ReplicaSet, n: int, seed: int,
                   drop_rate: float) -> List[FederationClient]:
    """Deterministic federated population: the storm mix (70% pods
    filtered to the scheduler, 15% node-scoped, the rest firehose),
    homed across ALL live replicas by the placement hash — follower
    hubs serve real watch traffic, not just the leader's."""
    clients: List[FederationClient] = []
    for i in range(n):
        cid = f"fed-{i:05d}"
        tenant = f"tenant-{i % STORM_TENANTS}"
        kinds = filter_attr = None
        r = i % 20
        if r < 14:
            kinds = ("pods",)
            filter_attr = (("spec", "scheduler_name"), "volcano")
        elif r < 17:
            kinds = ("nodes",)
        replica = rs.place_subscriber(cid)
        sub = rs.hub_of(replica).subscribe(
            cid, tenant=tenant, kinds=kinds, filter_attr=filter_attr,
            since_rv=0)
        clients.append(FederationClient(
            rs.hub_of(replica), sub, seed ^ (i * 2654435761),
            drop_rate, replica))
    return clients


def _mirror_digest(audit: dict) -> int:
    """One crc over every live replica's per-kind fingerprints — the
    double run's mirror bit-identity check."""
    crc = 0
    fps = audit.get("fingerprints", {})
    for name in sorted(fps):
        for kind in sorted(fps[name]):
            crc = zlib.crc32(
                f"{name}:{kind}:{fps[name][kind]}\n".encode(), crc)
    return crc


def run_federation(seed: int = 43, ticks: int = 60, nodes: int = 128,
                   subscribers: int = 1024, shards: int = 4,
                   drop_rate: float = 0.02, followers: int = 2,
                   resident: int = 128,
                   kill_tick: Optional[int] = None,
                   gap_tick: Optional[int] = None,
                   fence_tick: Optional[int] = None,
                   device=None) -> dict:
    """One full federation run. Returns the flat verdict dict the CLI
    gates on; see the module docstring for the contract. ``device``: the
    leader's scheduler's, None for the card."""
    from ..sim.engine import SimEngine
    from ..sim.faults import FlakyWatch
    cfg = storm_config(seed=seed, ticks=ticks, nodes=nodes,
                       resident=resident, device=device)
    eng = SimEngine(cfg)
    rs = ReplicaSet(eng.store, followers=followers, shards=shards)
    # epochs are elector-driven end-to-end: the lease lives in the
    # leader store (replicated like any object), acquisitions promote
    # the replica set through rs.promote_epoch — the harness never
    # calls advance_epoch
    elector = elector_for_replicaset(rs, identity=rs.leader_name,
                                     lease_duration=4 * cfg.tick_s,
                                     retry_period=cfg.tick_s)
    elector.step()   # initial acquisition: token 1 == the seed epoch
    clients = _build_clients(rs, subscribers, seed, drop_rate)
    if kill_tick is None:
        kill_tick = max(2, ticks // 3)
    if gap_tick is None:
        gap_tick = max(kill_tick + 2, ticks // 2)
    if fence_tick is None:
        fence_tick = max(gap_tick + 2, (2 * ticks) // 3)
    victim = f"replica-{followers}"   # the last follower dies
    fenced_rejections = [0]

    def tick_hook(tick: int) -> None:
        elector.step()   # renew the lease on the virtual clock
        if tick == kill_tick:
            # a replica dies mid-storm: hand every cursor it served to
            # a live peer at the client's applied chain position
            rs.kill(victim)
            for c in clients:
                if c.replica == victim:
                    name, sub = rs.handoff(c.sub, c.applied)
                    c.adopt(name, rs.hub_of(name), sub)
        if tick == gap_tick:
            # the leader journal window rolls past every mirror: the
            # followers must take the structured gone -> snapshot
            # bootstrap, their subscribers the relist
            FlakyWatch.force_gap(eng.store)
        if tick == fence_tick:
            # deposed-leader frame: collect under the CURRENT epoch,
            # then RESTART the elector incarnation (the leader process
            # bounced mid-flush). The fresh incarnation re-acquires its
            # own lease with a bumped fencing token (the fencing rule),
            # and the acquisition itself promotes the epoch; shipping
            # the pre-restart frame under the stale token must be
            # rejected at the mirror untouched
            stale = rs.epoch
            target = next(f for f in rs.followers
                          if f.name not in rs.dead)
            entries, _tail, gone, _ = rs.source.collect(
                target.applied_rv(), 0.0, epoch=stale)
            elector.restart()
            elector.step()
            assert rs.epoch > stale, "elector takeover did not promote"
            if not gone:
                try:
                    target.apply_frame(entries, epoch=stale)
                except FencedError:
                    fenced_rejections[0] += 1
        rs.sync()
        rs.pump()
        for c in clients:
            c.drain()

    eng.tick_hooks.append(tick_hook)
    result = eng.run()

    # settle: faults off, mirrors drain to the leader head, every
    # surviving cursor must converge on whichever replica serves it
    final_rv = eng.store.current_rv()
    for c in clients:
        c.faults_on = False
    for _ in range(64):
        for f in rs.followers:
            if f.name not in rs.dead:
                f.sync_to_head()
        rs.pump()
        for c in clients:
            c.drain()
        if all(c.converged(final_rv) for c in clients):
            break
        for c in clients:
            if c.applied != c.sub.last_framed:
                c.hub.rewind(c.sub, c.applied)
    audit = rs.audit()
    converged = sum(1 for c in clients if c.converged(final_rv))
    unrecovered = sum(c.gaps_unrecovered for c in clients) \
        + sum(1 for c in clients if not c.converged(final_rv))
    hubs = [rs.leader_hub] + [f.hub for f in rs.followers]
    frames_total = sum(h.frames_total for h in hubs)
    events_total = sum(h.events_total for h in hubs)
    follower_live = [f for f in rs.followers if f.name not in rs.dead]
    summary = result.summary()
    verdict = {
        "storm": summary,
        "final_rv": final_rv,
        "epoch": rs.epoch,
        "replicas": len(rs.names()),
        "dead": sorted(rs.dead),
        "subscribers": len(clients),
        "converged": converged,
        "gaps_detected": sum(c.gaps_detected for c in clients),
        "gaps_unrecovered": unrecovered,
        "frames_dropped": sum(c.frames_dropped for c in clients),
        "frames_total": frames_total,
        "events_total": events_total,
        "coalesce_ratio": round(events_total / max(1, frames_total), 1),
        "relists": sum(h.relists_total for h in hubs),
        "cursor_handoffs": rs.handoffs,
        "handed_off_clients": sum(1 for c in clients if c.handoffs),
        "fenced_frames": fenced_rejections[0]
        + sum(f.fenced_frames for f in rs.followers),
        "snapshot_bootstraps": sum(f.snapshot_bootstraps
                                   for f in rs.followers),
        "catchup_relists": sum(f.catchup_relists
                               for f in rs.followers),
        "replication_gaps": sum(f.gaps_detected for f in rs.followers),
        "follower_lag_rvs": {f.name: f.lag() for f in follower_live},
        "audit_verdict": audit["verdict"],
        "audit_divergent": audit["divergent"],
        "mirror_fingerprint": _mirror_digest(audit),
        "fanout_ms": rs.leader_hub.fanout_percentiles(),
        "bind_fingerprint": result.bind_fingerprint(),
        "ledger_fingerprint": result.ledger.get("fingerprint"),
        "violations": len(result.violations),
        "watch_drops": result.watch_drops,
        "divergence_repairs": result.divergence_repairs,
    }
    return verdict
