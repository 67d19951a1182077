"""Replica-set federation (the port's own copy of
volcano_tpu/replication/federation.py): one serving hub per replica,
cursor failover across replicas, and the cross-replica divergence audit
(docs/design/federation.md).

A :class:`ReplicaSet` wires the leader store and N
:class:`FollowerReplica` mirrors into one serving surface:

* every replica (leader included) owns a :class:`ServingHub` over its
  own store, so reads and watch/watchstream traffic scale horizontally
  while writes stay on the leader;
* every hub stamps frames with the replica's known leadership epoch —
  the annotation that lets a client cursor survive failover: the
  ``prev`` chain plus ``rewind()``/relist do the resume, the epoch
  tells the client its frames now come from a different mirror;
* :meth:`handoff` moves a subscriber to a deterministic live peer at
  its applied rv — a peer whose mirror is slightly behind simply holds
  the cursor until replication passes it; a peer whose journal window
  already rolled past it answers the structured relist (the
  "cursor handed to a peer mid-gap" contract);
* :meth:`audit` points the cache's anti-entropy fingerprint (count,
  max rv, crc over sorted ``key@rv`` lines) ACROSS replicas: because
  followers install at the leader's rvs, any divergence — missed
  frame, stale object, extra key — perturbs the fingerprint. Only
  commit-order-deterministic rv assignment makes this audit meaningful;
  see the settle barrier in apiserver/store.py.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional

from ..apiserver.store import KINDS, ObjectStore
from ..metrics import metrics as m
from ..serving.hub import ServingHub, Subscription
from .follower import FollowerReplica
from .leader import ReplicationSource


class ReplicaSet:
    """Leader + N follower replicas behind one federated serving
    surface. Pump-mode driving (the simulator and gate): ``sync()``
    pulls mirrors forward, ``pump()`` dispatches every live hub."""

    def __init__(self, leader_store: ObjectStore, followers: int = 2,
                 shards: int = 4, admission=None, epoch: int = 1,
                 encoder=None):
        self.epoch = int(epoch)
        leader_store.advance_fence(self.epoch)
        self.source = ReplicationSource(leader_store, epoch=self.epoch)
        self.leader_name = "replica-0"
        self.leader_store = leader_store
        self.leader_hub = ServingHub(leader_store, shards=shards,
                                     admission=admission,
                                     epoch=self.epoch, encoder=encoder)
        self.followers: List[FollowerReplica] = []
        for i in range(max(0, int(followers))):
            f = FollowerReplica(f"replica-{i + 1}", self.source)
            f.hub = ServingHub(f.store, shards=shards,
                               epoch=self.epoch, encoder=encoder)
            f.observe_epoch(self.epoch)
            self.followers.append(f)
        self.dead: set = set()
        self.handoffs = 0
        self.last_audit: Optional[dict] = None

    # -- topology ------------------------------------------------------------

    def names(self) -> List[str]:
        return [self.leader_name] + [f.name for f in self.followers]

    def live_names(self) -> List[str]:
        return [n for n in self.names() if n not in self.dead]

    def hub_of(self, name: str) -> ServingHub:
        if name == self.leader_name:
            return self.leader_hub
        for f in self.followers:
            if f.name == name:
                return f.hub
        raise KeyError(name)

    def store_of(self, name: str) -> ObjectStore:
        if name == self.leader_name:
            return self.leader_store
        for f in self.followers:
            if f.name == name:
                return f.store
        raise KeyError(name)

    def kill(self, name: str) -> None:
        """A replica dies: its hub stops dispatching and its mirror
        stops syncing. Its subscribers' cursors move to peers via
        :meth:`handoff` — nothing about a dead replica recovers them."""
        if name == self.leader_name:
            raise ValueError("the leader's death is a leadership "
                             "change: call advance_epoch() with the "
                             "new leader's token instead")
        self.dead.add(name)

    def advance_epoch(self) -> int:
        """A leadership election completed: the (possibly same) leader
        now ships under a NEW epoch, every live replica observes it,
        and any frame still stamped with the old epoch is fenced at the
        mirrors — the deposed-leader contract."""
        return self.promote_epoch(self.epoch + 1)

    def promote_epoch(self, token: int) -> int:
        """Promote the replica set to an elector-granted epoch: the
        fencing token a LeaderElector won the lease with (the
        ``EpochElector`` seam calls this from ``on_promote``). Monotonic
        — a stale token is a no-op, so a deposed incarnation re-winning
        nothing cannot roll the epoch back."""
        token = int(token)
        if token <= self.epoch:
            return self.epoch
        self.epoch = token
        self.leader_store.advance_fence(self.epoch)
        self.source.set_epoch(self.epoch)
        self.leader_hub.set_epoch(self.epoch)
        for f in self.followers:
            if f.name not in self.dead:
                f.observe_epoch(self.epoch)
        return self.epoch

    # -- driving ---------------------------------------------------------------

    def sync(self, timeout: float = 0.0) -> int:
        """One replication round for every live follower."""
        applied = 0
        for f in self.followers:
            if f.name not in self.dead:
                applied += f.sync_once(timeout)
        return applied

    def pump(self) -> int:
        """One dispatch round on every live hub."""
        frames = self.leader_hub.pump() \
            if self.leader_name not in self.dead else 0
        for f in self.followers:
            if f.name not in self.dead:
                frames += f.hub.pump()
        return frames

    def start(self) -> None:
        """Threaded mode: follower sync loops + every hub's shard
        threads (the production serving processes)."""
        self.leader_hub.start()
        for f in self.followers:
            f.start()
            f.hub.start()

    def stop(self) -> None:
        self.leader_hub.stop()
        for f in self.followers:
            f.stop()
            f.hub.stop()

    # -- cursor failover --------------------------------------------------------

    def place_subscriber(self, client_id: str) -> str:
        """Deterministic home replica for a client: crc32 over the live
        replica list (double runs place identically)."""
        live = self.live_names()
        return live[zlib.crc32(client_id.encode()) % len(live)]

    def handoff(self, sub: Subscription, applied_rv: int,
                exclude: tuple = ()) -> tuple:
        """Move a subscriber to a live peer replica, resuming at the
        client's applied rv. Returns ``(replica_name, new_sub)``. The
        old subscription is NOT unsubscribed here — its replica is
        typically dead; a live origin cleans up itself."""
        live = [n for n in self.live_names() if n not in exclude]
        if not live:
            raise RuntimeError("no live replica to hand the cursor to")
        name = live[zlib.crc32(sub.client_id.encode()) % len(live)]
        hub = self.hub_of(name)
        new = hub.subscribe(sub.client_id, tenant=sub.tenant,
                            kinds=sub.kinds, filter_attr=sub.filter_attr,
                            filter_fn=sub.filter_fn,
                            since_rv=int(applied_rv))
        self.handoffs += 1
        m.inc(m.REPLICATION_HANDOFFS, to=name)
        return name, new

    # -- divergence audit ---------------------------------------------------------

    def audit(self) -> dict:
        """Cross-replica anti-entropy fingerprint audit over every
        kind: followers install at the leader's rvs, so live mirrors
        must fingerprint IDENTICALLY to the leader (a lagging mirror is
        reported as lag, not divergence — the audit compares replicas
        that claim the same applied rv)."""
        from ..cache.cache import SchedulerCache
        fp = SchedulerCache._fingerprint
        reports: Dict[str, dict] = {}
        for name in self.live_names():
            store = self.store_of(name)
            reports[name] = {
                kind: fp({store.key_of(kind, o):
                          (o.metadata.resource_version, o)
                          for o in store.list_refs(kind)})
                for kind in KINDS}
        leader_fp = reports[self.leader_name]
        leader_rv = self.leader_store.current_rv()
        divergent = []
        for f in self.followers:
            if f.name in self.dead:
                continue
            if f.applied_rv() != leader_rv:
                continue   # lag, not divergence: compare after settle
            if reports[f.name] != leader_fp:
                divergent.append(f.name)
        verdict = "divergent" if divergent else "identical"
        m.inc(m.REPLICATION_AUDITS, verdict=verdict)
        self.last_audit = {"verdict": verdict, "divergent": divergent,
                           "leader_rv": leader_rv,
                           "fingerprints": {
                               name: {kind: list(v)
                                      for kind, v in per.items()}
                               for name, per in reports.items()}}
        return self.last_audit

    # -- observability ---------------------------------------------------------

    def report(self) -> dict:
        return {
            "epoch": self.epoch,
            "leader": self.source.report(),
            "followers": [f.report() for f in self.followers],
            "lag_rvs": {f.name: f.lag() for f in self.followers
                        if f.name not in self.dead},
            "dead": sorted(self.dead),
            "cursor_handoffs": self.handoffs,
            "last_audit": ({"verdict": self.last_audit["verdict"],
                            "divergent": self.last_audit["divergent"],
                            "leader_rv": self.last_audit["leader_rv"]}
                           if self.last_audit else None),
        }
