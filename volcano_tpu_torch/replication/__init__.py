"""Federated control plane: journal replication and cross-replica serving
(the port's own copy of volcano_tpu/replication/,
docs/design/federation.md).

One apiserver replica is the leader: its store is the write path and its
rv-sorted journal the replication log. Every other replica is a follower:
a full store mirror fed by contiguous journal ranges shipped from the
leader, serving reads and watch/watchstream traffic from its own
:class:`~volcano_tpu_torch.serving.hub.ServingHub`. The pieces:

* :mod:`.leader`: :class:`ReplicationSource`, the leader half (contiguous
  journal ranges and whole-store snapshots, every frame stamped with the
  leader's fencing epoch).
* :mod:`.follower`: :class:`FollowerReplica`, the follower half (frames
  installed at the leader's rvs, stale epochs fenced, gaps recovered by a
  catch-up relist or a snapshot bootstrap) and
  :class:`HTTPReplicationSource`, the same contract over the apiserver's
  ``/replicate`` routes.
* :mod:`.federation`: :class:`ReplicaSet`, leader and followers with one
  serving hub each, cursor handoff to a peer when a replica dies, and the
  cross-replica fingerprint audit.
* :mod:`.gate`: the federation storm gate (``python -m
  volcano_tpu_torch.sim.cli federation``).
* :mod:`.election`: the elector-to-epoch seam (:class:`EpochElector`),
  the process-mode lease side channel (:class:`LeaseBoard`) and the
  per-process member runtime (:class:`FederationMember`).
* :mod:`.chaos`: process mode's chaos harness (replica processes, the
  fault-injecting proxy, the watch fleet, the seeded writer) and
  ``run_federation_procs`` (``federation --procs``).

``set_active``/``replication_report`` register the process's live
ReplicaSet, its own FollowerReplica (a follower apiserver) or its
FederationMember for ``/debug/replication``.
"""

from __future__ import annotations

_ACTIVE = {"replica_set": None, "follower": None, "member": None}


def set_active(replica_set=None, follower=None, member=None) -> None:
    """Register the live ReplicaSet (a federated simulator or test
    harness), this process's own FollowerReplica (a follower apiserver),
    and/or its FederationMember (elector-driven process mode) for
    /debug/replication."""
    if replica_set is not None:
        _ACTIVE["replica_set"] = replica_set
    if follower is not None:
        _ACTIVE["follower"] = follower
    if member is not None:
        _ACTIVE["member"] = member


def clear_active() -> None:
    _ACTIVE["replica_set"] = None
    _ACTIVE["follower"] = None
    _ACTIVE["member"] = None


def replication_report() -> dict:
    """The /debug/replication payload: leader epoch, per-follower lag in
    rvs, last fingerprint audit, catch-up relists and bootstraps, from
    whatever ReplicaSet / FollowerReplica / FederationMember is
    registered (``{"replica_set": None}`` alone when none is)."""
    rs = _ACTIVE["replica_set"]
    f = _ACTIVE["follower"]
    mem = _ACTIVE["member"]
    report = {"replica_set": rs.report() if rs is not None else None}
    if f is not None:
        report["follower"] = dict(f.report(), lag_rvs=f.lag())
    if mem is not None:
        report["member"] = mem.report()
        fr = mem.follower_report()
        if fr is not None and "follower" not in report:
            stale = mem.staleness()
            report["follower"] = dict(
                fr, lag_rvs=stale["lag_rvs"] if stale else 0)
    return report
