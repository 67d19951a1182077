"""Journal replication, its leader half (the port's own copy of the
leader side of volcano_tpu/replication/, docs/design/federation.md).

One apiserver replica is the leader: its store is the write path and its
rv-sorted journal the replication log. :mod:`.leader` has
:class:`~.leader.ReplicationSource` and ``snapshot_payload``, which the
apiserver's ``/replicate`` and ``/replicate/snapshot`` routes serve.

The follower half (the mirror that applies shipped frames, the replica
set, election, the federation gate and the chaos harness) is not ported
yet: a port apiserver runs standalone, and ``replication_report`` gives
the standalone report.
"""

from __future__ import annotations


def replication_report() -> dict:
    """The /debug/replication payload of a standalone apiserver: no
    replica set, follower or member is registered (the reference's
    report when nothing is)."""
    return {"replica_set": None}
