"""vc-apiserver: the standalone API-server process of the multi-process
deployment (the port's own copy of volcano_tpu/cmd/apiserver.py;
docs/deployment.md).

Serves the object store over HTTP — CRUD, the long-poll change journal
(`/watch`), the serving hub's `/watchstream`, event recording (`/events`),
and remote admission-webhook registration (`/admissionwebhooks`). The
scheduler connects with `--server` (``python -m
volcano_tpu_torch.cmd.scheduler --server URL``). With ``--data-dir`` the
store is durable: recovered from the directory's snapshot and
write-ahead log at start, every write logged, compacted every
``--checkpoint-interval`` seconds, and compacted once more on SIGTERM.
The process is host-only: it never touches a GPU.

    python -m volcano_tpu_torch.cmd.apiserver --port 8181 [--data-dir D] \
        [--nodes 4 --node-resources cpu=16,memory=32Gi] [--default-queue]

``--replicate-from URL`` makes the process a follower replica: its store
mirrors the leader's journal at the leader's rvs (a snapshot bootstrap on
a cold start; with ``--data-dir`` it resumes from its own log while the
leader's epoch allows), and it serves reads and watches. ``--peers
NAME=URL,...`` makes it a federation member: it runs the leader elector
against a lease its peers push to it, follows whichever replica holds the
lease, role-gates its writes and takes over when the lease lapses.

    python -m volcano_tpu_torch.cmd.apiserver --port 8182 \
        --replicate-from http://127.0.0.1:8181 [--data-dir D2]
"""

from __future__ import annotations

import argparse
import sys
import threading

from ..apiserver.http import StoreHTTPServer
from ..apiserver.store import ObjectStore
from ..cli.util import parse_resource_list
from ..models.objects import (Node, NodeStatus, ObjectMeta, Queue, QueueSpec)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vc-apiserver")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8181)
    parser.add_argument("--nodes", type=int, default=0,
                        help="pre-create N simulated nodes")
    parser.add_argument("--node-resources", default="cpu=16,memory=32Gi")
    parser.add_argument("--default-queue", action="store_true",
                        help="pre-create the default queue")
    parser.add_argument("--data-dir", default=None,
                        help="durable state under DIR: segmented "
                             "write-ahead log + snapshot.json, replayed "
                             "crash-consistently on startup (the etcd "
                             "durability role; apiserver/wal.py, "
                             "docs/design/durability.md)")
    parser.add_argument("--checkpoint-interval", type=float, default=30.0,
                        help="WAL compaction interval, seconds (snapshot "
                             "anchor + segment purge)")
    parser.add_argument("--wal-flush-interval", type=float, default=0.05,
                        help="WAL group-commit fsync interval, seconds "
                             "(the bounded acked-but-not-durable window)")
    parser.add_argument("--wal-segment-bytes", type=int,
                        default=64 * 1024 * 1024,
                        help="WAL segment rotation size")
    # multi-tenant serving hub (docs/design/serving.md): the sharded
    # watch fan-out behind /watchstream plus per-tenant admission at the
    # write edge. On by default; --serving-shards 0 disables the hub
    # (clients fall back to the long-poll /watch).
    parser.add_argument("--serving-shards", type=int, default=4)
    parser.add_argument("--tenant-write-rate", type=float, default=1000.0,
                        help="per-tenant write tokens per second")
    parser.add_argument("--tenant-write-burst", type=float, default=2000.0)
    parser.add_argument("--max-subscriptions", type=int, default=1024,
                        help="per-tenant concurrent watch-stream cap")
    # federated control plane (docs/design/federation.md): with
    # --replicate-from this process is a FOLLOWER replica — its store is
    # a read-only mirror fed from the leader's /replicate journal stream
    # (snapshot bootstrap on cold start), and its hub serves watch /
    # watchstream traffic at the leader's rvs.
    parser.add_argument("--replicate-from", default=None, metavar="URL",
                        help="leader apiserver URL; makes this replica a "
                             "follower mirror serving reads and watches")
    parser.add_argument("--replica-name", default=None,
                        help="follower replica name (default host:port)")
    # federation PROCESS mode (docs/design/federation.md "process
    # mode"): --peers makes this process a full federation MEMBER — it
    # runs the leader elector against a peer-pushed lease board, follows
    # whichever replica holds the lease, role-gates its write path, and
    # takes over (bumping the fencing token) when the lease lapses.
    parser.add_argument("--peers", default=None,
                        metavar="NAME=URL,NAME=URL",
                        help="all replica endpoints (this one included); "
                             "enables elector-driven federation")
    parser.add_argument("--advertise-url", default=None, metavar="URL",
                        help="base url peers/clients reach this replica "
                             "at (default http://host:port)")
    parser.add_argument("--bootstrap-leader", action="store_true",
                        help="acquire the lease immediately at boot "
                             "(exactly one replica per fresh set)")
    parser.add_argument("--initial-leader", default=None, metavar="NAME",
                        help="lease-board seed: which peer leads at "
                             "boot (followers only)")
    parser.add_argument("--lease-duration", type=float, default=15.0)
    parser.add_argument("--renew-interval", type=float, default=5.0)
    parser.add_argument("--metrics", default=None, metavar="HOST:PORT",
                        help="also serve the Prometheus /metrics + "
                             "/debug endpoints (incl. "
                             "/debug/replication) from this process — "
                             "the same surface the scheduler exposes")
    parser.add_argument("--version", action="store_true")
    args = parser.parse_args(argv)
    if args.version:
        from ..version import print_version_and_exit
        print_version_and_exit()

    store = ObjectStore()
    wal = None
    recovered_rv = 0
    if args.data_dir:
        from ..apiserver.wal import WriteAheadLog, recover_store
        _, recovery = recover_store(args.data_dir, store)
        recovered_rv = recovery["final_rv"]
        if recovery["snapshot_objects"] or recovery["entries_replayed"]:
            print(f"recovered rv={recovered_rv} "
                  f"(snapshot {recovery['snapshot_objects']} objects @ "
                  f"rv {recovery['snapshot_rv']}, "
                  f"{recovery['entries_replayed']} WAL entries, "
                  f"{recovery['torn_records_truncated']} torn records "
                  f"truncated) from {args.data_dir}", flush=True)
        wal = WriteAheadLog(args.data_dir,
                            flush_interval=args.wal_flush_interval,
                            segment_max_bytes=args.wal_segment_bytes,
                            compact_interval=args.checkpoint_interval)
        wal.attach(store)
        wal.start()
    def ensure(kind, obj_):
        try:
            store.create(kind, obj_)
        except KeyError:
            pass   # already restored from the snapshot

    if args.default_queue:
        ensure("queues", Queue(metadata=ObjectMeta(name="default"),
                               spec=QueueSpec(weight=1)))
    if args.nodes:
        rl = parse_resource_list(args.node_resources)
        for i in range(args.nodes):
            ensure("nodes", Node(
                metadata=ObjectMeta(name=f"node-{i}"),
                status=NodeStatus(allocatable=dict(rl), capacity=dict(rl))))
    hub = admission = None
    if args.serving_shards > 0:
        from .. import serving
        from ..serving.admission import AdmissionController
        from ..serving.hub import ServingHub
        admission = AdmissionController(
            write_rate=args.tenant_write_rate,
            write_burst=args.tenant_write_burst,
            max_subscriptions=args.max_subscriptions)
        hub = ServingHub(store, shards=args.serving_shards,
                         admission=admission)
        serving.set_active(hub=hub, admission=admission)
    follower = None
    member = None
    if args.peers:
        from ..replication import set_active
        from ..replication.election import FederationMember
        peers = {}
        for part in args.peers.split(","):
            pname, _, purl = part.partition("=")
            if not pname or not purl:
                parser.error(f"malformed --peers entry {part!r} "
                             "(want NAME=URL)")
            peers[pname.strip()] = purl.strip()
        name = args.replica_name or f"{args.host}:{args.port}"
        advertise = args.advertise_url or f"http://{args.host}:{args.port}"
        initial = args.initial_leader or ""
        member = FederationMember(
            name, store, hub=hub, peers=peers, advertise_url=advertise,
            lease_duration=args.lease_duration,
            renew_interval=args.renew_interval,
            bootstrap_leader=args.bootstrap_leader,
            initial_leader=initial,
            initial_leader_url=peers.get(initial, ""),
            local_recovery_floor=(recovery["fence_floor"]
                                  if recovered_rv > 0 else None))
        set_active(member=member)
    elif args.replicate_from:
        from ..replication import set_active
        from ..replication.follower import (FollowerReplica, FollowerRole,
                                            HTTPReplicationSource)
        source = HTTPReplicationSource(args.replicate_from)
        name = args.replica_name or f"{args.host}:{args.port}"
        follower = FollowerReplica(name, source, store=store, hub=hub)
        resume_local = False
        if recovered_rv > 0:
            # federation restart fast path (docs/design/durability.md):
            # local WAL recovery already re-anchored the mirror at the
            # leader's rvs — resume the journal pull from there and only
            # fall back to the peer snapshot bootstrap when the sync
            # loop proves the log behind the leader's retained window
            # (gap -> catch-up relist -> bootstrap, follower.py).
            # Guarded like FederationMember._ensure_following
            # (election.py): the local log is only trusted while the
            # upstream's fence epoch is <= the recovered floor (no
            # takeover since the log's last durable fence record) and
            # our rv does not run AHEAD of the upstream head — a
            # rebuilt/diverged upstream whose rv space overlaps ours
            # contiguously would otherwise resume silently divergent
            # (the sync loop sees no gap to trip on).
            try:
                up_head = source.current_rv()
                _, _, gone, up_epoch = source.collect(up_head,
                                                      timeout=0.0)
                resume_local = (not gone
                                and up_epoch <= recovery["fence_floor"]
                                and recovered_rv <= up_head)
            except Exception as e:
                print(f"follower: upstream probe failed ({e}); "
                      f"falling back to snapshot bootstrap", flush=True)
        if resume_local:
            print(f"follower resuming from local WAL at rv "
                  f"{recovered_rv} (peer bootstrap skipped)", flush=True)
        else:
            follower.bootstrap()              # cold-start snapshot
        follower.start()                      # continuous journal pull
        set_active(follower=follower)
    metrics_server = None
    if args.metrics:
        from ..metrics.server import MetricsServer
        mhost, _, mport = args.metrics.rpartition(":")
        metrics_server = MetricsServer(mhost or "127.0.0.1", int(mport))
        metrics_server.start()
    # SIGTERM and SIGINT end the process through the shutdown below from
    # the moment it answers a request: a signal that lands while the
    # member still claims its lease or prints its role must not kill it
    # unflushed
    stop = threading.Event()
    import signal as _signal

    def _graceful(signum, frame):
        stop.set()
    for sig in (_signal.SIGTERM, _signal.SIGINT):
        _signal.signal(sig, _graceful)
    # a plain follower's mirror takes writes from the leader's journal
    # only: its server answers writes with a 503 naming the leader
    server = StoreHTTPServer(store, host=args.host, port=args.port,
                             hub=hub, admission=admission,
                             member=member if follower is None
                             else FollowerRole(follower))
    server.start()
    if member is not None:
        if args.bootstrap_leader:
            member.step()   # claim the lease before the first client
        member.start()
        role = f"member:{member.role()}"
    elif follower is not None:
        role = f"follower of {args.replicate_from}"
    else:
        role = "leader"
    print(f"vc-apiserver ({role}) serving on {args.host}:{server.port}",
          flush=True)
    stop.wait()
    if metrics_server is not None:
        metrics_server.stop()
    if member is not None:
        member.stop()
    if follower is not None:
        follower.stop()
    if wal is not None:
        # stop accepting writes BEFORE the final flush+compact: an acked
        # write landing after the last fsync would be lost on restart
        server.stop()
        wal.close(final_compact=True)   # durable shutdown
    return 0


if __name__ == "__main__":
    sys.exit(main())
