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

``--replicate-from`` and ``--peers`` (a follower replica, a federation
member) wait for replication's follower half (ROADMAP item 10b): given
either, the command exits non-zero and starts no server.
"""

from __future__ import annotations

import argparse
import sys
import threading

from ..apiserver.http import StoreHTTPServer
from ..apiserver.store import ObjectStore
from ..cli.util import parse_resource_list
from ..models.objects import (Node, NodeStatus, ObjectMeta, Queue, QueueSpec)

# the flags whose replication roles are not ported yet
WAITING_FLAGS = ("replicate_from", "peers")


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
    for flag in WAITING_FLAGS:
        if getattr(args, flag):
            print(f"vc-apiserver: --{flag.replace('_', '-')}: replication's "
                  "follower half (follower replicas and federation "
                  "members) is not ported yet; it waits for ROADMAP item "
                  "10b", file=sys.stderr)
            return 2

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
    metrics_server = None
    if args.metrics:
        from ..metrics.server import MetricsServer
        mhost, _, mport = args.metrics.rpartition(":")
        metrics_server = MetricsServer(mhost or "127.0.0.1", int(mport))
        metrics_server.start()
    server = StoreHTTPServer(store, host=args.host, port=args.port,
                             hub=hub, admission=admission)
    server.start()
    print(f"vc-apiserver (leader) serving on {args.host}:{server.port}",
          flush=True)
    stop = threading.Event()
    import signal as _signal

    def _graceful(signum, frame):
        stop.set()
    for sig in (_signal.SIGTERM, _signal.SIGINT):
        _signal.signal(sig, _graceful)
    stop.wait()
    if metrics_server is not None:
        metrics_server.stop()
    if wal is not None:
        # stop accepting writes BEFORE the final flush+compact: an acked
        # write landing after the last fsync would be lost on restart
        server.stop()
        wal.close(final_compact=True)   # durable shutdown
    return 0


if __name__ == "__main__":
    sys.exit(main())
