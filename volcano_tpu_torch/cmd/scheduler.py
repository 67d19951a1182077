"""The vc-scheduler binary (counterpart of volcano_tpu/cmd/scheduler.py;
reference: cmd/scheduler/app/server.go).

    python -m volcano_tpu_torch.cmd.scheduler [--server URL] \\
        [--scheduler-conf FILE] [--leader-elect] [--plugins-dir DIR] \\
        [--schedule-period 1] [--listen-address :8080] [--enable-tracing] \\
        [--device cpu]

Runs the scheduler against a remote apiserver (``--server URL``: a
``RemoteStore`` mirror, apiserver/remote.py, listed from the server and
kept current by its watch stream; the binds go back one REST write a
pod) or alone against an embedded store: one cycle every
``--schedule-period`` seconds on ``cuda:0`` (``--device cpu`` runs the
plain loop; without a GPU and without it the command raises), the conf
file reloaded when it changes, ``/metrics`` and ``/debug/*`` served on
``--listen-address``. With ``--leader-elect`` it is one candidate of
several on one store: it schedules only while it holds the lease, and its
writes carry the lease's fencing token. ``--plugins-dir`` loads the
out-of-tree plugins of a directory (``framework/registry.py:
load_plugins_dir``). ``--percentage-nodes-to-find``, ``--default-queue``
and ``--lock-object-namespace`` are accepted and ignored, as in the
reference.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import uuid
from typing import List, Optional

from ..apiserver.store import ObjectStore
from ..scheduler import Scheduler
from ..utils.leaderelection import LeaderElector


def add_flags(parser: argparse.ArgumentParser) -> None:
    """cmd/scheduler/app/options/options.go:81-108, and ``--device``."""
    parser.add_argument("--server", default=None,
                        help="remote apiserver URL (default: an embedded "
                             "store)")
    parser.add_argument("--scheduler-name", default="volcano")
    parser.add_argument("--scheduler-conf", default=None)
    parser.add_argument("--schedule-period", type=float, default=1.0)
    parser.add_argument("--default-queue", default="default")
    parser.add_argument("--leader-elect", action="store_true")
    parser.add_argument("--lock-object-namespace", default="volcano-system")
    parser.add_argument("--listen-address", default=":8080")
    parser.add_argument("--plugins-dir", default=None)
    parser.add_argument("--percentage-nodes-to-find", type=int, default=0,
                        help="accepted and ignored: the kernel evaluates "
                             "every node")
    parser.add_argument("--enable-tracing", action="store_true",
                        help="turn on the cycle flight recorder, the pod "
                             "lifecycle ledger and the metrics time series "
                             "(/debug/* on --listen-address); also turned "
                             "on by VOLCANO_TRACE=1")
    parser.add_argument("--trace-cycles", type=int, default=None,
                        help="how many recent cycles the flight recorder "
                             "keeps (default 64, or VOLCANO_TRACE_CAPACITY)")
    parser.add_argument("--device", default=None,
                        help="torch device of the placement kernel "
                             "(default: the GPU, cuda:0; 'cpu' runs the "
                             "plain loop)")
    parser.add_argument("--version", action="store_true")


def open_store(args):
    """The store the flags name: a RemoteStore over ``--server`` with its
    watch thread running, or a fresh embedded ObjectStore."""
    if args.server:
        from ..apiserver.remote import RemoteStore
        store = RemoteStore(args.server)
        store.run()
        return store
    return ObjectStore()


def run_scheduler(store: ObjectStore, args) -> Scheduler:
    """Build the scheduler from parsed flags and start it: at once, or,
    with ``--leader-elect``, through a LeaderElector whose callbacks
    start and stop it. Returns the scheduler (``.elector`` is the
    elector, or None)."""
    if args.plugins_dir:
        from ..framework.registry import load_plugins_dir
        load_plugins_dir(args.plugins_dir)
    elector = None
    if args.leader_elect:
        # the host and process, as the reference's, and a random suffix,
        # so that candidates of one process differ too
        identity = (f"{os.uname().nodename}-{os.getpid()}-"
                    f"{uuid.uuid4().hex[:8]}")
        elector = LeaderElector(
            store, identity, lease_name="vc-scheduler",
            on_started_leading=lambda: scheduler.start(),
            on_stopped_leading=lambda: scheduler.stop())
    # with an elector, run_once does nothing on a standby and the cache's
    # writes carry the elector's fencing token
    scheduler = Scheduler(store, scheduler_name=args.scheduler_name,
                          scheduler_conf_path=args.scheduler_conf,
                          schedule_period=args.schedule_period,
                          elector=elector, device=args.device)
    if elector is not None:
        elector.start()
    else:
        scheduler.start()
    return scheduler


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="vc-scheduler")
    add_flags(parser)
    args = parser.parse_args(argv)
    if args.version:
        from ..version import print_version_and_exit
        print_version_and_exit()
    from ..trace import tracer
    if args.enable_tracing:
        # an explicit --trace-cycles wins, then VOLCANO_TRACE_CAPACITY,
        # then the recorder's default
        cap = args.trace_cycles
        if cap is None:
            cap = tracer.env_capacity()
        tracer.enable(capacity=cap)
    elif tracer.enable_from_env() and args.trace_cycles is not None:
        tracer.configure(args.trace_cycles)
    store = open_store(args)
    scheduler = run_scheduler(store, args)
    from ..metrics.server import MetricsServer
    host, _, port_s = args.listen_address.rpartition(":")
    try:
        MetricsServer(host or "127.0.0.1", int(port_s)).start()
    except OSError as e:
        # a second candidate on one host must not die over the metrics
        # port: election and scheduling go on without exposition
        print(f"metrics endpoint unavailable ({e}); continuing without",
              file=sys.stderr)
    print(f"vc-scheduler running against "
          f"{args.server or 'the embedded store'} on {scheduler.device}",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        if scheduler.elector is not None:
            # the elector's loop ends and releases the lease, so that a
            # standby takes over at its next round
            scheduler.elector.stop(timeout=10.0)
        scheduler.stop()
        if args.server:
            store.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
