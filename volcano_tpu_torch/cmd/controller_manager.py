"""The vc-controller-manager binary (the port's own copy of
volcano_tpu/cmd/controller_manager.py; reference:
cmd/controller-manager/app/server.go): runs the job, queue, podgroup and
gc controllers with optional leader election.

    python -m volcano_tpu_torch.cmd.controller_manager \
        [--server URL] [--leader-elect] [--worker-num 4]

With ``--server`` the controllers watch a ``RemoteStore`` mirror of a
remote apiserver and write back over REST. The process places nothing:
it initialises no CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading

from ..apiserver.store import ObjectStore
from ..controllers import ControllerManager, JobController
from ..utils.leaderelection import LeaderElector


def add_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--server", default=None,
                        help="remote apiserver URL (multi-process mode)")
    parser.add_argument("--worker-num", type=int, default=4,
                        help="job controller worker shard count")
    parser.add_argument("--max-requeue-num", type=int, default=15)
    parser.add_argument("--leader-elect", action="store_true")
    parser.add_argument("--version", action="store_true")


def run_controllers(store: ObjectStore, args) -> ControllerManager:
    from ..controllers import (GarbageCollector, PodGroupController,
                               QueueController)
    controllers = [
        JobController(workers=args.worker_num,
                      max_requeue_num=args.max_requeue_num),
        QueueController(), PodGroupController(), GarbageCollector(),
    ]
    manager = ControllerManager(store, controllers)
    if args.leader_elect:
        identity = f"{os.uname().nodename}-{os.getpid()}"
        LeaderElector(store, identity, lease_name="vc-controller-manager",
                      on_started_leading=manager.start,
                      on_stopped_leading=manager.stop).start()
    else:
        manager.start()
    return manager


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vc-controller-manager")
    add_flags(parser)
    args = parser.parse_args(argv)
    if args.version:
        from ..version import print_version_and_exit
        print_version_and_exit()
    if args.server:
        from ..apiserver.remote import RemoteStore
        store = RemoteStore(args.server)
        store.run()
    else:
        store = ObjectStore()
    run_controllers(store, args)
    print("vc-controller-manager running against "
          + (args.server or "embedded store"), flush=True)
    threading.Event().wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
