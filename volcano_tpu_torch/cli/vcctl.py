"""vcctl: the command line client (the port's own copy of
volcano_tpu/cli/vcctl.py; reference: cmd/cli/vcctl.go).

    vcctl job   {run,list,view,suspend,resume,delete}
    vcctl queue {create,list,get,delete,operate}
    vcctl sim   {run,smoke,chaos,failover,obs,replay,...}
    vcctl debug {cycles,pending,health,latency,timeseries,explain,
                 replication,durability}

job/queue talk HTTP to a running control plane (python -m
volcano_tpu_torch.cmd.cluster, or the apiserver of cmd.deploy);
--server or $VOLCANO_SERVER selects the endpoint. sim needs no server:
the churn simulator owns its whole control plane in-process. debug reads
a scheduler's metrics server (--metrics or $VOLCANO_METRICS, cli/debug.py).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import job as job_cmds
from . import queue as queue_cmds
from .util import DEFAULT_SERVER, get_client


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="vcctl", description="volcano-tpu command line client")
    parser.add_argument("--server", "-s", default=DEFAULT_SERVER,
                        help="control plane endpoint")
    sub = parser.add_subparsers(dest="group", required=True)

    sub.add_parser("version", help="print client version")

    job = sub.add_parser("job", help="job operations").add_subparsers(
        dest="verb", required=True)

    run = job.add_parser("run", help="create a job")
    run.add_argument("--name", "-N", default="")
    run.add_argument("--namespace", "-n", default="default")
    run.add_argument("--image", "-i", default="busybox")
    run.add_argument("--min", "-m", type=int, default=1, dest="min_available")
    run.add_argument("--replicas", "-r", type=int, default=1)
    run.add_argument("--requests", "-R", default="cpu=1000m,memory=100Mi")
    run.add_argument("--limits", "-L", default="cpu=1000m,memory=100Mi")
    run.add_argument("--scheduler", "-S", default="volcano")
    run.add_argument("--queue", "-q", default="default")
    run.add_argument("--filename", "-f", default=None)

    ls = job.add_parser("list", help="list jobs")
    ls.add_argument("--namespace", "-n", default="default")
    ls.add_argument("--all-namespaces", action="store_true")
    ls.add_argument("--scheduler", "-S", default="")
    ls.add_argument("--selector", default="")

    for verb in ("view", "suspend", "resume", "delete"):
        p = job.add_parser(verb, help=f"{verb} a job")
        p.add_argument("--name", "-N", default="")
        p.add_argument("--namespace", "-n", default="default")

    queue = sub.add_parser("queue", help="queue operations").add_subparsers(
        dest="verb", required=True)

    qc = queue.add_parser("create", help="create a queue")
    qc.add_argument("--name", "-n", default="")
    qc.add_argument("--weight", "-w", type=int, default=1)
    qc.add_argument("--capability", "-c", default="")

    queue.add_parser("list", help="list queues")
    for verb in ("get", "delete"):
        p = queue.add_parser(verb, help=f"{verb} a queue")
        p.add_argument("--name", "-n", default="")

    qo = queue.add_parser("operate", help="open/close/update a queue")
    qo.add_argument("--name", "-n", default="")
    qo.add_argument("--action", "-a", default="",
                    help="open | close | update")
    qo.add_argument("--weight", "-w", type=int, default=0)

    from ..sim.cli import add_sim_parser
    add_sim_parser(sub)

    from .debug import add_debug_parser
    add_debug_parser(sub)

    return parser


def dispatch(args, client=None) -> str:
    if args.group == "version":
        from ..version import version_string
        return version_string()
    client = client if client is not None else get_client(args.server)
    if args.group == "job":
        if args.verb == "run":
            return job_cmds.run_job(
                client, args.name, args.namespace, args.image, args.replicas,
                args.min_available, args.requests, args.limits, args.scheduler,
                args.queue, args.filename)
        if args.verb == "list":
            return job_cmds.list_jobs(client, args.namespace,
                                      args.all_namespaces, args.scheduler,
                                      args.selector)
        if args.verb == "view":
            return job_cmds.view_job(client, args.name, args.namespace)
        if args.verb == "suspend":
            return job_cmds.suspend_job(client, args.name, args.namespace)
        if args.verb == "resume":
            return job_cmds.resume_job(client, args.name, args.namespace)
        if args.verb == "delete":
            return job_cmds.delete_job(client, args.name, args.namespace)
    if args.group == "queue":
        if args.verb == "create":
            return queue_cmds.create_queue(client, args.name, args.weight,
                                           args.capability)
        if args.verb == "list":
            return queue_cmds.list_queues(client)
        if args.verb == "get":
            return queue_cmds.get_queue(client, args.name)
        if args.verb == "delete":
            return queue_cmds.delete_queue(client, args.name)
        if args.verb == "operate":
            return queue_cmds.operate_queue(client, args.name, args.action,
                                            args.weight)
    raise ValueError(f"unknown command {args.group} {args.verb}")


def main(argv: Optional[List[str]] = None, client=None) -> int:
    args = build_parser().parse_args(argv)
    if args.group == "sim":
        # serverless: the simulator prints its own summary and returns an
        # exit code (nonzero on invariant violations / smoke failure)
        from ..sim.cli import dispatch_sim
        try:
            return dispatch_sim(args)
        except Exception as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    if args.group == "debug":
        # talks to the metrics server, not the apiserver client
        from .debug import dispatch_debug
        try:
            return dispatch_debug(args)
        except Exception as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    try:
        print(dispatch(args, client))
        return 0
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
