"""vc-deploy: one-command control-plane deployment (the port's own copy
of volcano_tpu/cmd/deploy.py).

The standalone analogue of the reference's one-file installer
(installer/volcano-development.yaml: three Deployments + admission
registration against the API server): brings up the four-process control
plane — apiserver, webhook-manager (TLS admission, CA-bundle registered),
controller-manager, scheduler — waits for admission to be live, runs a
smoke job through the full path (webhook validate -> job controller ->
podgroup -> gang schedule -> binds), reports, and tears everything down
(``--keep`` leaves it running for interactive use).

    python -m volcano_tpu_torch.cmd.deploy [--device cpu]

The scheduler child places on ``cuda:0`` unless ``--device`` names
another device (``cpu`` runs the plain loop); without a GPU and without
it the child raises and the deployment fails. The apiserver, webhook
manager and controller manager children place nothing and initialise no
CUDA device.
"""

from __future__ import annotations

import argparse
import signal
import socket
import subprocess
import sys
import time


def add_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--port", type=int, default=0,
                        help="apiserver port (0 = pick a free one)")
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--node-resources", default="cpu=16,memory=32Gi")
    parser.add_argument("--smoke-replicas", type=int, default=4)
    parser.add_argument("--timeout", type=float, default=120.0)
    parser.add_argument("--keep", action="store_true",
                        help="leave the control plane running (Ctrl-C "
                             "tears it down)")
    parser.add_argument("--scheduler-conf", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device of the scheduler child's "
                             "placement kernel (default: the GPU, cuda:0; "
                             "'cpu' runs the plain loop)")
    parser.add_argument("--version", action="store_true")


def _spawn(module: str, *args: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", module, *args])


def log(msg: str) -> None:
    print(f"[deploy] {msg}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vc-deploy")
    add_flags(parser)
    args = parser.parse_args(argv)
    if args.version:
        from ..version import print_version_and_exit
        print_version_and_exit()

    from ..apiserver.http import ApiError, StoreClient
    from ..models.objects import (Container, Job, JobSpec, ObjectMeta,
                                  PodSpec, PodTemplate, TaskSpec)

    port = args.port
    if port == 0:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    procs: list = []
    ok = False

    def teardown() -> None:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()

    def make_job(name: str, replicas: int, min_available: int) -> Job:
        return Job(
            metadata=ObjectMeta(name=name, namespace="default"),
            spec=JobSpec(
                min_available=min_available, queue="default",
                tasks=[TaskSpec(
                    name="main", replicas=replicas,
                    template=PodTemplate(
                        metadata=ObjectMeta(name="main"),
                        spec=PodSpec(containers=[Container(
                            name="main",
                            requests={"cpu": "1", "memory": "1Gi"})])))]))

    try:
        log(f"apiserver on {url} with {args.nodes} synthetic nodes")
        procs.append(_spawn("volcano_tpu_torch.cmd.apiserver",
                            "--port", str(port), "--default-queue",
                            "--nodes", str(args.nodes),
                            "--node-resources", args.node_resources))
        client = StoreClient(url)
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline:
            try:
                client.list("queues")
                break
            except Exception:
                time.sleep(0.3)
        else:
            log("apiserver did not come up")
            return 1

        log("webhook-manager (TLS admission, CA bundle registered)")
        procs.append(_spawn("volcano_tpu_torch.cmd.webhook_manager",
                            "--server", url, "--port", "0"))
        log("controller-manager")
        procs.append(_spawn("volcano_tpu_torch.cmd.controller_manager",
                            "--server", url))
        log("scheduler")
        sched = ["volcano_tpu_torch.cmd.scheduler", "--server", url,
                 "--schedule-period", "0.5"]
        if args.scheduler_conf:
            sched += ["--scheduler-conf", args.scheduler_conf]
        if args.device:
            sched += ["--device", args.device]
        procs.append(_spawn(*sched))

        # admission live = an invalid job is rejected over the TLS callback
        log("waiting for admission registration (invalid job must be "
            "rejected)")
        rejected = False
        while time.monotonic() < deadline and not rejected:
            try:
                client.create("jobs", make_job("deploy-bad", 2, 5))
                client.delete("jobs", "deploy-bad", "default")
            except ApiError as e:
                if e.code == 422:
                    rejected = True
                    break
            time.sleep(0.4)   # outside the try: non-422 errors (webhook
            #                   still booting) must not busy-spin
        if not rejected:
            log("FAIL: admission never became live")
            return 1
        log("admission live (422 on invalid job)")

        # smoke job through the whole control plane
        n = args.smoke_replicas
        log(f"smoke job: gang of {n}")
        client.create("jobs", make_job("deploy-smoke", n, n))
        bound: dict = {}
        while time.monotonic() < deadline:
            pods = [p for p in client.list("pods", "default")
                    if p.metadata.name.startswith("deploy-smoke-")]
            bound = {p.metadata.name: p.spec.node_name
                     for p in pods if p.spec.node_name}
            if len(bound) >= n:
                break
            time.sleep(0.4)
        if len(bound) < n:
            log(f"FAIL: only {len(bound)}/{n} smoke pods bound")
            return 1
        pg = next((g for g in client.list("podgroups", "default")
                   if g.metadata.name.startswith("deploy-smoke")), None)
        log(f"smoke job bound: {len(bound)}/{n} pods on "
            f"{len(set(bound.values()))} nodes; podgroup phase "
            f"{pg.status.phase if pg else '?'}")
        ok = True
        if args.keep:
            log(f"control plane left running on {url} (Ctrl-C to stop); "
                "submit work with:")
            log(f"  python -m volcano_tpu_torch.cli.vcctl --server {url} "
                "job run -N demo -r 4 -m 4")
            try:
                while all(p.poll() is None for p in procs):
                    time.sleep(1.0)
            except KeyboardInterrupt:
                return 0
            log("FAIL: a control-plane component exited; tearing down")
            return 1
        return 0
    finally:
        if not args.keep or not ok:
            log("tearing down")
            teardown()
            log("deployment verified and torn down" if ok else "failed")
        else:
            teardown()


if __name__ == "__main__":
    sys.exit(main())
