"""Single-process control plane runner (the port's own copy of
volcano_tpu/cmd/cluster.py).

Runs the whole framework in one process: object store + admission webhooks +
controllers + scheduler + HTTP API endpoint (+ optional simulated kubelets),
the standalone equivalent of deploying the reference's three binaries and
CRDs onto a cluster (installer/volcano-development.yaml).

    python -m volcano_tpu_torch.cmd.cluster --port 8181 --nodes 4 \
        --node-resources cpu=16,memory=32Gi [--device cpu]

Then drive it with vcctl:

    python -m volcano_tpu_torch.cli.vcctl job run -N demo -r 4 -m 4

The scheduler places on ``cuda:0`` unless ``--device`` names another
device (``cpu`` runs the plain loop); without a GPU and without it the
command raises.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from ..apiserver.http import StoreHTTPServer
from ..apiserver.store import ObjectStore
from ..cli.util import parse_resource_list
from ..controllers import ControllerManager
from ..framework.registry import load_plugins_dir
from ..models.objects import Queue, ObjectMeta, QueueSpec
from ..scheduler import Scheduler
from ..utils.kubelet import SimulatedKubelet
from ..utils.test_utils import build_node
from ..webhooks import WebhookManager


def build_cluster(port: int = 8181, nodes: int = 0,
                  node_resources: str = "cpu=8,memory=16Gi",
                  scheduler_conf: str = None, schedule_period: float = 1.0,
                  simulate_kubelet: bool = True,
                  enabled_admission: str = None, plugins_dir: str = None,
                  state_file: str = None, device=None, clock=None):
    """The plane's parts: (store, controller manager, kubelet or None,
    scheduler, HTTP server), none started. ``clock`` is the store's (and
    so the scheduler's and the kubelet's) clock, the process's by
    default; a caller that steps the plane itself passes a FakeClock."""
    import os

    from ..apiserver.persistence import load_store
    store = ObjectStore() if clock is None else ObjectStore(clock=clock)
    WebhookManager(store, enabled_admission=enabled_admission)
    if state_file and os.path.exists(state_file):
        load_store(state_file, store=store)   # control-plane resume
    if store.get("queues", "default") is None:
        store.create("queues", Queue(metadata=ObjectMeta(name="default"),
                                     spec=QueueSpec(weight=1)),
                     skip_admission=True)
    for i in range(nodes):
        if store.get("nodes", f"node-{i}") is None:
            store.create("nodes", build_node(
                f"node-{i}", parse_resource_list(node_resources)))
    if plugins_dir:
        load_plugins_dir(plugins_dir)
    manager = ControllerManager(store)
    kubelet = SimulatedKubelet(store) if simulate_kubelet else None
    scheduler = Scheduler(store, scheduler_conf_path=scheduler_conf,
                          schedule_period=schedule_period, device=device)
    server = StoreHTTPServer(store, port=port)
    return store, manager, kubelet, scheduler, server


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vc-cluster")
    parser.add_argument("--port", type=int, default=8181)
    parser.add_argument("--nodes", type=int, default=0,
                        help="number of simulated nodes to create")
    parser.add_argument("--node-resources", default="cpu=8,memory=16Gi")
    parser.add_argument("--scheduler-conf", default=None,
                        help="scheduler conf YAML path (hot-reloaded)")
    parser.add_argument("--schedule-period", type=float, default=1.0)
    parser.add_argument("--no-kubelet", action="store_true",
                        help="do not simulate pod execution")
    parser.add_argument("--enabled-admission", default=None,
                        help="comma-separated admission paths to enable")
    parser.add_argument("--plugins-dir", default=None,
                        help="directory of custom scheduler plugin .py files")
    parser.add_argument("--listen-address", default=None,
                        help="host:port for the Prometheus /metrics endpoint")
    parser.add_argument("--state-file", default=None,
                        help="snapshot file for control-plane state "
                             "(restored on start, checkpointed periodically)")
    parser.add_argument("--checkpoint-interval", type=float, default=30.0)
    parser.add_argument("--device", default=None,
                        help="torch device of the placement kernel "
                             "(default: the GPU, cuda:0; 'cpu' runs the "
                             "plain loop)")
    parser.add_argument("--version", action="store_true")
    args = parser.parse_args(argv)
    if args.version:
        from ..version import print_version_and_exit
        print_version_and_exit()

    store, manager, kubelet, scheduler, server = build_cluster(
        port=args.port, nodes=args.nodes, node_resources=args.node_resources,
        scheduler_conf=args.scheduler_conf,
        schedule_period=args.schedule_period,
        simulate_kubelet=not args.no_kubelet,
        enabled_admission=args.enabled_admission,
        plugins_dir=args.plugins_dir, state_file=args.state_file,
        device=args.device)

    checkpointer = None
    if args.state_file:
        from ..apiserver.persistence import StoreCheckpointer
        checkpointer = StoreCheckpointer(store, args.state_file,
                                         interval=args.checkpoint_interval)
        checkpointer.start()

    metrics_server = None
    if args.listen_address:
        from ..metrics.server import MetricsServer
        host, _, port_s = args.listen_address.rpartition(":")
        metrics_server = MetricsServer(host or "127.0.0.1", int(port_s))
        metrics_server.start()

    stop = threading.Event()

    def tick_kubelet():
        import logging
        while not stop.is_set():
            try:
                kubelet.tick()
            except Exception:
                # e.g. a pod deleted by the job controller between the
                # kubelet's get and update; next tick resyncs
                logging.getLogger(__name__).exception("kubelet tick failed")
            stop.wait(0.2)

    manager.start()
    scheduler.start()
    server.start()
    if kubelet is not None:
        threading.Thread(target=tick_kubelet, daemon=True).start()
    print(f"volcano-tpu control plane listening on :{server.port} "
          f"({args.nodes} nodes)")

    def shutdown(*_):
        stop.set()
        scheduler.stop()
        manager.stop()
        server.stop()
        if checkpointer is not None:
            checkpointer.stop()   # final checkpoint
        if metrics_server is not None:
            metrics_server.stop()
        sys.exit(0)

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    signal.pause()
    return 0


if __name__ == "__main__":
    sys.exit(main())
