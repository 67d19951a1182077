"""The PyTorch/CUDA port stands alone: every module of volcano_tpu_torch
imports with jax blocked and loads no module of the JAX package, and
chip_smoke.py imports neither; the port's C sources (the native engine
and the native solver) include and open nothing of the JAX package. Entry
points need a GPU unless the caller names another device. The apiserver
children that the federation, durability and served gates start (a
follower, a federation member, a durable leader) and the children
cmd/deploy.py starts beside the scheduler (its apiserver, webhook manager
and controller manager) load neither and never initialise CUDA."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules['jax'] = None
import volcano_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    volcano_tpu_torch.__path__, 'volcano_tpu_torch.'))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == 'volcano_tpu' or m.startswith('volcano_tpu.'))
print(len(names), leaked)
print(' '.join(names))
"""

# the packages of the scheduling cycle the walk must reach, the
# placement-constraint layer, the preempt/reclaim path, candidate pruning,
# the observability layer (tracer, ledger, why-pending, explainer,
# metrics, their time series and server) and the scheduler binary with
# its conf watcher and leader election included, the native engine's
# build, the churn simulator with the store checkpoint, and the
# apiserver's durable, served layer (the write-ahead log, the HTTP server
# and RemoteStore, the serving hub and its storm gate, replication's
# leader half, the apiserver binary), and replication's follower half
# (follower, replica set, election, the federation gates, the chaos
# harness) with the durability gate, and the job path (the controllers,
# admission webhooks, kubelets, the control-plane binaries and the CLI),
# and the native CPU solver's binding, vcctl debug and the NUMA agent
CYCLE_MODULES = ("volcano_tpu_torch.apiserver.store",
                 "volcano_tpu_torch.native",
                 "volcano_tpu_torch.native.build",
                 "volcano_tpu_torch.cache.cache",
                 "volcano_tpu_torch.actions.allocate",
                 "volcano_tpu_torch.actions.preempt",
                 "volcano_tpu_torch.actions.reclaim",
                 "volcano_tpu_torch.framework.victims",
                 "volcano_tpu_torch.ops.victims",
                 "volcano_tpu_torch.ops.preempt",
                 "volcano_tpu_torch.plugins.conformance",
                 "volcano_tpu_torch.plugins.predicates",
                 "volcano_tpu_torch.plugins.interpod",
                 "volcano_tpu_torch.plugins.task_topology",
                 "volcano_tpu_torch.ops.constraints",
                 "volcano_tpu_torch.ops.prune",
                 "volcano_tpu_torch.trace.explain",
                 "volcano_tpu_torch.trace.tracer",
                 "volcano_tpu_torch.trace.ledger",
                 "volcano_tpu_torch.trace.pending",
                 "volcano_tpu_torch.metrics.metrics",
                 "volcano_tpu_torch.metrics.timeseries",
                 "volcano_tpu_torch.metrics.server",
                 "volcano_tpu_torch.scheduler",
                 "volcano_tpu_torch.cmd.cycle",
                 "volcano_tpu_torch.cmd.scheduler",
                 "volcano_tpu_torch.utils.filewatcher",
                 "volcano_tpu_torch.utils.leaderelection",
                 "volcano_tpu_torch.apiserver.codec",
                 "volcano_tpu_torch.apiserver.persistence",
                 "volcano_tpu_torch.sim.events",
                 "volcano_tpu_torch.sim.faults",
                 "volcano_tpu_torch.sim.workload",
                 "volcano_tpu_torch.sim.invariants",
                 "volcano_tpu_torch.sim.engine",
                 "volcano_tpu_torch.sim.replay",
                 "volcano_tpu_torch.sim.cli",
                 "volcano_tpu_torch.apiserver.wal",
                 "volcano_tpu_torch.apiserver.http",
                 "volcano_tpu_torch.apiserver.remote",
                 "volcano_tpu_torch.serving",
                 "volcano_tpu_torch.serving.admission",
                 "volcano_tpu_torch.serving.hub",
                 "volcano_tpu_torch.serving.storm",
                 "volcano_tpu_torch.replication",
                 "volcano_tpu_torch.replication.leader",
                 "volcano_tpu_torch.cli.util",
                 "volcano_tpu_torch.cmd.apiserver",
                 "volcano_tpu_torch.replication.follower",
                 "volcano_tpu_torch.replication.federation",
                 "volcano_tpu_torch.replication.election",
                 "volcano_tpu_torch.replication.gate",
                 "volcano_tpu_torch.replication.chaos",
                 "volcano_tpu_torch.sim.durability",
                 "volcano_tpu_torch.controllers",
                 "volcano_tpu_torch.controllers.apis",
                 "volcano_tpu_torch.controllers.cache",
                 "volcano_tpu_torch.controllers.framework",
                 "volcano_tpu_torch.controllers.garbagecollector",
                 "volcano_tpu_torch.controllers.podgroup",
                 "volcano_tpu_torch.controllers.job.controller",
                 "volcano_tpu_torch.controllers.job.state",
                 "volcano_tpu_torch.controllers.job.plugins",
                 "volcano_tpu_torch.controllers.job.plugins.env",
                 "volcano_tpu_torch.controllers.job.plugins.ssh",
                 "volcano_tpu_torch.controllers.job.plugins.svc",
                 "volcano_tpu_torch.controllers.queue.controller",
                 "volcano_tpu_torch.controllers.queue.state",
                 "volcano_tpu_torch.webhooks",
                 "volcano_tpu_torch.webhooks.jobs",
                 "volcano_tpu_torch.webhooks.pods",
                 "volcano_tpu_torch.webhooks.podgroups",
                 "volcano_tpu_torch.webhooks.queues",
                 "volcano_tpu_torch.webhooks.router",
                 "volcano_tpu_torch.webhooks.util",
                 "volcano_tpu_torch.utils.certs",
                 "volcano_tpu_torch.utils.rsa_fallback",
                 "volcano_tpu_torch.utils.kubelet",
                 "volcano_tpu_torch.utils.process_kubelet",
                 "volcano_tpu_torch.cmd.cluster",
                 "volcano_tpu_torch.cmd.deploy",
                 "volcano_tpu_torch.cmd.controller_manager",
                 "volcano_tpu_torch.cmd.webhook_manager",
                 "volcano_tpu_torch.cli",
                 "volcano_tpu_torch.cli.vcctl",
                 "volcano_tpu_torch.cli.job",
                 "volcano_tpu_torch.cli.queue",
                 "volcano_tpu_torch.cli.singles",
                 "volcano_tpu_torch.ops.native",
                 "volcano_tpu_torch.cli.debug",
                 "volcano_tpu_torch.utils.numa_agent")


def _is_reference(module: str) -> bool:
    """volcano_tpu or volcano_tpu.*, but not volcano_tpu_torch."""
    return module == "volcano_tpu" or module.startswith("volcano_tpu.")


def test_every_port_module_imports_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, walked = out.stdout.strip().split("\n")
    count, leaked = first.split(" ", 1)
    assert int(count) >= 130, out.stdout
    assert leaked == "[]", leaked
    assert set(CYCLE_MODULES) <= set(walked.split()), walked


@pytest.mark.parametrize("path", [
    "chip_smoke.py",
    *sorted(str(p.relative_to(ROOT))
            for p in (ROOT / "volcano_tpu_torch").rglob("*.py"))])
def test_no_jax_or_reference_import_statement(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert not (m == "jax" or m.startswith("jax.")), (path, m)
            assert not _is_reference(m), (path, m)


def test_native_modules_are_scanned():
    """The import-statement scan above covers the native engine's Python
    modules."""
    native = sorted(p.name for p in
                    (ROOT / "volcano_tpu_torch" / "native").glob("*.py"))
    assert native == ["__init__.py", "build.py"]


_C_SOURCES = sorted(str(p.relative_to(ROOT)) for pattern in ("*.c", "*.cc")
                    for p in (ROOT / "volcano_tpu_torch").rglob(pattern))


@pytest.mark.parametrize("path", _C_SOURCES)
def test_c_source_reaches_nothing_of_the_reference(path):
    """The port's C includes only system headers (<...>) and names no
    path of the JAX package in a string (an #include "...", an fopen)."""
    text = (ROOT / path).read_text()
    includes = re.findall(r'^\s*#\s*include\s*(\S.*)$', text, re.M)
    assert includes and all(i.startswith("<") for i in includes), includes
    for lit in re.findall(r'"((?:[^"\\\n]|\\.)*)"', text):
        assert "volcano_tpu/" not in lit and "volcano_tpu." not in lit, lit
    assert not re.search(r"\b(fopen|open|dlopen)\s*\(", text)


def test_native_build_compiles_the_ports_own_source():
    from volcano_tpu_torch.native import build
    assert build.SOURCE == ROOT / "volcano_tpu_torch" / "native" / \
        "fastmodel.c"
    assert build.BUILD_DIR == ROOT / "volcano_tpu_torch" / "_build"
    assert "volcano_tpu_torch/native/fastmodel.c" in _C_SOURCES


def test_native_solver_builds_the_ports_own_source():
    from volcano_tpu_torch.native import build
    assert build.SOLVER_SOURCE == ROOT / "volcano_tpu_torch" / "native" / \
        "solver.cc"
    assert build.solver_path().parent == build.BUILD_DIR
    assert "volcano_tpu_torch/native/solver.cc" in _C_SOURCES


_NEW_MODULES = """
import sys
sys.modules['jax'] = None
import volcano_tpu_torch.ops.native, volcano_tpu_torch.cli.debug
import volcano_tpu_torch.utils.numa_agent
print(sorted(m for m in sys.modules
             if m == 'volcano_tpu' or m.startswith('volcano_tpu.')))
"""


def test_native_solver_debug_cli_and_numa_agent_load_no_reference():
    out = subprocess.run([sys.executable, "-c", _NEW_MODULES], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_prefix_check_spares_the_port():
    assert _is_reference("volcano_tpu.ops.fit")
    assert _is_reference("volcano_tpu")
    assert not _is_reference("volcano_tpu_torch")
    assert not _is_reference("volcano_tpu_torch.ops.fit")


def test_default_device_raises_without_gpu(monkeypatch):
    from volcano_tpu_torch.utils.platform import default_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")


def test_chip_smoke_alone_prints_no_result(tmp_path):
    """Without the package beside it (or without a GPU) the smoke test
    exits non-zero and never prints its result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# one apiserver child, run as the gates run it, under a wrapper that blocks
# jax and reports at exit what the process loaded and whether CUDA was
# initialised in it
_CHILD = """
import atexit, json, runpy, sys
sys.modules['jax'] = None
import torch

def report():
    leaked = sorted(m for m in sys.modules
                    if m == 'volcano_tpu' or m.startswith('volcano_tpu.'))
    print('CHILD ' + json.dumps({'leaked': leaked,
                                 'cuda': torch.cuda.is_initialized()}),
          flush=True)
atexit.register(report)
sys.argv = ['vc-apiserver'] + sys.argv[1:]
runpy.run_module('volcano_tpu_torch.cmd.apiserver', run_name='__main__')
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", ["follower", "member", "durable"])
def test_apiserver_children_load_no_reference_and_no_cuda(mode, tmp_path):
    """The children of the gates: a follower with its own log (the served
    north star's), a federation member that takes the lease (the process
    federation gate's), a durable leader armed with a WAL crash point
    that does not fire (the durability gate's). Each serves, replicates
    or logs a write, ends on SIGTERM, and loaded no module of jax or of
    the JAX package and initialised no CUDA."""
    import json
    import os
    import time
    import urllib.request

    from volcano_tpu_torch.apiserver.http import StoreClient, StoreHTTPServer
    from volcano_tpu_torch.apiserver.store import ObjectStore
    from volcano_tpu_torch.apiserver.wal import CRASH_ENV
    from volcano_tpu_torch.utils.test_utils import build_pod

    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    leader = ObjectStore()
    server = StoreHTTPServer(leader, port=0)
    server.start()
    argv = ["--port", str(port), "--data-dir", str(tmp_path / "d")]
    env = dict(os.environ)
    if mode == "follower":
        argv += ["--replicate-from", f"http://127.0.0.1:{server.port}"]
    elif mode == "member":
        argv += ["--peers", f"a={url}", "--replica-name", "a",
                 "--bootstrap-leader", "--renew-interval", "0.2"]
    else:
        env[CRASH_ENV] = "mid-compaction:1000"
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, *argv], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60.0
        while True:
            assert proc.poll() is None and time.monotonic() < deadline
            try:
                urllib.request.urlopen(url + "/rv", timeout=1).read()
                break
            except OSError:
                time.sleep(0.1)
        # a member serves reads before it holds the lease, and its role
        # gate answers writes with a 503 until then
        while mode == "member":
            with urllib.request.urlopen(url + "/leader", timeout=2) as r:
                if json.loads(r.read())["accepts_writes"]:
                    break
            assert time.monotonic() < deadline
            time.sleep(0.1)
        pod = build_pod("default", "p", "", "Pending", {"cpu": "1"})
        if mode == "follower":
            leader.create("pods", pod)
        else:
            StoreClient(url).create("pods", pod)

        def rv():
            with urllib.request.urlopen(url + "/rv", timeout=2) as r:
                return json.loads(r.read())["rv"]
        while rv() < 1:
            assert time.monotonic() < deadline
            time.sleep(0.1)
    finally:
        proc.terminate()
        out = proc.communicate(timeout=60)[0]
        server.stop()
    assert proc.returncode == 0, out
    child = [ln for ln in out.splitlines() if ln.startswith("CHILD ")]
    assert json.loads(child[-1][6:]) == {"leaked": [], "cuda": False}, out


# a child of cmd/deploy.py, run as deploy runs it, under a wrapper that
# blocks jax, ends the child on SIGTERM through SystemExit (so that atexit
# runs) and reports what the process loaded and whether CUDA was
# initialised in it
_DEPLOY_CHILD = """
import atexit, json, runpy, signal, sys
sys.modules['jax'] = None
import torch

def report():
    leaked = sorted(m for m in sys.modules
                    if m == 'volcano_tpu' or m.startswith('volcano_tpu.'))
    print('CHILD ' + json.dumps({'leaked': leaked,
                                 'cuda': torch.cuda.is_initialized()}),
          flush=True)
atexit.register(report)
signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
runpy.run_module(module, run_name='__main__')
"""


@pytest.mark.parametrize("module,extra", [
    ("volcano_tpu_torch.cmd.apiserver", ()),
    ("volcano_tpu_torch.cmd.webhook_manager", ()),
    ("volcano_tpu_torch.cmd.controller_manager", ()),
    ("volcano_tpu_torch.cmd.controller_manager", ("--leader-elect",)),
    ("volcano_tpu_torch.cmd.scheduler", ("--device", "cpu"))])
def test_deploy_children_load_no_reference_and_no_cuda(module, extra,
                                                       tmp_path):
    """Each child cmd/deploy.py starts beside the scheduler, with deploy's
    arguments: the apiserver with its nodes and default queue, the
    webhook manager (TLS, registered with the apiserver) and the
    controller manager, both over ``--server`` (the controller manager
    also as a ``--leader-elect`` candidate, which takes the
    vc-controller-manager lease before it expands the job). A job
    submitted through the plane is admitted (or refused with a 422 once
    the webhook is registered) and expanded, and the scheduler (here on
    the CPU) binds a gang; each child ends on SIGTERM having loaded no
    module of jax or of the JAX package and initialised no CUDA."""
    import json
    import time

    from volcano_tpu_torch.apiserver.http import StoreHTTPServer
    from volcano_tpu_torch.apiserver.store import ObjectStore
    from volcano_tpu_torch.cli.job import run_job
    from volcano_tpu_torch.utils.test_utils import build_queue

    store = ObjectStore()
    store.create("queues", build_queue("default"))
    server = StoreHTTPServer(store, port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    if module.endswith("apiserver"):
        url = f"http://127.0.0.1:{_free_port()}"
        argv = ["--port", url.rsplit(":", 1)[1], "--default-queue",
                "--nodes", "4", "--node-resources", "cpu=16,memory=32Gi"]
    elif module.endswith("webhook_manager"):
        argv = ["--server", url, "--port", "0",
                "--tls-cert-dir", str(tmp_path / "certs")]
    elif module.endswith("scheduler"):
        argv = ["--server", url, "--listen-address",
                f"127.0.0.1:{_free_port()}", "--schedule-period", "0.2",
                *extra]
        from volcano_tpu_torch.utils import test_utils as tu
        store.create("nodes", tu.build_node("n1", {"cpu": "4",
                                                   "memory": "8Gi"}))
        store.create("podgroups", tu.build_pod_group(
            "pg", "default", "default", 1, phase="Inqueue"))
        pod = tu.build_pod("default", "p0", "", "Pending",
                           {"cpu": "1", "memory": "1Gi"}, groupname="pg")
        store.create("pods", pod)
    else:
        argv = ["--server", url, *extra]
    proc = subprocess.Popen([sys.executable, "-c", _DEPLOY_CHILD, module,
                             *argv], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        from volcano_tpu_torch.apiserver.http import StoreClient
        client = StoreClient(url)
        deadline = time.monotonic() + 60.0

        def settled() -> bool:
            if module.endswith("apiserver"):
                return len(client.list("nodes")) == 4
            if module.endswith("webhook_manager"):
                return bool(store._hooks)
            if module.endswith("scheduler"):
                return store.get("pods", "p0").spec.node_name == "n1"
            return store.get("podgroups", "j1") is not None and (
                not extra or store.get(
                    "configmaps", "vc-controller-manager",
                    "volcano-system") is not None)
        if module.endswith("controller_manager"):
            run_job(store, "j1", replicas=2, min_available=2)
        while True:
            assert proc.poll() is None and time.monotonic() < deadline
            try:
                if settled():
                    break
            except OSError:
                pass
            time.sleep(0.1)
        if module.endswith("webhook_manager"):
            assert "successfully" in run_job(store, "j2", replicas=2,
                                             min_available=2)
            with pytest.raises(Exception, match="minAvailable"):
                run_job(store, "bad", replicas=2, min_available=5)
    finally:
        proc.terminate()
        out = proc.communicate(timeout=60)[0]
        server.stop()
    child = [ln for ln in out.splitlines() if ln.startswith("CHILD ")]
    assert child, out
    assert json.loads(child[-1][6:]) == {"leaked": [], "cuda": False}, out
