"""The port's control plane as separate processes (the reference's
tests/test_multiprocess.py cases on the port's binaries, the scheduler
child at ``--device cpu``), and one mixed plane.

* ``test_deploy_command``: ``python -m volcano_tpu_torch.cmd.deploy``
  brings up the port's four processes with TLS admission, proves
  admission live, binds a smoke gang of 4 and tears down.
* ``test_four_process_control_plane``: the port's apiserver, webhook
  manager, controller manager and scheduler; an invalid job is refused by
  the webhook callback with a 422, a valid one is expanded and bound.
* ``test_webhook_tls_handshake``: the port's admission endpoint serves
  HTTPS with its generated CA-signed certificate; a wrong CA bundle and
  plain HTTP fail closed.
* ``test_reference_controller_manager_on_port_apiserver``: the
  reference's vc-controller-manager against the port's apiserver gives
  the same PodGroups and pods as the port's own controller manager does
  against another port apiserver, for the same job (each with the port's
  scheduler on the CPU and no kubelet, so the gang ends bound, its pods
  Pending). Which node each pod lands on is left out here: the cycles
  meet the pods' REST writes at times that differ from run to run; the
  in-process tests hold binds exactly.
* ``test_cluster_command_runs_a_job``: ``cmd.cluster`` (the single
  process plane) runs vcctl's job to Running, refuses an invalid one and
  restores its state file after a restart.
"""

import signal
import socket
import subprocess
import time

from tests import torch_job_parity as tp
from tests.torch_reference_cases import port_cases

_mp = port_cases("test_multiprocess", replace=[
    ('"--timeout", "150"]', '"--timeout", "150", "--device", "cpu"]'),
    ('"--server", url, "--schedule-period", "0.5"))',
     '"--server", url, "--schedule-period", "0.5",\n'
     '                            "--device", "cpu"))')])

test_deploy_command = _mp.test_deploy_command
test_four_process_control_plane = _mp.test_four_process_control_plane
test_webhook_tls_handshake = _mp.test_webhook_tls_handshake


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(cond, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            got = cond()
        except OSError:
            got = None
        if got:
            return got
        time.sleep(0.3)
    raise AssertionError(f"timed out waiting for {what}")


def _plane(controller_pkg: str, procs: list) -> str:
    """A port apiserver (4 nodes, the default queue) with the port's
    scheduler on the CPU and ``controller_pkg``'s controller manager;
    returns its URL."""
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    procs.append(_mp._spawn("volcano_tpu_torch.cmd.apiserver",
                            "--port", str(port), "--nodes", "4",
                            "--node-resources", "cpu=8,memory=16Gi",
                            "--default-queue"))
    client = tp.mod(tp.PORT, "apiserver.http").StoreClient(url)
    assert _mp._wait_ready(client), "apiserver did not come up"
    procs.append(_mp._spawn(f"{controller_pkg}.cmd.controller_manager",
                            "--server", url))
    procs.append(_mp._spawn("volcano_tpu_torch.cmd.scheduler", "--server",
                            url, "--schedule-period", "0.3",
                            "--device", "cpu"))
    return url


def _facts(client) -> dict:
    """The PodGroups (spec and phase) and pods (spec, labels,
    annotations, phase, whether bound) a plane holds, in key order."""
    def pg(g):
        return (g.metadata.name, tp.encode(tp.PORT, "podgroups", g)["spec"],
                g.status.phase)

    def pod(p):
        enc = tp.encode(tp.PORT, "pods", p)
        enc["spec"].pop("node_name")
        return (p.metadata.name, enc["metadata"], enc["spec"],
                p.status.phase, bool(p.spec.node_name))
    return {"podgroups": sorted(pg(g) for g in client.list("podgroups")),
            "pods": sorted(pod(p) for p in client.list("pods"))}


def test_reference_controller_manager_on_port_apiserver():
    procs: list = []
    try:
        urls = {pkg: _plane(pkg, procs) for pkg in (tp.REFERENCE, tp.PORT)}
        clients = {pkg: tp.mod(tp.PORT, "apiserver.http").StoreClient(url)
                   for pkg, url in urls.items()}
        for client in clients.values():
            client.create("jobs", tp.vcjob(tp.PORT, "mixed", 3, 3,
                                           cpu="1", memory="1Gi"))

        # no kubelet runs here: the gang ends bound, its pods Pending
        def bound(client):
            pgs = client.list("podgroups")
            pods = client.list("pods")
            return len(pods) == 3 and all(p.spec.node_name for p in pods) \
                and [g.status.phase for g in pgs] == ["Running"]
        facts = {}
        for pkg, client in clients.items():
            _wait(lambda: bound(client), 90.0, f"{pkg}'s gang bound")
            facts[pkg] = _facts(client)
        assert facts[tp.REFERENCE] == facts[tp.PORT]
        assert [g[2] for g in facts[tp.PORT]["podgroups"]] == ["Running"]
        assert [p[0] for p in facts[tp.PORT]["pods"]] == \
            ["mixed-main-0", "mixed-main-1", "mixed-main-2"]
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def test_cluster_command_runs_a_job(tmp_path):
    """``python -m volcano_tpu_torch.cmd.cluster --device cpu`` with a
    state file: vcctl's job reaches Running through its in-process
    admission, controllers, scheduler and simulated kubelet; an invalid
    one is refused; on SIGTERM the checkpointer writes the state file,
    which a second start restores."""
    import contextlib
    import io

    from volcano_tpu_torch.cli import vcctl
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    state = str(tmp_path / "state.json")
    argv = ["--port", str(port), "--nodes", "2", "--device", "cpu",
            "--schedule-period", "0.2", "--state-file", state]
    client = tp.mod(tp.PORT, "apiserver.http").StoreClient(url)
    proc = _mp._spawn("volcano_tpu_torch.cmd.cluster", *argv)
    try:
        assert _mp._wait_ready(client), "the control plane did not come up"
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert vcctl.main(["--server", url, "job", "run", "-N", "demo",
                               "-r", "2", "-m", "2"]) == 0
        with contextlib.redirect_stderr(io.StringIO()) as err:
            assert vcctl.main(["--server", url, "job", "run", "-N", "bad",
                               "-r", "1", "-m", "3"]) == 1
        assert "minAvailable" in err.getvalue()
        _wait(lambda: client.get("jobs", "demo").status.state.phase ==
              "Running", 60.0, "the job Running")
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    assert proc.returncode == 0
    proc = _mp._spawn("volcano_tpu_torch.cmd.cluster", *argv)
    try:
        assert _mp._wait_ready(client), "the restart did not come up"
        assert client.get("jobs", "demo").status.state.phase == "Running"
        assert sorted(p.metadata.name for p in client.list("pods")) == \
            ["demo-demo-0", "demo-demo-1"]
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
