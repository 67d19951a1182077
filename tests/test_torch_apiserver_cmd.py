"""The port's two binaries of the multi-process deployment,
``python -m volcano_tpu_torch.cmd.apiserver`` and ``python -m
volcano_tpu_torch.cmd.scheduler --server URL``, held against the JAX
package's.

* The reference's ``test_apiserver_restart_durability`` on the port
  (``port_cases``): state written through the apiserver survives a
  restart from its ``--data-dir``, and a connected RemoteStore resyncs
  across the journal reset.
* Both packages' binaries, each pair as its own OS processes, on copies
  of one seeded data directory: the port's pair (the scheduler on
  ``--device cpu``) binds every pod where the reference's pair does.
  Then the port's apiserver is SIGKILLed once its write-ahead log has
  made the last bind durable, restarts from the directory and gives
  every bind back, with the same fingerprint as before the kill.

Tolerance: exact.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.request
import zlib

from tests.torch_reference_cases import port_cases

test_apiserver_restart_durability = port_cases(
    "test_multiprocess").test_apiserver_restart_durability

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES, GANGS, GANG = 16, 14, 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(mod, *args):
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return subprocess.Popen([sys.executable, "-m", mod, *args], cwd=REPO,
                            env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def _stop(p, sig=signal.SIGTERM):
    if p.poll() is None:
        p.send_signal(sig)
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_for(pred, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if pred():
                return True
        except OSError:
            pass
        time.sleep(0.2)
    return False


def _pods(url):
    return {f"{p['metadata']['namespace']}/{p['metadata']['name']}":
            p["spec"]["node_name"]
            for p in _get(f"{url}/apis/pods")["items"]}


def _fingerprint(url) -> str:
    """The served pods' keys, rvs and bind targets, and the rv tail."""
    items = sorted(_get(f"{url}/apis/pods")["items"],
                   key=lambda p: p["metadata"]["name"])
    h = zlib.crc32(str(_get(f"{url}/rv")["rv"]).encode())
    for p in items:
        h = zlib.crc32(f"{p['metadata']['name']}@"
                       f"{p['metadata']['resource_version']}:"
                       f"{p['spec']['node_name']}\n".encode(), h)
    return f"{h:08x}"


def _seed_data_dir(path):
    """One seeded cluster saved with the reference's anchored save (each
    package recovers the other's directories: tests/test_torch_wal.py)."""
    from volcano_tpu.apiserver.persistence import save_store_anchored
    from volcano_tpu.apiserver.store import ObjectStore
    from volcano_tpu.utils.synth import populate_store
    store = ObjectStore()
    populate_store(store, n_nodes=NODES, n_jobs=GANGS, gang_size=GANG)
    os.makedirs(path)
    save_store_anchored(store, os.path.join(path, "snapshot.json"),
                        fsync=True)


def _serve_and_schedule(pkg, data_dir, sched_args=()):
    """Boot ``pkg``'s apiserver on ``data_dir`` and its scheduler binary
    with --server; returns (apiserver, scheduler, url, metrics url) once
    every pod is bound (the scheduler still running)."""
    port, mport = _free_port(), _free_port()
    url, murl = f"http://127.0.0.1:{port}", f"http://127.0.0.1:{mport}"
    api = _spawn(f"{pkg}.cmd.apiserver", "--port", str(port), "--data-dir",
                 data_dir, "--metrics", f"127.0.0.1:{mport}")
    assert _wait_for(lambda: _get(f"{url}/rv") is not None, 60), pkg
    sched = _spawn(f"{pkg}.cmd.scheduler", "--server", url,
                   "--schedule-period", "0.5", "--listen-address",
                   f"127.0.0.1:{_free_port()}", *sched_args)
    ok = _wait_for(lambda: all(_pods(url).values()), 180)
    assert ok, f"{pkg}: pods left unbound"
    return api, sched, url, murl


def test_served_binaries_bind_as_the_reference_and_survive_sigkill(
        tmp_path):
    seed = str(tmp_path / "seed")
    _seed_data_dir(seed)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(seed, ref_dir)
    shutil.copytree(seed, port_dir)

    api, sched, url, _ = _serve_and_schedule("volcano_tpu", ref_dir)
    try:
        ref_binds = _pods(url)
    finally:
        _stop(sched)
        _stop(api)

    api, sched, url, murl = _serve_and_schedule(
        "volcano_tpu_torch", port_dir, ("--device", "cpu"))
    try:
        port_binds = _pods(url)
        assert len(port_binds) == GANGS * GANG
        assert port_binds == ref_binds
        # the scheduler's next cycles bind nothing new
        time.sleep(1.5)
        assert _pods(url) == port_binds
        _stop(sched)
        # acknowledged = fsynced: wait for the log to make the last rv
        # durable, then kill the apiserver with no chance to flush
        last_rv = _get(f"{url}/rv")["rv"]
        assert _wait_for(lambda: _get(f"{murl}/debug/durability")
                         ["durable_rv"] >= last_rv, 30)
        before = _fingerprint(url)
        _stop(api, signal.SIGKILL)
        port = url.rsplit(":", 1)[1]
        api = _spawn("volcano_tpu_torch.cmd.apiserver", "--port", port,
                     "--data-dir", port_dir)
        assert _wait_for(lambda: _get(f"{url}/rv") is not None, 60)
        assert _pods(url) == port_binds
        assert _fingerprint(url) == before
    finally:
        _stop(sched)
        _stop(api)
