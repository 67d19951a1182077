"""The port's durability gate (volcano_tpu_torch/sim/durability.py) held
against the JAX package's, and a follower of either package replicating
from the other's leader.

* The three in-process episodes (torn tail, bit flip, disk full) on both
  packages: equal verdicts.
* Each package's whole gate once at a shrunk writer plan (24 pods): the
  in-process episodes and a ``vc-apiserver --data-dir`` child SIGKILLed at
  each of the WAL's three crash points, every check true. The CLI's double
  run (its bit-identity check) is held on the card by chip_smoke.py's
  ``replicas`` group; here ``durability_checks`` gets the one run twice,
  so that check only says the fingerprints exist. The gate's watchdog
  stays on: a child that hangs fails the test within ``WATCHDOG_S``.
* Across packages: an apiserver of one package with ``--replicate-from``
  an apiserver of the other, both ways; the follower bootstraps, streams
  the leader's writes, and its ``/replicate/snapshot`` digest (the
  process federation gate's audit digest) equals the leader's.

Tolerance: exact.
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKGS = ("volcano_tpu", "volcano_tpu_torch")
SEED = 47
PODS = 24
WATCHDOG_S = 90.0


def _dur(pkg):
    return importlib.import_module(f"{pkg}.sim.durability")


@pytest.mark.parametrize("episode", ["episode_torn_tail",
                                     "episode_bit_flip",
                                     "episode_disk_full"])
def test_in_process_episode_matches_reference(episode):
    ref = getattr(_dur("volcano_tpu"), episode)(SEED)
    port = getattr(_dur("volcano_tpu_torch"), episode)(SEED)
    assert port == ref
    assert all(v for k, v in port.items()
               if isinstance(v, bool)), port


@pytest.fixture(scope="module")
def gate_runs():
    """Each package's gate, once."""
    return {pkg: _dur(pkg).run_durability(seed=SEED, pods=PODS, nodes=8,
                                          watchdog_s=WATCHDOG_S)
            for pkg in PKGS}


@pytest.mark.parametrize("pkg", PKGS)
def test_durability_gate_once(pkg, gate_runs):
    dur = _dur(pkg)
    v = gate_runs[pkg]
    checks = dur.durability_checks(v, v)
    assert len(checks) == 16 and all(checks.values()), \
        {k: ok for k, ok in checks.items() if not ok}
    assert [e["label"] for e in v["episodes"]] == [
        p for p, _, _ in dur.CRASH_POINTS]
    assert all(e["restarts"] == 1 for e in v["episodes"])


def test_port_and_reference_gates_agree(gate_runs):
    """The crash points' seeded arms and the baseline's content
    fingerprints are the reference's (the writer plan and the digests are
    the same code over the same wire)."""
    ref, port = gate_runs["volcano_tpu"], gate_runs["volcano_tpu_torch"]
    for k in ("bind_fingerprint", "ledger_fingerprint", "torn_tail",
              "bit_flip", "disk_full"):
        assert port[k] == ref[k], k
    assert [e["nth"] for e in port["episodes"]] == \
        [e["nth"] for e in ref["episodes"]]


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _spawn(pkg, port, *argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.cmd.apiserver", "--port", str(port),
         "--serving-shards", "1", *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    deadline = time.monotonic() + 60.0
    while True:
        assert proc.poll() is None, proc.communicate()[0]
        assert time.monotonic() < deadline
        try:
            _get(f"http://127.0.0.1:{port}/rv")
            return proc
        except OSError:
            time.sleep(0.1)


@pytest.mark.parametrize("leader_pkg,follower_pkg", [
    ("volcano_tpu", "volcano_tpu_torch"),
    ("volcano_tpu_torch", "volcano_tpu")])
def test_follower_of_the_other_package(leader_pkg, follower_pkg, tmp_path):
    from volcano_tpu_torch.apiserver.http import StoreClient
    from volcano_tpu_torch.replication.chaos import _audit_digest
    from volcano_tpu_torch.utils.test_utils import build_node, build_pod
    lport, fport = _port(), _port()
    lurl, furl = (f"http://127.0.0.1:{p}" for p in (lport, fport))
    procs = [_spawn(leader_pkg, lport, "--data-dir", str(tmp_path / "l"))]
    try:
        client = StoreClient(lurl)
        for i in range(4):
            client.create("nodes", build_node(f"n{i}", {"cpu": "8"}))
        for i in range(20):
            client.create("pods", build_pod("default", f"p{i}", "",
                                            "Pending", {"cpu": "1"}))
        procs.append(_spawn(follower_pkg, fport, "--replicate-from", lurl,
                            "--data-dir", str(tmp_path / "f")))
        for i in range(20):        # streamed live, after the bootstrap
            p = client.get("pods", f"p{i}")
            p.spec.node_name = f"n{i % 4}"
            client.update("pods", p)
        client.delete("pods", "p0")
        want = _get(f"{lurl}/rv")["rv"]
        deadline = time.monotonic() + 30.0
        while _get(f"{furl}/rv")["rv"] < want:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        leader_snap = _get(f"{lurl}/replicate/snapshot")
        follower_snap = _get(f"{furl}/replicate/snapshot")
        assert follower_snap["rv"] == leader_snap["rv"] == want
        assert _audit_digest(follower_snap) == _audit_digest(leader_snap)
        assert len(follower_snap["objects"]["pods"]) == 19
    finally:
        for proc in procs:
            proc.terminate()
            proc.communicate(timeout=60)
