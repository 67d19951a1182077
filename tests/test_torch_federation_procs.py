"""The port's process-mode federation gate (``python -m
volcano_tpu_torch.sim.cli federation --procs``,
volcano_tpu_torch/replication/chaos.py) beside the JAX package's.

Three ``vc-apiserver`` members of each package behind the seeded chaos
proxies, at a shrunk writer plan (24 pods, 64 watch clients): episode A
(a half-open partition of the leader, a takeover and a fenced write from
the deposed regime) and episode B (the new leader SIGKILLed, writes
failing fast with 503 while the lease lapses, the dead member restarted
from its own log). Each package's gate runs once, with every check of
``federation_procs_checks`` true (given the one run twice, so the
double-run check only says the fingerprints exist: the double run is held
on the card by chip_smoke.py's ``replicas`` group). The port's bind
fingerprint is the writer plan's final state, computed here from the
plan. The reference's is too, unless its writer reconciled through the
restarted member's stale log and lost the deposed regime's acknowledged
tail (ROADMAP.md §3), which its checks do not catch in one run; so the
reference is held to its checks only. The gate's watchdog stays on: a
hung child fails the test within ``WATCHDOG_S``.

Tolerance: exact.
"""

import importlib
import zlib

import pytest

from volcano_tpu_torch.sim.cli import federation_procs_checks

PKGS = ("volcano_tpu", "volcano_tpu_torch")
WATCHDOG_S = 120.0


@pytest.fixture(scope="module")
def runs():
    return {pkg: importlib.import_module(
        f"{pkg}.replication.chaos").run_federation_procs(
            seed=43, subscribers=64, pods=24, watchdog_s=WATCHDOG_S)
        for pkg in PKGS}


@pytest.mark.parametrize("pkg", PKGS)
def test_federation_procs_gate_once(pkg, runs):
    v = runs[pkg]
    checks = federation_procs_checks(v, v)
    assert len(checks) == 15 and all(checks.values()), \
        {k: ok for k, ok in checks.items() if not ok}
    assert v["final_epoch"] == 3 and v["converged"] == 64
    assert v["lost_writes_after_replay"] == 0


def _plan_bind_fingerprint(seed: int, pods: int) -> int:
    """chaos.py:_content_digests' bind crc over the state the writer's
    plan ends in (every create, bind and delete applied once)."""
    from volcano_tpu_torch.replication.chaos import ChaosWriter
    writer = ChaosWriter(["http://127.0.0.1:9"], seed, pods=pods)
    state = {}
    for op in writer.plan:
        if op[0] == "create":
            state[op[1]] = ""
        elif op[0] == "bind":
            state[op[1]] = op[2]
        else:
            del state[op[1]]
    crc = 0
    for name in sorted(state):
        crc = zlib.crc32(f"chaos/{name}={state[name]}\n".encode(), crc)
    return crc


def test_port_reaches_the_writer_plans_final_state(runs):
    port = runs["volcano_tpu_torch"]
    assert port["bind_fingerprint"] == _plan_bind_fingerprint(43, 24)
    assert port["writer_ops"] == runs["volcano_tpu"]["writer_ops"] == 52
