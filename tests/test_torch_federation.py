"""The port's federation gate (``python -m volcano_tpu_torch.sim.cli
federation``, replication/gate.py) held against the JAX package's.

* Both packages' CLIs at a shrunk shape (the port's at ``--device cpu``):
  both pass with every check true, the checks are equal, and so are the
  bind, outcome and ledger fingerprints, the counters and the replica
  set's facts (handoffs, fenced frames, bootstraps, the audit's verdict).
  The mirror fingerprint, a crc over each replica's key@rv lines, is held
  within each run (the audit) and not across runs or packages: the
  leader's status writers commit a timing-dependent number of updates in
  both packages, so the rvs move while every decision stays the same
  (tests/test_torch_sim_gates.py:FEDERATION_RECORDED).
* The port's ``run_federation`` at the gate's own shape, held to the
  reference's record in tests/torch_sim_reference.json.

Tolerance: exact.
"""

import contextlib
import io
import json

from tests.test_torch_sim_gates import (FEDERATION_RECORDED,
                                        federation_facts, recorded,
                                        summary_facts)
from volcano_tpu.framework.solver import reset_breaker
from volcano_tpu.sim import cli as ref_cli
from volcano_tpu_torch.sim import cli as port_cli

SHRUNK = ["federation", "--ticks", "16", "--nodes", "64", "--subscribers",
          "128"]
# the verdict's keys both packages' CLIs print and must agree on
VERDICT_KEYS = ("epoch", "replicas", "dead", "subscribers", "converged",
                "cursor_handoffs", "fenced_frames", "snapshot_bootstraps",
                "catchup_relists", "audit_verdict", "relists")


def _cli(side: str, argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if side == "ref":
            reset_breaker()
            rc = ref_cli.main(["sim", *argv, "--json"])
        else:
            rc = port_cli.main([*argv, "--json", "--device", "cpu"])
    return rc, json.loads(buf.getvalue())


def test_shrunk_federation_gate_matches_reference():
    ref_rc, ref = _cli("ref", SHRUNK)
    port_rc, port = _cli("port", SHRUNK)
    assert ref_rc == 0 and ref["pass"], ref["checks"]
    assert port_rc == 0 and port["pass"], port["checks"]
    assert port["checks"] == ref["checks"]
    assert len(port["checks"]) == 11 and all(port["checks"].values())
    assert summary_facts(port["federation"]) == \
        summary_facts(ref["federation"])
    assert {k: port[k] for k in VERDICT_KEYS} == \
        {k: ref[k] for k in VERDICT_KEYS}
    facts = port["port_facts"]
    # the CLI's two runs agree on every decision
    for k in ("bind_fingerprint", "ledger_fingerprint", "converged",
              "cursor_handoffs", "fenced_frames", "snapshot_bootstraps",
              "audit_verdict", "violations", "watch_drops",
              "divergence_repairs"):
        assert facts[k][0] == facts[k][1], k
    assert facts["bind_fingerprint"][0] == \
        port["federation"]["bind_fingerprint"]
    assert facts["audit_verdict"] == ["identical", "identical"]


def test_port_gives_recorded_federation_facts():
    """The port's federation gate at the gate's shape on the CPU
    (run_federation, as the CLI's first run) gives the recorded
    fingerprints and counters."""
    from volcano_tpu_torch.metrics import metrics
    from volcano_tpu_torch.replication.gate import run_federation
    entry = dict(recorded()["federation"])
    kwargs = entry.pop("kwargs")
    assert kwargs == FEDERATION_RECORDED
    metrics.reset()
    verdict = run_federation(device="cpu", **kwargs)
    assert federation_facts(verdict) == entry
    assert verdict["audit_divergent"] == []
    assert verdict["gaps_unrecovered"] == 0
