"""The port's ``incr``, ``constraints`` and ``prune`` simulator gates held
against the JAX package's on the CPU, as tests/test_torch_sim_gates.py
holds ``chaos``, ``failover`` and ``obs``: both CLIs pass with every check
true, equal checks, and the port's first run gives the reference's
fingerprints and counters. Default node counts, fewer ticks.

Tolerance: exact.
"""

from tests.test_torch_sim_gates import hold_verb


def test_incr_gate_matches_reference():
    ref, port = hold_verb(["incr", "--ticks", "120"], "incremental")

    def full(v):                # the forced-full run, its timing aside
        return {k: x for k, x in v["forced_full"].items() if k != "cycle_ms"}
    assert full(port) == full(ref)


def test_constraints_gate_matches_reference():
    ref, port = hold_verb(["constraints", "--ticks", "100"], "constraints")
    assert port["counters"]["compiled"] > 0
    assert port["counters"]["vk_kernel"] > 0


def test_prune_gate_matches_reference():
    ref, port = hold_verb(["prune", "--ticks", "80"], "prune")
    assert port["prune_runs"] > 0
    assert port["prune_fallbacks"] == ref["prune_fallbacks"]
