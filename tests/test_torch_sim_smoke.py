"""The port's ``smoke`` simulator gate at its full shape (512 nodes, 200
ticks, seed 7: the reference's ``make sim-smoke``) on the CPU: it must
pass (no violation, at least 2,000 tasks through, a bit-identical double
run), and its first run must give the reference's fingerprints and
counters recorded in tests/torch_sim_reference.json (the JAX package's
run at that shape; tests/test_torch_sim_gates.py regenerates the record).
About 55 s on one worker.

Tolerance: exact.
"""

from tests.test_torch_sim_gates import recorded, run_verb, summary_facts


def test_smoke_gate_matches_recorded_reference():
    rc, port = run_verb("port", ["smoke"])
    assert rc == 0 and port["pass"]
    assert port["deterministic_replay"]
    assert port["tasks_through"] >= 2000
    assert port["smoke"]["violations"] == []
    assert port["smoke"]["ticks"] == 200
    entry = dict(recorded()["shapes"]["smoke"])
    assert entry["kwargs"] == {"seed": 7, "ticks": 200, "nodes": 512}
    assert entry["fields"] == {}
    del entry["config"], entry["kwargs"], entry["fields"]
    assert summary_facts(port["smoke"]) == entry
