"""The port's simulator gates (``python -m volcano_tpu_torch.sim.cli
<verb>``) held against the JAX package's (volcano_tpu/sim/cli.py) on the
CPU, and the recorded reference fingerprints that chip_smoke.py's ``sim``
group holds the card to.

Each verb runs whole through both packages' CLIs (``--json``; the port's
at ``--device cpu``), at its default node count with fewer ticks where
the default would take too long here. Both must pass with every check
true, the two verdicts' checks must be equal, and the port's first run
must give the reference's bind, outcome and ledger fingerprints and
counters. The other verbs are in tests/test_torch_sim_verbs.py and
tests/test_torch_sim_smoke.py.

tests/torch_sim_reference.json records the reference's first run at the
shapes chip_smoke.py runs (``RECORDED``), and its storm and federation
gates' first runs at the gates' own shapes (``STORM_RECORDED``,
``FEDERATION_RECORDED``: the fingerprints and the counters that repeat
from run to run), and the job path's pump at chip_smoke.py's ``jobs``
shape (``jobs``: tests/torch_job_parity.py's ``JOBS_SHAPE``, 6,250
vcjobs of 8 on 10,000 nodes); ``generate_reference`` makes it
(``python -m tests.test_torch_sim_gates`` rewrites it), and the slow test
regenerates it and requires it unchanged.

Tolerance: exact (sha256 fingerprints, counters, check verdicts).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from volcano_tpu.framework.solver import reset_breaker
from volcano_tpu.sim import cli as ref_cli
from volcano_tpu_torch.sim import cli as port_cli

ROOT = Path(__file__).resolve().parent.parent
REFERENCE_FILE = ROOT / "tests" / "torch_sim_reference.json"

# the fingerprints and counters a verb's first run is held to
COUNTERS = ("binds", "evictions", "resync_retries", "quarantined",
            "restarts", "fenced_writes", "divergence_repairs",
            "watch_drops", "cycle_modes", "quiet_cycles")

# the shapes chip_smoke.py's sim group holds to the reference: (a) the
# sim-smoke run, (b) the first run of each of four gates, (c) the north
# star under churn (smoke_config's rates over 10,000 nodes of 64 cores
# and 256 Gi with 6,250 resident gangs of 8); name -> (config function of
# sim/cli.py, its keyword arguments, SimConfig fields set after it)
RECORDED = {
    "smoke": ("smoke_config", {"seed": 7, "ticks": 200, "nodes": 512}, {}),
    "chaos": ("chaos_config", {"seed": 13, "ticks": 120, "nodes": 128}, {}),
    "failover": ("failover_config",
                 {"seed": 29, "ticks": 120, "nodes": 128}, {}),
    "incr": ("incr_config", {"seed": 23, "ticks": 200, "nodes": 256}, {}),
    "constraints": ("constraint_config",
                    {"seed": 41, "ticks": 160, "nodes": 96, "zones": 4}, {}),
    "north": ("smoke_config", {"seed": 7, "ticks": 12, "nodes": 10000},
              {"node_cpu": "64", "node_mem": "256Gi",
               "resident_jobs": 6250, "resident_gang": 8}),
}


# the storm gate's shape (sim/cli.py storm's defaults) and what its first
# run is held to beside summary_facts: frames_total, events_total,
# final_rv, frames_dropped and gaps_detected vary from run to run in both
# packages (the hub's dispatch rounds meet the journal at different
# points), so they are left out
STORM_RECORDED = {"seed": 43, "ticks": 80, "nodes": 192,
                  "subscribers": 1024, "shards": 8, "drop_rate": 0.03}
STORM_FACTS = ("subscribers", "converged", "gaps_unrecovered",
               "noisy_throttled_writes", "noisy_subscription_throttles",
               "violations", "watch_drops", "divergence_repairs")


# the federation gate's shape (sim/cli.py federation's defaults) and what
# its first run is held to beside summary_facts. final_rv, the frame and
# event totals, frames_dropped, gaps_detected and the mirror fingerprint
# (a crc over each replica's count, max rv and key@rv lines) vary from run
# to run in both packages: the leader's status writers commit a
# timing-dependent number of updates, so the rvs differ while every
# decision is the same. Mirror identity is held within each run instead
# (audit_verdict).
FEDERATION_RECORDED = {"seed": 43, "ticks": 60, "nodes": 128,
                       "subscribers": 1024, "shards": 4, "drop_rate": 0.02,
                       "followers": 2}
FEDERATION_FACTS = ("subscribers", "converged", "gaps_unrecovered",
                    "cursor_handoffs", "handed_off_clients",
                    "fenced_frames", "snapshot_bootstraps",
                    "catchup_relists", "replication_gaps", "audit_verdict",
                    "epoch", "dead", "relists", "violations", "watch_drops",
                    "divergence_repairs")


def federation_facts(verdict: dict) -> dict:
    """What a run_federation verdict (either package) is held to."""
    out = summary_facts(verdict["storm"])
    out.update({k: verdict[k] for k in FEDERATION_FACTS})
    return out


def storm_facts(verdict: dict) -> dict:
    """What a run_storm verdict (either package) is held to."""
    out = summary_facts(verdict["storm"])
    out.update({k: verdict[k] for k in STORM_FACTS})
    return out


def summary_facts(summary: dict) -> dict:
    """What a SimResult.summary() (either package) is held to: the three
    fingerprints and the counters."""
    out = {"bind": summary["bind_fingerprint"],
           "outcome": summary["outcome_fingerprint"],
           "ledger": summary["ledger"]["fingerprint"]}
    out.update({k: summary[k] for k in COUNTERS})
    return out


def run_verb(side: str, argv) -> tuple:
    """(exit code, verdict) of one verb through a package's CLI main."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if side == "ref":
            reset_breaker()
            rc = ref_cli.main(["sim", *argv, "--json"])
        else:
            rc = port_cli.main([*argv, "--json", "--device", "cpu"])
    return rc, json.loads(buf.getvalue())


def hold_verb(argv, key: str) -> tuple:
    """Run ``argv`` through both CLIs; the port must pass with every check
    true, its checks equal to the reference's and its first run's
    fingerprints and counters equal. Returns both verdicts."""
    ref_rc, ref = run_verb("ref", argv)
    port_rc, port = run_verb("port", argv)
    assert ref_rc == 0 and ref["pass"], ref.get("checks")
    assert port_rc == 0 and port["pass"], port.get("checks")
    if "checks" in ref:
        assert port["checks"] == ref["checks"]
        assert all(port["checks"].values()), port["checks"]
    assert summary_facts(port[key]) == summary_facts(ref[key])
    assert port[key]["violations"] == [] and port[key]["ticks"] == \
        ref[key]["ticks"]
    return ref, port


def generate_reference() -> dict:
    """The reference simulator's first run at every RECORDED shape, on the
    CPU: fingerprints and counters, the generator and the commit of the
    JAX package it ran. It needs JAX on one device: on more (this suite's
    conftest gives it eight) the reference places the north star's
    10,000 nodes through its device mesh, which the port does not have
    (ROADMAP item 13), and binds otherwise."""
    import jax
    from volcano_tpu.sim.engine import run_sim
    assert jax.device_count() == 1, jax.devices()
    shapes = {}
    for name, (fn, kwargs, fields) in RECORDED.items():
        reset_breaker()
        result = run_sim(recorded_config(ref_cli, name))
        assert not result.violations, (name, result.violations)
        shapes[name] = {"config": fn, "kwargs": kwargs, "fields": fields,
                        **summary_facts(result.summary())}
    return {"generator": "tests/test_torch_sim_gates.py:generate_reference",
            "reference_commit": reference_commit(), "shapes": shapes,
            "storm": generate_storm(), "federation": generate_federation(),
            "jobs": generate_jobs()}


def generate_storm() -> dict:
    """The reference's storm gate's first run at STORM_RECORDED."""
    from volcano_tpu.serving.storm import run_storm
    reset_breaker()
    verdict = run_storm(**STORM_RECORDED)
    assert verdict["violations"] == 0
    return {"kwargs": STORM_RECORDED, **storm_facts(verdict)}


def generate_federation() -> dict:
    """The reference's federation gate's first run at
    FEDERATION_RECORDED."""
    from volcano_tpu.metrics import metrics
    from volcano_tpu.replication.gate import run_federation
    reset_breaker()
    metrics.reset()
    verdict = run_federation(**FEDERATION_RECORDED)
    assert verdict["violations"] == 0
    return {"kwargs": FEDERATION_RECORDED, **federation_facts(verdict)}


def generate_jobs() -> dict:
    """The reference's job path at JOBS_SHAPE: every vcjob submitted
    through admission into its in-process control plane, pumped until
    every job is Running (tests/torch_job_parity.py:run_jobs_shape)."""
    from tests.torch_job_parity import JOBS_SHAPE, REFERENCE, run_jobs_shape
    return {"kwargs": JOBS_SHAPE, **run_jobs_shape(REFERENCE, JOBS_SHAPE)}


def recorded_config(cli, name: str, **extra):
    """The SimConfig of a RECORDED shape from a package's sim/cli.py."""
    fn, kwargs, fields = RECORDED[name]
    cfg = getattr(cli, fn)(**kwargs, **extra)
    for k, v in fields.items():
        setattr(cfg, k, v)
    cfg.repro_dir = None
    return cfg


def reference_commit() -> str:
    """The last commit that changed the JAX package."""
    return subprocess.run(
        ["git", "log", "-1", "--format=%H", "--", "volcano_tpu/"],
        cwd=ROOT, capture_output=True, text=True, check=True).stdout.strip()


def recorded() -> dict:
    return json.loads(REFERENCE_FILE.read_text())


# -- the gates --------------------------------------------------------------


def test_chaos_gate_matches_reference():
    hold_verb(["chaos", "--ticks", "90"], "chaos")


def test_failover_gate_matches_reference():
    ref, port = hold_verb(["failover"], "failover")
    assert port["failover"]["restarts"] == 3
    assert port["failover"]["fenced_writes"] >= 1


def test_obs_gate_matches_reference():
    hold_verb(["obs"], "obs")


# -- the recorded reference -------------------------------------------------


def test_recorded_reference_schema():
    data = recorded()
    assert data["generator"] == \
        "tests/test_torch_sim_gates.py:generate_reference"
    assert len(data["reference_commit"]) == 40
    assert set(data["shapes"]) == set(RECORDED)
    for name, (fn, kwargs, fields) in RECORDED.items():
        entry = data["shapes"][name]
        assert entry["config"] == fn and entry["kwargs"] == kwargs
        assert entry["fields"] == fields
        assert callable(getattr(port_cli, fn))
        cfg = recorded_config(port_cli, name, device="cpu")
        assert all(getattr(cfg, k) == v for k, v in fields.items())
        for k in ("bind", "outcome", "ledger"):
            assert len(entry[k]) == 64 and int(entry[k], 16) >= 0
        assert set(entry) == {"config", "kwargs", "fields", "bind",
                              "outcome", "ledger", *COUNTERS}
        assert entry["binds"] > 0


def test_recorded_storm_schema():
    entry = recorded()["storm"]
    assert entry["kwargs"] == STORM_RECORDED
    assert set(entry) == {"kwargs", "bind", "outcome", "ledger", *COUNTERS,
                          *STORM_FACTS}
    assert entry["binds"] > 0 and entry["converged"] == entry["subscribers"]


def test_recorded_federation_schema():
    entry = recorded()["federation"]
    assert entry["kwargs"] == FEDERATION_RECORDED
    assert set(entry) == {"kwargs", "bind", "outcome", "ledger", *COUNTERS,
                          *FEDERATION_FACTS}
    assert entry["binds"] > 0 and entry["converged"] == entry["subscribers"]
    assert entry["audit_verdict"] == "identical"
    assert entry["fenced_frames"] >= 1 and entry["snapshot_bootstraps"] >= 1
    # the CLI's defaults are the recorded shape (chip_smoke runs them)
    parser = port_cli.argparse.ArgumentParser()
    port_cli.add_sim_parser(parser.add_subparsers(dest="group"))
    parsed = parser.parse_args(["sim", "federation"])
    assert {k: getattr(parsed, k) for k in FEDERATION_RECORDED} == \
        FEDERATION_RECORDED


def test_recorded_jobs_schema():
    """The job path's record: its shape is chip_smoke's, every job and
    PodGroup Running, every pod bound and Running, the default queue's
    counts those of the jobs."""
    from tests.torch_job_parity import JOBS_SHAPE
    entry = recorded()["jobs"]
    assert entry["kwargs"] == JOBS_SHAPE
    assert set(entry) == {"kwargs", "rounds", "phases_by_round", "binds",
                          "pods_running", "podgroups_running",
                          "queue_running", "queue_pending", "queue_inqueue",
                          "bind"}
    pods = JOBS_SHAPE["jobs"] * JOBS_SHAPE["replicas"]
    assert entry["binds"] == entry["pods_running"] == pods
    assert entry["podgroups_running"] == entry["queue_running"] == \
        JOBS_SHAPE["jobs"]
    assert entry["queue_pending"] == entry["queue_inqueue"] == 0
    assert entry["phases_by_round"][-1] == {"Running": JOBS_SHAPE["jobs"]}
    assert entry["rounds"] == len(entry["phases_by_round"]) <= \
        JOBS_SHAPE["max_rounds"]
    assert len(entry["bind"]) == 64 and int(entry["bind"], 16) >= 0


def test_port_gives_recorded_storm_facts():
    """The port's storm gate at the gate's shape on the CPU (run_storm, as
    the CLI's first run) gives the recorded fingerprints and counters."""
    from volcano_tpu_torch.serving.storm import run_storm
    entry = dict(recorded()["storm"])
    kwargs = entry.pop("kwargs")
    assert storm_facts(run_storm(device="cpu", **kwargs)) == entry


def port_facts(name: str) -> dict:
    """The port's run at a RECORDED shape on the CPU."""
    from volcano_tpu_torch.sim.engine import run_sim
    result = run_sim(recorded_config(port_cli, name, device="cpu"))
    assert not result.violations
    return summary_facts(result.summary())


def test_port_gives_recorded_chaos_fingerprints():
    entry = dict(recorded()["shapes"]["chaos"])
    del entry["config"], entry["kwargs"], entry["fields"]
    assert port_facts("chaos") == entry


@pytest.mark.slow
def test_recorded_reference_is_current():
    """Regenerate tests/torch_sim_reference.json from the JAX package, in
    a process with one JAX device (``generate_reference``); it must be
    unchanged (about six minutes: the north star's two of them, and the
    job path's pump at JOBS_SHAPE about three)."""
    flags = " ".join(f for f in os.environ.get("XLA_FLAGS", "").split()
                     if "xla_force_host_platform_device_count" not in f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
    out = subprocess.run(
        [sys.executable, "-m", "tests.test_torch_sim_gates", "--print"],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.splitlines()[-1]) == recorded()


if __name__ == "__main__":
    # python -m tests.test_torch_sim_gates [--print]: rewrite the record
    # (or print it on one line)
    data = generate_reference()
    if sys.argv[1:] == ["--print"]:
        print(json.dumps(data, sort_keys=True))
    else:
        REFERENCE_FILE.write_text(json.dumps(data, indent=1, sort_keys=True)
                                  + "\n")
