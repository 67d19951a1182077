"""The port's command-line entry point runs on the CPU when asked and
prints one JSON line; without a device it needs a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _run(*args):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.cmd.place", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)


def test_place_on_cpu_prints_one_json_line():
    out = _run("--device", "cpu", "--tasks", "256", "--nodes", "64",
               "--runs", "1")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["device"] == "cpu"
    assert 0 < rec["placed"] <= 256
    assert rec["committed_jobs"] * 8 == rec["placed"]
    assert len(rec["kernel_ms"]) == len(rec["place_ms"]) == 1


def test_place_with_queues_and_namespaces():
    out = _run("--device", "cpu", "--tasks", "200", "--nodes", "40",
               "--queues", "2", "--namespaces", "3", "--runs", "1")
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout)
    assert (rec["queues"], rec["namespaces"]) == (2, 3)
    assert rec["placed"] > 0


def test_place_without_device_needs_a_gpu():
    out = _run("--tasks", "64", "--nodes", "16")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""
