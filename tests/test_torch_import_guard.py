"""The PyTorch/CUDA port stands alone: every module of volcano_tpu_torch
imports with jax blocked and loads no module of the JAX package, and
chip_smoke.py imports neither. Entry points need a GPU unless the caller
names another device."""

import ast
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
# placement-constraint layer and the preempt/reclaim path included
CYCLE_MODULES = ("volcano_tpu_torch.apiserver.store",
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
                 "volcano_tpu_torch.scheduler",
                 "volcano_tpu_torch.cmd.cycle")


def _is_reference(module: str) -> bool:
    """volcano_tpu or volcano_tpu.*, but not volcano_tpu_torch."""
    return module == "volcano_tpu" or module.startswith("volcano_tpu.")


def test_every_port_module_imports_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, walked = out.stdout.strip().split("\n")
    count, leaked = first.split(" ", 1)
    assert int(count) >= 65, out.stdout
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
