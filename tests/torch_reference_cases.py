"""The reference's own test cases, run against the port.

``port_cases(path)`` loads a reference test module (``tests/test_*.py``)
with its imports of ``volcano_tpu`` pointed at ``volcano_tpu_torch`` and
returns the module: the same cases, asserting the same things, on the
port's objects. A test file of the port binds the classes and functions
it takes from it by name, so that pytest collects them there (and each
case counts once in that file).
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent


def port_cases(name: str, replace=()):
    """The reference test module ``tests/<name>.py`` on the port.
    ``replace`` is [(old, new)] text replacements applied after the
    package rename (a port name that differs, a test-only seam)."""
    src = (TESTS / f"{name}.py").read_text()
    src = re.sub(r"\bvolcano_tpu\b(?!_torch)", "volcano_tpu_torch", src)
    for old, new in replace:
        if old not in src:
            raise ValueError(f"{name}: {old!r} not found")
        src = src.replace(old, new)
    mod_name = f"tests._port_{name}"
    spec = importlib.util.spec_from_loader(mod_name, loader=None)
    mod = importlib.util.module_from_spec(spec)
    mod.__file__ = str(TESTS / f"{name}.py")
    sys.modules[mod_name] = mod
    exec(compile(src, f"<port of tests/{name}.py>", "exec"), mod.__dict__)
    return mod
