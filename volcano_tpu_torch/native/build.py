"""Builds the native libraries at first use: the native engine
``native/fastmodel.c`` with gcc, and the native CPU solver
``native/solver.cc`` with g++.

``fastmodel.c`` becomes a CPython extension module,
``volcano_tpu_torch/_build/fastmodel-<key>.so``, imported under its own
name (``volcano_tpu_torch_fastmodel``), so it never shadows another
package's ``fastmodel``. ``solver.cc`` becomes a plain shared library,
``volcano_tpu_torch/_build/libvcsolver-<key>.so``, with a C entry point
loaded through ctypes (ops/native.py); it needs no ``Python.h``.

Each key hashes the source, the compiler and its flags (and, for the
extension, the Python version) and the host's CPU, so a changed source,
compiler, interpreter or machine rebuilds, and an unchanged one loads the
library already built. Concurrent builders (test workers) each compile to
a file of their own and move it into place with ``os.replace``.

The solver's flags: ``-O3 -march=native`` (the key's host tag keeps a
library on the CPU it was built for), ``-ffp-contract=off`` given
explicitly, since GCC's GNU-mode default is ``fast`` and would fuse a
multiply into an add where ops/score.py rounds twice,
``-fno-trapping-math -fno-math-errno`` so that the sweep's masked
divisions vectorize (each lane still rounds as IEEE single precision),
and no ``-ffast-math``: the solver's scores equal the plain loop's bit for
bit.

A failed build (no compiler, no ``Python.h``, a compile error) raises
RuntimeError with the compiler's output: nothing falls back to another
engine or route because a build failed.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import platform
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "native" / "fastmodel.c"
SOLVER_SOURCE = PKG_DIR / "native" / "solver.cc"
BUILD_DIR = PKG_DIR / "_build"
MODULE_NAME = "volcano_tpu_torch_fastmodel"
CC = "gcc"
CFLAGS = ["-O2", "-fPIC", "-shared"]
CXX = "g++"
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-ffp-contract=off",
            "-fno-trapping-math", "-fno-math-errno", "-fPIC", "-shared"]

_lock = threading.Lock()
_module = None
_solvers: Dict[Path, ctypes.CDLL] = {}


def _host_tag() -> str:
    """The machine and its CPU's model and flags, hashed: a library built
    on one host is never loaded on another."""
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    cpu += line
                    if cpu.count("\n") >= 2:
                        break
    except OSError:
        pass
    return platform.machine() + "-" + hashlib.sha256(
        (platform.machine() + cpu).encode()).hexdigest()[:8]


def _key(source: Path, cmd: List[str]) -> str:
    return hashlib.sha256(source.read_bytes()
                          + " ".join(cmd).encode()).hexdigest()[:16]


def library_path() -> Path:
    """Where the extension for this source, compiler, flags, Python and
    host lives (built or not)."""
    tag = f"py{sys.version_info[0]}{sys.version_info[1]}"
    return BUILD_DIR / (f"fastmodel-{_key(SOURCE, [CC, *CFLAGS])}-{tag}-"
                        f"{_host_tag()}.so")


def solver_path() -> Path:
    """Where the solver library for this source, compiler, flags and host
    lives (built or not)."""
    key = _key(SOLVER_SOURCE, [CXX, *CXXFLAGS])
    return BUILD_DIR / f"libvcsolver-{key}-{_host_tag()}.so"


def _compile(what: str, compiler: List[str], source: Path,
             out: Path) -> Path:
    """Compile ``source`` with ``compiler`` (the command and its flags)
    unless ``out`` exists, into a file of this process's own, then move
    it into place."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [*compiler, "-o", str(tmp), str(source)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"{what} build failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} build failed: {' '.join(cmd)} exited "
                           f"{r.returncode}\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def build() -> Path:
    """Compile fastmodel.c unless it is built already; returns the library
    path. Raises RuntimeError with the compiler's output on failure."""
    include = sysconfig.get_paths()["include"]
    return _compile("fastmodel", [CC, *CFLAGS, f"-I{include}"], SOURCE,
                    library_path())


def build_solver() -> Path:
    """Compile solver.cc unless it is built already; returns the library
    path. Raises RuntimeError with the compiler's output on failure."""
    return _compile("native solver", [CXX, *CXXFLAGS], SOLVER_SOURCE,
                    solver_path())


def fastmodel():
    """The native engine's module, built on first use and imported once."""
    global _module
    with _lock:
        if _module is None:
            path = build()
            spec = importlib.util.spec_from_file_location(MODULE_NAME,
                                                          str(path))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _module = mod
        return _module


def solver() -> ctypes.CDLL:
    """The native solver's library for the current source, compiler and
    flags, built on first use and loaded once."""
    with _lock:
        path = solver_path()
        lib = _solvers.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(build_solver()))
            _solvers[path] = lib
        return lib
