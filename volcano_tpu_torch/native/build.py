"""Builds the native engine, ``native/fastmodel.c``, with gcc at first use.

The source becomes a CPython extension module,
``volcano_tpu_torch/_build/fastmodel-<key>.so``, imported under its own
name (``volcano_tpu_torch_fastmodel``), so it never shadows another
package's ``fastmodel``. The key hashes the source, the compiler and its
flags, the Python version and the host's CPU, so a changed source, another
interpreter or another machine rebuilds, and an unchanged one imports the
library already built. Concurrent builders (test workers) each compile to
a file of their own and move it into place with ``os.replace``.

A failed build (no compiler, no ``Python.h``, a compile error) raises
RuntimeError with the compiler's output: nothing falls back to the Python
engine because a build failed.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import platform
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "native" / "fastmodel.c"
BUILD_DIR = PKG_DIR / "_build"
MODULE_NAME = "volcano_tpu_torch_fastmodel"
CC = "gcc"
CFLAGS = ["-O2", "-fPIC", "-shared"]

_lock = threading.Lock()
_module = None


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


def library_path() -> Path:
    """Where the library for this source, compiler, flags, Python and host
    lives (built or not)."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        [CC, *CFLAGS]).encode()).hexdigest()[:16]
    tag = f"py{sys.version_info[0]}{sys.version_info[1]}"
    return BUILD_DIR / f"fastmodel-{key}-{tag}-{_host_tag()}.so"


def build() -> Path:
    """Compile fastmodel.c unless it is built already; returns the library
    path. Raises RuntimeError with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    include = sysconfig.get_paths()["include"]
    cmd = [CC, *CFLAGS, f"-I{include}", "-o", str(tmp), str(SOURCE)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"fastmodel build failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"fastmodel build failed: {' '.join(cmd)} exited "
                           f"{r.returncode}\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


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
