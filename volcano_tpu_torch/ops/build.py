"""Builds the CUDA kernels of csrc/ with nvcc on first use.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface,
``_build/lib<name>-<key>.so``, loaded with ctypes, with the compiler's
report (ptxas: registers, spills and shared memory of each kernel) beside
it in ``.log``. The key hashes the source and the flags, so a changed
source rebuilds and an unchanged one loads the library already built. Nothing is built when the package is
imported: the first wrapper call with a CUDA tensor builds, or
``build_all()`` builds every kernel ahead (chip_smoke.py times it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def sources() -> List[str]:
    """Names of every kernel source in csrc/."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> Path:
    """Build kernel ``name`` unless it is built already; returns its library
    path. Raises RuntimeError with nvcc's output when the build fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
         str(SRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)
    return out


def report(name: str) -> str:
    """The compiler's report of kernel ``name``'s build (built if need
    be): ptxas's registers, spills and shared memory of each kernel."""
    return build(name).with_suffix(".log").read_text()


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Build the named kernels (default: all of csrc/); {name: library}."""
    return {name: build(name)
            for name in (sources() if names is None else names)}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use and loaded once."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
