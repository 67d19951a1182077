"""Builds the CUDA kernels of csrc/ with nvcc on first use.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface,
``_build/lib<name>-<key>.so``, loaded with ctypes, with the compiler's
report (ptxas: registers, spills and shared memory of each kernel) beside
it in ``.log``. The key hashes the source and the flags, so a changed
source rebuilds and an unchanged one loads the library already built.
A source with a line ``// nvcc-parts: <n>`` is compiled n times at once,
with ``-DPART=<k> -DPARTS=<n>`` (each compile instantiating its share of
the kernels), and the n objects are linked into the one library.
Nothing is built when the package is imported: the first wrapper call
with a CUDA tensor builds, or ``build_all()`` builds every kernel ahead,
each source's compiles all started together (chip_smoke.py times it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


def parts(name: str) -> int:
    """How many compiles the source asks for (its ``// nvcc-parts: n``
    line; 1 without one)."""
    m = re.search(r"^// nvcc-parts: (\d+)$",
                  (SRC_DIR / f"{name}.cu").read_text(), re.M)
    return int(m.group(1)) if m else 1


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _commands(name: str, tmp: Path) -> List[List[str]]:
    """The compiles of ``name`` (run together), then the link if any."""
    src = str(SRC_DIR / f"{name}.cu")
    n = parts(name)
    if n == 1:
        return [[nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), src]]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [f"{tmp}.part{k}.o" for k in range(n)]
    compiles = [[nvcc(), *compile_flags, "-Xptxas", "-v", f"-DPART={k}",
                 f"-DPARTS={n}", "-c", "-o", obj, src]
                for k, obj in enumerate(objs)]
    return compiles + [[nvcc(), *NVCC_FLAGS, "-o", str(tmp), *objs]]


def _run_all(commands: List[List[str]]) -> List[subprocess.CompletedProcess]:
    """Run the commands at once; their results, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in commands]
    outs = [p.communicate()[0] for p in procs]
    return [subprocess.CompletedProcess(c, p.returncode, out)
            for c, p, out in zip(commands, procs, outs)]


def build(name: str) -> Path:
    """Build kernel ``name`` unless it is built already; returns its library
    path. Raises RuntimeError with nvcc's output when the build fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    commands = _commands(name, tmp)
    compiles, link = (commands, []) if len(commands) == 1 \
        else (commands[:-1], commands[-1:])
    try:
        done = _run_all(compiles)
        if all(p.returncode == 0 for p in done):
            done += _run_all(link)
    finally:
        for obj in tmp.parent.glob(f"{tmp.name}.part*.o"):
            obj.unlink()
    report_text = "".join(p.stdout for p in done)
    failed = [p for p in done if p.returncode != 0]
    if failed:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{failed[0].returncode}\n{report_text}")
    out.with_suffix(".log").write_text(report_text)
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
