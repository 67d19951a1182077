"""Version of the PyTorch/CUDA port (counterpart of volcano_tpu/version.py;
reference: pkg/version/version.go)."""

from __future__ import annotations

import platform
import sys

VERSION = "0.1.0"
API_VERSION = "v1alpha1"


def version_string() -> str:
    import torch
    return (f"volcano-tpu-torch version: {VERSION}\n"
            f"API version: {API_VERSION}\n"
            f"Python version: {sys.version.split()[0]}\n"
            f"PyTorch version: {torch.__version__}\n"
            f"Platform: {platform.system().lower()}/{platform.machine()}")


def print_version_and_exit() -> None:
    print(version_string())
    raise SystemExit(0)
