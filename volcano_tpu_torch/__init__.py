"""volcano-tpu-torch: the PyTorch/CUDA port of volcano_tpu's placement solve.

The per-cycle placement math of the JAX package, rewritten in PyTorch for
one NVIDIA H100: the encoded snapshot, static predicate masks and scores,
the gang-allocate loop as a hand-written CUDA kernel, and the decoded
per-job result. The package imports torch and numpy only; it never
imports jax or volcano_tpu, and keeps its own copy of what it needs.

Layout (mirrors volcano_tpu/ so each module's counterpart is easy to find):
  models/     -- bucket padding of the dense arrays
  utils/      -- device selection and the synthetic cluster generator
  ops/        -- fit, score, fair share, the plain gang-allocate loop and the
                 CUDA kernel's wrapper and build
  csrc/       -- the CUDA C++ kernel sources (built on first use)
  framework/  -- DenseSolver: masks, scores, kernel and decode
  convert.py  -- the reference package's numpy arrays to this port's tensors
  cmd/        -- command-line entry points
"""

from .version import VERSION  # noqa: F401
