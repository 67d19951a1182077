"""Padding of the dense snapshot arrays (counterpart of
volcano_tpu/models/arrays.py; the TaskBatch/NodeArrays encode is ported
with the object path)."""

from __future__ import annotations


def bucket(n: int, size: int) -> int:
    """Round up to a bucket boundary (>= 1 bucket) for stable shapes."""
    return max(size, ((n + size - 1) // size) * size)
