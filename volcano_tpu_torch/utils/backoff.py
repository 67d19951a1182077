"""Seeded-jitter exponential backoff (this port's own copy of
volcano_tpu/utils/backoff.py; docs/design/resilience.md).

The cache's bind-failure re-placement schedule reads it, so the schedule
is deterministic for a fixed (key, attempt, seed): the delay is
``base * 2^(attempt-1)`` capped at ``cap``, jittered into [0.5, 1.0) of
itself by a crc32 hash (never ``random``: two runs from one seed must
schedule identical retries, and crc32 does not depend on
PYTHONHASHSEED).
"""

from __future__ import annotations

import zlib


def seeded_backoff(key: str, attempt: int, base: float, cap: float,
                   seed: int = 0) -> float:
    """Delay in seconds before the ``attempt``-th retry of ``key``
    (attempts count from 1). ``base <= 0`` turns backoff off, for tests
    that retry back to back on a wall clock."""
    if base <= 0.0:
        return 0.0
    delay = min(cap, base * (2.0 ** (attempt - 1)))
    h = zlib.crc32(f"{key}:{attempt}:{seed}".encode())
    return delay * (0.5 + (h % 4096) / 8192.0)   # [0.5, 1.0) * delay
