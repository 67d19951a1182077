"""Dense-array helpers of the snapshot encoding."""

from .arrays import bucket  # noqa: F401
