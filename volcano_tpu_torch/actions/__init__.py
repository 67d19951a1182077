"""Builtin actions of the port (reference: pkg/scheduler/actions/
factory.go:30-38): enqueue, allocate, preempt, reclaim and backfill.
Importing this package registers them."""

from . import allocate  # noqa: F401
from . import backfill  # noqa: F401
from . import enqueue  # noqa: F401
from . import preempt  # noqa: F401
from . import reclaim  # noqa: F401
