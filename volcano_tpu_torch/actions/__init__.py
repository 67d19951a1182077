"""Builtin actions of the port (reference: pkg/scheduler/actions/
factory.go:30-38): enqueue, allocate, backfill, preempt, reclaim, elect
and reserve. Importing this package registers them."""

from . import allocate  # noqa: F401
from . import backfill  # noqa: F401
from . import elect  # noqa: F401
from . import enqueue  # noqa: F401
from . import preempt  # noqa: F401
from . import reclaim  # noqa: F401
from . import reserve  # noqa: F401
