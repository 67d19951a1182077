"""The scheduler cache: store watches in, per-cycle snapshots out, binds
and PodGroup statuses back to the store."""

from .cache import SchedulerCache  # noqa: F401
