"""The in-memory object store the scheduler cache watches."""

from .store import ConflictError, ObjectStore  # noqa: F401
