"""Clocks, device selection, synthetic clusters and test builders.

The submodules are imported by path (``utils.synth``, ``utils.platform``):
importing the package itself loads only the clock, which the object model
and the store read.
"""

from .clock import Clock, FakeClock, GLOBAL_CLOCK  # noqa: F401
