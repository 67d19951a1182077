"""Device selection and synthetic clusters."""

from .platform import default_device  # noqa: F401
from .synth import SynthArrays, synth_arrays  # noqa: F401
