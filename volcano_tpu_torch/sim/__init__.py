"""The simulator's fault injectors (faults), which the commit path's
tests and chip_smoke.py use; the rest of the reference's simulator
(volcano_tpu/sim) is not ported yet."""
