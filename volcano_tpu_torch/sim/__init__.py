"""Cluster churn simulator (the port of volcano_tpu/sim): an event-driven
workload/fault harness that drives the real scheduler (cache, store,
actions, plugins — no mocks) under a virtual clock, audits invariants
after every tick, and shrinks any failure to a deterministic
``{seed, tick}`` repro.

``python -m volcano_tpu_torch.sim.cli run|smoke|chaos|failover|obs|incr|
constraints|explain|prune|replay`` are the entry points; each takes
``--device`` (the card by default, ``cpu`` for the kernels' plain
versions). The ``mesh``, ``storm``, ``durability`` and ``federation``
verbs wait for the layers they drive.

Attribute access is lazy (PEP 562): importing the package does not drag
the whole scheduler stack in.
"""

_EXPORTS = {
    "DEFAULT_CONF": "engine", "SimConfig": "engine", "SimEngine": "engine",
    "SimResult": "engine", "run_sim": "engine",
    "Event": "events", "EventQueue": "events", "make_event": "events",
    "FaultConfig": "faults", "FlakyBinder": "faults",
    "CycleContext": "invariants", "Violation": "invariants",
    "check_all": "invariants",
    "load_bundle": "replay", "replay_bundle": "replay",
    "write_repro_bundle": "replay",
    "WorkloadConfig": "workload", "dump_trace": "workload",
    "load_trace": "workload",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(f".{module}", __name__)
    value = getattr(mod, name)
    globals()[name] = value   # cache: subsequent access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
