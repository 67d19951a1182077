"""Multi-tenant serving hub (the port's own copy of
volcano_tpu/serving/, docs/design/serving.md).

The apiserver/RemoteStore seam used to be a single-threaded convenience:
one long-poll thread per client, a fresh connection per write, no notion
of a tenant. This package turns that seam into a serving layer that
survives thousands of concurrent watchers:

* :mod:`.hub` — the sharded watch hub: N dispatch shards (hash by client
  id), every subscriber carrying a persistent cursor into the store's
  rv-sorted gap-free journal, coalesced event-batch frames (one delivery
  per burst), server-side kind/field filters with the store's filter-flip
  lifecycle semantics, and a structured ``relist`` signal when a cursor
  falls off the journal window.
* :mod:`.admission` — tenant identity + token-bucket rate limits and
  max-subscription caps at the write/watch edge (HTTP 429 with
  Retry-After; ``volcano_serving_*`` metrics).
* :mod:`.storm` — the watcher-storm gate runner
  (``python -m volcano_tpu_torch.sim.cli storm``): 1k+ subscribers with seeded frame-drop faults
  through a bind-flush storm, asserting cursor convergence, zero gaps,
  throttling and bit-identical double runs.

``set_active``/``serving_report`` register the process's live hub +
admission controller so the metrics server can expose them on
``/debug/serving`` without holding references through import cycles.
"""

from __future__ import annotations

_ACTIVE = {"hub": None, "admission": None}


def set_active(hub=None, admission=None) -> None:
    """Register the live hub/admission pair for /debug/serving (either
    may be None; a later call replaces only what it names)."""
    if hub is not None:
        _ACTIVE["hub"] = hub
    if admission is not None:
        _ACTIVE["admission"] = admission


def clear_active() -> None:
    _ACTIVE["hub"] = None
    _ACTIVE["admission"] = None


def serving_report() -> dict:
    """The /debug/serving payload: hub shard depths + fan-out latency
    percentiles and per-tenant admission counters, from whatever is
    registered (empty sections when nothing is)."""
    hub = _ACTIVE["hub"]
    adm = _ACTIVE["admission"]
    return {
        "hub": hub.report() if hub is not None else None,
        "admission": adm.report() if adm is not None else None,
    }
