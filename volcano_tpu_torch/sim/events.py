"""Event model for the cluster churn simulator (the port's own copy of
volcano_tpu/sim/events.py).

Events are plain data records — ``{"at": <virtual seconds>, "kind": ...,
**payload}`` — interpreted against the object store by the engine
(:mod:`.engine`). Keeping them data (not callables) buys the two
properties the simulator exists for: the synthetic generators
(:mod:`.workload`, :mod:`.faults`) and a JSONL trace replay produce the
*same* stream type, and any run can dump its applied stream verbatim as
a replayable repro bundle (:mod:`.replay`).

Kinds interpreted by the engine:

``job_arrival``    name, namespace, queue, size, min_available, cpu, mem,
                   duration (virtual seconds of service after full bind),
                   priority_class; optional placement constraints
                   (docs/design/constraints.md): spread_key/spread_skew/
                   spread_mode ("hard"|"soft") put a topology-spread
                   constraint on every pod of the gang, anti_key puts a
                   required self-anti-affinity term over that topology
                   key (one replica per domain)
``job_complete``   name, namespace — gang finishes as a unit (MPI-style):
                   pods + podgroup deleted
``pod_fail``       name, namespace, task — one pod dies (marks the job
                   churn-dirty for the gang-atomicity check)
``node_add``       name, cpu, mem, pods
``node_drain``     name — spec.unschedulable = True
``node_undrain``   name
``node_kill``      name — node deleted outright, resident pods die with
                   it (lost VM)
``evict_storm``    fraction, seed — delete that fraction of bound pods
``fault_set``      bind_fail_rate, api_latency_s — retune live injection
``scheduler_kill`` mode ("stateless"|"snapshot"), mid_flush_binds —
                   crash the scheduler (optionally partway through its
                   bind flush) and restart it at the tick barrier
                   (docs/design/failover.md)
``leader_lapse``   mode, mid_flush_binds — the leader dies WITHOUT
                   releasing its lease; a fresh candidate identity waits
                   out the lease before leading, and the deposed
                   incarnation's leftover write is fenced at takeover
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional


class Event(dict):
    """An event record. A dict subclass so JSONL (de)serialization is the
    identity; ``at``/``kind`` accessors are sugar."""

    @property
    def at(self) -> float:
        return float(self["at"])

    @property
    def kind(self) -> str:
        return self["kind"]


def make_event(at: float, kind: str, **payload) -> Event:
    e = Event(payload)
    e["at"] = float(at)
    e["kind"] = kind
    return e


class EventQueue:
    """Min-heap of events ordered by (at, insertion sequence).

    The explicit sequence tie-break makes same-timestamp ordering a
    function of generation order alone — never of heap internals — which
    the bit-identical-replay contract depends on.
    """

    def __init__(self, events: Optional[Iterable[Event]] = None):
        self._heap: List[tuple] = []
        self._seq = 0
        for e in events or ():
            self.push(e)

    def push(self, event: Event) -> None:
        heapq.heappush(self._heap, (event.at, self._seq, event))
        self._seq += 1

    def pop_until(self, now: float) -> List[Event]:
        """All events with ``at <= now``, in (at, seq) order."""
        out: List[Event] = []
        while self._heap and self._heap[0][0] <= now:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def __len__(self) -> int:
        return len(self._heap)

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None


def validate_event(e: Dict) -> None:
    """Raise ValueError on a malformed record (trace-replay ingestion
    guard: a truncated JSONL line must fail loudly, not schedule garbage)."""
    if "at" not in e or "kind" not in e:
        raise ValueError(f"event missing at/kind: {e!r}")
    if not isinstance(e["kind"], str) or not e["kind"]:
        raise ValueError(f"event kind must be a non-empty string: {e!r}")
    try:
        float(e["at"])
    except (TypeError, ValueError):
        raise ValueError(f"event at must be a number: {e!r}")
