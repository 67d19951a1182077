"""Refcounted pause and resume of the cyclic garbage collector (this
port's own copy of volcano_tpu/utils/gcguard.py).

Two code paths turn the collector off around bursts of object churn: the
scheduling cycle (a full collection in the middle of a 50,000-task cycle
walks the whole cluster's object graph; Scheduler.run_once) and the cache
executor's drain bursts (a bind flush churns millions of acyclic
objects). They overlap on different threads, so bare gc.disable() and
gc.enable() pairs would race and turn collection back on in the middle of
a burst; this guard nests.

The collector comes back only when the last pause is released, and only
if it was on at the first pause (a process that turned GC off stays so).
The bursts' garbage is almost all acyclic and freed by reference
counting; true cycles are collected by the scheduler loop's collection
between cycles (Scheduler.run) or at the next natural threshold.
"""

from __future__ import annotations

import gc
import threading

_lock = threading.Lock()
_depth = 0
_was_enabled = False


def pause() -> None:
    global _depth, _was_enabled
    with _lock:
        _depth += 1
        if _depth == 1:
            _was_enabled = gc.isenabled()
            if _was_enabled:
                gc.disable()


def resume() -> None:
    global _depth
    with _lock:
        if _depth == 0:
            return   # an unbalanced release never turns collection on
        _depth -= 1
        if _depth == 0 and _was_enabled:
            gc.enable()
