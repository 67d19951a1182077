"""Scheduler: the periodic cycle driver (counterpart of
volcano_tpu/scheduler.py; reference: pkg/scheduler/scheduler.go): load the
conf, every period open a session, run the configured actions in order,
close the session.

The placement kernel runs on ``device``: the GPU unless the caller passes
``device="cpu"`` (the plain loop), and the constructor raises when there
is no GPU. Left out of this port: the cycle watchdog, leader election and
fencing, anti-entropy, the conf file watcher, the tracer and the metrics.
"""

from __future__ import annotations

import gc
import logging
import threading
import time
from typing import Dict, Optional

from .apiserver.store import ObjectStore
from .cache import SchedulerCache
from .framework import (close_session, default_scheduler_conf, get_action,
                        open_session, parse_scheduler_conf)
from .models.job_info import TaskStatus
from .models.objects import DEFAULT_SCHEDULER_NAME
from .utils.clock import Clock
from .utils.platform import default_device

log = logging.getLogger(__name__)


class Scheduler:
    def __init__(self, store: ObjectStore,
                 scheduler_name: str = DEFAULT_SCHEDULER_NAME,
                 scheduler_conf: Optional[str] = None,
                 scheduler_conf_path: Optional[str] = None,
                 schedule_period: float = 1.0,
                 cache: Optional[SchedulerCache] = None,
                 clock: Optional[Clock] = None,
                 device=None):
        self.store = store
        self.device = default_device(device)
        # time-dependent decisions read this clock via the session, so a
        # driver on a virtual clock stays coherent with the store's
        # creation timestamps
        self.clock = clock if clock is not None else store.clock
        self.cache = cache if cache is not None else SchedulerCache(
            store, scheduler_name)
        self.schedule_period = schedule_period
        self._conf_path = scheduler_conf_path
        self._mutex = threading.Lock()
        self._stop = threading.Event()
        self.last_cycle: dict = {}
        # "namespace/name" -> node of the tasks the last cycle left
        # Pipelined (preempt's and reclaim's placements onto releasing
        # capacity live only in the session until a later cycle binds them)
        self.last_pipelined: Dict[str, str] = {}
        if scheduler_conf is not None:
            self.conf = parse_scheduler_conf(scheduler_conf)
        elif scheduler_conf_path is not None:
            with open(scheduler_conf_path) as f:
                self.conf = parse_scheduler_conf(f.read())
        else:
            self.conf = default_scheduler_conf()

    def load_scheduler_conf(self) -> None:
        """Re-read the conf file; keep the previous conf on parse errors
        (validation-or-keep-previous, scheduler.go:122-135)."""
        if self._conf_path is None:
            return
        try:
            with open(self._conf_path) as f:
                new_conf = parse_scheduler_conf(f.read())
            if not new_conf.actions:
                # an empty document (e.g. the file read mid-rewrite) parses
                # cleanly but is never a valid scheduler conf
                raise ValueError("conf has no actions")
            for name in new_conf.actions:
                if get_action(name) is None:
                    raise ValueError(f"unknown action {name!r}")
            with self._mutex:
                self.conf = new_conf
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError) as e:
            log.warning("scheduler conf reload failed, keeping previous: %s",
                        e)

    def run_once(self) -> None:
        """One scheduling cycle (scheduler.go:90-110).

        The cyclic garbage collector is paused for the cycle, as in the
        reference: a 50k-task snapshot churns millions of acyclic objects
        that reference counting frees, and a full collection in the middle
        of the cycle would walk the whole cluster's object graph.
        ``last_cycle`` keeps the cycle's timing split (wall ms): the
        snapshot, the rest of open_session, each action, the allocate
        action's own phases, close_session, and each placement solve's
        encode, solve, kernel and decode; ``pipelined`` counts the tasks
        left Pipelined at close (``last_pipelined`` maps them to their
        nodes) and ``victim_runs`` preempt's and reclaim's placements by
        victim-selection path."""
        with self._mutex:
            conf = self.conf
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            t0 = time.perf_counter()
            ssn = open_session(self.cache, conf.tiers, conf.configurations,
                               clock=self.clock, device=self.device)
            tick = time.perf_counter()
            split = {"open_session_ms": (tick - t0) * 1000.0
                     - self.cache.last_snapshot_ms,
                     "snapshot_ms": self.cache.last_snapshot_ms}
            try:
                for name in conf.actions:
                    action = get_action(name)
                    if action is not None:
                        action.execute(ssn)
                    now = time.perf_counter()
                    split[f"{name}_ms"] = (now - tick) * 1000.0
                    tick = now
                self.last_pipelined = {
                    t.key(): t.node_name for job in ssn.jobs.values()
                    for t in job.task_status_index.get(
                        TaskStatus.Pipelined, {}).values()}
                split["pipelined"] = len(self.last_pipelined)
                tick = time.perf_counter()
            finally:
                close_session(ssn)
            end = time.perf_counter()
            split["close_session_ms"] = (end - tick) * 1000.0
            split["cycle_ms"] = (end - t0) * 1000.0
            split.update({f"{k}_ms": v for k, v in ssn.timings.items()})
            split["places"] = list(ssn.solver.stats)
            split["victim_runs"] = dict(ssn.victim_runs)
            self.last_cycle = split
        finally:
            if was_enabled:
                gc.enable()

    def run(self) -> None:
        """Start cache ingestion, then run a cycle every period until
        stop()."""
        self.cache.run()
        # long-lived startup objects never need cycle detection: freezing
        # them keeps the collections between cycles proportional to the
        # cycle's garbage, not to the cluster's size
        gc.collect()
        gc.freeze()
        while not self._stop.is_set():
            start = time.monotonic()
            try:
                self.run_once()
            except Exception:
                # a transient failure (e.g. a status-writeback conflict)
                # must not kill the scheduling thread; the next cycle
                # resyncs from the cache
                log.exception("scheduling cycle failed; retrying next period")
            gc.collect(0)   # the cycle's garbage with true reference cycles
            elapsed = time.monotonic() - start
            self._stop.wait(max(0.0, self.schedule_period - elapsed))

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()
