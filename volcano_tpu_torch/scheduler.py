"""Scheduler: the periodic cycle driver (counterpart of
volcano_tpu/scheduler.py; reference: pkg/scheduler/scheduler.go): load the
conf, every period open a session, run the configured actions in order,
close the session.

The placement kernel runs on ``device``: the GPU unless the caller passes
``device="cpu"`` (the plain loop), and the constructor raises when there
is no GPU. Each cycle is recorded by the flight recorder (trace/tracer.py)
while tracing is on, feeds the metrics (metrics/metrics.py) always, and
is watched by the cycle watchdog. The cache runs the incremental
steady-state cycle by default (docs/design/incremental_cycle.md: a
persistent snapshot patched by dirty job and node, the quiet cycle, the
scoped allocate, resident node tensors); ``incremental=False`` forces the
full rebuild of every cycle.

``run_once`` brackets the cycle with the cache's ``begin_cycle`` and
``end_cycle``: once the cache runs, its executor writes the cycle's binds,
evictions and PodGroup statuses to the store after the cycle (readers of
the store call ``cache.flush_executors()`` first). ``run`` starts the
cache and the conf file watcher (``watch_conf``: a changed file is
reloaded within a second, and a conf that fails to parse, names no action
or an unknown one leaves the running conf in place) and, every
``anti_entropy_every`` cycles, runs the cache's anti-entropy pass in the
gap between cycles.

With an ``elector`` (utils/leaderelection.py) the scheduler is one of
several candidates: ``run_once`` does nothing on a standby but publish
the pending report's REASON_NOT_LEADER, and the cache stamps its writes
with the elector's fencing token (``fence_source``), so a deposed leader
cannot write after a takeover.
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
from .metrics import metrics as m
from .models.objects import DEFAULT_SCHEDULER_NAME
from .trace import ledger
from .utils import gcguard
from .utils.clock import Clock
from .utils.filewatcher import FileWatcher
from .utils.platform import default_device

log = logging.getLogger(__name__)


class Scheduler:
    # cycle watchdog (volcano_tpu/scheduler.py:26-33): a run_once over
    # watchdog_multiple x schedule_period wall seconds logs the in-flight
    # flight-recorder phase breakdown, bumps
    # volcano_cycle_deadline_exceeded_total and marks the scheduler
    # degraded on /debug/health until the next in-deadline cycle. It only
    # observes: the cycle is never interrupted.
    WATCHDOG_MULTIPLE = 4.0

    # the anti-entropy cadence of the run() loop: one cache<->store
    # fingerprint pass (docs/design/failover.md) every N cycles, between
    # cycles; 0 turns it off
    ANTI_ENTROPY_EVERY_CYCLES = 60

    def __init__(self, store: ObjectStore,
                 scheduler_name: str = DEFAULT_SCHEDULER_NAME,
                 scheduler_conf: Optional[str] = None,
                 scheduler_conf_path: Optional[str] = None,
                 schedule_period: float = 1.0,
                 cache: Optional[SchedulerCache] = None,
                 clock: Optional[Clock] = None,
                 watchdog_multiple: Optional[float] = None,
                 elector=None,
                 anti_entropy_every: Optional[int] = None,
                 device=None, incremental: Optional[bool] = None):
        self.store = store
        self.device = default_device(device)
        # time-dependent decisions read this clock via the session, so a
        # driver on a virtual clock stays coherent with the store's
        # creation timestamps
        self.clock = clock if clock is not None else store.clock
        self.cache = cache if cache is not None else SchedulerCache(
            store, scheduler_name)
        # leader election and fencing (docs/design/failover.md): a standby
        # skips its cycles, and the cache's writes carry the elector's
        # token unless the caller gave the cache a fence source of its own
        self.elector = elector
        if elector is not None and self.cache.fence_source is None:
            self.cache.fence_source = lambda: elector.fencing_token
        self.anti_entropy_every = (anti_entropy_every
                                   if anti_entropy_every is not None
                                   else self.ANTI_ENTROPY_EVERY_CYCLES)
        # the incremental steady-state cycle is the default, as in the
        # reference; incremental=False rebuilds the snapshot every cycle
        self.incremental = incremental if incremental is not None else True
        self.cache.incremental = self.incremental
        self.schedule_period = schedule_period
        self.watchdog_multiple = (watchdog_multiple
                                  if watchdog_multiple is not None
                                  else self.WATCHDOG_MULTIPLE)
        self.degraded = False
        self.cycle_deadline_exceeded = 0
        self._conf_path = scheduler_conf_path
        self._mutex = threading.Lock()
        # one stop event a start(): a thread of run() reads the event it
        # began with, so a stop and a later start (a lease lost and won
        # back) end the old loop and begin a new one
        self._stop = threading.Event()
        # held by run() for its whole loop: a new run waits for the
        # previous one's last cycle, so two loops never overlap
        self._run_lock = threading.Lock()
        self._watcher: Optional[FileWatcher] = None
        # the thread of run(), once start() began it
        self.thread: Optional[threading.Thread] = None
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

    def watch_conf(self) -> None:
        """Start the conf file's watcher (a 1 s mtime poll): each change
        reloads it through :meth:`load_scheduler_conf`."""
        if self._conf_path is None:
            return
        self._watcher = FileWatcher(self._conf_path,
                                    on_change=self.load_scheduler_conf)
        self._watcher.start()

    def run_once(self) -> None:
        """One scheduling cycle (scheduler.go:90-110).

        The cyclic garbage collector is paused for the cycle, as in the
        reference: a 50k-task snapshot churns millions of acyclic objects
        that reference counting frees, and a full collection in the middle
        of the cycle would walk the whole cluster's object graph.
        ``last_cycle`` keeps the cycle's timing split (wall ms): the
        snapshot, the rest of open_session, each action, the allocate
        action's own phases, close_session, and each placement solve's
        encode, solve, kernel and decode, its launches, its kernel plan
        and R, and its prune summary (``BatchSolver.stats``);
        ``pipelined`` counts the tasks left Pipelined at close
        (``last_pipelined`` maps them to their nodes) and ``victim_runs``
        preempt's and reclaim's placements by victim-selection path;
        ``mode`` is the snapshot's ("full", "incremental", or "legacy" for
        the full rebuild of ``incremental=False``), ``patched_jobs`` and
        ``patched_nodes`` count what it re-cloned and ``quiet`` says
        whether the session took the quiet path.

        With tracing on (trace/tracer.py) the cycle is one flight-recorder
        record: the root span ``cycle`` tagged with the session's jobs,
        nodes and queues, one ``action:<name>`` span an action, and a
        metrics time-series sample after it.

        On a standby (an ``elector`` that does not lead) the cycle does
        nothing but publish REASON_NOT_LEADER on the pending report."""
        from .trace import tracer as tr
        if self.elector is not None and not self.elector.is_leader:
            # scheduling is the leader's; say so on /debug/pending rather
            # than doing nothing in silence
            from .trace import pending
            pending.publish_idle(
                pending.REASON_NOT_LEADER,
                detail=f"candidate {self.elector.identity!r} is waiting "
                       f"on the lease")
            return
        with self._mutex:
            conf = self.conf
        start = time.perf_counter()
        deadline = self.schedule_period * self.watchdog_multiple
        timer: Optional[threading.Timer] = None
        if deadline > 0:
            timer = threading.Timer(deadline, self._watchdog_fire,
                                    args=(deadline,))
            timer.daemon = True
            timer.start()
        gcguard.pause()
        self.cache.begin_cycle()
        try:
            with tr.cycle():
                t0 = time.perf_counter()
                ssn = open_session(self.cache, conf.tiers,
                                   conf.configurations, clock=self.clock,
                                   device=self.device, actions=conf.actions)
                tr.tag_cycle(jobs=len(ssn.jobs), nodes=len(ssn.nodes),
                             queues=len(ssn.queues))
                stats = self.cache.last_snapshot_stats \
                    if self.incremental else {}
                if stats:
                    # the snapshot's mode and the dirty-set sizes it
                    # consumed
                    tr.tag_cycle(mode=stats["mode"],
                                 dirty_jobs=stats["dirty_jobs"],
                                 dirty_nodes=stats["dirty_nodes"],
                                 quiet=stats["quiet"])
                tick = time.perf_counter()
                split = {"open_session_ms": (tick - t0) * 1000.0
                         - self.cache.last_snapshot_ms,
                         "snapshot_ms": self.cache.last_snapshot_ms,
                         "mode": stats.get("mode", "legacy"),
                         "patched_jobs": stats.get("patched_jobs"),
                         "patched_nodes": stats.get("patched_nodes"),
                         "quiet": ssn.quiet_cycle}
                try:
                    for name in conf.actions:
                        action = get_action(name)
                        if action is not None:
                            with m.action_timer(name), \
                                    tr.span(f"action:{name}", action=name):
                                action.execute(ssn)
                        now = time.perf_counter()
                        split[f"{name}_ms"] = (now - tick) * 1000.0
                        tick = now
                    self.last_pipelined = ssn.pipelined_tasks()
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
            self.cache.end_cycle()
            gcguard.resume()
            elapsed = time.perf_counter() - start
            if timer is not None:
                timer.cancel()
                if self.degraded and elapsed <= deadline:
                    # recovered: this cycle came in under the deadline
                    self.degraded = False
                    m.set_health("scheduler", True,
                                 "cycle time back under the watchdog "
                                 "deadline")
        m.update_e2e_duration(elapsed)
        # the lifecycle ledger's stamps held in the cycle complete on the
        # flush executor, after the cycle's binds
        if ledger.is_enabled():
            self.cache.submit_background(ledger.complete_deferred)
        if tr.is_enabled():
            # /debug/timeseries: one sample of the key gauges and counters
            # a cycle, on the flight recorder's switch
            from .metrics import timeseries
            timeseries.sample(self.clock.now(), extra={
                "cycle_ms": round(elapsed * 1000.0, 3),
                "seq": tr.current_seq()})

    def _watchdog_fire(self, deadline: float) -> None:
        """The cycle blew its watchdog deadline: record the breach and the
        stuck cycle's flight-recorder phase breakdown. Observation only:
        the cycle runs on, and the next in-deadline cycle clears the
        degraded mark."""
        from .trace import tracer as tr
        self.degraded = True
        self.cycle_deadline_exceeded += 1
        m.inc(m.CYCLE_DEADLINE_EXCEEDED)
        detail = (f"scheduling cycle exceeded its {deadline:.2f}s watchdog "
                  f"deadline ({self.watchdog_multiple:g}x the "
                  f"{self.schedule_period:g}s period)")
        m.set_health("scheduler", False, detail)
        phases = tr.live_phases()
        log.error("cycle watchdog: %s; in-flight phases: %s", detail,
                  phases if phases else "(tracing disabled)")

    def run(self) -> None:
        """Start cache ingestion (once a process) and the conf watcher,
        then run a cycle every period until stop(), with the anti-entropy
        pass every ``anti_entropy_every`` cycles between them."""
        stop = self._stop
        with self._run_lock:
            self.cache.run()
            self.watch_conf()
            try:
                self._loop(stop)
            finally:
                if self._watcher is not None:
                    self._watcher.stop()

    def _loop(self, stop: threading.Event) -> None:
        # long-lived startup objects never need cycle detection: freezing
        # them keeps the collections between cycles proportional to the
        # cycle's garbage, not to the cluster's size
        gc.collect()
        gc.freeze()
        cycles = 0
        while not stop.is_set():
            start = time.monotonic()
            try:
                self.run_once()
            except Exception:
                # a transient failure (e.g. a status-writeback conflict)
                # must not kill the scheduling thread; the next cycle
                # resyncs from the cache
                log.exception("scheduling cycle failed; retrying next period")
            cycles += 1
            if self.anti_entropy_every and \
                    cycles % self.anti_entropy_every == 0:
                try:
                    # the executor may still be draining: a staged but
                    # uncommitted bind does not show in the fingerprints
                    self.cache.anti_entropy()
                except Exception:
                    log.exception("anti-entropy pass failed; the next "
                                  "interval retries")
            gc.collect(0)   # the cycle's garbage with true reference cycles
            elapsed = time.monotonic() - start
            stop.wait(max(0.0, self.schedule_period - elapsed))

    def start(self) -> threading.Thread:
        """Run :meth:`run` on a thread of its own (``self.thread``) under
        a fresh stop event, so that a scheduler stopped by a lost lease
        schedules again when it wins the lease back."""
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self.run, name="scheduler",
                                       daemon=True)
        self.thread.start()
        return self.thread

    def stop(self) -> None:
        """End the cycle loop after its current cycle and stop the conf
        watcher."""
        self._stop.set()
        if self._watcher is not None:
            self._watcher.stop()
