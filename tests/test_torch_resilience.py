"""The commit path's resilience in the port, held against the JAX package:
Resync's backoff, retry budget and quarantine, gang-atomic bind healing
(tests/test_resilience.py:87-322), lease fencing of every store write
form and of a deposed leader's flush (tests/test_failover.py's
TestStoreFencing and TestDeposedFlush) and the cache<->store anti-entropy
pass (TestAntiEntropy).

Each case runs one scenario, on a FakeClock threaded through the store,
through both packages (the port's Scheduler on the CPU) with the
executor live unless the case says otherwise, reads what it observes
after ``flush_executors()`` (binds, pod statuses, retry records with
their attempts and ``not_before``, quarantine, heals, fenced writes,
events, anti-entropy reports) and requires the two to be equal, then
holds the port to the reference test's own assertions.

Tolerance: exact (the virtual clock makes every backoff instant exact).
"""

import threading
import time
from types import SimpleNamespace

import pytest

from volcano_tpu import framework as ref_framework
from volcano_tpu.apiserver import ObjectStore as RefStore
from volcano_tpu.apiserver.store import FencedError as RefFencedError
from volcano_tpu.cache import SchedulerCache as RefCache
from volcano_tpu.metrics import metrics as ref_m
from volcano_tpu.models.job_info import TaskStatus as RefStatus
from volcano_tpu.scheduler import Scheduler as RefScheduler
from volcano_tpu.sim import faults as ref_faults
from volcano_tpu.trace import pending as ref_pending
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu.utils.clock import FakeClock as RefClock
from volcano_tpu_torch import framework as port_framework
from volcano_tpu_torch.apiserver import ObjectStore as PortStore
from volcano_tpu_torch.apiserver.store import FencedError as PortFencedError
from volcano_tpu_torch.cache import SchedulerCache as PortCache
from volcano_tpu_torch.metrics import metrics as port_m
from volcano_tpu_torch.models.job_info import TaskStatus as PortStatus
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler
from volcano_tpu_torch.sim import faults as port_faults
from volcano_tpu_torch.trace import pending as port_pending
from volcano_tpu_torch.utils import test_utils as port_tu
from volcano_tpu_torch.utils.clock import FakeClock as PortClock

CONF = """
actions: "enqueue, allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""

REF = SimpleNamespace(
    name="ref", Store=RefStore, Cache=RefCache, Scheduler=RefScheduler,
    tu=ref_tu, faults=ref_faults, Clock=RefClock, m=ref_m,
    pending=ref_pending, framework=ref_framework, Status=RefStatus,
    FencedError=RefFencedError, sched_kw={},
    write_kw={"skip_admission": True})
PORT = SimpleNamespace(
    name="port", Store=PortStore, Cache=PortCache, Scheduler=PortScheduler,
    tu=port_tu, faults=port_faults, Clock=PortClock, m=port_m,
    pending=port_pending, framework=port_framework, Status=PortStatus,
    FencedError=PortFencedError, sched_kw={"device": "cpu"}, write_kw={})


def both(fn):
    """``fn(side)`` for the reference and the port; both results."""
    return fn(REF), fn(PORT)


def rl(side):
    return side.tu.build_resource_list("1", "1Gi")


class Env:
    """A FakeClock store, a cache with a FlakyBinder (targeted failures)
    and a Scheduler of one side; ``run=False`` keeps the cache inline."""

    def __init__(self, side, fail_pods=(), nodes=4, node_cpu="8", run=True,
                 fence_source=None):
        side.m.reset()
        self.side = side
        self.clock = side.Clock(start=1.0)
        self.store = store = side.Store(clock=self.clock)
        self.binder = side.faults.FlakyBinder(store, self.clock,
                                              fail_pods=set(fail_pods))
        self.cache = side.Cache(store, binder=self.binder,
                                evictor=side.tu.FakeEvictor(store),
                                fence_source=fence_source)
        if run:
            self.cache.run()
        self.sched = side.Scheduler(store, scheduler_conf=CONF,
                                    cache=self.cache, clock=self.clock,
                                    **side.sched_kw)
        store.create("queues", side.tu.build_queue("default", weight=1))
        for i in range(nodes):
            store.create("nodes", side.tu.build_node(
                f"n{i}", {"cpu": node_cpu, "memory": "64Gi"}))

    def gang(self, name, size, min_available=None):
        tu = self.side.tu
        self.store.create("podgroups", tu.build_pod_group(
            name, "ns1", "default", min_available or size, phase="Inqueue"))
        for t in range(size):
            self.store.create("pods", tu.build_pod(
                "ns1", f"{name}-{t}", "", "Pending", rl(self.side), name))

    def cycle(self, n=1, advance=1.0):
        for _ in range(n):
            self.sched.run_once()
            assert self.cache.flush_executors(timeout=30)
            self.clock.advance(advance)

    def statuses(self):
        with self.cache.mutex:
            return {f"{t.namespace}/{t.name}": t.status.name
                    for j in self.cache.jobs.values()
                    for t in j.tasks.values()}

    def node_of(self, name):
        return self.store.get("pods", name, "ns1").spec.node_name

    def records(self):
        return {k: (r.attempts, r.not_before)
                for k, r in sorted(self.cache.retry_records.items())}

    def counter(self, name, **labels):
        key = (name, tuple(sorted(labels.items())))
        return self.side.m.snapshot()["counters"].get(key, 0)

    def gauge(self, name):
        return self.side.m.snapshot()["gauges"].get((name, ()))

    def events(self, reason):
        return [e[1] for e in self.store.events if e[3] == reason]

    def empty_nodes(self):
        with self.cache.mutex:
            return all(not n.tasks and n.used.is_empty()
                       for n in self.cache.nodes.values())

    def why_pending(self):
        ssn = self.side.framework.open_session(
            self.cache, self.sched.conf.tiers, self.sched.conf.configurations,
            clock=self.clock, **self.side.sched_kw)
        report = self.side.pending.collect(ssn)
        self.side.framework.close_session(ssn)
        self.cache.flush_executors(timeout=30)
        return report

    def stop(self):
        self.cache.stop()


# -- resync: the backoff schedule -------------------------------------------


def test_backoff_schedule_deterministic_under_virtual_clock():
    """A failing pod's retry schedule is exponential with seeded jitter on
    the store's virtual clock: equal in two environments of one package,
    and equal across the packages."""
    def run(side):
        schedules = []
        for _ in range(2):
            env = Env(side, fail_pods={"ns1/pg0-0"})
            env.gang("pg0", 1, min_available=1)
            seen = []
            for _ in range(30):
                before = env.cache.retry_records.get("ns1/pg0-0")
                attempts_before = before.attempts if before else 0
                env.cycle()
                rec = env.cache.retry_records.get("ns1/pg0-0")
                if rec is not None and rec.attempts != attempts_before:
                    seen.append((rec.attempts, rec.not_before))
                if env.cache.quarantined:
                    break
            env.stop()
            schedules.append(seen)
        assert schedules[0] == schedules[1]
        return schedules[0], sorted(env.cache.quarantined)

    ref, port = both(run)
    assert port == ref
    schedule, _ = port
    assert len(schedule) >= 3
    assert [a for a, _ in schedule] == list(range(1, len(schedule) + 1))
    base = PortCache.RESYNC_BACKOFF_BASE_SECONDS
    cap = PortCache.RESYNC_BACKOFF_CAP_SECONDS
    probe = PortCache(PortStore())
    for attempt, _ in schedule:
        delay = probe._backoff_seconds("ns1/pg0-0", attempt)
        nominal = min(cap, base * 2.0 ** (attempt - 1))
        assert 0.5 * nominal <= delay < nominal


def test_backoff_gates_replacement_not_reconcile():
    """A failed bind reconciles at once (Pending on both sides, no node
    accounting left) while re-placement waits for the backoff window."""
    def run(side):
        env = Env(side, fail_pods={"ns1/solo-0"})
        env.gang("solo", 1, min_available=1)
        env.cycle(advance=0.0)
        out = [env.statuses(), env.node_of("solo-0"), env.empty_nodes(),
               env.records(), "ns1/solo-0" in env.cache.bind_ineligible()]
        rec = env.cache.retry_records["ns1/solo-0"]
        attempts_before = env.binder.attempts
        env.cycle(advance=0.0)
        out.append(env.binder.attempts - attempts_before)
        env.clock.advance(rec.not_before - env.clock.now() + 0.001)
        out.append("ns1/solo-0" in env.cache.bind_ineligible())
        env.cycle(advance=0.0)
        out.append(env.binder.attempts - attempts_before)
        out.append(env.records())
        env.stop()
        return out

    ref, port = both(run)
    assert port == ref
    statuses, node, empty, records, ineligible = port[:5]
    assert statuses["ns1/solo-0"] == "Pending" and node == "" and empty
    (attempts, not_before), = records.values()
    assert attempts == 1 and not_before > 1.0 and ineligible
    assert port[5:8] == [0, False, 1]


# -- resync: the quarantine lifecycle ------------------------------------------


def test_budget_exhaustion_quarantines_then_pod_delete_clears():
    """A poison pod burns its retry budget into quarantine (the gauge, a
    store event, the why-pending reason, no more attempts); deleting the
    pod clears it, and the recreated pod binds."""
    def run(side):
        env = Env(side, fail_pods={"ns1/poison-0"})
        env.gang("poison", 2, min_available=2)
        for _ in range(60):
            env.cycle()
            if env.cache.quarantined:
                break
        m = side.m
        out = {"quarantined": sorted(env.cache.quarantined),
               "records": env.records(),
               "failed": list(env.binder.failed_keys),
               "retries": env.cache.resync_retry_total,
               "gauge": env.gauge(m.QUARANTINED_TASKS),
               "events": env.events("BindQuarantined"),
               "heals": env.counter(m.GANG_HEALS),
               "unbound": env.events("GangUnbound")}
        attempts = env.binder.attempts
        env.cycle(n=3)
        out["attempts_after"] = env.binder.attempts - attempts
        report = env.why_pending()
        out["reasons"] = dict(report["reasons"])
        out["job_reasons"] = report["jobs"]["ns1/poison"]["reasons"]
        env.store.delete("pods", "poison-0", "ns1", **side.write_kw)
        out["after_delete"] = (sorted(env.cache.quarantined),
                               env.gauge(m.QUARANTINED_TASKS))
        env.store.create("pods", side.tu.build_pod(
            "ns1", "poison-0", "", "Pending", rl(side), "poison"))
        env.binder.fail_pods.clear()
        env.cycle(n=2)
        out["bound"] = [env.node_of(f"poison-{t}") for t in range(2)]
        env.stop()
        return out

    ref, port = both(run)
    assert port == ref
    budget = PortCache.RESYNC_RETRY_BUDGET
    assert port["quarantined"] == ["ns1/poison-0"]
    assert port["records"] == {}
    assert len(port["failed"]) == budget == port["retries"]
    assert port["gauge"] == 1.0 and port["events"] == ["ns1/poison-0"]
    assert port["attempts_after"] == 0
    assert port["reasons"].get(port_pending.REASON_QUARANTINED) == 1
    assert port_pending.REASON_QUARANTINED in port["job_reasons"]
    assert port["after_delete"] == ([], 0.0)
    assert all(port["bound"])


def test_backoff_reason_in_why_pending():
    def run(side):
        env = Env(side, fail_pods={"ns1/pg0-0"})
        env.gang("pg0", 1, min_available=1)
        env.cycle(advance=0.0)
        reasons = dict(env.why_pending()["reasons"])
        env.stop()
        return reasons

    ref, port = both(run)
    assert port == ref
    assert any(r.startswith(port_pending.REASON_BIND_BACKOFF)
               for r in port), port


# -- gang-atomic bind healing -------------------------------------------------


def test_partial_gang_bind_heals_and_replaces():
    """One member of a gang of 4 fails to bind: its three bound siblings
    are unbound in the same flush (store node_name cleared, accounting
    rolled back), and once the failure clears the gang binds whole."""
    def run(side):
        env = Env(side, fail_pods={"ns1/gang-2"})
        env.gang("gang", 4, min_available=4)
        env.cycle(advance=0.0)
        m = side.m
        out = {"statuses": env.statuses(),
               "nodes": [env.node_of(f"gang-{t}") for t in range(4)],
               "empty": env.empty_nodes(),
               "unbound": env.events("GangUnbound"),
               "heals": env.counter(m.GANG_HEALS),
               "rejected": env.counter(m.BIND_ERRORS, reason="rejected"),
               "records": env.records()}
        env.binder.fail_pods.clear()
        rec = env.cache.retry_records["ns1/gang-2"]
        env.clock.advance(rec.not_before - env.clock.now() + 0.001)
        env.cycle()
        out["rebound"] = [env.node_of(f"gang-{t}") for t in range(4)]
        out["records_after"] = env.records()
        env.stop()
        return out

    ref, port = both(run)
    assert port == ref
    assert set(port["statuses"].values()) == {"Pending"}
    assert port["nodes"] == [""] * 4 and port["empty"]
    assert sorted(port["unbound"]) == ["ns1/gang-0", "ns1/gang-1",
                                       "ns1/gang-3"]
    assert port["heals"] >= 1 and port["rejected"] >= 1
    assert set(port["records"]) == {"ns1/gang-2"}
    assert all(port["rebound"]) and port["records_after"] == {}


def test_partial_gang_heals_on_per_task_bind_path():
    """A ready gang dispatched as one cache.bind() a task: a failure there
    heals the gang too, once the executor has run the siblings' binds."""
    def run(side):
        env = Env(side, fail_pods={"ns1/ptg-1"})
        env.gang("ptg", 3, min_available=3)
        with env.cache.mutex:
            job = next(iter(env.cache.jobs.values()))
            tasks = sorted(job.tasks.values(), key=lambda t: t.name)
        for i, t in enumerate(tasks):
            env.cache.bind(t, f"n{i}")
        assert env.cache.flush_executors(timeout=30)
        out = (env.statuses(), [env.node_of(f"ptg-{t}") for t in range(3)],
               env.empty_nodes(), sorted(env.cache.retry_records),
               env.counter(side.m.GANG_HEALS))
        env.stop()
        return out

    ref, port = both(run)
    assert port == ref
    statuses, nodes, empty, records, heals = port
    assert set(statuses.values()) == {"Pending"} and nodes == [""] * 3
    assert empty and records == ["ns1/ptg-1"] and heals == 1


def test_partial_gang_heals_inline_mode_at_flush_barrier():
    """Inline mode (no run(): no watches, no executor): a failure in the
    middle of a dispatch heals nothing while later siblings have not even
    staged; the flush_executors() barrier heals the partial gang."""
    def run(side):
        tu = side.tu
        clock = side.Clock(start=1.0)
        store = side.Store(clock=clock)
        binder = side.faults.FlakyBinder(store, clock, fail_pods={"ns1/ig-1"})
        cache = side.Cache(store, binder=binder,
                           evictor=tu.FakeEvictor(store))
        for i in range(4):
            store.create("nodes", tu.build_node(f"n{i}", {"cpu": "8",
                                                          "memory": "64Gi"}))
            cache.add_node(store.get("nodes", f"n{i}"))
        store.create("queues", tu.build_queue("default", weight=1))
        cache.add_pod_group(tu.build_pod_group("ig", "ns1", "default", 4,
                                               phase="Inqueue"))
        for t in range(4):
            store.create("pods", tu.build_pod("ns1", f"ig-{t}", "",
                                              "Pending", rl(side), "ig"))
            cache.add_pod(store.get("pods", f"ig-{t}", "ns1"))
        with cache.mutex:
            job = next(iter(cache.jobs.values()))
            tasks = sorted(job.tasks.values(), key=lambda t: t.name)
        for i, t in enumerate(tasks):
            cache.bind(t, f"n{i}")
        mid = store.get("pods", "ig-0", "ns1").spec.node_name
        assert cache.flush_executors(timeout=5)
        after = [store.get("pods", f"ig-{t}", "ns1").spec.node_name
                 for t in range(4)]
        records = sorted(cache.retry_records)
        cache.process_resync_tasks()
        with cache.mutex:
            statuses = {t.name: t.status.name for t in job.tasks.values()}
            empty = all(not n.tasks for n in cache.nodes.values())
        return mid, after, records, statuses, empty

    ref, port = both(run)
    assert port == ref
    mid, after, records, statuses, empty = port
    assert mid and after == [""] * 4 and records == ["ns1/ig-1"]
    assert set(statuses.values()) == {"Pending"} and empty


def test_elastic_job_above_min_available_not_healed():
    """A job still at or above min_available without the failed pod keeps
    its bound tasks: healing fires only on broken atomicity."""
    def run(side):
        env = Env(side, fail_pods={"ns1/ela-3"})
        env.gang("ela", 4, min_available=2)
        env.cycle(advance=0.0)
        out = (env.statuses(), [env.node_of(f"ela-{t}") for t in range(4)],
               env.counter(side.m.GANG_HEALS))
        env.stop()
        return out

    ref, port = both(run)
    assert port == ref
    statuses, nodes, heals = port
    bound = sorted(k for k, s in statuses.items() if s != "Pending")
    assert bound == ["ns1/ela-0", "ns1/ela-1", "ns1/ela-2"]
    assert all(nodes[:3]) and nodes[3] == "" and heals == 0


# -- lease fencing on the store -------------------------------------------------


def fenced_store(side, n=3, clock=None):
    tu = side.tu
    store = side.Store(clock=clock) if clock is not None else side.Store()
    store.create("queues", tu.build_queue("default", weight=1))
    store.create("nodes", tu.build_node("n0", {"cpu": "32",
                                               "memory": "64Gi"}))
    store.create("podgroups", tu.build_pod_group("pg0", "ns1", "default", n,
                                                 phase="Inqueue"))
    for t in range(n):
        store.create("pods", tu.build_pod("ns1", f"pg0-{t}", "", "Pending",
                                          rl(side), "pg0"))
    return store


def test_stale_token_rejected_every_write_form():
    def run(side):
        store = fenced_store(side)
        kw = side.write_kw
        out = [store.advance_fence(5)]
        pod = store.get("pods", "pg0-0", "ns1")
        writes = [
            lambda: store.update("pods", pod, fence=4, **kw),
            lambda: store.create("pods", side.tu.build_pod(
                "ns1", "late", "", "Pending", rl(side), "pg0"), fence=3),
            lambda: store.delete("pods", "pg0-0", "ns1", fence=1, **kw),
            lambda: store.patch_batch(
                "pods", [("pg0-0", "ns1", lambda p: None)], fence=4),
            lambda: store.bind_pods([("pg0-0", "ns1", "n0")], fence=4)]
        for write in writes:
            with pytest.raises(side.FencedError):
                write()
        after = store.get("pods", "pg0-0", "ns1")
        out += [store.fenced_writes, after.metadata.resource_version,
                pod.metadata.resource_version, after.spec.node_name,
                store.current_rv()]
        return out

    ref, port = both(run)
    assert port == ref
    assert port[1] == 5 and port[2] == port[3] and port[4] == ""


def test_current_and_future_tokens_pass_and_unstamped_pass():
    def run(side):
        store = fenced_store(side)
        kw = side.write_kw
        store.advance_fence(2)
        for fence in (2, 7, None):
            pod = store.get("pods", "pg0-0", "ns1")
            store.update("pods", pod, fence=fence, **kw)
        return (store.advance_fence(1), store.fence_floor(),
                store.fenced_writes, store.current_rv(),
                store.get("pods", "pg0-0", "ns1").metadata.resource_version)

    ref, port = both(run)
    assert port == ref
    assert port[:3] == (2, 2, 0) and port[3] == port[4]


def test_takeover_during_write_barrier_wait_still_fences():
    """A write waiting behind an in-flight bulk reservation (the settle
    wait releases the store lock) checks its fence after the wait: a
    takeover meanwhile still refuses it."""
    def run(side):
        store = fenced_store(side)
        store.advance_fence(1)
        with store._lock:
            store._rv += 4      # phase 1 of a sharded flush, frozen
        outcome = {}
        pod = store.get("pods", "pg0-0", "ns1")

        def deposed_writer():
            try:
                store.update("pods", pod, fence=1, **side.write_kw)
                outcome["fenced"] = False
            except side.FencedError:
                outcome["fenced"] = True

        t = threading.Thread(target=deposed_writer)
        t.start()
        time.sleep(0.2)
        waiting = t.is_alive()
        store.advance_fence(2)
        with store._lock:
            store._rv -= 4      # the reservation publishes
            store._flush_cond.notify_all()
        t.join(timeout=5)
        return (waiting, t.is_alive(), outcome,
                store.get("pods", "pg0-0", "ns1").spec.node_name,
                store.fenced_writes)

    ref, port = both(run)
    assert port == ref == (True, False, {"fenced": True}, "", 1)


def test_fenced_bind_pods_leaves_no_reservation():
    """A fenced bulk write is refused before it reserves rvs: the journal
    stays clean and later writers do not wait on orphaned keys."""
    def run(side):
        store = fenced_store(side)
        store.advance_fence(9)
        rv_before = store.current_rv()
        with pytest.raises(side.FencedError):
            store.bind_pods([("pg0-0", "ns1", "n0")], fence=1)
        clean = (store.current_rv() == rv_before == store._rv,
                 not store._inflight["pods"], not store._journal_parked)
        pod = store.get("pods", "pg0-1", "ns1")
        store.update("pods", pod, **side.write_kw)
        return clean, store.current_rv() - rv_before

    ref, port = both(run)
    assert port == ref == ((True, True, True), 1)


def test_stale_fenced_flush_fails_safe_and_resyncs():
    """A leader's flush in flight when a standby takes over (the floor
    rises): every write of the flush is refused, the cache's resync
    absorbs the failures, the store keeps none of the deposed binds."""
    def run(side):
        clock = side.Clock(start=1.0)
        store = fenced_store(side, n=3, clock=clock)
        binder = side.faults.FlakyBinder(store, clock)
        cache = side.Cache(store, binder=binder,
                           evictor=side.tu.FakeEvictor(store),
                           fence_source=lambda: 1)    # stale for good
        cache.run()
        sched = side.Scheduler(store, scheduler_conf=CONF, cache=cache,
                               clock=clock, **side.sched_kw)
        store.advance_fence(2)
        sched.run_once()
        assert cache.flush_executors(timeout=30)
        out = ([store.get("pods", f"pg0-{t}", "ns1").spec.node_name
                for t in range(3)], store.fenced_writes,
               cache.resync_retry_total, dict(binder.binds),
               {k: r.attempts for k, r in cache.retry_records.items()})
        sched.stop()
        cache.stop()
        return out

    ref, port = both(run)
    assert port == ref
    nodes, fenced, retries, binds, records = port
    assert nodes == [""] * 3 and fenced >= 3 and retries >= 3
    assert binds == {} and set(records.values()) == {1}


# -- anti-entropy ----------------------------------------------------------------


def ae_env(side):
    clock = side.Clock(start=1.0)
    store = fenced_store(side, n=3, clock=clock)
    cache = side.Cache(store)
    cache.run()
    return store, cache


def pod_watch(cache):
    return [w for w in cache._watches if w.kind == "pods"][0]


def ae_state(cache):
    st = cache.anti_entropy_state
    return {k: st[k] for k in ("checks", "repairs", "objects_repaired",
                               "last_check", "last_repair",
                               "last_divergent")}


def test_clean_pass_reports_no_divergence():
    def run(side):
        store, cache = ae_env(side)
        rep = cache.anti_entropy()
        out = (rep, ae_state(cache))
        cache.stop()
        return out

    ref, port = both(run)
    assert port == ref
    rep, state = port
    assert rep["divergent"] == [] and rep["repaired"] == 0
    assert state["checks"] == 1 and state["last_repair"] is None


def test_detects_and_repairs_lost_task():
    """A missed add leaves the cache stale: the pass flags the kind,
    relists it and converges."""
    def run(side):
        store, cache = ae_env(side)
        w = pod_watch(cache)
        orig, w.on_add = w.on_add, (lambda o: None)
        store.create("pods", side.tu.build_pod("ns1", "ghost", "", "Pending",
                                               rl(side), "pg0"))
        w.on_add = orig

        def task_keys():
            with cache.mutex:
                return sorted(t.key() for t in
                              cache.jobs["ns1/pg0"].tasks.values())

        out = [task_keys(), cache.anti_entropy(), task_keys(),
               cache.anti_entropy(), ae_state(cache)]
        cache.stop()
        return out

    ref, port = both(run)
    assert port == ref
    before, rep, after, rep2, state = port
    assert "ns1/ghost" not in before and "ns1/ghost" in after
    assert "pods" in rep["divergent"] and rep["repaired"] >= 1
    assert rep2["divergent"] == [] and state["repairs"] == 1


def test_repairs_stale_version_and_stray_task():
    def run(side):
        store, cache = ae_env(side)
        w = pod_watch(cache)
        orig = w.on_update, w.on_delete
        w.on_update = lambda old, new: None
        w.on_delete = lambda o: None
        pod = store.get("pods", "pg0-0", "ns1")
        pod.status.phase = "Running"
        store.update("pods", pod, **side.write_kw)
        store.delete("pods", "pg0-2", "ns1", **side.write_kw)
        w.on_update, w.on_delete = orig
        rep = cache.anti_entropy()
        with cache.mutex:
            by_key = {t.key(): t.pod.metadata.resource_version
                      for t in cache.jobs["ns1/pg0"].tasks.values()}
        out = (rep, by_key,
               store.get("pods", "pg0-0", "ns1").metadata.resource_version)
        cache.stop()
        return out

    ref, port = both(run)
    assert port == ref
    rep, by_key, rv = port
    assert "pods" in rep["divergent"] and rep["repaired"] >= 2
    assert "ns1/pg0-2" not in by_key and by_key["ns1/pg0-0"] == rv


def test_flaky_watch_drop_forces_divergence_then_repair():
    def run(side):
        store, cache = ae_env(side)
        flaky = side.faults.FlakyWatch(seed=0, drop_rate=1.0)
        flaky.wrap(pod_watch(cache))
        pod = store.get("pods", "pg0-1", "ns1")
        pod.status.phase = "Running"
        store.update("pods", pod, **side.write_kw)
        out = [flaky.dropped, cache.anti_entropy()]
        flaky.unwrap()
        out.append(cache.anti_entropy())
        cache.stop()
        return out

    ref, port = both(run)
    assert port == ref
    dropped, rep, rep2 = port
    assert dropped == 1 and "pods" in rep["divergent"]
    assert rep2["divergent"] == []


def test_flaky_watch_delay_redelivers_next_release():
    def run(side):
        store, cache = ae_env(side)
        flaky = side.faults.FlakyWatch(seed=0, delay_rate=1.0)
        flaky.wrap(pod_watch(cache))
        pod = store.get("pods", "pg0-1", "ns1")
        pod.status.phase = "Running"
        store.update("pods", pod, **side.write_kw)

        def phase():
            with cache.mutex:
                return {t.key(): t.pod.status.phase for t in
                        cache.jobs["ns1/pg0"].tasks.values()}["ns1/pg0-1"]

        out = [flaky.delayed, phase(), flaky.release_delayed(), phase()]
        flaky.unwrap()
        out += [flaky.dropped, flaky.release_delayed()]
        cache.stop()
        return out

    ref, port = both(run)
    assert port == ref == [1, "Pending", 1, "Running", 0, 0]
