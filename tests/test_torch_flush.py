"""The port's write-behind bind flush and the store's sharded bulk patch,
held against the JAX package.

The store (volcano_tpu_torch/apiserver/store.py) against
volcano_tpu/apiserver/store.py, each case on both engines of both
packages (the ``engine`` fixture: every native switch on, then every one
off, on both sides): serial against sharded commits, the rv reservation
and the journal under an interleaved writer, the write barrier on keys
in flight, a raising patch fn, the bind clone's sharing and filter flips
on every delivery path (tests/test_flush_pipeline.py's TestShardedEngine
and TestFilterFlipWatchers); the ledger's committed->echo hop of the
pipelined flush (test_commit_echo_hop_split). Then the cache's executor:
the snapshot that drains pending write-behind applies, the write-behind
evict (tests/test_batch_apply.py:169, :215), and three convergence cases
under concurrent writers (tests/test_concurrency.py:85, :120, :223).

Each case runs through both packages and what it observes (stored pods
and their rvs, journal rvs, deliveries, ledger hops, binds, statuses)
must be equal, exactly; the concurrency cases, whose interleavings
depend on thread timing, hold each package to the reference test's
convergence checks and compare what does not depend on timing.
"""

import json
import random
import threading
import time
from types import SimpleNamespace

import pytest

import volcano_tpu.cache.event_handlers as ref_handlers
import volcano_tpu_torch.cache.event_handlers as port_handlers
import volcano_tpu_torch.models.job_info as port_job_info
from volcano_tpu.apiserver import ObjectStore as RefStore
from volcano_tpu.apiserver.store import ConflictError as RefConflict
from volcano_tpu.cache import SchedulerCache as RefCache
from volcano_tpu.models.job_info import TaskStatus as RefStatus
from volcano_tpu.scheduler import Scheduler as RefScheduler
from volcano_tpu.trace import ledger as ref_ledger
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu.utils.clock import Clock as RefClockBase
from volcano_tpu_torch.apiserver import ObjectStore as PortStore
from volcano_tpu_torch.apiserver.store import ConflictError as PortConflict
from volcano_tpu_torch.cache import SchedulerCache as PortCache
from volcano_tpu_torch.models.job_info import TaskStatus as PortStatus
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler
from volcano_tpu_torch.trace import ledger as port_ledger
from volcano_tpu_torch.utils import test_utils as port_tu
from volcano_tpu_torch.utils.clock import Clock as PortClockBase

REF = SimpleNamespace(
    name="ref", Store=RefStore, Cache=RefCache, Scheduler=RefScheduler,
    tu=ref_tu, ledger=ref_ledger, Status=RefStatus, Conflict=RefConflict,
    ClockBase=RefClockBase, sched_kw={}, write_kw={"skip_admission": True})
PORT = SimpleNamespace(
    name="port", Store=PortStore, Cache=PortCache, Scheduler=PortScheduler,
    tu=port_tu, ledger=port_ledger, Status=PortStatus, Conflict=PortConflict,
    ClockBase=PortClockBase, sched_kw={"device": "cpu"}, write_kw={})

FLIP_KEY = "volcano.sh/test-filter-flip"

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


def both(fn):
    """``fn(side)`` for the reference and the port; both results."""
    return fn(REF), fn(PORT)


# each package's native-engine switches: (owner, attribute)
SWITCHES = {
    "ref": [(RefStore, "NATIVE_PUBLISH"), (RefCache, "NATIVE_APPLY"),
            (ref_handlers.EventHandlersMixin, "NATIVE_ECHO"),
            (ref_ledger, "NATIVE_CONFIRM")],
    "port": [(PortStore, "NATIVE_PUBLISH"), (PortCache, "NATIVE_APPLY"),
             (port_handlers.EventHandlersMixin, "NATIVE_ECHO"),
             (port_ledger, "NATIVE_CONFIRM"),
             (port_job_info, "NATIVE_CLONE")]}


@pytest.fixture(autouse=True, params=["native", "python"])
def engine(request):
    """Every case on both engines, the same one on both sides."""
    for owner, attr in SWITCHES["ref"] + SWITCHES["port"]:
        setattr(owner, attr, request.param == "native")
    yield request.param
    for owner, attr in SWITCHES["ref"] + SWITCHES["port"]:
        setattr(owner, attr, True)


def new_store(side, **kw):
    return side.Store(**kw)


def sharded(store, target: int = 2, cap: int = 4):
    """Force the sharded path for tiny bursts (instance attributes shadow
    the class's tuning)."""
    store.SHARD_SERIAL_MAX = 0
    store.SHARD_TARGET = target
    store.SHARD_MAX = cap
    return store


def store_with_pods(side, n: int):
    store = new_store(side)
    for i in range(n):
        store.create("pods", side.tu.build_pod(
            "ns1", f"p{i:03d}", "", "Pending", {"cpu": "1", "memory": "1Gi"}))
    return store


def journal_rvs(store) -> list:
    with store._lock:
        return [e[0] for e in store._journal]


def journal_clean(store) -> bool:
    rvs = journal_rvs(store)
    with store._lock:
        return (all(b - a == 1 for a, b in zip(rvs, rvs[1:]))
                and store._journal_tail == store._rv
                and not store._journal_parked
                and not any(store._inflight.values()))


def pods_view(store):
    return [(p.metadata.name, p.spec.node_name, p.metadata.resource_version)
            for p in sorted(store.list_refs("pods"),
                            key=lambda p: p.metadata.name)]


def setter(host):
    def fn(p):
        p.spec.node_name = host
    return fn


# -- the store's sharded engine ------------------------------------------------


class TestShardedEngine:
    def test_sharded_matches_serial(self):
        """One burst through the serial and the sharded path: the same
        stored objects, rvs, journal and delivered pairs."""
        def run(side):
            results = []
            for force in (False, True):
                store = store_with_pods(side, 12)
                if force:
                    sharded(store, target=3)
                bulk = []
                store.watch("pods", on_bulk_update=lambda ps: bulk.extend(ps),
                            sync=False)
                pairs, missing = store.patch_batch(
                    "pods", [(f"p{i:03d}", "ns1", setter(f"n{i % 4}"))
                             for i in range(12)]
                    + [("ghost", "ns1", setter("x"))])
                results.append((
                    missing, journal_clean(store), journal_rvs(store),
                    [(o.metadata.name, new.spec.node_name,
                      new.metadata.resource_version) for o, new in pairs],
                    [(o.metadata.name, new.metadata.resource_version)
                     for o, new in bulk],
                    pods_view(store)))
            assert results[0] == results[1]
            return results[1]

        ref, port = both(run)
        assert port == ref
        assert port[0] == [("ghost", "ns1")] and port[1]

    def test_bind_pods_matches_patch_batch(self):
        def run(side):
            outs = []
            for use_bind in (False, True):
                store = sharded(store_with_pods(side, 10), target=3)
                if use_bind:
                    _, missing = store.bind_pods(
                        [(f"p{i:03d}", "ns1", f"n{i % 3}") for i in range(10)]
                        + [("ghost", "ns1", "nx")])
                else:
                    _, missing = store.patch_batch(
                        "pods", [(f"p{i:03d}", "ns1", setter(f"n{i % 3}"))
                                 for i in range(10)]
                        + [("ghost", "ns1", setter("nx"))])
                outs.append((missing, journal_clean(store),
                             pods_view(store)))
            assert outs[0] == outs[1]
            return outs[1]

        ref, port = both(run)
        assert port == ref
        assert port[0] == [("ghost", "ns1")] and port[1]

    def test_bind_pods_clone_shares_immutable_subtrees(self):
        """The bind clone shares everything but the metadata and spec
        shells with the stored object, which no write mutates."""
        def run(side):
            store = store_with_pods(side, 3)
            with store._lock:
                olds = dict(store._objects["pods"])
            store.bind_pods([(f"p{i:03d}", "ns1", "n0") for i in range(3)])
            out = []
            for key, old in sorted(olds.items()):
                with store._lock:
                    new = store._objects["pods"][key]
                out.append((
                    new is not old, new.spec is not old.spec,
                    new.metadata is not old.metadata,
                    new.spec.containers is old.spec.containers,
                    new.metadata.annotations is old.metadata.annotations,
                    new.status is old.status,
                    new.__dict__.get("_rr") is old.__dict__.get("_rr"),
                    old.spec.node_name, new.spec.node_name))
            return out

        ref, port = both(run)
        assert port == ref
        assert port == [(True,) * 7 + ("", "n0")] * 3

    def test_repeated_key_chains_even_on_forced_shard_tuning(self):
        """Two patches of one key in a burst chain (the second sees the
        first's result): a repeated key forces the serial engine."""
        def run(side):
            store = sharded(store_with_pods(side, 6), target=2)

            def label(k, v):
                def fn(p):
                    p.metadata.labels[k] = v
                return fn

            patches = [(f"p{i:03d}", "ns1", setter(f"n{i}"))
                       for i in range(6)]
            patches.insert(3, ("p000", "ns1", label("second", "yes")))
            store.patch_batch("pods", patches)
            p0 = store.get("pods", "p000", "ns1")
            return (p0.spec.node_name, p0.metadata.labels.get("second"),
                    journal_clean(store), journal_rvs(store))

        ref, port = both(run)
        assert port == ref
        assert port[:3] == ("n0", "yes", True)

    def test_sharded_raising_fn_commits_noop_and_reraises(self):
        """A raising patch fn cannot abort reserved rvs: its item commits a
        no-op version, every other item commits, the journal stays
        gap-free and the error re-raises after delivery."""
        def run(side):
            store = sharded(store_with_pods(side, 6), target=2)
            delivered = []
            store.watch("pods", on_bulk_update=lambda ps: delivered.extend(
                (o.metadata.name, n.metadata.resource_version)
                for o, n in ps), sync=False)

            def boom(p):
                raise RuntimeError("bad patch")

            patches = [(f"p{i:03d}", "ns1",
                        boom if i == 2 else setter(f"n{i}"))
                       for i in range(6)]
            with pytest.raises(RuntimeError, match="bad patch"):
                store.patch_batch("pods", patches)
            return journal_clean(store), pods_view(store), delivered

        ref, port = both(run)
        assert port == ref
        clean, view, delivered = port
        assert clean and len(delivered) == 6
        for i, (name, node, rv) in enumerate(view):
            assert node == ("" if i == 2 else f"n{i}") and rv > 6

    @staticmethod
    def _slow_patch(store):
        """Start a sharded patch of p000-p007 whose fns wait for
        ``release``; returns (thread, entered, release)."""
        release = threading.Event()
        entered = threading.Event()

        def slow_setter(host):
            def fn(p):
                entered.set()
                release.wait(timeout=5.0)
                p.spec.node_name = host
            return fn

        t = threading.Thread(target=store.patch_batch, args=(
            "pods", [(f"p{i:03d}", "ns1", slow_setter(f"n{i}"))
                     for i in range(8)]))
        t.start()
        assert entered.wait(timeout=5.0)
        return t, release

    def test_interleaved_writer_settles_behind_reservation(self):
        """A write racing a sharded patch waits for the journal to settle:
        its rv comes after the whole reservation and is visible when it
        returns, so rv order follows commit order."""
        def run(side):
            store = sharded(store_with_pods(side, 8), target=2)
            store.create("nodes", side.tu.build_node(
                "n-aux", {"cpu": "1", "memory": "1Gi"}))
            rv_before = store.current_rv()
            t, release = self._slow_patch(store)
            aux = store.get("nodes", "n-aux")
            aux.metadata.labels["touched"] = "yes"
            updated = threading.Event()

            def racing_update():
                store.update("nodes", aux, **side.write_kw)
                updated.set()

            u = threading.Thread(target=racing_update)
            u.start()
            time.sleep(0.05)
            waited = not updated.is_set()
            release.set()
            t.join(timeout=10.0)
            u.join(timeout=10.0)
            events, tail, resync = store.events_since(rv_before, timeout=0.1)
            return (waited, t.is_alive(), updated.is_set(),
                    store.get("nodes", "n-aux").metadata.resource_version
                    == store.current_rv(), journal_clean(store), resync,
                    [(rv, k) for rv, _, k, _ in events], tail,
                    store.journal_window())

        ref, port = both(run)
        assert port == ref
        assert port[:6] == (True, False, True, True, True, False)
        assert [k for _, k in port[6]] == ["pods"] * 8 + ["nodes"]

    def test_update_on_inflight_key_waits_for_publish(self):
        """update() of a key inside an open reservation waits until its
        shard publishes, then meets the patched version: the stale copy
        conflicts, and the retry lands on top (no lost update)."""
        def run(side):
            store = sharded(store_with_pods(side, 8), target=2)
            t, release = self._slow_patch(store)
            done = threading.Event()
            conflicted = []

            def racing_update():
                live = store.get("pods", "p000", "ns1")   # pre-patch copy
                live.metadata.labels["raced"] = "yes"
                try:
                    store.update("pods", live, **side.write_kw)
                except side.Conflict:
                    conflicted.append(True)
                    fresh = store.get("pods", "p000", "ns1")
                    fresh.metadata.labels["raced"] = "yes"
                    store.update("pods", fresh, **side.write_kw)
                done.set()

            u = threading.Thread(target=racing_update)
            u.start()
            time.sleep(0.05)
            waited = not done.is_set()
            release.set()
            t.join(timeout=10.0)
            u.join(timeout=10.0)
            final = store.get("pods", "p000", "ns1")
            return (waited, done.is_set(), conflicted,
                    final.metadata.labels.get("raced"), final.spec.node_name,
                    final.metadata.resource_version, journal_clean(store))

        ref, port = both(run)
        assert port == ref
        assert port == (True, True, [True], "yes", "n0", 17, True)


class TestFilterFlipWatchers:
    """A watcher whose filter flips pass->fail or fail->pass within a burst
    sees on_delete or on_add (not on_update), on the bulk and the per-pair
    delivery paths, on the serial and the sharded engine."""

    @staticmethod
    def _flip_store(side, force_sharded: bool):
        store = store_with_pods(side, 6)
        if force_sharded:
            sharded(store, target=2)
        for name in ("p000", "p001"):
            live = store.get("pods", name, "ns1")
            live.metadata.annotations[FLIP_KEY] = "true"
            store.update("pods", live, **side.write_kw)
        return store

    @staticmethod
    def _flip(value):
        def fn(p):
            # the metadata shell shares its annotation dict with the stored
            # object: a patch that edits it copies first
            p.metadata.annotations = dict(p.metadata.annotations)
            p.metadata.annotations[FLIP_KEY] = value
        return fn

    @pytest.mark.parametrize("force_sharded", [False, True])
    @pytest.mark.parametrize("bulk_handler", [False, True])
    def test_filter_flips(self, force_sharded, bulk_handler):
        def run(side):
            store = self._flip_store(side, force_sharded)
            got = {"add": [], "delete": [], "update": [], "bulk": []}
            kwargs = dict(
                on_add=lambda o: got["add"].append(o.metadata.name),
                on_delete=lambda o: got["delete"].append(o.metadata.name),
                filter_fn=lambda p: p.metadata.annotations.get(
                    FLIP_KEY) == "true",
                sync=False)
            if bulk_handler:
                kwargs["on_bulk_update"] = lambda pairs: got["bulk"].extend(
                    (o.metadata.name, n.metadata.name) for o, n in pairs)
            else:
                kwargs["on_update"] = lambda o, n: got["update"].append(
                    o.metadata.name)
            store.watch("pods", **kwargs)
            store.patch_batch("pods", [
                ("p000", "ns1", self._flip("true")),    # pass -> pass
                ("p001", "ns1", self._flip("false")),   # pass -> fail
                ("p004", "ns1", self._flip("true")),    # fail -> pass
                ("p005", "ns1", self._flip("false")),   # fail -> fail
            ])
            return got, journal_clean(store), journal_rvs(store)

        ref, port = both(run)
        assert port == ref
        got, clean, _ = port
        assert got["add"] == ["p004"] and got["delete"] == ["p001"] and clean
        if bulk_handler:
            assert got["bulk"] == [("p000", "p000")] and got["update"] == []
        else:
            assert got["update"] == ["p000"] and got["bulk"] == []


# -- the pipelined flush's ledger hops ---------------------------------------------


def test_commit_echo_hop_split():
    """The pipelined flush stamps store_committed at the shard's publish
    and echo_confirmed at the echo's ingest: on a clock that advances at
    every read, the committed->echo hop is nonzero, not folded into
    staged->committed."""
    def run(side):
        class TickClock(side.ClockBase):
            def __init__(self):
                self.t = 1.0

            def now(self):
                self.t += 0.001
                return self.t

        tu = side.tu
        store = new_store(side, clock=TickClock())
        store.SHARD_SERIAL_MAX = 0
        store.SHARD_TARGET = 128
        cache = side.Cache(store, binder=tu.FakeBinder(store),
                           evictor=tu.FakeEvictor(store))
        cache.run()
        store.create("queues", tu.build_queue("default", weight=1))
        for i in range(8):
            store.create("nodes", tu.build_node(
                f"node-{i}", {"cpu": "640", "memory": "2560Gi",
                              "pods": "1100"}))
        for j in range(80):
            store.create("podgroups", tu.build_pod_group(
                f"pg-{j}", "default", "default", 8, phase="Inqueue"))
            for t in range(8):
                store.create("pods", tu.build_pod(
                    "default", f"job{j}-task{t}", "", "Pending",
                    {"cpu": "1", "memory": "1Gi"}, groupname=f"pg-{j}"))
        ledger = side.ledger
        ledger.reset()
        ledger.enable()
        try:
            with cache.mutex:
                gangs = []
                i = 0
                for job in sorted(cache.jobs.values(), key=lambda j: j.uid):
                    tasks = sorted(job.tasks.values(), key=lambda t: t.uid)
                    for t in tasks:
                        ledger.stamp(t.key(), "submitted", store.clock.now(),
                                     job=t.job)
                    gangs.append([(t, f"node-{(i := i + 1) % 8}")
                                  for t in tasks])
            for pairs in gangs:
                cache.bind_batch(pairs)
            assert cache.flush_executors(timeout=60.0)
            hops = ledger.report()["hops"]
            binds = sum(1 for p in store.list_refs("pods")
                        if p.spec.node_name)
            return ({h: hops[h]["count"] for h in
                     ("store_committed->echo_confirmed",
                      "bind_staged->store_committed")},
                    hops["store_committed->echo_confirmed"]["mean_ms"] > 0.0,
                    binds, journal_clean(store))
        finally:
            cache.stop()
            ledger.disable()
            ledger.reset()

    ref, port = both(run)
    assert port == ref
    counts, split, binds, clean = port
    assert counts == {"store_committed->echo_confirmed": 640,
                      "bind_staged->store_committed": 640}
    assert split and binds == 640 and clean


@pytest.mark.parametrize("force_sharded", [False, True])
def test_self_echo_does_not_dirty_on_either_engine(force_sharded):
    """The echo of the executor's own bind commit dirties no job or node,
    whether the store delivers it on the writing thread (serial) or on
    its echo worker on the writer's behalf (sharded): the dirty sets are
    emptied just before the store write, and stay empty."""
    def run(side):
        tu = side.tu
        store = new_store(side)
        if force_sharded:
            store.SHARD_SERIAL_MAX = 0
            store.SHARD_TARGET = 16
        cache = side.Cache(store, binder=tu.FakeBinder(store),
                           evictor=tu.FakeEvictor(store))
        cache.run()
        store.create("queues", tu.build_queue("default", weight=1))
        for i in range(4):
            store.create("nodes", tu.build_node(f"n{i}", {"cpu": "64",
                                                          "memory": "64Gi"}))
        for j in range(8):
            store.create("podgroups", tu.build_pod_group(
                f"pg{j}", "ns1", "default", 8, phase="Inqueue"))
            for t in range(8):
                store.create("pods", tu.build_pod(
                    "ns1", f"p{j}-{t}", "", "Pending",
                    tu.build_resource_list("1", "1Gi"), f"pg{j}"))
        write = cache._bind_store_writes

        def write_clean(bound, trace=None):
            with cache.mutex:
                cache._dirty_jobs.clear()
                cache._dirty_nodes.clear()
            write(bound, trace)

        cache._bind_store_writes = write_clean
        with cache.mutex:
            gangs = [[(t, f"n{k % 4}") for k, t in enumerate(
                sorted(job.tasks.values(), key=lambda t: t.name))]
                for _, job in sorted(cache.jobs.items())]
        for pairs in gangs:
            cache.bind_batch(pairs)
        assert cache.flush_executors(timeout=30)
        with cache.mutex:
            out = (sorted(cache._dirty_jobs), sorted(cache._dirty_nodes),
                   sorted({t.status.name for j in cache.jobs.values()
                           for t in j.tasks.values()}),
                   sum(1 for p in store.list_refs("pods")
                       if p.spec.node_name))
        cache.stop()
        return out

    ref, port = both(run)
    assert port == ref == ([], [], ["Bound"], 64)


# -- the cache's write-behind applies ------------------------------------------------


def gang_store(side, n_pods=2, node="", phase="Pending", pg_phase="Inqueue",
               evictor=None):
    tu = side.tu
    store = new_store(side)
    evictor = evictor or tu.FakeEvictor(store)
    cache = side.Cache(store, binder=tu.FakeBinder(store), evictor=evictor)
    cache.run()
    store.create("queues", tu.build_queue("default", weight=1))
    store.create("nodes", tu.build_node("n0", {"cpu": "8", "memory": "16Gi"}))
    store.create("podgroups", tu.build_pod_group(
        "pg", "ns1", "default", n_pods, phase=pg_phase))
    for t in range(n_pods):
        store.create("pods", tu.build_pod(
            "ns1", f"p{t}", node, phase, tu.build_resource_list("1", "1Gi"),
            "pg"))
    return store, cache, evictor


def test_snapshot_drains_pending_write_behind_applies():
    """A snapshot taken before the executor ran the queued bind applies
    still sees the bound state (else the next cycle would place the same
    tasks twice); the store writes then run once."""
    def run(side):
        store, cache, _ = gang_store(side)
        gate = threading.Event()
        cache._submit(lambda: gate.wait(5.0))    # wedge the executor
        with cache.mutex:
            job = next(iter(cache.jobs.values()))
            infos = sorted(job.tasks.values(), key=lambda t: t.name)
        accepted = cache.bind_batch([(infos[0], "n0"), (infos[1], "n0")])
        snap = cache.snapshot()
        sjob = next(iter(snap.jobs.values()))
        out = [len(accepted),
               {t.name: t.status.name for t in sjob.tasks.values()},
               snap.nodes["n0"].idle.milli_cpu, len(snap.nodes["n0"].tasks),
               [store.get("pods", f"p{t}", "ns1").spec.node_name
                for t in range(2)]]
        gate.set()
        assert cache.flush_executors(timeout=10)
        out.append([store.get("pods", f"p{t}", "ns1").spec.node_name
                    for t in range(2)])
        out.append(journal_rvs(store))
        cache.stop()
        return out

    ref, port = both(run)
    assert port == ref
    assert port[:5] == [2, {"p0": "Binding", "p1": "Binding"}, 6000.0, 2,
                        ["", ""]]
    assert port[5] == ["n0", "n0"]


def test_evict_batch_write_behind_converges():
    """evict_batch is write-behind too: the cache's task is Releasing at
    the next snapshot with the executor wedged, and the pod's delete
    lands once it drains."""
    def run(side):
        store, cache, evictor = gang_store(side, n_pods=1, node="n0",
                                           phase="Running",
                                           pg_phase="Running")
        gate = threading.Event()
        cache._submit(lambda: gate.wait(5.0))
        with cache.mutex:
            job = next(iter(cache.jobs.values()))
            info = next(iter(job.tasks.values()))
        cache.evict_batch([(info, "preempted")])
        snap = cache.snapshot()
        stask = next(iter(next(iter(snap.jobs.values())).tasks.values()))
        out = [stask.status.name, snap.nodes["n0"].releasing.milli_cpu,
               list(evictor.evicts)]
        gate.set()
        assert cache.flush_executors(timeout=10)
        out += [list(evictor.evicts), store.get("pods", "p0", "ns1"),
                journal_rvs(store)]
        cache.stop()
        return out

    ref, port = both(run)
    assert port == ref
    assert port[:5] == ["Releasing", 1000.0, [], ["ns1/p0"], None]


# -- convergence under concurrent writers (tests/test_concurrency.py) --------------


def flaky_binder_cls(side):
    class FirstTryFails(side.tu.FakeBinder):
        """Fails every pod's first bind, then succeeds."""

        def __init__(self, store):
            super().__init__(store)
            self._failed = set()
            self.fail_count = 0

        def bind(self, pod, hostname):
            key = f"{pod.metadata.namespace}/{pod.metadata.name}"
            if key not in self._failed:
                self._failed.add(key)
                self.fail_count += 1
                raise RuntimeError("transient bind failure")
            super().bind(pod, hostname)

    return FirstTryFails


def conc_env(side, binder_cls=None):
    store = new_store(side)
    binder = (binder_cls or side.tu.FakeBinder)(store)
    cache = side.Cache(store, binder=binder,
                       evictor=side.tu.FakeEvictor(store))
    cache.run()
    sched = side.Scheduler(store, scheduler_conf=CONF, cache=cache,
                           **side.sched_kw)
    return store, cache, binder, sched


def converged(cache, store) -> bool:
    """The cache's view equals the store's for every pod."""
    with cache.mutex:
        tasks = {t.key(): t for j in cache.jobs.values()
                 for t in j.tasks.values()}
    for pod in store.list("pods"):
        t = tasks.get(pod.metadata.key())
        if t is None or (pod.spec.node_name
                         and t.node_name != pod.spec.node_name):
            return False
    return True


def test_resync_reconverges_after_bind_failures():
    """Every pod's first bind fails: the executor's resync reconciles the
    cache with the store (back to Pending), and the next cycle binds them
    all."""
    def run(side):
        store, cache, binder, sched = conc_env(side, flaky_binder_cls(side))
        # back-to-back cycles on the wall clock: no re-placement backoff
        cache.RESYNC_BACKOFF_BASE_SECONDS = 0.0
        tu = side.tu
        store.create("queues", tu.build_queue("default", weight=1))
        for i in range(8):
            store.create("nodes", tu.build_node(f"n{i}", {"cpu": "8",
                                                          "memory": "16Gi"}))
        for j in range(6):
            store.create("podgroups", tu.build_pod_group(
                f"pg{j}", "ns1", "default", 4, phase="Inqueue"))
            for t in range(4):
                store.create("pods", tu.build_pod(
                    "ns1", f"j{j}-t{t}", "", "Pending",
                    tu.build_resource_list("1", "1Gi"), f"pg{j}"))
        sched.run_once()
        assert cache.flush_executors(timeout=30)
        with cache.mutex:
            statuses = {t.status.name for j in cache.jobs.values()
                        for t in j.tasks.values()}
        out = [binder.fail_count, len(cache.err_tasks), statuses,
               {k: r.attempts for k, r in cache.retry_records.items()}]
        sched.run_once()
        assert cache.flush_executors(timeout=30)
        out += [dict(binder.binds), converged(cache, store),
                cache.resync_retry_total]
        cache.stop()
        return out

    ref, port = both(run)
    assert port == ref
    assert port[:3] == [24, 0, {"Pending"}]
    assert len(port[4]) == 24 and port[5]


def test_concurrent_churn_converges():
    """Writers churn pods and PodGroups from four threads while the
    scheduler cycles; once they join, the cache equals the store and the
    node accounting is consistent (the interleaving is the threads', so
    each package is held to these checks on its own run)."""
    def run(side):
        store, cache, binder, sched = conc_env(side)
        tu = side.tu
        store.create("queues", tu.build_queue("default", weight=1))
        for i in range(16):
            store.create("nodes", tu.build_node(f"n{i}", {"cpu": "32",
                                                          "memory": "64Gi"}))
        errors = []

        def churn(tid):
            rng = random.Random(tid)
            created = []
            try:
                for k in range(40):
                    j = f"c{tid}-{k}"
                    store.create("podgroups", tu.build_pod_group(
                        j, "ns1", "default", 1, phase="Inqueue"))
                    store.create("pods", tu.build_pod(
                        "ns1", f"{j}-p", "", "Pending",
                        tu.build_resource_list("1", "1Gi"), j))
                    created.append(j)
                    if rng.random() < 0.3 and created:
                        victim = created.pop(rng.randrange(len(created)))
                        if store.get("pods", f"{victim}-p", "ns1") is not None:
                            store.delete("pods", f"{victim}-p", "ns1")
                        store.delete("podgroups", victim, "ns1")
                    time.sleep(0.001)
            except Exception as e:                    # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=churn, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        cycles = 0
        while any(t.is_alive() for t in threads):
            sched.run_once()
            cycles += 1
        for t in threads:
            t.join(timeout=60)
        for _ in range(2):
            sched.run_once()
            assert cache.flush_executors(timeout=60)
        with cache.mutex:
            consistent = all(
                node.idle.milli_cpu >= -0.5
                and abs(node.idle.milli_cpu + node.used.milli_cpu
                        - node.allocatable.milli_cpu) < 0.5
                for node in cache.nodes.values())
        out = (errors, cycles >= 1, converged(cache, store), consistent,
               sorted(p.metadata.key() for p in store.list("pods")),
               all(p.spec.node_name for p in store.list("pods")))
        cache.stop()
        return out

    ref, port = both(run)
    # the same pods survive the churn (the threads' seeded choices); the
    # binds themselves depend on which cycle saw which pod
    assert port[4] == ref[4]
    for side_out in (ref, port):
        errors, cycled, conv, consistent, _, all_bound = side_out
        assert errors == [] and cycled and conv and consistent and all_bound


def test_bind_batch_races_pod_deletion():
    """bind_batch racing a store-side pod delete neither deadlocks nor
    corrupts accounting: the deleted pod's bind fails into resync, which
    reconciles against the absent object, and no task of a deleted pod
    survives."""
    def run(side):
        store, cache, binder, sched = conc_env(side)
        tu = side.tu
        store.create("queues", tu.build_queue("default", weight=1))
        for i in range(4):
            store.create("nodes", tu.build_node(f"n{i}", {"cpu": "8",
                                                          "memory": "16Gi"}))
        for j in range(10):
            store.create("podgroups", tu.build_pod_group(
                f"pg{j}", "ns1", "default", 1, phase="Inqueue"))
            store.create("pods", tu.build_pod(
                "ns1", f"p{j}", "", "Pending",
                tu.build_resource_list("1", "1Gi"), f"pg{j}"))

        def deleter():
            for j in range(0, 10, 2):
                if store.get("pods", f"p{j}", "ns1") is not None:
                    try:
                        store.delete("pods", f"p{j}", "ns1")
                    except KeyError:
                        pass
                time.sleep(0.0005)

        t = threading.Thread(target=deleter)
        t.start()
        sched.run_once()
        t.join(timeout=30)
        for _ in range(2):
            assert cache.flush_executors(timeout=30)
            sched.run_once()
        assert cache.flush_executors(timeout=30)
        with cache.mutex:
            cache_keys = sorted(t.key() for j in cache.jobs.values()
                                for t in j.tasks.values())
        out = (converged(cache, store), cache_keys,
               sorted(p.metadata.key() for p in store.list("pods")),
               sorted(p.metadata.key() for p in store.list("pods")
                      if p.spec.node_name))
        cache.stop()
        return out

    ref, port = both(run)
    assert port == ref
    conv, cache_keys, store_keys, bound = port
    assert conv and cache_keys == store_keys == bound
    assert store_keys == [f"ns1/p{j}" for j in range(1, 10, 2)]


@pytest.mark.parametrize("scenario", ["default", "preempt", "reclaim"])
def test_cycle_command_commits_alike_live_and_inline(scenario):
    """cmd.cycle's ``commit`` says who writes a cycle's binds, evictions
    and statuses: the executor after the cycle (live) or the cycle itself
    (inline, a cache whose executor never starts). Both leave the store
    in the same state, every pod and PodGroup alike."""
    from volcano_tpu_torch.cmd import cycle as cycle_cmd

    def state(store):
        return ({p.metadata.key(): p.spec.node_name
                 for p in store.list("pods")},
                {g.metadata.key(): (g.status.phase, g.status.running)
                 for g in store.list("podgroups")})

    runs = {commit: cycle_cmd.run_cycle(256, 64, 1, "cpu", scenario=scenario,
                                        commit=commit)
            for commit in ("live", "inline")}
    for commit, r in runs.items():
        assert r["commit"] == commit
    assert state(runs["live"]["store"]) == state(runs["inline"]["store"])
    assert runs["live"]["binds"] == runs["inline"]["binds"] > 0
    assert runs["live"]["evictions"] == runs["inline"]["evictions"]
    if scenario != "default":
        assert runs["live"]["evictions"] > 0


def test_cycle_command_alternates_commits(capsys):
    """``--commit alternate``: a live cold run, then warm runs in live,
    inline, inline, live order, each naming its commit."""
    from volcano_tpu_torch.cmd import cycle as cycle_cmd
    assert cycle_cmd.main(["--device", "cpu", "--tasks", "64", "--nodes",
                           "16", "--commit", "alternate", "--warm", "4"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert [r["commit"] for r in [out["cold"]] + out["warm"]] == \
        ["live", "live", "inline", "inline", "live"]
    assert len({r["binds"] for r in [out["cold"]] + out["warm"]}) == 1
