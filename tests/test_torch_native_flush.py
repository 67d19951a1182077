"""The port's native commit path (volcano_tpu_torch/native/fastmodel.c:
publish_shard, bind_clone_pods, attr_eq_filter_pairs, bind_apply_bursts,
bind_echo_apply, bind_request_items, ledger_confirm_runs and the
snapshot's clones) held against its Python bodies and against the JAX
package on both of its engines.

tests/test_flush_pipeline.py's TestNativeParity through both packages: a
whole coalesced flush (write-behind apply, sharded store commit, echo
ingest, ledger completion, then a snapshot) must leave the same journal,
rvs, binds, cache state, snapshot and ledger fingerprint on every engine
of either package, with every switch on, every switch off, and one switch
at a time; the raising patch fn leaves the same state through both
publish engines. Its TestFilterFlipWatchers with a filter declared by
``filter_attr``. Then the designed hand-backs, each with the pairs or
gangs it hands back interleaved with the ones it takes: the echo (pairs
of another writer, declined guards, a job without its PodGroup, a task
the job holds as another object) and the apply (a node whose fit is
refused). Equality is exact: these are host objects.
"""

import threading
from types import SimpleNamespace

import pytest

import volcano_tpu.apiserver.store as ref_store_mod
import volcano_tpu.cache.cache as ref_cache_mod
import volcano_tpu.cache.event_handlers as ref_handlers
import volcano_tpu.trace.ledger as ref_ledger
import volcano_tpu.utils.test_utils as ref_tu
import volcano_tpu_torch.apiserver.store as port_store_mod
import volcano_tpu_torch.cache.cache as port_cache_mod
import volcano_tpu_torch.cache.event_handlers as port_handlers
import volcano_tpu_torch.models.job_info as port_ji
import volcano_tpu_torch.trace.ledger as port_ledger
import volcano_tpu_torch.utils.test_utils as port_tu
from volcano_tpu.utils.clock import FakeClock as RefFakeClock
from volcano_tpu_torch.utils.clock import FakeClock as PortFakeClock

REF = SimpleNamespace(
    name="ref", Store=ref_store_mod.ObjectStore,
    Cache=ref_cache_mod.SchedulerCache, ledger=ref_ledger, tu=ref_tu,
    Clock=RefFakeClock, write_kw={"skip_admission": True},
    switches={"NATIVE_PUBLISH": (ref_store_mod.ObjectStore, "NATIVE_PUBLISH"),
              "NATIVE_APPLY": (ref_cache_mod.SchedulerCache, "NATIVE_APPLY"),
              "NATIVE_ECHO": (ref_handlers.EventHandlersMixin,
                              "NATIVE_ECHO"),
              "NATIVE_CONFIRM": (ref_ledger, "NATIVE_CONFIRM")})
PORT = SimpleNamespace(
    name="port", Store=port_store_mod.ObjectStore,
    Cache=port_cache_mod.SchedulerCache, ledger=port_ledger, tu=port_tu,
    Clock=PortFakeClock, write_kw={},
    switches={"NATIVE_PUBLISH": (port_store_mod.ObjectStore,
                                 "NATIVE_PUBLISH"),
              "NATIVE_APPLY": (port_cache_mod.SchedulerCache,
                               "NATIVE_APPLY"),
              "NATIVE_ECHO": (port_handlers.EventHandlersMixin,
                              "NATIVE_ECHO"),
              "NATIVE_CONFIRM": (port_ledger, "NATIVE_CONFIRM"),
              "NATIVE_CLONE": (port_ji, "NATIVE_CLONE")})
ENGINES = ["native", "python"]


def set_engine(side, engine: str, **only) -> None:
    """Every switch of ``side`` to ``engine``; ``only`` overrides some."""
    for name, (owner, attr) in side.switches.items():
        setattr(owner, attr, only.get(name, engine == "native"))


@pytest.fixture(autouse=True)
def _restore_engines():
    yield
    for side in (REF, PORT):
        set_engine(side, "native")


def store_fp(store) -> list:
    with store._lock:
        assert store._journal_tail == store._rv
        assert not store._journal_parked
        assert not any(store._inflight.values())
        journal = [(rv, action, kind, store.key_of(kind, o),
                    getattr(o.spec, "node_name", ""))
                   for rv, action, kind, o in store._journal]
    pods = [(p.metadata.key(), p.metadata.resource_version,
             p.spec.node_name)
            for p in sorted(store.list_refs("pods"),
                            key=lambda p: p.metadata.key())]
    return [journal, pods]


def cache_fp(jobs, nodes) -> list:
    out = []
    for uid in sorted(jobs):
        job = jobs[uid]
        out.append((uid, job.allocated.milli_cpu, job.allocated.memory,
                    dict(job.allocated.scalars),
                    job.pending_request.milli_cpu,
                    job.total_request.milli_cpu,
                    [(t, job.tasks[t].status.name, job.tasks[t].node_name,
                      job.tasks[t].pod.metadata.resource_version)
                     for t in sorted(job.tasks)],
                    [(st.name, list(job.task_status_index[st]))
                     for st in job.task_status_index]))
    for name in sorted(nodes):
        n = nodes[name]
        out.append((name, n.idle.milli_cpu, n.idle.memory,
                    dict(n.idle.scalars), n.used.milli_cpu, n.used.memory,
                    [(k, t.status.name, t.node_name,
                      t.pod.metadata.resource_version)
                     for k, t in n.tasks.items()]))
    return out


def run_flush(side, engine: str, only=None, n_jobs=64, gang=8, n_nodes=16,
              small_node=False):
    """One coalesced cache flush on a virtual clock (the reference's
    TestNativeParity._run_flush), then a snapshot; a fingerprint of every
    observable. ``small_node`` gives node-0 room for 3 tasks, so the
    apply's combined fit is refused there."""
    set_engine(side, engine, **(only or {}))
    store = side.Store(clock=side.Clock(start=1.0))
    store.SHARD_SERIAL_MAX = 0
    store.SHARD_TARGET = n_jobs * gang // 4      # four shards
    binder = side.tu.FakeBinder(store)
    cache = side.Cache(store, binder=binder,
                       evictor=side.tu.FakeEvictor(store))
    cache.run()
    tu = side.tu
    store.create("queues", tu.build_queue("default", weight=1))
    for i in range(n_nodes):
        cpu = "6" if small_node and i == 0 else "640"
        store.create("nodes", tu.build_node(
            f"node-{i}", {"cpu": cpu, "memory": "2560Gi", "pods": "1100",
                          "nvidia.com/gpu": "64"}))
    for j in range(n_jobs):
        store.create("podgroups", tu.build_pod_group(
            f"pg-{j}", "default", "default", gang, phase="Inqueue"))
        for t in range(gang):
            req = {"cpu": "2", "memory": "4Gi"}
            if j % 4 == 1:
                req["nvidia.com/gpu"] = "1"
            store.create("pods", tu.build_pod(
                "default", f"job{j}-task{t}", "", "Pending", req,
                groupname=f"pg-{j}"))
    L = side.ledger
    L.reset()
    L.enable()
    try:
        with cache.mutex:
            for job in cache.jobs.values():
                for t in job.tasks.values():
                    L.stamp(t.key(), "submitted", store.clock.now(),
                            job=t.job)
            gangs = []
            i = 0
            for job in sorted(cache.jobs.values(), key=lambda j: j.uid):
                pairs = []
                for t in sorted(job.tasks.values(), key=lambda t: t.uid):
                    pairs.append((t, f"node-{i % n_nodes}"))
                    i += 1
                gangs.append(pairs)
        for pairs in gangs:
            cache.bind_batch(pairs)
        assert cache.flush_executors(timeout=60.0)
        with cache.mutex:
            live = cache_fp(cache.jobs, cache.nodes)
        snap = cache.snapshot()
        stats = L.stats()
        report = L.report()
        # the flush's correlation IDs count the executor's drains, which
        # depend on how the gangs' recording and the drains interleave
        for r in report["recent"]:
            r.pop("trace")
        return {"store": store_fp(store), "cache": live,
                "snapshot": cache_fp(snap.jobs, snap.nodes),
                "binds": dict(binder.binds), "ledger": L.fingerprint(),
                "report": report, "completed": stats["completed"],
                "open": stats["open"]}
    finally:
        cache.stop()
        L.disable()
        L.reset()


# -- TestNativeParity through both packages ----------------------------------


@pytest.mark.parametrize("port_engine", ENGINES)
@pytest.mark.parametrize("ref_engine", ENGINES)
def test_flush_equal_across_packages_and_engines(ref_engine, port_engine):
    ref = run_flush(REF, ref_engine)
    port = run_flush(PORT, port_engine)
    assert port["completed"] == 64 * 8 and port["open"] == 0
    for k in ref:
        assert port[k] == ref[k], k


@pytest.mark.parametrize("switch", sorted(PORT.switches))
def test_per_switch_native_parity(switch):
    """One native entry at a time: a flush with only this switch on
    equals the all-Python flush of either package (the all-on test can
    hide two engines whose differences cancel)."""
    only = run_flush(PORT, "python", only={switch: True}, n_jobs=16)
    pure = run_flush(PORT, "python", n_jobs=16)
    ref = run_flush(REF, "python", n_jobs=16)
    assert only == pure
    for k in ref:
        assert only[k] == ref[k], k


@pytest.mark.parametrize("port_engine", ENGINES)
@pytest.mark.parametrize("ref_engine", ENGINES)
def test_flush_with_a_refused_fit(ref_engine, port_engine):
    """node-0 fits 3 of the tasks sent there: the native apply hands the
    whole run back (nothing changed) and the Python body replays that
    node per task; the binds, the heal and the state equal the
    reference's on every engine."""
    ref = run_flush(REF, ref_engine, n_jobs=8, small_node=True)
    port = run_flush(PORT, port_engine, n_jobs=8, small_node=True)
    assert port["completed"] < 8 * 8
    for k in ref:
        assert port[k] == ref[k], k


def sharded(store, target=2, cap=4):
    store.SHARD_SERIAL_MAX = 0
    store.SHARD_TARGET = target
    store.SHARD_MAX = cap
    return store


def store_with_pods(side, n):
    store = side.Store()
    for i in range(n):
        store.create("pods", side.tu.build_pod(
            "ns1", f"p{i:03d}", "", "Pending", {"cpu": "1", "memory": "1Gi"}))
    return store


def setter(host):
    def fn(p):
        p.spec.node_name = host
    return fn


@pytest.mark.parametrize("engine", ENGINES)
def test_publish_raising_fn_state(engine):
    """The raising patch fn (a no-op version, a gap-free journal, the
    error re-raised) leaves the same state through both publish engines
    of both packages."""
    outs = []
    for side in (REF, PORT):
        set_engine(side, engine)
        store = sharded(store_with_pods(side, 6))

        def boom(p):
            raise RuntimeError("bad patch")

        with pytest.raises(RuntimeError, match="bad patch"):
            store.patch_batch("pods", [
                (f"p{i:03d}", "ns1", boom if i == 3 else setter(f"n{i}"))
                for i in range(6)])
        outs.append(store_fp(store))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("engine", ENGINES)
def test_bind_pods_sharded_equal_across_packages(engine):
    """bind_pods on the sharded path (the native bind clone), a missing
    pod among them: stored pods, rvs, journal and delivered pairs."""
    outs = []
    for side in (REF, PORT):
        set_engine(side, engine)
        store = sharded(store_with_pods(side, 10), target=3)
        bulk = []
        store.watch("pods", on_bulk_update=lambda ps: bulk.extend(
            (o.metadata.name, n.metadata.resource_version, n.spec.node_name)
            for o, n in ps), sync=False)
        pairs, missing = store.bind_pods(
            [(f"p{i:03d}", "ns1", f"n{i % 3}") for i in range(10)]
            + [("ghost", "ns1", "nx")])
        assert missing == [("ghost", "ns1")]
        outs.append((store_fp(store), bulk,
                     [(o.metadata.name, n.metadata.resource_version)
                      for o, n in pairs]))
    assert outs[0] == outs[1]


# -- TestFilterFlipWatchers with a declared filter ---------------------------


def flip_store(side):
    store = side.Store()
    for i in range(6):
        pod = side.tu.build_pod("ns1", f"p{i:03d}", "", "Pending",
                                {"cpu": "1", "memory": "1Gi"})
        pod.spec.scheduler_name = "volcano" if i < 2 else "other"
        store.create("pods", pod)
    return store


def sched(name):
    def fn(p):
        p.spec.scheduler_name = name
    return fn


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("bulk_handler", [False, True])
@pytest.mark.parametrize("force_sharded", [False, True])
def test_filter_flips_with_filter_attr(force_sharded, bulk_handler, engine):
    """A watcher whose filter (declared as spec.scheduler_name ==
    "volcano") flips pass->fail or fail->pass mid-burst sees on_delete
    and on_add, not an update, on every delivery path and engine, the
    same in both packages."""
    gots = []
    for side in (REF, PORT):
        set_engine(side, engine)
        store = flip_store(side)
        if force_sharded:
            sharded(store)
        got = {"add": [], "delete": [], "update": [], "bulk": []}
        kwargs = dict(
            on_add=lambda o: got["add"].append(o.metadata.name),
            on_delete=lambda o: got["delete"].append(o.metadata.name),
            filter_fn=lambda p: p.spec.scheduler_name == "volcano",
            filter_attr=(("spec", "scheduler_name"), "volcano"),
            sync=False)
        if bulk_handler:
            kwargs["on_bulk_update"] = lambda pairs: got["bulk"].extend(
                (o.metadata.name, n.metadata.name) for o, n in pairs)
        else:
            kwargs["on_update"] = lambda o, n: got["update"].append(
                o.metadata.name)
        store.watch("pods", **kwargs)
        store.patch_batch("pods", [
            ("p000", "ns1", sched("volcano")),     # pass -> pass
            ("p001", "ns1", sched("other")),       # pass -> fail
            ("p004", "ns1", sched("volcano")),     # fail -> pass
            ("p005", "ns1", sched("other")),       # fail -> fail
        ])
        assert got["add"] == ["p004"] and got["delete"] == ["p001"]
        if bulk_handler:
            assert got["bulk"] == [("p000", "p000")] and not got["update"]
        else:
            assert got["update"] == ["p000"] and not got["bulk"]
        gots.append((got, store_fp(store)))
    assert gots[0] == gots[1]


@pytest.mark.parametrize("side", [REF, PORT], ids=["ref", "port"])
def test_cache_declares_its_pod_filter(side):
    """The cache's pods watch declares the filter _responsible_for
    evaluates."""
    store = side.Store()
    cache = side.Cache(store, scheduler_name="sched-x")
    cache.run()
    try:
        (w,) = store._watches["pods"]
        assert w.filter_attr == (("spec", "scheduler_name"), "sched-x")
        for name in ("sched-x", "volcano", None):
            pod = side.tu.build_pod("ns1", "p", "", "Pending",
                                    {"cpu": "1"})
            pod.spec.scheduler_name = name
            assert w.filter_fn(pod) == (name == "sched-x")
    finally:
        cache.stop()


# -- the designed hand-backs, interleaved -------------------------------------


def echo_case(side, engine: str):
    """update_pods_bulk over one delivery that mixes the cache's own bind
    echoes with pairs the native pass hands back: a declined guard (the
    echo names another node than the hint), another writer's patch of a
    bound pod (no hint), a pod of an unknown job, a hinted task the job
    no longer holds as that object. Returns the cache's state, the
    dirty sets and the ledger's."""
    set_engine(side, engine)
    tu = side.tu
    store = side.Store(clock=side.Clock(start=1.0))
    cache = side.Cache(store, binder=tu.FakeBinder(store),
                       evictor=tu.FakeEvictor(store))
    store.create("queues", tu.build_queue("default"))
    store.create("queues", tu.build_queue("q2"))
    for i in range(3):
        store.create("nodes", tu.build_node(
            f"n{i}", {"cpu": "64", "memory": "256Gi", "pods": "110"}))
    for j, q in enumerate(("default", "q2", "default")):
        store.create("podgroups", tu.build_pod_group(
            f"pg{j}", "ns", q, 2, phase="Inqueue"))
        for t in range(3):
            store.create("pods", tu.build_pod(
                "ns", f"j{j}-t{t}", "", "Pending",
                {"cpu": "1", "memory": "1Gi"}, groupname=f"pg{j}"))
    store.create("pods", tu.build_pod("ns", "orphan", "", "Pending",
                                      {"cpu": "1", "memory": "1Gi"},
                                      groupname="pg-gone"))
    cache.run()
    L = side.ledger
    L.reset()
    L.enable()
    try:
        with cache.mutex:
            for job in cache.jobs.values():
                for t in job.tasks.values():
                    L.stamp(t.key(), "submitted", 1.0, job=t.job)
        bound = []
        for j in range(3):
            pairs = [(cache.jobs[f"ns/pg{j}"].tasks[f"ns-j{j}-t{t}"],
                      f"n{(j + t) % 3}") for t in range(3)]
            bound.append(cache.bind_batch(pairs))
        cache.flush_executors()
        with cache.mutex:
            # the flush's echo completed the entries: open them again for
            # the delivery below
            for job in cache.jobs.values():
                for t in job.tasks.values():
                    L.stamp(t.key(), "submitted", 2.0, job=t.job)
            cache._dirty_jobs.clear()
            cache._dirty_nodes.clear()
            hint = {}
            for j in range(3):
                for t in range(3):
                    task = cache.jobs[f"ns/pg{j}"].tasks[f"ns-j{j}-t{t}"]
                    hint[task.uid] = (task, task.node_name)
            # the hinted host is another node for j0-t1: a declined guard
            t1 = hint["ns-j0-t1"]
            hint["ns-j0-t1"] = (t1[0], "n-other")
            # j2-t2: the job holds another object under its uid
            job2 = cache.jobs["ns/pg2"]
            job2.tasks["ns-j2-t2"] = job2.tasks["ns-j2-t2"].clone()
        pairs = []
        order = ["j0-t0", "j0-t1", "j0-t2", "orphan", "j1-t0", "j1-t1",
                 "j2-t0", "j2-t1", "j2-t2", "j1-t2"]
        rv = store.current_rv()
        for name in order:
            old = store.get("pods", name, "ns")
            new = store.get("pods", name, "ns")
            rv += 1
            new.metadata.resource_version = rv
            pairs.append((old, new))
        # j1's pods are another writer's patch: no hint for them
        for name in ("j1-t0", "j1-t1", "j1-t2"):
            hint.pop(f"ns-{name}")
        cache._expected_bind_echo = (threading.get_ident(), hint)
        cache.update_pods_bulk(pairs)
        cache._expected_bind_echo = None
        with cache.mutex:
            state = (cache_fp(cache.jobs, cache.nodes),
                     sorted(cache._dirty_jobs), sorted(cache._dirty_nodes),
                     {uid: j._status_version
                      for uid, j in sorted(cache.jobs.items())})
        report = L.report()
        for r in report["recent"]:   # drain-dependent correlation IDs
            r.pop("trace")
        return (state, L.fingerprint(), report,
                L.stats()["completed"], [b is not None for b in bound])
    finally:
        cache.stop()
        L.disable()
        L.reset()


def test_echo_hand_backs_interleaved():
    """The port's two engines leave the same state, dirty sets, status
    versions and ledger; the native pass took some pairs and handed the
    others back."""
    native, python = (echo_case(PORT, e) for e in ENGINES)
    assert native == python
    assert native[3] > 9


@pytest.mark.parametrize("engine", ENGINES)
def test_echo_hand_backs_against_the_reference(engine):
    """The cache state and the ledger equal the reference's Python body's
    on both of the port's engines (its echo moves a run of a job's tasks
    in one bulk move, so the status versions are the port's own). The
    reference's native echo is not the yardstick on this delivery: it
    takes every hinted pair first and the rest after, so a status index
    and the ledger's order differ from its own Python body's where
    handed-back pairs sit between taken ones; the port's native pass
    keeps the delivery's order."""
    p_state, *p_ledger = echo_case(PORT, engine)
    r_state, *r_ledger = echo_case(REF, "python")
    assert p_state[:3] == r_state[:3]
    assert p_ledger == r_ledger


def test_native_echo_stops_at_the_first_pair_it_hands_back():
    """bind_echo_apply returns the index of the first pair it does not
    take and changes nothing from there on."""
    fm = port_ji._fastmodel()
    store = PORT.Store()
    pod = PORT.tu.build_pod("ns", "a", "n0", "Running", {"cpu": "1"}, "pg")
    store.create("pods", pod)
    pairs = [(pod, pod), (pod, pod)]
    assert fm.bind_echo_apply(pairs, 0, {}, {}, {}, None) == 0
    assert fm.bind_echo_apply(pairs, 2, {}, {}, {}, None) == 2
    assert fm.bind_echo_apply([], 0, {}, {}, {}, []) == 0


def test_native_entries_take_the_flush(monkeypatch):
    """On the native engine every entry of the path runs in the flush and
    takes its work: the apply returns True, the echo every pair, the bind
    clone and the request their lists (no hand-back on a regular flush)."""
    fm = port_ji._fastmodel()
    calls = {}

    def counted(name, took):
        real = getattr(fm, name)

        def wrapper(*args):
            out = real(*args)
            c = calls.setdefault(name, [0, 0])
            c[0] += 1
            c[1] += bool(took(args, out))
            return out
        monkeypatch.setattr(fm, name, wrapper)

    always = lambda args, out: True  # noqa: E731
    counted("bind_apply_bursts", lambda args, out: out is True)
    counted("bind_echo_apply", lambda args, out: out == len(args[0]))
    counted("bind_clone_pods", lambda args, out: out is not None)
    counted("bind_request_items", lambda args, out: out is not None)
    for name in ("publish_shard", "attr_eq_filter_pairs",
                 "ledger_confirm_runs", "clone_task_table",
                 "clone_task_dict", "clone_resource"):
        counted(name, always)
    out = run_flush(PORT, "native", n_jobs=16)
    assert out["completed"] == 16 * 8
    assert set(calls) == {
        "bind_apply_bursts", "bind_echo_apply", "bind_clone_pods",
        "bind_request_items", "publish_shard", "attr_eq_filter_pairs",
        "ledger_confirm_runs", "clone_task_table", "clone_task_dict",
        "clone_resource"}, calls
    for name, (n, took) in calls.items():
        assert n > 0 and took == n, (name, n, took)
