"""The incremental steady-state cycle of the port
(docs/design/incremental_cycle.md) held against the JAX package's.

The cases of tests/test_incremental.py that need no layer the port lacks
run once per package on stores built by each package's own builders, and
what each observes (snapshot modes, patched sets, dirty sets, counters)
must agree. The reference's simulator is not ported, so the
equivalence of the incremental and the full cycle is checked on a seeded
churn loop driven by hand: gang arrivals, pod deletions and failures,
node cordons and one queue edit, drawn with numpy from a seed. Three runs
(the port with ``incremental=True``, the port with ``incremental=False``
and the reference at its default) must agree after every cycle.

Tolerance: exact. Binds (pod -> node, read back from the store), evicted
pod keys in eviction order, PodGroup phases and conditions (type,
status, reason, message).

Every Env runs its cache, so the executor is live: binds are written
behind the cycle, and each cycle ends with ``flush_executors()``.
"""

import threading

import numpy as np
import pytest

from volcano_tpu import framework as ref_framework
from volcano_tpu.apiserver import ObjectStore as RefStore
from volcano_tpu.cache import SchedulerCache as RefCache
from volcano_tpu.framework.solver import reset_breaker
from volcano_tpu.metrics import metrics as ref_m
from volcano_tpu.models import objects as ref_obj
from volcano_tpu.scheduler import Scheduler as RefScheduler
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu_torch import framework as port_framework
from volcano_tpu_torch.apiserver import ObjectStore as PortStore
from volcano_tpu_torch.cache import SchedulerCache as PortCache
from volcano_tpu_torch.metrics import metrics as port_m
from volcano_tpu_torch.models import objects as port_obj
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler
from volcano_tpu_torch.utils import test_utils as port_tu

from tests.test_torch_cycle import ZONE, HOSTNAME, outcome

CONF = """
actions: "enqueue, allocate, backfill"
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


class Side:
    """One package's classes, and the arguments its Scheduler and its
    store writes take."""

    def __init__(self, name, store, cache, sched, tu, obj, metrics,
                 framework, sched_kw, write_kw):
        self.name, self.Store, self.Cache, self.Scheduler = \
            name, store, cache, sched
        self.tu, self.obj, self.m, self.framework = \
            tu, obj, metrics, framework
        self.sched_kw, self.write_kw = sched_kw, write_kw


REF = Side("ref", RefStore, RefCache, RefScheduler, ref_tu, ref_obj, ref_m,
           ref_framework, {}, {"skip_admission": True})
PORT = Side("port", PortStore, PortCache, PortScheduler, port_tu, port_obj,
            port_m, port_framework, {"device": "cpu"}, {})
SIDES = (REF, PORT)


class Env:
    """A store, a cache with the fake binder and evictor, and a
    Scheduler of one side."""

    def __init__(self, side, incremental=True, conf=CONF, n_nodes=6,
                 node_cpu="16", node_mem="32Gi", queues=(("default", 1),),
                 seed_objects=None):
        tu = side.tu
        self.side = side
        self.store = store = side.Store()
        self.binder = tu.FakeBinder(store)
        self.evictor = tu.FakeEvictor(store)
        self.cache = side.Cache(store, binder=self.binder,
                                evictor=self.evictor)
        kw = dict(side.sched_kw)
        if incremental is not None:
            kw["incremental"] = incremental
        self.sched = side.Scheduler(store, cache=self.cache,
                                    scheduler_conf=conf, **kw)
        for name, weight in queues:
            q = tu.build_queue(name, weight=weight)
            q.metadata.creation_timestamp = 1.0
            store.create("queues", q)
        for i in range(n_nodes):
            node = tu.build_node(f"node-{i:02d}", {
                "cpu": node_cpu, "memory": node_mem, "pods": "110"})
            node.metadata.creation_timestamp = 1.0
            store.create("nodes", node)
        if seed_objects is not None:
            seed_objects(self)
        self.cache.run()

    def gang(self, name, size=3, cpu="2", queue="default", ts=10.0,
             pc="", labels=None, spread=None, node="", phase="Pending"):
        tu, o = self.side.tu, self.side.obj
        pg = tu.build_pod_group(name, "default", queue, size,
                                phase="Inqueue" if not node else "Running",
                                priority_class=pc)
        pg.metadata.creation_timestamp = ts
        self.store.create("podgroups", pg)
        for t in range(size):
            pod = tu.build_pod("default", f"{name}-{t}",
                               node if isinstance(node, str) else node[t],
                               phase, {"cpu": cpu, "memory": "4Gi"},
                               groupname=name, labels=dict(labels or {}))
            pod.metadata.creation_timestamp = ts
            if spread:
                pod.spec.topology_spread = [o.TopologySpreadConstraint(
                    max_skew=1, topology_key=key, when_unsatisfiable=mode)
                    for key, mode in spread]
            self.store.create("pods", pod)

    def update(self, kind, o):
        self.store.update(kind, o, **self.side.write_kw)

    def delete(self, kind, name, ns="default"):
        self.store.delete(kind, name, ns, **self.side.write_kw)

    def cycle(self):
        self.sched.run_once()
        self.cache.flush_executors()

    def outcome(self):
        binds, phases, conds = outcome(self.store)
        return binds, list(self.evictor.evicts), phases, conds


def both(fn):
    """``fn(side)`` for the reference and the port; both results."""
    return fn(REF), fn(PORT)


def counter(side, name, **labels):
    key = (name, tuple(sorted(labels.items())))
    with side.m._lock:
        return side.m._counters.get(key, 0.0)


# ---------------------------------------------------------------------------
# dirty-set semantics
# ---------------------------------------------------------------------------

def test_self_echo_does_not_dirty():
    """A commit's own bind echo leaves no dirty residue beyond the bind's
    staging (consumed by the next snapshot), while a foreign pod patch of
    the same shape dirties its job."""
    def run(side):
        env = Env(side)
        env.gang("gang-a")
        env.cycle()
        binds = len(env.binder.binds)
        env.cycle()
        snap = env.cache.snapshot()
        clean = (snap.incr_mode, sorted(snap.patched_jobs),
                 sorted(snap.patched_nodes))
        env.store.patch_batch("pods", [("gang-a-0", "default",
                                        lambda pod: None)])
        snap = env.cache.snapshot()
        foreign = "default/gang-a" in snap.patched_jobs
        env.cache.stop()
        return binds, clean, foreign

    ref, port = both(run)
    assert port == ref
    assert port == (3, ("incremental", [], []), True)


def test_update_pods_bulk_hint_skips_dirty():
    """The same delivery does not dirty under the binding thread's
    expected-echo hint, and dirties without it."""
    def run(side):
        env = Env(side)
        env.gang("gang-b")
        env.cycle()
        env.cycle()
        cache = env.cache
        cache.snapshot()
        task = next(iter(cache.jobs["default/gang-b"].tasks.values()))
        old = env.store.get("pods", task.name, task.namespace)
        cache._expected_bind_echo = (threading.get_ident(),
                                     {task.uid: (task, task.node_name)})
        try:
            cache.update_pods_bulk([(old, old)])
        finally:
            cache._expected_bind_echo = None
        hinted = "default/gang-b" in cache._dirty_jobs
        cache.update_pods_bulk([(old, old)])
        plain = "default/gang-b" in cache._dirty_jobs
        cache.stop()
        return hinted, plain

    ref, port = both(run)
    assert port == ref == (False, True)


def test_structural_change_forces_full_rebuild():
    """Queue and priority-class edits rebuild the persistent snapshot;
    the snapshot after is incremental again."""
    def run(side):
        env = Env(side)
        env.gang("gang-c")
        env.cycle()
        env.cycle()
        modes = [env.cache.snapshot().incr_mode]
        env.store.create("priorityclasses", side.obj.PriorityClass(
            metadata=side.obj.ObjectMeta(name="high"), value=9))
        modes += [env.cache.snapshot().incr_mode,
                  env.cache.snapshot().incr_mode]
        env.update("queues", env.store.get("queues", "default"))
        modes.append(env.cache.snapshot().incr_mode)
        env.cache.stop()
        return modes

    ref, port = both(run)
    assert port == ref == ["incremental", "full", "incremental", "full"]


def test_periodic_full_recompute_cadence():
    def run(side):
        env = Env(side)
        env.cache.INCR_FULL_RECOMPUTE_EVERY_CYCLES = 3
        env.gang("gang-e")
        modes = []
        for _ in range(7):
            env.sched.run_once()
            modes.append(env.cache.last_snapshot_stats["mode"])
        env.cache.flush_executors()
        env.cache.stop()
        return modes

    ref, port = both(run)
    assert port == ref
    assert port[0] == port[3] == port[6] == "full"
    assert {port[i] for i in (1, 2, 4, 5)} == {"incremental"}


def test_fingerprint_repair_invalidates_snapshot():
    """An anti-entropy pass that repaired divergence means the watch
    stream, and so the dirty sets, lied: the persistent snapshot is
    rebuilt. A clean pass leaves it incremental."""
    def run(side):
        env = Env(side)
        env.gang("gang-d")
        env.cycle()
        env.cycle()
        modes = [env.cache.snapshot().incr_mode]
        clean = env.cache.anti_entropy()
        modes.append(env.cache.snapshot().incr_mode)
        # diverge the cache behind the watch's back, then repair
        with env.cache.mutex:
            env.cache.nodes.pop("node-05")
            env.cache.node_list.remove("node-05")
        repaired = env.cache.anti_entropy()
        modes.append(env.cache.snapshot().incr_mode)
        modes.append(env.cache.snapshot().incr_mode)
        nodes = sorted(env.cache.nodes)
        env.cache.stop()
        return clean, repaired, modes, nodes

    ref, port = both(run)
    assert port == ref
    clean, repaired, modes, nodes = port
    assert clean["repaired"] == 0 and clean["divergent"] == []
    assert repaired["divergent"] == ["nodes"] and repaired["repaired"] >= 1
    assert modes == ["incremental", "incremental", "full", "incremental"]
    assert "node-05" in nodes


def test_retry_backoff_jobs_stay_in_working_set():
    """A bind backoff ends with no watch delta: the job of a live retry
    record is patched by every snapshot, and no longer once the record is
    gone."""
    def run(side):
        from volcano_tpu.cache.cache import _RetryRecord as RefRecord
        from volcano_tpu_torch.cache.cache import _RetryRecord as PortRecord
        env = Env(side)
        env.gang("gang-f")
        env.cycle()
        env.cycle()
        env.cache.snapshot()
        rec = (RefRecord if side is REF else PortRecord)(
            "default/gang-f-0", "default/gang-f")
        rec.attempts = 1
        rec.not_before = env.store.clock.now() + 60.0
        env.cache.retry_records[rec.key] = rec
        seen = ["default/gang-f" in env.cache.snapshot().patched_jobs
                for _ in range(2)]
        ineligible = env.cache.bind_ineligible()
        del env.cache.retry_records[rec.key]
        seen.append("default/gang-f" in env.cache.snapshot().patched_jobs)
        env.cache.stop()
        return seen, ineligible

    ref, port = both(run)
    assert port == ref
    assert port[0] == [True, True, False]
    assert list(port[1]) == ["default/gang-f-0"]


# ---------------------------------------------------------------------------
# snapshot content
# ---------------------------------------------------------------------------

def test_patched_snapshot_matches_full_rebuild():
    """After a pod deletion, a drained node and a new gang, the patched
    snapshot equals a rebuild of the same cache in content and in order
    (dict order sets the order of float sums downstream), and so does
    the reference's."""
    def run(side):
        env = Env(side)
        for j in range(4):
            env.gang(f"gang-g{j}")
        env.cycle()
        env.delete("pods", "gang-g0-1")
        node = env.store.get("nodes", "node-02")
        node.spec.unschedulable = True
        env.update("nodes", node)
        env.gang("gang-h")
        env.cycle()
        env.cycle()
        cache = env.cache
        snap = cache.snapshot()
        with cache.mutex:
            full = cache._snapshot_locked()
        assert snap.incr_mode == "incremental"
        assert list(snap.jobs) == list(full.jobs)
        assert list(snap.nodes) == list(full.nodes)
        assert snap.node_list == full.node_list
        for uid, job in full.jobs.items():
            pj = snap.jobs[uid]
            assert {u: t.status for u, t in pj.tasks.items()} == \
                {u: t.status for u, t in job.tasks.items()}
            assert pj.priority == job.priority
            assert pj.pod_group.status.phase == job.pod_group.status.phase
        for name, ninfo in full.nodes.items():
            pn = snap.nodes[name]
            assert (pn.idle.milli_cpu, pn.idle.memory) == \
                (ninfo.idle.milli_cpu, ninfo.idle.memory)
            assert sorted(pn.tasks) == sorted(ninfo.tasks)
        total = [0.0, 0.0]
        for n in full.nodes.values():
            total[0] += n.allocatable.milli_cpu
            total[1] += n.allocatable.memory
        assert [snap.total_resource.milli_cpu,
                snap.total_resource.memory] == total
        view = ({u: sorted((t.name, str(t.status), t.node_name)
                           for t in j.tasks.values())
                 for u, j in snap.jobs.items()},
                {n: (ni.idle.milli_cpu, ni.idle.memory)
                 for n, ni in snap.nodes.items()})
        cache.stop()
        return view

    ref, port = both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# the quiet cycle, the resident node tensors, the metrics
# ---------------------------------------------------------------------------

def test_quiet_cycle_skips_plugin_opens():
    def run(side):
        env = Env(side)
        env.gang("gang-i")
        for _ in range(3):
            env.cycle()
        fw = side.framework
        conf = fw.parse_scheduler_conf(CONF)
        kw = dict(side.sched_kw)
        ssn = fw.open_session(env.cache, conf.tiers, conf.configurations,
                              actions=conf.actions, **kw)
        try:
            quiet = (ssn.quiet_cycle, ssn.plugins == {},
                     ssn.total_resource is not None)
        finally:
            fw.close_session(ssn)
        # without the action list the quiet path never engages
        ssn = fw.open_session(env.cache, conf.tiers, conf.configurations,
                              **kw)
        try:
            loud = (ssn.quiet_cycle, bool(ssn.plugins))
        finally:
            fw.close_session(ssn)
        env.cache.stop()
        return quiet, loud

    ref, port = both(run)
    assert port == ref == ((True, True, True), (False, True))


def test_device_buffer_reuse_and_scoped_transfer():
    """Across incremental cycles with pending work the solver reuses its
    resident node tensors, copying in only the dirty rows: the second
    place copies less than the first; here on CPU tensors."""
    def run(side):
        m = side.m
        env = Env(side)
        env.gang("gang-j", size=2)
        xfer0 = counter(side, m.DEVICE_TRANSFER_BYTES)
        env.cycle()                     # full snapshot; buffers built
        full_stage = counter(side, m.DEVICE_TRANSFER_BYTES) - xfer0
        rebuilds0 = counter(side, m.SOLVER_DEVICE_BUFFER, event="rebuild")
        reuse0 = counter(side, m.SOLVER_DEVICE_BUFFER, event="reuse")
        env.gang("gang-k", size=2)
        xfer1 = counter(side, m.DEVICE_TRANSFER_BYTES)
        env.cycle()                     # incremental; the kernel again
        incr_stage = counter(side, m.DEVICE_TRANSFER_BYTES) - xfer1
        out = (env.cache.last_snapshot_stats["mode"],
               rebuilds0 >= 1 and full_stage > 0,
               counter(side, m.SOLVER_DEVICE_BUFFER, event="reuse") > reuse0,
               counter(side, m.SOLVER_DEVICE_BUFFER, event="rebuild")
               == rebuilds0,
               0 < incr_stage < full_stage)
        env.cache.stop()
        return out

    ref, port = both(run)
    assert port == ref == ("incremental", True, True, True, True)


def test_resident_node_rows_track_the_snapshot():
    """The port's resident tensors after a churn cycle hold what a fresh
    upload of that session's NodeArrays would, and a cycle that places
    nothing new and patches no node copies no node row."""
    import torch
    from volcano_tpu_torch.framework.solver import NODE_FIELDS
    from volcano_tpu_torch.models.arrays import NodeArrays
    env = Env(PORT, n_nodes=8)
    env.gang("gang-r0", size=4)
    env.cycle()
    env.gang("gang-r1", size=4)
    env.delete("pods", "gang-r0-1")
    env.cycle()
    state = env.cache._incr_solver_state
    assert state.dev is not None and not state.dev_dirty_rows
    # a fresh encode of the session's nodes (the cycle's snapshot minus
    # the placements it made, which the next snapshot patches in)
    snap = env.cache._incr_snap
    dirty = env.cache._dirty_nodes
    narr = NodeArrays.build(snap.nodes, state.names, state.rindex)
    fresh = {"node_idle": narr.idle, "node_future": narr.future_idle,
             "node_alloc": narr.allocatable, "node_ntasks": narr.n_tasks,
             "node_max_tasks": narr.max_tasks}
    clean = [i for i, n in enumerate(state.names) if n not in dirty]
    for f in NODE_FIELDS:
        np.testing.assert_array_equal(state.dev[f][clean].numpy(),
                                      fresh[f][clean])
    np.testing.assert_array_equal(state.dev["node_idle"].numpy(),
                                  state.narr.idle)
    # the churn cycle copied its dirty rows only
    row_bytes = sum(int(t[0].numel() * t.element_size())
                    for t in state.dev.values())
    churn = env.sched.last_cycle["places"][0]
    assert 0 < churn["node_bytes"] < row_bytes * len(state.names)
    assert churn["node_bytes"] % row_bytes == 0
    # a gang that cannot fit: once no node is patched, the cycles that
    # re-evaluate it (its Unschedulable condition write re-dirties it)
    # copy no node row
    env.gang("gang-big", size=2, cpu="64")
    seen = []
    for _ in range(4):
        env.cycle()
        lc = env.sched.last_cycle
        if lc["mode"] == "incremental" and lc["patched_nodes"] == 0 \
                and lc["places"]:
            seen.append(lc["places"][0]["node_bytes"])
    assert seen and set(seen) == {0}
    assert isinstance(state.dev["node_idle"], torch.Tensor)
    env.cache.stop()


def test_cycle_mode_metrics_and_stats():
    def run(side):
        m = side.m
        env = Env(side)
        full0 = counter(side, m.CYCLE_MODE, mode="full")
        incr0 = counter(side, m.CYCLE_MODE, mode="incremental")
        env.gang("gang-m")
        env.cycle()
        env.cycle()
        stats = env.cache.last_snapshot_stats
        out = (counter(side, m.CYCLE_MODE, mode="full") - full0,
               counter(side, m.CYCLE_MODE, mode="incremental") - incr0,
               {k: stats[k] for k in ("mode", "quiet", "dirty_jobs",
                                      "dirty_nodes", "patched_jobs",
                                      "patched_nodes")})
        env.cache.stop()
        return out

    ref, port = both(run)
    assert port == ref
    assert port[:2] == (1, 1)


def test_incremental_is_the_default_and_can_be_turned_off():
    env = Env(PORT, incremental=None)
    assert env.sched.incremental and env.cache.incremental
    env.gang("gang-d")
    env.cycle()
    env.cycle()
    assert env.sched.last_cycle["mode"] == "incremental"
    env.cache.stop()
    env = Env(PORT, incremental=False)
    env.gang("gang-d")
    env.cycle()
    env.cycle()
    assert not env.cache.incremental
    assert env.sched.last_cycle["mode"] == "legacy"
    assert env.cache._incr_snap is None
    env.cache.stop()


# ---------------------------------------------------------------------------
# incremental against full, cycle by cycle, on seeded churn
# ---------------------------------------------------------------------------

REGIMES = {
    # a short burst, then a long tail with nothing dirty
    "quiet": dict(resident=10, gang=4, horizon=5, arrival=0.4, fail=0.0,
                  finish=0.0, flap=0.0),
    "bursty": dict(resident=24, gang=8, horizon=30, arrival=1.0, fail=0.1,
                   finish=0.15, flap=0.0),
    "flap": dict(resident=12, gang=4, horizon=30, arrival=0.4, fail=0.05,
                 finish=0.1, flap=0.08),
}
CYCLES = 40
QUEUE_EDIT_AT = 20


def churn_script(regime, seed=11, n_nodes=32):
    """Per cycle, the events to apply before it, drawn from ``seed``:
    ("gang", name, size, cpu), ("finish", gang), ("fail", gang),
    ("cordon", node), ("uncordon", node), ("queue", weight)."""
    r = REGIMES[regime]
    rng = np.random.default_rng(seed)
    script = [[] for _ in range(CYCLES)]
    gangs = []
    n = 0

    def arrive(c, size):
        nonlocal n
        name = f"g{n:03d}"
        n += 1
        gangs.append(name)
        cpu = str(int(rng.integers(1, 5)))
        script[c].append(("gang", name, size, cpu))

    for _ in range(r["resident"]):
        arrive(0, r["gang"])
    down = {}
    for c in range(1, CYCLES):
        if c < r["horizon"]:
            for _ in range(int(rng.poisson(r["arrival"]))):
                arrive(c, int(rng.integers(2, r["gang"] + 1)))
            if gangs and rng.uniform() < r["finish"]:
                script[c].append(("finish", gangs.pop(
                    int(rng.integers(len(gangs))))))
            if gangs and rng.uniform() < r["fail"]:
                script[c].append(("fail", gangs[int(rng.integers(
                    len(gangs)))]))
            if rng.uniform() < r["flap"]:
                node = f"node-{int(rng.integers(n_nodes)):02d}"
                if node not in down:
                    down[node] = c + 5
                    script[c].append(("cordon", node))
        for node, until in list(down.items()):
            if until == c:
                del down[node]
                script[c].append(("uncordon", node))
        if c == QUEUE_EDIT_AT:
            script[c].append(("queue", 2))
    return script


def apply_events(env, events):
    store = env.store
    for ev in events:
        kind = ev[0]
        if kind == "gang":
            _, name, size, cpu = ev
            env.gang(name, size=size, cpu=cpu, ts=100.0 + int(name[1:]))
        elif kind == "finish":
            for pod in store.list("pods"):
                if pod.metadata.name.startswith(ev[1] + "-"):
                    env.delete("pods", pod.metadata.name)
        elif kind == "fail":
            pod = store.get("pods", ev[1] + "-0", "default")
            if pod is not None and pod.spec.node_name:
                pod.status.phase = "Failed"
                env.update("pods", pod)
        elif kind in ("cordon", "uncordon"):
            node = store.get("nodes", ev[1])
            node.spec.unschedulable = kind == "cordon"
            env.update("nodes", node)
        elif kind == "queue":
            q = store.get("queues", "default")
            q.spec.weight = ev[1]
            env.update("queues", q)


def run_churn(side, script, incremental, n_nodes=32, **env_kw):
    env = Env(side, incremental=incremental, n_nodes=n_nodes, **env_kw)
    outs, modes, quiet = [], [], 0
    for events in script:
        apply_events(env, events)
        env.cycle()
        outs.append(env.outcome())
        stats = env.cache.last_snapshot_stats if incremental is not False \
            else {}
        modes.append(stats.get("mode", "legacy"))
        quiet += bool(stats.get("quiet"))
    env.cache.stop()
    return outs, modes, quiet


def assert_cycles_equal(runs):
    """Every run's outcome equals the first's, cycle by cycle."""
    (name0, outs0), rest = runs[0], runs[1:]
    for name, outs in rest:
        for c, (a, b) in enumerate(zip(outs0, outs)):
            for part, x, y in zip(("binds", "evictions", "phases",
                                   "conditions"), a, b):
                assert x == y, (name, name0, c, part,
                                sorted(set(map(repr, x.items() if
                                               isinstance(x, dict) else x))
                                       ^ set(map(repr, y.items() if
                                                 isinstance(y, dict)
                                                 else y)))[:8])


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_incremental_vs_full_equivalence(regime):
    """The port incremental, the port forced full and the reference at
    its default agree after each of 40 cycles of seeded churn on 32
    nodes; the port's incremental run took incremental and (in the quiet
    regime) quiet cycles, and the forced-full run none."""
    script = churn_script(regime)
    reset_breaker()
    ref, _, _ = run_churn(REF, script, None)
    incr, modes, quiet = run_churn(PORT, script, True)
    full, full_modes, _ = run_churn(PORT, script, False)
    assert_cycles_equal([("ref", ref), ("port incremental", incr),
                         ("port full", full)])
    assert ref[-1][0], "the churn placed nothing"
    assert modes[0] == "full" and modes[QUEUE_EDIT_AT] == "full"
    assert modes.count("incremental") > CYCLES // 2
    assert set(full_modes) == {"legacy"}
    if regime == "quiet":
        assert quiet > 10


def zone_nodes(env):
    """Label the nodes with four zones and their hostnames."""
    for i in range(32):
        node = env.store.get("nodes", f"node-{i:02d}")
        node.metadata.labels.update({ZONE: f"zone-{i % 4}",
                                     HOSTNAME: f"node-{i:02d}"})
        env.update("nodes", node)


def test_constrained_churn_with_relabels():
    """Hard and soft topology spread and required self-anti-affinity
    gangs (the heavy mix) on four zones, with nodes moved between zones
    between cycles: the persistent constraint rows refresh the relabelled
    rows, and the three runs agree every cycle."""
    rng = np.random.default_rng(5)
    script = [[] for _ in range(16)]
    for c in range(16):
        for k in range(2 if c else 6):
            j = c * 10 + k
            mode = j % 3
            script[c].append(("cgang", f"c{j:03d}", int(rng.integers(2, 5)),
                              str(int(rng.integers(1, 4))), mode))
        if c and c % 3 == 0:
            script[c].append(("relabel", f"node-{int(rng.integers(32)):02d}",
                              f"zone-{int(rng.integers(4))}"))
        if c == 8:
            script[c].append(("finish", "c001"))

    def run(side, incremental):
        env = Env(side, incremental=incremental, n_nodes=32,
                  seed_objects=zone_nodes)
        outs, modes = [], []
        for events in script:
            for ev in events:
                if ev[0] == "cgang":
                    _, name, size, cpu, mode = ev
                    spread = [[(ZONE, "DoNotSchedule")],
                              [(ZONE, "ScheduleAnyway")], None][mode]
                    env.gang(name, size=size, cpu=cpu, spread=spread,
                             ts=100.0 + int(name[1:]))
                    if mode == 2:
                        anti_replicas(env, name, size)
                elif ev[0] == "relabel":
                    node = env.store.get("nodes", ev[1])
                    node.metadata.labels[ZONE] = ev[2]
                    env.update("nodes", node)
                else:
                    apply_events(env, [ev])
            env.cycle()
            outs.append(env.outcome())
            modes.append(env.sched.last_cycle.get("mode")
                         if side is PORT else None)
        env.cache.stop()
        return outs, modes

    reset_breaker()
    ref, _ = run(REF, None)
    incr, modes = run(PORT, True)
    full, _ = run(PORT, False)
    assert_cycles_equal([("ref", ref), ("port incremental", incr),
                         ("port full", full)])
    assert modes.count("incremental") > 8
    assert ref[-1][0]


def anti_replicas(env, name, size):
    """Give gang ``name``'s pods a required anti-affinity to their own
    job-group label by zone (one replica per zone)."""
    o = env.side.obj
    for t in range(size):
        pod = env.store.get("pods", f"{name}-{t}", "default")
        pod.metadata.labels["job-group"] = name
        term = o.PodAffinityTerm(
            label_selector=[o.NodeSelectorRequirement(
                key="job-group", operator="In", values=[name])],
            topology_key=ZONE)
        aff = o.Affinity()
        aff.pod_anti_affinity = o.PodAffinity(required=[term], preferred=[])
        pod.spec.affinity = aff
        env.update("pods", pod)


VICTIM_CONF = """
actions: "enqueue, allocate, preempt, reclaim, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def test_preempt_reclaim_churn():
    """preempt and reclaim under churn: low-priority gangs of queue q0
    fill the cluster, then high-priority gangs (q0, preempting) and q1's
    gangs (reclaiming) arrive over the cycles; evictions in order,
    pipelines' later binds and phases agree in the three runs."""
    def seed(env):
        for name, value in (("low", 10), ("high", 1000)):
            env.store.create("priorityclasses", env.side.obj.PriorityClass(
                metadata=env.side.obj.ObjectMeta(name=name), value=value))
        for i in range(6):
            env.gang(f"low{i}", size=4, cpu="4", queue="q0", ts=5.0 + i,
                     pc="low", node=[f"node-{(4 * i + t) % 12:02d}"
                                     for t in range(4)],
                     phase="Running")

    rng = np.random.default_rng(3)
    script = [[] for _ in range(12)]
    for c in range(1, 12):
        if c % 2:
            script[c].append(("hgang", f"h{c:02d}", int(rng.integers(1, 3)),
                              "q0", "high"))
        else:
            script[c].append(("hgang", f"r{c:02d}", int(rng.integers(1, 3)),
                              "q1", ""))

    def run(side, incremental):
        env = Env(side, incremental=incremental, conf=VICTIM_CONF,
                  n_nodes=12, node_cpu="8", node_mem="32Gi",
                  queues=(("q0", 1), ("q1", 1)), seed_objects=seed)
        outs, modes = [], []
        for events in script:
            for _, name, size, queue, pc in events:
                env.gang(name, size=size, cpu="4", queue=queue, pc=pc,
                         ts=100.0 + int(name[1:]))
            env.cycle()
            outs.append(env.outcome())
            modes.append(env.sched.last_cycle.get("mode")
                         if side is PORT else None)
        env.cache.stop()
        return outs, modes

    reset_breaker()
    ref, _ = run(REF, None)
    incr, modes = run(PORT, True)
    full, _ = run(PORT, False)
    assert_cycles_equal([("ref", ref), ("port incremental", incr),
                         ("port full", full)])
    assert ref[-1][1], "nothing was evicted"
    assert "incremental" in modes
