"""The port's sla, overcommit, tdm and reservation plugins and its elect
and reserve actions held against the JAX package's, and the repo's
full-featured conf (examples/scheduler-conf.yaml) cycle for cycle.

Three levels, each side on its own objects built from one plain
description (nothing crosses between the packages):

* the registries: the port registers every plugin and action name the
  JAX package does, so no conf schedules differently by a silent skip;
* the cases of tests/test_enqueue_backfill.py and
  tests/test_tdm_reservation.py through both packages' session harness
  (binds, evictions, PodGroup phases, the reservation's target and
  locked nodes);
* seeded clusters through ``Scheduler.run_once`` of both packages, cycle
  after cycle (tests/test_torch_cycle.py's descriptions): sla with
  overcommit on a FakeClock, tdm inside and outside its window,
  reservation over four cycles, and the example conf with NUMA and sla
  shares over three incremental cycles.

Both packages' reservation singletons and tdm evict clocks are reset
around every test. tdm windows are built so that they cannot end during
a run: all day when active, two hours ahead when not. Tolerance: exact.
"""

import time

import pytest

import volcano_tpu.actions as ref_actions_pkg
import volcano_tpu.plugins as ref_plugins_pkg
import volcano_tpu.plugins.tdm as ref_tdm
import volcano_tpu_torch.actions as port_actions_pkg
import volcano_tpu_torch.plugins as port_plugins_pkg
import volcano_tpu_torch.plugins.tdm as port_tdm
from tests.harness import Harness as RefHarness
from tests.test_torch_cycle import PORT, REF, make_spec, outcome, populate
from tests.test_torch_numaaware import (SIDES, assert_cycles_equal,
                                        numa_cycles, numa_spec)
from tests.test_torch_victims import PortHarness
from volcano_tpu.framework import registry as ref_registry
from volcano_tpu.models.objects import PodGroupPhase
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu.utils.clock import FakeClock as RefClock
from volcano_tpu.utils.reservation import RESERVATION as REF_RESERVATION
from volcano_tpu_torch.framework import registry as port_registry
from volcano_tpu_torch.utils import test_utils as port_tu
from volcano_tpu_torch.utils.clock import FakeClock as PortClock
from volcano_tpu_torch.utils.reservation import RESERVATION as PORT_RESERVATION

REVOCABLE_ZONE_LABEL = "volcano.sh/revocable-zone"
REVOCABLE_ZONE_KEY = "volcano.sh/revocable-zone"
PREEMPTABLE_KEY = "volcano.sh/preemptable"


@pytest.fixture(autouse=True)
def reset_singletons():
    """Both packages' reservation state and tdm evict clocks, before and
    after each test."""
    def reset():
        REF_RESERVATION.reset()
        PORT_RESERVATION.reset()
        ref_tdm._last_evict_at = 0.0
        port_tdm._last_evict_at = 0.0
    reset()
    yield
    reset()


HARNESS = {"ref": (RefHarness, ref_tu, REF_RESERVATION),
           "port": (PortHarness, port_tu, PORT_RESERVATION)}


def both(fn):
    """fn(harness class, test_utils, reservation) for each package, the
    reservation singletons reset before each run."""
    out = []
    for side in ("ref", "port"):
        REF_RESERVATION.reset()
        PORT_RESERVATION.reset()
        out.append(fn(*HARNESS[side]))
    return out


def state(h, reservation=None):
    """What a harness case reads back: binds, evictions, PodGroup phases
    from the store, and the reservation's target and locked nodes."""
    phases = {g.metadata.key(): g.status.phase
              for g in h.store.list("podgroups")}
    res = None
    if reservation is not None:
        res = (reservation.target_job.name
               if reservation.target_job is not None else None,
               sorted(reservation.locked_nodes))
    return dict(h.binder.binds), list(h.evictor.evicts), phases, res


# -- the registries ---------------------------------------------------------

def builtin_names(registry, package):
    """The plugin and action names ``package`` itself registers (tests
    may add their own to a registry)."""
    registry.get_action("allocate")   # loads the builtins
    plugins = {n for n, b in registry._plugin_builders.items()
               if b.__module__.startswith(package + ".")}
    actions = {n for n, a in registry._actions.items()
               if type(a).__module__.startswith(package + ".")}
    return plugins, actions


def test_registries_match_reference():
    """The port registers every plugin and action of the JAX package
    (the repo's full-featured conf names sla and numa-aware, which the
    port used to skip silently)."""
    assert ref_plugins_pkg and ref_actions_pkg and port_plugins_pkg \
        and port_actions_pkg
    ref = builtin_names(ref_registry, "volcano_tpu")
    port = builtin_names(port_registry, "volcano_tpu_torch")
    assert port == ref
    assert {"sla", "overcommit", "tdm", "reservation", "numa-aware"} \
        <= port[0]
    assert {"elect", "reserve"} <= port[1]


# -- tests/test_enqueue_backfill.py's sla and overcommit cases ---------------

ENQUEUE_CONF = """
actions: "enqueue, allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: overcommit
  - name: predicates
  - name: nodeorder
"""

SLA_CONF = """
actions: "enqueue"
tiers:
- plugins:
  - name: sla
    arguments:
      sla-waiting-time: 1ms
- plugins:
  - name: overcommit
"""


def enqueue_case(case):
    def run(Harness, tu, _):
        rl1 = tu.build_resource_list("1", "1Gi")
        h = Harness(SLA_CONF if case == "sla_force_permits" else ENQUEUE_CONF)
        h.add("queues", tu.build_queue("q1"))
        pg = tu.build_pod_group("pg1", "c1", "q1", 1,
                                phase=PodGroupPhase.PENDING)
        big = case in ("beyond_headroom", "sla_force_permits")
        if case != "no_min_resources":
            pg.spec.min_resources = {"cpu": "40" if big else "1",
                                     "memory": "1Gi"}
        h.add("podgroups", pg)
        h.add("nodes", tu.build_node("n1", tu.build_resource_list("4",
                                                                  "4Gi")))
        h.add("pods", tu.build_pod(
            "c1", "p1", "", "Pending",
            tu.build_resource_list("40", "1Gi") if big else rl1, "pg1"))
        if case == "sla_force_permits":
            time.sleep(0.01)   # age past the 1ms SLA
        ssn = h.open_session()
        h.run_actions("enqueue")
        phase = next(iter(ssn.jobs.values())).pod_group.status.phase
        if case == "within_headroom":
            h.run_actions("allocate")
        h.close_session()
        out = (phase, dict(h.binder.binds))
        h.cache.stop()
        return out
    return both(run)


@pytest.mark.parametrize("case,phase,binds", [
    ("within_headroom", PodGroupPhase.INQUEUE, 1),
    ("beyond_headroom", PodGroupPhase.PENDING, 0),
    ("no_min_resources", PodGroupPhase.INQUEUE, 0),
    ("sla_force_permits", PodGroupPhase.INQUEUE, 0),
])
def test_enqueue_case_matches_reference(case, phase, binds):
    ref, port = enqueue_case(case)
    assert port == ref
    assert ref[0] == phase and len(ref[1]) == binds


# -- tests/test_tdm_reservation.py's cases ------------------------------------

def zone_window(active: bool) -> str:
    """A tdm window that cannot end during a run: the whole day when
    active, else 02:00-03:00 hours from now (which never holds now)."""
    if active:
        return "00:00-23:59"
    lt = time.localtime()
    now_min = lt.tm_hour * 60 + lt.tm_min
    start, end = (now_min + 120) % 1440, (now_min + 180) % 1440
    return f"{start // 60:02d}:{start % 60:02d}-{end // 60:02d}:{end % 60:02d}"


def tdm_conf(active: bool, actions="allocate, preempt", extra_tier1=""):
    return f"""
actions: "{actions}"
tiers:
- plugins:
  - name: gang
  - name: tdm
    arguments:
      tdm.revocable-zone.rz1: {zone_window(active)}
      tdm.evict.period: 1ms{extra_tier1}
- plugins:
  - name: predicates
  - name: nodeorder
"""


def revocable_pod(tu, ns, name, nodename, phase, pg):
    p = tu.build_pod(ns, name, nodename, phase,
                     tu.build_resource_list("1", "1Gi"), pg,
                     preemptable=True)
    p.metadata.annotations[REVOCABLE_ZONE_KEY] = "rz1"
    return p


def tdm_case(case):
    def run(Harness, tu, reservation):
        rl1 = tu.build_resource_list("1", "1Gi")
        h = Harness(tdm_conf(active=case != "drain_outside_window"))
        h.add("queues", tu.build_queue("q1"))
        h.add("podgroups", tu.build_pod_group("pg1", "c1", "q1", 1,
                                              phase=PodGroupPhase.INQUEUE))
        h.add("nodes", tu.build_node(
            "n1", tu.build_resource_list("4", "4Gi"),
            labels={REVOCABLE_ZONE_LABEL: "rz1"}))
        if case == "blocks_plain_tasks":
            h.add("pods", tu.build_pod("c1", "plain", "", "Pending", rl1,
                                       "pg1"))
            h.run_actions("allocate")
        elif case == "admits_revocable_tasks":
            h.add("pods", revocable_pod(tu, "c1", "rev1", "", "Pending",
                                        "pg1"))
            h.run_actions("allocate")
        else:
            h.add("pods",
                  revocable_pod(tu, "c1", "rev1", "n1", "Running", "pg1"),
                  revocable_pod(tu, "c1", "rev2", "n1", "Running", "pg1"))
            h.run_actions("preempt")
        h.close_session()
        out = state(h)
        h.cache.stop()
        return out
    return both(run)


@pytest.mark.parametrize("case", ["blocks_plain_tasks",
                                  "admits_revocable_tasks",
                                  "drain_outside_window"])
def test_tdm_case_matches_reference(case):
    ref, port = tdm_case(case)
    assert port == ref
    binds, evicts = ref[0], ref[1]
    if case == "blocks_plain_tasks":
        assert binds == {}
    elif case == "admits_revocable_tasks":
        assert binds == {"c1/rev1": "n1"}
    else:
        assert len(evicts) == 1   # one pod per job per cycle by default


RESERVE_CONF = """
actions: "{actions}"
tiers:
- plugins:
  - name: gang
  - name: reservation
- plugins:
  - name: predicates
  - name: nodeorder
"""


def test_elect_reserve_lock_and_release_matches_reference():
    """elect picks the Pending job, reserve locks the node with the most
    idle; once the target is Inqueue, allocate binds it and reserve
    resets the reservation: the same in both, cycle by cycle."""
    def run(Harness, tu, reservation):
        rl1 = tu.build_resource_list("1", "1Gi")
        h = Harness(RESERVE_CONF.format(actions="elect, allocate, reserve"))
        h.add("queues", tu.build_queue("q1"))
        h.add("podgroups", tu.build_pod_group("pg1", "c1", "q1", 1,
                                              phase=PodGroupPhase.PENDING))
        h.add("nodes", tu.build_node("n1", tu.build_resource_list("4",
                                                                  "4Gi")),
              tu.build_node("n2", tu.build_resource_list("2", "2Gi")))
        h.add("pods", tu.build_pod("c1", "p1", "", "Pending", rl1, "pg1"))
        h.run_actions("elect", "allocate", "reserve").close_session()
        first = state(h, reservation)
        pg = h.store.get("podgroups", "pg1", "c1")
        pg.status.phase = PodGroupPhase.INQUEUE
        h.store.update("podgroups", pg)
        h.open_session()
        h.run_actions("elect", "allocate", "reserve").close_session()
        out = (first, state(h, reservation))
        h.cache.stop()
        return out
    ref, port = both(run)
    assert port == ref
    assert ref[0][3] == ("pg1", ["n1"]) and ref[0][0] == {}
    assert len(ref[1][0]) == 1 and ref[1][3] == (None, [])


def test_allocate_exempts_target_job_from_locked_nodes_as_reference():
    """The reservation target may use its locked nodes; every other job
    sees them masked out of the kernel's mask."""
    def run(Harness, tu, reservation):
        h = Harness(RESERVE_CONF.format(actions="allocate"))
        h.add("queues", tu.build_queue("q1"))
        h.add("podgroups",
              tu.build_pod_group("pgT", "c1", "q1", 1,
                                 phase=PodGroupPhase.INQUEUE),
              tu.build_pod_group("pgO", "c1", "q1", 1,
                                 phase=PodGroupPhase.INQUEUE))
        h.add("nodes", tu.build_node("n1", tu.build_resource_list("4",
                                                                  "4Gi")),
              tu.build_node("n2", tu.build_resource_list("1", "1Gi")))
        h.add("pods",
              tu.build_pod("c1", "tgt", "", "Pending",
                           tu.build_resource_list("3", "3Gi"), "pgT"),
              tu.build_pod("c1", "other", "", "Pending",
                           tu.build_resource_list("1", "1Gi"), "pgO"))
        ssn = h.open_session()
        reservation.target_job = next(j for j in ssn.jobs.values()
                                      if j.name == "pgT")
        reservation.locked_nodes["n1"] = None
        h.run_actions("allocate").close_session()
        out = state(h)
        h.cache.stop()
        return out
    ref, port = both(run)
    assert port == ref
    assert ref[0] == {"c1/tgt": "n1", "c1/other": "n2"}


# -- seeded clusters through Scheduler.run_once ------------------------------

CLOCK0 = 50_000.0
HOUR = 3600.0


def set_ages(spec, every, offset=1, old=2 * HOUR, young=60.0):
    """PodGroups (and their pods) of every ``every``-th job (from
    ``offset``) created ``old`` seconds before CLOCK0, the others
    ``young`` seconds before: sla's waiting time falls between them."""
    ts = {}
    for i, g in enumerate(spec["podgroups"]):
        g["ts"] = CLOCK0 - (old if i % every == offset else young)
        ts[g["name"]] = g["ts"]
    for p in spec["pods"]:
        p["ts"] = ts[p["group"]]
    return spec


def annotate(store, spec, pods=None, groups=None):
    """Add annotations to the stored pods (``pods``: {pod name:
    annotations}) and podgroups (``groups``) of ``spec``."""
    for p in spec["pods"]:
        ann = (pods or {}).get(p["name"])
        if ann:
            pod = store.get("pods", p["name"], p["ns"])
            pod.metadata.annotations.update(ann)
            store.update("pods", pod)
    for g in spec["podgroups"]:
        ann = (groups or {}).get(g["name"])
        if ann:
            pg = store.get("podgroups", g["name"], g["ns"])
            pg.metadata.annotations.update(ann)
            store.update("podgroups", pg)


def cycles(pkg, spec, conf_text, n_cycles, prepare=None, between=None,
           reservation=None, **kw):
    """``n_cycles`` cycles of ``pkg``'s Scheduler on a FakeClock store
    built from ``spec`` (``prepare(store)`` before the cache starts,
    ``between(store, clock, c)`` before cycle c > 0). Returns per cycle
    the outcome, the evictions so far and the reservation's state."""
    clock = (RefClock if pkg is REF else PortClock)(CLOCK0)
    store = pkg.Store(clock=clock)
    populate(pkg, store, spec)
    if prepare is not None:
        prepare(store)
    evictor = pkg.tu.FakeEvictor(store)
    cache = pkg.Cache(store, binder=pkg.tu.FakeBinder(store),
                      evictor=evictor)
    cache.run()
    sched = pkg.Scheduler(store, scheduler_conf=conf_text, cache=cache,
                          **kw)
    out = []
    for c in range(n_cycles):
        if c and between is not None:
            between(store, clock, c)
        sched.run_once()
        cache.flush_executors()
        res = None
        if reservation is not None:
            res = (reservation.target_job.name
                   if reservation.target_job is not None else None,
                   sorted(reservation.locked_nodes))
        out.append((outcome(store), list(evictor.evicts), res))
    cache.stop()
    return out


def assert_same_cycles(spec, conf_text, n_cycles, **kw):
    REF_RESERVATION.reset()
    ref = cycles(REF, spec, conf_text, n_cycles,
                 reservation=REF_RESERVATION, **kw)
    PORT_RESERVATION.reset()
    port = cycles(PORT, spec, conf_text, n_cycles,
                  reservation=PORT_RESERVATION, device="cpu", **kw)
    for c, (r, p) in enumerate(zip(ref, port)):
        (rb, rp, rc), revicts, rres = r
        (pb, pp, pc), pevicts, pres = p
        assert pb == rb, (c, sorted(set(pb.items()) ^ set(rb.items()))[:8])
        assert pp == rp, (c, {k: (pp[k], rp.get(k)) for k in pp
                              if pp[k] != rp.get(k)})
        assert pc == rc, c
        assert pevicts == revicts, c
        assert pres == rres, c
    return ref


SLA_OVERCOMMIT = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: sla
    arguments:
      sla-waiting-time: 1h
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: overcommit
    arguments:
      overcommit-factor: 1.0
"""


def test_sla_and_overcommit_cycles_match_reference():
    """Pending PodGroups whose MinResources pass the overcommit headroom
    only in part; the jobs older than sla-waiting-time are permitted
    anyway and order first. Two cycles, the clock an hour on between
    them (the younger jobs then pass their deadline too)."""
    spec = set_ages(make_spec(31, n_nodes=3, n_jobs=24, pending_pg=1,
                              node_cpu=(8, 13), gang=(2, 5)), every=3)

    def later(store, clock, c):
        clock.advance(HOUR)

    ref = assert_same_cycles(spec, SLA_OVERCOMMIT, 2, between=later)
    phases = list(ref[0][0][1].values())
    assert "Pending" in phases and ref[0][0][0]
    assert len(ref[1][0][0]) >= len(ref[0][0][0])


def tdm_spec(seed, running=0):
    """One node in 8 labelled with zone rz1, one gang in 4 revocable
    (zone annotation) and preemptable; priorities high, low and none."""
    spec = make_spec(seed, n_nodes=16, n_jobs=24, priorities=True,
                     running=running, gang=(2, 4))
    for i, n in enumerate(spec["nodes"]):
        if i % 8 == 0:
            n["labels"][REVOCABLE_ZONE_LABEL] = "rz1"
    revocable = {g["name"] for i, g in enumerate(spec["podgroups"])
                 if i % 4 == 0}
    pods = {p["name"]: {REVOCABLE_ZONE_KEY: "rz1", PREEMPTABLE_KEY: "true"}
            for p in spec["pods"] if p["group"] in revocable}
    groups = {g: {PREEMPTABLE_KEY: "true"} for g in revocable}
    return spec, pods, groups


@pytest.mark.parametrize("active", [True, False])
def test_tdm_cycles_match_reference(active):
    """tdm with overcommit in tier 1 under enqueue, allocate, backfill
    and preempt: inside the window revocable gangs may use the zone's
    nodes and nothing else may; outside it the zone's preemptable pods
    drain, one a job a cycle. Two cycles."""
    spec, pods, groups = tdm_spec(41 if active else 42, running=3)
    conf_text = tdm_conf(active, "enqueue, allocate, backfill, preempt",
                         "\n  - name: overcommit\n    arguments:\n"
                         "      overcommit-factor: 1.2")
    ref = assert_same_cycles(
        spec, conf_text, 2,
        prepare=lambda store: annotate(store, spec, pods, groups))
    placed = {f"{p['ns']}/{p['name']}" for p in spec["pods"] if p["node"]}
    binds = {k: v for k, v in ref[-1][0][0].items() if k not in placed}
    zone_nodes = {n["name"] for n in spec["nodes"]
                  if REVOCABLE_ZONE_LABEL in n["labels"]}
    on_zone = {k for k, node in binds.items() if node in zone_nodes}
    assert binds
    if active:
        assert on_zone and all(k.split("/")[1] in pods for k in on_zone)
    else:
        assert ref[-1][1], "nothing drained outside the window"


def test_reservation_cycles_match_reference():
    """enqueue, elect, allocate, backfill, reserve with reservation in
    tier 1 over four cycles an hour apart: a high-priority gang of two
    whole-node pods waits Pending (its MinResources pass no overcommit
    headroom) while reserve locks one empty node a cycle, and the gangs
    that arrive before cycles two and three pack the other nodes (the
    lock masks the locked ones for them). Past its sla-waiting-time the
    gang is enqueued and binds on the locked nodes, and the reservation
    resets."""
    spec = make_spec(51, n_nodes=6, n_jobs=0, node_cpu=(8, 9),
                     node_mem_gi=(32, 33))
    spec["priority_classes"] = [("top", 1000)]
    spec["podgroups"].append(dict(
        name="pg-target", ns="default", queue="default", min_member=2,
        phase="Pending", min_res={"cpu": "60", "memory": "3Gi"}, pc="top",
        ts=CLOCK0 - 60.0, annotations={"sla-waiting-time": "150m"}))
    for t in range(2):
        spec["pods"].append(dict(
            ns="default", name=f"target-task{t}", node="", phase="Pending",
            req={"cpu": "7", "memory": "1Gi"}, group="pg-target",
            selector={}, tolerations=[], priority=1000, ts=CLOCK0 - 60.0))
    conf_text = """
actions: "enqueue, elect, allocate, backfill, reserve"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: reservation
  - name: sla
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
    arguments:
      binpack.weight: 10
  - name: overcommit
    arguments:
      overcommit-factor: 1.0
"""
    more = {c: make_spec(50 + c, n_nodes=0, n_jobs=6, job_offset=100 * c,
                         req_cpu_m=(1000, 1501), req_mem_mi=(512, 1025),
                         gang=(2, 3))
            for c in (1, 2)}

    def later(store, clock, c):
        clock.advance(HOUR)
        if c in more:
            populate(PORT if isinstance(store, PORT.Store) else REF,
                     store, more[c])

    ref = assert_same_cycles(spec, conf_text, 4, between=later)
    reservations = [res for _, _, res in ref]
    assert [r[0] for r in reservations] == ["pg-target"] * 3 + [None]
    assert [len(r[1]) for r in reservations[:3]] == [1, 2, 3]
    binds = ref[-1][0][0]
    target_nodes = {binds.get(f"default/target-task{t}") for t in range(2)}
    assert None not in target_nodes
    assert target_nodes <= set(reservations[2][1])
    assert all(binds.get(k) not in target_nodes
               for k in ref[2][0][0])   # the lock held for the others


# -- the repo's full-featured conf ---------------------------------------------

def example_conf() -> str:
    with open("examples/scheduler-conf.yaml") as f:
        return f.read()


def test_example_conf_three_incremental_cycles_match_reference():
    """examples/scheduler-conf.yaml over three incremental cycles of a
    NUMA cluster: every node has a Numatopology (single-numa-node, the
    static CPU manager), one gang in two Guaranteed with the
    single-numa-node policy, a third of the PodGroups Pending with
    MinResources and one in four created more than sla-waiting-time (1 h)
    before the clock. New gangs arrive before cycles two and three.
    Binds, phases, conditions and every node's NUMA set equal after each
    cycle; sla's and numa-aware's shares changed the outcome."""
    def spec_of(seed, **kw):
        s = numa_spec(seed, **kw)
        for i, g in enumerate(s["podgroups"]):
            if i % 3 == 2:
                g["phase"] = "Pending"
                g["min_res"] = {"cpu": "4", "memory": "4Gi"}
        return set_ages(s, every=4)

    spec = spec_of(61, n_nodes=12, n_jobs=18)
    more = [spec_of(61 + c, n_jobs=6, job_offset=100 * c) for c in (1, 2)]
    conf_text = example_conf()
    ref = numa_cycles(SIDES["ref"], spec, conf_text, more)
    port = numa_cycles(SIDES["port"], spec, conf_text, more, device="cpu")
    assert_cycles_equal(ref, port)
    assert [m for _, _, m in port] == ["full", "incremental", "incremental"]
    binds = ref[-1][0][0]
    guaranteed = {p["name"] for p in spec["pods"] if p["guaranteed"]}
    assert any(k.split("/")[1] in guaranteed for k in binds)
    assert any(len(v) < 4 * (int(n["cpu"]) // 4)
               for n in spec["nodes"]
               for k, v in ref[-1][1].items() if k == n["name"])


def test_cycle_command_example_conf_on_cpu(capsys):
    """python -m volcano_tpu_torch.cmd.cycle --scenario example-conf: the
    full-featured conf over populate_store's plugin shares binds every
    pod, and its place swept numa-aware's host predicate over every
    group and node."""
    import json

    from volcano_tpu_torch.cmd import cycle
    assert cycle.main(["--device", "cpu", "--tasks", "256", "--nodes", "32",
                       "--warm", "0", "--scenario", "example-conf"]) == 0
    run = json.loads(capsys.readouterr().out)["cold"]
    assert run["binds"] == 256 and run["committed_gangs"] == 32
    host = run["places"][0]["host_predicates"]
    assert (host["groups"], host["nodes"]) == (32, 32) and host["ms"] > 0
