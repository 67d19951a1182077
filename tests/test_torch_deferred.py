"""The deferred apply (``apply: deferred``, the default of both packages)
held against the JAX package: the nine cases of
tests/test_deferred_apply.py run through each package's session harness,
with the same in-case checks on both sides and, where a case schedules,
binds, evictions and PodGroup phases equal; then ``apply: eager`` against
the default on an allocate-only shape and on preempt and reclaim shapes
that allocate first, the port's eager and deferred runs and the
reference's default all equal.

Each side builds its own objects with its own builders (nothing crosses
between the packages). Tolerance: exact.
"""

import json

import pytest

import volcano_tpu.framework as ref_framework
import volcano_tpu.framework.statement as ref_statement
import volcano_tpu_torch.framework as port_framework
import volcano_tpu_torch.framework.statement as port_statement
from tests.harness import Harness as RefHarness
from tests.test_torch_victims import PORT as VPORT
from tests.test_torch_victims import REF as VREF
from tests.test_torch_victims import (PortHarness, Scenario, build,
                                      outcome_of, preempt_cluster,
                                      reclaim_cluster)
from volcano_tpu.models.job_info import TaskStatus as RefStatus
from volcano_tpu.models.objects import PodGroupPhase as RefPhase
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu_torch.models.job_info import TaskStatus as PortStatus
from volcano_tpu_torch.models.objects import PodGroupPhase as PortPhase
from volcano_tpu_torch.utils import test_utils as port_tu


class Side:
    def __init__(self, name, harness, tu, status, phase, framework,
                 statement):
        self.name, self.Harness, self.tu = name, harness, tu
        self.Status, self.Phase = status, phase
        self.framework, self.statement = framework, statement


REF = Side("ref", RefHarness, ref_tu, RefStatus, RefPhase, ref_framework,
           ref_statement)
PORT = Side("port", PortHarness, port_tu, PortStatus, PortPhase,
            port_framework, port_statement)

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

CONF_CHAIN = CONF.replace('"enqueue, allocate"',
                          '"enqueue, allocate, backfill, preempt, reclaim"')

EAGER = """
configurations:
- name: solver
  arguments: {apply: eager}
"""


def env(side, conf=CONF, gangs=3, gang=4, nodes=4):
    """tests/test_deferred_apply.py:_env on ``side``'s builders."""
    tu = side.tu
    h = side.Harness(conf)
    h.add("queues", tu.build_queue("default", weight=1))
    for i in range(nodes):
        h.add("nodes", tu.build_node(f"n{i}", {"cpu": "8",
                                               "memory": "16Gi"}))
    rl = tu.build_resource_list("1", "1Gi")
    for j in range(gangs):
        h.add("podgroups", tu.build_pod_group(
            f"pg{j}", "ns1", "default", gang, phase=side.Phase.INQUEUE))
        for t in range(gang):
            h.add("pods", tu.build_pod("ns1", f"pg{j}-{t}", "", "Pending",
                                       rl, f"pg{j}"))
    return h


def finish(h):
    """Flush the harness's commit, read binds, evictions and PodGroup
    phases from the store, and stop the cache's executor."""
    h.cache.flush_executors(timeout=30)
    phases = {g.metadata.key(): g.status.phase
              for g in h.store.list("podgroups")}
    out = dict(h.binder.binds), list(h.evictor.evicts), phases
    h.cache.stop()
    return out


def both(case, *args):
    """Run ``case(side, *args)`` on both packages; the outcomes must be
    equal. Returns the port's."""
    ref = case(REF, *args)
    port = case(PORT, *args)
    assert port == ref
    return port


# -- the nine cases of tests/test_deferred_apply.py ----------------------------

def cycle_binds_and_running(side):
    h = env(side)
    h.run_actions("enqueue", "allocate").close_session()
    out = finish(h)
    assert len(out[0]) == 12
    assert set(out[2].values()) == {side.Phase.RUNNING}
    return out


def test_deferred_cycle_binds_and_podgroup_running():
    both(cycle_binds_and_running)


def deltas_feed_readiness(side):
    h = env(side, gangs=1)
    ssn = h.open_session()
    side.framework.get_action("enqueue").execute(ssn)
    side.framework.get_action("allocate").execute(ssn)
    job = next(iter(ssn.jobs.values()))
    # deferred: statuses Pending, the deltas carry the placements
    assert job.deferred_alloc == 4
    assert {t.status for t in job.tasks.values()} == {side.Status.Pending}
    assert job.ready_task_num() == 4
    assert "" not in {t.node_name for t in job.tasks.values()}
    ssn.materialize()
    assert job.deferred_alloc == 0
    assert {t.status for t in job.tasks.values()} == \
        {side.Status.Allocated}
    assert job.ready_task_num() == 4
    used = sum(n.used.milli_cpu for n in ssn.nodes.values())
    assert used == pytest.approx(4000.0)
    placed = {t.name: t.node_name for t in job.tasks.values()}
    h.close_session()
    return placed, finish(h)


def test_deferred_deltas_feed_readiness_and_clear_on_materialize():
    both(deltas_feed_readiness)


def later_actions_materialize(side):
    h = env(side, CONF_CHAIN)
    h.run_actions("enqueue", "allocate", "backfill", "preempt", "reclaim")
    ssn = h.ssn
    h.close_session()
    out = finish(h)
    assert len(out[0]) == 12
    used = sum(n.used.milli_cpu for n in ssn.nodes.values())
    assert used == pytest.approx(12000.0)
    return out


def test_later_actions_see_materialized_state():
    both(later_actions_materialize)


def drop_reverses_deltas(side):
    h = env(side, gangs=1)
    ssn = h.open_session()
    job = next(iter(ssn.jobs.values()))
    tasks = sorted(job.tasks.values(), key=lambda t: t.name)
    node = ssn.nodes["n0"]
    stmt = side.statement.Statement(ssn)
    for t in tasks:
        t.node_name = node.name
    stmt.record_batch_deferred(job, [(t, node, False) for t in tasks])
    assert job.deferred_alloc == 4
    assert job.ready_task_num() == 4
    prop = ssn.plugins["proportion"]
    assert prop.queue_opts["default"].allocated.milli_cpu == \
        pytest.approx(4000.0)
    stmt.discard()
    assert job.deferred_alloc == 0
    assert job.ready_task_num() == 0
    assert all(t.status == side.Status.Pending for t in job.tasks.values())
    assert all(t.node_name == "" for t in job.tasks.values())
    assert not node.tasks
    assert prop.queue_opts["default"].allocated.milli_cpu == \
        pytest.approx(0)
    # the dropped op stays queued but inert: materialize must not bring it
    # back
    ssn.materialize()
    assert all(t.status == side.Status.Pending for t in job.tasks.values())
    assert not node.tasks
    h.close_session()
    return finish(h)


def test_deferred_drop_reverses_deltas():
    both(drop_reverses_deltas)


def kept_pipelined_gang(side):
    tu = side.tu
    h = side.Harness(CONF)
    h.add("queues", tu.build_queue("default", weight=1))
    h.add("nodes", tu.build_node("n0", {"cpu": "4", "memory": "8Gi"}))
    h.add("podgroups", tu.build_pod_group("busy", "ns1", "default", 1,
                                          phase=side.Phase.RUNNING))
    busy = tu.build_pod("ns1", "busy-0", "n0", "Running",
                        tu.build_resource_list("4", "8Gi"), "busy")
    busy.metadata.deletion_timestamp = 123.0   # terminating: Releasing
    h.add("pods", busy)
    h.add("podgroups", tu.build_pod_group("pg", "ns1", "default", 2,
                                          phase=side.Phase.INQUEUE))
    for t in range(2):
        h.add("pods", tu.build_pod("ns1", f"p{t}", "", "Pending",
                                   tu.build_resource_list("2", "4Gi"),
                                   "pg"))
    h.run_actions("enqueue", "allocate")
    ssn = h.ssn
    h.close_session()
    job = next(j for j in ssn.jobs.values() if j.name == "pg")
    # gang's close materialized it: Pipelined, not Pending
    assert {t.status for t in job.tasks.values()} == {side.Status.Pipelined}
    assert job.deferred_pipe == 0
    pipelined = {t.name: t.node_name for t in job.tasks.values()}
    pg = h.store.get("podgroups", "pg", "ns1")
    assert any(c.type == "Unschedulable" for c in pg.status.conditions)
    out = finish(h)
    assert not out[0]   # pipelined: no bind yet
    return pipelined, out


def test_kept_pipelined_gang_reports_unready_after_materialize():
    both(kept_pipelined_gang)


def eager_matches_deferred(side):
    h1 = env(side)
    h1.run_actions("enqueue", "allocate").close_session()
    h2 = env(side, CONF + EAGER)
    h2.run_actions("enqueue", "allocate").close_session()
    deferred, eager = finish(h1), finish(h2)
    assert eager == deferred
    return deferred


def test_eager_conf_matches_deferred_binds():
    both(eager_matches_deferred)


def reclaim_after_deferred_allocate(side):
    tu = side.tu
    conf = CONF.replace('"enqueue, allocate"', '"enqueue, allocate, reclaim"'
                        ).replace("  - name: drf\n", "")
    h = side.Harness(conf)
    h.add("queues", tu.build_queue("q1", weight=1))
    h.add("queues", tu.build_queue("q2", weight=3))
    for i in range(4):
        h.add("nodes", tu.build_node(f"n{i}", {"cpu": "8",
                                               "memory": "16Gi"}))
    h.add("podgroups", tu.build_pod_group("q1pg", "ns1", "q1", 2,
                                          phase=side.Phase.RUNNING))
    for t in range(2):
        h.add("pods", tu.build_pod("ns1", f"q1p{t}", f"n{t}", "Running",
                                   tu.build_resource_list("8", "16Gi"),
                                   "q1pg"))
    h.add("podgroups", tu.build_pod_group("q2pg", "ns1", "q2", 2,
                                          phase=side.Phase.INQUEUE))
    for t in range(2):
        h.add("pods", tu.build_pod("ns1", f"q2p{t}", "", "Pending",
                                   tu.build_resource_list("8", "16Gi"),
                                   "q2pg"))
    h.run_actions("enqueue", "allocate", "reclaim")
    ssn = h.ssn
    h.close_session()
    out = finish(h)
    assert len(out[0]) == 2
    assert not out[1], f"reclaim evicted running pods: {out[1]}"
    seen = {}
    for n in ssn.nodes.values():
        for key in n.tasks:
            assert key not in seen, f"{key} on {seen[key]} and {n.name}"
            seen[key] = n.name
    return out


def test_reclaim_after_deferred_allocate_does_not_double_place():
    both(reclaim_after_deferred_allocate)


def failing_apply(side, monkeypatch):
    def boom(self, ssn):
        raise RuntimeError("synthetic apply failure")
    monkeypatch.setattr(side.statement._DeferredBatch, "apply", boom)


def failure_before_commit(side, monkeypatch):
    h = env(side, gangs=1)
    ssn = h.open_session()
    job = next(iter(ssn.jobs.values()))
    tasks = sorted(job.tasks.values(), key=lambda t: t.name)
    node = ssn.nodes["n0"]
    stmt = side.statement.Statement(ssn)
    for t in tasks:
        t.node_name = node.name
    stmt.record_batch_deferred(job, [(t, node, False) for t in tasks])
    with monkeypatch.context() as mp:
        failing_apply(side, mp)
        ssn.materialize()
    assert job.deferred_alloc == 0
    assert all(t.node_name == "" for t in job.tasks.values())
    assert all(t.status == side.Status.Pending for t in job.tasks.values())
    assert not node.tasks
    stmt.commit()   # a dead op: no bind
    h.close_session()
    out = finish(h)
    assert not out[0]
    return out


def test_apply_failure_before_commit_drops_gang(monkeypatch):
    both(failure_before_commit, monkeypatch)


def failure_after_commit(side, monkeypatch):
    h = env(side, gangs=1)
    ssn = h.open_session()
    side.framework.get_action("enqueue").execute(ssn)
    side.framework.get_action("allocate").execute(ssn)   # records, commits
    job = next(iter(ssn.jobs.values()))
    assert job.deferred_alloc == 4
    with monkeypatch.context() as mp:
        failing_apply(side, mp)
        ssn.materialize()
    assert job.deferred_alloc == 4   # the deltas stand after the commit
    assert job.ready_task_num() == 4
    h.close_session()
    out = finish(h)
    assert len(out[0]) == 4
    return out


def test_apply_failure_after_commit_keeps_deltas(monkeypatch):
    both(failure_after_commit, monkeypatch)


# -- apply: eager against the default -----------------------------------------

SHAPE_TIERS = """
tiers:
- plugins:
  - name: priority
  - name: conformance
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def allocate_shape() -> Scenario:
    """Six gangs of 3 over four nodes of 8 CPU in two queues, one gang
    too big to place."""
    sc = Scenario(queues=[("q1", 1, True), ("q2", 2, True)])
    sc.nodes = [(f"n{i}", "8", "8Gi") for i in range(4)]
    for j in range(6):
        cpu = "5" if j == 3 else "2"
        sc.podgroups.append((f"g-{j}", "c1", f"q{1 + j % 2}", 3, "Inqueue",
                             ""))
        sc.pods += [("c1", f"g{j}-{t}", "", "Pending", cpu, "1Gi", f"g-{j}")
                    for t in range(3)]
    return sc


def with_free_node(sc: Scenario) -> Scenario:
    """The victim shape plus one empty node that allocate fills first, so
    the later action must see the deferred placements."""
    sc.nodes.append(("free", "2", "2Gi"))
    return sc


SHAPES = {
    "default": (allocate_shape, "enqueue, allocate, backfill"),
    "preempt": (lambda: with_free_node(preempt_cluster()),
                "enqueue, allocate, preempt"),
    "reclaim": (lambda: with_free_node(reclaim_cluster()),
                "enqueue, allocate, reclaim"),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_eager_binds_alike_on_the_victim_shapes(shape):
    """The port's ``apply: eager`` and default runs and the reference's
    default run give equal binds, evictions, pipelines and phases."""
    make, actions = SHAPES[shape]
    conf = f'actions: "{actions}"' + SHAPE_TIERS
    names = [a.strip() for a in actions.split(",")]
    outs = []
    for pkg, text in ((VREF, conf), (VPORT, conf), (VPORT, conf + EAGER)):
        h = build(pkg, text, make())
        evicts, pipelined, phases, _ = outcome_of(pkg, h, names)
        outs.append((dict(h.binder.binds), evicts, pipelined, phases))
    assert outs[1] == outs[0]
    assert outs[2] == outs[0]
    assert outs[0][0], "the shape placed nothing"
    if shape != "default":
        assert outs[0][1], "the shape evicted nothing"


# -- the readers that materialize ---------------------------------------------

READER_CONF = CONF.replace(
    '"enqueue, allocate"',
    '"enqueue, allocate, backfill, preempt, reclaim, reserve"')


@pytest.mark.parametrize("reader", ["backfill", "preempt", "reclaim",
                                    "reserve"])
def test_reader_actions_materialize_first(reader):
    """Each action that reads placement state applies the deferred gangs
    at its start, in both packages: nothing is left deferred and no job
    keeps a delta once it ran (reserve materializes while its target is
    not ready)."""
    import volcano_tpu.utils.reservation as ref_reservation
    import volcano_tpu_torch.utils.reservation as port_reservation
    singletons = {"ref": ref_reservation.RESERVATION,
                  "port": port_reservation.RESERVATION}

    def case(side):
        h = env(side, READER_CONF, gangs=3)
        tu = side.tu
        h.add("podgroups", tu.build_pod_group("big", "ns1", "default", 1,
                                              phase=side.Phase.INQUEUE))
        h.add("pods", tu.build_pod("ns1", "big-0", "", "Pending",
                                   tu.build_resource_list("64", "1Gi"),
                                   "big"))
        ssn = h.open_session()
        side.framework.get_action("enqueue").execute(ssn)
        side.framework.get_action("allocate").execute(ssn)
        deferred = sum(j.deferred_alloc for j in ssn.jobs.values())
        assert deferred == 12 and ssn._deferred_ops
        res = singletons[side.name]
        res.reset()
        if reader == "reserve":
            res.target_job = next(j for j in ssn.jobs.values()
                                  if j.name == "big")
        try:
            side.framework.get_action(reader).execute(ssn)
        finally:
            res.reset()
        left = (dict(ssn._deferred_ops),
                sum(j.deferred_alloc for j in ssn.jobs.values()))
        statuses = sorted(t.status.name for j in ssn.jobs.values()
                          for t in j.tasks.values())
        h.close_session()
        finish(h)
        assert left == ({}, 0)
        return statuses

    both(case)


# -- cmd.cycle --apply ----------------------------------------------------------

@pytest.mark.parametrize("scenario", ["default", "preempt", "reclaim"])
def test_cycle_command_applies_alike_deferred_and_eager(scenario):
    """cmd.cycle's ``apply``: the deferred staging and ``apply: eager``
    leave the store in the same state, every pod and PodGroup alike."""
    from volcano_tpu_torch.cmd import cycle as cycle_cmd

    def state(store):
        return ({p.metadata.key(): p.spec.node_name
                 for p in store.list("pods")},
                {g.metadata.key(): (g.status.phase, g.status.running)
                 for g in store.list("podgroups")})

    runs = {apply: cycle_cmd.run_cycle(256, 64, 1, "cpu", scenario=scenario,
                                       apply=apply)
            for apply in ("deferred", "eager")}
    for apply, r in runs.items():
        assert r["apply"] == apply
    assert state(runs["deferred"]["store"]) == state(runs["eager"]["store"])
    assert runs["deferred"]["binds"] == runs["eager"]["binds"] > 0
    assert runs["deferred"]["evictions"] == runs["eager"]["evictions"]


def test_cycle_command_alternates_applies(capsys):
    """``--apply alternate``: a deferred cold run, then warm runs in
    deferred, eager, eager, deferred order, each naming its apply; the
    eager runs stage in allocate, the deferred ones in backfill."""
    from volcano_tpu_torch.cmd import cycle as cycle_cmd
    assert cycle_cmd.main(["--device", "cpu", "--tasks", "64", "--nodes",
                           "16", "--apply", "alternate", "--warm", "4"]) == 0
    out = json.loads(capsys.readouterr().out)
    runs = [out["cold"]] + out["warm"]
    assert [r["apply"] for r in runs] == \
        ["deferred", "deferred", "eager", "eager", "deferred"]
    assert len({r["binds"] for r in runs}) == 1
