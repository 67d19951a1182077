"""Node sampling in the port (``BatchSolver._node_order``, solver conf
``sampling.*``) against the JAX package: the cases of
tests/test_sampling.py through both packages, two cycles in which the
window rotates, and sampling together with pruning.

The window's start is a process-wide cursor in each package; every test
resets both before it runs. Tolerance: exact (window names, binds, PodGroup
phases and conditions; prune summaries as tests/test_torch_prune.py holds
them).
"""

import pytest

import volcano_tpu.framework.solver as ref_solver
import volcano_tpu_torch.framework.solver as port_solver
from tests.test_torch_cycle import PORT, REF, outcome
from tests.test_torch_prune import assert_summaries, run
from volcano_tpu.framework import open_session as ref_open_session
from volcano_tpu.framework import parse_scheduler_conf as ref_parse
from volcano_tpu_torch.framework import open_session as port_open_session
from volcano_tpu_torch.framework import parse_scheduler_conf as port_parse

CONF_OFF = """
actions: "enqueue, allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: predicates
  - name: nodeorder
"""

CONF_ON = CONF_OFF + """
configurations:
- name: solver
  arguments:
    sampling.enable: "true"
    sampling.percentage: 25
    sampling.minNodes: 8
"""

RL = {"cpu": "1", "memory": "1Gi"}


@pytest.fixture(autouse=True)
def reset_cursors():
    ref_solver._node_cursor = 0
    port_solver._node_cursor = 0
    yield


def build_env(nodes=40, gangs=2, gang=2, first=0):
    """tests/test_sampling.py's cluster in either package: ``nodes`` nodes
    of 8 CPU, ``gangs`` gangs of ``gang`` pods of 1 CPU (numbered from
    ``first``; nodes only when ``first`` is 0)."""
    def build(pkg, store):
        tu = pkg.tu
        if not first:
            q = tu.build_queue("default", weight=1)
            q.metadata.creation_timestamp = 1.0
            store.create("queues", q)
            for i in range(nodes):
                node = tu.build_node(f"n{i:03d}", {"cpu": "8",
                                                   "memory": "16Gi"})
                node.metadata.creation_timestamp = 1.0
                store.create("nodes", node)
        for j in range(first, first + gangs):
            pg = tu.build_pod_group(f"pg{j}", "ns1", "default", gang,
                                    phase="Inqueue")
            pg.metadata.creation_timestamp = 10.0 + j
            store.create("podgroups", pg)
            for t in range(gang):
                pod = tu.build_pod("ns1", f"pg{j}-{t}", "", "Pending", RL,
                                   groupname=f"pg{j}")
                pod.metadata.creation_timestamp = 10.0 + j
                store.create("pods", pod)
    return build


def sessions(pkg, conf_text, build, n):
    """The node orders of ``n`` sessions opened one after another on one
    cache, each read twice (it must be stable within a session)."""
    store = pkg.Store()
    build(pkg, store)
    cache = pkg.Cache(store)
    cache.run()
    # sessions only: no watch or executor after the list
    cache.stop()
    if pkg is REF:
        c = ref_parse(conf_text)
        open_one = lambda: ref_open_session(cache, c.tiers, c.configurations)
    else:
        c = port_parse(conf_text)
        open_one = lambda: port_open_session(cache, c.tiers,
                                             c.configurations, device="cpu")
    orders = []
    for _ in range(n):
        ssn = open_one()
        first = ssn.solver._node_order()
        assert ssn.solver._node_order() == first
        orders.append((ssn.solver.sampling, first))
    return orders


def test_sampling_off_by_default_considers_all_nodes():
    ref = sessions(REF, CONF_OFF, build_env(), 1)
    port = sessions(PORT, CONF_OFF, build_env(), 1)
    assert port == ref
    assert port[0][0] is False and len(port[0][1]) == 40


def test_sampling_window_size_and_rotation():
    ref = sessions(REF, CONF_ON, build_env(), 3)
    port = sessions(PORT, CONF_ON, build_env(), 3)
    assert port == ref
    (on, first), (_, second), _ = port
    assert on is True and len(first) == 10       # 25% of 40 (>= minNodes)
    assert second[0] == "n010" and second != first


def test_sampling_adaptive_percentage_small_cluster_uncapped():
    """Clusters at or below minNodes are never sampled."""
    ref = sessions(REF, CONF_ON, build_env(nodes=8), 2)
    port = sessions(PORT, CONF_ON, build_env(nodes=8), 2)
    assert port == ref
    assert all(len(order) == 8 for _, order in port)
    assert port_solver._node_cursor == 0


def test_sampling_adaptive_window_wraps():
    """percentage 0 is adaptive (50 - N/125, at least 5): the window is
    max(minNodes, that share) and wraps past the last node."""
    conf_text = CONF_ON.replace("sampling.percentage: 25",
                                "sampling.percentage: 0")
    ref = sessions(REF, conf_text, build_env(nodes=30), 4)
    port = sessions(PORT, conf_text, build_env(nodes=30), 4)
    assert port == ref
    assert [len(order) for _, order in port] == [14] * 4
    assert port[2][1][:3] == ["n028", "n029", "n000"]


def _cycles(pkg, builds, conf_text, **kw):
    """One cycle per build on one store: the first fills it, each later one
    adds gangs before its cycle. Returns the outcome after each cycle."""
    store = pkg.Store()
    builds[0](pkg, store)
    cache = pkg.Cache(store, binder=pkg.tu.FakeBinder(store))
    cache.run()
    sched = pkg.Scheduler(store, scheduler_conf=conf_text, cache=cache, **kw)
    out = []
    for i, build in enumerate(builds):
        if i:
            build(pkg, store)
        sched.run_once()
        cache.flush_executors()
        out.append(outcome(store))
    cache.stop()
    return out


def test_sampling_cycle_still_binds_gangs():
    """Placement through the sampled window gang-binds, inside the first
    window, as the reference does."""
    builds = [build_env(gangs=3, gang=2)]
    ref = _cycles(REF, builds, CONF_ON)
    port = _cycles(PORT, builds, CONF_ON, device="cpu")
    assert port == ref
    binds = port[0][0]
    assert len(binds) == 6
    assert all(node < "n010" for node in binds.values()), binds


def test_two_cycles_with_a_rotating_window():
    """The second cycle's window starts where the first ended: its binds
    land in n010-n019 in both packages."""
    builds = [build_env(gangs=3, gang=2),
              build_env(gangs=3, gang=2, first=3)]
    ref = _cycles(REF, builds, CONF_ON)
    port = _cycles(PORT, builds, CONF_ON, device="cpu")
    assert port == ref
    first, second = port[0][0], port[1][0]
    new = {k: v for k, v in second.items() if k not in first}
    assert len(first) == 6 and len(new) == 6
    assert all("n010" <= node < "n020" for node in new.values()), new


def test_sampling_with_pruning():
    """A sampled window under forced pruning: the distillation sees the
    window's nodes only, and the reduced run binds as the reference's."""
    conf_text = CONF_ON + '    prune.enable: "true"\n    prune.k: 2\n' \
        '    kernel: scan\n    mesh.enable: "false"\n'
    build = build_env(nodes=64, gangs=5, gang=4)
    ref = run(REF, build, conf_text)
    port = run(PORT, build, conf_text, device="cpu")
    assert port[0] == ref[0] and len(port[0][0]) == 20
    assert_summaries(port[1], ref[1])
    assert port[1] and all(s["nodes"] == 16 for s in port[1])
    assert all(s["served"] for s in port[1])
