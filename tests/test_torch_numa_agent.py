"""The port's NumaAgent (volcano_tpu_torch/utils/numa_agent.py) against the
JAX package's: the cases of tests/test_infra.py:127-165 (TestNumaAgent)
through the port's store and Scheduler(device="cpu"), and one node stream
through both packages' agents with the published Numatopologies equal
field by field.

Tolerance: exact.
"""

import pytest

from volcano_tpu.apiserver import ObjectStore as RefStore
from volcano_tpu.utils import numa_agent as ref_agent
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu_torch.apiserver import ObjectStore
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.scheduler import Scheduler
from volcano_tpu_torch.utils import numa_agent
from volcano_tpu_torch.utils import test_utils as tu

CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: gang
  - name: priority
- plugins:
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: numa-aware
"""


def test_publishes_topology_for_nodes():
    store = ObjectStore()
    agent = numa_agent.NumaAgent(store, default_shape=numa_agent.NumaShape(
        numa_count=2, cores_per_numa=4, threads_per_core=2,
        topology_manager_policy="single-numa-node"))
    store.create("nodes", tu.build_node("n1", {"cpu": "16",
                                               "memory": "32Gi"}))
    nt = store.get("numatopologies", "n1")
    assert nt is not None
    assert nt.policies["TopologyManagerPolicy"] == "single-numa-node"
    assert len(nt.cpu_detail) == 16
    assert nt.numa_res["cpu"].capacity == 16
    assert {c.numa_id for c in nt.cpu_detail.values()} == {0, 1}
    agent.stop()
    store.create("nodes", tu.build_node("n2", {"cpu": "16",
                                               "memory": "32Gi"}))
    assert store.get("numatopologies", "n2") is None


def test_numa_scheduling_end_to_end_with_agent():
    """Agent-published topology drives numaaware admission."""
    store = ObjectStore()
    agent = numa_agent.NumaAgent(store, default_shape=numa_agent.NumaShape(
        numa_count=2, cores_per_numa=2, threads_per_core=2,
        topology_manager_policy="single-numa-node"))
    cache = SchedulerCache(store, binder=tu.FakeBinder(store),
                           evictor=tu.FakeEvictor(store))
    cache.run()
    try:
        sched = Scheduler(store, scheduler_conf=CONF, cache=cache,
                          device="cpu")
        store.create("queues", tu.build_queue("default"))
        store.create("nodes", tu.build_node("n1", {"cpu": "8",
                                                   "memory": "16Gi"}))
        store.create("podgroups", tu.build_pod_group(
            "pg1", "ns1", "default", 1, phase="Inqueue"))
        pod = tu.build_pod("ns1", "p0", "", "Pending",
                           {"cpu": "2", "memory": "1Gi"}, "pg1")
        pod.spec.containers[0].limits = dict(pod.spec.containers[0].requests)
        pod.metadata.annotations["volcano.sh/numa-topology-policy"] = \
            "single-numa-node"
        store.create("pods", pod)
        sched.run_once()
        assert cache.flush_executors()
        assert store.get("pods", "p0", "ns1").spec.node_name == "n1"
        nt = store.get("numatopologies", "n1")
        assert len(nt.cpu_detail) == 8
    finally:
        cache.stop()
        agent.stop()


def _topologies(store):
    """name -> every field of its Numatopology."""
    out = {}
    for nt in store.list("numatopologies"):
        out[nt.metadata.name] = (
            dict(nt.policies),
            {k: (list(v.allocatable), v.capacity)
             for k, v in nt.numa_res.items()},
            {i: (c.numa_id, c.socket_id, c.core_id)
             for i, c in nt.cpu_detail.items()},
            dict(nt.res_reserved))
    return out


@pytest.mark.parametrize("late_shapes", [False, True])
def test_node_stream_publishes_as_the_reference(late_shapes):
    """Nodes before and after the agent starts, a shape map with a
    default and per-node shapes (other policies, reserved CPU), an update
    of a node that already has topology, and a node after stop()."""
    def shapes(mod):
        return {"big": mod.NumaShape(numa_count=4, cores_per_numa=8,
                                     threads_per_core=1,
                                     cpu_manager_policy="none",
                                     topology_manager_policy="restricted",
                                     reserved_cpu_milli=1500.0),
                "odd": mod.NumaShape(numa_count=3, cores_per_numa=3,
                                     threads_per_core=2)}

    def stream(store, mod, t):
        store.create("nodes", t.build_node("early", {"cpu": "8",
                                                     "memory": "8Gi"}))
        agent = mod.NumaAgent(
            store, default_shape=None if late_shapes else mod.NumaShape(
                numa_count=2, cores_per_numa=4),
            shapes=shapes(mod))
        for name in ("big", "odd", "plain"):
            store.create("nodes", t.build_node(name, {"cpu": "16",
                                                      "memory": "32Gi"}))
        node = store.get("nodes", "plain")
        node.metadata.labels["x"] = "y"
        store.update("nodes", node)
        agent.stop()
        store.create("nodes", t.build_node("after", {"cpu": "8",
                                                     "memory": "8Gi"}))
        return _topologies(store)

    ref = stream(RefStore(), ref_agent, ref_tu)
    port = stream(ObjectStore(), numa_agent, tu)
    assert port == ref
    expect = {"big", "odd"} if late_shapes else {"early", "big", "odd",
                                                 "plain"}
    assert set(port) == expect
    assert port["big"][3] == {"cpu": 1500.0}
