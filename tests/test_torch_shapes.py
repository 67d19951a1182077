"""Shapes beyond the kernel's old limits, through whole cycles: more than
eight resource kinds (R = 9, 12, 16 and 20: cpu, memory and 7, 10, 14 and
18 scalar kinds).

The port's store is built by ``utils/synth.py:populate_store(...,
scalars=...)``; the JAX package's, which has no such option, by the same
builders of its own ``utils/test_utils.py`` here (``reference_store``),
object for object. The port's ``Scheduler(device="cpu")`` runs against
``volcano_tpu.scheduler.Scheduler`` under the reference's default conf
and with ``prune.enable: "off"`` (plus one case with pruning forced on).
The scalar kinds are scarce (4 nodes of 16 units each for 24 gangs), so
they decide which gangs fit and some roll back.

Tolerance: exact. Binds (pod -> node) and PodGroup phases, read back from
the stores, must be equal. The kernel's own shapes are held by
tests/test_torch_cuda_allocate.py (plans, input checks) and, on the card,
by chip_smoke.py's ``shapes_vs_plain``.
"""

import pytest

from volcano_tpu.apiserver import ObjectStore as RefStore
from volcano_tpu.cache import SchedulerCache as RefCache
from volcano_tpu.scheduler import Scheduler as RefScheduler
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu_torch.apiserver import ObjectStore as PortStore
from volcano_tpu_torch.cache import SchedulerCache as PortCache
from volcano_tpu_torch.models.arrays import ResourceIndex
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler
from volcano_tpu_torch.utils import synth as port_synth
from volcano_tpu_torch.utils import test_utils as port_tu

SHAPE = dict(n_nodes=4, n_jobs=24, gang_size=4)
CONFS = {
    "default": None,
    "prune_off": """
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
configurations:
- name: solver
  arguments: {prune.enable: "off", mesh.enable: "false"}
""",
}
CONFS["prune_forced"] = CONFS["prune_off"].replace(
    'prune.enable: "off"', 'prune.enable: "true", prune.k: 2')


def reference_store(kinds, n_nodes, n_jobs, gang_size):
    """The JAX package's store of populate_store's shape with ``kinds``,
    from its own builders, in populate_store's order."""
    store = RefStore()
    store.create("queues", ref_tu.build_queue("default", weight=1))
    for i in range(n_nodes):
        alloc = {"cpu": "64", "memory": "256Gi", "pods": "110"}
        alloc.update({kind: port_synth.SCALAR_CAPACITY for kind in kinds})
        store.create("nodes", ref_tu.build_node(
            f"node-{i}", alloc, labels={"rack": f"rack-{i % 32}"}))
    for j in range(n_jobs):
        store.create("podgroups", ref_tu.build_pod_group(
            f"pg-{j}", "default", "default", gang_size, phase="Inqueue"))
        req = {"cpu": "2", "memory": "4Gi"}
        req.update({kind: str(port_synth.scalar_request(j, k))
                    for k, kind in enumerate(kinds)
                    if port_synth.scalar_request(j, k)})
        for t in range(gang_size):
            store.create("pods", ref_tu.build_pod(
                "default", f"job{j}-task{t}", "", "Pending", dict(req),
                groupname=f"pg-{j}"))
    return store


def port_store(kinds, **shape):
    store = PortStore()
    port_synth.populate_store(store, scalars=kinds, **shape)
    return store


def outcome(store):
    binds = {f"{p.metadata.namespace}/{p.metadata.name}": p.spec.node_name
             for p in store.list("pods") if p.spec.node_name}
    phases = {f"{g.metadata.namespace}/{g.metadata.name}": g.status.phase
              for g in store.list("podgroups")}
    return binds, phases


def run(store, cache_cls, sched_cls, tu, conf, **kw):
    cache = cache_cls(store, binder=tu.FakeBinder(store))
    cache.run()
    sched = sched_cls(store, scheduler_conf=conf, cache=cache, **kw)
    sched.run_once()
    cache.flush_executors()
    cache.stop()
    return outcome(store), sched


def test_populate_store_scalars_default_leaves_the_fixture_unchanged():
    """Without ``scalars`` the nodes and pods carry cpu, memory (and the
    nodes pods) only, as before the option existed."""
    store = port_store((), **SHAPE)
    assert all(set(n.status.allocatable) == {"cpu", "memory", "pods"}
               for n in store.list("nodes"))
    assert all(set(p.spec.containers[0].requests) == {"cpu", "memory"}
               for p in store.list("pods"))


def test_scalar_kinds_name_gpu_fleet_devices_then_numbered_ones():
    kinds = port_synth.scalar_kinds(18)
    assert kinds[:7] == port_synth.SCALAR_KINDS
    assert len(set(kinds)) == 18
    assert kinds[7:] == tuple(f"example.com/dev-{i}" for i in range(11))


@pytest.mark.parametrize("r", [9, 12, 16, 20])
@pytest.mark.parametrize("conf", sorted(CONFS))
def test_cycle_with_many_resource_kinds_matches_reference(r, conf):
    kinds = port_synth.scalar_kinds(r - 2)
    port_s = port_store(kinds, **SHAPE)
    ref_s = reference_store(kinds, **SHAPE)
    # the two stores hold the same objects' resources
    assert sorted((n.metadata.name, sorted(n.status.allocatable.items()))
                  for n in port_s.list("nodes")) == sorted(
        (n.metadata.name, sorted(n.status.allocatable.items()))
        for n in ref_s.list("nodes"))
    assert sorted((p.metadata.name,
                   sorted(p.spec.containers[0].requests.items()))
                  for p in port_s.list("pods")) == sorted(
        (p.metadata.name, sorted(p.spec.containers[0].requests.items()))
        for p in ref_s.list("pods"))
    (rb, rp), _ = run(ref_s, RefCache, RefScheduler, ref_tu, CONFS[conf])
    (pb, pp), sched = run(port_s, PortCache, PortScheduler, port_tu,
                          CONFS[conf], device="cpu")
    assert pb == rb, sorted(set(pb.items()) ^ set(rb.items()))[:10]
    assert pp == rp, {k: (pp[k], rp.get(k)) for k in pp if pp[k] != rp[k]}
    # the scalar kinds decide: some gangs fit, some do not
    assert 0 < len(pb) < SHAPE["n_jobs"] * SHAPE["gang_size"]
    places = sched.last_cycle["places"]
    assert places and all(pl["R"] == r for pl in places)
    assert all(pl["plan"] == "shared" for pl in places)
    if conf == "prune_forced":
        assert places[0]["prune"] is not None


def test_resource_index_counts_every_scalar_kind():
    kinds = port_synth.scalar_kinds(18)
    store = port_store(kinds, **SHAPE)
    cache = PortCache(store)
    cache.run()
    cache.stop()
    snap = cache.snapshot()
    rindex = ResourceIndex.from_cluster(snap.nodes, snap.jobs)
    assert rindex.r == 20
    assert set(rindex.names[2:]) == set(kinds)
