"""The store-backed volume binder, the cache's default in both packages,
held against the JAX package: the first three cases of
tests/test_volume_binding.py (a claim binds to a volume on schedule; a
pod whose claim matches no volume stays Pending; storage class, node
reachability and in-cycle assumptions) through each package, then seeded
incremental cycles of the whole scheduler with claim-mounting pods, under
the cache's executor and under ``cmd.cycle.InlineCache``, against the
reference's cycles, with claims and volumes added and removed between
cycles.

Each side builds its own objects from one plain description made with
numpy from a seed (nothing crosses between the packages). Compared in
every cycle, exactly: the binds read back from the store, the PodGroup
phases, each volume's phase and claim and each claim's phase and volume.
"""

import numpy as np
import pytest

from tests.harness import Harness as RefHarness
from tests.test_torch_cycle import PORT, REF, conf, make_spec, populate
from tests.test_torch_victims import PortHarness
from volcano_tpu.cache.interface import StoreVolumeBinder as RefBinder
from volcano_tpu.cache.interface import VolumeBindError as RefBindError
from volcano_tpu_torch.apiserver.store import FencedError
from volcano_tpu_torch.cache.interface import (NullVolumeBinder,
                                               StoreVolumeBinder,
                                               VolumeBindError)
from volcano_tpu_torch.cmd.cycle import InlineCache

CONF = """
actions: "enqueue, allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: predicates
  - name: nodeorder
"""

SIDES = {"ref": (REF, RefHarness, RefBinder, RefBindError),
         "port": (PORT, PortHarness, StoreVolumeBinder, VolumeBindError)}


def pvc(o, name, ns="ns1", storage="10Gi", cls=""):
    return o.PersistentVolumeClaim(
        metadata=o.ObjectMeta(name=name, namespace=ns),
        spec={"resources": {"requests": {"storage": storage}},
              "storageClassName": cls})


def pv(o, name, capacity="20Gi", cls="", nodes=None):
    return o.PersistentVolume(metadata=o.ObjectMeta(name=name),
                              capacity=capacity, storage_class=cls,
                              node_affinity=list(nodes or []))


def pod_with_pvc(pkg, ns, name, claim, group):
    tu = pkg.tu
    p = tu.build_pod(ns, name, "", "Pending",
                     tu.build_resource_list("1", "1Gi"), group)
    p.spec.volumes = [{"name": "data",
                       "persistentVolumeClaim": {"claimName": claim}}]
    return p


def volume_states(store):
    """(volume -> (phase, claim), claim -> (phase, volume))."""
    pvs = {v.metadata.name: (v.phase, v.claim_ref)
           for v in store.list("persistentvolumes")}
    pvcs = {f"{c.metadata.namespace}/{c.metadata.name}":
            (c.phase, c.volume_name)
            for c in store.list("persistentvolumeclaims")}
    return pvs, pvcs


# -- tests/test_volume_binding.py:52, :71, :85 --------------------------------

def session_case(side, claim_storage, pv_capacity):
    pkg, harness, _, _ = SIDES[side]
    tu, o = pkg.tu, pkg.obj
    h = harness(CONF)
    h.add("queues", tu.build_queue("default", weight=1))
    h.add("nodes", tu.build_node("n1", {"cpu": "8", "memory": "16Gi"}))
    h.add("persistentvolumeclaims", pvc(o, "data-claim",
                                        storage=claim_storage))
    h.add("persistentvolumes", pv(o, "vol-1", capacity=pv_capacity))
    h.add("podgroups", tu.build_pod_group("pg", "ns1", "default", 1,
                                          phase="Inqueue"))
    h.add("pods", pod_with_pvc(pkg, "ns1", "p1", "data-claim", "pg"))
    h.run_actions("enqueue", "allocate").close_session()
    out = dict(h.binder.binds), volume_states(h.store)
    h.cache.stop()
    return out


def test_pod_with_pvc_binds_volume_on_schedule():
    ref = session_case("ref", "10Gi", "20Gi")
    port = session_case("port", "10Gi", "20Gi")
    assert port == ref
    binds, (pvs, pvcs) = port
    assert binds == {"ns1/p1": "n1"}
    assert pvs == {"vol-1": ("Bound", "ns1/data-claim")}
    assert pvcs == {"ns1/data-claim": ("Bound", "vol-1")}


def test_pod_without_matching_pv_does_not_schedule():
    ref = session_case("ref", "100Gi", "10Gi")
    port = session_case("port", "100Gi", "10Gi")
    assert port == ref
    binds, (pvs, pvcs) = port
    assert binds == {}
    assert pvs == {"vol-1": ("Available", "")}
    assert pvcs == {"ns1/data-claim": ("Pending", "")}


def binder_case(side):
    """tests/test_volume_binding.py:85 on ``side``: what each step plans
    or raises."""
    pkg, _, binder_cls, bind_error = SIDES[side]
    o, tu = pkg.obj, pkg.tu
    store = pkg.Store()
    binder = binder_cls(store)
    store.create("persistentvolumeclaims", pvc(o, "c1", cls="fast"))
    store.create("persistentvolumes", pv(o, "slow-1", cls="slow"))
    store.create("persistentvolumes", pv(o, "fast-1", cls="fast",
                                         nodes=["n2"]))

    class T:
        namespace = "ns1"
        pod = pod_with_pvc(pkg, "ns1", "p", "c1", "")

    class T2:
        namespace = "ns1"
        pod = pod_with_pvc(pkg, "ns1", "q", "c2", "")

    n1 = tu.build_node("n1", {"cpu": "1"})
    n2 = tu.build_node("n2", {"cpu": "1"})
    steps = []
    with pytest.raises(bind_error):
        binder.get_pod_volumes(T(), n1)   # fast-1 unreachable from n1
    vols = binder.get_pod_volumes(T(), n2)
    steps.append(vols.bindings)
    binder.allocate_volumes(T(), "n2", vols)
    # a pod sharing the claim rides the in-flight binding
    steps.append(binder.get_pod_volumes(T(), n2).bindings)
    # a different claim cannot book the assumed volume
    store.create("persistentvolumeclaims", pvc(o, "c2", cls="fast"))
    with pytest.raises(bind_error):
        binder.get_pod_volumes(T2(), n2)
    binder.release_volumes(T(), vols)
    steps.append(binder.get_pod_volumes(T(), n2).bindings)
    return steps


def test_pv_node_affinity_restricts_reuse_and_class_matching():
    port = binder_case("port")
    assert port == binder_case("ref")
    assert port == [[("ns1/c1", "fast-1")], [], [("ns1/c1", "fast-1")]]


def test_null_binder_counts_volumes_as_bound():
    """``NullVolumeBinder`` is still there for callers that pass it: the
    claim that matches no volume then binds."""
    h = PortHarness(CONF)
    h.cache.volume_binder = NullVolumeBinder()
    tu, o = PORT.tu, PORT.obj
    h.add("queues", tu.build_queue("default", weight=1))
    h.add("nodes", tu.build_node("n1", {"cpu": "8", "memory": "16Gi"}))
    h.add("persistentvolumeclaims", pvc(o, "data-claim", storage="100Gi"))
    h.add("podgroups", tu.build_pod_group("pg", "ns1", "default", 1,
                                          phase="Inqueue"))
    h.add("pods", pod_with_pvc(PORT, "ns1", "p1", "data-claim", "pg"))
    h.run_actions("enqueue", "allocate").close_session()
    binds = dict(h.binder.binds)
    h.cache.stop()
    assert binds == {"ns1/p1": "n1"}


def test_volume_plan_and_bind_are_timed():
    """A cycle that plans and binds a claim reports both times in the
    session's timings (``volumes.plan``, ``volumes.bind``)."""
    h = PortHarness(CONF)
    tu, o = PORT.tu, PORT.obj
    h.add("queues", tu.build_queue("default", weight=1))
    h.add("nodes", tu.build_node("n1", {"cpu": "8", "memory": "16Gi"}))
    h.add("persistentvolumeclaims", pvc(o, "data-claim"))
    h.add("persistentvolumes", pv(o, "vol-1"))
    h.add("podgroups", tu.build_pod_group("pg", "ns1", "default", 1,
                                          phase="Inqueue"))
    h.add("pods", pod_with_pvc(PORT, "ns1", "p1", "data-claim", "pg"))
    timings = h.run_actions("enqueue", "allocate").ssn.timings
    h.close_session()
    h.cache.stop()
    assert dict(h.binder.binds) == {"ns1/p1": "n1"}
    assert timings["volumes.plan"] >= 0.0
    assert timings["volumes.bind"] >= 0.0


def test_volume_bind_writes_carry_the_fencing_token():
    """The cache's default binder stamps its PV and PVC writes with the
    cache's fencing token: a deposed leader's volume bind is refused and
    leaves both objects as they were, and the leader's lands."""
    o = PORT.obj
    store = PORT.Store()
    token = [1]
    cache = PORT.Cache(store, fence_source=lambda: token[0])
    binder = cache.volume_binder
    store.create("persistentvolumeclaims", pvc(o, "c1"))
    store.create("persistentvolumes", pv(o, "vol-1"))

    class T:
        namespace = "ns1"
        pod = pod_with_pvc(PORT, "ns1", "p", "c1", "")

    vols = binder.get_pod_volumes(T(), None)
    binder.allocate_volumes(T(), "n1", vols)
    store.advance_fence(2)
    with pytest.raises(FencedError):
        binder.bind_volumes(T(), vols)
    assert store.fenced_writes == 1
    assert volume_states(store) == ({"vol-1": ("Available", "")},
                                    {"ns1/c1": ("Pending", "")})
    token[0] = 2
    binder.bind_volumes(T(), vols)
    assert volume_states(store) == ({"vol-1": ("Bound", "ns1/c1")},
                                    {"ns1/c1": ("Bound", "vol-1")})


# -- seeded incremental cycles ------------------------------------------------

CLASSES = ("fast", "standard")
# the class of the claims no volume of the plan matches
UNMATCHED = "archive"


def volume_spec(spec, seed, every=2):
    """Claims and volumes for ``spec``'s pods, drawn from ``seed``: every
    ``every``-th job mounts claims (each pod its own, or, one job in
    three, one claim shared by the gang). Two jobs in three get a volume
    for each claim, 0-10 Gi larger than the request, of one of CLASSES,
    beside decoys (too small, of the other class, reachable from one node
    only); the third has claims of the class UNMATCHED, which no volume
    has. The volumes lie in a shuffled store order. Returns (claims by
    pod name, claims, volumes): claims as (namespace, name, storage,
    class, job), volumes as (name, capacity, class, nodes)."""
    rng = np.random.default_rng(seed)
    by_pod, claims, vols = {}, [], []
    groups = {}
    for p in spec["pods"]:
        groups.setdefault(p["group"], []).append(p)
    nodes = [n["name"] for n in spec["nodes"]]
    for j, (group, pods) in enumerate(sorted(groups.items())):
        if j % every:
            continue
        k = j // every
        shared = k % 3 == 2
        cls = CLASSES[k % 2] if k % 3 != 1 else UNMATCHED
        for t, p in enumerate(pods):
            name = f"c-{group}" if shared else f"c-{p['name']}"
            by_pod[p["name"]] = name
            if shared and t:
                continue
            req = int(rng.integers(5, 50))
            claims.append((p["ns"], name, f"{req}Gi", cls, group))
            if cls == UNMATCHED:
                continue
            vols.append((f"v-{name}", f"{req + int(rng.integers(0, 11))}Gi",
                         cls, []))
            if rng.uniform() < 0.3:
                vols.append((f"d-{name}", f"{max(1, req - 2)}Gi", cls, []))
            if rng.uniform() < 0.3:
                vols.append((f"o-{name}", f"{req}Gi",
                             CLASSES[1 - k % 2], []))
            if rng.uniform() < 0.3:
                node = nodes[int(rng.integers(len(nodes)))]
                vols.append((f"n-{name}", f"{req}Gi", cls, [node]))
    order = rng.permutation(len(vols))
    return by_pod, claims, [vols[i] for i in order]


class WithVolumes:
    """Hands ``populate`` a store whose pods mount their claims."""

    def __init__(self, store, by_pod):
        self.store, self.by_pod = store, by_pod

    def create(self, kind, o):
        claim = self.by_pod.get(o.metadata.name) if kind == "pods" else None
        if claim is not None:
            o.spec.volumes = [{"name": "data", "persistentVolumeClaim":
                               {"claimName": claim}}]
        return self.store.create(kind, o)


def add_volumes(pkg, store, claims, vols):
    o = pkg.obj
    for ns, name, storage, cls, _ in claims:
        store.create("persistentvolumeclaims",
                     pvc(o, name, ns=ns, storage=storage, cls=cls))
    for name, cap, cls, nodes in vols:
        store.create("persistentvolumes",
                     pv(o, name, capacity=cap, cls=cls, nodes=nodes))


def churn_plan(spec, claims, vols, seed):
    """Between cycle 1 and 2: volumes for every claim of one job that had
    none, and one claim of another such job deleted; between 2 and 3: a
    new job with claims and volumes."""
    rng = np.random.default_rng(seed + 1)
    jobs = sorted({c[4] for c in claims if c[3] == UNMATCHED})
    late_job = jobs[int(rng.integers(len(jobs)))]
    extra = [(f"late-{name}", "60Gi", cls, [])
             for _, name, _, cls, job in claims if job == late_job]
    doomed = [c for c in claims if c[3] == UNMATCHED
              and c[4] != late_job][:1]
    more = make_spec(seed + 7, n_jobs=2, gang=(2, 3), job_offset=100,
                     node_offset=100)
    more_by_pod, more_claims, more_vols = volume_spec(
        dict(more, nodes=spec["nodes"]), seed + 9, every=1)
    return [(extra, doomed, None), ([], [], (more, more_by_pod, more_claims,
                                              more_vols))]


def run_volume_cycles(pkg, spec, plan, churn, conf_text, cycles,
                      inline=False, **kw):
    by_pod, claims, vols = plan
    store = pkg.Store()
    add_volumes(pkg, store, claims, vols)
    populate(pkg, WithVolumes(store, by_pod), spec)
    cache = (InlineCache if inline else pkg.Cache)(store)
    cache.run()
    sched = pkg.Scheduler(store, scheduler_conf=conf_text, cache=cache, **kw)
    out = []
    for c in range(cycles):
        if c:
            extra, doomed, more = churn[c - 1]
            for ns, name, _, _, _ in doomed:
                store.delete("persistentvolumeclaims", name, ns)
            add_volumes(pkg, store, [], extra)
            if more is not None:
                mspec, mby_pod, mclaims, mvols = more
                add_volumes(pkg, store, mclaims, mvols)
                populate(pkg, WithVolumes(store, mby_pod), mspec)
        sched.run_once()
        cache.flush_executors()
        binds = {f"{p.metadata.namespace}/{p.metadata.name}":
                 p.spec.node_name for p in store.list("pods")
                 if p.spec.node_name}
        phases = {g.metadata.key(): g.status.phase
                  for g in store.list("podgroups")}
        out.append((binds, phases, volume_states(store)))
    cache.stop()
    return out


@pytest.mark.parametrize("commit", ["live", "inline"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_volume_cycles_match_reference(seed, commit):
    spec = make_spec(seed, n_nodes=12, n_jobs=14, gang=(2, 4),
                     node_cpu=(8, 17), node_mem_gi=(16, 33))
    plan = volume_spec(spec, seed)
    churn = churn_plan(spec, plan[1], plan[2], seed)
    text = conf()
    ref = run_volume_cycles(REF, spec, plan, churn, text, 3)
    port = run_volume_cycles(PORT, spec, plan, churn, text, 3,
                             inline=commit == "inline", device="cpu")
    for c, (r, p) in enumerate(zip(ref, port)):
        assert p[0] == r[0], (c, sorted(set(p[0].items())
                                        ^ set(r[0].items())))
        assert p[1] == r[1], c
        assert p[2] == r[2], c
    last_pvs, last_pvcs = ref[-1][2]
    bound = [k for k, (phase, _) in last_pvcs.items() if phase == "Bound"]
    pending = [k for k, (phase, _) in last_pvcs.items() if phase != "Bound"]
    assert bound and pending, (bound, pending)
    # every bound claim holds its own volume
    vols = [v for k, (_, v) in last_pvcs.items() if k in bound]
    assert len(set(vols)) == len(vols)
    assert all(last_pvs[v] == ("Bound", k) for k, (_, v)
               in last_pvcs.items() if k in bound)
    # a pod whose claim is unbound is not bound either
    claim_of = {f"default/{p}": f"default/{c}" for p, c in plan[0].items()}
    for pod, node in ref[-1][0].items():
        if pod in claim_of and claim_of[pod] in last_pvcs:
            assert last_pvcs[claim_of[pod]][0] == "Bound", pod
