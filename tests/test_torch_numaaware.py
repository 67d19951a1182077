"""The numa-aware plugin of the port held against the JAX package's: the
topology-manager policies and the CPU manager on the cases of
tests/test_numaaware.py and on seeded random inputs, the plugin's
admission and write-back through a session, and whole cycles of a NUMA
cluster over three incremental cycles.

Each side builds its own objects from one plain description (numpy draws
from a seed); nothing crosses between the packages. Tolerance: exact for
everything here (bitmasks, CPU-id sets, binds, PodGroup phases and
conditions, the NUMA sets left in each cache).
"""

import numpy as np
import pytest

from tests.harness import Harness as RefHarness
from tests.test_torch_cycle import PORT, REF, make_spec, outcome, populate
from tests.test_torch_victims import PortHarness
from volcano_tpu.models import numa_info as ref_numa_info
from volcano_tpu.models import objects as ref_obj
from volcano_tpu.plugins import numaaware as ref_numa
from volcano_tpu.plugins.numaaware import cpumanager as ref_cpu
from volcano_tpu.plugins.numaaware import policy as ref_policy
from volcano_tpu.utils import numa_agent as ref_agent
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu.utils.clock import FakeClock as RefClock
from volcano_tpu_torch.models import numa_info as port_numa_info
from volcano_tpu_torch.models import objects as port_obj
from volcano_tpu_torch.plugins import numaaware as port_numa
from volcano_tpu_torch.plugins.numaaware import cpumanager as port_cpu
from volcano_tpu_torch.plugins.numaaware import policy as port_policy
from volcano_tpu_torch.utils import numa_agent as port_agent
from volcano_tpu_torch.utils import test_utils as port_tu
from volcano_tpu_torch.utils.clock import FakeClock as PortClock

SIDES = {
    "ref": dict(policy=ref_policy, cpu=ref_cpu, obj=ref_obj, numa=ref_numa,
                info=ref_numa_info, agent=ref_agent, tu=ref_tu,
                Harness=RefHarness, Clock=RefClock, pkg=REF),
    "port": dict(policy=port_policy, cpu=port_cpu, obj=port_obj,
                 numa=port_numa, info=port_numa_info, agent=port_agent,
                 tu=port_tu, Harness=PortHarness, Clock=PortClock,
                 pkg=PORT),
}


def both(fn):
    """fn(side) for both packages -> (ref result, port result)."""
    return fn(SIDES["ref"]), fn(SIDES["port"])


# -- policies ----------------------------------------------------------------

def hints(side, spec):
    """``spec``: [{res: [(bits or None, preferred)]} or None] as one
    package's provider hints."""
    th, mask_of = side["policy"].TopologyHint, side["policy"].mask_of
    out = []
    for provider in spec:
        if provider is None:
            out.append(None)
            continue
        out.append({res: [th(mask_of(b) if b is not None else None, p)
                          for b, p in hs] for res, hs in provider.items()})
    return out


def verdict(side, best, admit):
    bits = None if best.affinity is None \
        else side["policy"].mask_bits(best.affinity)
    return bits, best.preferred, admit


POLICY_CASES = {
    # tests/test_numaaware.py::TestPolicyMerge
    "single_provider_single_hint": ("PolicyBestEffort", [0, 1],
                                    [{"cpu": [([0], True)]}]),
    "two_resources_intersect": ("PolicyBestEffort", [0, 1],
                                [{"cpu": [([0, 1], True), ([0], True)],
                                  "gpu": [([0], True)]}]),
    "best_effort_admits_non_preferred": ("PolicyBestEffort", [0, 1],
                                         [{"cpu": [([0, 1], False)]}]),
    "restricted_rejects_non_preferred": ("PolicyRestricted", [0, 1],
                                         [{"cpu": [([0, 1], False)]}]),
    "restricted_admits_preferred": ("PolicyRestricted", [0, 1],
                                    [{"cpu": [([1], True)]}]),
    "single_numa_rejects_multi_node_hint": ("PolicySingleNumaNode", [0, 1],
                                            [{"cpu": [([0, 1], True)]}]),
    "single_numa_admits_single_node": ("PolicySingleNumaNode", [0, 1],
                                       [{"cpu": [([0, 1], True),
                                                 ([1], True)]}]),
    "no_opinion_provider_is_any_numa": ("PolicyRestricted", [0, 1], [None]),
    "empty_hint_list_is_unpreferred": ("PolicyRestricted", [0, 1],
                                       [{"cpu": []}]),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_case_matches_reference(case):
    cls, numa_nodes, spec = POLICY_CASES[case]
    ref, port = both(lambda s: verdict(s, *getattr(s["policy"], cls)(
        numa_nodes).predicate(hints(s, spec))))
    assert port == ref


def random_hint_spec(rng, n_numa):
    """Up to three providers of up to two resources, each a random list
    of (bits, preferred) hints, some providers with no opinion."""
    spec = []
    for _ in range(int(rng.integers(1, 4))):
        if rng.uniform() < 0.15:
            spec.append(None)
            continue
        provider = {}
        for res in ("cpu", "gpu")[:int(rng.integers(1, 3))]:
            n = int(rng.integers(0, 4))
            provider[res] = [
                (sorted(int(b) for b in rng.choice(
                    n_numa, int(rng.integers(1, n_numa + 1)),
                    replace=False)), bool(rng.uniform() < 0.6))
                for _ in range(n)]
        spec.append(provider)
    return spec


@pytest.mark.parametrize("seed", range(6))
def test_policies_on_seeded_hints_match_reference(seed):
    """Every policy on random hint sets over 2-4 NUMA nodes, and the
    merge of the filtered hints."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n_numa = int(rng.integers(2, 5))
        spec = random_hint_spec(rng, n_numa)
        for cls in ("PolicyNone", "PolicyBestEffort", "PolicyRestricted",
                    "PolicySingleNumaNode"):
            ref, port = both(lambda s: verdict(s, *getattr(s["policy"], cls)(
                list(range(n_numa))).predicate(hints(s, spec))))
            assert port == ref, (cls, spec)
        ref, port = both(lambda s: verdict(s, s["policy"].merge_filtered_hints(
            list(range(n_numa)),
            s["policy"].filter_providers_hints(hints(s, spec))), True))
        assert port == ref, spec


# -- the CPU manager --------------------------------------------------------

def make_detail(side, cpus_per_numa=4, numa_count=2, threads=2):
    """cpu ids laid out numa-major, ``threads`` cpus per core (as
    tests/test_numaaware.py:make_detail)."""
    detail = {}
    cpu_id = 0
    for numa in range(numa_count):
        for core in range(cpus_per_numa // threads):
            for _ in range(threads):
                detail[cpu_id] = side["obj"].CpuInfo(
                    numa_id=numa, socket_id=numa, core_id=core)
                cpu_id += 1
    return detail


def container(side, cpu, limits=True):
    req = {"cpu": cpu, "memory": "1Gi"}
    return side["obj"].Container(requests=dict(req),
                                 limits=dict(req) if limits else {})


def hint_list(side, hs):
    return sorted((side["policy"].mask_bits(h.affinity), h.preferred)
                  for h in hs)


CPU_CASES = {
    # tests/test_numaaware.py::TestCpuManager
    "take_whole_socket_first": lambda s: sorted(s["cpu"].take_by_topology(
        s["cpu"].CPUDetails(make_detail(s)), set(range(8)), 4)),
    "take_core_packing": lambda s: sorted(s["cpu"].take_by_topology(
        s["cpu"].CPUDetails(make_detail(s)), set(range(8)) - {0}, 2)),
    "guaranteed_cpus_integral_only": lambda s: [
        s["cpu"].guaranteed_cpus(s["obj"].Container(requests=r))
        for r in ({"cpu": "2"}, {"cpu": "1500m"}, {})],
    "hints_prefer_fewest_numa_nodes": lambda s: hint_list(
        s, s["cpu"].generate_cpu_topology_hints(
            set(range(8)), s["cpu"].CPUDetails(make_detail(s)), 2)),
    "hints_request_exceeding_single_node": lambda s: hint_list(
        s, s["cpu"].generate_cpu_topology_hints(
            set(range(8)), s["cpu"].CPUDetails(make_detail(s)), 6)),
}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_cpu_manager_case_matches_reference(case):
    ref, port = both(CPU_CASES[case])
    assert port == ref


def test_take_insufficient_raises_in_both():
    for side in SIDES.values():
        with pytest.raises(ValueError):
            side["cpu"].take_by_topology(
                side["cpu"].CPUDetails(make_detail(side)), {0, 1}, 3)


def test_allocate_aligns_to_hint_in_both():
    def run(s):
        topo = s["info"].NumatopoInfo("n1")
        topo.cpu_detail = make_detail(s)
        return sorted(s["cpu"].CpuManager().allocate(
            container(s, "2"),
            s["policy"].TopologyHint(s["policy"].mask_of([1]), True), topo,
            {"cpu": set(range(8))})["cpu"])
    ref, port = both(run)
    assert port == ref and set(ref) <= {4, 5, 6, 7} and len(ref) == 2


@pytest.mark.parametrize("seed", range(6))
def test_cpu_manager_on_seeded_topologies_matches_reference(seed):
    """Random topologies (2-4 NUMA nodes, 2-6 cores, 1-2 threads), random
    free sets and requests, a reserved CPU share: hints, the policies'
    verdicts over them and the aligned assignment, equal in both."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(20):
        numa_count = int(rng.integers(2, 5))
        threads = int(rng.integers(1, 3))
        per_numa = threads * int(rng.integers(2, 7))
        n_cpu = numa_count * per_numa
        free = {int(c) for c in rng.choice(
            n_cpu, int(rng.integers(1, n_cpu + 1)), replace=False)}
        want = int(rng.integers(1, per_numa + 2))
        reserved = float(rng.choice([0, 1000, 1500]))
        policy_name = str(rng.choice(["PolicyBestEffort", "PolicyRestricted",
                                      "PolicySingleNumaNode"]))

        def run(s):
            topo = s["info"].NumatopoInfo("n")
            topo.cpu_detail = make_detail(s, per_numa, numa_count, threads)
            topo.res_reserved = {"cpu": reserved} if reserved else {}
            mng = s["cpu"].CpuManager()
            c = container(s, str(want))
            hs = mng.get_topology_hints(c, topo, {"cpu": set(free)})
            best, admit = getattr(s["policy"], policy_name)(
                list(range(numa_count))).predicate([hs])
            assign = mng.allocate(c, best, topo, {"cpu": set(free)})
            return (hint_list(s, hs["cpu"]), verdict(s, best, admit),
                    sorted(assign["cpu"]))
        ref, port = both(run)
        assert port == ref


def test_is_guaranteed_in_both():
    def run(s):
        pod = guaranteed_pod(s, "ns", "p", "g")
        out = [s["numa"].is_guaranteed(pod)]
        pod.spec.containers[0].limits = {}
        out.append(s["numa"].is_guaranteed(pod))
        return out
    ref, port = both(run)
    assert port == ref == [True, False]


# -- the plugin through a session (tests/test_numaaware.py's integration) ----

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


def guaranteed_pod(side, ns, name, group, cpu="2", policy="", node="",
                   phase="Pending"):
    pod = side["tu"].build_pod(ns, name, node, phase,
                               {"cpu": cpu, "memory": "1Gi"}, group)
    c = pod.spec.containers[0]
    c.limits = dict(c.requests)
    if policy:
        pod.metadata.annotations["volcano.sh/numa-topology-policy"] = policy
    return pod


def numa_crd(side, node_name, cpus_per_numa=4, numa_count=2,
             tm_policy="single-numa-node"):
    detail = make_detail(side, cpus_per_numa, numa_count)
    o = side["obj"]
    return o.Numatopology(
        metadata=o.ObjectMeta(name=node_name),
        policies={"CPUManagerPolicy": "static",
                  "TopologyManagerPolicy": tm_policy},
        numa_res={"cpu": o.NumaResInfo(allocatable=sorted(detail),
                                       capacity=len(detail))},
        cpu_detail=detail)


def numa_sets(cache):
    """{node: sorted allocatable cpu ids} of the cache's NUMA views."""
    return {name: sorted(n.numa_scheduler_info.numa_res_map["cpu"]
                         .allocatable)
            for name, n in sorted(cache.nodes.items())
            if n.numa_scheduler_info is not None}


def integration(case):
    def run(s):
        tu = s["tu"]
        h = s["Harness"](CONF)
        h.add("queues", tu.build_queue("default"))
        if case == "single_numa_policy":
            h.add("nodes",
                  tu.build_node("small", {"cpu": "8", "memory": "16Gi"}),
                  tu.build_node("big", {"cpu": "16", "memory": "16Gi"}))
            h.add("numatopologies",
                  numa_crd(s, "small", cpus_per_numa=4, numa_count=2),
                  numa_crd(s, "big", cpus_per_numa=8, numa_count=2))
        else:
            h.add("nodes", tu.build_node("n1", {"cpu": "8",
                                                "memory": "16Gi"}))
            h.add("numatopologies", numa_crd(
                s, "n1", tm_policy="best-effort"
                if case == "policy_mismatch" else "single-numa-node"))
        h.add("podgroups", tu.build_pod_group("pg1", "ns1", "default", 1,
                                              phase="Inqueue"))
        if case == "burstable":
            h.add("pods", tu.build_pod("ns1", "p0", "", "Pending",
                                       {"cpu": "2", "memory": "1Gi"}, "pg1"))
        else:
            h.add("pods", guaranteed_pod(
                s, "ns1", "p0", "pg1",
                cpu="6" if case == "single_numa_policy" else "2",
                policy="single-numa-node"))
        h.run_actions("allocate").close_session()
        out = (dict(h.binder.binds), numa_sets(h.cache))
        h.cache.stop()
        return out
    return both(run)


@pytest.mark.parametrize("case,binds", [
    ("single_numa_policy", {"ns1/p0": "big"}),
    ("sets_pushed_back_on_close", {"ns1/p0": "n1"}),
    ("policy_mismatch", {}),
    ("burstable", {"ns1/p0": "n1"}),
])
def test_session_case_matches_reference(case, binds):
    ref, port = integration(case)
    assert port == ref
    assert ref[0] == binds
    if case == "sets_pushed_back_on_close":
        assert len(ref[1]["n1"]) == 6   # 2 cpus taken out of 8


# -- whole cycles with NUMA --------------------------------------------------

NUMA_TIERS = """
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
  - name: numa-aware
    arguments:
      weight: 2
"""


def numa_spec(seed, n_nodes=16, n_jobs=16, job_offset=0, guaranteed=2):
    """make_spec's cluster with integral CPU requests; every
    ``guaranteed``-th job's pods are Guaranteed (limits = requests) and
    carry the single-numa-node policy annotation."""
    spec = make_spec(seed, n_nodes=n_nodes, n_jobs=n_jobs, gang=(2, 5),
                     node_cpu=(8, 25), req_cpu_m=(1000, 4001),
                     job_offset=job_offset, node_offset=0)
    guaranteed_groups = {g["name"] for i, g in enumerate(spec["podgroups"])
                         if i % guaranteed == 0}
    for p in spec["pods"]:
        cpu = int(p["req"]["cpu"][:-1]) // 1000 * 1000 or 1000
        p["req"] = {"cpu": str(cpu // 1000), "memory": p["req"]["memory"]}
        p["guaranteed"] = p["group"] in guaranteed_groups
    return spec


def add_numa(side, store, spec, topology_policy="single-numa-node"):
    """A Numatopology for every node of ``spec`` (two NUMA nodes, two
    threads a core, as many CPUs as the node has), and the pods' limits
    and policy annotation."""
    for n in spec["nodes"]:
        shape = side["agent"].NumaShape(
            numa_count=2, cores_per_numa=max(1, int(n["cpu"]) // 4),
            threads_per_core=2, topology_manager_policy=topology_policy)
        store.create("numatopologies", side["agent"].build_numatopology(
            n["name"], shape))


def populate_numa(side, store, spec):
    populate(side["pkg"], store, spec)
    for p in spec["pods"]:
        if not p.get("guaranteed"):
            continue
        pod = store.get("pods", p["name"], p["ns"])
        c = pod.spec.containers[0]
        c.limits = dict(c.requests)
        pod.metadata.annotations["volcano.sh/numa-topology-policy"] = \
            "single-numa-node"
        store.update("pods", pod)


def numa_cycles(side, spec, conf_text, more=(), edits=None, **kw):
    """``cycles`` = 1 + len(more) cycles on ``side``'s Scheduler with the
    incremental default; ``more[c - 1]`` is added before cycle c and
    ``edits[c]`` (a fn(side, store)) runs before it. Returns per cycle
    the outcome, the cache's NUMA sets and the snapshot mode."""
    pkg = side["pkg"]
    store = pkg.Store(clock=side["Clock"](50_000.0))
    populate_numa(side, store, spec)
    add_numa(side, store, spec)
    cache = pkg.Cache(store, binder=pkg.tu.FakeBinder(store))
    cache.run()
    sched = pkg.Scheduler(store, scheduler_conf=conf_text, cache=cache,
                          **kw)
    out = []
    for c in range(1 + len(more)):
        if c:
            populate_numa(side, store, more[c - 1])
        if edits and c in edits:
            edits[c](side, store)
        sched.run_once()
        cache.flush_executors()
        out.append((outcome(store), numa_sets(cache),
                    getattr(sched, "last_cycle", {}).get("mode")))
    cache.stop()
    return out


def assert_cycles_equal(ref, port):
    for c, (r, p) in enumerate(zip(ref, port)):
        (rb, rp, rc), rn, _ = r
        (pb, pp, pc), pn, _ = p
        assert pb == rb, (c, sorted(set(pb.items()) ^ set(rb.items()))[:8])
        assert pp == rp and pc == rc, c
        assert pn == rn, (c, {k: (pn[k], rn.get(k)) for k in pn
                              if pn[k] != rn.get(k)})


@pytest.mark.parametrize("seed", [1, 2])
def test_numa_cycles_match_reference(seed):
    """Three incremental cycles, new gangs arriving before the second and
    third: binds, phases, conditions and every node's NUMA set equal
    after each; the Guaranteed gangs took CPU sets."""
    spec = numa_spec(seed)
    more = [numa_spec(seed + 10 * c, n_jobs=6, job_offset=100 * c)
            for c in (1, 2)]
    conf_text = 'actions: "enqueue, allocate, backfill"' + NUMA_TIERS
    ref = numa_cycles(SIDES["ref"], spec, conf_text, more)
    port = numa_cycles(SIDES["port"], spec, conf_text, more, device="cpu")
    assert_cycles_equal(ref, port)
    assert [m for _, _, m in port] == ["full", "incremental", "incremental"]
    total = {n["name"]: 2 * max(1, int(n["cpu"]) // 4) * 2
             for n in spec["nodes"]}
    taken = sum(total[k] - len(v) for k, v in port[-1][1].items())
    assert taken > 0 and ref[-1][0][0]


def test_numatopology_edit_forces_a_full_snapshot():
    """A Numatopology edit between cycles is structural: the next
    snapshot rebuilds in full in the port as in the reference, and a
    node whose topology narrows keeps the narrower set."""
    spec = numa_spec(7, n_nodes=12, n_jobs=10)
    more = [numa_spec(17, n_jobs=4, job_offset=100)]

    def shrink(side, store):
        nt = store.get("numatopologies", spec["nodes"][0]["name"])
        nt.numa_res["cpu"].allocatable = nt.numa_res["cpu"].allocatable[4:]
        store.update("numatopologies", nt)

    conf_text = 'actions: "enqueue, allocate, backfill"' + NUMA_TIERS
    ref = numa_cycles(SIDES["ref"], spec, conf_text, more, {1: shrink})
    port = numa_cycles(SIDES["port"], spec, conf_text, more, {1: shrink},
                       device="cpu")
    assert_cycles_equal(ref, port)
    assert [m for _, _, m in port] == ["full", "full"]
