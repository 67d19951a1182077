"""The placement-constraint layer of the port against the JAX package's:
the inter-pod index (plugins/interpod.py), the constraint compiler
(ops/constraints.py), the task-topology plugin and the solver's two
lowerings of topology domains.

Each side builds its own objects from one plain description (the
builders of tests/test_torch_cycle.py, or the small scenarios below after
tests/test_interpod.py and tests/test_task_topology.py) and opens its own
session on them; no object crosses between the packages. Tolerance:
exact. Masks, slot tensors and slot entries are compared cell for cell,
scores bit for bit (both sides run the same numpy float32 arithmetic),
binds pod for pod.
"""

import numpy as np
import pytest

import volcano_tpu.apiserver as ref_apiserver
import volcano_tpu.cache as ref_cache
import volcano_tpu.framework as ref_framework
import volcano_tpu.models.arrays as ref_arrays
import volcano_tpu.models.objects as ref_obj
import volcano_tpu.ops.constraints as ref_constraints
import volcano_tpu.plugins.interpod as ref_interpod
import volcano_tpu.plugins.task_topology as ref_topology
import volcano_tpu.utils.test_utils as ref_tu
from volcano_tpu.models.resource import Resource as RefResource
from volcano_tpu.scheduler import Scheduler as RefScheduler
import volcano_tpu_torch.apiserver as port_apiserver
import volcano_tpu_torch.cache as port_cache
import volcano_tpu_torch.framework as port_framework
import volcano_tpu_torch.models.arrays as port_arrays
import volcano_tpu_torch.models.objects as port_obj
import volcano_tpu_torch.ops.constraints as port_constraints
import volcano_tpu_torch.plugins.interpod as port_interpod
import volcano_tpu_torch.plugins.task_topology as port_topology
import volcano_tpu_torch.utils.test_utils as port_tu
from volcano_tpu_torch.models.resource import Resource as PortResource
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler
from tests.test_torch_cycle import (CONSTRAINED_CASES, HOSTNAME, PORT, REF,
                                    assert_same, conf, make_spec, populate)


class Side:
    """One package's modules, under the same names."""

    def __init__(self, apiserver, cache, framework, arrays, obj, constraints,
                 interpod, topology, tu, resource, scheduler, device):
        self.apiserver, self.cache, self.framework = apiserver, cache, \
            framework
        self.arrays, self.obj, self.constraints = arrays, obj, constraints
        self.interpod, self.topology, self.tu = interpod, topology, tu
        self.Resource, self.Scheduler = resource, scheduler
        self.kw = {} if device is None else {"device": device}

    def cycle(self, store, conf_text):
        """One Scheduler.run_once on the store, its binds written back;
        returns the scheduler."""
        cache = self.cache.SchedulerCache(store)
        cache.run()
        sched = self.Scheduler(store, scheduler_conf=conf_text, cache=cache,
                               **self.kw)
        sched.run_once()
        cache.flush_executors()
        cache.stop()
        return sched


SIDES = {
    "ref": Side(ref_apiserver, ref_cache, ref_framework, ref_arrays, ref_obj,
                ref_constraints, ref_interpod, ref_topology, ref_tu,
                RefResource, RefScheduler, None),
    "port": Side(port_apiserver, port_cache, port_framework, port_arrays,
                 port_obj, port_constraints, port_interpod, port_topology,
                 port_tu, PortResource, PortScheduler, "cpu"),
}


def bound(store):
    """{pod name: node} of the bound pods."""
    return {p.metadata.name: p.spec.node_name for p in store.list("pods")
            if p.spec.node_name}


INTERPOD_CONF = """
actions: "enqueue, allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: predicates
  - name: nodeorder
  - name: binpack
configurations:
- name: solver
  arguments: {kernel: scan, prune.enable: "off", mesh.enable: "false"}
"""


def open_session(side, store, conf_text):
    cache = side.cache.SchedulerCache(store)
    cache.run()
    # the session reads only its snapshot: no watch or executor after the
    # list (its close writes inline)
    cache.stop()
    c = side.framework.parse_scheduler_conf(conf_text)
    return side.framework.open_session(cache, c.tiers, c.configurations,
                                       **side.kw)


def pending(ssn):
    """The session's pending tasks, by uid."""
    return sorted((t for j in ssn.jobs.values() for t in j.tasks.values()
                   if not t.node_name), key=lambda t: t.uid)


# -- the inter-pod index: the scenarios of tests/test_interpod.py ---------------

def _term(o, key, value, topo=HOSTNAME):
    return o.PodAffinityTerm(
        label_selector=[o.NodeSelectorRequirement(key=key, operator="In",
                                                  values=[value])],
        topology_key=topo)


def _interpod_store(side, scenario):
    """The store of one scenario: three nodes n0..n2 (zones a, a, b for
    ``zone``), pod groups ``web``/``iso`` (running) and ``pg`` (inqueue),
    and the scenario's pods."""
    o, tu = side.obj, side.tu
    store = side.apiserver.ObjectStore()
    store.create("queues", tu.build_queue("default", weight=1))
    zones = ["a", "a", "b"]
    for i in range(3):
        labels = {HOSTNAME: f"n{i}"}
        if scenario == "zone":
            labels["zone"] = zones[i]
        store.create("nodes", tu.build_node(
            f"n{i}", {"cpu": "8", "memory": "16Gi"}, labels=labels))
    for name, phase in (("web", "Running"), ("iso", "Running"),
                        ("pg", "Inqueue")):
        store.create("podgroups", tu.build_pod_group(
            name, "ns1", "default", 1, phase=phase))
    rl = {"cpu": "1", "memory": "1Gi"}

    def pod(name, node, group, labels, required=(), anti=(), preferred=()):
        p = tu.build_pod("ns1", name, node, "Running" if node else "Pending",
                         rl, group, labels=labels)
        if required or anti or preferred:
            aff = o.Affinity()
            if required or preferred:
                aff.pod_affinity = o.PodAffinity(
                    required=list(required),
                    preferred=[o.WeightedPodAffinityTerm(weight=w, term=t)
                               for w, t in preferred])
            if anti:
                aff.pod_anti_affinity = o.PodAffinity(required=list(anti))
            p.spec.affinity = aff
        store.create("pods", p)

    web = {"app": "web"}
    backend = {"app": "backend"}
    if scenario == "colocate_hostname":
        pod("web-1", "n1", "web", web)
        pod("pending-1", "", "pg", backend,
            required=[_term(o, "app", "web")])
    elif scenario == "zone":
        pod("web-1", "n0", "web", web)
        pod("pending-1", "", "pg", backend,
            required=[_term(o, "app", "web", topo="zone")])
    elif scenario == "bootstrap_self_match":
        pod("pending-1", "", "pg", web, required=[_term(o, "app", "web")])
    elif scenario == "unsatisfiable":
        pod("pending-1", "", "pg", backend,
            required=[_term(o, "app", "web")])
    elif scenario == "anti":
        pod("web-1", "n0", "web", web)
        pod("web-2", "n2", "web", web)
        pod("pending-1", "", "pg", backend, anti=[_term(o, "app", "web")])
    elif scenario == "symmetry":
        pod("iso-1", "n1", "iso", {"app": "iso"},
            anti=[_term(o, "app", "backend")])
        pod("pending-1", "", "pg", backend)
    elif scenario in ("preferred", "batch_node_order"):
        node = "n2" if scenario == "preferred" else "n1"
        weight = 100 if scenario == "preferred" else 10
        pod("web-1", node, "web", web)
        pod("pending-1", "", "pg", backend,
            preferred=[(weight, _term(o, "app", "web"))])
    return store


# the reference test's expected binds of pending-1 (None: no bind)
INTERPOD = {"colocate_hostname": {"n1"}, "zone": {"n0", "n1"},
            "bootstrap_self_match": {"n0", "n1", "n2"},
            "unsatisfiable": None, "anti": {"n1"}, "symmetry": {"n0", "n2"},
            "preferred": {"n2"}, "batch_node_order": {"n1"}}


def _index_view(side, ssn):
    """(node names, the index's required anti-affinity terms, {task uid:
    (required mask, preference score, batch node order, has pod
    affinity)} over the session's pending tasks)."""
    names = [n.name for n in ssn.node_list]
    index = side.interpod.get_index(ssn, names)
    nodes = list(ssn.nodes.values())
    out = {}
    for t in pending(ssn):
        mask = index.required_mask(t)
        pref = index.preference_score(t)
        out[t.uid] = (None if mask is None else mask.tolist(),
                      None if pref is None else pref.tolist(),
                      ssn.batch_node_order_fn(t, nodes),
                      side.interpod.task_has_pod_affinity(t))
    return names, repr(index.anti_required), out


@pytest.mark.parametrize("scenario", sorted(INTERPOD))
def test_interpod_index_matches_reference(scenario):
    views = {}
    for name, side in SIDES.items():
        store = _interpod_store(side, scenario)
        ssn = open_session(side, store, INTERPOD_CONF)
        views[name] = _index_view(side, ssn)
        side.framework.close_session(ssn)
    assert views["port"] == views["ref"]
    _, _, tasks = views["port"]
    if scenario == "batch_node_order":
        scores = tasks["ns1-pending-1"][2]
        assert scores["n1"] > scores["n0"] and scores["n1"] > scores["n2"]
    # the cycle places pending-1 where the reference test expects, in
    # both packages
    binds = {}
    for name, side in SIDES.items():
        store = _interpod_store(side, scenario)
        side.cycle(store, INTERPOD_CONF)
        binds[name] = bound(store)
    assert binds["port"] == binds["ref"]
    want = INTERPOD[scenario]
    got = binds["port"].get("pending-1")
    assert (got is None) if want is None else (got in want), got


def test_interpod_index_on_random_pods_matches_reference():
    """tests/test_interpod.py's randomized index: 60 nodes, 400 placed pods
    in two namespaces, four terms; matching topologies and a preferred
    (anti-)affinity score equal the reference's."""
    rng = np.random.default_rng(7)
    nodes = [(f"n{i}", {"zone": f"z{i % 7}", "rack": f"r{i % 13}"})
             for i in range(60)]
    pods = []
    for p in range(400):
        ns = ["ns1", "ns2"][int(rng.integers(2))]
        labels = {"app": ["web", "db", "cache"][int(rng.integers(3))],
                  "tier": ["a", "b"][int(rng.integers(2))]}
        if rng.uniform() < 0.5:
            del labels["tier"]
        pods.append((ns, f"p{p}", f"n{int(rng.integers(60))}", labels))
    views = {}
    for name, side in SIDES.items():
        o, tu = side.obj, side.tu
        store = side.apiserver.ObjectStore()
        store.create("queues", tu.build_queue("default", weight=1))
        for n, labels in nodes:
            store.create("nodes", tu.build_node(
                n, {"cpu": "64", "memory": "128Gi"}, labels=labels))
        store.create("podgroups", tu.build_pod_group(
            "pg", "ns1", "default", 1, phase="Inqueue"))
        for ns, pname, node, labels in pods:
            store.create("pods", tu.build_pod(
                ns, pname, node, "Running", {"cpu": "1", "memory": "1Gi"},
                "pg" if ns == "ns1" else "", labels=labels))
        ssn = open_session(side, store, INTERPOD_CONF)
        names = [n.name for n in ssn.node_list]
        index = side.interpod.InterPodIndex(ssn, names)
        req = o.NodeSelectorRequirement
        terms = [
            o.PodAffinityTerm(label_selector=[req(
                key="app", operator="In", values=["web"])],
                topology_key="zone"),
            o.PodAffinityTerm(label_selector=[req(
                key="tier", operator="NotIn", values=["a"])],
                topology_key="rack", namespaces=["ns2"]),
            o.PodAffinityTerm(label_selector=[req(
                key="tier", operator="Exists")], topology_key="zone",
                namespaces=["ns1", "ns2"]),
            o.PodAffinityTerm(label_selector=[req(
                key="app", operator="DoesNotExist")], topology_key="rack")]
        probe = tu.build_pod("ns1", "probe", "", "Pending",
                             {"cpu": "1", "memory": "1Gi"}, "pg")
        probe.spec.affinity = o.Affinity(
            pod_affinity=o.PodAffinity(preferred=[
                o.WeightedPodAffinityTerm(weight=3, term=terms[0])]),
            pod_anti_affinity=o.PodAffinity(preferred=[
                o.WeightedPodAffinityTerm(weight=2, term=terms[1])]))

        class Task:
            namespace = "ns1"
            pod = probe
        views[name] = (names,
                       [sorted(index.matching_topologies(t, "ns1"))
                        for t in terms],
                       index.preference_score(Task()).tolist())
        side.framework.close_session(ssn)
    assert views["port"] == views["ref"]
    assert any(views["port"][1]) and any(views["port"][2])


def test_normalize_matches_reference():
    rng = np.random.default_rng(3)
    for raw in (rng.normal(size=17) * 40, np.zeros(5), np.full(4, 3.0),
                -np.abs(rng.normal(size=9))):
        for weight in (1.0, 2.5):
            np.testing.assert_array_equal(
                port_interpod.normalize(raw.copy(), weight),
                ref_interpod.normalize(raw.copy(), weight))


# -- the constraint compiler on a session's own batch ---------------------------

def _compiler_session(side, case, seed, compile_off=False, tieredpack=0):
    """A session on the description of ``CONSTRAINED_CASES[case]``, its
    pending jobs in uid order, and its node encode."""
    c = CONSTRAINED_CASES[case]
    spec = make_spec(seed, **c["kw"])
    store = side.apiserver.ObjectStore()
    populate(REF if side is SIDES["ref"] else PORT, store, spec)
    ssn = open_session(side, store, conf(compile_off=compile_off,
                                         tieredpack=tieredpack))
    ordered = []
    for uid in sorted(ssn.jobs):
        tasks = sorted((t for t in ssn.jobs[uid].tasks.values()
                        if not t.node_name), key=lambda t: t.uid)
        if tasks:
            ordered.append((ssn.jobs[uid], tasks))
    names = [n.name for n in ssn.node_list]
    narr = side.arrays.NodeArrays.build(ssn.nodes, names, ssn.solver.rindex)
    return ssn, ordered, narr


def _partition(batch):
    """The batch's grouping of its tasks, as sets of uids."""
    groups = {}
    for t, g in zip(batch.tasks, batch.task_group[:len(batch.tasks)]):
        groups.setdefault(int(g), set()).add(t.uid)
    return sorted(sorted(s) for s in groups.values())


def _arr(x):
    return None if x is None else np.asarray(x)


def _equal(a, b, ctx):
    if a is None or b is None:
        assert a is None and b is None, ctx
    else:
        np.testing.assert_array_equal(a, b, ctx)


@pytest.mark.parametrize("case", ["heavy_mix", "self_anti_one_per_zone",
                                  "running_pod_symmetry",
                                  "required_affinity_zone"])
def test_split_lowering_matches_reference(case):
    """Split lowering: assign_spread_slots' entries and derived groups,
    compile_mask and reference_mask, cell for cell; the port's compiled
    mask equals its own per-pair reference."""
    seed = sorted(CONSTRAINED_CASES).index(case) + 51
    got = {}
    for name, side in SIDES.items():
        ssn, ordered, narr = _compiler_session(side, case, seed)
        k = side.constraints
        override = k.assign_spread_slots(ssn, ordered, narr.names)
        batch = side.arrays.TaskBatch.build(ordered, ssn.solver.rindex,
                                            sig_override=override)
        got[name] = dict(
            slots=dict(getattr(ssn, "_constraint_slots", {})),
            overridden=sorted(override or ()),
            partition=_partition(batch),
            compiled=_arr(k.compile_mask(ssn, batch, narr)),
            reference=_arr(k.reference_mask(ssn, batch, narr)))
        side.framework.close_session(ssn)
    port, ref = got["port"], got["ref"]
    for key in ("slots", "overridden", "partition"):
        assert port[key] == ref[key], key
    _equal(port["compiled"], ref["compiled"], "compile_mask")
    _equal(port["reference"], ref["reference"], "reference_mask")
    _equal(port["compiled"], port["reference"], "port compiled vs reference")
    if case in ("heavy_mix", "self_anti_one_per_zone"):
        assert port["slots"] and port["overridden"]
        assert port["compiled"] is not None and not port["compiled"].all()


@pytest.mark.parametrize("case", ["heavy_mix", "self_anti_one_per_zone",
                                  "hard_spread"])
def test_slot_tensors_match_reference(case):
    """Tensor lowering: groups keep their base sigs, build_slot_tensors
    gives the same task_slot and slot rows, and compile_mask skips its
    group-wide slot rows (every task keeps its own domain)."""
    seed = sorted(CONSTRAINED_CASES).index(case) + 51
    got = {}
    for name, side in SIDES.items():
        ssn, ordered, narr = _compiler_session(side, case, seed)
        k = side.constraints
        assert k.assign_spread_slots(ssn, ordered, narr.names,
                                     split=False) is None
        n_slots = k.count_batch_slots(ssn, ordered)
        batch = side.arrays.TaskBatch.build(ordered, ssn.solver.rindex)
        task_slot, rows = k.build_slot_tensors(ssn, batch, narr)
        batch.task_slot, batch.slot_rows = task_slot, rows
        got[name] = dict(n_slots=n_slots, task_slot=task_slot, rows=rows,
                         real=len(batch.tasks), partition=_partition(batch),
                         compiled=_arr(k.compile_mask(ssn, batch, narr)),
                         reference=_arr(k.reference_mask(ssn, batch, narr)))
        side.framework.close_session(ssn)
    port, ref = got["port"], got["ref"]
    assert port["n_slots"] == ref["n_slots"] > 0
    assert port["partition"] == ref["partition"]
    for key in ("task_slot", "rows", "compiled", "reference"):
        _equal(port[key], ref[key], key)
    _equal(port["compiled"], port["reference"], "port compiled vs reference")
    rows, task_slot = port["rows"], port["task_slot"]
    assert rows.shape[0] == port["n_slots"] + 1 and rows[-1].all()
    # padding tasks carry the all-true row S
    assert (task_slot[port["real"]:] == port["n_slots"]).all()


@pytest.mark.parametrize("case,weights", [
    ("soft_spread", dict(spread_weight=10.0)),
    ("soft_spread", dict(spread_weight=3.0, tiered_weight=1.0)),
    ("tieredpack", dict(tiered_weight=2.0, spread_weight=0.0)),
    ("tieredpack", dict(tiered_weight=0.5, spread_weight=10.0)),
])
def test_compile_score_matches_reference(case, weights):
    """Soft topology spread and priority-tiered packing scores, bit for
    bit."""
    seed = sorted(CONSTRAINED_CASES).index(case) + 51
    got = {}
    for name, side in SIDES.items():
        ssn, ordered, narr = _compiler_session(side, case, seed)
        batch = side.arrays.TaskBatch.build(ordered, ssn.solver.rindex)
        got[name] = _arr(side.constraints.compile_score(ssn, batch, narr,
                                                        **weights))
        side.framework.close_session(ssn)
    assert got["port"] is not None and got["port"].any()
    np.testing.assert_array_equal(got["port"], got["ref"])


def test_slot_cap_overflow_goes_to_split_mode():
    """More distinct slot entries than SLOT_CAP (one gang of 72 replicas,
    one a host by self-anti-affinity over 80 hosts, so 72 slots): the
    place path lowers by split groups and hands the kernel no slots; the
    binds equal the reference's, one replica a host."""
    assert port_constraints.SLOT_CAP == ref_constraints.SLOT_CAP == 64

    def build(side):
        o, tu = side.obj, side.tu
        store = side.apiserver.ObjectStore()
        store.create("queues", tu.build_queue("default", weight=1))
        for i in range(80):
            store.create("nodes", tu.build_node(
                f"n{i:02d}", {"cpu": "8", "memory": "16Gi"},
                labels={HOSTNAME: f"n{i:02d}"}))
        store.create("podgroups", tu.build_pod_group(
            "pg", "ns1", "default", 72, phase="Inqueue"))
        for t in range(72):
            p = tu.build_pod("ns1", f"t{t}", "", "Pending",
                             {"cpu": "1", "memory": "1Gi"}, "pg",
                             labels={"job": "pg"})
            p.spec.affinity = o.Affinity(pod_anti_affinity=o.PodAffinity(
                required=[_term(o, "job", "pg")]))
            store.create("pods", p)
        return store

    binds, places = {}, None
    for name, side in SIDES.items():
        store = build(side)
        sched = side.cycle(store, INTERPOD_CONF)
        binds[name] = bound(store)
        if name == "port":
            places = sched.last_cycle["places"]
    assert binds["port"] == binds["ref"] and len(binds["port"]) == 72
    assert len(set(binds["port"].values())) == 72
    assert places and all(pl["slots"] == 0 for pl in places)
    # the tensor lowering would have needed 72 slot rows
    ssn = open_session(SIDES["port"], build(SIDES["port"]), INTERPOD_CONF)
    ordered = [(j, pending(ssn)) for j in ssn.jobs.values()]
    port_constraints.assign_spread_slots(
        ssn, ordered, [n.name for n in ssn.node_list], split=False)
    assert port_constraints.count_batch_slots(ssn, ordered) == 72
    port_framework.close_session(ssn)


def test_lowering_choice_in_the_solver():
    """BatchSolver's place path takes the tensor lowering (base groups,
    per-task slots) and host contexts the split lowering (derived groups
    through the selector pairs); both restrict each task to the same
    nodes."""
    case = "heavy_mix"
    seed = sorted(CONSTRAINED_CASES).index(case) + 51
    ssn, ordered, narr = _compiler_session(SIDES["port"], case, seed)
    solver = ssn.solver
    _, batch, dense = solver._context(ordered, solver.device,
                                      slot_tensors=True)
    assert batch.task_slot is not None and "task_slot" in dense.arrays
    mask = dense.static_mask().numpy()
    ts, rows = batch.task_slot, batch.slot_rows
    tensor_ok = np.stack([mask[batch.task_group[i]] & rows[ts[i]]
                          for i in range(len(batch.tasks))])
    ssn2, ordered2, _ = _compiler_session(SIDES["port"], case, seed)
    _, batch2, dense2 = ssn2.solver._context(ordered2, ssn2.solver.device)
    assert batch2.task_slot is None and "task_slot" not in dense2.arrays
    assert batch2.n_groups > batch.n_groups
    mask2 = dense2.static_mask().numpy()
    order2 = {t.uid: i for i, t in enumerate(batch2.tasks)}
    split_ok = np.stack([mask2[batch2.task_group[order2[t.uid]]]
                         for t in batch.tasks])
    np.testing.assert_array_equal(tensor_ok, split_ok)
    for s in (ssn, ssn2):
        port_framework.close_session(s)


# -- task topology: tests/test_task_topology.py's cases -------------------------

def test_parse_affinity_annotation_matches_reference():
    valid = {"ps", "worker", "chief"}
    for raw in ("ps,worker;chief", "ps,unknown", "ps,ps", None, "",
                "chief", "worker;ps,chief"):
        assert port_topology.parse_affinity_annotation(raw, valid) == \
            ref_topology.parse_affinity_annotation(raw, valid), raw


def _stub_tasks(side):
    """The stand-in tasks of tests/test_task_topology.py, and a chief."""
    class T:
        def __init__(self, uid, name, task_name):
            self.uid, self.name, self.node_name = uid, name, ""
            self.resreq = side.Resource(1000, 1 << 30)
            self.pod = side.obj.Pod(metadata=side.obj.ObjectMeta(
                name=name, annotations={side.obj.TASK_SPEC_KEY: task_name}))
    return {t.uid: t for t in (T("u1", "ps-0", "ps"), T("u2", "ps-1", "ps"),
                               T("u3", "w-0", "worker"),
                               T("u4", "c-0", "chief"))}


@pytest.mark.parametrize("affinity,anti,order", [
    ([["ps", "worker"]], [["ps"]], None),
    ([["ps", "worker", "chief"]], None, ["chief", "ps", "worker"]),
    (None, [["ps"], ["worker", "chief"]], None),
])
def test_task_topology_buckets_match_reference(affinity, anti, order):
    """Bucket construction: affinity groups merge into one bucket and
    anti-affinity splits, as in the reference."""
    got = {}
    for name, side in SIDES.items():
        jm = side.topology.JobManager("job1")
        jm.apply_task_topology(affinity, anti, order)
        jm.construct_buckets(_stub_tasks(side))
        got[name] = (len(jm.buckets), dict(jm.pod_in_bucket),
                     jm.bucket_max_size)
    assert got["port"] == got["ref"]
    if anti == [["ps"]]:
        assert got["port"][0] == 2
        assert got["port"][1]["u1"] != got["port"][1]["u2"]


TOPOLOGY_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: gang
  - name: task-topology
    arguments:
      task-topology.weight: 10
- plugins:
  - name: predicates
  - name: nodeorder
configurations:
- name: solver
  arguments: {kernel: scan, prune.enable: "off", mesh.enable: "false"}
"""


@pytest.mark.parametrize("kind", ["affinity", "anti_affinity"])
def test_task_topology_cycle_matches_reference(kind):
    """tests/test_task_topology.py's two cycles: ps/worker affinity packs
    the gang onto one node, ps self-anti-affinity spreads it; binds equal
    the reference's, and the node scores of the plugin agree."""
    binds, scores = {}, {}
    for name, side in SIDES.items():
        tu = side.tu
        store = side.apiserver.ObjectStore()
        store.create("queues", tu.build_queue("q1"))
        pg = tu.build_pod_group("pg1", "c1", "q1",
                                4 if kind == "affinity" else 2,
                                phase="Inqueue")
        key = side.topology.AFFINITY_ANNOTATION if kind == "affinity" \
            else side.topology.ANTI_AFFINITY_ANNOTATION
        pg.metadata.annotations[key] = "ps,worker" if kind == "affinity" \
            else "ps"
        store.create("podgroups", pg)
        for n in ("n1", "n2"):
            store.create("nodes", tu.build_node(
                n, {"cpu": "8", "memory": "8Gi"}))
        names = ["ps-0", "ps-1"] + (["worker-0", "worker-1"]
                                    if kind == "affinity" else [])
        for p in names:
            store.create("pods", tu.build_pod(
                "c1", p, "", "Pending", {"cpu": "1", "memory": "1Gi"}, "pg1",
                task_name=p.split("-")[0]))
        ssn = open_session(side, store, TOPOLOGY_CONF)
        plugin = ssn.plugins["task-topology"]
        scores[name] = {(t.name, n.name): plugin.node_order_fn(t, n)
                        for t in pending(ssn) for n in ssn.nodes.values()}
        side.framework.close_session(ssn)
        side.cycle(store, TOPOLOGY_CONF)
        binds[name] = bound(store)
    assert scores["port"] == scores["ref"]
    assert binds["port"] == binds["ref"] and len(binds["port"]) == len(names)
    assert len(set(binds["port"].values())) == \
        (1 if kind == "affinity" else 2)


def test_task_topology_buckets_reach_the_kernel():
    """The plugin's bucket fn fills the kernel's task_bucket and
    group_pack_bonus (they were -1 and 0 without it)."""
    c = CONSTRAINED_CASES["task_topology"]
    spec = make_spec(71, **c["kw"])
    store = port_apiserver.ObjectStore()
    populate(PORT, store, spec)
    ssn = open_session(SIDES["port"], store, conf(task_topology=True))
    ordered = [(j, sorted(j.tasks.values(), key=lambda t: t.uid))
               for _, j in sorted(ssn.jobs.items())]
    _, batch, dense = ssn.solver._context(ordered, ssn.solver.device)
    bucket = dense.arrays["task_bucket"].numpy()
    bonus = dense.arrays["group_pack_bonus"].numpy()
    assert (bucket >= 0).any() and (bonus > 0).any()
    real = len(batch.tasks)
    assert (bucket[real:] == -1).all()
    port_framework.close_session(ssn)


def test_constrained_cycle_with_more_slots_than_the_cap_is_exact(
        monkeypatch):
    """The self-anti case with SLOT_CAP lowered below its slot count binds
    what the reference binds (the split mode is a lowering, not a
    different answer)."""
    spec = make_spec(57, **CONSTRAINED_CASES["self_anti_one_per_zone"]["kw"])
    monkeypatch.setattr(port_constraints, "SLOT_CAP", 1)
    assert_same(spec, conf())
