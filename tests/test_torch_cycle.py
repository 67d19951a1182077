"""The scheduling cycle through the objects: the port's
``Scheduler(store, device="cpu").run_once()`` against the JAX package's
``volcano_tpu.scheduler.Scheduler`` on the same objects.

Each side gets its own ObjectStore, filled by its own builders
(``utils/test_utils.py``) from one plain description made with numpy from
a seed; no object crosses between the packages. The reference runs with
the solver pinned to its XLA scan (``kernel: scan``, pruning and the mesh
off), which tests/test_torch_allocate.py holds equal to the port's plain
loop; one case runs the reference's default conf, the one users run.

Tolerance: exact. The binds (pod -> node, read back from the store), the
PodGroup phases and their conditions (type, status, reason, message) must
be equal after close.
"""

import numpy as np
import pytest

from volcano_tpu.apiserver import ObjectStore as RefStore
from volcano_tpu.cache import SchedulerCache as RefCache
from volcano_tpu.models import objects as ref_obj
from volcano_tpu.scheduler import Scheduler as RefScheduler
from volcano_tpu.utils import synth as ref_synth
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu_torch.apiserver import ObjectStore as PortStore
from volcano_tpu_torch.cache import SchedulerCache as PortCache
from volcano_tpu_torch.models import objects as port_obj
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler
from volcano_tpu_torch.utils import synth as port_synth
from volcano_tpu_torch.utils import test_utils as port_tu


class Pkg:
    def __init__(self, store, cache, scheduler, obj, tu, synth):
        self.Store, self.Cache, self.Scheduler = store, cache, scheduler
        self.obj, self.tu, self.synth = obj, tu, synth


REF = Pkg(RefStore, RefCache, RefScheduler, ref_obj, ref_tu, ref_synth)
PORT = Pkg(PortStore, PortCache, PortScheduler, port_obj, port_tu,
           port_synth)

TIERS = """
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf{drf}
  - name: predicates
  - name: proportion
  - name: nodeorder{extra}
"""
ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
AFFINITY_ANNOTATION = "volcano.sh/task-topology-affinity"
ANTI_AFFINITY_ANNOTATION = "volcano.sh/task-topology-anti-affinity"
PIN = """
configurations:
- name: solver
  arguments: {kernel: scan, prune.enable: "off", mesh.enable: "false"}
"""


def conf(actions="enqueue, allocate, backfill", binpack=False,
         ns_order=False, pin=True, compile_off=False, tieredpack=0,
         task_topology=False):
    """The scheduler conf of a case: ``compile_off`` sets the solver's
    ``constraints.compile: off``, ``tieredpack`` the priority plugin's
    ``tieredpack.weight``, ``task_topology`` adds that plugin (weight 10)."""
    extra = "\n  - name: binpack" if binpack else ""
    if task_topology:
        extra += ("\n  - name: task-topology\n    arguments:\n"
                  "      task-topology.weight: 10")
    text = f'actions: "{actions}"' + TIERS.format(
        drf="\n    enableNamespaceOrder: true" if ns_order else "",
        extra=extra)
    if tieredpack:
        text = text.replace("  - name: priority\n",
                            "  - name: priority\n    arguments:\n"
                            f"      tieredpack.weight: {tieredpack}\n")
    pin_text = PIN
    if compile_off:
        pin_text = PIN.replace('mesh.enable: "false"}',
                               'mesh.enable: "false", '
                               'constraints.compile: "off"}')
    return text + (pin_text if pin else "")


# -- the cluster description --------------------------------------------------

def make_spec(seed, *, n_nodes=32, n_jobs=24, gang=(2, 8), queues=None,
              namespaces=("default",), node_cpu=(8, 33), node_mem_gi=(16, 65),
              req_cpu_m=(500, 4001), req_mem_mi=(512, 8193), surplus=0.0,
              selectors=False, taints=False, running=0, pending_pg=0,
              best_effort=0, priorities=False, not_ready=0, releasing=0,
              job_offset=0, node_offset=0, zones=0, spread_every=0,
              soft_every=0, anti_every=0, web_running=False,
              pod_affinity=None, symmetry=False, topology_every=0):
    """A plain description of a cluster (lists of tuples and dicts),
    drawn with numpy from ``seed``; ``populate`` turns it into objects.

    Placement constraints, none by default (no option draws from the
    rng): ``zones`` labels node i with the zone key (zone-<i % zones>)
    and the hostname key; every ``spread_every``-th job spreads hard over
    the zones (max_skew 1), every ``soft_every``-th (offset 1) softly,
    every ``anti_every``-th (offset 2) places one replica per zone by
    required self-anti-affinity; ``web_running`` labels running pods
    app=web, and ``pod_affinity`` = (kind, topology key, every) gives
    every ``every``-th pending job a term on app=web (kind: "req",
    "anti", "pref" or "anti_pref"); ``symmetry`` gives running pods a
    required anti-affinity to app=backend by hostname, which every other
    pending job's pods carry; every ``topology_every``-th job has ps and
    worker tasks under task-topology annotations (affinity "ps,worker"
    and anti-affinity "ps", alternating)."""
    rng = np.random.default_rng(seed)
    queues = queues or [("default", 1, None)]
    spec = {"queues": [] if job_offset else list(queues), "quotas": [],
            "priority_classes": [], "nodes": [], "podgroups": [], "pods": []}
    if not job_offset:
        for i, ns in enumerate(namespaces):
            if len(namespaces) > 1:
                spec["quotas"].append((ns, [1, 2, 4][i % 3]))
        if priorities:
            spec["priority_classes"] = [("high", 100), ("low", 1)]
    ts = 1000.0 * (job_offset + 1)
    for i in range(n_nodes if not job_offset else 0):
        name = f"node-{node_offset + i:03d}"
        labels = {"rack": f"rack-{i % 4}", "zone": f"z{i % 3}"}
        if zones:
            labels.update({ZONE: f"zone-{i % zones}", HOSTNAME: name})
        node_taints = []
        if taints and i % 5 == 0:
            node_taints.append(("dedicated", "gpu", "NoSchedule"))
        if taints and i % 7 == 3:
            node_taints.append(("spot", "true", "PreferNoSchedule"))
        spec["nodes"].append(dict(
            name=name, labels=labels, taints=node_taints,
            cpu=str(int(rng.integers(*node_cpu))),
            mem=f"{int(rng.integers(*node_mem_gi))}Gi",
            ready=not (not_ready and i % not_ready == not_ready - 1)))
    node_names = [n["name"] for n in spec["nodes"]]
    # room left on each ready node for the pods placed here already
    room = {n["name"]: [int(n["cpu"]) * 1000, int(n["mem"][:-2]) * 1024]
            for n in spec["nodes"] if n["ready"]}
    for j in range(n_jobs):
        jid = job_offset + j
        ns = namespaces[j % len(namespaces)]
        q = queues[j % len(queues)][0]
        size = int(rng.integers(gang[0], gang[1] + 1))
        min_member = size
        n_pods = size + (int(rng.integers(1, 3)) if rng.uniform() < surplus
                         else 0)
        phase = "Inqueue"
        min_res = None
        if pending_pg and j % pending_pg == 0:
            phase = "Pending"
            min_res = {"cpu": str(size), "memory": f"{size}Gi"}
        is_running = running and j % running == 1
        # every ``releasing``-th running job is being deleted: its pods
        # are Releasing, capacity that later gangs may pipeline onto
        is_releasing = is_running and releasing and j % releasing == 1
        if is_running:
            phase = "Running"
        pc = ""
        if priorities:
            pc = ["high", "low", ""][j % 3]
        cpu_m = int(rng.integers(*req_cpu_m))
        mem_mi = int(rng.integers(*req_mem_mi))
        be = best_effort and j % best_effort == 2
        selector = {}
        tolerations = []
        if selectors and j % 4 == 1:
            selector = {"zone": f"z{j % 3}"}
        if taints and j % 3 == 0:
            tolerations.append(("dedicated", "Equal", "gpu", "NoSchedule"))
        if taints and j % 6 == 1:
            tolerations.append(("spot", "Exists", "", ""))
        pg_name = f"pg-{jid}"
        # placement constraints of the job's pods
        spread, aff, labels, pg_ann = [], [], {}, {}
        if spread_every and j % spread_every == 0:
            spread.append((ZONE, 1, "DoNotSchedule"))
        if soft_every and j % soft_every == 1 % soft_every:
            spread.append((ZONE, 1, "ScheduleAnyway"))
        if anti_every and j % anti_every == 2 % anti_every:
            labels["job-group"] = pg_name
            aff.append(("anti", "job-group", pg_name, ZONE, 0))
        if is_running and web_running:
            labels["app"] = "web"
        if pod_affinity and not is_running and \
                j % pod_affinity[2] == 0:
            kind, key = pod_affinity[:2]
            aff.append((kind, "app", "web", key, 1 + j % 3))
        if symmetry:
            if is_running:
                labels["app"] = "iso"
                aff.append(("anti", "app", "backend", HOSTNAME, 0))
            elif j % 2 == 0:
                labels["app"] = "backend"
        topo = topology_every and j % topology_every == 0
        if topo:
            pg_ann = ({AFFINITY_ANNOTATION: "ps,worker"}
                      if (j // topology_every) % 2 == 0
                      else {ANTI_AFFINITY_ANNOTATION: "ps"})
        spec["podgroups"].append(dict(
            name=pg_name, ns=ns, queue=q, min_member=min_member, phase=phase,
            min_res=min_res, pc=pc, ts=ts + j, annotations=pg_ann))
        for t in range(n_pods):
            node = ""
            pod_phase = "Pending"
            # a few odd-sized tasks split a gang into two groups
            c = cpu_m * (2 if t == n_pods - 1 and size > 3 else 1)
            req = {} if be else {"cpu": f"{c}m", "memory": f"{mem_mi}Mi"}
            if is_running and t < min_member:
                fits = [n for n in node_names if n in room
                        and room[n][0] >= c and room[n][1] >= mem_mi]
                if fits:
                    node = fits[int(rng.integers(len(fits)))]
                    room[node][0] -= c
                    room[node][1] -= mem_mi
                    pod_phase = "Running"
            spec["pods"].append(dict(
                ns=ns, name=f"job{jid}-task{t}", node=node, phase=pod_phase,
                req=req, group=pg_name, selector=selector,
                tolerations=tolerations,
                priority=[100, 1, None][j % 3] if priorities else None,
                ts=ts + j, deleting=bool(is_releasing and node),
                labels=dict(labels), spread=spread, aff=aff,
                task=("ps" if t % 2 == 0 else "worker") if topo else ""))
    return spec


def _constraints(o, p):
    """The pod's topology spread and pod (anti-)affinity objects, in
    package ``o``'s classes, from the description's tuples."""
    spread = [o.TopologySpreadConstraint(max_skew=skew, topology_key=key,
                                         when_unsatisfiable=mode)
              for key, skew, mode in p.get("spread", ())]
    if not p.get("aff"):
        return spread, None
    parts = {"req": [], "anti": [], "pref": [], "anti_pref": []}
    for kind, key, value, topology, weight in p["aff"]:
        term = o.PodAffinityTerm(
            label_selector=[o.NodeSelectorRequirement(
                key=key, operator="In", values=[value])],
            topology_key=topology)
        parts[kind].append(o.WeightedPodAffinityTerm(weight=weight, term=term)
                           if kind.endswith("pref") else term)
    aff = o.Affinity()
    if parts["req"] or parts["pref"]:
        aff.pod_affinity = o.PodAffinity(required=parts["req"],
                                         preferred=parts["pref"])
    if parts["anti"] or parts["anti_pref"]:
        aff.pod_anti_affinity = o.PodAffinity(required=parts["anti"],
                                              preferred=parts["anti_pref"])
    return spread, aff


def populate(pkg, store, spec):
    tu, o = pkg.tu, pkg.obj
    for name, weight, cap in spec["queues"]:
        q = tu.build_queue(name, weight=weight, capability=cap)
        q.metadata.creation_timestamp = 1.0
        store.create("queues", q)
    for ns, weight in spec["quotas"]:
        store.create("resourcequotas", o.ResourceQuota(
            metadata=o.ObjectMeta(name=f"weight-{ns}", namespace=ns),
            hard={"namespace.weight": str(weight)}))
    for name, value in spec["priority_classes"]:
        store.create("priorityclasses", o.PriorityClass(
            metadata=o.ObjectMeta(name=name), value=value))
    for n in spec["nodes"]:
        node = tu.build_node(n["name"], {"cpu": n["cpu"], "memory": n["mem"],
                                         "pods": "110"}, labels=n["labels"])
        node.spec.taints = [o.Taint(key=k, value=v, effect=e)
                            for k, v, e in n["taints"]]
        node.status.ready = n["ready"]
        node.metadata.creation_timestamp = 1.0
        store.create("nodes", node)
    for g in spec["podgroups"]:
        pg = tu.build_pod_group(g["name"], g["ns"], g["queue"],
                                g["min_member"], phase=g["phase"],
                                priority_class=g["pc"])
        pg.spec.min_resources = g["min_res"]
        pg.metadata.creation_timestamp = g["ts"]
        pg.metadata.uid = f"{g['ns']}-{g['name']}"
        pg.metadata.annotations.update(g.get("annotations", {}))
        store.create("podgroups", pg)
    for p in spec["pods"]:
        pod = tu.build_pod(p["ns"], p["name"], p["node"], p["phase"],
                           p["req"], groupname=p["group"],
                           selector=p["selector"], priority=p["priority"],
                           labels=p.get("labels"),
                           task_name=p.get("task", ""))
        pod.spec.tolerations = [
            o.Toleration(key=k, operator=op, value=v, effect=e)
            for k, op, v, e in p["tolerations"]]
        pod.spec.topology_spread, pod.spec.affinity = _constraints(o, p)
        pod.metadata.creation_timestamp = p["ts"]
        if p.get("deleting"):
            pod.metadata.deletion_timestamp = p["ts"] + 1.0
        store.create("pods", pod)


def outcome(store):
    """(binds, PodGroup phases, PodGroup conditions) as read from the
    store."""
    binds = {f"{p.metadata.namespace}/{p.metadata.name}": p.spec.node_name
             for p in store.list("pods") if p.spec.node_name}
    pgs = {f"{g.metadata.namespace}/{g.metadata.name}": g
           for g in store.list("podgroups")}
    phases = {k: g.status.phase for k, g in pgs.items()}
    conds = {k: sorted((c.type, c.status, c.reason, c.message)
                       for c in g.status.conditions)
             for k, g in pgs.items()}
    return binds, phases, conds


def run(pkg, spec, conf_text, cycles=1, more=None, **kw):
    """Build ``pkg``'s store from ``spec``, run ``cycles`` cycles (adding
    ``more``, a list of specs, before each later cycle) and return the
    outcome after each cycle."""
    store = pkg.Store()
    populate(pkg, store, spec)
    cache = pkg.Cache(store, binder=pkg.tu.FakeBinder(store))
    cache.run()
    sched = pkg.Scheduler(store, scheduler_conf=conf_text, cache=cache,
                          **kw)
    out = []
    for c in range(cycles):
        if c and more:
            populate(pkg, store, more[c - 1])
        sched.run_once()
        cache.flush_executors()
        out.append(outcome(store))
    cache.stop()
    return out


def assert_same(spec, conf_text, cycles=1, more=None, expect_binds=True):
    ref = run(REF, spec, conf_text, cycles, more)
    port = run(PORT, spec, conf_text, cycles, more, device="cpu")
    for c, ((rb, rp, rc), (pb, pp, pc)) in enumerate(zip(ref, port)):
        assert pb == rb, (c, sorted(set(pb.items()) ^ set(rb.items()))[:10])
        assert pp == rp, (c, {k: (pp[k], rp.get(k)) for k in pp
                              if pp[k] != rp.get(k)})
        assert pc == rc, (c, {k: (pc[k], rc.get(k)) for k in pc
                              if pc[k] != rc.get(k)})
    if expect_binds:
        assert ref[-1][0], "the case placed nothing"
    return ref


# -- cases ----------------------------------------------------------------------

FOUR_QUEUES = [("q0", 1, None), ("q1", 2, None), ("q2", 4, None),
               ("q3", 1, {"cpu": "40", "memory": "80Gi"})]
THREE_NS = ("ns-a", "ns-b", "ns-c")

CASES = {
    "one_queue": dict(kw=dict(n_nodes=16), conf=dict()),
    "one_queue_binpack": dict(kw=dict(n_nodes=16, surplus=0.5),
                              conf=dict(binpack=True)),
    "four_queues_three_ns": dict(
        kw=dict(queues=FOUR_QUEUES, namespaces=THREE_NS, n_jobs=32),
        conf=dict()),
    "four_queues_ns_order": dict(
        kw=dict(queues=FOUR_QUEUES, namespaces=THREE_NS, n_jobs=32),
        conf=dict(ns_order=True)),
    "tight_capacity": dict(
        kw=dict(n_nodes=16, n_jobs=30, node_cpu=(4, 9), node_mem_gi=(8, 17),
                req_cpu_m=(1000, 3001), gang=(3, 8)),
        conf=dict()),
    "selectors_and_taints": dict(
        kw=dict(selectors=True, taints=True, n_nodes=16, n_jobs=28),
        conf=dict()),
    "running_and_surplus": dict(
        kw=dict(running=3, surplus=0.6, n_nodes=16, n_jobs=28),
        conf=dict()),
    "releasing_pipelined": dict(
        kw=dict(running=2, releasing=2, n_nodes=12, n_jobs=26,
                node_cpu=(6, 13), gang=(2, 6)),
        conf=dict()),
    "enqueue_pending": dict(
        kw=dict(pending_pg=3, queues=[("q0", 1, None),
                                      ("q1", 1, {"cpu": "24",
                                                 "memory": "48Gi"})]),
        conf=dict()),
    "backfill_best_effort": dict(kw=dict(best_effort=4, n_nodes=16),
                                 conf=dict()),
    "priorities_not_ready": dict(
        kw=dict(priorities=True, not_ready=6, n_nodes=18, n_jobs=28),
        conf=dict()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cycle_matches_reference(case):
    c = CASES[case]
    seed = sorted(CASES).index(case) + 11
    assert_same(make_spec(seed, **c["kw"]), conf(**c["conf"]))


def test_tight_capacity_rolls_back_with_unschedulable_condition():
    """Some gangs must roll back: their PodGroups carry the Unschedulable
    condition in both packages, with the same message."""
    spec = make_spec(5, **CASES["tight_capacity"]["kw"])
    (binds, phases, conds), = assert_same(spec, conf())
    unsched = [k for k, cs in conds.items()
               if any(t == "Unschedulable" and s == "True" for t, s, _, _ in cs)]
    assert unsched and len(unsched) < len(phases)
    for k in unsched:
        assert not any(b.startswith(k.split("/")[0] + "/job" +
                                    k.split("-")[-1] + "-")
                       for b in binds)


def test_enqueue_moves_pending_podgroups_to_inqueue():
    spec = make_spec(7, **CASES["enqueue_pending"]["kw"])
    (_, phases, _), = assert_same(spec, conf())
    pending_before = {f"{g['ns']}/{g['name']}" for g in spec["podgroups"]
                      if g["phase"] == "Pending"}
    assert pending_before
    assert any(phases[k] != "Pending" for k in pending_before)


def test_backfill_places_best_effort_pods():
    spec = make_spec(9, **CASES["backfill_best_effort"]["kw"])
    (binds, _, _), = assert_same(spec, conf())
    be = {f"{p['ns']}/{p['name']}" for p in spec["pods"] if not p["req"]}
    assert be and be <= set(binds)


def test_two_consecutive_cycles_with_new_jobs_between():
    first = make_spec(21, n_jobs=16, queues=FOUR_QUEUES, namespaces=THREE_NS)
    later = make_spec(22, n_jobs=14, queues=FOUR_QUEUES, namespaces=THREE_NS,
                      job_offset=100)
    out = assert_same(first, conf(), cycles=2, more=[later])
    assert len(out[1][0]) > len(out[0][0])


def test_reference_default_conf():
    """The reference's default conf (kernel auto, the users' path) binds
    what the port's default conf binds."""
    from volcano_tpu.framework.conf import DEFAULT_SCHEDULER_CONF
    assert_same(make_spec(31, queues=FOUR_QUEUES, n_jobs=28),
                DEFAULT_SCHEDULER_CONF)


def test_populate_store_cycle_matches_reference():
    """The shape cmd/cycle.py and chip_smoke.py run, at a small size."""
    def run_synth(pkg, **kw):
        store = pkg.Store()
        pkg.synth.populate_store(store, n_nodes=16, n_jobs=24, gang_size=8)
        cache = pkg.Cache(store, binder=pkg.tu.FakeBinder(store))
        cache.run()
        pkg.Scheduler(store, scheduler_conf=conf(binpack=True), cache=cache,
                      **kw).run_once()
        cache.flush_executors()
        cache.stop()
        return outcome(store)
    ref = run_synth(REF)
    assert run_synth(PORT, device="cpu") == ref
    assert len(ref[0]) == 24 * 8


def test_scheduler_default_conf_and_device():
    """Scheduler(store) reads the default conf; it runs on the GPU unless
    given device="cpu", and raises without one."""
    import torch
    store = PortStore()
    port_synth.populate_store(store, n_nodes=4, n_jobs=2, gang_size=2)
    s = PortScheduler(store, device="cpu")
    assert s.conf.actions == ["enqueue", "allocate", "backfill"]
    s.cache.run()
    s.run_once()
    s.cache.flush_executors()
    s.cache.stop()
    assert sum(bool(p.spec.node_name) for p in store.list("pods")) == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PortScheduler(PortStore())


# -- placement constraints ------------------------------------------------------

ZONED = dict(zones=4, n_nodes=16, n_jobs=20, gang=(2, 6))
WEB = dict(running=3, web_running=True, n_nodes=12, n_jobs=24, zones=3)

CONSTRAINED_CASES = {
    "hard_spread": dict(kw=dict(ZONED, spread_every=2), conf=dict()),
    # gangs of up to 4 over 4 zones, with surplus replicas beyond them
    "self_anti_one_per_zone": dict(
        kw=dict(ZONED, anti_every=2, gang=(2, 4), surplus=0.8),
        conf=dict()),
    "required_affinity_hostname": dict(
        kw=dict(WEB, pod_affinity=("req", HOSTNAME, 2)), conf=dict()),
    "required_affinity_zone": dict(
        kw=dict(WEB, pod_affinity=("req", ZONE, 2)), conf=dict()),
    # few running app=web pods, so that some hosts and zones have none
    "required_anti_affinity_hostname": dict(
        kw=dict(WEB, pod_affinity=("anti", HOSTNAME, 2), running=8,
                n_nodes=20), conf=dict()),
    "required_anti_affinity_zone": dict(
        kw=dict(WEB, pod_affinity=("anti", ZONE, 3), running=12, zones=8,
                n_nodes=24), conf=dict()),
    "preferred_affinity": dict(
        kw=dict(WEB, pod_affinity=("pref", ZONE, 2)), conf=dict()),
    "running_pod_symmetry": dict(
        kw=dict(running=8, symmetry=True, zones=3, n_nodes=20, n_jobs=24),
        conf=dict()),
    "soft_spread": dict(
        kw=dict(ZONED, soft_every=2, running=4, surplus=0.8),
        conf=dict(binpack=True)),
    "tieredpack": dict(
        kw=dict(priorities=True, running=2, n_nodes=16, n_jobs=28),
        conf=dict(tieredpack=2, binpack=True)),
    "task_topology": dict(
        kw=dict(topology_every=2, n_nodes=12, n_jobs=20, gang=(3, 6)),
        conf=dict(task_topology=True)),
    # the reference constraint benchmark's mix, smaller
    "heavy_mix": dict(
        kw=dict(zones=4, spread_every=4, anti_every=4, soft_every=3,
                running=5, n_nodes=24, n_jobs=32, gang=(2, 4)),
        conf=dict(binpack=True)),
}


def _zone_counts(spec, binds, job):
    """{zone: bound pods} of one job of the description."""
    zone = {n["name"]: n["labels"].get(ZONE) for n in spec["nodes"]}
    counts = {}
    for p in spec["pods"]:
        node = binds.get(f"{p['ns']}/{p['name']}")
        if p["group"] == job and node:
            counts[zone[node]] = counts.get(zone[node], 0) + 1
    return counts


def _check_semantics(spec, binds):
    """Hard spread keeps max_skew 1 over the zones; one replica per zone
    for the self-anti gangs; a pod with required (anti-)affinity to app=web
    lands in (out of) a domain of a node hosting one; symmetric
    anti-affinity keeps app=backend pods off the nodes of app=iso pods."""
    labels = {n["name"]: n["labels"] for n in spec["nodes"]}
    zones = sorted({lab[ZONE] for lab in labels.values() if ZONE in lab})
    hosts = {}
    for p in spec["pods"]:
        node = binds.get(f"{p['ns']}/{p['name']}")
        if node:
            hosts.setdefault(p["labels"].get("app"), set()).add(node)
    for g in spec["podgroups"]:
        pods = [p for p in spec["pods"] if p["group"] == g["name"]]
        counts = _zone_counts(spec, binds, g["name"])
        if not counts or any(p["node"] for p in pods):
            continue    # placed by the description, not by the cycle
        if any(s[2] == "DoNotSchedule" for s in pods[0]["spread"]):
            per_zone = [counts.get(z, 0) for z in zones]
            assert max(per_zone) - min(per_zone) <= 1, (g["name"], counts)
        if any(a[:2] == ("anti", "job-group") for a in pods[0]["aff"]):
            assert max(counts.values()) <= 1, (g["name"], counts)
    for p in spec["pods"]:
        node = binds.get(f"{p['ns']}/{p['name']}")
        if not node or p["node"]:
            continue
        for kind, key, value, topology, _ in p["aff"]:
            if key != "app" or kind not in ("req", "anti"):
                continue
            domains = {labels[h].get(topology) for h in hosts.get(value, ())}
            inside = labels[node].get(topology) in domains
            assert inside == (kind == "req"), (p["name"], node, kind)
        if p["labels"].get("app") == "backend":
            assert node not in hosts.get("iso", ()), (p["name"], node)


@pytest.mark.parametrize("mode", ["compiled", "compile_off"])
@pytest.mark.parametrize("case", sorted(CONSTRAINED_CASES))
def test_constrained_cycle_matches_reference(case, mode):
    """A cycle whose pods carry placement constraints binds what the
    reference binds, in the compiled mode (the slot path) and under
    ``constraints.compile: off`` (per-pair mask, split groups)."""
    c = CONSTRAINED_CASES[case]
    seed = sorted(CONSTRAINED_CASES).index(case) + 51
    spec = make_spec(seed, **c["kw"])
    (binds, _, _), = assert_same(
        spec, conf(compile_off=mode == "compile_off", **c["conf"]))
    _check_semantics(spec, binds)


def test_constrained_cycle_takes_the_slot_path():
    """The compiled mode hands the kernel per-task domain slots and keeps
    base groups; ``constraints.compile: off`` splits groups instead and
    hands it none. Both bind the same."""
    spec = make_spec(61, **CONSTRAINED_CASES["heavy_mix"]["kw"])
    out, split = {}, {}
    for off in (False, True):
        store = PortStore()
        populate(PORT, store, spec)
        sched = PortScheduler(store, scheduler_conf=conf(compile_off=off,
                                                         binpack=True),
                              device="cpu")
        sched.cache.run()
        sched.run_once()
        sched.cache.flush_executors()
        sched.cache.stop()
        out[off] = outcome(store)[0]
        split[off] = sched.last_cycle["places"]
    assert out[False] == out[True] and out[False]
    assert split[False][0]["slots"] > 0 and split[True][0]["slots"] == 0
    assert all(pl["constraint_ms"] > 0 for pl in split[False])


def _small_session(conf_text):
    from volcano_tpu_torch.framework import open_session, parse_scheduler_conf
    store = PortStore()
    port_synth.populate_store(store, n_nodes=4, n_jobs=2, gang_size=2)
    cache = PortCache(store)
    cache.run()
    # the session reads only its snapshot: no watch or executor after the
    # list (its binds write inline)
    cache.stop()
    c = parse_scheduler_conf(conf_text)
    return lambda: open_session(cache, c.tiers, c.configurations,
                                device="cpu")


def test_placement_changing_options_raise_not_implemented():
    """The priority plugin's tiered packing score is ported: a session
    with it runs a cycle and adds its score to the solver (node sampling
    is held by tests/test_torch_sampling.py)."""
    from volcano_tpu_torch.framework import get_action
    ssn = _small_session(conf(tieredpack=2))()
    plain = _small_session(conf())()
    assert len(ssn.solver.static_score_fns) == \
        len(plain.solver.static_score_fns) + 1
    get_action("allocate").execute(ssn)
    assert ssn.solver.stats and ssn.solver.stats[0]["kernel_ms"] >= 0
    # the keys that only choose among exact kernels are accepted
    ssn = _small_session(conf().replace(
        '{kernel: scan,',
        '{kernel: pallas, breaker.window: 5, apply: deferred,'))()
    assert ssn.solver is not None


def _host_only_plugin(pkg_framework, name, fault=None):
    """A plugin in ``pkg_framework``'s registry that registers only a
    host predicate: it vetoes a node for a task's job by a fixed hash of
    the two names (about one pair in three), raising ``fault`` instead
    when given (an error outside the veto contract)."""
    import zlib

    class HostOnly(pkg_framework.Plugin):
        def __init__(self, arguments=None):
            pass

        def name(self):
            return name

        def on_session_open(self, ssn):
            def predicate(task, node):
                if fault is not None:
                    raise fault(f"{name}: broken on {node.name}")
                if zlib.crc32(f"{task.job}/{node.name}".encode()) % 3 == 0:
                    raise ValueError(f"{name}: {task.job} kept off "
                                     f"{node.name}")
            ssn.add_predicate_fn(name, predicate)

    pkg_framework.register_plugin_builder(name, HostOnly)


def test_host_predicate_of_unvectorized_plugin_raises():
    """A plugin that registers a host predicate without marking itself
    vectorized is honoured as in the reference: the solver sweeps it over
    every group and node into the static mask, equal to the reference's
    ``_host_predicate_mask`` on the same session; whole cycles bind for
    bind the same; and an error outside the veto contract is raised, not
    read as a veto."""
    import volcano_tpu.framework as ref_fw
    import volcano_tpu_torch.framework as port_fw
    from volcano_tpu.models.arrays import NodeArrays as RefNodeArrays
    from volcano_tpu.models.arrays import TaskBatch as RefTaskBatch
    from volcano_tpu_torch.models.arrays import NodeArrays, TaskBatch

    for fw in (ref_fw, port_fw):
        _host_only_plugin(fw, "test-host-only")
        _host_only_plugin(fw, "test-host-broken", fault=TypeError)
    text = conf().replace("  - name: nodeorder\n",
                          "  - name: nodeorder\n  - name: test-host-only\n")

    def session(pkg, fw, conf_text, **kw):
        store = pkg.Store()
        pkg.synth.populate_store(store, n_nodes=12, n_jobs=6, gang_size=3)
        cache = pkg.Cache(store)
        cache.run()
        cache.stop()
        c = fw.parse_scheduler_conf(conf_text)
        return fw.open_session(cache, c.tiers, c.configurations, **kw)

    masks = []
    for pkg, fw, NA, TB, kw in ((REF, ref_fw, RefNodeArrays, RefTaskBatch,
                                 {}),
                                (PORT, port_fw, NodeArrays, TaskBatch,
                                 {"device": "cpu"})):
        ssn = session(pkg, fw, text, **kw)
        jobs = sorted(ssn.jobs.values(), key=lambda j: j.uid)
        ordered = [(j, sorted(j.tasks.values(), key=lambda t: t.uid))
                   for j in jobs]
        narr = NA.build(ssn.nodes, [n.name for n in ssn.node_list],
                        ssn.solver.rindex)
        batch = TB.build(ordered, ssn.solver.rindex)
        sweep = ssn.solver._host_predicate_mask if pkg is REF \
            else ssn.solver.host_predicate_mask
        masks.append(np.asarray(sweep(batch, narr)))
    assert masks[1].shape == masks[0].shape
    assert np.array_equal(masks[1], masks[0])
    assert 0 < int((~masks[0][:6, :12]).sum()) < 6 * 12

    # whole cycles: the same binds, phases and conditions, and the
    # vetoed pairs unused
    (binds, _, _), = assert_same(make_spec(23, n_nodes=10, n_jobs=12), text)
    import zlib
    for key, node in binds.items():
        ns, pod = key.split("/")
        job = f"{ns}/pg-{pod.split('-')[0][3:]}"
        assert zlib.crc32(f"{job}/{node}".encode()) % 3 != 0

    broken = conf().replace("  - name: nodeorder\n",
                            "  - name: nodeorder\n"
                            "  - name: test-host-broken\n")
    ssn = session(PORT, port_fw, broken, device="cpu")
    with pytest.raises(TypeError, match="test-host-broken"):
        port_fw.get_action("allocate").execute(ssn)


def test_cycle_command_on_cpu(capsys):
    """python -m volcano_tpu_torch.cmd.cycle --device cpu: one JSON line
    with the cold and warm runs, every task bound; without --device it
    needs a GPU."""
    import json

    import torch

    from volcano_tpu_torch.cmd import cycle
    assert cycle.main(["--device", "cpu", "--tasks", "64", "--nodes", "8",
                       "--warm", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and len(out["warm"]) == 1
    for run in [out["cold"], *out["warm"]]:
        assert run["binds"] == 64 and run["committed_gangs"] == 8
        assert len(run["places"]) == 1
        assert run["cycle_ms"] >= run["allocate_ms"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cycle.main(["--tasks", "64", "--nodes", "8"])


def test_cycle_command_with_constraints_on_cpu(capsys):
    """cmd.cycle with --zones, --spread-every and --anti-every: the
    constraint mix reaches the kernel as per-task slots, and every gang
    binds."""
    import json

    from volcano_tpu_torch.cmd import cycle
    assert cycle.main(["--device", "cpu", "--tasks", "128", "--nodes", "32",
                       "--warm", "0", "--zones", "8", "--spread-every", "2",
                       "--anti-every", "4"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert (out["zones"], out["spread_every"], out["anti_every"]) == (8, 2, 4)
    run = out["cold"]
    assert run["binds"] == 128 and run["committed_gangs"] == 16
    assert run["places"][0]["slots"] == 8
    assert run["places"][0]["constraint_ms"] > 0
