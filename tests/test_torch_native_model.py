"""The port's native engine (volcano_tpu_torch/native/fastmodel.c) at the
model level, held against its own Python bodies and against the JAX
package's native engine and Python bodies.

The cases of tests/test_native_model.py (the snapshot clones, the bind and
status clones, registration through the MRO and its refusals, the GC
guard) and of tests/test_native_registry.py (every registration and entry
against the Python body it equals: the task table and dict clones, the
Resource clone, the bind clone, the bind request, the filter
classification and the ledger's completion), each through both packages:
the reference on its native engine and on its Python bodies, the port on
its native engine and on its Python bodies. Observables must be equal
exactly (host objects: no tolerance). And the build: a broken compiler
raises RuntimeError, and no engine switches over.
"""

import gc
import re
from collections import defaultdict
from types import SimpleNamespace

import pytest

import volcano_tpu.cache.interface as ref_interface
import volcano_tpu.models.job_info as ref_ji
import volcano_tpu.models.node_info as ref_ni
import volcano_tpu.models.objects as ref_obj
import volcano_tpu.models.resource as ref_res
import volcano_tpu.trace.ledger as ref_ledger
import volcano_tpu.utils.fastclone as ref_fc
import volcano_tpu.utils.gcguard as ref_gcguard
import volcano_tpu.utils.test_utils as ref_tu
import volcano_tpu_torch.cache.interface as port_interface
import volcano_tpu_torch.models.job_info as port_ji
import volcano_tpu_torch.models.node_info as port_ni
import volcano_tpu_torch.models.objects as port_obj
import volcano_tpu_torch.models.resource as port_res
import volcano_tpu_torch.native.build as port_build
import volcano_tpu_torch.trace.ledger as port_ledger
import volcano_tpu_torch.utils.fastclone as port_fc
import volcano_tpu_torch.utils.gcguard as port_gcguard
import volcano_tpu_torch.utils.test_utils as port_tu
from volcano_tpu.apiserver import ObjectStore as RefStore
from volcano_tpu.native import build as ref_build
from volcano_tpu_torch.apiserver import ObjectStore as PortStore

REF = SimpleNamespace(name="ref", ji=ref_ji, ni=ref_ni, obj=ref_obj,
                      res=ref_res, ledger=ref_ledger, fc=ref_fc,
                      gcguard=ref_gcguard, tu=ref_tu, Store=RefStore,
                      interface=ref_interface)
PORT = SimpleNamespace(name="port", ji=port_ji, ni=port_ni, obj=port_obj,
                       res=port_res, ledger=port_ledger, fc=port_fc,
                       gcguard=port_gcguard, tu=port_tu, Store=PortStore,
                       interface=port_interface)
SIDES = [pytest.param(REF, id="ref"), pytest.param(PORT, id="port")]
ENGINES = ["native", "python"]


def fm_of(side):
    """The side's native module, registered with its model classes."""
    fm = side.ji._fastmodel()
    assert fm is not None, f"{side.name}: the native engine did not load"
    return fm


def job_clone(side, job, engine: str):
    """JobInfo.clone on the engine asked for."""
    if side is REF:
        return job._clone_native(fm_of(REF)) if engine == "native" \
            else job._clone_python()
    old = PORT.ji.NATIVE_CLONE
    PORT.ji.NATIVE_CLONE = engine == "native"
    try:
        return job.clone()
    finally:
        PORT.ji.NATIVE_CLONE = old


def node_clone(side, node, engine: str):
    """NodeInfo.clone on the engine asked for (the reference's switch is
    its module's handle: None runs the Python body)."""
    if side is PORT:
        old = PORT.ji.NATIVE_CLONE
        PORT.ji.NATIVE_CLONE = engine == "native"
        try:
            return node.clone()
        finally:
            PORT.ji.NATIVE_CLONE = old
    if engine == "native":
        assert fm_of(REF) is not None
        return node.clone()
    saved = (REF.ji._fm_cache, REF.ji._fm_tried)
    REF.ji._fm_cache, REF.ji._fm_tried = None, True
    try:
        return node.clone()
    finally:
        REF.ji._fm_cache, REF.ji._fm_tried = saved


def mk_job(side, uid="ns1/pg-x", name="pg-x", n=4, cpu="2", mem="4Gi"):
    job = side.ji.JobInfo(uid)
    for i in range(n):
        pod = side.tu.build_pod("ns1", f"p{i}", "node-0" if i % 2 else "",
                                "Running" if i % 2 else "Pending",
                                {"cpu": cpu, "memory": mem,
                                 "nvidia.com/gpu": "1" if i == 3 else "0"},
                                name)
        job.add_task_info(side.ji.TaskInfo(pod))
    job.set_pod_group(side.tu.build_pod_group(name, "ns1", "default", n))
    return job


def view(x, side, path=""):
    """A package-neutral value of a model object: what the two packages'
    clones are compared by (Resources by their four fields, TaskInfos slot
    by slot, pods and PodGroups by key, enums by name)."""
    if isinstance(x, side.res.Resource):
        return ("Resource", x.milli_cpu, x.memory, dict(x.scalars),
                x.max_task_num)
    if isinstance(x, side.ji.TaskInfo):
        return ("TaskInfo",) + tuple(
            view(getattr(x, s, None), side, s)
            for s in side.ji.TaskInfo.__slots__)
    if isinstance(x, side.ji.TaskStatus):
        return ("TaskStatus", x.name)
    if isinstance(x, (side.obj.Pod, side.obj.PodGroup)):
        return (type(x).__name__, x.metadata.namespace, x.metadata.name)
    if isinstance(x, dict):
        return ("dict", tuple((view(k, side), view(v, side))
                              for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(view(v, side) for v in x))
    if isinstance(x, (str, int, float, bool, type(None))):
        return x
    return (type(x).__name__, view(vars(x), side))


def attrs_view(o, side):
    return {k: view(v, side) for k, v in sorted(vars(o).items())}


def assert_equiv(a, b, side, path=""):
    """Structural equivalence of two values of one package, with pods
    compared by identity (a clone shares its source's pod)."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, side.res.Resource):
        assert (a.milli_cpu, a.memory, a.scalars, a.max_task_num) == \
            (b.milli_cpu, b.memory, b.scalars, b.max_task_num), path
        return
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_equiv(a[k], b[k], side, f"{path}.{k}")
        return
    if isinstance(a, side.ji.TaskInfo):
        for slot in side.ji.TaskInfo.__slots__:
            if slot == "pod":
                assert a.pod is b.pod, (path, slot)
            else:
                assert getattr(a, slot, None) == getattr(b, slot, None), \
                    (path, slot)
        return
    if isinstance(a, (str, int, float, bool, tuple, list, type(None))):
        assert a == b, (path, a, b)
        return
    if a is b:
        return
    assert_equiv(vars(a), vars(b), side, f"{path}<{type(a).__name__}>")


@pytest.fixture(autouse=True)
def _restore_engines():
    yield
    PORT.ji.NATIVE_CLONE = True
    fm_of(REF).register_task_type(REF.ji.TaskInfo)
    fm_of(PORT).register_task_type(PORT.ji.TaskInfo)


# -- tests/test_native_model.py through both packages ------------------------


@pytest.mark.parametrize("side", SIDES)
def test_job_clone_native_matches_python(side):
    job = mk_job(side)
    n = job_clone(side, job, "native")
    p = job_clone(side, job, "python")
    # identical attribute sets and equivalent values: a JobInfo field
    # added to __init__ and the Python clone but not the native one fails
    assert set(vars(n)) == set(vars(p)), set(vars(n)) ^ set(vars(p))
    for key in vars(p):
        assert_equiv(getattr(n, key), getattr(p, key), side, key)
    # fresh (not shared) mutable state
    assert n.tasks is not job.tasks and n.allocated is not job.allocated
    uid = next(iter(n.tasks))
    assert n.tasks[uid] is not job.tasks[uid]
    before = job.tasks[uid].status
    n.tasks[uid].status = side.ji.TaskStatus.Binding
    assert job.tasks[uid].status == before


def test_job_clone_equal_across_packages_and_engines():
    views = {(side.name, engine): attrs_view(
        job_clone(side, mk_job(side), engine), side)
        for side in (REF, PORT) for engine in ENGINES}
    # scheduling_start_time is stamped at construction (wall clock)
    for v in views.values():
        v.pop("scheduling_start_time")
    first = views[("ref", "native")]
    for k, v in views.items():
        assert v == first, k


@pytest.mark.parametrize("side", SIDES)
def test_node_clone_native_and_python_equivalent(side):
    node = side.ni.NodeInfo(side.tu.build_node(
        "n1", {"cpu": "8", "memory": "16Gi", "pods": "10"}))
    t = side.ji.TaskInfo(side.tu.build_pod(
        "ns1", "p0", "n1", "Running", {"cpu": "1", "memory": "1Gi"}, "pg"))
    node.add_task(t)
    n = node_clone(side, node, "native")
    p = node_clone(side, node, "python")
    assert set(vars(n)) == set(vars(node)) == set(vars(p))
    for key in vars(p):
        assert_equiv(getattr(n, key), getattr(p, key), side, key)
    assert n.tasks is not node.tasks and set(n.tasks) == set(node.tasks)
    assert n.allocatable is node.allocatable   # shared by contract
    t2 = side.ji.TaskInfo(side.tu.build_pod(
        "ns1", "p1", "n1", "Running", {"cpu": "1", "memory": "1Gi"}, "pg"))
    n.add_task(t2)
    assert "ns1/p1" in n.tasks and "ns1/p1" not in node.tasks
    assert node.idle.milli_cpu - n.idle.milli_cpu == 1000


def test_node_clone_equal_across_packages_and_engines():
    def one(side, engine):
        node = side.ni.NodeInfo(side.tu.build_node(
            "n1", {"cpu": "8", "memory": "16Gi", "nvidia.com/gpu": "2"}))
        for i in range(3):
            node.add_task(side.ji.TaskInfo(side.tu.build_pod(
                "ns1", f"p{i}", "n1", "Running",
                {"cpu": "1", "memory": "1Gi"}, "pg")))
        return attrs_view(node_clone(side, node, engine), side)
    views = {(s.name, e): one(s, e) for s in (REF, PORT) for e in ENGINES}
    first = views[("ref", "native")]
    for k, v in views.items():
        assert v == first, k


@pytest.mark.parametrize("side", SIDES)
def test_bind_clone_attribute_parity(side):
    pod = side.tu.build_pod("ns1", "p0", "", "Pending",
                            {"cpu": "1", "memory": "1Gi"}, "pg")
    pod.resource_request()
    pod._sched_group_sig = 1234
    a, b = side.obj.clone_pod_for_bind(pod), side.fc.fast_clone(pod)
    assert set(vars(a)) == set(vars(b)), set(vars(a)) ^ set(vars(b))
    assert a.__dict__["_rr"] is pod.__dict__["_rr"]
    assert a.__dict__["_sched_group_sig"] == 1234
    for part in ("metadata", "spec", "status"):
        assert set(vars(getattr(a, part))) == set(vars(getattr(b, part)))
    a.spec.node_name = "nX"
    a.metadata.resource_version = 99
    assert pod.spec.node_name == "" and pod.metadata.resource_version != 99


@pytest.mark.parametrize("side", SIDES)
def test_status_clone_attribute_parity(side):
    pg = side.tu.build_pod_group("pg-x", "ns1", "default", 4)
    a, b = side.obj.clone_pod_group_for_status(pg), side.fc.fast_clone(pg)
    assert set(vars(a)) == set(vars(b))
    assert a.spec is pg.spec and a.metadata is not pg.metadata


@pytest.mark.parametrize("side", SIDES)
def test_register_subclass_clones_inherited_slots(side):
    fm = fm_of(side)

    class SubTask(side.ji.TaskInfo):
        __slots__ = ("extra_tag",)

        def __init__(self, pod):
            super().__init__(pod)
            self.extra_tag = "sub"

    fm.register_task_type(SubTask)
    t = SubTask(side.tu.build_pod("ns1", "p0", "n1", "Running",
                                  {"cpu": "1", "memory": "1Gi"}, "pg"))
    c = fm.clone_task(t)
    for slot in side.ji.TaskInfo.__slots__:
        assert getattr(c, slot, None) == getattr(t, slot, None), slot
    assert c.extra_tag == "sub"


@pytest.mark.parametrize("side", SIDES)
def test_register_rejects_dict_bearing_base(side):
    fm = fm_of(side)

    class DictBase:
        pass

    class BadTask(DictBase):
        __slots__ = ("status", "uid")

    with pytest.raises(TypeError):
        fm.register_task_type(BadTask)

    class NoSlotsSub(side.ji.TaskInfo):
        pass

    with pytest.raises(TypeError):
        fm.register_task_type(NoSlotsSub)
    t = side.ji.TaskInfo(side.tu.build_pod(
        "ns1", "p0", "n1", "Running", {"cpu": "1", "memory": "1Gi"}, "pg"))
    assert fm.clone_task(t).uid == t.uid


@pytest.mark.parametrize("side", SIDES)
def test_gcguard_nesting_and_foreign_disable(side):
    g = side.gcguard
    assert gc.isenabled()
    g.pause()
    assert not gc.isenabled()
    g.pause()
    g.resume()
    assert not gc.isenabled()
    g.resume()
    assert gc.isenabled()
    g.resume()
    assert gc.isenabled()
    gc.disable()
    try:
        g.pause()
        g.resume()
        assert not gc.isenabled()
    finally:
        gc.enable()


# -- tests/test_native_registry.py through both packages ---------------------

_TABLE_RE = re.compile(r"static\s+PyMethodDef\s+\w+\[\]\s*=\s*\{(?P<body>.*?)\};",
                       re.S)
_ENTRY_RE = re.compile(r'\{\s*"(?P<name>\w+)"\s*,')


def declared_entries(path) -> list:
    with open(path, encoding="utf-8") as f:
        m = _TABLE_RE.search(f.read())
    return _ENTRY_RE.findall(m.group("body")) if m else []


@pytest.mark.parametrize("side", SIDES)
def test_registry_matches_compiled_exports(side):
    path = ref_build._FM_SRC if side is REF else port_build.SOURCE
    declared = declared_entries(path)
    assert declared, "method table parse came back empty"
    fm = fm_of(side)
    for name in declared:
        assert callable(getattr(fm, name, None)), name


def test_port_entries_are_the_reference_entries_the_port_calls():
    """The port exports the reference's entries that its layers call and
    adds the bind clone's class registration. It leaves out the JSON
    encoder (its callers are not ported) and the __dict__ shell clone (a
    dict-backed instance reads its attributes about three times slower
    than one the class's __init__ layout holds, so the clones keep their
    field stores in Python)."""
    ref = set(declared_entries(ref_build._FM_SRC))
    port = set(declared_entries(port_build.SOURCE))
    assert port - ref == {"register_pod_types"}
    assert ref - port == {"encode_object_json", "shell_clone"}


@pytest.mark.parametrize("side", SIDES)
def test_register_task_type_and_register_resource_type_idempotent(side):
    fm = fm_of(side)
    fm.register_task_type(side.ji.TaskInfo)
    fm.register_resource_type(side.res.Resource)

    class DictBearing:
        pass

    with pytest.raises(TypeError):
        fm.register_task_type(DictBearing)


@pytest.mark.parametrize("side", SIDES)
def test_register_task_status_reregistration_keeps_echo_guards(side):
    fm = fm_of(side)
    fm.register_task_status(side.ji.TaskStatus, side.ji._ALLOCATED_STATUSES)
    job = mk_job(side, n=5)
    tasks, plain = fm.clone_task_table(job.tasks)
    assert set(plain) == {t.status for t in job.tasks.values()}


@pytest.mark.parametrize("side", SIDES)
def test_clone_task_table_parity(side):
    fm = fm_of(side)
    job = mk_job(side, n=5)
    tasks, plain = fm.clone_task_table(job.tasks)
    ptasks, pindex = {}, defaultdict(dict)
    for uid, task in job.tasks.items():
        c = task.clone()
        ptasks[uid] = c
        pindex[c.status][uid] = c
    assert list(tasks) == list(ptasks)
    for uid in tasks:
        assert tasks[uid] is not job.tasks[uid]
        assert_equiv(tasks[uid], ptasks[uid], side, uid)
    assert [(s, list(d)) for s, d in plain.items()] == \
        [(s, list(d)) for s, d in pindex.items()]
    for d in plain.values():
        for uid, t in d.items():
            assert t is tasks[uid]


@pytest.mark.parametrize("side", SIDES)
def test_job_clone_with_a_subclassed_task(side):
    """A task of a TaskInfo subclass clones as TaskInfo.clone makes it (a
    TaskInfo) on every engine: the reference's native table refuses it
    and its caller runs the Python loop, the port's clones it in C."""
    class SubTask(side.ji.TaskInfo):
        __slots__ = ()

    job = mk_job(side, n=3)
    job.add_task_info(SubTask(side.tu.build_pod(
        "ns1", "sub", "", "Pending", {"cpu": "1", "memory": "1Gi"},
        "pg-x")))
    n, p = (job.clone() if side is REF and e == "native"
            else job_clone(side, job, e) for e in ENGINES)
    assert [type(t) for t in n.tasks.values()] == \
        [type(t) for t in p.tasks.values()] == [side.ji.TaskInfo] * 4
    assert attrs_view(n, side) == attrs_view(p, side)


@pytest.mark.parametrize("side", SIDES)
def test_clone_task_dict_parity(side):
    fm = fm_of(side)
    node = side.ni.NodeInfo(side.tu.build_node(
        "nr1", {"cpu": "8", "memory": "16Gi"}))
    for i in range(3):
        node.add_task(side.ji.TaskInfo(side.tu.build_pod(
            "ns1", f"np{i}", "nr1", "Running",
            {"cpu": "1", "memory": "1Gi"}, "pg")))
    clones = fm.clone_task_dict(node.tasks)
    assert list(clones) == list(node.tasks)
    for key in clones:
        assert clones[key] is not node.tasks[key]
        assert_equiv(clones[key], node.tasks[key].clone(), side, key)


@pytest.mark.parametrize("side", SIDES)
def test_clone_resource_parity(side):
    fm = fm_of(side)
    r = side.res.Resource.from_resource_list(
        {"cpu": "3", "memory": "7Gi", "nvidia.com/gpu": "2", "pods": "11"})
    r.max_task_num = 42
    n, p = fm.clone_resource(r), r.clone()
    assert n is not r and type(n) is type(p)
    assert (n.milli_cpu, n.memory, n.scalars, n.max_task_num) == \
        (p.milli_cpu, p.memory, p.scalars, p.max_task_num)
    assert n.scalars is not r.scalars
    n.scalars["nvidia.com/gpu"] = 999.0
    assert r.scalars["nvidia.com/gpu"] != 999.0


def bind_olds(side, n=4, seed_rr=True, sig=False):
    olds = []
    for i in range(n):
        pod = side.tu.build_pod("ns1", f"bp{i}", "", "Pending",
                                {"cpu": "1", "memory": "1Gi"}, "pg")
        if seed_rr:
            pod.resource_request()
        if sig:
            pod._sched_group_sig = 7 + i
        olds.append(pod)
    return olds


def python_bind_clone(side, old, host, rv):
    ref = side.obj.clone_pod_for_bind(old)
    ref.spec.node_name = host
    ref.resource_request()
    ref.metadata.resource_version = rv
    return ref


@pytest.mark.parametrize("sig", [False, True], ids=["plain", "group_sig"])
@pytest.mark.parametrize("side", SIDES)
def test_bind_clone_pods_parity(side, sig):
    fm = fm_of(side)
    olds = bind_olds(side, sig=sig)
    hosts = [f"node-{i}" for i in range(4)]
    news = fm.bind_clone_pods(olds, hosts, 100)
    assert len(news) == 4
    for i, (old, new) in enumerate(zip(olds, news)):
        ref = python_bind_clone(side, old, hosts[i], 100 + i)
        assert new is not old and type(new) is type(ref)
        assert set(vars(new)) == set(vars(ref))
        if side is PORT:   # the port's C builds the dict in its order
            assert list(vars(new)) == list(vars(ref))
        for part in ("metadata", "spec"):
            a, b = getattr(new, part), getattr(ref, part)
            assert type(a) is type(b) and vars(a) == vars(b)
            assert a is not getattr(old, part)
        assert new.status is old.status
        assert new.__dict__["_rr"] is old.__dict__["_rr"]
        assert new.spec.node_name == hosts[i]
        assert new.metadata.resource_version == 100 + i
        assert old.spec.node_name == "" and \
            old.metadata.resource_version != 100 + i


def test_port_bind_clone_pods_hands_back_an_unparsed_pod():
    """A shard with a pod whose request was never parsed comes back as
    None, with nothing built: the Python loop, which parses it, runs."""
    fm = fm_of(PORT)
    olds = bind_olds(PORT, n=3)
    olds[1].__dict__.pop("_rr")
    assert fm.bind_clone_pods(olds, ["a", "b", "c"], 1) is None


@pytest.mark.parametrize("side", SIDES)
def test_bind_request_items_parity(side):
    fm_of(side)
    items = [(side.tu.build_pod("ns1", f"qp{i}", "", "Pending",
                                {"cpu": "1", "memory": "1Gi"}, "pg"),
              f"node-{i}") for i in range(3)]
    want = [(p.metadata.name, p.metadata.namespace, h) for p, h in items]
    if side is REF:
        reqs, keys = side.interface.native_bind_request_items(
            items, True, True)
        assert keys == [f"{p.metadata.namespace}/{p.metadata.name}"
                        for p, _ in items]
    else:
        reqs = fm_of(PORT).bind_request_items(items)
        assert fm_of(PORT).bind_request_items([(object(), "h")]) is None
    assert reqs == want


def flip_pairs(side):
    def pod(name, sched):
        p = side.tu.build_pod("ns1", name, "", "Pending",
                              {"cpu": "1", "memory": "1Gi"}, "pg")
        p.spec.scheduler_name = sched
        return p
    return [(pod("a", "volcano"), pod("a", "volcano")),
            (pod("b", "other"), pod("b", "volcano")),
            (pod("c", "volcano"), pod("c", "other")),
            (pod("d", "other"), pod("d", "other")),
            (pod("e", None), pod("e", "volcano"))]


@pytest.mark.parametrize("side", SIDES)
def test_attr_eq_filter_pairs_parity(side):
    fm = fm_of(side)
    pairs = flip_pairs(side)
    delivery, flips = fm.attr_eq_filter_pairs(
        pairs, "spec", "scheduler_name", "volcano")

    def passes(p):
        return p.spec.scheduler_name == "volcano"
    ref_delivery = [(o, n) for o, n in pairs if passes(o) and passes(n)]
    ref_flips = []
    for o, n in pairs:
        if not passes(o) and passes(n):
            ref_flips.append((True, n))
        elif passes(o) and not passes(n):
            ref_flips.append((False, o))
    assert [(id(o), id(n)) for o, n in delivery] == \
        [(id(o), id(n)) for o, n in ref_delivery]
    assert [(bool(a), id(o)) for a, o in flips] == \
        [(a, id(o)) for a, o in ref_flips]


def ledger_roundtrip(side, native: bool):
    L = side.ledger
    old = L.NATIVE_CONFIRM
    L.NATIVE_CONFIRM = native
    try:
        L.reset()
        L.enable()
        keys = [f"q/led{i}" for i in range(6)]
        for k in keys:
            L.stamp(k, "submitted", 1.0, queue="default", job="j")
        L.stamp(keys[0], "enqueued", 1.25)
        L.stamp_runs([(keys[:3], 2.0), (keys[3:], 2.5)], "bind_staged")
        L.stamp(keys[5], "store_committed", 2.75)
        L.confirm_runs([(keys[:3], "default"), (keys[3:5], "other"),
                        (keys[5:], None)], 4.0, commit_t=3.0)
        stats = L.stats()
        return (L.fingerprint(), stats["completed"], stats["open"],
                L.report())
    finally:
        L.NATIVE_CONFIRM = old
        L.disable()
        L.reset()


@pytest.mark.parametrize("side", SIDES)
def test_register_ledger_types_and_confirm_runs_parity(side):
    fm = side.ledger._ledger_native()
    L = side.ledger
    fm.register_ledger_types(L._Entry, L._Agg, L._HOP_NAME, L._COMMIT_IDX,
                             L._ECHO_IDX)
    native = ledger_roundtrip(side, True)
    python = ledger_roundtrip(side, False)
    assert native == python
    assert native[1] == 6 and native[2] == 0


def test_confirm_runs_equal_across_packages_and_engines():
    runs = {(s.name, e): ledger_roundtrip(s, e == "native")
            for s in (REF, PORT) for e in ENGINES}
    first = runs[("ref", "native")]
    for k, v in runs.items():
        assert v == first, k


# -- the build: no soft availability -----------------------------------------


def test_build_raises_on_a_broken_compiler(monkeypatch, tmp_path):
    """A compiler that is missing, or that fails, raises RuntimeError with
    its output; the loaded engine and every switch stay as they were."""
    monkeypatch.setattr(port_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(port_build, "CC", str(tmp_path / "no-such-gcc"))
    with pytest.raises(RuntimeError, match="fastmodel build failed"):
        port_build.build()
    broken = tmp_path / "broken-gcc"
    broken.write_text("#!/bin/sh\necho 'cc1: fatal error: Python.h' >&2\n"
                      "exit 1\n")
    broken.chmod(0o755)
    monkeypatch.setattr(port_build, "CC", str(broken))
    with pytest.raises(RuntimeError, match="Python.h"):
        port_build.build()
    assert not list(tmp_path.glob("fastmodel-*"))
    assert PORT.ji.NATIVE_CLONE and PORT.ledger.NATIVE_CONFIRM
    assert PORT.Store.NATIVE_PUBLISH


def test_a_failed_first_build_reaches_the_caller(monkeypatch, tmp_path):
    """With no engine loaded yet, a failed build raises out of the
    model's clone: the Python body does not run in its place."""
    monkeypatch.setattr(port_build, "_module", None)
    monkeypatch.setattr(port_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(port_build, "CC", str(tmp_path / "no-such-gcc"))
    monkeypatch.setattr(port_ji, "_fm", None)
    job = mk_job(PORT)
    with pytest.raises(RuntimeError, match="fastmodel build failed"):
        job.clone()
    assert port_ji.NATIVE_CLONE


def test_build_is_keyed_and_reused(monkeypatch, tmp_path):
    """One build a key: a second build() returns the same library without
    compiling, and a changed flag is another key."""
    monkeypatch.setattr(port_build, "BUILD_DIR", tmp_path)
    first = port_build.build()
    assert first.parent == tmp_path and first.exists()

    def no_compile(*args, **kwargs):
        raise AssertionError("an unchanged key compiled again")
    monkeypatch.setattr(port_build.subprocess, "run", no_compile)
    assert port_build.build() == first
    monkeypatch.setattr(port_build, "CFLAGS", port_build.CFLAGS + ["-g"])
    assert port_build.library_path() != first
