"""The port's object model and its encode against the JAX package's:
quantity parsing and Resource arithmetic, JobInfo/NodeInfo accounting, the
NodeArrays/TaskBatch/PredicateFeatures encodes and the placement solver's
inputs built from a session, and the scheduler-conf reader against PyYAML.

Both sides are built from one plain description made with numpy from a
seed (tests/test_torch_cycle.py ``make_spec``), each by its own builders
into its own store. Tolerance: exact everywhere (the same float32 and
float64 operations in the same order).
"""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_cycle import (CASES, PORT, REF, conf, make_spec,
                                    populate)
from volcano_tpu.framework import conf as ref_conf
from volcano_tpu.framework import open_session as ref_open_session
from volcano_tpu.models import arrays as ref_arrays
from volcano_tpu.models import quantity as ref_quantity
from volcano_tpu.models import resource as ref_resource
from volcano_tpu.models.job_info import TaskStatus as RefStatus
from volcano_tpu_torch.framework import conf as port_conf
from volcano_tpu_torch.framework import open_session as port_open_session
from volcano_tpu_torch.models import arrays as port_arrays
from volcano_tpu_torch.models import quantity as port_quantity
from volcano_tpu_torch.models import resource as port_resource
from volcano_tpu_torch.models.job_info import TaskStatus as PortStatus

ROOT = Path(__file__).resolve().parent.parent

QUANTITIES = ["0", "1", "100m", "1500m", "1.5", "2Gi", "512Mi", "10Ki",
              "1k", "3G", "1e3", "2.5e-3", "0.5Gi", "+4", "7Ti", "250u",
              "1Pi", 3, 2.5, "  8  ", "64"]


@pytest.mark.parametrize("q", QUANTITIES, ids=str)
def test_quantity_parsing(q):
    assert port_quantity.parse_quantity(q) == ref_quantity.parse_quantity(q)
    assert port_quantity.milli_value(q) == ref_quantity.milli_value(q)


def _resource_lists(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rl = {"cpu": f"{int(rng.integers(0, 8000))}m",
              "memory": f"{int(rng.integers(0, 64))}Gi",
              "pods": str(int(rng.integers(0, 110)))}
        if rng.uniform() < 0.5:
            rl["nvidia.com/gpu"] = str(int(rng.integers(0, 4)))
        if rng.uniform() < 0.3:
            rl["example.com/foo"] = f"{int(rng.integers(0, 3000))}m"
        out.append(rl)
    return out


def _res_state(r):
    return (r.milli_cpu, r.memory, dict(r.scalars), r.max_task_num)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_resource_arithmetic(seed):
    rls = _resource_lists(seed, 12)
    for a_rl, b_rl in zip(rls, rls[1:]):
        pa, pb = (port_resource.Resource.from_resource_list(x)
                  for x in (a_rl, b_rl))
        ra, rb = (ref_resource.Resource.from_resource_list(x)
                  for x in (a_rl, b_rl))
        assert _res_state(pa) == _res_state(ra)
        for default in (port_resource.ZERO, port_resource.INFINITY):
            for op in ("less", "less_equal", "less_partly",
                       "less_equal_partly", "equal"):
                assert getattr(pa, op)(pb, default) == \
                    getattr(ra, op)(rb, default), (op, default)
        assert _res_state(pa.clone().add(pb)) == _res_state(
            ra.clone().add(rb))
        assert _res_state(pa.clone().multi(0.37)) == _res_state(
            ra.clone().multi(0.37))
        assert _res_state(pa.fit_delta(pb)) == _res_state(ra.fit_delta(rb))
        pm, rm = pa.clone(), ra.clone()
        pm.set_max_resource(pb)
        rm.set_max_resource(rb)
        assert _res_state(pm) == _res_state(rm)
        if rb.less_equal(ra):
            assert _res_state(pa.clone().sub(pb)) == _res_state(
                ra.clone().sub(rb))
    assert port_resource.EPS == ref_resource.EPS


# -- cache state and accounting ------------------------------------------------

def _cache(pkg, spec):
    store = pkg.Store()
    populate(pkg, store, spec)
    cache = pkg.Cache(store, binder=pkg.tu.FakeBinder(store))
    cache.run()
    # snapshots and sessions only: no watch or executor after the list
    cache.stop()
    return cache


def _job_state(job):
    return (job.min_available, job.priority, job.queue, job.namespace,
            _res_state(job.allocated), _res_state(job.total_request),
            _res_state(job.pending_request), job.ready_task_num(),
            job.valid_task_num(), job.waiting_task_num(),
            sorted((s.name, len(ts)) for s, ts in
                   job.task_status_index.items() if ts),
            sorted((t.uid, t.status.name, t.node_name,
                    _res_state(t.resreq)) for t in job.tasks.values()))


def _node_state(node):
    return tuple(_res_state(getattr(node, a)) for a in
                 ("idle", "used", "releasing", "pipelined", "allocatable",
                  "capability")) + (node.ready(), sorted(node.tasks))


def _snapshot_state(snap):
    return ({u: _job_state(j) for u, j in snap.jobs.items()},
            {n: _node_state(x) for n, x in snap.nodes.items()},
            list(snap.node_list), sorted(snap.queues))


@pytest.mark.parametrize("case", ["running_and_surplus",
                                  "priorities_not_ready",
                                  "four_queues_three_ns"])
def test_snapshot_and_accounting(case):
    """The caches' snapshots agree, and so do JobInfo/NodeInfo after the
    same staged placements and rollbacks on both sides."""
    spec = make_spec(3, **CASES[case]["kw"])
    snaps = [_cache(pkg, spec).snapshot() for pkg in (REF, PORT)]
    assert _snapshot_state(snaps[0]) == _snapshot_state(snaps[1])

    rng = np.random.default_rng(4)
    names = list(snaps[0].node_list)
    moves = []
    for uid in sorted(snaps[0].jobs):
        for tid in sorted(snaps[0].jobs[uid].tasks):
            if rng.uniform() < 0.4:
                moves.append((uid, tid, names[int(rng.integers(len(names)))],
                              bool(rng.uniform() < 0.3)))
    for snap, status in zip(snaps, (RefStatus, PortStatus)):
        for uid, tid, node_name, pipelined in moves:
            job = snap.jobs[uid]
            task = job.tasks[tid]
            node = snap.nodes.get(node_name)
            if task.status != status.Pending or node is None:
                continue
            try:
                job.update_task_status(
                    task, status.Pipelined if pipelined
                    else status.Allocated)
                task.node_name = node_name
                node.add_task(task)
            except (RuntimeError, KeyError):
                job.update_task_status(task, status.Pending)
                task.node_name = ""
        # roll back every third staged task
        for i, (uid, tid, node_name, _) in enumerate(moves):
            task = snap.jobs[uid].tasks[tid]
            if i % 3 == 0 and task.node_name and \
                    task.status in (status.Allocated, status.Pipelined):
                snap.nodes[task.node_name].remove_task(task)
                snap.jobs[uid].update_task_status(task, status.Pending)
                task.node_name = ""
    assert _snapshot_state(snaps[0]) == _snapshot_state(snaps[1])


# -- the encode ----------------------------------------------------------------

def _fields(obj, names):
    out = {}
    for n in names:
        v = getattr(obj, n)
        if isinstance(v, ref_arrays.ResourceIndex) or \
                isinstance(v, port_arrays.ResourceIndex):
            v = (v.names, v.scales.tolist(), v.eps.tolist())
        elif isinstance(v, list):
            v = [getattr(x, "uid", x) for x in v]
        out[n] = v
    return out


def _assert_fields_equal(ref, port, names):
    rf, pf = _fields(ref, names), _fields(port, names)
    for n in names:
        r, p = rf[n], pf[n]
        if isinstance(r, np.ndarray) or isinstance(p, np.ndarray):
            np.testing.assert_array_equal(np.asarray(p), np.asarray(r),
                                          err_msg=n)
            assert np.asarray(p).dtype == np.asarray(r).dtype, n
        else:
            assert p == r, n


def _ordered_batch(pkg_allocate, ssn):
    """The allocate action's phase-A batch: (job, pending tasks up to the
    remaining gang minimum), in its namespace/queue/job order."""
    act = pkg_allocate.AllocateAction()
    batch = []
    for job in act._ordered_jobs(ssn):
        tasks = act._pending_tasks(ssn, job)
        if tasks:
            need = max(0, job.min_available - job.ready_task_num())
            batch.append((job, tasks[:need] if need else []))
    return batch


def _sessions(spec, conf_text):
    from volcano_tpu.actions import allocate as ref_allocate
    from volcano_tpu_torch.actions import allocate as port_allocate
    rc = ref_conf.parse_scheduler_conf(conf_text)
    pc = port_conf.parse_scheduler_conf(conf_text)
    rs = ref_open_session(_cache(REF, spec), rc.tiers, rc.configurations)
    ps = port_open_session(_cache(PORT, spec), pc.tiers, pc.configurations,
                           device="cpu")
    return (rs, _ordered_batch(ref_allocate, rs)), \
        (ps, _ordered_batch(port_allocate, ps))


NODE_FIELDS = ("rindex", "names", "name_to_idx", "n_pad", "valid", "idle",
               "used", "releasing", "pipelined", "allocatable", "capability",
               "max_tasks", "n_tasks", "revocable", "oversubscription")
BATCH_FIELDS = ("rindex", "tasks", "t_pad", "g_pad", "j_pad", "q_pad",
                "task_valid", "task_group", "task_job", "group_req",
                "group_first", "group_inverse", "job_uids",
                "job_min_available", "job_ready_base", "job_task_start",
                "job_task_end", "job_queue", "queue_names", "ns_names",
                "pool_queue", "pool_ns", "pool_job_start", "pool_njobs")
FEATURE_FIELDS = ("node_pairs", "group_requires", "group_require_counts",
                  "node_taints", "group_tolerates", "group_affinity_ok")

ENCODE_CASES = ["four_queues_ns_order", "selectors_and_taints",
                "running_and_surplus", "priorities_not_ready",
                "tight_capacity"]


@pytest.mark.parametrize("case", ENCODE_CASES)
def test_encode_matches_reference(case):
    """NodeArrays, TaskBatch and PredicateFeatures of the allocate batch,
    field by field, in the job/queue/namespace/pool order the kernel
    receives."""
    spec = make_spec(13, **CASES[case]["kw"])
    (rs, rbatch), (ps, pbatch) = _sessions(spec, conf(**CASES[case]["conf"]))
    assert [j.uid for j, _ in pbatch] == [j.uid for j, _ in rbatch]
    assert [[t.uid for t in ts] for _, ts in pbatch] == \
        [[t.uid for t in ts] for _, ts in rbatch]
    rr = ref_arrays.ResourceIndex.from_cluster(rs.nodes, rs.jobs)
    pr = port_arrays.ResourceIndex.from_cluster(ps.nodes, ps.jobs)
    rn = ref_arrays.NodeArrays.build(rs.nodes,
                                     [n.name for n in rs.node_list], rr)
    pn = port_arrays.NodeArrays.build(ps.nodes,
                                      [n.name for n in ps.node_list], pr)
    _assert_fields_equal(rn, pn, NODE_FIELDS)
    np.testing.assert_array_equal(pn.future_idle, rn.future_idle)
    rb = ref_arrays.TaskBatch.build(rbatch, rr)
    pb = port_arrays.TaskBatch.build(pbatch, pr)
    _assert_fields_equal(rb, pb, BATCH_FIELDS)
    assert pb.task_slot is None
    rf = ref_arrays.PredicateFeatures.build(rs.nodes, rn, rb)
    pf = port_arrays.PredicateFeatures.build(ps.nodes, pn, pb)
    for n in FEATURE_FIELDS:
        r, p = getattr(rf, n), getattr(pf, n)
        if r is None:
            assert p is None, n
        else:
            np.testing.assert_array_equal(p, r, err_msg=n)


@pytest.mark.parametrize("case", ENCODE_CASES)
def test_solver_inputs_match_reference(case):
    """The placement solver's inputs built from the sessions: the static
    [G, N] mask after every plugin's contribution, the static score, the
    queue budgets, the namespace state and the node tensors."""
    spec = make_spec(17, **CASES[case]["kw"])
    (rs, rbatch), (ps, pbatch) = _sessions(spec, conf(**CASES[case]["conf"]))
    narr, batch, gmask, static = rs.solver._build_context(
        rbatch, slot_tensors=True)
    _, _, dense = ps.solver._context(pbatch, torch.device("cpu"))
    np.testing.assert_array_equal(dense.static_mask().numpy(),
                                  np.asarray(gmask))
    a = dense.arrays
    np.testing.assert_array_equal(a["group_static_score"].numpy(),
                                  np.asarray(static))
    for port_key, ref_val in (("node_idle", narr.idle),
                              ("node_future", narr.future_idle),
                              ("node_alloc", narr.allocatable),
                              ("node_ntasks", narr.n_tasks),
                              ("node_max_tasks", narr.max_tasks),
                              ("task_group", batch.task_group),
                              ("group_req", batch.group_req),
                              ("eps", rs.solver.rindex.eps)):
        np.testing.assert_array_equal(a[port_key].numpy(), ref_val,
                                      err_msg=port_key)
    rw, pw = rs.solver.score_weights(), ps.solver.score_weights()
    for f in type(pw)._fields:
        np.testing.assert_array_equal(getattr(pw, f).numpy(),
                                      np.asarray(getattr(rw, f)), err_msg=f)
    # the queue budgets and namespace state, as the reference's _place
    # derives them from the same plugin hooks
    r = rs.solver.rindex.r
    q_des = np.full((batch.q_pad, r), np.inf, np.float32)
    q_al = np.zeros((batch.q_pad, r), np.float32)
    for qi, qname in enumerate(batch.queue_names):
        for fn in rs.solver.queue_budget_fns:
            budget = fn(qname, rs.solver.rindex)
            if budget is not None:
                q_al[qi], q_des[qi] = budget
                break
    np.testing.assert_array_equal(a["queue_deserved"].numpy(), q_des)
    np.testing.assert_array_equal(a["queue_alloc0"].numpy(), q_al)
    ns_live = rs.solver.namespace_budget_fn is not None \
        and len(batch.ns_names) > 1
    assert ps.solver._ns_live == ns_live
    assert ns_live == (case == "four_queues_ns_order")
    np.testing.assert_array_equal(
        a["ns_total"].numpy(), rs.solver.rindex.vec(rs.total_resource))


# -- the scheduler conf ----------------------------------------------------------

def _conf_texts():
    """Every string constant in tests/ and volcano_tpu/bench_suite.py that
    PyYAML reads as a scheduler conf (a mapping with tiers or actions)."""
    texts = {}
    paths = sorted((ROOT / "tests").glob("*.py")) + \
        [ROOT / "volcano_tpu" / "bench_suite.py"]
    for path in paths:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and ("tiers:" in node.value or "actions:" in node.value):
                try:
                    raw = yaml.safe_load(node.value)
                except yaml.YAMLError:
                    continue
                if isinstance(raw, dict) and ("tiers" in raw
                                              or "actions" in raw):
                    texts.setdefault(node.value,
                                     f"{path.name}:{node.lineno}")
    return texts


def _conf_summary(c):
    return (c.actions,
            [[(p.name, dict(p.enabled), dict(p.arguments)) for p in t.plugins]
             for t in c.tiers],
            {k: dict(v) for k, v in c.configurations.items()})


@functools.lru_cache(maxsize=1)
def _all_conf_texts():
    return sorted(_conf_texts().items(), key=lambda kv: kv[1])


def test_conf_texts_found():
    assert len(_all_conf_texts()) >= 20


@pytest.mark.parametrize("i", range(20))
def test_conf_reader_matches_pyyaml(i):
    """The port's YAML-subset reader gives what PyYAML gives, on a slice
    of the repo's conf texts (every text lands in one slice)."""
    texts = _all_conf_texts()
    for text, where in texts[i::20]:
        assert port_conf.load_yaml(text) == yaml.safe_load(text), where
        try:
            ref = ref_conf.parse_scheduler_conf(text)
        except (AttributeError, TypeError, KeyError):
            continue    # a fragment the reference refuses too
        assert _conf_summary(port_conf.parse_scheduler_conf(text)) == \
            _conf_summary(ref), where


def test_conf_reader_refuses_unsupported_yaml():
    for text in ("a: &x 1\nb: *x\n", "a: |\n  text\n", "a: !!str 1\n"):
        with pytest.raises(ValueError):
            port_conf.load_yaml(text)
    assert port_conf.load_yaml(port_conf.DEFAULT_SCHEDULER_CONF) == \
        yaml.safe_load(ref_conf.DEFAULT_SCHEDULER_CONF)
