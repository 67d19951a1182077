"""The native CPU solver (volcano_tpu_torch/native/solver.cc through
ops/native.py:gang_allocate_native) and the solver conf's ``kernel:
native`` route.

Against the port's plain loop (ops/allocate.py:gang_allocate): exact
equality of assign, pipelined, ready, kept and the final state, on
utils/synth.py fixtures across seeds at R = 4, 9 and 20, on the
scenarios of tests/test_torch_chunked.py (padding tasks inside a job's
span, pod caps, budgets, buckets, pipelining, rollbacks, gangs longer
than the table) and on the domain-slot cases of
tests/test_torch_allocate.py, at the default table size and at C2 = 8.

Against the JAX package: the cases of tests/test_native_kernel.py, held
to volcano_tpu.ops.allocate.gang_allocate (the scan) and
volcano_tpu.ops.native.gang_allocate_native under the near-tie contract
(ready and kept exact, equal placements and pipelines per job, a
feasible replay), and to the port's plain loop exactly. The reference's
solver contracts its score chain as XLA does (fmaf) and the port's rounds
once per operation, so the two may pick differently between nodes whose
scores tie to within an ulp.

Whole cycles: ``kernel: native`` in Scheduler(store, device="cpu") binds
what the port's default route (the plain loop) and the reference's
Scheduler bind on the same seeded store, and counts its launches as
``volcano_solver_kernel_runs_total{kernel="native"}``.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_kernel_fuzz import _mutate
from tests.test_torch_allocate import SLOT_KINDS, slot_scenario
from tests.test_torch_chunked import SCENARIOS, _prepared
from tests.test_torch_cycle import FOUR_QUEUES, PORT, REF, make_spec, populate
from tests.test_torch_cycle import conf as cycle_conf
from tests.test_torch_cycle import run as cycle_run
from tests.test_torch_prune import constrained_cluster, solver_conf
from tests.test_torch_prune import run as prune_run
from tests.test_torch_prune import uniform_cluster
from volcano_tpu.ops.allocate import gang_allocate as ref_scan
from volcano_tpu.ops.allocate import gang_allocate_chunked as ref_chunked
from volcano_tpu.ops.native import gang_allocate_native as ref_native
from volcano_tpu.ops.score import ScoreWeights as RefWeights
from volcano_tpu.utils.synth import synth_arrays as ref_synth_arrays
import volcano_tpu.ops.native as ref_native_mod
from volcano_tpu_torch import convert
from volcano_tpu_torch.metrics import metrics as m
from volcano_tpu_torch.native import build
from volcano_tpu_torch.ops import native
from volcano_tpu_torch.ops.allocate import gang_allocate
from volcano_tpu_torch.ops.native import gang_allocate_native
from volcano_tpu_torch.ops.score import ScoreWeights
from volcano_tpu_torch.trace import tracer
from volcano_tpu_torch.utils.synth import synth_arrays

STATE = ("idle", "future", "n_tasks", "q_alloc", "ns_alloc", "p_cursor")


def _port_inputs(sa, weights):
    """The port's CPU tensors and weights for SynthArrays ``sa`` and
    reference weights."""
    return convert.from_reference(
        {f: getattr(sa, f) for f in convert.FIELDS},
        {f: np.asarray(getattr(weights, f)) for f in weights._fields}, "cpu")


def assert_equal_to_plain(got, plain, ctx):
    for field, g, p in zip(("assign", "pipelined", "ready", "kept"),
                           got[:4], plain[:4]):
        assert g.dtype == p.dtype and torch.equal(g, p), f"{field}: {ctx}"
    for field in STATE:
        assert torch.equal(getattr(got[4], field), getattr(plain[4], field)), \
            f"{field}: {ctx}"


def hold_to_plain(t, w, ctx, **kw):
    """The native solver against the plain loop on the same tensors;
    returns the native outputs."""
    got = gang_allocate_native(*convert.args(t), w, **kw)
    assert_equal_to_plain(got, gang_allocate(*convert.args(t), w, **kw), ctx)
    return got


# -- exact against the plain loop ---------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_fuzz_equals_plain(seed):
    rng = np.random.default_rng(seed + 300)
    sa = synth_arrays(int(rng.integers(40, 400)), int(rng.integers(8, 160)),
                      gang_size=int(rng.integers(1, 9)), seed=seed * 5 + 2,
                      utilization=float(rng.uniform(0.0, 0.8)),
                      rack_affinity=bool(rng.integers(0, 2)),
                      n_queues=int(rng.integers(1, 5)),
                      n_namespaces=int(rng.integers(1, 3)))
    sa = _mutate(sa, rng)
    w = RefWeights.make(sa.group_req.shape[1],
                        binpack=float(rng.uniform(0, 2)),
                        least=float(rng.uniform(0, 2)),
                        most=float(rng.uniform(0, 1)),
                        balanced=float(rng.uniform(0, 2)))
    t, pw = _port_inputs(sa, w)
    hold_to_plain(t, pw, f"seed={seed}",
                  allow_pipeline=bool(rng.integers(0, 2)),
                  ns_live=bool(rng.integers(0, 2)))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("r", [4, 9, 20])
def test_resource_counts_equal_plain(r, seed):
    """Every R: a plain shape, tight capacity that rolls gangs back, and
    topology buckets with a pack bonus."""
    rng = np.random.default_rng(seed + 900)
    sa = synth_arrays(300, 64, gang_size=int(rng.integers(2, 9)), r=r,
                      seed=seed, utilization=float(rng.uniform(0.2, 0.7)))
    if seed == 1:
        sa.node_idle *= np.float32(0.3)
        sa.node_future[:] = sa.node_idle
    if seed == 2:
        sa.task_bucket[:] = rng.integers(-1, 4, sa.task_bucket.shape[0])
        sa.group_pack_bonus[:] = 5.0
    t = convert.as_tensors({f: getattr(sa, f) for f in convert.FIELDS},
                           "cpu")
    w = ScoreWeights.make(r, binpack=1.0, least=1.0, most=0.3, balanced=1.0)
    got = hold_to_plain(t, w, f"R={r} seed={seed}")
    assert int((got[0] >= 0).sum()) > 0
    if seed == 1:
        jobs = int((sa.job_n_tasks > 0).sum())
        assert not bool((got[2] | got[3])[:jobs].all()), "no rollback"


@pytest.mark.parametrize("c2", [8, 256])
@pytest.mark.parametrize("name", SCENARIOS)
def test_chunked_scenarios_equal_plain(name, c2, monkeypatch):
    monkeypatch.setattr(native, "C2", c2)
    _, _, allow_pipeline, t, w, plain = _prepared(name)
    got = gang_allocate_native(*convert.args(t), w,
                               allow_pipeline=allow_pipeline)
    assert_equal_to_plain(got, plain, f"{name} C2={c2}")


@pytest.mark.parametrize("c2", [8, 256])
@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("kind", SLOT_KINDS)
def test_slots_equal_plain(kind, seed, c2, monkeypatch):
    monkeypatch.setattr(native, "C2", c2)
    sa, weights, task_slot, slot_ok = slot_scenario(kind, seed)
    t, w = _port_inputs(sa, weights)
    got = hold_to_plain(t, w, f"{kind} seed={seed} C2={c2}",
                        allow_pipeline=seed == 0,
                        task_slot=torch.from_numpy(task_slot),
                        slot_ok=torch.from_numpy(slot_ok))
    placed = np.flatnonzero(got[0].numpy() >= 0)
    assert placed.size and slot_ok[task_slot[placed],
                                   got[0].numpy()[placed]].all()


def test_one_content_shares_its_table():
    """Gangs of one content (request, mask, static row, bonus) serve from
    one table: a refresh each C2 placements, not one a job; a rollback
    drops the table."""
    sa = synth_arrays(64 * 8, 256, gang_size=8, seed=4, utilization=0.0)
    sa.group_req[:] = sa.group_req[0]
    sa.group_static_score[:] = 0.0
    t = convert.as_tensors({f: getattr(sa, f) for f in convert.FIELDS},
                           "cpu")
    w = ScoreWeights.make(4, binpack=1.0)
    got = hold_to_plain(t, w, "one content")
    refreshes, rollbacks = gang_allocate_native.last_stats.tolist()
    placed = int((got[0] >= 0).sum())
    c2 = max(8, min(native.C2, sa.node_idle.shape[0]))
    assert placed == 512 and rollbacks == 0
    assert refreshes == -(-placed // c2)


# -- the reference's cases (tests/test_native_kernel.py) ----------------------

def hold_to_reference(sa, weights, ctx, allow_pipeline=True, ns_live=False,
                      reference=None, plain=True):
    """The near-tie contract against the reference's scan (or the given
    ``reference`` outputs) and its native solver, and exact equality with
    the port's plain loop when ``plain``."""
    t, w = _port_inputs(sa, weights)
    kw = dict(allow_pipeline=allow_pipeline, ns_live=ns_live)
    got = gang_allocate_native(*convert.args(t), w, **kw)
    if plain:
        assert_equal_to_plain(got, gang_allocate(*convert.args(t), w, **kw),
                              ctx)
    refs = [reference if reference is not None else ref_scan(
        *[jnp.asarray(a) for a in sa.args], weights, **kw)[:4],
        ref_native(*sa.args, weights, **kw)[:4]]
    a, p, ready, kept = (x.numpy() for x in got[:4])
    job = np.asarray(sa.task_job)
    for ra, rp, rr, rk in ([np.asarray(x) for x in r] for r in refs):
        np.testing.assert_array_equal(ready, rr, ctx)
        np.testing.assert_array_equal(kept, rk, ctx)
        for ours, theirs in ((a >= 0, ra >= 0), (p, rp)):
            np.testing.assert_array_equal(
                np.bincount(job[ours], minlength=len(ready)),
                np.bincount(job[theirs], minlength=len(ready)), ctx)
    # the replay: the last placement onto a node's idle capacity fit, so
    # every node placed on leaves at least -eps idle
    req = np.asarray(sa.group_req, np.float32)[np.asarray(sa.task_group)]
    on = (a >= 0) & ~p
    left = np.asarray(sa.node_idle, np.float32).copy()
    np.add.at(left, a[on], -req[on])
    used = np.unique(a[on])
    assert (left[used] >= -np.asarray(sa.eps)[None, :] - 1e-3).all(), ctx
    return got


@pytest.mark.parametrize("seed", range(12))
def test_reference_fuzz(seed):
    rng = np.random.default_rng(seed)
    sa = ref_synth_arrays(int(rng.integers(40, 400)),
                          int(rng.integers(8, 160)),
                          gang_size=int(rng.integers(1, 9)),
                          seed=seed * 7 + 1,
                          utilization=float(rng.uniform(0.0, 0.8)),
                          rack_affinity=bool(rng.integers(0, 2)),
                          n_queues=int(rng.integers(1, 5)))
    sa = _mutate(sa, rng)
    weights = RefWeights.make(sa.group_req.shape[1],
                              binpack=float(rng.uniform(0, 2)),
                              least=float(rng.uniform(0, 2)),
                              most=float(rng.uniform(0, 1)),
                              balanced=float(rng.uniform(0, 2)))
    hold_to_reference(sa, weights, f"seed={seed}",
                      allow_pipeline=bool(rng.integers(0, 2)))


@pytest.mark.parametrize("seed", range(4))
def test_reference_multi_namespace_ties(seed):
    rng = np.random.default_rng(seed + 500)
    sa = ref_synth_arrays(int(rng.integers(60, 300)),
                          int(rng.integers(16, 120)),
                          gang_size=int(rng.integers(1, 6)),
                          seed=seed * 13 + 5,
                          utilization=float(rng.uniform(0.0, 0.6)),
                          n_queues=int(rng.integers(1, 4)), n_namespaces=3)
    weights = RefWeights.make(sa.group_req.shape[1], binpack=1.0)
    for ns_live in (False, True):
        hold_to_reference(sa, weights, f"seed={seed} ns_live={ns_live}",
                          ns_live=ns_live, plain=ns_live)


def test_reference_small_c2(monkeypatch):
    monkeypatch.setattr(native, "C2", 8)
    monkeypatch.setattr(ref_native_mod, "_C2", 8)
    rng = np.random.default_rng(7)
    sa = _mutate(ref_synth_arrays(200, 60, gang_size=4, seed=3,
                                  utilization=0.5), rng)
    weights = RefWeights.make(sa.group_req.shape[1], binpack=1.0, least=1.0)
    hold_to_reference(sa, weights, "C2=8")


@pytest.mark.parametrize("seed", range(10))
def test_reference_near_tie_stress(seed):
    rng = np.random.default_rng(seed)
    sa = ref_synth_arrays(int(rng.integers(100, 400)),
                          int(rng.integers(12, 40)),
                          gang_size=int(rng.integers(12, 25)),
                          seed=seed * 13,
                          utilization=float(rng.uniform(0.1, 0.6)))
    sa = _mutate(sa, rng)
    sa.node_idle *= rng.uniform(0.15, 0.5)
    sa.node_future[:] = np.maximum(sa.node_future, sa.node_idle)
    weights = RefWeights.make(sa.group_req.shape[1],
                              binpack=float(rng.uniform(0, 2)),
                              least=float(rng.uniform(0, 2)),
                              most=float(rng.uniform(0, 1)),
                              balanced=float(rng.uniform(0, 2)))
    hold_to_reference(sa, weights, f"near-tie seed={seed}",
                      allow_pipeline=bool(rng.integers(0, 2)))


def test_reference_large_scale_ties():
    """10,000 tasks on 2,000 nodes with rack-affinity static scores,
    against the reference's chunked scan and native solver (the plain
    loops take tens of seconds there)."""
    sa = ref_synth_arrays(10_000, 2_000, gang_size=8, seed=42,
                          utilization=0.3, rack_affinity=True)
    weights = RefWeights.make(sa.group_req.shape[1], binpack=1.0)
    chunked = ref_chunked(*[jnp.asarray(a) for a in sa.args], weights)[:4]
    got = hold_to_reference(sa, weights, "large-scale", reference=chunked,
                            plain=False)
    assert int((got[0] >= 0).sum()) > 0


def test_reference_rollback_heavy():
    sa = ref_synth_arrays(320, 40, gang_size=8, seed=11, utilization=0.1)
    sa.node_idle *= 0.08
    sa.node_future[:] = sa.node_idle
    weights = RefWeights.make(sa.group_req.shape[1], binpack=1.0,
                              balanced=1.0)
    for allow_pipeline in (True, False):
        got = hold_to_reference(sa, weights, f"pipeline={allow_pipeline}",
                                allow_pipeline=allow_pipeline)
    assert gang_allocate_native.last_stats.tolist()[1] > 0, "no rollback"


def _stale_gen_shape(seed, scale, bucket_period=0):
    """One group for every job (a rollback leaves a table the next gang
    would reuse), tight capacity, gangs of 12 over a table of 8."""
    sa = ref_synth_arrays(12 * 8, 24, gang_size=12, seed=seed,
                          utilization=0.2)
    sa.task_group[:] = 0
    sa.node_idle = sa.node_idle * scale
    sa.node_future = np.maximum(sa.node_future * 0.2, sa.node_idle)
    if bucket_period:
        sa.task_bucket = ((np.arange(len(sa.task_bucket)) // bucket_period)
                          % 2).astype(np.int32)
    return sa


_STALE_GEN_WEIGHTS = dict(binpack=1.3, least=0.7, balanced=0.9)


@pytest.mark.parametrize("seed,scale", [(3, 0.6), (4, 0.4), (7, 0.6),
                                        (13, 0.6), (14, 0.6)])
def test_reference_rollback_gang_over_c2(seed, scale, monkeypatch):
    monkeypatch.setattr(native, "C2", 8)
    monkeypatch.setattr(ref_native_mod, "_C2", 8)
    sa = _stale_gen_shape(seed, scale)
    weights = RefWeights.make(sa.group_req.shape[1], **_STALE_GEN_WEIGHTS)
    hold_to_reference(sa, weights, f"gang>C2 seed={seed}")
    assert gang_allocate_native.last_stats.tolist()[1] > 0, "no rollback"


@pytest.mark.parametrize("seed,scale,period", [
    (3, 0.6, 10), (4, 0.4, 7), (6, 0.4, 10), (7, 0.6, 9), (13, 0.6, 10)])
def test_reference_rollback_alternating_buckets(seed, scale, period):
    sa = _stale_gen_shape(seed, scale, bucket_period=period)
    weights = RefWeights.make(sa.group_req.shape[1], **_STALE_GEN_WEIGHTS)
    hold_to_reference(sa, weights, f"alt-bucket seed={seed}")


# -- the route: kernel: native in whole cycles --------------------------------

def _native(conf_text):
    assert "kernel: scan" in conf_text
    return conf_text.replace("kernel: scan", "kernel: native")


@functools.lru_cache(maxsize=None)
def _spec():
    return make_spec(5, queues=FOUR_QUEUES, n_jobs=28)


def test_cycle_native_binds_as_plain_and_reference():
    conf = cycle_conf(binpack=True)
    ref = cycle_run(REF, _spec(), conf)
    plain_before = m.counter_total(m.SOLVER_KERNEL_RUNS, kernel="plain")
    plain = cycle_run(PORT, _spec(), conf, device="cpu")
    assert m.counter_total(m.SOLVER_KERNEL_RUNS, kernel="plain") \
        > plain_before
    launches = gang_allocate_native.launches
    before = {k: m.counter_total(m.SOLVER_KERNEL_RUNS, kernel=k)
              for k in ("native", "plain")}
    got = cycle_run(PORT, _spec(), _native(conf), device="cpu")
    assert got == plain == ref
    assert ref[0][0], "the case placed nothing"
    runs = gang_allocate_native.launches - launches
    assert runs > 0
    assert m.counter_total(m.SOLVER_KERNEL_RUNS, kernel="native") \
        - before["native"] == runs
    assert m.counter_total(m.SOLVER_KERNEL_RUNS, kernel="plain") \
        == before["plain"]


def _spans(span, name):
    found = [span] if span.name == name else []
    for child in span.children or ():
        found.extend(_spans(child, name))
    return found


def test_native_route_is_traced_as_the_kernel_span():
    """The traced cycle's ``kernel`` span names the native route, and its
    ``execute`` span's kernel_ms is the solver's own."""
    store = PORT.Store()
    populate(PORT, store, _spec())
    cache = PORT.Cache(store, binder=PORT.tu.FakeBinder(store))
    cache.run()
    tracer.enable()
    try:
        sched = PORT.Scheduler(store, scheduler_conf=_native(cycle_conf()),
                               cache=cache, device="cpu")
        sched.run_once()
        record = tracer.last_record()
    finally:
        tracer.disable()
        tracer.reset()
        cache.stop()
    kernels = _spans(record.root, "kernel")
    assert kernels and all(sp.tags["kernel"] == "native" for sp in kernels)
    executes = [sp.tags["kernel_ms"] for sp in _spans(record.root,
                                                      "execute")]
    places = sched.last_cycle["places"]
    assert executes == [ms for pl in places for ms in pl["launch_ms"]]
    assert all(ms > 0 for ms in executes)
    assert [pl["plan"] for pl in places] == ["host"] * len(places)
    assert all(len(pl["launch"]) == 2 for pl in places)


def test_cycle_native_constrained_and_pruned():
    """The slot path and the pruned launch take the native route too."""
    for cluster, args in ((constrained_cluster, {"prune.enable": "off"}),
                          (uniform_cluster, {"prune.enable": "true",
                                             "prune.k": 8})):
        ref = prune_run(REF, cluster, solver_conf(**args))
        launches = gang_allocate_native.launches
        got = prune_run(PORT, cluster, solver_conf(**args, kernel="native"),
                        device="cpu")
        assert got[0] == ref[0] and got[0][0]
        places = got[2]
        assert gang_allocate_native.launches - launches == \
            sum(pl["launches"] for pl in places)
        assert all(pl["plan"] == "host" for pl in places)
        if args["prune.enable"] == "true":
            assert got[1] and all(s["served"] for s in got[1])
        else:
            assert any(pl["slots"] for pl in places)


# -- the build ----------------------------------------------------------------

def test_missing_compiler_raises_with_its_error(monkeypatch):
    """No fall-back: a C++ compiler that is not there fails the build,
    the solver and the route, each with the compiler's error."""
    missing = "/nonexistent/bin/g++"
    monkeypatch.setattr(build, "CXX", missing)
    with pytest.raises(RuntimeError, match="native solver build failed") \
            as err:
        build.build_solver()
    assert missing in str(err.value)
    sa = synth_arrays(32, 8, gang_size=4, seed=1)
    t = convert.as_tensors({f: getattr(sa, f) for f in convert.FIELDS},
                           "cpu")
    with pytest.raises(RuntimeError, match=missing):
        gang_allocate_native(*convert.args(t), ScoreWeights.make(4))
    store = PORT.Store()
    populate(PORT, store, _spec())
    cache = PORT.Cache(store, binder=PORT.tu.FakeBinder(store))
    cache.run()
    try:
        sched = PORT.Scheduler(store, scheduler_conf=_native(cycle_conf()),
                               cache=cache, device="cpu")
        with pytest.raises(RuntimeError, match=missing):
            sched.run_once()
    finally:
        cache.stop()
    assert not any(p.spec.node_name for p in store.list("pods"))


def test_build_flags_and_output():
    flags = build.CXXFLAGS
    assert "-ffp-contract=off" in flags
    assert not any("fast-math" in f and not f.startswith("-fno")
                   for f in flags)
    assert not re.search(r"\bfmaf?\s*\(", build.SOLVER_SOURCE.read_text())
    path = build.build_solver()
    assert path.parent == build.BUILD_DIR and path.name.startswith(
        "libvcsolver-")
    assert build.solver_path() == path


def test_inputs_off_the_cpu_and_bad_shapes_raise():
    sa = synth_arrays(32, 8, gang_size=4, seed=1)
    t = convert.as_tensors({f: getattr(sa, f) for f in convert.FIELDS},
                           "cpu")
    args = convert.args(t)
    bad = list(args)
    bad[list(convert.FIELDS).index("node_alloc")] = t["node_alloc"][:-1]
    with pytest.raises(ValueError, match="node_alloc"):
        gang_allocate_native(*bad, ScoreWeights.make(4))
    bad = list(args)
    bad[0] = t["task_group"].to("meta")
    with pytest.raises(ValueError, match="CPU tensors"):
        gang_allocate_native(*bad, ScoreWeights.make(4))
    with pytest.raises(ValueError, match="both or neither"):
        gang_allocate_native(*args, ScoreWeights.make(4),
                             task_slot=torch.zeros(args[0].shape[0],
                                                   dtype=torch.int32))
