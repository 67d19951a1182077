"""The port's plain gang_allocate against volcano_tpu's scan
(ops.allocate.gang_allocate) and its Pallas kernel run in interpret mode
(ops.pallas_allocate.gang_allocate_pallas(interpret=True)).

Scenarios follow tests/test_namespace_fairness.py:_scenario: tight capacity
that forces rollbacks, finite queue budgets that drop pools, several
namespaces with random weights and prior allocations; plus topology
buckets with a pack bonus, pipelining on and off, and both namespace
orders; plus per-task domain slots (``task_slot``/``slot_ok``): gangs
rotating over zones, an all-false row, slots with buckets, and slots under
tight capacity with rollbacks. Every case is held to exact equality of assign, pipelined, ready
and kept: none needs the Pallas near-tie contract of
tests/test_pallas_allocate.py, because on the CPU the port's score rounds
like the reference's at every argmax these fixtures reach (the pack bonus
is a multiple of 1/1024, which the Pallas kernel carries exactly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.ops.allocate import gang_allocate as ref_gang_allocate
from volcano_tpu.ops.pallas_allocate import gang_allocate_pallas
from volcano_tpu.ops.score import ScoreWeights as RefWeights
from volcano_tpu.utils.synth import synth_arrays
from volcano_tpu_torch import convert
from volcano_tpu_torch.ops.allocate import (gang_allocate, make_pool_select,
                                            namespace_share, queue_overused,
                                            queue_share)
from volcano_tpu_torch.utils.synth import zone_slots


def _scenario(seed, buckets=False):
    rng = np.random.default_rng(seed)
    n_tasks = int(rng.integers(30, 250))
    n_nodes = int(rng.integers(8, 96))
    gang = int(rng.integers(1, 7))
    sa = synth_arrays(n_tasks, n_nodes, gang_size=gang, seed=seed * 13 + 5,
                      utilization=float(rng.uniform(0.0, 0.8)),
                      rack_affinity=bool(rng.integers(0, 2)),
                      n_queues=int(rng.integers(1, 4)),
                      n_namespaces=int(rng.integers(2, 5)))
    choice = rng.integers(0, 3)
    if choice == 0:      # tight capacity: rollbacks interleave namespaces
        sa.node_idle *= rng.uniform(0.05, 0.3)
        sa.node_future[:] = sa.node_idle
    elif choice == 1:    # finite queue budgets: overuse drops pools
        q = sa.queue_deserved.shape[0]
        totals = sa.node_idle.sum(axis=0)
        sa.queue_deserved[:] = totals[None, :] * \
            rng.uniform(0.05, 0.6, (q, 1)).astype(np.float32)
    ns = sa.ns_weight.shape[0]
    sa.ns_weight[:] = rng.choice([1.0, 1.0, 2.0, 5.0], ns)
    sa.ns_alloc0[:] = (sa.ns_total[None, :]
                       * rng.uniform(0.0, 0.2, (ns, 1))).astype(np.float32)
    if buckets:          # task-topology buckets, uniform within a group
        g = sa.group_req.shape[0]
        gb = np.where(np.arange(g) % 3 == 0, -1, np.arange(g) % 4)
        sa.task_bucket[:] = np.where(sa.task_valid, gb[sa.task_group], -1)
        sa.group_pack_bonus[:] = rng.choice([0.5, 5.0, 20.0], g)
    weights = RefWeights.make(sa.group_req.shape[1],
                              binpack=float(rng.uniform(0, 2)),
                              least=float(rng.uniform(0, 2)),
                              balanced=float(rng.uniform(0, 2)))
    return sa, weights


def _port(sa, weights, **kw):
    t, w = convert.from_reference(
        {name: getattr(sa, name) for name in convert.FIELDS},
        {f: np.asarray(getattr(weights, f)) for f in weights._fields}, "cpu")
    return gang_allocate(*convert.args(t), w, **kw)


def _assert_equal(ref, got, ctx):
    for name, a, b in zip(("assign", "pipelined", "ready", "kept"),
                          ref[:4], got[:4]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      f"{name}: {ctx}")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ns_live", [False, True])
@pytest.mark.parametrize("buckets", [False, True])
def test_matches_scan(seed, ns_live, buckets):
    sa, weights = _scenario(seed, buckets)
    allow_pipeline = seed % 2 == 0
    ref = ref_gang_allocate(*[jnp.asarray(a) for a in sa.args], weights,
                            allow_pipeline=allow_pipeline, ns_live=ns_live)
    got = _port(sa, weights, allow_pipeline=allow_pipeline, ns_live=ns_live)
    ctx = f"seed={seed} ns_live={ns_live} pipeline={allow_pipeline}"
    _assert_equal(ref, got, ctx)
    rs, gs = ref[4], got[4]
    for name in ("idle", "future", "q_alloc", "ns_alloc", "p_cursor"):
        np.testing.assert_array_equal(getattr(gs, name).numpy(),
                                      np.asarray(getattr(rs, name)),
                                      f"{name}: {ctx}")
    np.testing.assert_array_equal(gs.n_tasks.numpy(), np.asarray(rs.n_tasks))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("ns_live", [False, True])
def test_matches_pallas_interpret(seed, ns_live):
    sa, weights = _scenario(seed + 20, buckets=seed % 2 == 1)
    allow_pipeline = seed != 2
    ref = gang_allocate_pallas(*[jnp.asarray(a) for a in sa.args], weights,
                               allow_pipeline=allow_pipeline, ns_live=ns_live,
                               interpret=True)
    got = _port(sa, weights, allow_pipeline=allow_pipeline, ns_live=ns_live)
    _assert_equal(ref, got, f"seed={seed} ns_live={ns_live}")


def test_pool_select_pieces_match_reference():
    from volcano_tpu.ops import allocate as ref
    rng = np.random.default_rng(3)
    q_alloc = rng.choice([0.0, 10.0, 50.0], (4, 3)).astype(np.float32)
    q_des = rng.choice([0.0, 20.0, np.inf], (4, 3)).astype(np.float32)
    eps = np.full(3, 0.1, np.float32)
    ns_alloc = rng.choice([0.0, 5.0, 9.0], (3, 3)).astype(np.float32)
    ns_total = np.array([100.0, 0.0, 50.0], np.float32)
    ns_weight = np.array([1.0, 2.0, 5.0], np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        queue_share(t(q_alloc), t(q_des)).numpy(),
        np.asarray(ref.queue_share(jnp.asarray(q_alloc), jnp.asarray(q_des))))
    np.testing.assert_array_equal(
        queue_overused(t(q_alloc), t(q_des), t(eps)).numpy(),
        np.asarray(ref.queue_overused(jnp.asarray(q_alloc),
                                      jnp.asarray(q_des), jnp.asarray(eps))))
    np.testing.assert_array_equal(
        namespace_share(t(ns_alloc), t(ns_total), t(ns_weight)).numpy(),
        np.asarray(ref.namespace_share(jnp.asarray(ns_alloc),
                                       jnp.asarray(ns_total),
                                       jnp.asarray(ns_weight))))
    pools = [np.array(x, np.int32) for x in
             ([0, 1, 2, 3, 0, 0], [0, 0, 1, 1, 2, 0], [0, 3, 5, 8, 9, 0],
              [3, 2, 3, 1, 2, 0])]
    for ns_live in (False, True):
        for cursor in ([0] * 6, [3, 2, 0, 0, 0, 0], [3, 2, 3, 1, 2, 0]):
            cur = np.array(cursor, np.int32)
            want = ref.make_pool_select(
                jnp.asarray(q_des), *(jnp.asarray(p) for p in pools),
                jnp.asarray(ns_weight), jnp.asarray(ns_total),
                jnp.asarray(eps), ns_live)(
                    jnp.asarray(q_alloc), jnp.asarray(ns_alloc),
                    jnp.asarray(cur))
            got = make_pool_select(
                t(q_des), *(t(p) for p in pools), t(ns_weight), t(ns_total),
                t(eps), ns_live)(t(q_alloc), t(ns_alloc), t(cur))
            assert [int(x) for x in got] == [int(x) for x in want]


SLOT_KINDS = ["rotating", "all_false", "buckets", "tight"]


def slot_scenario(kind, seed=0):
    """(SynthArrays, reference weights, task_slot, slot_ok) for one slot
    case: zones of 4 nodes' stride, every job rotating its tasks over the
    zones (``rotating``), every other job with the last task of every
    second such job on the all-false row (``all_false``), every other job
    with topology buckets and a pack bonus (``buckets``), or every other
    job over small nodes that cannot hold every gang (``tight``)."""
    rng = np.random.default_rng(seed + 70)
    sa = synth_arrays(int(rng.integers(150, 300)), int(rng.integers(24, 80)),
                      gang_size=int(rng.integers(3, 7)), seed=seed * 11 + 1,
                      utilization=float(rng.uniform(0.1, 0.5)))
    if kind == "buckets":
        g = sa.group_req.shape[0]
        gb = np.where(np.arange(g) % 3 == 0, -1, np.arange(g) % 4)
        sa.task_bucket[:] = np.where(sa.task_valid, gb[sa.task_group], -1)
        sa.group_pack_bonus[:] = rng.choice([0.5, 5.0, 20.0], g)
    if kind == "tight":
        sa.node_idle *= np.float32(0.1)
        sa.node_future[:] = sa.node_idle
    task_slot, slot_ok = zone_slots(
        sa, zones=4, every=1 if kind == "rotating" else 2,
        unsat_every=2 if kind == "all_false" else 0, seed=seed)
    weights = RefWeights.make(sa.group_req.shape[1],
                              binpack=float(rng.uniform(0, 2)),
                              least=float(rng.uniform(0, 2)),
                              balanced=float(rng.uniform(0, 2)))
    return sa, weights, task_slot, slot_ok


def slot_aims_reached(sa, task_slot, slot_ok, out, kind):
    """Every placement lies in its task's slot row, and each case reaches
    what it was built for."""
    assign, ready, kept = (np.asarray(x) for x in (out[0], out[2], out[3]))
    placed = np.flatnonzero(assign >= 0)
    assert placed.size > 0
    assert slot_ok[task_slot[placed], assign[placed]].all()
    jobs = int((sa.job_n_tasks > 0).sum())
    if kind == "all_false":
        unsat_jobs = np.unique(sa.task_job[task_slot == slot_ok.shape[0] - 2])
        assert unsat_jobs.size and not (ready | kept)[unsat_jobs].any()
    if kind == "tight":
        assert not (ready | kept)[:jobs].all(), "no gang rolled back"


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("kind", SLOT_KINDS)
def test_slots_match_scan(kind, seed):
    sa, weights, task_slot, slot_ok = slot_scenario(kind, seed)
    allow_pipeline = seed == 0
    ref = ref_gang_allocate(*[jnp.asarray(a) for a in sa.args], weights,
                            allow_pipeline=allow_pipeline,
                            task_slot=jnp.asarray(task_slot),
                            slot_ok=jnp.asarray(slot_ok))
    got = _port(sa, weights, allow_pipeline=allow_pipeline,
                task_slot=torch.from_numpy(task_slot),
                slot_ok=torch.from_numpy(slot_ok))
    ctx = f"{kind} seed={seed}"
    _assert_equal(ref, got, ctx)
    for name in ("idle", "future", "n_tasks", "q_alloc", "p_cursor"):
        np.testing.assert_array_equal(getattr(got[4], name).numpy(),
                                      np.asarray(getattr(ref[4], name)),
                                      f"{name}: {ctx}")
    slot_aims_reached(sa, task_slot, slot_ok, got, kind)
