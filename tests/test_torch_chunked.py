"""The CUDA kernel's decision procedure, on the CPU: the port's
gang_allocate_chunked (a top-C candidate table refreshed by rule) against
the JAX package's chunked scan (volcano_tpu.ops.allocate.
gang_allocate_chunked, same chunk) and against the port's plain loop.

Scenarios follow tests/test_kernel_fuzz.py: mixed gangs (several groups in
one job, padding tasks inside a job's span, pod caps), finite queue
budgets, topology buckets with a pack bonus, releasing capacity with
pipelining on and off, tight capacity that forces rollbacks, gang 1 (a
refresh every step) and gang 20 (longer than the chunk, so the table
refreshes inside a job). Every case is held to exact equality of assign,
pipelined, ready, kept and the final node state, at chunks from 1 (a
refresh every step) to the kernel's 16. The per-task domain slot cases of
tests/test_torch_allocate.py (a slot change forces a refresh, whose mask
takes the slot's row) are held the same way, and their refresh counts to
the rule.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.ops.allocate import \
    gang_allocate_chunked as ref_gang_allocate_chunked
from volcano_tpu.ops.score import ScoreWeights as RefWeights
from volcano_tpu.utils.synth import synth_arrays
from volcano_tpu_torch import convert
from volcano_tpu_torch.ops.allocate import (gang_allocate,
                                            gang_allocate_chunked,
                                            rule_refreshes)
from tests.test_torch_allocate import SLOT_KINDS, slot_aims_reached, \
    slot_scenario

SCENARIOS = ["mixed_gangs", "budgets", "buckets", "releasing_pipelined",
             "releasing_no_pipeline", "tight", "gang1", "gang20"]


def _scenario(name):
    """(SynthArrays, reference weights, allow_pipeline) for one case."""
    seed = SCENARIOS.index(name)
    rng = np.random.default_rng(seed + 40)
    gang = {"gang1": 1, "gang20": 20}.get(name, int(rng.integers(3, 9)))
    n_tasks = int(rng.integers(200, 480)) if gang > 1 else 160
    sa = synth_arrays(n_tasks, int(rng.integers(40, 128)), gang_size=gang,
                      seed=seed * 7 + 3,
                      utilization=float(rng.uniform(0.2, 0.7)),
                      n_queues=3 if name == "budgets" else 1,
                      node_pad_to=128)
    n = sa.node_idle.shape[0]
    allow_pipeline = name != "releasing_no_pipeline"
    jobs = int((sa.job_n_tasks > 0).sum())
    if name == "mixed_gangs":
        # the second half of every other job takes the next job's group,
        # some tasks inside a span are padding, and pod caps bite
        for j in range(0, jobs - 1, 2):
            s = sa.job_task_start[j]
            sa.task_group[s + gang // 2:s + gang] = sa.task_group[s] + 1
        real = np.flatnonzero(sa.task_valid)
        sa.task_valid[rng.choice(real, len(real) // 6, replace=False)] = False
        sa.job_min_available[:jobs] = rng.integers(1, gang + 1, jobs)
        sa.node_max_tasks[:] = rng.integers(0, 40, n)
    elif name == "budgets":
        totals = sa.node_idle.sum(axis=0)
        sa.queue_deserved[:3] = totals[None, :] * \
            rng.uniform(0.05, 0.4, (3, 1)).astype(np.float32)
    elif name == "buckets":
        # neighbouring groups share a bucket, so mates count across jobs
        g = sa.group_req.shape[0]
        gb = np.where(np.arange(g) % 5 == 0, -1, (np.arange(g) // 2) % 3)
        sa.task_bucket[:] = np.where(sa.task_valid, gb[sa.task_group], -1)
        sa.group_pack_bonus[:] = rng.uniform(0.0, 8.0, g)
    elif name.startswith("releasing"):
        sa.node_idle *= np.float32(0.05)
        sa.node_future = sa.node_idle + np.abs(sa.node_future) * 3.0
    elif name in ("tight", "gang20"):
        sa.node_idle *= np.float32(0.12)
        sa.node_future[:] = sa.node_idle
    weights = RefWeights.make(sa.group_req.shape[1],
                              binpack=float(rng.uniform(0, 2)),
                              least=float(rng.uniform(0, 2)),
                              most=float(rng.uniform(0, 1)),
                              balanced=float(rng.uniform(0, 2)))
    return sa, weights, allow_pipeline


@functools.lru_cache(maxsize=None)
def _prepared(name):
    sa, weights, allow_pipeline = _scenario(name)
    t, w = convert.from_reference(
        {f: getattr(sa, f) for f in convert.FIELDS},
        {f: np.asarray(getattr(weights, f)) for f in weights._fields}, "cpu")
    plain = gang_allocate(*convert.args(t), w, allow_pipeline=allow_pipeline)
    return sa, weights, allow_pipeline, t, w, plain


@functools.lru_cache(maxsize=None)
def _reference(name, chunk):
    sa, weights, allow_pipeline, *_ = _prepared(name)
    out = ref_gang_allocate_chunked(*[jnp.asarray(a) for a in sa.args],
                                    weights, allow_pipeline=allow_pipeline,
                                    chunk=chunk)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("chunk", [1, 2, 5, 16])
@pytest.mark.parametrize("name", SCENARIOS)
def test_chunked_equals_reference_and_plain(name, chunk):
    sa, _, allow_pipeline, t, w, plain = _prepared(name)
    got = gang_allocate_chunked(*convert.args(t), w,
                                allow_pipeline=allow_pipeline, chunk=chunk)
    ref = _reference(name, chunk)
    ctx = f"{name} chunk={chunk}"
    for field, g, r, p in zip(("assign", "pipelined", "ready", "kept"),
                              got[:4], ref[:4], plain[:4]):
        np.testing.assert_array_equal(g.numpy(), r, f"{field} vs JAX: {ctx}")
        assert torch.equal(g, p), f"{field} vs plain: {ctx}"
    np.testing.assert_array_equal(got[4].idle.numpy(), ref[4], ctx)
    for field in ("idle", "future", "n_tasks", "q_alloc", "ns_alloc",
                  "p_cursor"):
        assert torch.equal(getattr(got[4], field), getattr(plain[4], field)), \
            f"{field}: {ctx}"
    # the cases must reach what they were built for
    placed = int((got[0] >= 0).sum())
    assert placed > 0, ctx
    if name == "releasing_pipelined":
        assert bool(got[1].any()), ctx
    if name in ("tight", "gang20"):
        assert not bool((got[2] | got[3])[:int((sa.job_n_tasks > 0).sum())]
                        .all()), f"no gang rolled back: {ctx}"


@pytest.mark.parametrize("name,chunk", [("gang1", 16), ("gang20", 16),
                                        ("gang20", 2), ("mixed_gangs", 16)])
def test_refresh_count_follows_the_rule(name, chunk):
    """gang 1 changes group every step, so every valid step refreshes; a
    gang of 20 refreshes at least once per job and once per chunk of
    served steps inside it; padding steps never refresh."""
    sa, _, allow_pipeline, t, w, _ = _prepared(name)
    refreshes = gang_allocate_chunked(*convert.args(t), w,
                                      allow_pipeline=allow_pipeline,
                                      chunk=chunk)[5]["total"]
    jobs = int((sa.job_n_tasks > 0).sum())
    valid_steps = int(sa.task_valid.sum())
    assert refreshes <= valid_steps
    if name == "gang1":
        assert refreshes == valid_steps
    elif name == "gang20":
        assert refreshes >= jobs * -(-20 // chunk)
    else:
        assert refreshes >= jobs


@pytest.mark.parametrize("name,chunk,cause", [
    ("mixed_gangs", 16, "forced"), ("mixed_gangs", 2, "forced"),
    ("mixed_gangs", 16, "in_job"), ("gang20", 16, "in_job"),
    ("buckets", 16, "bucket_carried"), ("buckets", 2, "bucket_carried")])
def test_scenarios_reach_the_refresh_causes(name, chunk, cause):
    """The scenarios drive the table's rarer refreshes: a rollback followed
    by a job of the same group and bucket (mixed gangs, whose jobs end in
    the next job's group) refreshes on the force flag alone; a group
    change inside a job's span, or a gang longer than the chunk, refreshes
    after a job's first step; a job in the bucket of the job before
    refreshes with that bucket's pack row."""
    _, _, allow_pipeline, t, w, _ = _prepared(name)
    counts = gang_allocate_chunked(*convert.args(t), w,
                                   allow_pipeline=allow_pipeline,
                                   chunk=chunk)[5]
    assert counts[cause] > 0, counts
    assert counts[cause] <= counts["total"]


@functools.lru_cache(maxsize=None)
def _slot_prepared(kind):
    sa, weights, task_slot, slot_ok = slot_scenario(kind, seed=3)
    arrays = {f: getattr(sa, f) for f in convert.FIELDS}
    arrays.update(task_slot=task_slot, slot_ok=slot_ok)
    t, w = convert.from_reference(
        arrays, {f: np.asarray(getattr(weights, f)) for f in weights._fields},
        "cpu")
    plain = gang_allocate(*convert.args(t), w, **convert.slot_kwargs(t))
    return sa, weights, task_slot, slot_ok, t, w, plain


@pytest.mark.parametrize("chunk", [1, 16])
@pytest.mark.parametrize("kind", SLOT_KINDS)
def test_slots_chunked_equals_reference_and_plain(kind, chunk):
    sa, weights, task_slot, slot_ok, t, w, plain = _slot_prepared(kind)
    got = gang_allocate_chunked(*convert.args(t), w, chunk=chunk,
                                **convert.slot_kwargs(t))
    ref = ref_gang_allocate_chunked(*[jnp.asarray(a) for a in sa.args],
                                    weights, chunk=chunk,
                                    task_slot=jnp.asarray(task_slot),
                                    slot_ok=jnp.asarray(slot_ok))
    ctx = f"{kind} chunk={chunk}"
    for field, g, r, p in zip(("assign", "pipelined", "ready", "kept"),
                              got[:4], ref[:4], plain[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      f"{field} vs JAX: {ctx}")
        assert torch.equal(g, p), f"{field} vs plain: {ctx}"
    np.testing.assert_array_equal(got[4].idle.numpy(), np.asarray(ref[4]),
                                  ctx)
    for field in ("future", "n_tasks", "q_alloc"):
        assert torch.equal(getattr(got[4], field), getattr(plain[4], field))
    slot_aims_reached(sa, task_slot, slot_ok, got, kind)


@pytest.mark.parametrize("kind", ["rotating", "all_false"])
def test_slot_refreshes_follow_the_rule(kind):
    """A rotating gang refreshes at every task; the count by the rule and
    the model's agree, and the slot cause counts the refreshes that only
    the slot change called for."""
    sa, _, task_slot, slot_ok, t, w, _ = _slot_prepared(kind)
    out = gang_allocate_chunked(*convert.args(t), w, chunk=16,
                                **convert.slot_kwargs(t))
    counts = out[5]
    jobs = int((sa.job_n_tasks > 0).sum())
    rolled = int((~(out[2] | out[3]))[:jobs].sum())
    by_rule = rule_refreshes(sa.task_group, sa.task_bucket, task_slot,
                             sa.job_task_start, sa.job_n_tasks)
    if rolled == 0:
        assert counts["total"] == by_rule
    else:
        # a rollback forces the next job's first refresh, which a group
        # change there calls for anyway
        assert counts["total"] >= by_rule
    rotating = np.isin(sa.task_job, np.flatnonzero(
        np.bincount(sa.task_job[task_slot < slot_ok.shape[0] - 1],
                    minlength=sa.job_n_tasks.shape[0])))
    steps_in_rotating = int((rotating & sa.task_valid).sum())
    assert counts["total"] >= steps_in_rotating
    assert 0 < counts["slot"] < counts["total"]


@pytest.mark.parametrize("outside", ["below", "above"])
@pytest.mark.parametrize("route", ["plain", "chunked"])
def test_slot_outside_rows_admits_no_node(route, outside):
    """A slot outside 0..S admits no node, as the kernel's refresh does:
    the all-false case with its empty row's tasks moved to slot -1 or
    S + 1 places exactly what it placed on the empty row."""
    sa, _, task_slot, slot_ok, t, w, plain = _slot_prepared("all_false")
    S = slot_ok.shape[0] - 1
    empty = task_slot == S - 1
    assert empty.any() and not slot_ok[S - 1].any()
    moved = np.where(empty, -1 if outside == "below" else S + 1, task_slot)
    kw = dict(task_slot=torch.from_numpy(moved.astype(np.int32)),
              slot_ok=torch.from_numpy(slot_ok))
    got = gang_allocate(*convert.args(t), w, **kw) if route == "plain" \
        else gang_allocate_chunked(*convert.args(t), w, chunk=16, **kw)
    for field, g, p in zip(("assign", "pipelined", "ready", "kept"),
                           got[:4], plain[:4]):
        assert torch.equal(g, p), f"{field}: {route} {outside}"
    for field in ("idle", "future", "n_tasks", "q_alloc"):
        assert torch.equal(getattr(got[4], field), getattr(plain[4], field))
