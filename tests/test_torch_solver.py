"""The slice as a whole: DenseSolver(..., device="cpu").place() against
the JAX package's composition of the same steps on the same inputs
(carried across with convert.from_reference):
volcano_tpu/framework/solver.py:_fused_static_mask over the unique
capability rows, the selector and taint masks of volcano_tpu.ops.fit, the
proportion water-fill of volcano_tpu.ops.fairshare, the Pallas kernel in
interpret mode, and the decode of solver.py:1036-1048 written here in
numpy.

assign, pipelined, ready and kept must be equal exactly (no case here needs
the near-tie contract of tests/test_pallas_allocate.py); the per-job and
per-node totals to atol=1e-3 (float32 sums of the same rows, which the port
adds with index_add_ in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.framework.solver import _fused_static_mask
from volcano_tpu.ops.fairshare import proportion_waterfill
from volcano_tpu.ops.fit import selector_mask, taint_mask
from volcano_tpu.ops.pallas_allocate import gang_allocate_pallas
from volcano_tpu.ops.score import ScoreWeights as RefWeights
from volcano_tpu.utils.synth import synth_arrays
from volcano_tpu_torch import convert
from volcano_tpu_torch.framework.solver import (DenseSolver,
                                                PredicateFeatures,
                                                QueueBudgets)
from volcano_tpu_torch.ops.score import ScoreWeights


def _case(kind, seed):
    rng = np.random.default_rng(seed)
    kw = dict(gang_size=int(rng.integers(2, 6)), seed=seed,
              utilization=float(rng.uniform(0.1, 0.5)))
    if kind in ("queues", "all"):
        kw.update(n_queues=3, n_namespaces=2)
    sa = synth_arrays(int(rng.integers(120, 250)), int(rng.integers(30, 96)),
                      **kw)
    n = sa.node_idle.shape[0]
    real = int(sa.node_alloc[:, 0].astype(bool).sum())
    features = queues = None
    if kind in ("capability", "all"):
        # a third of the nodes are small: the large gangs cannot fit there
        small = rng.uniform(size=n) < 0.33
        sa.node_alloc[small, 0] = np.minimum(sa.node_alloc[small, 0], 3000.0)
        sa.node_idle[:] = np.minimum(sa.node_idle, sa.node_alloc)
        sa.node_future[:] = sa.node_idle
    if kind in ("features", "all"):
        g = sa.group_req.shape[0]
        node_pairs = (rng.uniform(size=(n, 6)) < 0.6).astype(np.float32)
        requires = (rng.uniform(size=(g, 6)) < 0.15).astype(np.float32)
        taints = (rng.uniform(size=(n, 3)) < 0.2).astype(np.float32)
        taints[real:] = 0.0
        features = (node_pairs, requires, requires.sum(1).astype(np.float32),
                    taints, (rng.uniform(size=(g, 3)) < 0.5)
                    .astype(np.float32))
    if kind in ("queues", "all"):
        r = sa.group_req.shape[1]
        request = np.zeros((3, r), np.float32)
        valid = sa.task_valid
        np.add.at(request, sa.job_queue[sa.task_job[valid]],
                  sa.group_req[sa.task_group[valid]])
        capability = np.full((3, r), np.inf, np.float32)
        capability[0] = sa.ns_total * 0.01
        queues = (np.array([1.0, 2.0, 3.0], np.float32), capability,
                  request * 3)
    weights = RefWeights.make(sa.group_req.shape[1], binpack=1.0,
                              least=float(rng.uniform(0, 2)))
    return sa, weights, features, queues


def _reference(sa, weights, features, queues, ns_live):
    uniq_cap, inv = np.unique(sa.node_alloc, axis=0, return_inverse=True)
    gmask = _fused_static_mask(
        jnp.asarray(sa.group_req), jnp.asarray(uniq_cap),
        jnp.asarray(inv.reshape(-1).astype(np.int32)),
        jnp.ones(sa.node_alloc.shape[0], bool), jnp.asarray(sa.eps))
    gmask = gmask & jnp.asarray(sa.group_mask)
    if features is not None:
        pairs, requires, counts, taints, tolerates = map(jnp.asarray, features)
        gmask = gmask & selector_mask(pairs, requires, counts)
        gmask = gmask & taint_mask(taints, tolerates)
    args = [jnp.asarray(a) for a in sa.args]
    args[4] = gmask
    if queues is not None:
        deserved, _ = proportion_waterfill(
            *map(jnp.asarray, queues), jnp.asarray(sa.ns_total))
        args[20] = args[20].at[:3].set(deserved)
    assign, pipelined, ready, kept, _ = gang_allocate_pallas(
        *args, weights, ns_live=ns_live, interpret=True)
    assign, pipelined = np.asarray(assign), np.asarray(pipelined)
    # the decode of framework/solver.py:1036-1048
    J, R = sa.job_min_available.shape[0], sa.group_req.shape[1]
    placed_all = np.flatnonzero(assign >= 0)
    rows_req = sa.group_req[sa.task_group[placed_all]]
    jt = np.zeros((J, R), np.float32)
    np.add.at(jt, sa.task_job[placed_all], rows_req)
    nv = np.zeros((sa.node_idle.shape[0], R), np.float32)
    alloc_rows = ~pipelined[placed_all].astype(bool)
    np.add.at(nv, assign[placed_all][alloc_rows], rows_req[alloc_rows])
    return (assign, pipelined, np.asarray(ready), np.asarray(kept), jt, nv,
            np.asarray(args[20]))


@pytest.mark.parametrize("kind", ["plain", "capability", "features",
                                  "queues", "all"])
@pytest.mark.parametrize("seed", [0, 1])
def test_place_matches_reference_composition(kind, seed):
    sa, weights, features, queues = _case(kind, seed)
    ns_live = kind in ("queues", "all") and seed == 1
    ref = _reference(sa, weights, features, queues, ns_live)
    arrays, w = convert.from_reference(
        {name: getattr(sa, name) for name in convert.FIELDS},
        {f: np.asarray(getattr(weights, f)) for f in weights._fields}, "cpu")
    solver = DenseSolver(
        arrays, w, "cpu",
        features=None if features is None else PredicateFeatures(*features),
        queues=None if queues is None else QueueBudgets(*queues))
    out = solver.place(ns_live=ns_live)
    assign, pipelined, ready, kept, jt, nv, deserved = ref
    np.testing.assert_array_equal(out.assign.numpy(), assign)
    np.testing.assert_array_equal(out.pipelined.numpy(), pipelined)
    np.testing.assert_array_equal(out.ready.numpy(), ready)
    np.testing.assert_array_equal(out.kept.numpy(), kept)
    np.testing.assert_allclose(out.queue_deserved.numpy(), deserved,
                               rtol=1e-6)
    np.testing.assert_allclose(out.job_total_vec.numpy(), jt, atol=1e-3)
    np.testing.assert_allclose(out.node_alloc_vec.numpy(), nv, atol=1e-3)
    J = ready.shape[0]
    np.testing.assert_array_equal(
        out.job_placed.numpy(),
        np.bincount(sa.task_job[assign >= 0], minlength=J)[:J])
    assert out.n_placed == int((assign >= 0).sum())
    if kind != "plain":   # the case's masks or budgets bite
        assert out.n_placed < int(sa.task_valid.sum()) or \
            not np.asarray(solver.static_mask()).all()


def test_solver_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sa, _, _, _ = _case("plain", 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseSolver(sa, ScoreWeights.make(4))
