"""Predicates and scores of the port against the jnp forms.

Masks are exact. Scores hold to rtol=1e-6, atol=1e-4: both sides compute in
float32, but XLA:CPU contracts ``s + w * term`` into a fused multiply-add
while the port rounds the product and the sum separately (as its CUDA
kernel does), so the two may differ in the last bits of a value near 100.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.ops import fit as jfit
from volcano_tpu.ops import score as jscore
from volcano_tpu_torch.ops import fit, score

RTOL, ATOL = 1e-6, 1e-4


def _nodes(seed, n=64, r=4):
    rng = np.random.default_rng(seed)
    alloc = rng.choice([0.0, 8.0, 64_000.0, 262_144.0, 110.0], (n, r))
    alloc = alloc.astype(np.float32)
    idle = (alloc * rng.uniform(-0.1, 1.0, (n, r))).astype(np.float32)
    req = rng.choice([0.0, 1.0, 1000.0, 2048.0, 8000.0], r).astype(np.float32)
    return rng, req, idle, alloc


@pytest.mark.parametrize("seed", range(3))
def test_group_fit_mask_exact(seed):
    rng = np.random.default_rng(seed)
    req = rng.choice([0.0, 1.0, 100.0, 1000.0], (20, 4)).astype(np.float32)
    avail = rng.choice([0.0, 1.0, 99.95, 1000.0], (30, 4)).astype(np.float32)
    eps = np.array([100.0, 0.1, 0.1, 0.1], np.float32)
    want = np.asarray(jfit.group_fit_mask(jnp.asarray(req), jnp.asarray(avail),
                                          jnp.asarray(eps)))
    got = fit.group_fit_mask(torch.from_numpy(req), torch.from_numpy(avail),
                             torch.from_numpy(eps)).numpy()
    np.testing.assert_array_equal(got, want)
    r1 = np.asarray(jfit.resource_le(jnp.asarray(req[:5]),
                                     jnp.asarray(avail[:5]), jnp.asarray(eps)))
    r2 = fit.resource_le(torch.from_numpy(req[:5]), torch.from_numpy(avail[:5]),
                         torch.from_numpy(eps)).numpy()
    np.testing.assert_array_equal(r2, r1)


@pytest.mark.parametrize("seed", range(3))
def test_selector_and_taint_masks_exact(seed):
    rng = np.random.default_rng(seed)
    node_pairs = (rng.uniform(size=(40, 12)) < 0.4).astype(np.float32)
    requires = (rng.uniform(size=(15, 12)) < 0.15).astype(np.float32)
    counts = requires.sum(axis=1).astype(np.float32)
    taints = (rng.uniform(size=(40, 5)) < 0.2).astype(np.float32)
    tolerates = (rng.uniform(size=(15, 5)) < 0.5).astype(np.float32)
    want_sel = np.asarray(jfit.selector_mask(
        jnp.asarray(node_pairs), jnp.asarray(requires), jnp.asarray(counts)))
    got_sel = fit.selector_mask(torch.from_numpy(node_pairs),
                                torch.from_numpy(requires),
                                torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got_sel, want_sel)
    want_t = np.asarray(jfit.taint_mask(jnp.asarray(taints),
                                        jnp.asarray(tolerates)))
    got_t = fit.taint_mask(torch.from_numpy(taints),
                           torch.from_numpy(tolerates)).numpy()
    np.testing.assert_array_equal(got_t, want_t)
    assert got_sel.any() and not got_sel.all()


def test_pod_count_and_static_predicate_mask_exact():
    rng = np.random.default_rng(5)
    n_tasks = rng.integers(0, 5, 30).astype(np.int32)
    max_tasks = rng.integers(0, 5, 30).astype(np.int32)
    want = np.asarray(jfit.pod_count_mask(jnp.asarray(n_tasks),
                                          jnp.asarray(max_tasks)))
    got = fit.pod_count_mask(torch.from_numpy(n_tasks),
                             torch.from_numpy(max_tasks)).numpy()
    np.testing.assert_array_equal(got, want)
    parts = [rng.uniform(size=(6, 30)) < 0.8 for _ in range(4)]
    valid = rng.uniform(size=30) < 0.9
    want = np.asarray(jfit.static_predicate_mask(
        jnp.asarray(valid), *(jnp.asarray(p) for p in parts)))
    got = fit.static_predicate_mask(
        torch.from_numpy(valid), *(torch.from_numpy(p) for p in parts))
    np.testing.assert_array_equal(got.numpy(), want)


TERMS = ["binpack", "least", "most", "balanced"]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("term", TERMS)
def test_score_terms(seed, term):
    rng, req, idle, alloc = _nodes(seed)
    used = alloc - idle
    w_res = rng.choice([0.0, 1.0, 2.5], 4).astype(np.float32)
    j = [jnp.asarray(req), jnp.asarray(used), jnp.asarray(alloc)]
    t = [torch.from_numpy(req), torch.from_numpy(used),
         torch.from_numpy(alloc)]
    if term == "binpack":
        want = jscore.binpack_score(*j, jnp.asarray(w_res))
        got = score.binpack_score(*t, torch.from_numpy(w_res))
    else:
        name = {"least": "least_requested_score",
                "most": "most_requested_score",
                "balanced": "balanced_allocation_score"}[term]
        want = getattr(jscore, name)(*j)
        got = getattr(score, name)(*t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("seed", range(4))
def test_node_score_weighted_sum(seed):
    rng, req, idle, alloc = _nodes(seed)
    kw = dict(binpack_res=rng.choice([0.0, 1.0, 3.0], 4),
              binpack=float(rng.uniform(0, 2)), least=float(rng.uniform(0, 2)),
              most=float(rng.uniform(0, 2)), balanced=float(rng.uniform(0, 2)))
    static = rng.choice([0.0, 50.0], idle.shape[0]).astype(np.float32)
    want = jscore.node_score(jnp.asarray(req), jnp.asarray(idle),
                             jnp.asarray(alloc),
                             jscore.ScoreWeights.make(4, **kw),
                             jnp.asarray(static))
    got = score.node_score(torch.from_numpy(req), torch.from_numpy(idle),
                           torch.from_numpy(alloc),
                           score.ScoreWeights.make(4, **kw),
                           torch.from_numpy(static))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
