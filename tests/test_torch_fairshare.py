"""Fair share of the port against volcano_tpu.ops.fairshare, rtol=1e-6
(float32 on both sides; the per-pass sums over queues may be taken in
another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.ops import fairshare as jfs
from volcano_tpu_torch.ops import fairshare

INF = np.inf


def _case(seed, q=5, r=4, capped=True, demand=1.0):
    rng = np.random.default_rng(seed)
    weight = rng.choice([1.0, 2.0, 3.0, 10.0], q).astype(np.float32)
    total = np.array([64_000.0 * 50, 262_144.0 * 50, 5500.0, 400.0],
                     np.float32)[:r]
    request = (total[None, :] * rng.uniform(0.0, demand, (q, r))
               / q * 2).astype(np.float32)
    capability = np.full((q, r), INF, np.float32)
    if capped:
        rows = rng.uniform(size=q) < 0.5
        capability[rows] = (total[None, :]
                            * rng.uniform(0.05, 0.3, (rows.sum(), r)))
    return weight, capability, request, total


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("demand", [0.3, 3.0])   # requests met / unmet
def test_proportion_waterfill(seed, capped, demand):
    args = _case(seed, capped=capped, demand=demand)
    want_d, want_m = jfs.proportion_waterfill(*(jnp.asarray(a) for a in args))
    got_d, got_m = fairshare.proportion_waterfill(
        *(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)


def test_proportion_waterfill_zero_weight_and_empty_total():
    weight = np.array([0.0, 1.0], np.float32)
    capability = np.full((2, 2), INF, np.float32)
    request = np.array([[5.0, 5.0], [3.0, 0.0]], np.float32)
    for total in (np.array([10.0, 10.0], np.float32),
                  np.array([0.0, 0.0], np.float32)):
        args = (weight, capability, request, total)
        want_d, want_m = jfs.proportion_waterfill(
            *(jnp.asarray(a) for a in args))
        got_d, got_m = fairshare.proportion_waterfill(
            *(torch.from_numpy(a) for a in args))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                                   rtol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_dominant_share(seed):
    rng = np.random.default_rng(seed)
    alloc = rng.choice([0.0, 1.0, 500.0, 4096.0], (7, 4)).astype(np.float32)
    total = rng.choice([0.0, 1000.0, 8192.0], 4).astype(np.float32)
    want_s, want_i = jfs.dominant_share(jnp.asarray(alloc), jnp.asarray(total))
    got_s, got_i = fairshare.dominant_share(torch.from_numpy(alloc),
                                            torch.from_numpy(total))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_i.dtype == torch.int32
