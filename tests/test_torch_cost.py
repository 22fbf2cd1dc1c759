"""fasthevc_tpu_torch.ops.cost against fasthevc_tpu.ops.cost.

K2's twin (satd on CPU tensors) must equal the JAX satd of src - pred
exactly.  K4's twin (sse_rate on CPU tensors) must give the JAX sse
exactly and the JAX level_rate_proxy within 1e-5 relative: the proxy sums
f32 log2 terms, which the two libraries evaluate and add in different
orders (measured differences are below 5e-6 relative at n = 32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.ops import cost as jcost
from fasthevc_tpu.ops import transform as jtr
from fasthevc_tpu_torch.ops import cost

RATE_RTOL = 1e-5


def _satd_inputs(n, count, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (count, n, n)).astype(np.int32)
    preds = rng.integers(0, 256, (count, 35, n, n)).astype(np.int32)
    # near-flat predictions too: small residuals, many equal costs
    preds[: count // 2] = np.clip(src[: count // 2, None]
                                  + rng.integers(-3, 4, (count // 2, 35, n,
                                                         n)), 0, 255)
    return src, preds


def _k4_inputs(n, qp, count, seed):
    """Residuals and their JAX search-grade T/Q/IQ/IT results."""
    rng = np.random.default_rng(seed)
    res = np.concatenate([
        rng.integers(-255, 256, (count, n, n)),
        rng.integers(-12, 13, (count, n, n)),
        np.zeros((2, n, n), np.int64)]).astype(np.int32)
    lv, rq = jtr.tq_roundtrip_fast(jnp.asarray(res), qp, n.bit_length() - 1)
    return res, np.asarray(rq).astype(np.int32), np.asarray(lv)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_satd_matches_jax(n):
    src, preds = _satd_inputs(n, 24, seed=n)
    want = np.asarray(jcost.satd(jnp.asarray(src[:, None] - preds)))
    got = cost.satd(torch.from_numpy(src), torch.from_numpy(preds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,qp", [(4, 22), (8, 32), (16, 37), (32, 27)])
def test_sse_rate_matches_jax(n, qp):
    res, rq, lv = _k4_inputs(n, qp, 60, seed=n + qp)
    want_d = np.asarray(jcost.sse(jnp.asarray(res), jnp.asarray(rq)))
    want_r = np.asarray(jcost.level_rate_proxy(jnp.asarray(lv)))
    dist, rate = cost.sse_rate(torch.from_numpy(res), torch.from_numpy(rq),
                               torch.from_numpy(lv.astype(np.int32)))
    assert dist.dtype == rate.dtype == torch.float32
    np.testing.assert_array_equal(dist.numpy(), want_d)
    np.testing.assert_allclose(rate.numpy(), want_r, rtol=RATE_RTOL, atol=0)
    assert (rate.numpy()[-2:] == 0).all()  # all-zero blocks cost no bits
