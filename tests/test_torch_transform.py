"""fasthevc_tpu_torch.ops.transform against fasthevc_tpu.ops.transform.

K3 computes the exact integer T/Q/IQ/IT; the JAX search runs its f32 form
tq_roundtrip_fast.  Levels and reconstructed residuals must be identical,
on full-range random residuals and on small ones, at every TB size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.ops import transform as jtr
from fasthevc_tpu.spec import transform as spec_tr
from fasthevc_tpu_torch.ops import transform

CASES = [(lg, qp) for qp in (22, 32, 37) for lg in (2, 3, 4, 5)]


def _residuals(lg, count, seed):
    n = 1 << lg
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(-255, 256, (count, n, n)),
        rng.integers(-20, 21, (count, n, n))]).astype(np.int32)


@pytest.mark.parametrize("lg,qp", CASES)
def test_tq_roundtrip_matches_jax_fast_form(lg, qp):
    res = _residuals(lg, 100, seed=lg * 100 + qp)
    jl, jr = jtr.tq_roundtrip_fast(jnp.asarray(res), qp, lg)
    lv, rq = transform.tq_roundtrip(torch.from_numpy(res), qp, lg)
    assert lv.dtype == rq.dtype == torch.int32
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(rq.numpy(), np.asarray(jr))


@pytest.mark.parametrize("lg", [2, 5])
def test_tq_roundtrip_matches_spec_oracle(lg):
    """The twin is the normative pipeline of fasthevc_tpu.spec."""
    res = _residuals(lg, 6, seed=7 + lg)
    lv, rq = transform.tq_roundtrip(torch.from_numpy(res), 30, lg)
    for i in range(res.shape[0]):
        coeffs = spec_tr.forward_transform(res[i], 8, False)
        levels = spec_tr.quantize(coeffs, 30, 8, is_intra=True)
        recon = spec_tr.inverse_transform(
            spec_tr.dequantize(levels, 30, 8), 8, False)
        np.testing.assert_array_equal(lv[i].numpy(), levels)
        np.testing.assert_array_equal(rq[i].numpy(), recon)
