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


@pytest.mark.parametrize("lg,use_dst", [(2, False), (2, True), (3, False),
                                        (4, False), (5, False)])
def test_exact_stages_match_jax(lg, use_dst):
    """fwd_transform, quantize(_mixed), dequantize and inv_transform are
    the JAX functions of the same names, exactly."""
    res = _residuals(lg, 40, seed=60 + lg)
    jc = np.asarray(jtr.fwd_transform(jnp.asarray(res), lg, 8, use_dst))
    tc = transform.fwd_transform(torch.from_numpy(res), lg, 8, use_dst)
    np.testing.assert_array_equal(tc.numpy(), jc)
    mask = np.arange(res.shape[0]) % 3 != 0
    for qp in (22, 37):
        jl = np.asarray(jtr.quantize_mixed(jnp.asarray(jc), jnp.int32(qp), lg,
                                           8, jnp.asarray(mask)))
        tl = transform.quantize_mixed(tc, qp, lg, 8, torch.from_numpy(mask))
        np.testing.assert_array_equal(tl.numpy(), jl)
        for intra in (True, False):
            np.testing.assert_array_equal(
                transform.quantize(tc, qp, lg, 8, intra).numpy(),
                np.asarray(jtr.quantize(jnp.asarray(jc), qp, lg, 8, intra)))
        jd = np.asarray(jtr.dequantize(jnp.asarray(jl), qp, lg, 8))
        td = transform.dequantize(tl, qp, lg, 8)
        np.testing.assert_array_equal(td.numpy(), jd)
        np.testing.assert_array_equal(
            transform.inv_transform(td, lg, 8, use_dst).numpy(),
            np.asarray(jtr.inv_transform(jnp.asarray(jd), lg, 8, use_dst)))


@pytest.mark.parametrize("qp", [36, 42, 51])
def test_dequantize_follows_the_spec_where_jax_wraps(qp):
    """|level| * 1152 << qp//6 reaches 2^31 at high QPs: the spec's int64
    product saturates to +-32767/-32768, JAX's int32 product (no x64)
    wraps and flips the sign at QP 42 and 51.  The port follows the spec
    (ROADMAP.md queue 3 logs the reference's side)."""
    lv = np.zeros((4, 4), np.int32)
    lv[0, :4] = [32767, -32767, 8000, -7282]
    lv[1, :2] = [1000, -1]
    want = spec_tr.dequantize(lv, qp, 8)
    got = transform.dequantize(torch.from_numpy(lv)[None], qp, 2, 8)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    jax_out = np.asarray(jtr.dequantize(jnp.asarray(lv)[None], jnp.int32(qp),
                                        2, 8))[0]
    assert np.array_equal(jax_out, want) == (qp == 36)
