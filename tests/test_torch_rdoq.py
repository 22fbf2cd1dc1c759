"""fasthevc_tpu_torch.ops.rdoq against fasthevc_tpu.ops.rdoq.

The parallel trellis decides levels by comparing f32 costs, so the port
must reproduce the reference's f32 results bit for bit: the rate tables
(build_rdoq_tables), the trellis itself (rdoq_scan_plain vs rdoq_scan,
run jitted as the commit runs it), and XLA's blocked order of the
cumulative sum (blocked_cumsum vs jnp.cumsum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.ops import rdoq as jrdoq
from fasthevc_tpu.ops.commit import _scan_oh
from fasthevc_tpu_torch.ops import rdoq

KEYS = [(0, 3), (0, 4), (0, 5), (1, 2), (1, 3), (1, 4)]


def _lam(qp):
    ls = np.float32(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))
    return np.float32(ls * ls)


@pytest.mark.parametrize("qp", [0, 22, 32, 37, 51])
def test_tables_bit_equal(qp):
    lam = _lam(qp)
    qp_c = max(qp - 2, 0)
    want = jrdoq.build_rdoq_tables(jnp.int32(qp), jnp.int32(qp),
                                   jnp.int32(qp_c), jnp.float32(lam), 0, 8)
    got = rdoq.build_rdoq_tables(qp, qp, qp_c, float(lam), 0, 8)
    for key in KEYS:
        w, g = want[key], got[key]
        for name in ("sig", "last", "g1", "g2", "csb"):
            a = np.asarray(w[name])
            b = g[name].numpy()
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                          err_msg=f"{key} {name}")
        assert (np.float32(w["err_scale"]).view(np.int32)
                == g["err_scale"].numpy().view(np.int32))
        assert int(w["qbits"]) == g["qbits"]
        assert int(w["q_scale"]) == g["q_scale"]


def _blocks(nn, count, rng):
    """Scan-ordered coefficient blocks: decaying spectra of several
    magnitudes, all-zero blocks, flat blocks whose costs tie, and blocks
    at the 16-bit limit."""
    decay = np.exp(-np.arange(nn) / nn * 3)
    scale = rng.choice([2, 12, 60, 400, 4000], (count, 1))
    c = (rng.standard_normal((count, nn)) * scale * decay).astype(np.int64)
    c[0] = 0
    c[1] = 7
    c[2, ::3] = -7
    c[3] = rng.choice([-32767, 32767, 0], nn)
    c[4, :4] = 32767
    return np.clip(c, -32767, 32767).astype(np.int32)


@pytest.mark.parametrize("c_idx,lg", KEYS)
@pytest.mark.parametrize("qp", [22, 37])
def test_trellis_matches_jax(c_idx, lg, qp):
    rng = np.random.default_rng(100 * lg + qp + c_idx)
    nn = 1 << (2 * lg)
    cf = _blocks(nn, 48, rng)
    n_scans = 3 if lg in (2, 3) else 1
    sel = rng.integers(0, 3, 48) if rdoq._n_scans(lg, c_idx) == 3 else \
        np.zeros(48, np.int64)
    lam = _lam(qp)
    jt = jrdoq.build_rdoq_tables(jnp.int32(qp), jnp.int32(qp), jnp.int32(qp),
                                 jnp.float32(lam), 0, 8)[(c_idx, lg)]
    oh = jnp.asarray(np.eye(n_scans, dtype=np.float32)[sel])
    run = jax.jit(jrdoq.rdoq_scan, static_argnums=(3, 4))
    want = np.asarray(run(jnp.asarray(cf), oh, jt, lg, c_idx))
    tt = rdoq.build_rdoq_tables(qp, qp, qp, float(lam), 0, 8)[(c_idx, lg)]
    got = rdoq.rdoq_scan_plain(torch.from_numpy(cf), torch.from_numpy(sel),
                               tt, lg, c_idx)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).sum() > 0


def test_scan_oh_matches_the_select():
    sel = np.array([0, 2, 1, 0])
    np.testing.assert_array_equal(np.asarray(_scan_oh(3, jnp.asarray(sel))),
                                  np.eye(3, dtype=np.float32)[sel])


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512, 1024])
def test_blocked_cumsum_matches_xla(n):
    rng = np.random.default_rng(n)
    # mixed magnitudes and signs, so that the summation order shows
    x = (rng.standard_normal((64, n))
         * 10.0 ** rng.integers(-3, 5, (64, n))).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    got = rdoq.blocked_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # a plain sequential scan does not give these bits
    if n > 16:
        assert not np.array_equal(torch.cumsum(torch.from_numpy(x), -1)
                                  .numpy(), want)


def test_rdoq_device_round_trips_raster_order():
    rng = np.random.default_rng(5)
    cf = (rng.standard_normal((6, 8, 8)) * 300).astype(np.int32)
    tabs = rdoq.build_rdoq_tables(32, 32, 32, float(_lam(32)), 0, 8)[(0, 3)]
    sel = torch.tensor([0, 1, 2, 0, 1, 2])
    lv = rdoq.rdoq_device(torch.from_numpy(cf), sel, tabs, 3, 0)
    from fasthevc_tpu_torch.ops.commit import scan_permute
    lv_s = rdoq.rdoq_scan_plain(
        scan_permute(torch.from_numpy(cf).reshape(6, 64), 3, sel), sel, tabs,
        3, 0)
    assert torch.equal(scan_permute(lv.reshape(6, 64), 3, sel), lv_s)


def test_quantiser_steps_are_xla_exp2():
    """The trellis' step 2^qbits is jnp.exp2, inexact on XLA's CPU backend
    at odd exponents; the port carries its values."""
    q = np.array(sorted(rdoq.XLA_EXP2), np.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(q)))
    got = np.array([rdoq.XLA_EXP2[int(v)] for v in q], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
