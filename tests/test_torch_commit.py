"""fasthevc_tpu_torch.ops.commit against fasthevc_tpu.ops.commit.

The wavefront commit's twin (the plain form of kernel K5) must give the
recon and level planes of the JAX `wavefront_commit_intra` exactly, with
the dead-zone quantiser and with the parallel RDOQ trellis, sign-data
hiding on, on the decisions of the intra search, at the shapes of
tests/test_device_commit.py and on a picture with two tile columns.  The
dead-zone cases call the JAX function as test_device_commit.py does, so
that they share its compiled programs; the tiled picture without RDOQ is
held against the JAX device route in test_torch_device_route.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.ops.commit import wavefront_commit_intra as jax_commit
from fasthevc_tpu.utils import synthesize_yuv
from fasthevc_tpu.utils.video import pad_plane
from fasthevc_tpu_torch.codec.search import search_intra_maps_batch
from fasthevc_tpu_torch.ops import commit


def _frame(w, h, qp, seed):
    """One synthesized frame in coded dims and its search decisions."""
    y, cb, cr = synthesize_yuv(w, h, 1, seed=seed)[0]
    ph, pw = -(-h // 32) * 32, -(-w // 32) * 32
    planes = [pad_plane(np.asarray(p, np.int32), hh, ww) for p, hh, ww in
              ((y, ph, pw), (cb, ph // 2, pw // 2), (cr, ph // 2, pw // 2))]
    ls = np.float32(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))
    pk = search_intra_maps_batch(
        *(torch.from_numpy(p)[None] for p in planes[:1]), float(ls), 5, 3, w,
        h, cb_batch=torch.from_numpy(planes[1])[None],
        cr_batch=torch.from_numpy(planes[2])[None])[0].numpy()
    src = (planes[0][:h, :w], planes[1][:h // 2, :w // 2],
           planes[2][:h // 2, :w // 2])
    depth = pk[:h // 8, :w // 8, 0].astype(np.int32)
    mode = pk[:h // 8, :w // 8, 1].astype(np.int32)
    return src, depth, mode, np.float32(ls * ls)


@pytest.mark.parametrize("w,h,qp,tiles,rdoq", [
    (96, 64, 32, (), False), (96, 64, 32, (), True),
    (104, 72, 27, (), False), (104, 72, 27, (), True),
    (128, 96, 30, (64,), True)])
def test_commit_twin_matches_jax(w, h, qp, tiles, rdoq):
    (sy, scb, scr), depth, mode, lam = _frame(w, h, qp, seed=w + qp)
    kw = dict(tile_bounds_x=tiles, rdoq=True, lam=jnp.float32(lam)) \
        if rdoq else {}
    want = jax_commit(jnp.asarray(sy), jnp.asarray(scb), jnp.asarray(scr),
                      jnp.asarray(depth), jnp.asarray(mode), jnp.int32(qp),
                      jnp.int32(qp), jnp.int32(qp), w, h, sdh=True, **kw)
    got = commit.wavefront_commit_intra(
        *(torch.from_numpy(a)[None] for a in (sy, scb, scr, depth, mode)),
        qp, qp, qp, w, h, True, tiles, (), rdoq=rdoq, lam=float(lam))
    names = ("rec_y", "rec_cb", "rec_cr", "lv_y", "lv_cb", "lv_cr")
    for name, g, wnt in zip(names, got, want):
        assert g.dtype == (torch.int32 if name[0] == "r" else torch.int16)
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(wnt),
                                      err_msg=name)
    assert np.abs(got[3].numpy()).sum() > 0


def test_scan_permute_round_trip():
    x = torch.arange(3 * 64).reshape(3, 64)
    sel = torch.tensor([0, 1, 2])
    fwd = commit.scan_permute(x, 3, sel)
    assert torch.equal(commit.scan_permute(fwd, 3, sel, inverse=True), x)
    # the horizontal scan of an 8x8 block reads its first 4x4 row by row
    assert fwd[1, :4].tolist() == [64, 65, 66, 67]


def test_sdh_adjust_matches_jax():
    from fasthevc_tpu.ops.commit import _sdh_adjust_scan
    rng = np.random.default_rng(9)
    cf = (rng.standard_normal((40, 64)) * 200).astype(np.int32)
    lv = (cf // 37).astype(np.int32)
    lv[0] = 0
    lv[1, ::5] = 32767
    want = np.asarray(_sdh_adjust_scan(jnp.asarray(lv), jnp.asarray(cf), 32,
                                       3, 8))
    got = commit._sdh_adjust_scan(torch.from_numpy(lv), torch.from_numpy(cf),
                                  32, 3, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != lv).any()
