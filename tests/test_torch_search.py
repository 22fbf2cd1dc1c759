"""fasthevc_tpu_torch.codec.search against fasthevc_tpu.codec.search.

The port's search runs the kernels' twins on the CPU and must take the
same decisions as the JAX search: identical packed [F, gh, gw, 9] maps
from search_intra_maps_batch, on clips with texture, flat areas (many
equal RMD costs) and a picture that does not fill its CTUs (forced
splits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.codec import search as jsearch
from fasthevc_tpu.utils import pad_plane, synthesize_yuv
from fasthevc_tpu_torch.codec import search

# (width, height, qp, seed); seed None = a clip with large flat areas
CLIPS = [(96, 64, 32, 21), (96, 64, 22, 5), (96, 64, 37, None),
         (104, 72, 37, 3), (128, 96, 27, 8)]


def _lambda_sqrt(qp):
    return float(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))


def _clip(w, h, seed):
    if seed is not None:
        return synthesize_yuv(w, h, 2, seed=seed)
    frames = []
    for t in range(2):
        y = np.full((h, w), 128, np.uint8)
        y[:, w // 2:] = 60 + 10 * t
        y[h // 2:, : w // 4] = np.arange(w // 4, dtype=np.uint8)[None] * 3
        c = np.full((h // 2, w // 2), 128, np.uint8)
        frames.append((y, c, c.copy()))
    return frames


def _padded(clip, w, h):
    pw, ph = -(-w // 32) * 32, -(-h // 32) * 32
    cw, ch = -(-w // 8) * 8, -(-h // 8) * 8

    def pad(p, hh, ww, cph, cpw):
        return pad_plane(pad_plane(p, cph, cpw), hh, ww).astype(np.uint8)

    ys = np.stack([pad(f[0], ph, pw, ch, cw) for f in clip])
    cbs = np.stack([pad(f[1], ph // 2, pw // 2, ch // 2, cw // 2)
                    for f in clip])
    crs = np.stack([pad(f[2], ph // 2, pw // 2, ch // 2, cw // 2)
                    for f in clip])
    return ys, cbs, crs, cw, ch


@pytest.mark.parametrize("w,h,qp,seed", CLIPS)
def test_packed_maps_match_jax(w, h, qp, seed):
    ys, cbs, crs, cw, ch = _padded(_clip(w, h, seed), w, h)
    ls = _lambda_sqrt(qp)
    want = np.asarray(jsearch.search_intra_maps_batch(
        jnp.asarray(ys), jnp.float32(ls), 5, 3, cw, ch,
        cb_u8_batch=jnp.asarray(cbs), cr_u8_batch=jnp.asarray(crs),
        rd_cands=3))
    got = search.search_intra_maps_batch(
        torch.from_numpy(ys), ls, 5, 3, cw, ch,
        cb_batch=torch.from_numpy(cbs), cr_batch=torch.from_numpy(crs),
        rd_cands=3)
    assert got.dtype == torch.int16 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_search_intra_frame_matches_jax():
    """Per-size modes and splits identical; f32 costs equal up to the
    rate proxy's last-bit differences."""
    f = synthesize_yuv(96, 64, 1, seed=9)[0]
    y, cb, cr = (p.astype(np.int32) for p in f)
    ls = _lambda_sqrt(30)
    want = jsearch.search_intra_frame(jnp.asarray(y), jnp.float32(ls), 5, 3,
                                      jnp.asarray(cb), jnp.asarray(cr))
    got = search.search_intra_frame(torch.from_numpy(y), ls, 5, 3,
                                    torch.from_numpy(cb),
                                    torch.from_numpy(cr))
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        v = np.asarray(v)
        if key.startswith(("mode", "split")):
            np.testing.assert_array_equal(got[key].numpy(), v, err_msg=key)
        else:
            np.testing.assert_allclose(got[key].numpy(), v, rtol=1e-5,
                                       err_msg=key)


def test_topk_ties_lower_index_first():
    """The shortlist keeps jax.lax.top_k's order among equal RMD costs."""
    cost = np.array([[3, 1, 1, 1, .5, 1, 1], [2, 2, 2, 2, 2, 2, 2]],
                    np.float32)
    _, want = jax.lax.top_k(-jnp.asarray(cost), 3)
    got = torch.sort(torch.from_numpy(cost), dim=1, stable=True).indices
    np.testing.assert_array_equal(got[:, :3].numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, :3].numpy(), [[4, 1, 2], [0, 1, 2]])


@pytest.mark.parametrize("seed", [0, 1])
def test_intra_mode_bits_match_jax(seed):
    rng = np.random.default_rng(seed)
    gy, gx = 6, 9
    prov = rng.integers(0, 35, gy * gx).astype(np.int32)
    prov[::4] = rng.integers(0, 2, prov[::4].shape)  # planar/DC neighbours
    want = np.asarray(jsearch._intra_mode_bits(jnp.asarray(prov), gy, gx))
    got = search._intra_mode_bits(torch.from_numpy(prov), 1, gy, gx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_search_qp_inverts_lambda_like_jax():
    for qp in range(52):
        ls = jnp.float32(_lambda_sqrt(qp))
        lam = ls * ls
        want = int(jnp.clip(jnp.round(12.0 + 3.0 * jnp.log2(lam / 0.57)),
                            0, 51))
        assert search.search_qp(_lambda_sqrt(qp)) == want == qp
