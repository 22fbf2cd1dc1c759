"""fasthevc_tpu_torch's in-loop filters and checksum against the reference.

The deblock twin (the plain form of kernel K6) must equal the JAX
`deblock_device` and the spec oracle `deblock_picture`; the SAO twin (K7)
must give `sao_device`'s parameters and output planes; the checksum twin
(K8) must equal `utils.video.picture_checksum`.  Shapes are those of
tests/test_device_commit.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.ops.deblock import deblock_device
from fasthevc_tpu.ops.sao import sao_device
from fasthevc_tpu.spec.deblock import deblock_picture
from fasthevc_tpu.utils.video import picture_checksum
from fasthevc_tpu_torch.codec.device_pipeline import device_checksum
from fasthevc_tpu_torch.ops import deblock, sao

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)


def _random_quadtree_depth(gh, gw, rng):
    depth = np.zeros((gh, gw), np.int8)
    for cy in range(0, gh, 4):
        for cx in range(0, gw, 4):
            if rng.random() < 0.7:
                for sy in range(2):
                    for sx in range(2):
                        d = 1 + (rng.random() < 0.5)
                        depth[cy + 2 * sy:cy + 2 * sy + 2,
                              cx + 2 * sx:cx + 2 * sx + 2] = d
    return depth


def test_deblock_twin_matches_jax_and_oracle():
    rng = np.random.default_rng(0)
    for _trial in range(3):
        w, h = int(rng.choice([64, 96, 128])), int(rng.choice([64, 96]))
        depth = _random_quadtree_depth(h // 8, w // 8, rng).astype(np.int32)
        qp = int(rng.integers(18, 45))
        y = rng.integers(0, 256, (h, w)).astype(np.int32)
        cb = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
        cr = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)

        class P:
            pass

        class SP:
            bit_depth, log2_ctu, log2_max_tu = 8, 5, 5

        p = P()
        p.y, p.cb, p.cr = y.copy(), cb.copy(), cr.copy()
        deblock_picture(p, SP(), depth, qp, qp, qp, maps=None)
        want = deblock_device(jnp.asarray(y), jnp.asarray(cb),
                              jnp.asarray(cr), jnp.asarray(depth), qp, qp,
                              qp, 5)
        got = deblock.deblock(*(torch.from_numpy(a)[None]
                                for a in (y, cb, cr, depth)), qp, qp, qp, 5)
        for g, wj, oracle in zip(got, want, (p.y, p.cb, p.cr)):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(wj))
            np.testing.assert_array_equal(g[0].numpy(), oracle)


def test_deblock_twin_filters_strong_and_weak_edges():
    """Smooth content around the edges, so that both filters and the
    chroma filter change samples (random noise mostly skips them)."""
    rng = np.random.default_rng(3)
    h, w = 64, 96
    depth = np.full((1, h // 8, w // 8), 2, np.int32)
    planes = [np.clip(120 + rng.integers(-k, k + 1, (1, hh, ww))
                      + 6 * (np.arange(ww) // 8 % 2)[None, None], 0, 255)
              .astype(np.int32)
              for k, hh, ww in ((1, h, w), (1, h // 2, w // 2),
                                (2, h // 2, w // 2))]
    got = deblock.deblock(*(torch.from_numpy(a) for a in planes + [depth]),
                          32, 32, 32, 5)
    want = deblock_device(*(jnp.asarray(a[0]) for a in planes + [depth]),
                          32, 32, 32, 5)
    for g, wj, src in zip(got, want, planes):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(wj))
        assert (g[0].numpy() != src[0]).any()


def test_sao_twin_matches_jax():
    rng = np.random.default_rng(1)
    w, h = 104, 72
    src = rng.integers(0, 256, (h, w)).astype(np.int32)
    rec = np.clip(src + rng.integers(-6, 7, (h, w)), 0, 255).astype(np.int32)
    scb = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    rcb = np.clip(scb + rng.integers(-6, 7, scb.shape), 0,
                  255).astype(np.int32)
    scr = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    rcr = np.clip(scr + rng.integers(-6, 7, scr.shape), 0,
                  255).astype(np.int32)
    arrays = (src, scb, scr, rec, rcb, rcr)
    want = sao_device(*(jnp.asarray(a) for a in arrays), 5)
    got = sao.sao(*(torch.from_numpy(a)[None] for a in arrays), 5)
    for g, wj in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(wj))
    params = got[3][0].numpy()
    assert set(np.unique(params[..., 0])) >= {1, 2}   # band and edge CTBs


def _sao_planes(kind, frames, h, w, rng):
    """(src, rec) [frames, h, w] int32: noise (rec = src +- 6), extremes
    (rec at 0-3 with src 0 above, 252-255 with src 255 below: offsets
    that clip) or flat (both 128: every gain 0)."""
    shape = (frames, h, w)
    if kind == "flat":
        src = np.full(shape, 128)
        rec = src.copy()
    elif kind == "extremes":
        low = np.arange(h)[:, None] < h // 2
        rec = np.where(low, rng.integers(0, 4, shape),
                       rng.integers(252, 256, shape))
        src = np.where(rec < 128, 0, 255)
    else:
        src = rng.integers(0, 256, shape)
        rec = np.clip(src + rng.integers(-6, 7, shape), 0, 255)
    return src.astype(np.int32), rec.astype(np.int32)


def _clipped(rec, params, ctb):
    """Samples of one plane [H, W] whose rec + its CTB's offset leaves
    [0, 255], the apply's clip (params [ny, nx, 7])."""
    h, w = rec.shape

    def up(a):
        return np.repeat(np.repeat(a, ctb, 0), ctb, 1)[:h, :w]

    typ, cls, pos = (up(params[..., i]) for i in range(3))
    offs = up(params[..., 3:])                              # [H, W, 4]
    cats = sao._edge_cats(torch.from_numpy(rec)[None].long(), h,
                          w)[0].numpy()
    cat = np.take_along_axis(cats, cls[None], 0)[0]
    k = (rec >> 3) - pos

    def off(i):
        return np.take_along_axis(offs, np.clip(i, 0, 3)[..., None],
                                  2)[..., 0]

    add = np.where((typ == 2) & (cat > 0), off(cat - 1), 0)
    add = add + np.where((typ == 1) & (k >= 0) & (k < 4), off(k), 0)
    return int(((rec + add < 0) | (rec + add > 255)).sum())


@pytest.mark.parametrize("lg,h,w,frames,kind", [
    (4, 48, 64, 1, "noise"), (4, 40, 56, 1, "noise"),
    (6, 64, 128, 1, "noise"), (6, 88, 120, 1, "noise"),
    (5, 64, 96, 2, "noise"), (5, 64, 96, 1, "extremes"),
    (5, 64, 96, 1, "flat")])
def test_sao_twin_matches_jax_at_the_edge_cases(lg, h, w, frames, kind):
    """The cases the fused kernel's edge logic must get right: CTU 16 and
    64, heights and widths off the CTB grid (the estimate's padded rule
    and the apply's coded rule differ there), two frames, offsets that
    clip at 0 and 255, and a flat picture (type 0 everywhere)."""
    rng = np.random.default_rng(lg * 100 + h + w + frames)
    planes = [_sao_planes(kind, frames, h >> (c > 0), w >> (c > 0), rng)
              for c in range(3)]
    arrays = [p[0] for p in planes] + [p[1] for p in planes]
    got = sao.sao_plain(*(torch.from_numpy(a) for a in arrays), lg)
    for f in range(frames):
        want = sao_device(*(jnp.asarray(a[f]) for a in arrays), lg)
        for g, wj in zip(got, want):
            np.testing.assert_array_equal(g[f].numpy(), np.asarray(wj))
    types = got[3][..., 0].numpy()
    if kind == "flat":
        assert (types == 0).all()
    else:
        assert (types > 0).any()
    if kind == "extremes":
        p = got[3][0].numpy()
        assert _clipped(planes[0][1][0], p[..., 0, :], 1 << lg) > 0


def test_checksum_twin_matches_picture_checksum():
    rng = np.random.default_rng(2)
    for h, w in ((72, 104), (36, 52), (300, 520)):
        planes = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
        got = device_checksum(torch.from_numpy(planes))
        want = [int.from_bytes(picture_checksum([p])[0], "big")
                for p in planes]
        assert got.tolist() == want
