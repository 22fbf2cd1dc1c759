"""fasthevc_tpu_torch's in-loop filters and checksum against the reference.

The deblock twin (the plain form of kernel K6) must equal the JAX
`deblock_device` and the spec oracle `deblock_picture`; the SAO twin (K7)
must give `sao_device`'s parameters and output planes; the checksum twin
(K8) must equal `utils.video.picture_checksum`.  Shapes are those of
tests/test_device_commit.py.
"""

import jax.numpy as jnp
import numpy as np
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


def test_checksum_twin_matches_picture_checksum():
    rng = np.random.default_rng(2)
    for h, w in ((72, 104), (36, 52), (300, 520)):
        planes = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
        got = device_checksum(torch.from_numpy(planes))
        want = [int.from_bytes(picture_checksum([p])[0], "big")
                for p in planes]
        assert got.tolist() == want
