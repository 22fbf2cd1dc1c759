"""K10's twin (fasthevc_tpu_torch.ops.me.subpel on CPU tensors) against the
reference's two-stage sub-pel search, fasthevc_tpu/ops/me.py _subpel_core,
jitted alone and called on the windows it is given (no JAX inter program is
compiled; XLA contracts its cost into one fused multiply-add, as the
reference's jitted search does): costs bit for bit, quarter-pel MVs and
predictions exactly.

Two crafted cases: flat pictures, where every candidate of a stage costs
the same at lambda_sqrt 0 (the first half-pel candidate must win and no
quarter-pel one may replace it) or differs only by its MV rate; and MVs
that push the windows past all four picture edges, where the reference
reads edge-clamped samples.  The CUDA kernel is held against this twin in
test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.ops.me import _subpel_core
from fasthevc_tpu.utils import synthesize_yuv
from fasthevc_tpu_torch.ops import me

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

H, W = 32, 48
_core = jax.jit(_subpel_core, static_argnums=3)


def _reference(y, ref, mv_int, n, ls):
    """_subpel_core on the edge-clamped windows at block + mv_int - 4."""
    gy, gx = H // n, W // n
    oy = np.repeat(np.arange(gy) * n, gx)
    ox = np.tile(np.arange(gx) * n, gy)
    side = np.arange(n + 8)
    rows = np.clip(oy[:, None] + mv_int[:, 1:2] - 4 + side, 0, H - 1)
    cols = np.clip(ox[:, None] + mv_int[:, 0:1] - 4 + side, 0, W - 1)
    win = ref[rows[:, :, None], cols[:, None, :]]
    src = y.reshape(gy, n, gx, n).transpose(0, 2, 1, 3).reshape(-1, n, n)
    return [np.asarray(a) for a in _core(
        jnp.asarray(src), jnp.asarray(win), jnp.asarray(mv_int), n,
        jnp.float32(ls))]


def _check(y, ref, mv_int, n, ls):
    want_c, want_mv, want_p = _reference(y, ref, mv_int, n, ls)
    c, mv, p = me.subpel(torch.from_numpy(y), torch.from_numpy(ref)[None],
                         torch.from_numpy(mv_int)[None], n, ls)
    np.testing.assert_array_equal(c[0].numpy().view(np.int32),
                                  want_c.view(np.int32))
    np.testing.assert_array_equal(mv[0].numpy(), want_mv)
    np.testing.assert_array_equal(p[0].numpy(), want_p)
    return mv[0].numpy()


@pytest.mark.parametrize("ls", [0.0, 9.5])
def test_subpel_twin_keeps_the_first_of_equal_costs(ls):
    """Flat source and reference: every prediction equals the source, so
    at lambda_sqrt 0 all 17 candidates cost 0 and the first half-pel
    candidate, (-2, -2) from 4 * mv_int, must win; above 0 candidates of
    equal MV magnitude tie and the least magnitude wins."""
    n = 8
    y = np.full((H, W), 117, np.int32)
    ref = y.copy()
    b = (H // n) * (W // n)
    mv_int = np.random.default_rng(3).integers(-3, 4, (b, 2)).astype(
        np.int32)
    mv = _check(y, ref, mv_int, n, ls)
    if ls == 0.0:
        np.testing.assert_array_equal(mv, 4 * mv_int - 2)


@pytest.mark.parametrize("n", [8, 16])
def test_subpel_twin_at_the_picture_edges(n):
    """MVs 20 pels past each edge on the corner blocks (windows clamped at
    all four edges), random ones up to 12 pels elsewhere, on synthesized
    content."""
    clip = synthesize_yuv(W, H, 2, seed=8)
    y = np.asarray(clip[1][0], np.int32)
    ref = np.asarray(clip[0][0], np.int32)
    gy, gx = H // n, W // n
    mv_int = np.random.default_rng(n).integers(
        -12, 13, (gy * gx, 2)).astype(np.int32)
    for b, (sx, sy) in ((0, (-1, -1)), (gx - 1, (1, -1)),
                        ((gy - 1) * gx, (-1, 1)), (gy * gx - 1, (1, 1))):
        mv_int[b] = (20 * sx, 20 * sy)
    _check(y, ref, mv_int, n, 7.25)
