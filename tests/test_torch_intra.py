"""fasthevc_tpu_torch.ops.intra against fasthevc_tpu.ops.intra.

K1's twin (predict_plain, behind predict_all_modes / predict_selected on
CPU tensors) must equal the JAX predictions exactly, and grid_refs must
cut the same references.  The CUDA kernel itself is held against its twin
in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.ops import intra as jintra
from fasthevc_tpu.utils import synthesize_yuv
from fasthevc_tpu_torch.ops import intra

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

SIZES = [(2, True), (2, False), (3, True), (3, False), (4, True),
         (4, False), (5, True), (5, False)]


def _refs(lg, count, seed):
    """Uniform random refs (every code path, full sample range) plus the
    refs of a synthesized picture (realistic smooth content)."""
    n = 1 << lg
    rng = np.random.default_rng(seed)
    top = rng.integers(0, 256, (count, 2 * n + 1)).astype(np.int32)
    left = rng.integers(0, 256, (count, 2 * n + 1)).astype(np.int32)
    left[:, 0] = top[:, 0]
    y = synthesize_yuv(64, 64, 1, seed=seed)[0][0].astype(np.int32)
    st, sl = intra.grid_refs(torch.from_numpy(y), n)
    return (np.concatenate([top, st.numpy()]),
            np.concatenate([left, sl.numpy()]))


@pytest.mark.parametrize("lg,luma", SIZES)
def test_predict_all_modes_matches_jax(lg, luma):
    top, left = _refs(lg, 48, seed=lg)
    want = np.asarray(jintra.predict_all_modes(jnp.asarray(top),
                                               jnp.asarray(left), lg, luma))
    got = intra.predict_all_modes(torch.from_numpy(top),
                                  torch.from_numpy(left), lg, luma)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lg,luma", SIZES)
def test_predict_selected_matches_jax(lg, luma):
    top, left = _refs(lg, 70, seed=10 + lg)
    modes = np.arange(top.shape[0], dtype=np.int32) % 35
    want = np.asarray(jintra.predict_selected(
        jnp.asarray(top), jnp.asarray(left), lg, jnp.asarray(modes), luma))
    got = intra.predict_selected(torch.from_numpy(top),
                                 torch.from_numpy(left), lg,
                                 torch.from_numpy(modes), luma)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_grid_refs_match_jax(n):
    y = synthesize_yuv(96, 64, 1, seed=n)[0][0].astype(np.int32)
    jt, jl = jintra.grid_refs(jnp.asarray(y), n)
    tt, tl = intra.grid_refs(torch.from_numpy(y), n)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_grid_refs_batched_equals_per_frame():
    clip = synthesize_yuv(64, 32, 3, seed=4)
    ys = torch.from_numpy(np.stack([f[0] for f in clip]).astype(np.int32))
    bt, bl = intra.grid_refs(ys, 8)
    per = [intra.grid_refs(ys[i], 8) for i in range(3)]
    assert torch.equal(bt, torch.cat([p[0] for p in per]))
    assert torch.equal(bl, torch.cat([p[1] for p in per]))
