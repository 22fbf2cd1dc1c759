"""The port's P search against fasthevc_tpu/codec/search.py on the CPU.

`search_p_maps` (the intra candidates over K1-K4's twins, integer ME,
sub-pel refinement, the two merge candidates, the inter RD leaf and the
quadtree DP) must give the JAX search's packed [gh, gw, 9] decision maps,
at SR 64 with one and two active references, on 16 clip/QP cases at
96x64 and 128x96.  The f32 costs of the two sides may differ in the last
ulp (XLA sums the SSE and the rate proxy in its own order); the decisions
must not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.codec.search import search_p_maps as jax_p_maps
from fasthevc_tpu_torch.codec.search import search_p_maps
from fasthevc_tpu_torch.utils import synthesize_yuv
from fasthevc_tpu_torch.utils.video import pad_plane

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

SR = 64
CASES = ([(96, 64, seed, qp) for seed in (1, 2, 3)
          for qp in (22, 27, 32, 37)]
         + [(128, 96, seed, qp) for seed in (4, 5) for qp in (27, 37)])


def _luma(w, h, seed):
    ph, pw = -(-h // 32) * 32, -(-w // 32) * 32
    clip = synthesize_yuv(w, h, 3, seed=seed)
    return [pad_plane(np.asarray(clip[k][0], np.int32), ph, pw)
            for k in (2, 1, 0)]


@pytest.mark.parametrize("w,h,seed,qp", CASES)
def test_p_maps_match_jax(w, h, seed, qp):
    y, r0, r1 = _luma(w, h, seed)
    ls = float(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))
    got = search_p_maps(torch.from_numpy(np.stack([y, y])),
                        torch.from_numpy(np.stack([np.stack([r0, r1]),
                                                   np.stack([r0, r0])])),
                        [ls, ls], 5, 3, w, h, SR, nref=[2, 1]).numpy()
    for i, (nref, refb) in enumerate(((2, r1), (1, r0))):
        want = np.asarray(jax_p_maps(
            jnp.asarray(y.astype(np.uint8)), jnp.asarray(r0.astype(np.uint8)),
            jnp.float32(ls), 5, 3, w, h, SR,
            refb_u8=jnp.asarray(refb.astype(np.uint8)), nref=jnp.int32(nref)))
        np.testing.assert_array_equal(got[i], want)
        inter = got[i][..., 2] > 0
        assert inter.any() and (got[i][..., 1][inter] == -1).all()
    # only an active second reference is ever chosen
    assert not (got[1][..., 7] == 1).any()


def test_second_reference_is_chosen():
    y, r0, r1 = _luma(96, 64, 1)
    ls = float(np.sqrt(0.57 * 2.0 ** ((27 - 12) / 3.0)))
    got = search_p_maps(torch.from_numpy(y[None]),
                        torch.from_numpy(np.stack([r0, r1])[None]), [ls], 5,
                        3, 96, 64, SR, nref=[2]).numpy()[0]
    assert (got[..., 7] == 1).any()
