"""The port's P and B searches at CTU 64, and the classic route's P and B
pictures at CTU 64, against the JAX package on the CPU.

At CTU 64 the searches price a 64-block from its top-left 32 quadrant
(the cost times 4), for the intra candidates as for the inter RD leaf,
and K9-K12 run their tier-64 windows.  TpuEncoder sends P and B orders at
CTU 64 to its classic per-frame route, the first caller of these search
forms.  `search_p_maps` and `search_b_maps` must give the JAX search's
packed decision maps on one 128x128 frame, called as the per-frame route
calls them (encoder.py:1087-1108: two references per list), and a CTU-64
low-delay P encode must equal TpuEncoder's byte for byte.  The CTU-64
random-access encode against TpuEncoder is in the slow tier (the JAX B
search compiles once per reference form at this shape); tier 1 checks
that the port's stream decodes hash-clean.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.codec.encoder import TpuEncoder
from fasthevc_tpu.codec.search import search_b_maps as jax_b_maps
from fasthevc_tpu.codec.search import search_p_maps as jax_p_maps
from fasthevc_tpu.config import config as jax_config
from fasthevc_tpu.spec.decoder import SpecDecoder
from fasthevc_tpu_torch.codec.encoder import TorchEncoder
from fasthevc_tpu_torch.codec.gop import coding_order
from fasthevc_tpu_torch.codec.search import search_b_maps, search_p_maps
from fasthevc_tpu_torch.config import config as port_config
from fasthevc_tpu_torch.utils import synthesize_yuv

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

SR = 64
W = H = 128


def _ls(qp):
    return float(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))


def _luma(seed=12):
    """Five 128x128 luma planes (the CTU-64 grid needs no padding)."""
    return [np.asarray(f[0], np.int32)
            for f in synthesize_yuv(W, H, 5, seed=seed)]


def _u8(a):
    return jnp.asarray(a.astype(np.uint8))


@pytest.mark.parametrize("qp", [27, 37])
def test_p_maps_match_jax_at_ctu64(qp):
    f = _luma()
    y, r0, r1 = f[2], f[1], f[0]
    got = search_p_maps(torch.from_numpy(y[None]),
                        torch.from_numpy(np.stack([r0, r1])[None]), _ls(qp),
                        6, 3, W, H, SR).numpy()[0]
    want = np.asarray(jax_p_maps(_u8(y), _u8(r0), jnp.float32(_ls(qp)), 6, 3,
                                 W, H, SR, refb_u8=_u8(r1)))
    np.testing.assert_array_equal(got, want)
    assert (got[..., 2] > 0).any()


@pytest.mark.parametrize("qp", [27, 37])
def test_b_maps_match_jax_at_ctu64(qp):
    f = _luma()
    y, l0, l1 = f[2], (f[1], f[0]), (f[3], f[4])
    got = search_b_maps(torch.from_numpy(y[None]),
                        torch.from_numpy(np.stack(l0)[None]),
                        torch.from_numpy(np.stack(l1)[None]), _ls(qp), 6, 3,
                        W, H, SR).numpy()[0]
    want = np.asarray(jax_b_maps(_u8(y), _u8(l0[0]), _u8(l1[0]),
                                 jnp.float32(_ls(qp)), 6, 3, W, H, SR,
                                 ref0b_u8=_u8(l0[1]), ref1b_u8=_u8(l1[1])))
    np.testing.assert_array_equal(got, want)
    assert (got[..., 2] > 0).any()


def _hash_clean(stream, frames):
    pics = SpecDecoder().decode(stream)
    return len(pics) == frames and all(p.hash_ok for p in pics)


def test_ctu64_ldp_matches_tpu_encoder():
    """P pictures at CTU 64 on the per-frame route: the 64-block inter RD
    leaf and merge candidates, committed by the C++ engine."""
    clip = synthesize_yuv(128, 64, 2, seed=81)
    kw = dict(width=128, height=64, qp=32, frames=2, log2_ctu=6)
    want, want_recons = TpuEncoder(jax_config.low_delay_p(**kw)).encode(clip)
    enc = TorchEncoder(port_config.low_delay_p(**kw), "cpu")
    got, recons = enc.encode(clip)
    assert set(enc.timing) == {"search_s", "commit_s", "wall_s"}
    assert got == want
    for r, wr in zip(recons, want_recons):
        np.testing.assert_array_equal(r.y, np.asarray(wr.y))
    assert _hash_clean(got, 2)


RA64 = dict(width=64, height=64, qp=35, frames=17, sao=False, log2_ctu=6)


def test_ctu64_ra_decodes_hash_clean():
    """A CTU-64 GOP-16 (B pictures with one and two references per list)
    on the per-frame route decodes hash-clean, in coding order."""
    clip = synthesize_yuv(64, 64, 17, seed=85)
    cfg = port_config.random_access_gop16(**RA64)
    order = []
    stream, _ = TorchEncoder(cfg, "cpu").encode(
        clip, on_frame=lambda poc, idr, nal: order.append(poc))
    assert order == [-1] + [poc for poc, *_ in coding_order(cfg, 17, 0)]
    assert _hash_clean(stream, 17)


@pytest.mark.slow
def test_ctu64_ra_matches_tpu_encoder():
    clip = synthesize_yuv(64, 64, 17, seed=85)
    want, _ = TpuEncoder(jax_config.random_access_gop16(**RA64)).encode(clip)
    got, _ = TorchEncoder(port_config.random_access_gop16(**RA64),
                          "cpu").encode(clip)
    assert got == want
