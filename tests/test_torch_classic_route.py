"""TorchEncoder's classic per-frame route against TpuEncoder's.

Under FASTHEVC_FORCE_CLASSIC (tests/conftest.py) both packages send P and
B orders, lossless, weighted prediction, HRD and the two-pass
recon-reference search (`search_recon_refs`) to their classic per-frame
loop: one picture a step in coding order, its search on the device (the
kernels' twins here), the C++ slice engine's commit against a host DPB.
The configs and clips are the JAX package's own tests' (the file:line
beside each), so XLA's persistent cache serves their compiles.  Each port
stream must equal TpuEncoder's byte for byte, with equal recons, and
decode hash-clean in SpecDecoder.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from fasthevc_tpu.codec.encoder import TpuEncoder
from fasthevc_tpu.config import config as jax_config
from fasthevc_tpu.spec.decoder import SpecDecoder
from fasthevc_tpu_torch.codec.encoder import TorchEncoder
from fasthevc_tpu_torch.config import config as port_config
from fasthevc_tpu_torch.utils import synthesize_yuv

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

CLASSIC_KEYS = {"search_s", "commit_s", "wall_s"}


def fade_clip(n, w=64, h=64, seed=3):
    """tests/test_weighted_pred.py's global luminance fade: frame t is the
    first frame * (1 - t/4) + 10 t."""
    base = synthesize_yuv(w, h, 1, seed=seed, motion=False)[0]
    out = []
    for t in range(n):
        gain, off = 1.0 - 0.25 * t, 10 * t
        y = np.clip(base[0].astype(np.float64) * gain + off, 0, 255)
        cb = np.clip((base[1].astype(np.float64) - 128) * gain + 128, 0, 255)
        cr = np.clip((base[2].astype(np.float64) - 128) * gain + 128, 0, 255)
        out.append((y.astype(np.uint8), cb.astype(np.uint8),
                    cr.astype(np.uint8)))
    return out


def _gop(cfgmod, *entries):
    return [cfgmod.GopEntry(*e) for e in entries]


WP_P = dict(width=64, height=64, qp=30, frames=3, intra_period=-1, sao=False,
            weighted_pred=True, num_ref_per_list=1)
WP_B = dict(width=64, height=64, qp=30, frames=5, intra_period=4, sao=False,
            weighted_pred=True, num_ref_per_list=1)
HRD = dict(width=64, height=64, qp=32, frames=3, sao=False, hrd=True,
           intra_period=-1)

# name -> (preset, config arguments, GOP entries or None, clip)
CASES = {
    # tests/test_tpu_p_frames.py:27-30
    "ldp": ("low_delay_p", dict(width=96, height=64, qp=32, frames=3), None,
            lambda: synthesize_yuv(96, 64, 3, seed=81)),
    # tests/test_tpu_p_frames.py:62-68
    "ra-gop16": ("random_access_gop16",
                 dict(width=64, height=64, qp=35, frames=17, sao=False,
                      deblocking=False), None,
                 lambda: synthesize_yuv(64, 64, 17, seed=85)),
    # tests/test_weighted_pred.py:141-164 and :166-185
    "wp-p": ("EncoderConfig", WP_P, [(1, 0, "P", (-1,))],
             lambda: fade_clip(3)),
    "wp-b": ("EncoderConfig", WP_B,
             [(4, 0, "P", (-4,)), (2, 1, "B", (-2, 2)), (1, 2, "B", (-1, 1)),
              (3, 2, "B", (-1, 1))], lambda: fade_clip(5)),
    # tests/test_tpu_encoder.py:39-45 (one frame: the per-frame route)
    "lossless": ("EncoderConfig",
                 dict(width=64, height=64, qp=32, frames=1, lossless=True),
                 None, lambda: synthesize_yuv(64, 64, 1, seed=23)),
    # tests/test_hrd_sei.py:50-62
    "hrd-ldp": ("EncoderConfig", HRD, [(1, 0, "P", (-1,))],
                lambda: synthesize_yuv(64, 64, 3, seed=4)),
    # the two-pass recon-reference search of quality()
    "recon-refs": ("EncoderConfig",
                   dict(width=64, height=64, qp=32, frames=1,
                        search_recon_refs=True, num_intra_rd_candidates=5),
                   None, lambda: synthesize_yuv(64, 64, 1, seed=23)),
}


def _configs(preset, kw, gop=None):
    """The JAX package's and the port's config from the same arguments."""
    out = []
    for mod in (jax_config, port_config):
        extra = {} if gop is None else {"gop": _gop(mod, *gop)}
        out.append(getattr(mod, preset)(**kw, **extra))
    return out


def _hash_clean(stream, frames):
    pics = SpecDecoder().decode(stream)
    return len(pics) == frames and all(p.hash_ok for p in pics)


def _same_recons(got, want):
    for r, wr in zip(got, want):
        for plane in ("y", "cb", "cr"):
            np.testing.assert_array_equal(np.asarray(getattr(r, plane)),
                                          np.asarray(getattr(wr, plane)))


@pytest.mark.parametrize("name", list(CASES))
def test_classic_stream_matches_tpu_encoder(name):
    preset, kw, gop, make_clip = CASES[name]
    clip = make_clip()
    assert os.environ.get("FASTHEVC_FORCE_CLASSIC")
    jcfg, pcfg = _configs(preset, kw, gop)
    want, want_recons = TpuEncoder(jcfg).encode(clip)
    enc = TorchEncoder(pcfg, "cpu")
    got, recons = enc.encode(clip)
    assert set(enc.timing) == CLASSIC_KEYS
    assert got == want
    _same_recons(recons, want_recons)
    assert _hash_clean(got, len(clip))


def test_lossless_pipelined_matches_tpu_encoder():
    """Two lossless all-intra pictures take the pipelined route (the C++
    engine with transquant bypass, no filters) in both packages, and the
    port's recon is the source."""
    clip = synthesize_yuv(96, 64, 2, seed=21)
    jcfg, pcfg = _configs("EncoderConfig", dict(width=96, height=64, qp=32,
                                                frames=2, lossless=True))
    want, _ = TpuEncoder(jcfg).encode(clip)
    enc = TorchEncoder(pcfg, "cpu")
    got, recons = enc.encode(clip)
    assert "wait_s" in enc.timing
    assert got == want
    for f, r in zip(clip, recons):
        np.testing.assert_array_equal(r.y, f[0])
    assert _hash_clean(got, 2)


def test_two_pass_search_changes_the_decisions():
    """search_recon_refs on the per-frame route searches again from the
    pass-1 recon: the stream differs from the one-pass stream, both decode
    hash-clean, and the encoder's parameter set is left as it was."""
    clip = synthesize_yuv(64, 64, 1, seed=23)
    _, pcfg = _configs("EncoderConfig", CASES["recon-refs"][1])
    enc = TorchEncoder(pcfg, "cpu")
    sp_before = (enc.sp.deblocking_disabled, enc.sp.sao_enabled)
    two, _ = enc.encode(clip)
    assert (enc.sp.deblocking_disabled, enc.sp.sao_enabled) == sp_before
    one, _ = TorchEncoder(pcfg.replace(search_recon_refs=False),
                          "cpu").encode(clip)
    assert two != one
    assert _hash_clean(two, 1) and _hash_clean(one, 1)


def test_recon_refs_warn_and_change_nothing_off_the_per_frame_route():
    """The reference reads search_recon_refs on its per-frame route only;
    on the pipelined route the port writes the same bytes without it, and
    warns."""
    clip = synthesize_yuv(96, 64, 2, seed=21)
    cfg = port_config.EncoderConfig(width=96, height=64, qp=32, frames=2)
    plain, _ = TorchEncoder(cfg, "cpu").encode(clip)
    with pytest.warns(UserWarning, match="search_recon_refs"):
        got, _ = TorchEncoder(cfg.replace(search_recon_refs=True),
                              "cpu").encode(clip)
    assert got == plain
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TorchEncoder(cfg, "cpu").encode(clip)


def test_rate_control_classic_matches_tpu_encoder():
    """All-intra with rate control at CTU 64 takes the per-frame route in
    both packages (the pipelined route has no rate control): QP from the
    controller, feedback after each picture."""
    clip = synthesize_yuv(96, 64, 3, seed=21)
    jcfg, pcfg = _configs("EncoderConfig", dict(
        width=96, height=64, qp=27, frames=3, log2_ctu=6,
        target_bitrate=60_000))
    want, _ = TpuEncoder(jcfg).encode(clip)
    enc = TorchEncoder(pcfg, "cpu")
    got, _ = enc.encode(clip)
    assert set(enc.timing) == CLASSIC_KEYS
    assert got == want
    assert _hash_clean(got, 3)


def test_ten_bit_ldp_matches_tpu_encoder():
    """Above 8 bits the search's planes go up as int32 and both packages
    take the per-frame route."""
    clip = [tuple((np.asarray(p, np.int32) * 4).astype(np.uint16)
                  for p in f) for f in synthesize_yuv(64, 64, 2, seed=81)]
    jcfg, pcfg = _configs("low_delay_p", dict(width=64, height=64, qp=32,
                                              frames=2, bit_depth=10))
    want, want_recons = TpuEncoder(jcfg).encode(clip)
    got, recons = TorchEncoder(pcfg, "cpu").encode(clip)
    assert got == want
    _same_recons(recons, want_recons)
    assert _hash_clean(got, 2)
