"""TorchEncoder's low-delay P device route against TpuEncoder, and its
routing.

TorchEncoder on the CPU runs the P route through the kernels' twins: the P
search, exact MC, the mixed wavefront commit, deblocking with boundary
strengths, SAO and the checksum per batch, the on-device DPB, TMVP from
the recorded motion, and CABAC on the host.  With SAO and RDOQ off its
stream must equal TpuEncoder's classic per-frame route (which
tests/test_device_inter.py holds equal to TpuEncoder's device route); at
the defaults and against the device route itself the comparison is in
the slow tier, since XLA takes minutes to compile the JAX inter device
program on the CPU.  Every stream must decode hash-clean.
"""

import dataclasses
import os

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

W, H = 96, 64
DEVICE_KEYS = {"device_s", "wait_s", "entropy_s", "wall_s"}
NO_SAO_RDOQ = {"sao": False, "rdoq": False}


def _configs(preset, intra_period=None, **kw):
    """The JAX package's and the port's config from the same arguments."""
    cfgs = (getattr(jax_config, preset)(**kw),
            getattr(port_config, preset)(**kw))
    if intra_period is not None:
        cfgs = tuple(dataclasses.replace(c, intra_period=intra_period)
                     for c in cfgs)
    return cfgs


def _port_encode(monkeypatch, cfg, clip):
    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)
    enc = TorchEncoder(cfg, "cpu")
    stream, recons = enc.encode(clip)
    assert set(enc.timing) == DEVICE_KEYS
    return stream, recons


def _hash_clean(stream, frames):
    pics = SpecDecoder().decode(stream)
    return len(pics) == frames and all(p.hash_ok for p in pics)


@pytest.mark.parametrize("frames,extra", [(3, {}), (5, {"intra_period": 2})])
def test_ldp_stream_matches_classic_route(monkeypatch, frames, extra):
    """FASTHEVC_FORCE_CLASSIC (tests/conftest.py) sends TpuEncoder's P
    orders to its classic per-frame loop; the port takes its device
    route.  intra_period 2 puts IDRs mid-clip: new CVSs, DPB evictions."""
    clip = synthesize_yuv(W, H, frames, seed=3)
    jcfg, pcfg = _configs("low_delay_p", width=W, height=H, qp=32,
                          frames=frames, **NO_SAO_RDOQ, **extra)
    assert os.environ.get("FASTHEVC_FORCE_CLASSIC")
    want, want_recons = TpuEncoder(jcfg).encode(clip)
    got, recons = _port_encode(monkeypatch, pcfg, clip)
    assert got == want
    for r, wr in zip(recons, want_recons):
        for plane in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(r, plane),
                                          np.asarray(getattr(wr, plane)))
    assert _hash_clean(got, frames)


def test_ldp_defaults_decode_hash_clean(monkeypatch):
    """At the defaults (SAO, the device trellis, TMVP, two references) the
    port's stream decodes with matching picture hashes, is deterministic,
    and codes its P pictures cheaper than an all-intra encode."""
    clip = synthesize_yuv(W, H, 3, seed=3)
    _, pcfg = _configs("low_delay_p", width=W, height=H, qp=32, frames=3)
    got, _ = _port_encode(monkeypatch, pcfg, clip)
    assert _hash_clean(got, 3)
    again, _ = _port_encode(monkeypatch, pcfg, clip)
    assert again == got
    _, icfg = _configs("all_intra", width=W, height=H, qp=32, frames=3)
    intra, _ = _port_encode(monkeypatch, icfg, clip)
    assert len(got) < len(intra)


@pytest.mark.slow
@pytest.mark.parametrize("extra", [{}, NO_SAO_RDOQ])
def test_ldp_stream_matches_tpu_device_route(monkeypatch, extra):
    """Against TpuEncoder's inter device route itself (about 2-4 min of
    XLA compiles per config on the CPU)."""
    clip = synthesize_yuv(W, H, 3, seed=3)
    jcfg, pcfg = _configs("low_delay_p", width=W, height=H, qp=32, frames=3,
                          **extra)
    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)
    want, _ = TpuEncoder(jcfg).encode(clip)
    got, _ = _port_encode(monkeypatch, pcfg, clip)
    assert got == want
    assert _hash_clean(got, 3)


def test_b_orders_and_the_classic_p_route_raise(monkeypatch):
    """B orders take the GOP device route (a 3-frame GOP-2 of B pictures,
    the first with l0 == l1); B and P orders under FASTHEVC_FORCE_CLASSIC
    take the classic per-frame route, with and without rate control, and
    there (once refused) the port's streams are TpuEncoder's."""
    clip = synthesize_yuv(64, 64, 3, seed=1)
    gop = [(2, 1, "B", (-2,)), (1, 2, "B", (-1, 1))]
    kw = dict(width=64, height=64, qp=32, frames=3, intra_period=-1)
    j_b, b_cfg = (m.EncoderConfig(gop=[m.GopEntry(*e) for e in gop], **kw)
                  for m in (jax_config, port_config))
    stream, _ = _port_encode(monkeypatch, b_cfg, clip)
    assert _hash_clean(stream, 3)
    j_ldp, ldp = _configs("low_delay_p", width=64, height=64, frames=3)
    monkeypatch.setenv("FASTHEVC_FORCE_CLASSIC", "1")
    for jcfg, cfg in ((j_b, b_cfg), (j_ldp, ldp)):
        for rc in ({}, {"target_bitrate": 100000}):
            want, _ = TpuEncoder(dataclasses.replace(jcfg, **rc)).encode(clip)
            enc = TorchEncoder(dataclasses.replace(cfg, **rc), "cpu")
            got, _ = enc.encode(clip)
            assert set(enc.timing) == {"search_s", "commit_s", "wall_s"}
            assert got == want
            assert _hash_clean(got, 3)


def test_the_port_takes_only_its_own_config():
    jcfg, _ = _configs("low_delay_p", width=64, height=64, frames=3)
    with pytest.raises(TypeError):
        TorchEncoder(jcfg, "cpu")
