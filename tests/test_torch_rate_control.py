"""Rate control and HRD SEI on TorchEncoder's device routes.

With `target_bitrate` the device routes dispatch their batches one after
another: the all-intra route in groups of at most two frames, each at the
QP the R-lambda controller gives it, the GOP route with each picture's QP
chosen before its batch, and the controller fed every picture's bits.
Against TpuEncoder: the all-intra route on its own device route
(tests/test_device_rc.py:33-47's config and clip, which tier 1 compiles
there), and the low-delay P route, whose batches hold one picture each,
on TpuEncoder's classic per-frame loop with SAO and RDOQ off (the same
pictures and feedback points; tests/test_torch_p_route.py holds the two
routes equal without rate control).  HRD's buffering-period and
pic-timing SEI go where TpuEncoder writes them: checked the same way on
an IDR, low-delay P pictures and a hierarchical-B GOP (inter RQT off too,
which the device commit never splits).  Against TpuEncoder's inter device
route itself the comparison is in the slow tier.
"""

import os

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

DEVICE_KEYS = {"device_s", "wait_s", "entropy_s", "wall_s"}
NO_SAO_RDOQ = {"sao": False, "rdoq": False}
HIER_B = [(4, 1, "B", (-4,)), (2, 2, "B", (-2, 2)), (1, 3, "B", (-1, 1)),
          (3, 3, "B", (-1, 1))]


def _configs(preset, gop=None, **kw):
    """The JAX package's and the port's config from the same arguments."""
    out = []
    for mod in (jax_config, port_config):
        extra = {} if gop is None else {
            "gop": [mod.GopEntry(*e) for e in gop]}
        out.append(getattr(mod, preset)(**kw, **extra))
    return out


def _port_device(monkeypatch, cfg, clip):
    """The clip through the port's device route (the kernels' twins)."""
    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)
    enc = TorchEncoder(cfg, "cpu")
    stream, recons = enc.encode(clip)
    assert set(enc.timing) == DEVICE_KEYS
    return stream, recons


def _decode(stream, frames):
    dec = SpecDecoder()
    pics = dec.decode(stream)
    assert len(pics) == frames and all(p.hash_ok for p in pics)
    return dec


def test_all_intra_rc_matches_tpu_device_route(monkeypatch):
    """tests/test_device_rc.py:33-47: 16 frames at 192x128 in groups of
    two, the realized rate within 5% of the target."""
    w, h, n, target = 192, 128, 16, 220_000
    frames = synthesize_yuv(w, h, n, seed=6)
    jcfg, pcfg = _configs("EncoderConfig", width=w, height=h, qp=32,
                          frames=n, target_bitrate=target, frame_group=4)
    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)
    want, _ = TpuEncoder(jcfg).encode(frames)
    got, _ = _port_device(monkeypatch, pcfg, frames)
    assert got == want
    _decode(got, n)
    realized = len(got) * 8 * pcfg.frame_rate / n
    assert abs(realized - target) / target < 0.05


@pytest.mark.parametrize("extra", [
    {"target_bitrate": 100_000},
    {"hrd": True},
], ids=["rc", "hrd"])
def test_ldp_device_route_matches_classic_loop(monkeypatch, extra):
    """Low-delay P: one picture a batch on the port's device route,
    one picture a step on TpuEncoder's classic loop
    (FASTHEVC_FORCE_CLASSIC, tests/conftest.py).  Not both at once: the
    reference's device routes feed the controller each picture's bits
    with its HRD SEI, its classic loop without."""
    clip = synthesize_yuv(96, 64, 3, seed=3)
    jcfg, pcfg = _configs("low_delay_p", width=96, height=64, qp=32,
                          frames=3, **NO_SAO_RDOQ, **extra)
    assert os.environ.get("FASTHEVC_FORCE_CLASSIC")
    want, _ = TpuEncoder(jcfg).encode(clip)
    got, _ = _port_device(monkeypatch, pcfg, clip)
    assert got == want
    dec = _decode(got, 3)
    if extra.get("hrd"):
        assert len(dec.hrd_buffering_periods) == 1
        assert len(dec.hrd_pic_timings) == 3


def test_hrd_on_a_hierarchical_b_device_route(monkeypatch):
    """tests/test_hrd_sei.py:65-80's GOP-4 of B pictures: the device route
    writes its batches [0] [4] [2] [1, 3], coding order here, with each
    picture's output delay from its coding-order AU index."""
    clip = synthesize_yuv(64, 64, 5, seed=5)
    jcfg, pcfg = _configs("EncoderConfig", gop=HIER_B, width=64, height=64,
                          qp=35, frames=5, hrd=True, intra_period=-1,
                          rqt_inter=False, **NO_SAO_RDOQ)
    want, _ = TpuEncoder(jcfg).encode(clip)
    got, _ = _port_device(monkeypatch, pcfg, clip)
    assert got == want
    dec = _decode(got, 5)
    assert len(dec.hrd_pic_timings) == 5
    assert all(t["dpb_output_delay"] >= 0 for t in dec.hrd_pic_timings)


def test_hrd_on_the_all_intra_device_route(monkeypatch):
    """An IDR on the all-intra device route: a buffering period and
    pic_timing(0, 0) before it, as TpuEncoder's per-frame loop writes for
    a one-picture all-intra clip (SAO and RDOQ off: the same picture)."""
    clip = synthesize_yuv(64, 64, 1, seed=23)
    jcfg, pcfg = _configs("EncoderConfig", width=64, height=64, qp=32,
                          frames=1, hrd=True, **NO_SAO_RDOQ)
    want, _ = TpuEncoder(jcfg).encode(clip)
    got, _ = _port_device(monkeypatch, pcfg, clip)
    assert got == want
    dec = _decode(got, 1)
    assert len(dec.hrd_buffering_periods) == 1


@pytest.mark.slow
def test_gop_rc_matches_tpu_device_route(monkeypatch):
    """tests/test_device_rc.py:50-70 against TpuEncoder's inter device
    route itself (minutes of XLA compiles on the CPU)."""
    w, h, n, target = 128, 64, 9, 90_000
    frames = synthesize_yuv(w, h, n, seed=7)
    jcfg, pcfg = _configs("EncoderConfig", gop=[(1, 0, "P", (-1,))],
                          width=w, height=h, qp=32, frames=n,
                          target_bitrate=target, intra_period=-1, sao=False,
                          num_ref_per_list=1, temporal_mvp=False)
    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)
    want, _ = TpuEncoder(jcfg).encode(frames)
    got, _ = _port_device(monkeypatch, pcfg, frames)
    assert got == want
    _decode(got, n)
    realized = len(got) * 8 * pcfg.frame_rate / n
    assert abs(realized - target) / target < 0.10


@pytest.mark.slow
def test_ra_rc_and_hrd_match_tpu_device_route(monkeypatch):
    """Two hierarchical-B GOPs in one CVS under rate control and HRD, in
    batches of at most two (FASTHEVC_MAX_INTER_BATCH), against
    TpuEncoder's inter device route itself."""
    clip = synthesize_yuv(64, 64, 9, seed=5)
    jcfg, pcfg = _configs("EncoderConfig", gop=HIER_B, width=64, height=64,
                          qp=35, frames=9, hrd=True, intra_period=-1,
                          target_bitrate=60_000)
    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)
    monkeypatch.setenv("FASTHEVC_MAX_INTER_BATCH", "2")
    want, _ = TpuEncoder(jcfg).encode(clip)
    got, _ = _port_device(monkeypatch, pcfg, clip)
    assert got == want
    _decode(got, 9)
