"""TorchEncoder's random-access device route against TpuEncoder.

On the CPU TorchEncoder runs B batches through the kernels' twins: the B
search (both lists, merge candidates, BI through K12's twin), exact MC
with bi-prediction, the mixed wavefront commit, deblocking with both
lists' strengths, SAO and the checksum, the on-device DPB with list-1
stacks, TMVP collocated from list 1, and CABAC with init_type 2.

The device route sends a GOP-16 in dependency batches, [16] [8] [4, 12]
[2, 6, 10, 14] [the odd POCs], and writes its pictures in that order, as
TpuEncoder's device route does; TpuEncoder's classic per-frame route
(FASTHEVC_FORCE_CLASSIC, tests/conftest.py) writes them in coding order.
The classic route's host commit also splits inter TUs where RD says so
(inter RQT, `rqt_inter`), which the device route of either package never
does, so the two reference routes differ on random access wherever a
split wins (POCs 1, 2, 3 and 13 of this clip).  With SAO, RDOQ and inter
RQT off the port's pictures must equal the classic route's NAL unit for
NAL unit, POC by POC.  Against TpuEncoder's device route itself, byte for
byte, the comparison is in the slow tier, since XLA takes minutes to
compile the JAX inter device program on the CPU.  Every stream must
decode hash-clean.
"""

import os

import numpy as np
import pytest
import torch

from fasthevc_tpu.codec.encoder import TpuEncoder
from fasthevc_tpu.config import config as jax_config
from fasthevc_tpu.spec.decoder import SpecDecoder
from fasthevc_tpu_torch.codec.encoder import TorchEncoder
from fasthevc_tpu_torch.config import config as port_config
from fasthevc_tpu_torch.spec import bitstream as bs
from fasthevc_tpu_torch.utils import synthesize_yuv

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

W = H = 64
FRAMES = 17
# POCs in the device route's batch order: the IDR, then one GOP-16
BATCH_ORDER = [0, 16, 8, 4, 12, 2, 6, 10, 14, 1, 3, 5, 7, 9, 11, 13, 15]
DEVICE_KEYS = {"device_s", "wait_s", "entropy_s", "wall_s"}
PARAMETER_SETS = (bs.NAL_VPS, bs.NAL_SPS, bs.NAL_PPS)


def _configs(preset, **kw):
    """The JAX package's and the port's config from the same arguments."""
    return (getattr(jax_config, preset)(**kw),
            getattr(port_config, preset)(**kw))


def _port_encode(monkeypatch, cfg, clip):
    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)
    enc = TorchEncoder(cfg, "cpu")
    stream, recons = enc.encode(clip)
    assert set(enc.timing) == DEVICE_KEYS
    return stream, recons


def _pictures(stream):
    """(parameter-set NAL units, {POC: the picture's slice and SEI NAL
    units}, the POCs in stream order), the stream hash-clean."""
    nals = list(bs.split_annexb(stream))
    params = [n for n in nals if n[0] in PARAMETER_SETS]
    units = []
    for nal in nals:
        if nal[0] in PARAMETER_SETS:
            continue
        if nal[0] in (bs.NAL_TRAIL_R, bs.NAL_IDR_W_RADL):
            units.append([])
        units[-1].append(nal)
    pics = SpecDecoder().decode(stream)
    assert len(pics) == len(units) and all(p.hash_ok for p in pics)
    pocs = [p.poc for p in pics]
    return params, dict(zip(pocs, units)), pocs


@pytest.mark.parametrize("deblocking", [False, True])
def test_ra_pictures_match_classic_route(monkeypatch, deblocking):
    clip = synthesize_yuv(W, H, FRAMES, seed=85)
    jcfg, pcfg = _configs("random_access_gop16", width=W, height=H, qp=35,
                          frames=FRAMES, sao=False, rdoq=False,
                          rqt_inter=False, deblocking=deblocking)
    assert os.environ.get("FASTHEVC_FORCE_CLASSIC")
    want, want_recons = TpuEncoder(jcfg).encode(clip)
    got, recons = _port_encode(monkeypatch, pcfg, clip)
    params, pics, pocs = _pictures(got)
    want_params, want_pics, want_pocs = _pictures(want)
    assert params == want_params
    assert pocs == BATCH_ORDER and sorted(want_pocs) == sorted(pocs)
    for poc in pocs:
        assert pics[poc] == want_pics[poc], f"POC {poc}"
    for r, wr in zip(recons, want_recons):
        for plane in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(r, plane),
                                          np.asarray(getattr(wr, plane)))


def test_ra_defaults_decode_hash_clean(monkeypatch):
    """At the defaults (SAO, the device trellis on init_type 1 tables,
    TMVP, two references per list) the stream decodes hash-clean in the
    batch order, and the layered GOP-16 order forms the same batches, so
    its stream is the same byte for byte."""
    clip = synthesize_yuv(W, H, FRAMES, seed=85)
    _, ra = _configs("random_access_gop16", width=W, height=H, qp=32,
                     frames=FRAMES)
    got, _ = _port_encode(monkeypatch, ra, clip)
    _, pics, pocs = _pictures(got)
    assert pocs == BATCH_ORDER
    _, layered = _configs("random_access_gop16_layered", width=W, height=H,
                          qp=32, frames=FRAMES)
    again, _ = _port_encode(monkeypatch, layered, clip)
    assert again == got


@pytest.mark.slow
@pytest.mark.parametrize("extra", [{}, {"sao": False, "rdoq": False}])
def test_ra_stream_matches_tpu_device_route(monkeypatch, extra):
    """Against TpuEncoder's inter device route itself, byte for byte
    (several minutes of XLA compiles per config on the CPU)."""
    clip = synthesize_yuv(W, H, FRAMES, seed=85)
    jcfg, pcfg = _configs("random_access_gop16", width=W, height=H, qp=35,
                          frames=FRAMES, **extra)
    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)
    want, _ = TpuEncoder(jcfg).encode(clip)
    got, _ = _port_encode(monkeypatch, pcfg, clip)
    assert got == want
    _pictures(got)
