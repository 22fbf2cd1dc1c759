"""TorchEncoder's random-access device route against TpuEncoder.

On the CPU TorchEncoder runs B batches through the kernels' twins: the B
search (both lists, merge candidates, BI through K12's twin), exact MC
with bi-prediction, the mixed wavefront commit, deblocking with both
lists' strengths, SAO and the checksum, the on-device DPB with list-1
stacks, TMVP collocated from list 1, and CABAC with init_type 2.

The device route sends a GOP-16 in dependency batches, [16] [8] [4, 12]
[2, 6, 10, 14] [the odd POCs] (below 1280x720; from there up at most 4
pictures a batch, as TpuEncoder's batcher caps them), and writes its
pictures in that order, as TpuEncoder's device route does; TpuEncoder's classic per-frame route
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
from fasthevc_tpu_torch.codec.gop import coding_order
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


def _reference_batches(monkeypatch, jcfg, frames: int) -> list:
    """The POCs of TpuEncoder's GOP-route batches, in dispatch order, with
    nothing encoded: frame i is flat at value i, the device programs are
    replaced by stubs that read each batch's POCs off its planes (a pad
    slot repeats the batch's last picture) and return zero decisions, and
    CABAC by a stub, so its batcher runs as written."""
    import fasthevc_tpu.cabac_cpp as jax_cabac
    import fasthevc_tpu.codec.device_pipeline as jax_pipeline

    batches = []

    def stub(yb, *_, **__):
        pocs = [int(v) for v in np.asarray(yb[:, 0, 0])]
        batches.append(pocs[:pocs.index(pocs[-1]) + 1])
        f, h, w = yb.shape
        z = np.zeros((f, 1, 1), np.uint8)
        return {"packed": np.zeros((f, h // 8, w // 8, 9), np.int16),
                "lv8_y": z, "lv8_cb": z, "lv8_cr": z, "sao": z,
                "rec_y": z, "rec_cb": z, "rec_cr": z,
                "overflow": np.zeros((f, 3), bool),
                "cksum": np.zeros((f, 3), np.uint32)}

    monkeypatch.setattr(jax_pipeline, "encode_group_device", stub)
    monkeypatch.setattr(jax_pipeline, "encode_inter_group_device", stub)
    monkeypatch.setattr(jax_cabac, "entropy_slice_native",
                        lambda *_, **__: [b""])
    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)
    clip = [tuple(np.full((hh, ww), i, np.uint8)
                  for hh, ww in ((jcfg.height, jcfg.width),
                                 (jcfg.height // 2, jcfg.width // 2),
                                 (jcfg.height // 2, jcfg.width // 2)))
            for i in range(frames)]
    TpuEncoder(jcfg).encode(clip)
    return batches


def _port_batches(pcfg, frames: int) -> list:
    enc = TorchEncoder(pcfg, "cpu")
    return [[e.poc for e in b] for b in enc._gop_schedule(
        coding_order(pcfg, frames, 0), 0)]


@pytest.mark.parametrize("w,h,frames,cap,env", [
    (1920, 1080, 33, 4, None), (1920, 1080, 17, 4, None),
    (64, 64, 33, 8, None), (64, 64, 33, 2, "2")])
def test_gop_batches_follow_the_reference_batcher(monkeypatch, w, h, frames,
                                                  cap, env):
    """The IDR and one or two GOP-16s in one CVS (no intra period): batches
    of at most 4 P or B pictures from 1280x720 up, 8 below, or
    FASTHEVC_MAX_INTER_BATCH; the stream's picture order is the batches'.
    At 1080p the reference's order of 33 frames puts POC 1 at stream
    position 11 (a cap of 8 put POC 20 there), and 17 frames go in 7
    batches."""
    if env is not None:
        monkeypatch.setenv("FASTHEVC_MAX_INTER_BATCH", env)
    jcfg, pcfg = (c.replace(intra_period=-1) for c in _configs(
        "random_access_gop16", width=w, height=h, qp=32, frames=frames))
    got = _port_batches(pcfg, frames)
    assert got == _reference_batches(monkeypatch, jcfg, frames)
    assert max(len(b) for b in got) == cap
    if (w, frames) == (1920, 33):
        assert got[:8] == [[0], [16], [8, 32], [4, 12, 24], [2, 6, 10, 14],
                           [1, 3, 5, 7], [9, 11, 13, 15], [20, 28]]
        assert [p for b in got for p in b][11] == 1
    if (w, frames) == (1920, 17):
        assert [len(b) for b in got] == [1, 1, 1, 2, 4, 4, 4]
