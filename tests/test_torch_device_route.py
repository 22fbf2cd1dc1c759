"""TorchEncoder's device route against TpuEncoder's, and the routing.

With FASTHEVC_FORCE_CLASSIC unset, TpuEncoder encodes an all-intra CTU-32
clip on its device route (search, wavefront commit with the device
trellis, deblock, SAO and checksum in one program per frame group; the
host emits CABAC).  TorchEncoder on the CPU runs the same route through
the kernels' twins and must write the same bytes, at the default config
(RDOQ, SAO, deblocking and SDH on) and on a tiled picture, and its
streams must decode hash-clean.  The configs are those of
tests/test_device_commit.py, so the JAX programs are shared with it.
"""

import numpy as np
import pytest

from fasthevc_tpu.codec.encoder import TpuEncoder
from fasthevc_tpu.config import EncoderConfig
from fasthevc_tpu.spec.decoder import SpecDecoder
from fasthevc_tpu.utils import synthesize_yuv
from fasthevc_tpu_torch.codec.encoder import TorchEncoder

DEVICE_KEYS = {"device_s", "wait_s", "entropy_s", "wall_s"}
PIPELINED_KEYS = {"search_s", "wait_s", "commit_s", "wall_s"}


@pytest.fixture(autouse=True)
def _enable_device_paths(monkeypatch):
    """The suite forces the pipelined route (tests/conftest.py); this
    module tests the device route."""
    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)


@pytest.mark.parametrize("w,h,qp,seed,frames,extra", [
    (104, 72, 30, 4, 4, {}),
    (128, 96, 30, 5, 2, {"tile_cols": 2, "tile_rows": 1, "sao": False,
                         "rdoq": False}),
])
def test_stream_matches_tpu_device_route(w, h, qp, seed, frames, extra):
    clip = synthesize_yuv(w, h, frames, seed=seed)
    cfg = EncoderConfig(width=w, height=h, qp=qp, frames=frames, **extra)
    want, want_recons = TpuEncoder(cfg).encode(clip)
    enc = TorchEncoder(cfg, "cpu")
    got, recons = enc.encode(clip)
    assert set(enc.timing) == DEVICE_KEYS
    assert got == want
    for r, wr in zip(recons, want_recons):
        for plane in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(r, plane),
                                          np.asarray(getattr(wr, plane)))
    pics = SpecDecoder().decode(got)
    assert len(pics) == frames and all(p.hash_ok for p in pics)


@pytest.mark.parametrize("hash_type", [0, 2])
def test_hash_types_on_the_device_route(hash_type):
    """The checksum comes from the device; MD5 from the fetched recon."""
    clip = synthesize_yuv(64, 64, 2, seed=8)
    cfg = EncoderConfig(width=64, height=64, qp=34, frames=2,
                        hash_type=hash_type)
    stream, _ = TorchEncoder(cfg, "cpu").encode(clip)
    pics = SpecDecoder().decode(stream)
    assert len(pics) == 2 and all(p.hash_ok for p in pics)


@pytest.mark.parametrize("log2_ctu,force,keys", [
    (5, False, DEVICE_KEYS), (6, False, PIPELINED_KEYS),
    (5, True, PIPELINED_KEYS)])
def test_routing(monkeypatch, log2_ctu, force, keys):
    """CTU 32 takes the device route unless FASTHEVC_FORCE_CLASSIC is set;
    CTU 64 takes the pipelined route, as in TpuEncoder."""
    if force:
        monkeypatch.setenv("FASTHEVC_FORCE_CLASSIC", "1")
    clip = synthesize_yuv(64, 64, 2, seed=6)
    cfg = EncoderConfig(width=64, height=64, qp=32, frames=2,
                        log2_ctu=log2_ctu)
    enc = TorchEncoder(cfg, "cpu")
    stream, _ = enc.encode(clip)
    assert set(enc.timing) == keys
    assert all(p.hash_ok for p in SpecDecoder().decode(stream))
