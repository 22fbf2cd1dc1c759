"""fasthevc_tpu_torch.codec.encoder.TorchEncoder against TpuEncoder.

Under FASTHEVC_FORCE_CLASSIC=1 (tests/conftest.py) TpuEncoder encodes an
all-intra clip on its pipelined route: the JAX search, then the C++ slice
engine.  TorchEncoder on the CPU (the kernels' twins, then the same C++
engine) must write the same bytes at the default config (RDOQ, SAO,
deblocking and SDH on), and its stream must decode hash-clean.
"""

import os
import subprocess
import sys

import pytest

from fasthevc_tpu.codec.encoder import TpuEncoder
from fasthevc_tpu.config import EncoderConfig, low_delay_p
from fasthevc_tpu.spec.decoder import SpecDecoder
from fasthevc_tpu.utils import synthesize_yuv
from fasthevc_tpu_torch.codec.encoder import TorchEncoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("w,h,qp,seed,frames,extra", [
    (96, 64, 32, 21, 2, {}),
    (104, 72, 27, 3, 2, {}),
    (128, 96, 33, 77, 2, {"tile_cols": 2, "tile_rows": 2}),
    (96, 64, 35, 12, 3, {"frame_group": 2, "hash_type": 2}),
    (96, 64, 27, 2, 2, {"log2_ctu": 6}),
])
def test_stream_matches_tpu_encoder(w, h, qp, seed, frames, extra):
    clip = synthesize_yuv(w, h, frames, seed=seed)
    cfg = EncoderConfig(width=w, height=h, qp=qp, frames=frames, **extra)
    want, want_recons = TpuEncoder(cfg).encode(clip)
    got, recons = TorchEncoder(cfg, "cpu").encode(clip)
    assert got == want
    assert len(recons) == frames
    for r, wr in zip(recons, want_recons):
        assert (r.y == wr.y).all() and (r.cb == wr.cb).all()
    pics = SpecDecoder().decode(got)
    assert len(pics) == frames and all(p.hash_ok for p in pics)


def test_single_frame_matches_tpu_encoder():
    """One frame: TpuEncoder takes its per-frame route, the port its
    group route with a group of one; the decisions are the same."""
    clip = synthesize_yuv(88, 72, 1, seed=22)
    cfg = EncoderConfig(width=88, height=72, qp=30, frames=1)
    want, _ = TpuEncoder(cfg).encode(clip)
    got, _ = TorchEncoder(cfg, "cpu").encode(clip)
    assert got == want


def test_plain_flag_gives_the_same_stream():
    clip = synthesize_yuv(64, 64, 2, seed=31)
    cfg = EncoderConfig(width=64, height=64, qp=32, frames=2)
    enc = TorchEncoder(cfg, "cpu")
    a, _ = enc.encode(clip)
    b, _ = TorchEncoder(cfg, "cpu", plain=True).encode(clip)
    assert a == b
    assert set(enc.timing) == {"search_s", "wait_s", "commit_s", "wall_s"}


def test_port_imports_no_jax():
    code = ("import sys; import fasthevc_tpu_torch.codec.encoder; "
            "import fasthevc_tpu_torch.codec.search; "
            "import fasthevc_tpu_torch.codec.device_pipeline; "
            "import fasthevc_tpu_torch.ops.rdoq; "
            "import fasthevc_tpu_torch.ops.commit; "
            "import fasthevc_tpu_torch.ops.deblock; "
            "import fasthevc_tpu_torch.ops.sao; "
            "import fasthevc_tpu_torch._build; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'flax', 'fasthevc_tpu.ops', "
            "'fasthevc_tpu.codec.search', 'fasthevc_tpu.codec.encoder', "
            "'fasthevc_tpu.codec.device_pipeline'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("kw", [
    {"lossless": True}, {"fast_partition": True},
    {"target_bitrate": 200000}, {"search_recon_refs": True},
    {"hrd": True}, {"rqt_intra": True}, {"wpp": True},
    {"scaling_lists": True},
])
def test_unported_tools_raise(kw):
    cfg = EncoderConfig(width=64, height=64, qp=32, frames=2, **kw)
    with pytest.raises(NotImplementedError):
        TorchEncoder(cfg, "cpu")


def test_inter_orders_raise():
    cfg = low_delay_p(width=64, height=64, frames=3)
    clip = synthesize_yuv(64, 64, 3, seed=1)
    with pytest.raises(NotImplementedError, match="item 8"):
        TorchEncoder(cfg, "cpu").encode(clip)
