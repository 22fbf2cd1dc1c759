"""fasthevc_tpu_torch.codec.encoder.TorchEncoder against TpuEncoder.

Under FASTHEVC_FORCE_CLASSIC=1 (tests/conftest.py) TpuEncoder encodes an
all-intra clip on its pipelined route (one picture, and P orders, on its
per-frame route): the JAX search, then the C++ slice engine.  TorchEncoder
on the CPU (the kernels' twins, then the same C++ engine) must write the
same bytes at the default config (RDOQ, SAO, deblocking and SDH on), and
its stream must decode hash-clean.
"""

import os
import subprocess
import sys

import pytest
import torch

from fasthevc_tpu.codec.encoder import TpuEncoder
from fasthevc_tpu.config import EncoderConfig as JaxConfig
from fasthevc_tpu.config import low_delay_p as jax_low_delay_p
from fasthevc_tpu.spec.decoder import SpecDecoder
from fasthevc_tpu_torch.codec.encoder import TorchEncoder
from fasthevc_tpu_torch.config import EncoderConfig, low_delay_p
from fasthevc_tpu_torch.models import init_params, params_to_flax
from fasthevc_tpu_torch.utils import synthesize_yuv

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

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
    kw = dict(width=w, height=h, qp=qp, frames=frames, **extra)
    want, want_recons = TpuEncoder(JaxConfig(**kw)).encode(clip)
    got, recons = TorchEncoder(EncoderConfig(**kw), "cpu").encode(clip)
    assert got == want
    assert len(recons) == frames
    for r, wr in zip(recons, want_recons):
        assert (r.y == wr.y).all() and (r.cb == wr.cb).all()
    pics = SpecDecoder().decode(got)
    assert len(pics) == frames and all(p.hash_ok for p in pics)


def test_single_frame_matches_tpu_encoder():
    """One frame: both packages take their per-frame route."""
    clip = synthesize_yuv(88, 72, 1, seed=22)
    kw = dict(width=88, height=72, qp=30, frames=1)
    want, _ = TpuEncoder(JaxConfig(**kw)).encode(clip)
    got, _ = TorchEncoder(EncoderConfig(**kw), "cpu").encode(clip)
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
            "import fasthevc_tpu_torch.models; "
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
    {"rqt_intra": True}, {"wpp": True}, {"scaling_lists": True},
])
def test_unported_tools_raise(kw):
    """The tools TpuEncoder refuses too (they run on the spec tier)."""
    cfg = EncoderConfig(width=64, height=64, qp=32, frames=2, **kw)
    with pytest.raises(NotImplementedError):
        TorchEncoder(cfg, "cpu")


def test_fast_partition_requires_params():
    cfg = EncoderConfig(width=64, height=64, qp=32, frames=2,
                        fast_partition=True)
    with pytest.raises(ValueError, match="partition_params"):
        TorchEncoder(cfg, "cpu")


def test_a_ctu32_partition_cnn_on_a_ctu64_config_raises():
    params = params_to_flax(init_params(torch.Generator().manual_seed(0),
                                         device="cpu"))
    cfg = EncoderConfig(width=64, height=64, qp=32, frames=2, log2_ctu=6,
                        fast_partition=True)
    with pytest.raises(ValueError, match="depths"):
        TorchEncoder(cfg, "cpu", partition_params=params)
    # the same network fits CTU 32
    TorchEncoder(cfg.replace(log2_ctu=5), "cpu", partition_params=params)


def test_inter_orders_raise():
    """P orders under FASTHEVC_FORCE_CLASSIC (tests/conftest.py) take the
    classic per-frame route in both packages, and the port's stream (once
    refused) is TpuEncoder's."""
    assert os.environ.get("FASTHEVC_FORCE_CLASSIC")
    clip = synthesize_yuv(64, 64, 3, seed=1)
    want, _ = TpuEncoder(jax_low_delay_p(width=64, height=64,
                                         frames=3)).encode(clip)
    enc = TorchEncoder(low_delay_p(width=64, height=64, frames=3), "cpu")
    got, _ = enc.encode(clip)
    assert set(enc.timing) == {"search_s", "commit_s", "wall_s"}
    assert got == want
    pics = SpecDecoder().decode(got)
    assert len(pics) == 3 and all(p.hash_ok for p in pics)
