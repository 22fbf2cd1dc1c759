"""The port's CLIs (fasthevc_tpu_torch.cli) against the JAX package's.

The encode CLI with `--engine torch --device cpu` runs TorchEncoder on
the kernels' twins; the JAX CLI with `--engine tpu` runs TpuEncoder.  On
the same input file both must write the same stream, the same recon YUV
and the same per-picture metrics (apart from the wall times), and print
the same per-picture lines.  Both decode CLIs must print the same lines
and YUV, and exit 2 on a truncated stream.  The port's default device is
the card: on a host without one the CLI fails before it encodes.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from fasthevc_tpu.cli import decode as jax_decode
from fasthevc_tpu.cli import encode as jax_encode
from fasthevc_tpu_torch.cli import decode, encode, evaluate
from fasthevc_tpu_torch.codec.encoder import TorchEncoder
from fasthevc_tpu_torch.config import EncoderConfig
from fasthevc_tpu_torch.utils import synthesize_yuv

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

W, H, FRAMES, QP = 96, 64, 2, 32


def _poc_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("POC")]


def _records(path):
    with open(path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    for r in recs:
        r.pop("times")
    return recs


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """The 96x64 clip through both encode CLIs: {package: (paths, rc,
    stdout)}."""
    d = tmp_path_factory.mktemp("cli")
    yuv = str(d / "in.yuv")
    encode.write_yuv(yuv, synthesize_yuv(W, H, FRAMES, seed=21))
    common = ["-i", yuv, "--size", f"{W}x{H}", "--frames", str(FRAMES),
              "--qp", str(QP)]
    out = {}
    for name, mod, extra in (("port", encode, ["--engine", "torch",
                                               "--device", "cpu"]),
                             ("jax", jax_encode, ["--engine", "tpu"])):
        paths = {k: str(d / f"{name}.{k}") for k in ("bin", "yuv", "jsonl")}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(common + extra + [
                "-b", paths["bin"], "--recon", paths["yuv"], "--metrics",
                paths["jsonl"]])
        out[name] = (paths, rc, buf.getvalue())
    return out


def test_encode_cli_matches_jax_cli(encoded):
    (pp, prc, pout), (jp, jrc, jout) = encoded["port"], encoded["jax"]
    assert prc == 0 and jrc == 0
    assert _read(pp["bin"]) == _read(jp["bin"])
    assert _read(pp["yuv"]) == _read(jp["yuv"])
    assert len(_read(pp["yuv"])) == FRAMES * W * H * 3 // 2
    assert _records(pp["jsonl"]) == _records(jp["jsonl"])
    assert len(_records(pp["jsonl"])) == FRAMES
    assert _poc_lines(pout) == _poc_lines(jout)
    summary = [ln for ln in pout.splitlines() if ln.startswith("SUMMARY:")]
    assert len(summary) == 1 and f"{FRAMES} frames" in summary[0]


def test_decode_cli_matches_jax_cli(encoded, tmp_path, capsys):
    stream = encoded["port"][0]["bin"]
    outs = {}
    for name, mod in (("port", decode), ("jax", jax_decode)):
        yuv = str(tmp_path / f"{name}.yuv")
        rc = mod.main(["-b", stream, "-o", yuv])
        outs[name] = (rc, capsys.readouterr().out, _read(yuv))
    assert outs["port"] == outs["jax"]
    rc, text, yuv = outs["port"]
    assert rc == 0 and text.rstrip().endswith("hash OK")
    assert yuv == _read(encoded["port"][0]["yuv"])
    cut = tmp_path / "cut.bin"
    data = _read(stream)
    cut.write_bytes(data[:len(data) - 40])
    for mod in (decode, jax_decode):
        assert mod.main(["-b", str(cut)]) == 2
        assert "ERROR: corrupt or truncated" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="the host has a "
                    "CUDA device, so --device cuda would run")
@pytest.mark.parametrize("cli", ["encode", "evaluate"])
def test_default_device_needs_a_card(cli, tmp_path, capsys):
    """No CUDA device: the default --device cuda fails loudly, naming the
    device, and writes no stream."""
    out = tmp_path / "out.bin"
    if cli == "encode":
        rc = encode.main(["--synth", "64x64", "--frames", "1", "-b",
                          str(out)])
    else:
        rc = evaluate.main(["--config", "1", "--quick"])
    assert rc != 0
    assert "--device cuda" in capsys.readouterr().err
    assert not out.exists()


def test_profile_writes_a_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    rc = encode.main(["--synth", "64x64", "--frames", "1", "--device",
                      "cpu", "-b", str(tmp_path / "out.bin"), "--profile",
                      str(trace_dir)])
    assert rc == 0
    files = list(trace_dir.iterdir())
    assert files and all(f.stat().st_size > 0 for f in files)
    with open(files[0]) as f:
        assert json.load(f)["traceEvents"]


def test_evaluate_config1_quick(capsys):
    assert evaluate.main(["--config", "1", "--quick", "--device",
                          "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    out = json.loads(lines[-1])
    assert out["config"] == "AI-smoke" and out["decode_verify"] is True
    frames = synthesize_yuv(160, 96, 4, seed=1)
    cfg = EncoderConfig(width=160, height=96, frames=4, qp=32)
    stream, _ = TorchEncoder(cfg, "cpu").encode(frames)
    assert out["bits"] == len(stream) * 8
