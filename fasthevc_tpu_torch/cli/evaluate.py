"""Evaluation harness: BASELINE.md configs, RD curves, BD-rate gates.

Usage:
  python -m fasthevc_tpu_torch.cli.evaluate --config 1   # AI 416x240 smoke
  python -m fasthevc_tpu_torch.cli.evaluate --config 2   # LDP 832x480 4-QP
  python -m fasthevc_tpu_torch.cli.evaluate --config 4   # fast-vs-full BD
  python -m fasthevc_tpu_torch.cli.evaluate --quick      # small variants
  ... [--device cuda|cpu]

Prints an RD table + JSON summary.  TorchEncoder runs on `--device`
(default cuda; a cuda request on a host without a CUDA device fails);
config 2 runs the NumPy SpecEncoder.  Config 4 asserts the fast-partition
BD-rate delta <= 2% (the north-star gate).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..codec.encoder import TorchEncoder
from ..config import EncoderConfig, low_delay_p
from ..spec.decoder import SpecDecoder
from ..spec.encoder import SpecEncoder
from ..utils import bd_rate, psnr, synthesize_yuv, yuv_from_planes
from .encode import device_error

QPS = (22, 27, 32, 37)


def rd_point(encoder, frames, width, height):
    t0 = time.time()
    stream, recons = encoder.encode(frames)
    dt = time.time() - t0
    # decode-verify
    pics = SpecDecoder().decode(stream)
    assert all(p.hash_ok for p in pics), "hash mismatch"
    ps = []
    for f, r in zip(frames, recons):
        ry, _, _ = yuv_from_planes((r.y, r.cb, r.cr), width, height)
        ps.append(psnr(f[0], ry))
    return len(stream) * 8, float(np.mean(ps)), dt


def rd_curve(make_encoder, cfg_base, frames, width, height, label):
    rates, psnrs = [], []
    for qp in QPS:
        cfg = cfg_base.replace(qp=qp)
        bits, p, dt = rd_point(make_encoder(cfg), frames, width, height)
        rates.append(bits)
        psnrs.append(p)
        print(f"  {label} QP{qp}: {bits/len(frames)/1000:7.1f} kbit/frame  "
              f"{p:6.3f} dB  {len(frames)/dt:5.2f} fps", file=sys.stderr)
    return rates, psnrs


def config1(quick=False, device="cuda"):
    w, h, n = (160, 96, 4) if quick else (416, 240, 8)
    frames = synthesize_yuv(w, h, n, seed=1)
    cfg = EncoderConfig(width=w, height=h, frames=n)
    bits, p, dt = rd_point(TorchEncoder(cfg.replace(qp=32), device), frames,
                           w, h)
    out = {"config": "AI-smoke", "bits": bits, "psnr_y": p,
           "fps": n / dt, "decode_verify": True}
    print(json.dumps(out))
    return out


def config2(quick=False):
    w, h, n = (160, 96, 4) if quick else (832, 480, 8)
    frames = synthesize_yuv(w, h, n, seed=2)
    cfg = low_delay_p(width=w, height=h, frames=n,
                      num_intra_rd_candidates=1)
    print("LDP RD curve (golden encoder):", file=sys.stderr)
    rates, psnrs = rd_curve(lambda c: SpecEncoder(c), cfg, frames, w, h,
                            "LDP")
    out = {"config": "LDP", "rates": rates, "psnrs": psnrs}
    print(json.dumps(out))
    return out


def config3(quick=False, frames_n=None, ablate_cascade=False,
            device="cuda"):
    """BASELINE config #3: random-access GOP-16, ParkScene-class 1080p,
    decode verify. quick: tiny frames for CI. --ablate-cascade also codes
    the same clip with the temporal QP cascade zeroed and reports the
    BD-rate of cascade vs flat QP (must be negative = cascade wins)."""
    from ..config import random_access_gop16

    if quick:
        w, h, n = 160, 96, 18
    else:
        w, h, n = 1920, 1080, (frames_n or 33)
    frames = synthesize_yuv(w, h, n, seed=3)
    cfg = random_access_gop16(width=w, height=h, frames=n)
    print(f"RA GOP-16 RD curve (TorchEncoder on {device}, "
          "decode-verified):", file=sys.stderr)
    rates, psnrs = rd_curve(lambda c: TorchEncoder(c, device), cfg, frames,
                            w, h, "RA")
    out = {"config": "RA-1080p" if not quick else "RA-quick",
           "rates": rates, "psnrs": psnrs, "decode_verify": True}
    if ablate_cascade:
        import dataclasses
        flat_gop = [dataclasses.replace(e, qp_offset=0) for e in cfg.gop]
        cfg_flat = cfg.replace(gop=flat_gop)
        print("flat-QP ablation curve:", file=sys.stderr)
        r_flat, p_flat = rd_curve(lambda c: TorchEncoder(c, device),
                                  cfg_flat, frames, w, h, "flat")
        delta = bd_rate(r_flat, p_flat, rates, psnrs)
        out["bd_rate_cascade_vs_flat_pct"] = delta
        out["cascade_wins"] = bool(delta < 0.0)
    print(json.dumps(out))
    return out


def config5(quick=False, device="cuda"):
    """BASELINE config #5: 4K multi-tile encode, GOP-parallel across N>=2
    processes (torch.distributed over a localhost address when no
    cluster)."""
    from ..parallel.multiproc import gop_parallel_encode_check

    # closed GOPs WITH P frames (intra_period-led segments, LDP inside):
    # each process owns whole GOPs where DPB state matters (VERDICT r2 #7)
    w, h, n = (256, 128, 8) if quick else (3840, 2160, 16)
    out = gop_parallel_encode_check(w, h, n, n_procs=2,
                                    tile_cols=2, tile_rows=2,
                                    intra_period=4 if quick else 8,
                                    device=device)
    print(json.dumps(out))
    return out


def config4(quick=False, params_path=None, device="cuda"):
    """Fast CU-partition model vs full RDO: BD-rate delta gate (<= 2%)."""
    from ..models import load_params, train_self_distilled

    w, h, n = (160, 96, 2) if quick else (416, 240, 4)
    if params_path:
        params = load_params(params_path)
    else:
        print("training partition model (self-distillation)...",
              file=sys.stderr)
        params = train_self_distilled(qps=(27, 37), steps=400,
                                      log=lambda m: print(m,
                                                          file=sys.stderr),
                                      device=device)
    frames = synthesize_yuv(w, h, n, seed=4)
    cfg = EncoderConfig(width=w, height=h, frames=n)
    print("full-search curve:", file=sys.stderr)
    r_full, p_full = rd_curve(lambda c: TorchEncoder(c, device), cfg,
                              frames, w, h, "full")
    print("fast-partition curve:", file=sys.stderr)
    r_fast, p_fast = rd_curve(
        lambda c: TorchEncoder(c.replace(fast_partition=True), device,
                               partition_params=params),
        cfg, frames, w, h, "fast")
    delta = bd_rate(r_full, p_full, r_fast, p_fast)
    out = {"config": "fast-vs-full", "bd_rate_pct": delta,
           "gate_2pct": bool(delta <= 2.0)}
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=1,
                    choices=[1, 2, 3, 4, 5])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--frames", type=int, help="override frame count")
    ap.add_argument("--ablate-cascade", action="store_true",
                    help="config 3: also run flat-QP and report BD-rate")
    ap.add_argument("--partition-model")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where TorchEncoder runs (cpu: the kernels' plain "
                         "twins)")
    args = ap.parse_args(argv)
    err = device_error(args.device) if args.config != 2 else None
    if err is not None:
        print(f"fasthevc-evaluate: {err}", file=sys.stderr)
        return 1
    if args.config == 1:
        config1(args.quick, args.device)
    elif args.config == 2:
        config2(args.quick)
    elif args.config == 3:
        config3(args.quick, args.frames, args.ablate_cascade, args.device)
    elif args.config == 5:
        out = config5(args.quick, args.device)
        return 0 if out.get("ok") else 1
    else:
        out = config4(args.quick, args.partition_model, args.device)
        return 0 if out["gate_2pct"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
