"""Encoder CLI (HM TAppEncoder analog, SURVEY.md E1).

Usage:
  python -m fasthevc_tpu_torch.cli.encode --synth 416x240 --frames 8 \
      --qp 32 -b out.bin [--recon rec.yuv] [--lossless] \
      [--engine torch|spec] [--device cuda|cpu]
  python -m fasthevc_tpu_torch.cli.encode -i in.yuv --size 416x240 \
      --frames 8 ...

Prints one per-picture log line (HM-style: POC, PSNR) and a summary;
exits nonzero on failure.  `--engine torch` (the default) runs
TorchEncoder on `--device` (default cuda: the hand-written kernels; cpu:
their plain twins); a cuda request on a host without a CUDA device fails
before anything is encoded.  `--engine spec` runs the NumPy SpecEncoder on
the host.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..utils import psnr, synthesize_yuv, yuv_from_planes


def read_yuv(path: str, width: int, height: int, frames: int):
    """Read planar 4:2:0 8-bit YUV."""
    ysz, csz = width * height, (width // 2) * (height // 2)
    out = []
    with open(path, "rb") as f:
        for _ in range(frames):
            y = np.frombuffer(f.read(ysz), np.uint8).reshape(height, width)
            cb = np.frombuffer(f.read(csz), np.uint8).reshape(height // 2,
                                                              width // 2)
            cr = np.frombuffer(f.read(csz), np.uint8).reshape(height // 2,
                                                              width // 2)
            out.append((y, cb, cr))
    return out


def write_yuv(path: str, frames) -> None:
    with open(path, "wb") as f:
        for y, cb, cr in frames:
            f.write(np.asarray(y, np.uint8).tobytes())
            f.write(np.asarray(cb, np.uint8).tobytes())
            f.write(np.asarray(cr, np.uint8).tobytes())


def device_error(device: str) -> str | None:
    """Why the encoder cannot run on `device` here, or None when it can."""
    if device == "cuda" and not torch.cuda.is_available():
        return ("--device cuda: no CUDA device is available "
                "(torch.cuda.is_available() is false); pass --device cpu "
                "to run the kernels' plain twins on the CPU")
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fasthevc-encode")
    ap.add_argument("-i", "--input", help="input YUV (planar 4:2:0 8-bit)")
    ap.add_argument("--synth", help="synthesize WxH test content instead")
    ap.add_argument("--size", help="WxH of input YUV")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--qp", type=int, default=32)
    ap.add_argument("-b", "--bitstream", required=True)
    ap.add_argument("--recon", help="write reconstruction YUV")
    ap.add_argument("--lossless", action="store_true")
    ap.add_argument("--ctu", type=int, default=32, choices=[16, 32, 64])
    ap.add_argument("--rd-candidates", type=int, default=3)
    ap.add_argument("--engine", default="torch", choices=["torch", "spec"],
                    help="torch: TorchEncoder on --device; spec: the NumPy "
                         "SpecEncoder on the host")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where TorchEncoder runs (cpu: the kernels' plain "
                         "twins)")
    ap.add_argument("--preset", default="all_intra",
                    choices=["all_intra", "low_delay_p",
                             "random_access_gop16",
                             "random_access_gop16_layered"])
    ap.add_argument("--tiles", default="1x1",
                    help="tile columns x rows, e.g. 4x2")
    ap.add_argument("--bitrate", type=int, default=0,
                    help="target bits/s (enables rate control)")
    ap.add_argument("--nxn-intra", action="store_true",
                    help="search PART_NxN intra at min CU (spec engine)")
    ap.add_argument("--transform-skip", action="store_true",
                    help="search transform_skip on 4x4 TBs (spec engine)")
    ap.add_argument("--hash-type", type=int, default=0, choices=[0, 1, 2],
                    help="decoded-picture-hash SEI: 0 MD5, 1 CRC, "
                         "2 checksum")
    ap.add_argument("--search-range", type=int, default=64,
                    help="motion search range (full-pel; hierarchical ME "
                         "beyond 8)")
    ap.add_argument("--wpp", action="store_true",
                    help="WPP entropy substreams (spec engine)")
    ap.add_argument("--slices", type=int, default=1,
                    help="independent slice segments per picture "
                         "(spec engine)")
    ap.add_argument("--weighted-pred", action="store_true",
                    help="explicit weighted prediction (fades)")
    ap.add_argument("--scaling-lists", action="store_true",
                    help="default quantization scaling lists "
                         "(spec engine)")
    ap.add_argument("--metrics", help="write per-picture JSONL records")
    ap.add_argument("--profile",
                    help="write a torch.profiler trace of the encode into "
                         "this directory (Chrome trace JSON)")
    args = ap.parse_args(argv)

    if args.engine == "torch":
        err = device_error(args.device)
        if err is not None:
            print(f"fasthevc-encode: {err}", file=sys.stderr)
            return 1

    if args.synth:
        w, h = map(int, args.synth.split("x"))
        frames = synthesize_yuv(w, h, args.frames)
    elif args.input and args.size:
        w, h = map(int, args.size.split("x"))
        frames = read_yuv(args.input, w, h, args.frames)
    else:
        ap.error("need --synth WxH or (-i FILE --size WxH)")

    from ..config import (all_intra, low_delay_p, random_access_gop16,
                          random_access_gop16_layered)
    preset_fn = {"all_intra": all_intra, "low_delay_p": low_delay_p,
                 "random_access_gop16": random_access_gop16,
                 "random_access_gop16_layered":
                     random_access_gop16_layered}[args.preset]
    try:
        tc, tr = map(int, args.tiles.lower().split("x"))
    except ValueError:
        ap.error(f"--tiles expects COLSxROWS (e.g. 4x2), got {args.tiles!r}")
    cfg = preset_fn(width=w, height=h, qp=args.qp, frames=args.frames,
                    lossless=args.lossless,
                    log2_ctu=args.ctu.bit_length() - 1,
                    num_intra_rd_candidates=args.rd_candidates,
                    tile_cols=tc, tile_rows=tr,
                    target_bitrate=args.bitrate,
                    nxn_intra=args.nxn_intra,
                    transform_skip=args.transform_skip,
                    hash_type=args.hash_type,
                    search_range=args.search_range,
                    wpp=args.wpp, slices=args.slices,
                    weighted_pred=args.weighted_pred,
                    scaling_lists=args.scaling_lists)

    if args.engine == "torch":
        from ..codec.encoder import TorchEncoder
        enc = TorchEncoder(cfg, args.device)
    else:
        from ..spec.encoder import SpecEncoder
        enc = SpecEncoder(cfg)
    frame_info = {}

    def on_frame(poc, is_idr, nal_bytes):
        if poc >= 0:
            frame_info[poc] = (is_idr, len(nal_bytes) * 8)

    on_card = args.engine == "torch" and args.device == "cuda"
    t0 = time.time()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                         else [])
        with profile(activities=acts) as prof:
            stream, recons = enc.encode(frames, on_frame=on_frame)
            if on_card:
                torch.cuda.synchronize()
    else:
        stream, recons = enc.encode(frames, on_frame=on_frame)
    dt = time.time() - t0
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile,
                                              "encode_trace.json"))

    with open(args.bitstream, "wb") as f:
        f.write(stream)

    metrics = None
    if args.metrics:
        from ..utils.metrics import MetricsLog
        metrics = MetricsLog(args.metrics)
    rec_frames = []
    total_psnr = np.zeros(3)
    for poc, (frame, rec) in enumerate(zip(frames, recons)):
        ry, rcb, rcr = yuv_from_planes((rec.y, rec.cb, rec.cr), w, h)
        rec_frames.append((ry, rcb, rcr))
        ps = [psnr(frame[0], ry), psnr(frame[1], rcb), psnr(frame[2], rcr)]
        total_psnr += ps
        print(f"POC {poc:4d} [Y {ps[0]:7.4f} dB  U {ps[1]:7.4f} dB  "
              f"V {ps[2]:7.4f} dB]")
        if metrics is not None:
            from ..utils.metrics import PictureRecord
            is_idr, bits = frame_info.get(poc, (True, 0))
            metrics.add(PictureRecord(
                poc=poc, slice_type="I" if is_idr else "PB", qp=args.qp,
                bits=bits, psnr_y=float(ps[0]), psnr_u=float(ps[1]),
                psnr_v=float(ps[2]),
                times={"total": dt / len(frames)}))
    if metrics is not None:
        metrics.close()
    if args.recon:
        write_yuv(args.recon, rec_frames)

    n = len(frames)
    bits = len(stream) * 8
    print(f"SUMMARY: {n} frames, {bits} bits "
          f"({bits / n:.0f} bits/frame), "
          f"Y {total_psnr[0] / n:.4f} dB, U {total_psnr[1] / n:.4f} dB, "
          f"V {total_psnr[2] / n:.4f} dB, {dt:.2f} s "
          f"({n / dt:.3f} fps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
