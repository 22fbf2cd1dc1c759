#!/usr/bin/env python3
"""Drive the fasthevc_tpu_torch all-intra encoder once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  0. the card: requires torch.cuda.is_available(); prints nvidia-smi's
     name and power limit;
  1. builds the CUDA kernels from fasthevc_tpu_torch/csrc;
  2. runs kernels K1-K4 against their plain PyTorch twins on the card, at
     the shapes a 1920x1080 frame group of 8 gives them, from seeded numpy
     inputs: K1-K3 must match exactly, K4's dist exactly (below 2^24) and
     its rate within 1e-5 relative; prints each median time beside the
     twin's (CUDA events);
  3. encodes synthesized 1920x1080 QP32 frames with TorchEncoder (default
     tools, tile grid and hash type as bench.py sets them): one warm-up
     group, then 16 timed frames; prints fps, kbit/frame, Y-PSNR and the
     search / host-commit split, and requires every kernel to have been
     launched by that encode;
  4. encodes the same 16 frames with the twins on the card: the stream
     must be byte-identical;
  5. encodes a 416x240 2-frame clip on the card and with the twins on the
     CPU: the streams must be identical and decode with matching picture
     hashes in SpecDecoder.

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT, GROUP, TIMED = 1920, 1080, 8, 16
RATE_RTOL = 1e-5


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int = 7) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _kernel_inputs(torch, dev):
    """Seeded 1080p frame group (padded to the CTU grid), as the search
    holds it: luma [8, 1088, 1920] and chroma [8, 544, 960] int32."""
    rng = np.random.default_rng(2024)
    ph = -(-HEIGHT // 32) * 32
    # smooth content plus noise, so every mode and level class occurs
    yy, xx = np.mgrid[0:ph, 0:WIDTH]
    base = (96 + 64 * np.sin(xx / 37.0) * np.cos(yy / 23.0)).astype(np.int32)
    y = np.clip(base[None] + rng.integers(-40, 41, (GROUP, ph, WIDTH)),
                0, 255).astype(np.int32)
    c = np.clip(128 + rng.integers(-30, 31, (GROUP, ph // 2, WIDTH // 2)),
                0, 255).astype(np.int32)
    return torch.from_numpy(y).to(dev), torch.from_numpy(c).to(dev)


def phase_kernels(torch, dev) -> tuple:
    from fasthevc_tpu_torch.codec.search import _blocks, search_qp
    from fasthevc_tpu_torch.ops import cost, intra, transform

    y, c = _kernel_inputs(torch, dev)
    qp = search_qp(float(np.sqrt(0.57 * 2.0 ** ((32 - 12) / 3.0))))
    errs = {"intra_pred": 0.0, "satd": 0.0, "tq_roundtrip": 0.0,
            "sse_rate": 0.0}
    timed = {}

    def same(name, a, b):
        if not torch.equal(a, b):
            bad = (a != b).sum().item()
            raise AssertionError(f"{name}: {bad} values differ from the twin")

    def k4_check(name, got, want):
        (dk, rk), (dp, rp) = got, want
        exact = dp < 2.0 ** 24
        if not torch.equal(dk[exact], dp[exact]):
            raise AssertionError(f"{name}: K4 dist differs from the twin")
        rel = ((rk - rp).abs() / rp.abs().clamp_min(1e-30)).max().item()
        if rel > RATE_RTOL:
            raise AssertionError(f"{name}: K4 rate rel err {rel:.3g}")
        errs["sse_rate"] = max(errs["sse_rate"], (rk - rp).abs().max().item())

    # luma: all 35 modes, SATD, then the true-RD pass on the top 3 modes
    for n in (8, 16, 32):
        lg = n.bit_length() - 1
        top, left = intra.grid_refs(y, n)
        src = _blocks(y, n).contiguous()
        pk = intra.predict_all_modes(top, left, lg)
        same(f"K1 n={n}", pk, intra.predict_plain(top, left, lg))
        sk = cost.satd(src, pk)
        same(f"K2 n={n}", sk, cost.satd_plain(src, pk))
        res = (src[:, None] - pk[:, :3]).reshape(-1, n, n).contiguous()
        lk, rk = transform.tq_roundtrip(res, qp, lg)
        lp, rp = transform.tq_roundtrip_plain(res, qp, lg)
        same(f"K3 levels n={n}", lk, lp)
        same(f"K3 recon n={n}", rk, rp)
        k4_check(f"n={n}", cost.sse_rate(res, rk, lk),
                 cost.sse_rate_plain(res, rk, lk))
        if n == 8:  # the largest batch: B = 8 * 136 * 240 blocks
            timed["intra_pred"] = (
                _median_ms(lambda: intra.predict_all_modes(top, left, lg)),
                _median_ms(lambda: intra.predict_plain(top, left, lg)))
            timed["satd"] = (_median_ms(lambda: cost.satd(src, pk)),
                             _median_ms(lambda: cost.satd_plain(src, pk)))
            timed["tq_roundtrip"] = (
                _median_ms(lambda: transform.tq_roundtrip(res, qp, lg)),
                _median_ms(lambda: transform.tq_roundtrip_plain(res, qp, lg)))
            timed["sse_rate"] = (
                _median_ms(lambda: cost.sse_rate(res, rk, lk)),
                _median_ms(lambda: cost.sse_rate_plain(res, rk, lk)))
        del pk, sk, res, lk, rk, lp, rp
    # chroma DM: one selected mode per block
    gen = torch.Generator(device="cpu").manual_seed(7)
    for cn in (4, 8, 16):
        lg = cn.bit_length() - 1
        top, left = intra.grid_refs(c, cn)
        modes = torch.randint(0, 35, (top.shape[0],), generator=gen).to(dev)
        pk = intra.predict_selected(top, left, lg, modes, is_luma=False)
        pp = intra.predict_plain(top, left, lg, modes[:, None], False)[:, 0]
        same(f"K1 chroma n={cn}", pk, pp)
        res = (_blocks(c, cn) - pk).contiguous()
        lk, rk = transform.tq_roundtrip(res, qp, lg)
        lp, rp = transform.tq_roundtrip_plain(res, qp, lg)
        same(f"K3 chroma levels n={cn}", lk, lp)
        same(f"K3 chroma recon n={cn}", rk, rp)
        k4_check(f"chroma n={cn}", cost.sse_rate(res, rk, lk),
                 cost.sse_rate_plain(res, rk, lk))
    torch.cuda.synchronize()
    for name, (ms, plain_ms) in timed.items():
        print(f"kernel {name}: {ms:.4f} ms, plain twin {plain_ms:.4f} ms "
              f"(1080p group-of-8 shape, n=8)")
    return errs, timed


def _search_ms(torch, enc, frames):
    """Median device time of the search of one frame group, through the
    kernels and through the twins."""
    from fasthevc_tpu.utils import pad_plane
    from fasthevc_tpu_torch.codec.search import search_intra_maps_batch

    sp = enc.sp
    ph = -(-HEIGHT // 32) * 32

    def upload(i, h, w):
        return torch.from_numpy(np.stack([pad_plane(np.asarray(f[i]), h, w)
                                          for f in frames])).cuda()

    y = upload(0, ph, WIDTH)
    cb, cr = upload(1, ph // 2, WIDTH // 2), upload(2, ph // 2, WIDTH // 2)

    def run(plain):
        return search_intra_maps_batch(
            y, enc.lambda_sqrt, sp.log2_ctu, sp.log2_min_cu, sp.coded_width,
            sp.coded_height, cb_batch=cb, cr_batch=cr, plain=plain)

    return (_median_ms(lambda: run(False), reps=5),
            _median_ms(lambda: run(True), reps=3))


def phase_encode(torch):
    from fasthevc_tpu.config import EncoderConfig
    from fasthevc_tpu.config.config import auto_tile_grid
    from fasthevc_tpu.utils import psnr, synthesize_yuv, yuv_from_planes
    from fasthevc_tpu_torch import _build
    from fasthevc_tpu_torch.codec.encoder import TorchEncoder

    clip = synthesize_yuv(WIDTH, HEIGHT, GROUP + TIMED, seed=1)
    warm, timed_clip = clip[:GROUP], clip[GROUP:]
    tc, tr = auto_tile_grid(WIDTH, HEIGHT)
    cfg = EncoderConfig(width=WIDTH, height=HEIGHT, qp=32, frames=TIMED,
                        tile_cols=tc, tile_rows=tr, hash_type=2)
    enc = TorchEncoder(cfg, "cuda")
    enc.encode(warm)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    stream, recons = enc.encode(timed_clip)
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    ry, _, _ = yuv_from_planes((recons[0].y, recons[0].cb, recons[0].cr),
                               WIDTH, HEIGHT)
    p = psnr(timed_clip[0][0], ry)
    tm = enc.timing
    print(f"1080p QP32 all-intra, {TIMED} frames, tiles {tc}x{tr}: "
          f"{TIMED / dt:.4f} fps, {len(stream) * 8 / TIMED / 1000:.2f} "
          f"kbit/frame, Y-PSNR {p:.3f} dB; wall {dt:.3f} s; search on the "
          f"card {tm['search_s']:.4f} s (host blocked on it "
          f"{tm['wait_s']:.4f} s); host commit {tm['commit_s']:.3f} "
          f"thread-s over the pool")
    print(f"launches in the timed encode: {launches}")
    for name in ("intra_pred", "satd", "tq_roundtrip", "sse_rate"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"encode")
    search_ms = _search_ms(torch, enc, timed_clip[:GROUP])
    print(f"search alone, one group of {GROUP} frames: kernels "
          f"{search_ms[0]:.3f} ms, twins {search_ms[1]:.3f} ms")
    # phase 4: the same frames through the twins on the card
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    plain_stream, _ = TorchEncoder(cfg, "cuda", plain=True).encode(
        timed_clip)
    print(f"twin route: {TIMED / (time.perf_counter() - t0):.4f} fps")
    if dict(_build.LAUNCHES) != before:
        raise AssertionError("the twin route launched a kernel")
    if plain_stream != stream:
        raise AssertionError("kernel-route stream differs from the twin "
                             "route's")
    print(f"kernel route == twin route: {len(stream)} bytes identical")
    return launches


def phase_decode():
    from fasthevc_tpu.config import EncoderConfig
    from fasthevc_tpu.spec.decoder import SpecDecoder
    from fasthevc_tpu.utils import synthesize_yuv
    from fasthevc_tpu_torch.codec.encoder import TorchEncoder

    clip = synthesize_yuv(416, 240, 2, seed=3)
    cfg = EncoderConfig(width=416, height=240, qp=32, frames=2)
    stream, _ = TorchEncoder(cfg, "cuda").encode(clip)
    cpu_stream, _ = TorchEncoder(cfg, "cpu").encode(clip)
    if stream != cpu_stream:
        raise AssertionError("416x240: card stream differs from the CPU "
                             "twins' stream")
    pics = SpecDecoder().decode(stream)
    if len(pics) != 2 or not all(p.hash_ok for p in pics):
        raise AssertionError("416x240 stream does not decode hash-clean")
    print(f"416x240: {len(stream)} bytes, equal to the CPU twins' stream, "
          f"{len(pics)} pictures hash_ok")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    card = _card_line()
    from fasthevc_tpu_torch import _build

    t0 = time.perf_counter()
    _build.lib()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({len(_build.sources())} sources)")
    dev = torch.device("cuda")
    errs, timed = phase_kernels(torch, dev)
    torch.cuda.empty_cache()
    launches = phase_encode(torch)
    torch.cuda.empty_cache()
    phase_decode()
    meta = {
        "intra_pred": ("csrc/intra_pred.cu", "fasthevc_tpu/ops/intra.py:171"),
        "satd": ("csrc/satd.cu", "fasthevc_tpu/ops/cost.py:26"),
        "tq_roundtrip": ("csrc/tq_roundtrip.cu",
                         "fasthevc_tpu/ops/transform.py:151"),
        "sse_rate": ("csrc/sse_rate.cu", "fasthevc_tpu/ops/cost.py:53"),
    }
    kernels = [{"name": name, "route": "cuda",
                "source": f"fasthevc_tpu_torch/{src}", "replaces": rep,
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": timed[name][0], "plain_ms": timed[name][1]}
               for name, (src, rep) in meta.items()]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
