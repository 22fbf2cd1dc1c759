#!/usr/bin/env python3
"""Drive the fasthevc_tpu_torch all-intra encoder once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  0. the card: requires torch.cuda.is_available(); prints nvidia-smi's
     name and power limit;
  1. builds the CUDA kernels from fasthevc_tpu_torch/csrc (one nvcc per
     source, all started together);
  2. runs every kernel against its plain PyTorch twin on the card, from
     seeded numpy inputs at the shapes a 1920x1080 group of 8 frames gives
     it: K1-K4 (the search) exactly, K4's rate within 1e-5 relative;
     then, on the decision maps of one search of that group, K5 (the
     wavefront commit with the RDOQ trellis; its twin on the first 2
     frames, since the twin runs wave by wave), K6 (deblock), K7 (SAO) and
     K8 (checksum) on all 8 frames, exactly; prints each median time
     beside the twin's (CUDA events);
  3. encodes synthesized 1920x1080 QP32 frames with TorchEncoder on its
     device route (bench.py's tools: default tools, auto_tile_grid tiles,
     hash type 2): one warm-up group, then 16 timed frames; prints fps,
     kbit/frame, Y-PSNR and the device / host-wait / entropy split, and
     requires every kernel K1-K8 to have been launched by that encode;
  4. encodes the same 16 frames with the twins on the card: the stream
     must be byte-identical;
  5. encodes a 416x240 2-frame clip on the device route on the card and
     with the twins on the CPU: identical streams that decode with
     matching picture hashes in SpecDecoder;
  6. the pipelined route (CTU 64: device search, host C++ commit): the
     same 416x240 check, then 8 timed 1080p frames after a warm-up, fps
     printed beside phase 3's, requiring K1-K4 to have been launched.

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT, GROUP, TIMED = 1920, 1080, 8, 16
QP = 32
RATE_RTOL = 1e-5
TWIN_FRAMES = 2          # K5's twin at 1080p: the first frames of the group
SEARCH_KERNELS = ("intra_pred", "satd", "tq_roundtrip", "sse_rate")
DEVICE_KERNELS = SEARCH_KERNELS + ("commit_intra", "deblock", "sao",
                                   "checksum")
META = {
    "intra_pred": ("csrc/intra_pred.cu", "fasthevc_tpu/ops/intra.py:171"),
    "satd": ("csrc/satd.cu", "fasthevc_tpu/ops/cost.py:26"),
    "tq_roundtrip": ("csrc/tq_roundtrip.cu",
                     "fasthevc_tpu/ops/transform.py:151"),
    "sse_rate": ("csrc/sse_rate.cu", "fasthevc_tpu/ops/cost.py:53"),
    "commit_intra": ("csrc/commit_intra.cu",
                     "fasthevc_tpu/ops/commit.py:545"),
    "deblock": ("csrc/deblock.cu", "fasthevc_tpu/ops/deblock.py:236"),
    "sao": ("csrc/sao.cu", "fasthevc_tpu/ops/sao.py:264"),
    "checksum": ("csrc/checksum.cu",
                 "fasthevc_tpu/codec/device_pipeline.py:55"),
}


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


def _timed_once(fn):
    """(result, ms) of one run of fn, timed with CUDA events."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _lambda_sqrt(qp: int) -> float:
    return float(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))


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


def _same(torch, name, a, b):
    if not torch.equal(a, b):
        bad = (a != b).sum().item()
        raise AssertionError(f"{name}: {bad} values differ from the twin")


def phase_search_kernels(torch, y, c, errs, timed):
    from fasthevc_tpu_torch.codec.search import _blocks, search_qp
    from fasthevc_tpu_torch.ops import cost, intra, transform

    qp = search_qp(_lambda_sqrt(QP))

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
        _same(torch, f"K1 n={n}", pk, intra.predict_plain(top, left, lg))
        sk = cost.satd(src, pk)
        _same(torch, f"K2 n={n}", sk, cost.satd_plain(src, pk))
        res = (src[:, None] - pk[:, :3]).reshape(-1, n, n).contiguous()
        lk, rk = transform.tq_roundtrip(res, qp, lg)
        lp, rp = transform.tq_roundtrip_plain(res, qp, lg)
        _same(torch, f"K3 levels n={n}", lk, lp)
        _same(torch, f"K3 recon n={n}", rk, rp)
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
        modes = torch.randint(0, 35, (top.shape[0],), generator=gen).to(
            c.device)
        pk = intra.predict_selected(top, left, lg, modes, is_luma=False)
        pp = intra.predict_plain(top, left, lg, modes[:, None], False)[:, 0]
        _same(torch, f"K1 chroma n={cn}", pk, pp)
        res = (_blocks(c, cn) - pk).contiguous()
        lk, rk = transform.tq_roundtrip(res, qp, lg)
        lp, rp = transform.tq_roundtrip_plain(res, qp, lg)
        _same(torch, f"K3 chroma levels n={cn}", lk, lp)
        _same(torch, f"K3 chroma recon n={cn}", rk, rp)
        k4_check(f"chroma n={cn}", cost.sse_rate(res, rk, lk),
                 cost.sse_rate_plain(res, rk, lk))
    torch.cuda.synchronize()


def phase_pixel_kernels(torch, y, c, sp, timed):
    """K5-K8 against their twins on the decisions of one 1080p search."""
    from fasthevc_tpu.spec.ctu import tu_qps
    from fasthevc_tpu_torch.codec import device_pipeline as dp
    from fasthevc_tpu_torch.codec.search import search_intra_maps_batch
    from fasthevc_tpu_torch.ops import commit, deblock, sao

    cb, cr = c, 255 - c
    ls = _lambda_sqrt(QP)
    pk = search_intra_maps_batch(y, ls, 5, 3, WIDTH, HEIGHT, cb_batch=cb,
                                 cr_batch=cr)
    gh, gw = HEIGHT // 8, WIDTH // 8
    dm = pk[:, :gh, :gw, 0].to(torch.int32)
    mm = pk[:, :gh, :gw, 1].to(torch.int32)
    sy = y[:, :HEIGHT].contiguous()
    scb = cb[:, :HEIGHT // 2].contiguous()
    scr = cr[:, :HEIGHT // 2].contiguous()
    qy, qcb, qcr = tu_qps(sp, QP)
    lam = float(torch.tensor(ls, dtype=torch.float32) ** 2)
    tbx = tuple(int(b) * 32 for b in sp.tile_col_bounds()[1:-1])
    tby = tuple(int(b) * 32 for b in sp.tile_row_bounds()[1:-1])

    def run_commit(frames, plain):
        return commit.wavefront_commit_intra(
            sy[:frames], scb[:frames], scr[:frames], dm[:frames],
            mm[:frames], qy, qcb, qcr, WIDTH, HEIGHT, True, tbx, tby,
            rdoq=True, lam=lam, plain=plain)

    rec = run_commit(GROUP, False)
    twin, twin_ms = _timed_once(lambda: run_commit(TWIN_FRAMES, True))
    for name, a, b in zip(("rec_y", "rec_cb", "rec_cr", "lv_y", "lv_cb",
                           "lv_cr"), rec, twin):
        _same(torch, f"K5 {name}", a[:TWIN_FRAMES], b)
    k5_group_ms = _median_ms(lambda: run_commit(GROUP, False), reps=3)
    timed["commit_intra"] = (
        _median_ms(lambda: run_commit(TWIN_FRAMES, False), reps=3), twin_ms)
    print(f"kernel commit_intra: {k5_group_ms:.4f} ms for the group of "
          f"{GROUP} frames (1080p, RDOQ on)")

    ry, rcb, rcr = rec[:3]
    dargs = (ry, rcb, rcr, dm, QP, qcb, qcr, 5)
    dk = deblock.deblock(*dargs)
    for name, a, b in zip(("y", "cb", "cr"), dk,
                          deblock.deblock(*dargs, plain=True)):
        _same(torch, f"K6 {name}", a, b)
    timed["deblock"] = (_median_ms(lambda: deblock.deblock(*dargs)),
                        _median_ms(lambda: deblock.deblock(*dargs,
                                                           plain=True)))
    sargs = (sy, scb, scr) + tuple(dk) + (5,)
    sk = sao.sao(*sargs)
    for name, a, b in zip(("y", "cb", "cr", "params"), sk,
                          sao.sao(*sargs, plain=True)):
        _same(torch, f"K7 {name}", a, b)
    timed["sao"] = (_median_ms(lambda: sao.sao(*sargs)),
                    _median_ms(lambda: sao.sao(*sargs, plain=True)))
    y8 = sk[0].to(torch.uint8)
    _same(torch, "K8", dp.device_checksum(y8),
          dp.device_checksum(y8, plain=True))
    timed["checksum"] = (
        _median_ms(lambda: dp.device_checksum(y8)),
        _median_ms(lambda: dp.device_checksum(y8, plain=True)))
    torch.cuda.synchronize()


def _encode(torch, cfg, clip, device="cuda", plain=False):
    from fasthevc_tpu_torch.codec.encoder import TorchEncoder
    enc = TorchEncoder(cfg, device, plain=plain)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream, recons = enc.encode(clip)
    return stream, recons, time.perf_counter() - t0, enc


def phase_device_route(torch):
    """Phases 3 and 4; returns (launches, fps)."""
    from fasthevc_tpu.config import EncoderConfig
    from fasthevc_tpu.config.config import auto_tile_grid
    from fasthevc_tpu.utils import psnr, synthesize_yuv, yuv_from_planes
    from fasthevc_tpu_torch import _build
    from fasthevc_tpu_torch.codec.encoder import TorchEncoder

    clip = synthesize_yuv(WIDTH, HEIGHT, GROUP + TIMED, seed=1)
    warm, timed_clip = clip[:GROUP], clip[GROUP:]
    tc, tr = auto_tile_grid(WIDTH, HEIGHT)
    cfg = EncoderConfig(width=WIDTH, height=HEIGHT, qp=QP, frames=TIMED,
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
    fps = TIMED / dt
    print(f"device route, 1080p QP32 all-intra, {TIMED} frames, tiles "
          f"{tc}x{tr}: {fps:.4f} fps, {len(stream) * 8 / TIMED / 1000:.2f} "
          f"kbit/frame, Y-PSNR {p:.3f} dB; wall {dt:.3f} s; group programs "
          f"on the card {tm['device_s']:.4f} s (host blocked on them "
          f"{tm['wait_s']:.4f} s); host CABAC {tm['entropy_s']:.3f} "
          f"thread-s over the pool")
    print(f"launches in the timed device-route encode: {launches}")
    for name in DEVICE_KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"device-route encode")
    # phase 4: the same frames through the twins on the card
    before = dict(_build.LAUNCHES)
    plain_stream, _, pdt, _ = _encode(torch, cfg, timed_clip, plain=True)
    print(f"twin device route: {TIMED / pdt:.4f} fps")
    if dict(_build.LAUNCHES) != before:
        raise AssertionError("the twin route launched a kernel")
    if plain_stream != stream:
        raise AssertionError("kernel-route stream differs from the twin "
                             "route's")
    print(f"kernel route == twin route: {len(stream)} bytes identical")
    return launches, fps


def _check_small(torch, log2_ctu: int, route: str):
    from fasthevc_tpu.config import EncoderConfig
    from fasthevc_tpu.spec.decoder import SpecDecoder
    from fasthevc_tpu.utils import synthesize_yuv

    clip = synthesize_yuv(416, 240, 2, seed=3)
    cfg = EncoderConfig(width=416, height=240, qp=QP, frames=2,
                        log2_ctu=log2_ctu)
    stream, _, _, enc = _encode(torch, cfg, clip)
    if route == "device" and "device_s" not in enc.timing:
        raise AssertionError("416x240 CTU 32 did not take the device route")
    cpu_stream, _, _, _ = _encode(torch, cfg, clip, device="cpu")
    if stream != cpu_stream:
        raise AssertionError(f"416x240 {route} route: card stream differs "
                             f"from the CPU twins' stream")
    pics = SpecDecoder().decode(stream)
    if len(pics) != 2 or not all(p.hash_ok for p in pics):
        raise AssertionError(f"416x240 {route} route stream does not decode "
                             f"hash-clean")
    print(f"416x240 {route} route (CTU {1 << log2_ctu}): {len(stream)} "
          f"bytes, equal to the CPU twins' stream, {len(pics)} pictures "
          f"hash_ok")


def phase_pipelined_route(torch, device_fps: float):
    from fasthevc_tpu.config import EncoderConfig
    from fasthevc_tpu.config.config import auto_tile_grid
    from fasthevc_tpu.utils import synthesize_yuv
    from fasthevc_tpu_torch import _build

    _check_small(torch, 6, "pipelined")
    clip = synthesize_yuv(WIDTH, HEIGHT, 2 * GROUP, seed=1)
    tc, tr = auto_tile_grid(WIDTH, HEIGHT)
    cfg = EncoderConfig(width=WIDTH, height=HEIGHT, qp=QP, frames=GROUP,
                        tile_cols=tc, tile_rows=tr, hash_type=2, log2_ctu=6)
    _encode(torch, cfg, clip[:GROUP])
    _build.LAUNCHES.clear()
    stream, _, dt, enc = _encode(torch, cfg, clip[GROUP:])
    launches = dict(_build.LAUNCHES)
    tm = enc.timing
    print(f"pipelined route, 1080p QP32 CTU 64, {GROUP} frames: "
          f"{GROUP / dt:.4f} fps ({len(stream) * 8 / GROUP / 1000:.2f} "
          f"kbit/frame; search on the card {tm['search_s']:.4f} s, host "
          f"commit {tm['commit_s']:.3f} thread-s); device route at CTU 32: "
          f"{device_fps:.4f} fps")
    print(f"launches in the timed pipelined encode: {launches}")
    for name in SEARCH_KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"pipelined encode")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    # the device route is the default; this variable would force the
    # pipelined one
    os.environ.pop("FASTHEVC_FORCE_CLASSIC", None)
    card = _card_line()
    from fasthevc_tpu.config import EncoderConfig
    from fasthevc_tpu.config.config import auto_tile_grid
    from fasthevc_tpu.spec.encoder import config_to_sp
    from fasthevc_tpu_torch import _build

    t_start = time.perf_counter()
    _build.lib()
    print(f"kernel build: {time.perf_counter() - t_start:.2f} s "
          f"({len(_build.sources())} sources)")
    dev = torch.device("cuda")
    errs = {name: 0.0 for name in DEVICE_KERNELS}
    timed: dict = {}
    y, c = _kernel_inputs(torch, dev)
    phase_search_kernels(torch, y, c, errs, timed)
    tc, tr = auto_tile_grid(WIDTH, HEIGHT)
    sp = config_to_sp(EncoderConfig(width=WIDTH, height=HEIGHT, qp=QP,
                                    tile_cols=tc, tile_rows=tr))
    phase_pixel_kernels(torch, y, c, sp, timed)
    del y, c
    for name, (ms, plain_ms) in timed.items():
        print(f"kernel {name}: {ms:.4f} ms, plain twin {plain_ms:.4f} ms")
    print("(1080p group-of-8 shapes; K1-K4 at n=8; commit_intra on "
          f"{TWIN_FRAMES} frames, RDOQ on)")
    torch.cuda.empty_cache()
    launches, fps = phase_device_route(torch)
    torch.cuda.empty_cache()
    _check_small(torch, 5, "device")
    phase_pipelined_route(torch, fps)
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s")
    kernels = [{"name": name, "route": "cuda",
                "source": f"fasthevc_tpu_torch/{src}", "replaces": rep,
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": timed[name][0], "plain_ms": timed[name][1]}
               for name, (src, rep) in META.items()]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
