#!/usr/bin/env python3
"""Drive the fasthevc_tpu_torch encoder once on one CUDA card.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile [--root DIR]
                                       # only the profiled 1080p LDP and RA
                                       # encodes (device time by kernel
                                       # family: K3/K4, K9, K11, K12, K7's
                                       # forms, K11's planes, K6, K8)
    python3 chip_smoke.py --profile-mesh   # only phase 16's cases, profiled
    python3 chip_smoke.py --bench-kernels [--root DIR]
                                       # K9's integer stage and the merge
                                       # candidates, K12 and its glue, K10,
                                       # K1 + K2 and K1's fused form, the RD
                                       # shortlist and its glue, K7 and
                                       # K11's commit planes, then
                                       # phases 3, 7, 10,
                                       # 14 and 16's encodes, no twins (DIR:
                                       # another checkout's package; --root
                                       # is refused in every other mode)

Phases (any failure raises, and the script exits non-zero):
  0. the card: requires torch.cuda.is_available(); prints nvidia-smi's
     name and power limit;
  1. builds the CUDA kernels from fasthevc_tpu_torch/csrc (one nvcc per
     source, all started together);
  2. runs every kernel against its plain PyTorch twin on the card, from
     seeded inputs at the shapes the 1920x1080 main paths give it, and
     prints each median time (CUDA events) beside the twin's, its bound
     and what sets the bound:
     a. K1-K4 (the search) on a group of 8 frames, exactly (K4's rate
        within 1e-5 relative), and K1's fused form (the intra search's
        35-mode SATDs) against its twin and against K1 + K2 at n = 8, 16
        and 32, each timed beside K1 + K2; K1's rd form (intra_rd_cands,
        the RD shortlist: the 3 least RMD costs of each block's SATDs and
        MPM bits, their modes, bits and residuals) against its twin and
        against the parent's path (the stable sort, K1's selected form and
        the subtract), at n = 8, 16 and 32, and its form given the modes
        on the chroma DM blocks (n = 4, 8, 16) against the selected form
        and the subtract, each timed with events and alone (torch.profiler)
        beside the parent's path and the bound; the superseded selected
        form at n = 8 against its twin and the gather of the 35 (K2 is
        timed here at [B, 35] only beside K1 + K2: no route launches that
        form); K3's costed form (tq_cost, the search's T/Q/IQ/IT with K4's
        SSE and rate inside) on the residuals of those 3 rd candidates
        (luma n = 8, 16, 32) and of the chroma DM blocks (n = 4, 8, 16,
        at both dead-zone offsets): bit for bit equal to K3 -> K4, against
        its twin as K4 is held, each timed beside K3 + K4 with its
        bound as the butterflies count it (the matrix form's count
        beside); then, on
        the decision maps of one search of that group, K5 (the wavefront
        commit with the RDOQ trellis; its twin on the first 2 frames; its
        time on 1, 2 and 8 frames and per dependent CTU step, and its
        latency bound: the steps times the least CTU step), K6 (deblock;
        it, its BS and cbf passes in b and K8 also timed alone), K7's
        fused form (sao_fused: estimate and apply in one launch) on
        the group and on its first picture, against its twin and against
        the earlier two-launch form (sao_stats + sao_apply), each timed
        with events and alone beside its bound, and K8 (checksum),
        exactly;
     b. the P kernels on one P frame of phase 7's clip with two
        references at SR 64: K9 (decimation; the fused form, me_coarse
        and me_fine, each against its twin, which searches one tier at a
        time, and against the earlier form's five sad_search calls, the
        parent's path, timed beside it; the earlier form's coarse tier 16
        and 8-block refinement against their twins), K10 (sub-pel, at n =
        8, 16 and 32, each timed with its bound), K11's merge form
        (mc_merge at n = 8, 16, 32, against its twin and against the
        earlier path of mc_sel, K2 on the candidates' predictions and the
        fold's torch ops, timed beside it; mc_sel and K2 on their own) and
        K11's planes form (the commit's MC planes of the three components
        in one launch) against its twin and the earlier form a component,
        timed with events and alone beside its bound, K5's mixed form
        (RDOQ on; its time per
        dependent step beside the frame's share of intra granules and
        CTUs, and its latency bound: the steps times the least CTU step,
        the slope of one-row P pictures) and K6 with boundary strengths,
        exactly; K9's and K11's bounds by the fused count, with the
        earlier count beside;
     c. the B kernels on POC 4 of phase 10's clip with two references per
        list (0, 8 and 8, 16) at SR 64: K9's fused form over the four
        state references and K11's merge form over both lists (n = 8, 16,
        32), as in b; K12's selected form (bi_select: the BI candidate and
        the direction, with the chosen prediction and rate) on the 8-, 16-
        and 32-blocks' merge winners, against its twin and against the
        parent's path (bi_cost, then stack, argmin and where), each timed
        with events and alone beside the bound; the superseded bi_cost at
        n = 8; and K11's planes form with both lists on that frame's B
        decisions, against its twin and the earlier form a component, as
        in b, exactly (the f32 costs and rates bit for bit);
     e. the forms the CTU-64 classic route adds, on that B frame padded
        to the CTU-64 grid: K9's fused form with its tier 64 (and the
        earlier form's tier-64 searches), K10, K2, K11's merge form and
        K12's selected form on the 64-blocks, exactly, each with its time,
        twin time and bound (run before d, which needs the card's memory);
     d. the partition CNN with seeded random weights: K13 on a 1080p group
        of 8 at CTU 32 (and one 1080p frame at CTU 64), its training-mode
        logits within CNN_TOL of the conv2d chain's and its depth maps
        equal wherever the chain's top-two margin exceeds 2 CNN_TOL (the
        flips inside the margin counted), each of its tiles T (CTUs a
        CTA) timed; K13's training mode and K14 on one training batch of 64 CTUs against
        autograd through the chain (gradients within 1e-4 of each
        tensor's largest; two K14 calls bit for bit equal; K14 and
        autograd timed in turns, 41 pairs after a warm-up, medians and
        interquartile ranges printed, with K14's grid, stages and share
        of its bound); K15 on the
        flat parameters, bit for bit; each
        with its time, twin time, bound and the library call's time (the
        conv2d chain, its backward, torch.optim.Adam);
     f. the multi-device layer's kernels at the shapes of an interior rank
        of the 1080p (2, 4) mesh (a 480-column tile): K16 (the halo
        exchange: the search's source halo, and its packed form), K6's
        tile-column form with P strengths and its CU cbf pass, K7's fused
        halo form with both neighbours' columns (against its twin and the
        earlier two-launch halo form, as in a), exactly, each with its
        time, twin time and bound;
  3. encodes synthesized 1920x1080 QP32 frames with TorchEncoder on its
     all-intra device route (bench.py's tools: default tools,
     auto_tile_grid tiles, hash type 2): one warm-up group, then 16 timed
     frames; prints fps, kbit/frame, Y-PSNR and the device / host-wait /
     entropy split, and requires every kernel of the route to have been
     launched by that encode, K7's fused form once a group;
  4. encodes the first 8 of those frames with the kernels and with the
     twins on the card: the streams must be byte-identical;
  5. encodes a 416x240 2-frame clip on the device route on the card and
     with the twins on the CPU: identical streams that decode with
     matching picture hashes in SpecDecoder;
  6. the pipelined route (CTU 64: device search, host C++ commit): the
     same 416x240 check, then 8 timed 1080p frames after a warm-up, fps
     printed beside phase 3's, requiring the intra search's kernels (K1's
     fused and rd forms, K3's costed form) to have been launched;
  7. the low-delay P device route: low_delay_p(1920, 1080, qp=32,
     hash_type=2) on synthesized frames, a warm-up, then one I frame and 8
     P frames timed;
     prints fps, kbit/frame, Y-PSNR and the split, and requires every
     kernel of the route (K1, K3, K5-K11 with K5's mixed form and K6's
     strengths) to have been launched by that encode, K9 at three
     launches a P picture, K11's merge form at one a block size, K7's
     fused form at one a picture batch (9) and K11's planes form at one a
     P batch (8), and none of the superseded forms (UNLAUNCHED);
  8. the first 2 frames of that clip through the kernels and through the
     twins on the card: byte-identical streams;
  9. a 416x240 4-frame low-delay P clip on the card and with the twins on
     the CPU: identical streams that decode hash-clean in SpecDecoder;
 10. the random-access device route: random_access_gop16(1920, 1080,
     qp=32, hash_type=2) on synthesized frames, a warm-up, then 17 frames
     timed (the IDR and one GOP-16, in 7 dependency batches of 1, 1, 1,
     2, 4, 4 and 4 frames: at 1280x720 and up a batch holds at most 4 B
     pictures, as in the reference's batcher); prints fps,
     kbit/frame, Y-PSNR (I and B), each batch's span on the card and the
     host-wait / entropy split, and requires every kernel of the route
     (K12 and K11's bi-predicting planes included) to have been launched
     by that encode, K9 at three launches a B picture, K11's merge form
     at one a block size for both lists, K7's fused form at one a batch
     (7) and K11's planes form at one a B batch (6);
 11. a 416x240 17-frame random-access clip through the kernels and through
     the twins on the card, and through the twins on the CPU: identical
     streams that decode hash-clean in SpecDecoder;
 12. trains the partition CNN on the card with
     train_self_distilled(qps=(27, 37), steps=400), the recipe of the
     reference's BASELINE config 4, printing its loss, accuracy and wall
     time (the 400 steps apart from the distillation targets' search),
     and requires the intra search's kernels, K13's training mode, K14
     and K15 to have been launched;
 13. the fast-partition path with those parameters: phases 3, 7 and 10
     again (the same frames) with fast_partition, fps, kbit/frame and
     Y-PSNR printed beside the full search's, each requiring K13 and its
     route's kernels; one 1080p all-intra fast-partition stream of 8
     frames with K13 and with the conv2d chain in its place, compared
     byte for byte, with K13's depth flips on those frames; then config 4
     itself (416x240, 4 frames, QP 22, 27, 32 and 37, full vs fast,
     every stream hash-clean) and its BD-rate by
     the port's utils.bd_rate, printed against the 2% gate as a
     measurement; and 416x240 fast-partition streams (all-intra and random
     access with the trained CNN, the CTU-64 pipelined route with a seeded
     CTU-64 CNN) through the kernels on the card and through the twins on
     the CPU: identical, hash-clean;
 14. the classic per-frame route: phase 7's low_delay_p at CTU 64 (which
     TpuEncoder, too, sends to its per-frame loop), a warm-up, then 1 I
     and 4 P frames timed; prints fps, kbit/frame, Y-PSNR and the
     search (CUDA events) / host C++ commit split, and requires K1, K3's
     costed form, K9, K10 and K11's merge form to have been launched, at
     three and four launches a P picture;
 15. rate control at 1080p: the all-intra device route on phase 3's 16
     frames and the low-delay P device route on phase 7's 9 frames, each
     with target_bitrate at 0.8 of the rate its fixed-QP phase realized;
     prints the realized rate beside the target and the fps beside phases
     3 and 7, and requires each route's kernels;
 16. the in-process ("gop", "tile") mesh of 2 x 4 ranks on the one card,
     one thread and one CUDA stream per rank: 1920x1080 all-intra with 4
     tile columns (8 frames, SAO on), low_delay_p with one reference and 4
     tile columns (2 segments of 4, SR 64: an ME halo of 128 columns on
     480-column tiles), and IDR + P + B with the two-entry GOP (2
     segments of 3); each sharded stream must equal TorchEncoder's
     single-device route byte for byte, both fps printed, and K16, K6's
     tile-column form and cbf pass, K7's fused halo form (once a rank and
     step), K9's fused form, K10, K11's merge form and its planes form
     (once a rank and inter step) must have been launched, and none of
     the superseded forms; the streams are decoded in the mesh-decode
     jobs;
 17. BASELINE config 5 through parallel.multiproc.gop_parallel_encode_check:
     3840x2160, 16 frames, 2 processes on the card, tiles 2x2, intra
     period 8: the concatenated stream must equal one process's byte for
     byte, both fps printed; its decode runs in the config5-decode jobs;
 and the classic_small jobs: 416x240 streams of this slice's paths
     (random access at CTU 64, which needs K12; low-delay P at CTU 64 with
     a seeded CTU-64 CNN under fast_partition; weighted prediction on a
     fade; lossless; quality()'s two-pass search under
     FASTHEVC_FORCE_CLASSIC; HRD on the random-access device route; rate
     control on the all-intra device route) through the kernels on the
     card, through the twins on the card and through the twins on the
     CPU: identical, hash-clean; the sharded-small job: the dry run's two
     configurations on 8 in-process ranks through the kernels on the card,
     the twins on the card and the twins on the CPU, identical and each
     equal to the single-device route, hash-clean; and the mesh-decode and
     config5-decode jobs: in SpecDecoder, the whole IDR+P+B stream of
     phase 16 (all 6 pictures, one decoder pass), the IDR and first P of
     each segment of the all-intra and low-delay P streams (pictures 0-1;
     0-1 and 4-5), and config 5's pictures 8-9 (the second process's IDR
     and first P) decode hash-clean.

Order: phase 2 without K5's twins, then the timed encodes (3, 6, 7, 10),
the training (12), the timed fast-partition encodes (13) and phases 14
and 15, then 16 and 17, alone on the card; then every check that runs
twins (K5's twins of phase 2, phases 4, 5, 6's 416x240 check, 8, 9, 11,
13's 416x240 checks, classic_small and sharded-small), config 4 and the
decodes of phases 16 and 17 as JOBS, each a process of its own
(`chip_smoke.py --job NAME`), all at once: the twins are bound by the
host's Python and launches, so they overlap.

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
SR = 64                  # low_delay_p's search range (config.py default)
LDP_TIMED_P = 8          # P frames of the timed low-delay encode
LDP_TWIN_FRAMES = 2      # its twin-route check (K5's twin: 1-2 min a frame)
RATE_RTOL = 1e-5
LEVEL_NAMES = ("rec_y", "rec_cb", "rec_cr", "lv_y", "lv_cb", "lv_cr")
JOBS_DEADLINE_S = 1140   # the twin jobs end by then, inside the 1200 s
TWIN_FRAMES = 2          # K5's twin at 1080p: the first frames of the group
# The card's peaks (NVIDIA's data sheet, H100 SXM at 700 W):
# 3.35 TB/s of device memory; 67 TFLOP/s f32 outside the tensor cores is
# 132 SMs x 128 lanes x 2 (multiply-add) x 1.98 GHz, and an SM has half as
# many int32 lanes, so int32 work peaks at 33.5 T operations/s (a
# multiply-add counted as two).  The kernels here are int32 work.
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 33.5e12
PEAK_F32_FLOPS_S = 67e12     # the partition CNN's f32 work, no tensor core
# the intra search: K1's fused form (all 35 modes' SATDs), K1's rd form (the
# RD shortlist and its residuals, the chroma DM residual), K3's costed form
# (T/Q/IQ/IT with K4's SSE and rate inside)
SEARCH_KERNELS = ("intra_rd_cands", "intra_satd", "tq_cost")
# the superseded forms, which no route launches: K3's plain form and K4
# (tq_cost replaced the pair), K9's one-search-a-launch form (me_coarse and
# me_fine replaced it), K11's merge-candidate MC and K2 (mc_merge replaced
# them with the fold), K1's selected form (intra_rd_cands replaced it with
# the sort and the subtract), K12's bi_cost (bi_select replaced it with
# the direction choice), K7's two-launch form and its halo form (sao_fused
# and sao_fused_halo replaced them) and K11's plane form a component
# (inter_pred_fused and inter_pred_fused_bi replaced it); every route's
# launches must show none of them
UNLAUNCHED = ("tq_roundtrip", "sse_rate", "me_full_search", "me_refine",
              "mc_sel", "satd", "intra_pred_selected", "bi_cost", "sao",
              "sao_halo", "inter_pred", "inter_pred_bi")
# K1's rd form a search batch of the all-intra route: the three luma sizes
# and both chroma planes at each
RD_PER_GROUP = 9
INTRA_ROUTE = SEARCH_KERNELS + ("commit_intra", "deblock", "sao_fused",
                                "checksum")
# the P search's K9 (three launches a picture), K10 and K11's merge form
# (one launch a block size), then the commit's
ME_KERNELS = ("me_downsample4", "me_coarse", "me_fine", "subpel",
              "mc_merge")
P_KERNELS = ME_KERNELS + ("inter_pred_fused", "commit_mixed", "deblock_bs",
                          "deblock_cbf")
LDP_ROUTE = INTRA_ROUTE + P_KERNELS
RA_FRAMES = 17           # random access: the IDR and one GOP-16
RA_BATCHES = 7           # its dependency batches: 1, 1, 1, 2, 4, 4, 4
B_KERNELS = ("bi_select", "inter_pred_fused_bi")
RA_ROUTE = (INTRA_ROUTE + tuple(k for k in P_KERNELS
                                if k != "inter_pred_fused") + B_KERNELS)
# the classic per-frame route's P search: K1 (fused and selected forms),
# K3's costed form, K9, K10 and K11's merge form (the C++ engine commits
# and compensates on the host)
CLASSIC_ROUTE = SEARCH_KERNELS + ME_KERNELS
CLASSIC_TIMED_P = 4      # P frames of the timed classic-route encode
RC_SHARE = 0.8           # phase 15's targets: this share of phases 3 and 7's
TRAIN_KERNELS = ("cnn_train", "cnn_backward", "adam")
CNN_KERNELS = ("cnn_depth",) + TRAIN_KERNELS
# K13's f32 logits against the conv2d chain's (cuDNN, TF32 off): sums of up
# to 585 products in two orders; a depth decision whose top-two logits lie
# within 2 CNN_TOL may go either way
CNN_TOL = 1e-4
CNN_BATCH = 64           # train_self_distilled's batch of CTUs
K14_PAIRS = 41           # phase 2d: K14 and autograd through the chain
BENCH_ENCODES = 5        # --bench-kernels: timed encodes of each route
CNN_QPS = (22, 27, 32, 37)   # config 4's rate points (cli/evaluate.py QPS)
META = {
    "intra_rd_cands": ("csrc/intra_pred.cu",
                       "fasthevc_tpu/codec/search.py:170"),
    "intra_pred_selected": ("csrc/intra_pred.cu",
                            "fasthevc_tpu/ops/intra.py:239"),
    "intra_satd": ("csrc/intra_pred.cu", "fasthevc_tpu/codec/search.py:163"),
    "satd": ("csrc/satd.cu", "fasthevc_tpu/ops/cost.py:26"),
    "tq_cost": ("csrc/tq_roundtrip.cu", "fasthevc_tpu/ops/transform.py:151"),
    "commit_intra": ("csrc/commit.cu", "fasthevc_tpu/ops/commit.py:545"),
    "deblock": ("csrc/deblock.cu", "fasthevc_tpu/ops/deblock.py:236"),
    "sao_fused": ("csrc/sao.cu", "fasthevc_tpu/ops/sao.py:264"),
    "sao": ("csrc/sao.cu", "fasthevc_tpu/ops/sao.py:264"),
    "checksum": ("csrc/checksum.cu",
                 "fasthevc_tpu/codec/device_pipeline.py:55"),
    "me_downsample4": ("csrc/me_int.cu", "fasthevc_tpu/ops/me.py:129"),
    "me_coarse": ("csrc/me_int.cu", "fasthevc_tpu/ops/me.py:233"),
    "me_fine": ("csrc/me_int.cu", "fasthevc_tpu/ops/me.py:265"),
    "me_full_search": ("csrc/me_int.cu", "fasthevc_tpu/ops/me.py:42"),
    "me_refine": ("csrc/me_int.cu", "fasthevc_tpu/ops/me.py:220"),
    "subpel": ("csrc/subpel.cu", "fasthevc_tpu/ops/me.py:343"),
    "mc_merge": ("csrc/mc.cu", "fasthevc_tpu/codec/search.py:438"),
    "mc_sel": ("csrc/mc.cu", "fasthevc_tpu/ops/me.py:671"),
    "inter_pred_fused": ("csrc/mc.cu", "fasthevc_tpu/ops/me.py:508"),
    "inter_pred": ("csrc/mc.cu", "fasthevc_tpu/ops/me.py:508"),
    "commit_mixed": ("csrc/commit.cu", "fasthevc_tpu/ops/commit.py:570"),
    "deblock_bs": ("csrc/deblock.cu", "fasthevc_tpu/ops/deblock.py:177"),
    "deblock_cbf": ("csrc/deblock.cu", "fasthevc_tpu/ops/deblock.py:154"),
    "bi_select": ("csrc/bi.cu", "fasthevc_tpu/codec/search.py:476"),
    "bi_cost": ("csrc/bi.cu", "fasthevc_tpu/codec/search.py:476"),
    "inter_pred_fused_bi": ("csrc/mc.cu", "fasthevc_tpu/ops/me.py:508"),
    "inter_pred_bi": ("csrc/mc.cu", "fasthevc_tpu/ops/me.py:508"),
    "cnn_depth": ("csrc/cnn.cu", "fasthevc_tpu/models/partition_cnn.py:82"),
    "cnn_train": ("csrc/cnn.cu", "fasthevc_tpu/models/partition_cnn.py:30"),
    "cnn_backward": ("csrc/cnn.cu",
                     "fasthevc_tpu/models/partition_cnn.py:158"),
    "adam": ("csrc/cnn.cu", "fasthevc_tpu/models/partition_cnn.py:153"),
    "halo": ("csrc/halo.cu", "fasthevc_tpu/parallel/sharded.py:46"),
    "deblock_window": ("csrc/deblock.cu",
                       "fasthevc_tpu/parallel/sharded.py:67"),
    "sao_fused_halo": ("csrc/sao.cu",
                       "fasthevc_tpu/parallel/sharded.py:186"),
    "sao_halo": ("csrc/sao.cu", "fasthevc_tpu/parallel/sharded.py:186"),
}
# the multi-device layer's kernels: K16, K6's tile-column form, K7's fused
# halo form (phases 2f and 16; the P/B mesh cases run K6's cbf pass too)
MESH_KERNELS = ("halo", "deblock_window", "sao_fused_halo")
MESH = (2, 4)            # phase 16's in-process ("gop", "tile") mesh


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _with_k13_tile(cnn, t: int, fn):
    """fn() with K13 launched at tile t in place of `cnn_tile`'s choice."""
    chosen = cnn.cnn_tile
    cnn.cnn_tile = lambda *_: t
    try:
        return fn()
    finally:
        cnn.cnn_tile = chosen


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


def _device_ms(fn, keys=None, reps: int = 5, tries: int = 3):
    """The card's own time of one call of fn, without the host work around
    its launches: torch.profiler's device time of the kernels whose names
    hold one of `keys` (every kernel when None), summed over `reps` calls
    after a warm-up, divided by reps.  A profiling window now and then
    records no device event: it is run again, up to `tries` times, and
    None (not measured) is returned if none records one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if str(e.device_type).endswith("CUDA")
                 and (keys is None or any(k in e.name for k in keys)))
        if us > 0:
            return us / reps / 1e3
    return None


def _ms_text(ms) -> str:
    """A time for the log: "x.xxxx ms", or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _share_text(bound_ms: float, ms) -> str:
    """The bound's share of a time, or "not measured"."""
    return ("not measured" if ms is None
            else f"{100 * bound_ms / ms:.1f}%")


def _interleaved_ms(fa, fb, pairs: int = K14_PAIRS, warm: int = 5) -> tuple:
    """fa and fb timed in turns (a, b, a, b, ...) after `warm` turns of
    each, every call in its own CUDA-event window: ([ms of fa], [ms of
    fb]), one value a turn."""
    for _ in range(warm):
        fa()
        fb()
    out: tuple = ([], [])
    for _ in range(pairs):
        for fn, acc in zip((fa, fb), out):
            acc.append(_timed_once(fn)[1])
    return out


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


def _bound(nbytes: float, ops: float, peak: float = PEAK_INT32_OPS_S
           ) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their peak (int32 by default)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def _transform_ops(dm) -> float:
    """Multiply-adds (as two ops) of the exact forward and inverse
    transforms of every CU of depth maps dm [F, H/8, W/8] (CTU 32, TU ==
    CU): 4 one-dimensional passes of n^3 multiply-adds for an n x n luma
    block and its two n/2 chroma blocks."""
    total = 0.0
    for d in range(3):
        n = 32 >> d
        cus = float((dm == d).sum().item()) / (n // 8) ** 2
        total += cus * 4 * 2 * (n ** 3 + 2 * (n // 2) ** 3)
    return total


def _bfly_ops(n: int) -> int:
    """Operations (a multiply-add as two) of one n-point core transform by
    HM's even-odd partial butterflies, forward or inverse: n additions
    splitting (or joining) the even and odd halves, (n/2)^2 multiply-adds
    of the odd half, and the n/2-point transform of the even half; the
    2-point one is 64 (a +- b), four operations."""
    return 4 if n == 2 else n + 2 * (n // 2) ** 2 + _bfly_ops(n // 2)


def _tq_work(blocks: int, n: int, costed: bool, matrix: bool = False
             ) -> tuple:
    """(bytes, int32 operations) of K3 on `blocks` n x n residuals: the
    residual read; the levels and recon written (tq_roundtrip) or (dist,
    rate) (tq_cost).  Operations: four 1-D passes of n transforms by the
    butterflies (with `matrix`, the n^3 matrix form's count), 10 a sample
    for the shifts, clips and quantisers, and for tq_cost 12 a sample for
    K4's SSE and level features."""
    per_1d = 2 * n * n if matrix else _bfly_ops(n)
    ops = 4 * n * per_1d + (22 if costed else 10) * n * n
    nbytes = 4 * n * n + (8 if costed else 8 * n * n)
    return blocks * nbytes, blocks * ops


def _interp_ops(n: int, taps: int) -> float:
    """Multiply-adds (as two ops) of the separable interpolation of one
    n x n block with a taps-tap filter: (n + taps - 1) rows of n horizontal
    filters, then n x n vertical ones, taps multiply-adds each."""
    return 2 * taps * ((n + taps - 1) * n + n * n)


def phase_search_kernels(torch, y, c, errs, timed, work):
    from fasthevc_tpu_torch.codec.search import _blocks, search_qp
    from fasthevc_tpu_torch.ops import cost, intra, transform

    qp = search_qp(_lambda_sqrt(QP))
    faster = []

    def k4_check(name, got, want, key):
        (dk, rk), (dp, rp) = got, want
        exact = dp < 2.0 ** 24
        if not torch.equal(dk[exact], dp[exact]):
            raise AssertionError(f"{name}: dist differs from the twin")
        rel = ((rk - rp).abs() / rp.abs().clamp_min(1e-30)).max().item()
        if rel > RATE_RTOL:
            raise AssertionError(f"{name}: rate rel err {rel:.3g}")
        if key in errs:
            errs[key] = max(errs[key], (rk - rp).abs().max().item())

    def tq_check(name, res, lg, intra):
        """K3 and K4 against their twins, tq_cost bit for bit against K3
        -> K4 and against its twin; each timed.  Returns the ms of
        tq_cost, K3 and K4, and K3's (levels, recon)."""
        lk, rk = transform.tq_roundtrip(res, qp, lg, is_intra=intra)
        lp, rp = transform.tq_roundtrip_plain(res, qp, lg, is_intra=intra)
        _same(torch, f"K3 levels {name}", lk, lp)
        _same(torch, f"K3 recon {name}", rk, rp)
        k4 = cost.sse_rate(res, rk, lk)
        k4_check(f"K4 {name}", k4, cost.sse_rate_plain(res, rk, lk), "")
        got = transform.tq_cost(res, qp, lg, is_intra=intra)
        _same(torch, f"tq_cost dist against K3 -> K4 {name}", got[0], k4[0])
        _same(torch, f"tq_cost rate against K3 -> K4 {name}", got[1], k4[1])
        k4_check(f"tq_cost {name}", got,
                 transform.tq_cost_plain(res, qp, lg, is_intra=intra),
                 "tq_cost")
        ms = _median_ms(lambda: transform.tq_cost(res, qp, lg,
                                                  is_intra=intra))
        k3 = _median_ms(lambda: transform.tq_roundtrip(res, qp, lg,
                                                       is_intra=intra))
        k4_ms = _median_ms(lambda: cost.sse_rate(res, rk, lk))
        b, n = res.shape[0], 1 << lg
        b_ms, b_by = _bound(*_tq_work(b, n, True))
        m_ms, m_by = _bound(*_tq_work(b, n, True, matrix=True))
        r_ms, r_by = _bound(*_tq_work(b, n, False))
        print(f"kernel tq_cost {name} ({b} blocks): {ms:.4f} ms against K3 "
              f"+ K4 {k3:.4f} + {k4_ms:.4f} = {k3 + k4_ms:.4f} ms "
              f"({(k3 + k4_ms) / ms:.2f}x); bound {b_ms:.4f} ms ({b_by}, "
              f"butterflies), {100 * b_ms / ms:.1f}% of it; the n^3 matrix "
              f"form's count: {m_ms:.4f} ms ({m_by}); tq_roundtrip bound "
              f"{r_ms:.4f} ms ({r_by}), {100 * r_ms / k3:.1f}% of it")
        faster.append((name, ms < k3 + k4_ms))
        return ms, k3, k4_ms, (lk, rk)

    ls = torch.tensor(_lambda_sqrt(QP), dtype=torch.float32)

    def both_ms(fn):
        """(CUDA-event median ms, torch.profiler's device ms alone) of fn."""
        return _median_ms(fn), _device_ms(fn)

    def rd_check(n, top, left, src, d, timed_, work_):
        """K1's rd form on the group's n-blocks, 3 candidates (the search's
        count) from their SATDs d and MPM bits: bit for bit against its
        twin and against the parent's path (the unfused RMD cost, a stable
        sort, K1's selected form, the subtract and the bits' gather) where
        their shortlists agree (the rounding repair may move a near tie);
        each timed, with events and alone, beside the bound.  Returns the
        shortlist."""
        from fasthevc_tpu_torch.codec.search import _intra_mode_bits
        lg = n.bit_length() - 1
        bits = _intra_mode_bits(torch.argmin(d, dim=1).to(torch.int32),
                                GROUP, y.shape[1] // n, y.shape[2] // n)
        b = src.shape[0]

        def new():
            return intra.intra_rd_cands(top, left, lg, src, d, bits, ls, 3)

        def parent():
            return _shortlist_parent(torch, intra, top, left, lg, src, d,
                                     bits, ls)

        got = new()
        want = intra.intra_rd_cands_plain(top, left, lg, src, d, bits, ls, 3)
        for i, (a, w) in enumerate(zip(got, want)):
            if a.dtype == torch.float32:
                a, w = a.view(torch.int32), w.view(torch.int32)
            _same(torch, f"intra_rd_cands n={n} output {i}", a, w)
        old = parent()
        agree = (old[0] == got[0]).all(dim=1)
        moved = int((~agree).sum().item())
        _same(torch, f"intra_rd_cands against the parent's path n={n}",
              got[2].reshape(b, 3, n, n)[agree],
              old[2].reshape(b, 3, n, n)[agree])
        del old
        ms, dev = both_ms(new)
        p_ms, p_dev = both_ms(parent)
        w = (4 * (2 * b * (2 * n + 1) + b * n * n + 2 * b * 35
                  + b * 3 * n * n + 2 * b * 3),
             b * (35 * 4 + 3 * 10 * n * n))
        b_ms, b_by = _bound(*w)
        # the selected form's count: the refs and modes in, the
        # predictions out
        s_ms, s_by = _bound(4 * (2 * b * (2 * n + 1) + b * 3
                                 + b * 3 * n * n), 6 * b * 3 * n * n)
        print(f"kernel intra_rd_cands n={n} ({b} blocks, 3 candidates): "
              f"{ms:.4f} ms, alone {_ms_text(dev)}; the parent's path (sort"
              f", intra_pred_selected, subtract) {p_ms:.4f} ms, alone "
              f"{_ms_text(p_dev)}; bound {b_ms:.4f} ms ({b_by}), "
              f"{_share_text(b_ms, dev)} of the kernel alone "
              f"(intra_pred_selected's own count: {s_ms:.4f} ms, {s_by}); "
              f"shortlists moved by the RMD rounding repair: {moved} of {b}")
        if timed_ is not None:
            timed_["intra_rd_cands"] = (ms, _median_ms(
                lambda: intra.intra_rd_cands_plain(top, left, lg, src, d,
                                                   bits, ls, 3)))
            work_["intra_rd_cands"] = w
        return got[0]

    def chroma_check(cn, top, left, src, modes):
        """K1's rd form given the modes (the chroma DM residual): against
        its twin and the parent's path (K1's selected form, the subtract),
        timed as rd_check's.  Returns the residuals."""
        lg = cn.bit_length() - 1

        def new():
            return intra.intra_rd_residuals(top, left, lg, src, modes, False)

        def parent():
            return src - intra.predict_selected(top, left, lg, modes[:, 0],
                                                False)

        got = new()
        _same(torch, f"intra_rd_cands chroma n={cn}", got,
              intra.intra_rd_residuals_plain(top, left, lg, src, modes,
                                             False))
        _same(torch, f"intra_rd_cands chroma against the parent's path "
              f"n={cn}", got, parent())
        ms, dev = both_ms(new)
        p_ms, p_dev = both_ms(parent)
        b = src.shape[0]
        w = (4 * (2 * b * (2 * cn + 1) + 2 * b * cn * cn + b),
             b * 10 * cn * cn)
        b_ms, b_by = _bound(*w)
        print(f"kernel intra_rd_cands chroma n={cn} ({b} blocks): {ms:.4f} "
              f"ms, alone {_ms_text(dev)}; the parent's path "
              f"(intra_pred_selected, subtract) {p_ms:.4f} ms, alone "
              f"{_ms_text(p_dev)}; bound {b_ms:.4f} ms ({b_by}), "
              f"{_share_text(b_ms, dev)} of the kernel alone")
        return got

    # luma: all 35 modes, SATD, then the true-RD pass on the top 3 modes
    for n in (8, 16, 32):
        lg = n.bit_length() - 1
        top, left = intra.grid_refs(y, n)
        src = _blocks(y, n).contiguous()
        pk = intra.predict_all_modes(top, left, lg)
        _same(torch, f"K1 n={n}", pk, intra.predict_plain(top, left, lg))
        sk = cost.satd(src, pk)
        _same(torch, f"K2 n={n}", sk, cost.satd_plain(src, pk))
        fk = intra.predict_satd(top, left, lg, src)
        _same(torch, f"K1 fused n={n}", fk,
              intra.predict_satd_plain(top, left, lg, src))
        _same(torch, f"K1 fused against K1 + K2 n={n}", fk, sk)
        b = src.shape[0]
        fused = (_median_ms(lambda: intra.predict_satd(top, left, lg, src)),
                 _median_ms(lambda: intra.predict_satd_plain(top, left, lg,
                                                             src)))
        k12 = (_median_ms(lambda: intra.predict_all_modes(top, left, lg)),
               _median_ms(lambda: cost.satd(src, pk)))
        # the references, the source and [B, 35] cross device memory; the
        # operations are K1's and K2's per predicted sample
        w = (4 * (2 * b * (2 * n + 1) + b * n * n + b * 35),
             15 * b * 35 * n * n)
        b_ms, b_by = _bound(*w)
        print(f"kernel intra_satd n={n} ({b} blocks of the 1080p group): "
              f"{fused[0]:.4f} ms, plain twin {fused[1]:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / fused[0]:.1f}% of the "
              f"bound; K1 all-mode + K2 {k12[0]:.4f} + {k12[1]:.4f} = "
              f"{sum(k12):.4f} ms")
        # the RD shortlist: K1's rd form on the group's SATDs and MPM bits
        take = rd_check(n, top, left, src, fk, timed if n == 8 else None,
                        work)
        if n == 8:
            # the superseded selected form, on the same shortlist
            ck = intra.predict(top, left, lg, take)
            _same(torch, f"K1 selected n={n}", ck,
                  intra.predict_plain(top, left, lg, take))
            _same(torch, f"K1 selected against the gather n={n}", ck,
                  torch.take_along_dim(pk, take[:, :, None, None].long(),
                                       dim=1))
            del ck
        res = (src[:, None] - pk[:, :3]).reshape(-1, n, n).contiguous()
        ms, k3, k4_ms, (lk, rk) = tq_check(f"luma n={n}", res, lg, True)
        if n == 8:  # the largest batch: B = 8 * 136 * 240 blocks
            bt = res.shape[0]
            timed["intra_satd"], work["intra_satd"] = fused, w
            # the kernels line keeps K1's selected form, which no route
            # launches since the rd form; the all-mode form and K2 at [B,
            # 35] (phase 2b has K2's entry) are printed beside it
            timed["intra_pred_selected"] = (
                _median_ms(lambda: intra.predict(top, left, lg, take)),
                _median_ms(lambda: intra.predict_plain(top, left, lg, take)))
            work["intra_pred_selected"] = (
                4 * (2 * b * (2 * n + 1) + b * 3 + b * 3 * n * n),
                6 * b * 3 * n * n)
            # K3's plain form and K4, which no route launches, are printed
            # beside tq_cost; their twins here
            for name, ms_k, plain_fn, wb in (
                    ("intra_pred all-mode form", k12[0],
                     lambda: intra.predict_plain(top, left, lg),
                     (4 * (2 * b * (2 * n + 1) + b * 35 * n * n),
                      6 * b * 35 * n * n)),
                    ("satd at [B, 35]", k12[1],
                     lambda: cost.satd_plain(src, pk),
                     (4 * (b * n * n + b * 35 * n * n + b * 35),
                      9 * b * 35 * n * n)),
                    ("tq_roundtrip", k3,
                     lambda: transform.tq_roundtrip_plain(res, qp, lg),
                     _tq_work(bt, n, False)),
                    ("sse_rate", k4_ms,
                     lambda: cost.sse_rate_plain(res, rk, lk),
                     (4 * 3 * bt * n * n + 8 * bt, 12 * bt * n * n))):
                b_ms, b_by = _bound(*wb)
                print(f"kernel {name} n={n} (no route launches it): "
                      f"{ms_k:.4f} ms, plain twin "
                      f"{_median_ms(plain_fn):.4f} ms, bound {b_ms:.4f} ms "
                      f"({b_by})")
            timed["tq_cost"] = (ms, _median_ms(
                lambda: transform.tq_cost_plain(res, qp, lg)))
            work["tq_cost"] = _tq_work(bt, n, True)
        del pk, sk, fk, res, lk, rk
    # chroma DM: one selected mode per block, at both dead-zone offsets
    gen = torch.Generator(device="cpu").manual_seed(7)
    for cn in (4, 8, 16):
        lg = cn.bit_length() - 1
        top, left = intra.grid_refs(c, cn)
        modes = torch.randint(0, 35, (top.shape[0], 1), generator=gen).to(
            c.device)
        res = chroma_check(cn, top, left, _blocks(c, cn).contiguous(),
                           modes)
        for intra_dz in (True, False):
            tq_check(f"chroma n={cn} {'intra' if intra_dz else 'inter'}",
                     res, lg, intra_dz)
    print("tq_cost faster than K3 + K4 on the same inputs: "
          + ", ".join(f"{name} {'yes' if ok else 'NO'}"
                      for name, ok in faster))
    torch.cuda.synchronize()


def _intra_commit(torch, y, c, sp):
    """Phase 2a's K5 call on the decisions of one search of the group:
    (run(frames, plain), planes and maps)."""
    from fasthevc_tpu_torch.codec.search import search_intra_maps_batch
    from fasthevc_tpu_torch.ops import commit
    from fasthevc_tpu_torch.spec.ctu import tu_qps

    cb, cr = c, 255 - c
    ls = _lambda_sqrt(QP)
    pk = search_intra_maps_batch(y, ls, 5, 3, WIDTH, HEIGHT, cb_batch=cb,
                                 cr_batch=cr)
    gh, gw = HEIGHT // 8, WIDTH // 8
    d = dict(dm=pk[:, :gh, :gw, 0].to(torch.int32),
             mm=pk[:, :gh, :gw, 1].to(torch.int32),
             sy=y[:, :HEIGHT].contiguous(),
             scb=cb[:, :HEIGHT // 2].contiguous(),
             scr=cr[:, :HEIGHT // 2].contiguous())
    qy, qcb, qcr = tu_qps(sp, QP)
    lam = float(torch.tensor(ls, dtype=torch.float32) ** 2)
    d.update(qy=qy, qcb=qcb, qcr=qcr, lam=lam)
    tbx = tuple(int(b) * 32 for b in sp.tile_col_bounds()[1:-1])
    tby = tuple(int(b) * 32 for b in sp.tile_row_bounds()[1:-1])

    def run_commit(frames, plain):
        return commit.wavefront_commit_intra(
            d["sy"][:frames], d["scb"][:frames], d["scr"][:frames],
            d["dm"][:frames], d["mm"][:frames], qy, qcb, qcr, WIDTH, HEIGHT,
            True, tbx, tby, rdoq=True, lam=lam, plain=plain)

    return run_commit, d


def _k5_steps() -> int:
    """K5's dependent CTU steps at 1080p: nctux + 2 (nctuy - 1)."""
    return WIDTH // 32 + 2 * (-(-HEIGHT // 32) - 1)


def _k5_least_step(torch, d) -> float:
    """The least time of one of K5's dependent CTU steps: over rows 8, 16
    and 24 of the first frame, the slope between one-row pictures of 60
    and 4 CTUs (each a chain of that many steps, one launch a call)."""
    from fasthevc_tpu_torch.ops import commit
    qy, qcb, qcr, lam = d["qy"], d["qcb"], d["qcr"], d["lam"]
    best = float("inf")
    for row in (8, 16, 24):
        ms = {}
        for k in (4, WIDTH // 32):
            y0, w = row * 32, k * 32
            args = (d["sy"][:1, y0:y0 + 32, :w],
                    d["scb"][:1, y0 // 2:y0 // 2 + 16, :w // 2],
                    d["scr"][:1, y0 // 2:y0 // 2 + 16, :w // 2],
                    d["dm"][:1, y0 // 8:y0 // 8 + 4, :w // 8],
                    d["mm"][:1, y0 // 8:y0 // 8 + 4, :w // 8],
                    qy, qcb, qcr, w, 32, True, (), ())
            ms[k] = _median_ms(lambda: commit.wavefront_commit_intra(
                *args, rdoq=True, lam=lam), reps=9)
        best = min(best, (ms[WIDTH // 32] - ms[4]) / (WIDTH // 32 - 4))
    return best


def _k5_mixed_least_step(torch, d) -> float:
    """The least time of one dependent CTU step of K5's mixed form (RDOQ
    on): over rows 8, 16 and 24 of phase 2b's P frame, the slope between
    one-row pictures of 60 and 4 CTUs with that row's decisions and MC
    planes, as _k5_least_step takes it for the intra form."""
    from fasthevc_tpu_torch.ops import commit
    lam = float(torch.tensor(_lambda_sqrt(QP), dtype=torch.float32) ** 2)
    best = float("inf")
    for row in (8, 16, 24):
        ms = {}
        for k in (4, WIDTH // 32):
            y0, w = row * 32, k * 32

            def crop(p, s):
                """rows y0.. of a [(1,) H, W] plane at 1/s scale"""
                p = p if p.dim() == 3 else p[None]
                return p[:, y0 // s:(y0 + 32) // s, :w // s].contiguous()

            args = ([crop(p, 1 + (i > 0)) for i, p in enumerate(d["src"])]
                    + [crop(d[m], 8) for m in ("dm", "mm", "im")]
                    + [crop(p, 1 + (i > 0)) for i, p in enumerate(d["pred"])]
                    + [[QP], [QP], [QP], w, 32, True])
            ms[k] = _median_ms(lambda: commit.wavefront_commit_mixed(
                *args, rdoq=True, lam=[lam]), reps=9)
        best = min(best, (ms[WIDTH // 32] - ms[4]) / (WIDTH // 32 - 4))
    return best


def _alone_text(name: str, label: str, timed: dict, fn, keys) -> None:
    """Prints a kernel's events time beside its time alone (the card's own
    time of its kernels, without the wrapper's host work)."""
    print(f"kernel {name} ({label}): {timed[name][0]:.4f} ms, the kernel "
          f"alone {_ms_text(_device_ms(fn, keys))}")


def _sao_work(px: float) -> tuple:
    """K7's (bytes, int32 operations) on px luma samples and their chroma:
    src and rec read and the plane written once, int32 each; about 30
    operations a sample (4 edge classes and the band)."""
    return (px * 1.5 * 4 * 3, 30 * px * 1.5)


def _sao_check(torch, label: str, args: tuple, kw: dict, px: float,
               timed=None, work=None, keys=("sao_fused", "sao")) -> None:
    """K7's fused form against its twin and against the earlier two-launch
    form (the parent's), bit for bit; both timed with events and alone
    (torch.profiler's device time of their kernels); prints the bound and
    the fused form's share of it.  With `timed`, the rows of keys[0] (the
    fused form) and keys[1] (the earlier form)."""
    from fasthevc_tpu_torch.ops import sao

    def new():
        return sao.sao(*args, **kw)

    def old():
        return sao.sao_two_pass(*args, **kw)

    def twin():
        return sao.sao(*args, plain=True, **kw)

    got = new()
    for ref, what in ((twin(), "twin"), (old(), "earlier form")):
        for name, a, b in zip(("y", "cb", "cr", "params"), got, ref):
            _same(torch, f"K7 {label} {name} ({what})", a, b)
    types = torch.bincount(got[3][..., 0].flatten().long(),
                           minlength=3).tolist()
    ms, old_ms = _median_ms(new), _median_ms(old)
    dev = _device_ms(new, ("sao_fused_kernel",))
    old_dev = _device_ms(old, ("sao_stats_kernel", "sao_apply_kernel"))
    wk = _sao_work(px)
    b_ms, b_by = _bound(*wk)
    print(f"kernel {keys[0]} ({label}; CTB parameters off / band / edge "
          f"{types}): {ms:.4f} ms (the kernel alone {_ms_text(dev)}), the "
          f"earlier form {old_ms:.4f} ms (its two kernels alone "
          f"{_ms_text(old_dev)}); bound {b_ms:.4f} ms ({b_by}), "
          f"{_share_text(b_ms, dev)} of it alone, {_share_text(b_ms, ms)} by "
          f"events")
    if timed is not None:
        plain_ms = _median_ms(twin)
        timed[keys[0]], timed[keys[1]] = (ms, plain_ms), (old_ms, plain_ms)
        work[keys[0]] = work[keys[1]] = wk


def _planes_check(torch, label: str, pred, keys: tuple, wk: tuple, timed,
                  work) -> None:
    """K11's planes form (pred("fused")) against its twin (pred("twin"))
    and the earlier form a component (pred("earlier"), the parent's), bit
    for bit; both timed with events and alone; prints the bound and the
    planes form's share of it; fills the rows of keys (planes form,
    earlier form)."""
    got = pred("fused")
    for ref, what in ((pred("twin"), "twin"), (pred("earlier"),
                                               "earlier form")):
        for name, a, b in zip(("y", "cb", "cr"), got, ref):
            _same(torch, f"K11 {keys[0]} {name} ({what})", a, b)
    ms, old_ms = (_median_ms(lambda: pred("fused")),
                  _median_ms(lambda: pred("earlier")))
    plain_ms = _median_ms(lambda: pred("twin"))
    dev = _device_ms(lambda: pred("fused"), ("inter_planes_kernel",))
    old_dev = _device_ms(lambda: pred("earlier"), ("inter_pred_kernel",))
    b_ms, b_by = _bound(*wk)
    print(f"kernel {keys[0]} ({label}, the three components): {ms:.4f} ms "
          f"(the kernel alone {_ms_text(dev)}), the earlier form a "
          f"component {old_ms:.4f} ms (its three launches alone "
          f"{_ms_text(old_dev)}), plain twin {plain_ms:.4f} ms; bound "
          f"{b_ms:.4f} ms ({b_by}), {_share_text(b_ms, dev)} of it alone, "
          f"{_share_text(b_ms, ms)} by events")
    timed[keys[0]], timed[keys[1]] = (ms, plain_ms), (old_ms, plain_ms)
    work[keys[0]] = work[keys[1]] = wk


def phase_pixel_kernels(torch, y, c, sp, timed, work):
    """K5-K8 on the decisions of one 1080p search; K6-K8 against their
    twins here, K5 against its twin in the job k5-intra."""
    from fasthevc_tpu_torch.codec import device_pipeline as dp
    from fasthevc_tpu_torch.ops import deblock, sao

    run_commit, d = _intra_commit(torch, y, c, sp)
    dm, sy, scb, scr = d["dm"], d["sy"], d["scb"], d["scr"]
    qcb, qcr = d["qcb"], d["qcr"]
    gh, gw = HEIGHT // 8, WIDTH // 8
    rec = run_commit(GROUP, False)
    steps = _k5_steps()
    k5_ms = {f: _median_ms(lambda: run_commit(f, False), reps=3)
             for f in (1, TWIN_FRAMES, GROUP)}
    timed["commit_intra"] = (k5_ms[TWIN_FRAMES], None)
    # source in, recon out (int32), levels out (int16), 1.5 planes each
    px = TWIN_FRAMES * HEIGHT * WIDTH * 1.5
    work["commit_intra"] = (px * (4 + 4 + 2),
                            _transform_ops(dm[:TWIN_FRAMES]))
    for f, ms in k5_ms.items():
        print(f"kernel commit_intra, {f} 1080p frame(s), RDOQ on: "
              f"{ms:.4f} ms, {ms / steps:.4f} ms per dependent step "
              f"({steps} steps)")
    step = _k5_least_step(torch, d)
    print(f"kernel commit_intra: least CTU step {step:.4f} ms (the slope "
          f"of one-row pictures of 4 and {WIDTH // 32} CTUs, the least of 3 "
          f"rows); latency bound {steps} x {step:.4f} = {steps * step:.4f} "
          f"ms a 1080p call")

    ry, rcb, rcr = rec[:3]
    dargs = (ry, rcb, rcr, dm, QP, qcb, qcr, 5)
    dk = deblock.deblock(*dargs)
    for name, a, b in zip(("y", "cb", "cr"), dk,
                          deblock.deblock(*dargs, plain=True)):
        _same(torch, f"K6 {name}", a, b)
    timed["deblock"] = (_median_ms(lambda: deblock.deblock(*dargs)),
                        _median_ms(lambda: deblock.deblock(*dargs,
                                                           plain=True)))
    _alone_text("deblock", f"1080p group of {GROUP}", timed,
                lambda: deblock.deblock(*dargs), ("deblock_kernel",))
    gpx = GROUP * HEIGHT * WIDTH
    segs = GROUP * (HEIGHT // 4 * gw + WIDTH // 4 * gh)
    work["deblock"] = (gpx * 1.5 * 4 * 2 + 4 * GROUP * gh * gw, 120 * segs)
    sargs = (sy, scb, scr) + tuple(dk) + (5,)
    _sao_check(torch, f"1080p group of {GROUP}", sargs, {}, gpx, timed,
               work)
    _sao_check(torch, "one 1080p picture",
               tuple(a[:1] for a in sargs[:6]) + (5,), {}, HEIGHT * WIDTH)
    y8 = sao.sao(*sargs)[0].to(torch.uint8)
    _same(torch, "K8", dp.device_checksum(y8),
          dp.device_checksum(y8, plain=True))
    timed["checksum"] = (
        _median_ms(lambda: dp.device_checksum(y8)),
        _median_ms(lambda: dp.device_checksum(y8, plain=True)))
    _alone_text("checksum", f"1080p group of {GROUP}, luma", timed,
                lambda: dp.device_checksum(y8), ("checksum_kernel",))
    work["checksum"] = (gpx + 4 * GROUP, 4 * gpx)
    torch.cuda.synchronize()


def _p_frames(torch, dev):
    """Frame 2 of the synthesized 1080p clip of phase 7 as a P frame, with
    frames 1 and 0 as its references: (src [3 planes], refs [3 planes of
    [2, H, W]]), int32 on dev."""
    clip = _ldp_clip()[:3]

    def planes(k):
        return [torch.from_numpy(np.asarray(p, np.int32)).to(dev)
                for p in clip[k]]

    src, ref_a, ref_b = planes(2), planes(1), planes(0)
    return src, [torch.stack([a, b]) for a, b in zip(ref_a, ref_b)]


def _p_commit_inputs(torch):
    """Phase 2b's P frame: its source planes and references, the padded
    luma and reference planes, its P search decisions (kernels) and the
    MC planes (K11)."""
    from fasthevc_tpu_torch.codec.search import search_p_maps
    from fasthevc_tpu_torch.ops import me

    dev = torch.device("cuda")
    src, refs = _p_frames(torch, dev)
    ph = -(-HEIGHT // 32) * 32
    pad = (0, 0, 0, ph - HEIGHT)
    y = torch.nn.functional.pad(src[0][None].float(), pad,
                                mode="replicate")[0].to(torch.int32)
    r = torch.nn.functional.pad(refs[0].float(), pad,
                                mode="replicate").to(torch.int32)
    pk = search_p_maps(y[None], r[None], [_lambda_sqrt(QP)], 5, 3, WIDTH,
                       HEIGHT, SR, nref=[2])
    gh, gw = HEIGHT // 8, WIDTH // 8
    d = dict(src=src, refs=refs, y=y, r=r,
             dm=pk[:, :gh, :gw, 0].to(torch.int32),
             mm=pk[:, :gh, :gw, 1].to(torch.int32),
             im=pk[:, :gh, :gw, 2].to(torch.int32),
             mv=pk[:, :gh, :gw, 3:7].to(torch.int32),
             rm=pk[:, :gh, :gw, 7:9].to(torch.int32))
    d["pred"] = me.inter_pred_planes(tuple(p[None] for p in refs), None,
                                     d["im"], d["mv"], ref_map=d["rm"])
    return d


def _run_mixed(torch, d, plain):
    """Phase 2b's K5 mixed call: one frame, RDOQ on."""
    from fasthevc_tpu_torch.ops import commit
    lam = float(torch.tensor(_lambda_sqrt(QP), dtype=torch.float32) ** 2)
    return commit.wavefront_commit_mixed(
        *(p[None] for p in d["src"]), d["dm"], d["mm"], d["im"], *d["pred"],
        [QP], [QP], [QP], WIDTH, HEIGHT, True, rdoq=True, lam=[lam],
        plain=plain)


def _subpel_ops(n: int, blocks: int, per_candidate_h: bool = False
                ) -> int:
    """K10's operations on `blocks` (reference, n-block) pairs, a
    multiply-add counted as two: the four horizontal 8-tap phases of a
    block's window ((n + 8) rows of n + 1 columns) once a block, then each
    of the 17 candidates' vertical 8-tap pass and SATD (~12 per sample).
    per_candidate_h: the earlier count, in which every candidate paid its
    own (n + 7) x n horizontal pass (printed for comparison only)."""
    if per_candidate_h:
        return blocks * 17 * ((n + 7) * n * 16 + n * n * 28)
    return blocks * (4 * (n + 8) * (n + 1) * 16 + 17 * n * n * 28)


def _subpel_bound_text(n: int, blocks: int, w: tuple, ms: float) -> str:
    """K10's bound and share of it, beside its share of the earlier
    per-candidate count."""
    b_ms, b_by = _bound(*w)
    old_ms = _bound(w[0], _subpel_ops(n, blocks, per_candidate_h=True))[0]
    return (f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of the "
            f"bound (against the earlier count, a horizontal pass per "
            f"candidate: {old_ms:.4f} ms, {100 * old_ms / ms:.1f}%)")


def _k9_work(h: int, w: int, rr: int, tiers) -> dict:
    """K9's (bytes, int32 operations) on an h x w picture with rr
    references at SR: "me_coarse" and "me_fine" as the fused form counts
    them (the tier-16 blocks' absolute differences, 3 operations each, and
    3 additions a larger block and offset for its children's sum; the
    8-blocks' refinements and 3 additions a 16-block and offset), and
    "old": the operations of the five separate searches (each tier's own
    absolute differences).  Bytes: the search planes, the bases and the
    MVs, each read or written once."""
    scale = 4 if SR > 8 else 1
    rng = SR if scale == 1 else -(-SR // 4)
    offs = (2 * rng + 1) ** 2
    nb = {n: (h // n) * (w // n) for n in (8,) + tuple(tiers)}
    mvs = 8 * rr * sum(nb[n] for n in tiers)
    coarse_ops = rr * offs * (nb[16] * (16 // scale) ** 2 * 3
                              + 3 * sum(nb[n] for n in tiers if n > 16))
    fine_ops = rr * 49 * 3 * (nb[8] * 64 + nb[16]
                              + sum(nb[n] * n * n for n in tiers if n > 16))
    old_ops = rr * (offs * 3 * sum(nb[n] * (n // scale) ** 2 for n in tiers)
                    + 49 * 3 * (nb[8] * 64 + sum(nb[n] * n * n
                                                 for n in tiers)))
    return {"me_coarse": (4 * (1 + rr) * h * w / scale ** 2 + mvs,
                          coarse_ops),
            "me_fine": (4 * (1 + rr) * h * w + 2 * mvs + 8 * rr * nb[8],
                        fine_ops),
            "old": (4 * (1 + rr) * h * w * (1 + 1 / scale ** 2), old_ops)}


def _k9_check(torch, label: str, y, refs, tiers, timed=None, work=None):
    """K9's fused form (me_coarse on the 1/4 planes, me_fine) on one picture
    at SR: each against its twin, both equal to the earlier form's five
    sad_search calls (the parent's path), which are timed too; prints each
    kernel's time, twin time, bound by the fused count and share of it,
    with the earlier count's bound beside.  Returns the ME state."""
    from fasthevc_tpu_torch.ops import me

    ds = me.downsample4(torch.cat([y[None], refs]))
    sr4 = -(-SR // 4)

    def old():
        base = {n: me.sad_search(ds[0], ds[1:], None, n // 4, sr4, n // 4,
                                 4, SR) for n in tiers}
        mv = {n: me.sad_search(y, refs, base[n], n, 3, n, 1, SR)
              for n in tiers}
        mv[8] = me.sad_search(y, refs, base[16], 8, 3, 16, 1, SR)
        return base, mv

    def coarse(plain=False):
        return me.me_coarse(ds[0], ds[1:], SR, tiers, 4, plain=plain)

    base = coarse()

    def fine(plain=False):
        return me.me_fine(y, refs, base, SR, tiers, plain=plain)

    mv = fine()
    ob, om = old()
    for got, twin, parent in ((base, coarse(True), ob),
                              (mv, fine(True), om)):
        for n in twin:
            _same(torch, f"K9 {label} n={n}", got[n], twin[n])
            _same(torch, f"K9 {label} n={n} (earlier form)", parent[n],
                  got[n])
    ms = {"me_coarse": (_median_ms(coarse), _median_ms(lambda: coarse(True),
                                                       reps=1)),
          "me_fine": (_median_ms(fine), _median_ms(lambda: fine(True),
                                                   reps=1))}
    dev = {"me_coarse": _device_ms(coarse, ("me_coarse_kernel",)),
           "me_fine": _device_ms(fine, ("me_fine_kernel",))}
    old_ms, old_dev = _median_ms(old), _device_ms(old, ("sad_search",))
    h, w = y.shape
    wk = _k9_work(h, w, refs.shape[0], tiers)
    old_b = _bound(*wk["old"])[0]
    new_b = _bound(*wk["me_coarse"])[0] + _bound(*wk["me_fine"])[0]
    for name in ("me_coarse", "me_fine"):
        b_ms, b_by = _bound(*wk[name])
        print(f"kernel {name} ({label}): {ms[name][0]:.4f} ms (the kernel "
              f"alone {_ms_text(dev[name])}), plain twin {ms[name][1]:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{_share_text(b_ms, dev[name])} of the bound")
    both = ms["me_coarse"][0] + ms["me_fine"][0]
    both_dev = (None if None in dev.values()
                else dev["me_coarse"] + dev["me_fine"])
    print(f"K9 ({label}): me_coarse + me_fine {both:.4f} ms (the kernels "
          f"alone {_ms_text(both_dev)}) against the earlier form's five "
          f"sad_search calls {old_ms:.4f} ms (alone {_ms_text(old_dev)}; the"
          f" parent's path, this run); bound by the fused count "
          f"{new_b:.4f} ms ({_share_text(new_b, both_dev)} of the kernels "
          f"alone), by the five searches' count {old_b:.4f} ms "
          f"({_share_text(old_b, both_dev)})")
    if timed is not None:
        for name in ("me_coarse", "me_fine"):
            timed[name], work[name] = ms[name], wk[name]
    st = me.MEState(y, refs, SR)
    st.tiers, st.base, st.mv_int = list(tiers), base, mv
    return st


def _merge_work(h: int, w: int, n: int, lists: int) -> tuple:
    """mc_merge's (bytes, int32 operations) on an h x w picture: per list
    the source, the ME winners' predictions, at least one reference
    plane's area and the winners' predictions written, each once, and the
    per-block fields in and out; two candidates' separable filters and
    8x8 Hadamard SATDs (~9 operations a sample)."""
    b = (h // n) * (w // n)
    return (lists * (4 * 4 * h * w + 2 * 20 * b),
            lists * 2 * b * (_interp_ops(n, 8) + 9 * n * n))


def _merge_check(torch, label: str, st, lists, n: int, ls: float,
                 timed=None, work=None) -> None:
    """K11's merge form on one block size: against its twin and against the
    earlier form's path (mc_sel, K2 and the fold's torch ops, the
    parent's), bit for bit, all three timed; prints the bound."""
    from fasthevc_tpu_torch.ops import cost, me

    def new():
        return me.mc_merge(st, lists, n, ls)

    def twin():
        return me.mc_merge(st, lists, n, ls, plain=True)

    def old():
        return me.mc_merge_plain(st, lists, n, ls, -1, me.mc_sel,
                                 cost.satd)

    got = new()
    for ref, what in ((twin(), "twin"), (old(), "earlier form")):
        for li, (a, c) in enumerate(zip(got, ref)):
            for k, (x, z) in enumerate(zip(a, c)):
                if x.dtype == torch.float32:
                    x, z = x.view(torch.int32), z.view(torch.int32)
                _same(torch, f"K11 mc_merge {label} n={n} list {li} "
                      f"output {k} ({what})", x, z)
    merged = sum(int((a[4] == 2.0).sum()) for a in got)
    ms, plain_ms, old_ms = (_median_ms(new), _median_ms(twin, reps=1),
                            _median_ms(old))
    dev, old_dev = _device_ms(new, ("mc_merge_kernel",)), _device_ms(old)
    h, w = st.y.shape
    wk = _merge_work(h, w, n, len(lists))
    b_ms, b_by = _bound(*wk)
    print(f"kernel mc_merge n={n} ({label}, {len(lists)} list(s), "
          f"{merged} merge winners): {ms:.4f} ms (the kernel alone "
          f"{_ms_text(dev)}), plain twin {plain_ms:.4f} ms, the earlier form"
          f" (mc_sel + satd + the fold's torch ops, the parent's path) "
          f"{old_ms:.4f} ms (its kernels alone {_ms_text(old_dev)}); bound "
          f"{b_ms:.4f} ms ({b_by}), {_share_text(b_ms, dev)} of the bound")
    if timed is not None:
        timed["mc_merge"], work["mc_merge"] = (ms, plain_ms), wk


def _merge_lists(torch, st, sp, n: int, pairs) -> list:
    """mc_merge's lists of one block size from the sub-pel results: per
    (ia, ib) the ME winners of `_pick_ref`."""
    from fasthevc_tpu_torch.codec.search import _pick_ref
    from fasthevc_tpu_torch.ops import me
    out = []
    for ia, ib in pairs:
        c, mv, pred, sel = _pick_ref(sp[n], ia, ib)
        out.append((ia, ib, mv, sel.to(torch.int32), pred, c,
                    me.mv_rate_bits(mv)))
    return out


def phase_inter_kernels(torch, timed, work):
    """K9-K11, K5's mixed form and K6 with strengths on one 1080p P frame
    (SR 64, two references), against their twins (K5's in the job
    k5-mixed); K9's and K11's earlier forms beside their fused ones, as
    the parent's path."""
    from fasthevc_tpu_torch.codec.search import _blocks
    from fasthevc_tpu_torch.ops import cost, deblock, me

    dev = torch.device("cuda")
    d = _p_commit_inputs(torch)
    refs, y, r = d["refs"], d["y"], d["r"]
    ph = -(-HEIGHT // 32) * 32
    ls = _lambda_sqrt(QP)
    hw, rr = ph * WIDTH, r.shape[0]

    # K9: decimation; the earlier form's coarse full search (tier 16 on
    # the 1/4 planes) and +-3 refinement of the 8-blocks around their
    # 16-parent's base, each a launch (their rows of the kernels line);
    # then the fused form against its twins and the earlier five calls
    planes = torch.cat([y[None], r])
    ds = me.downsample4(planes)
    _same(torch, "K9 downsample4", ds, me.downsample4(planes, plain=True))
    timed["me_downsample4"] = (
        _median_ms(lambda: me.downsample4(planes)),
        _median_ms(lambda: me.downsample4(planes, plain=True)))
    work["me_downsample4"] = (4 * 3 * hw * (1 + 1 / 16), 17 * 3 * hw / 16)
    sr4 = -(-SR // 4)
    fargs = (ds[0], ds[1:], None, 4, sr4, 4, 4, SR)
    base16 = me.sad_search(*fargs)
    _same(torch, "K9 full search", base16, me.sad_search(*fargs, plain=True))
    timed["me_full_search"] = (
        _median_ms(lambda: me.sad_search(*fargs), reps=3),
        _median_ms(lambda: me.sad_search(*fargs, plain=True), reps=1))
    b16 = hw // 256
    work["me_full_search"] = (4 * (3 * hw / 16 + rr * b16 * 2),
                              3 * rr * b16 * (2 * sr4 + 1) ** 2 * 16)
    rargs = (y, r, base16, 8, 3, 16, 1, SR)
    mv8 = me.sad_search(*rargs)
    _same(torch, "K9 refine", mv8, me.sad_search(*rargs, plain=True))
    timed["me_refine"] = (
        _median_ms(lambda: me.sad_search(*rargs)),
        _median_ms(lambda: me.sad_search(*rargs, plain=True), reps=1))
    b8 = hw // 64
    work["me_refine"] = (4 * (3 * hw + rr * b8 * 2), 3 * rr * b8 * 49 * 64)
    st = _k9_check(torch, f"1080p P frame, {rr} refs, SR {SR}", y, r,
                   [16, 32], timed, work)

    # K10 on the 8-blocks (the largest batch, the kernels line's entry),
    # the 16- and 32-blocks on me_state's tier MVs
    for n in (8, 16, 32):
        mvn = mv8 if n == 8 else st.mv_int[n]
        got = me.subpel(y, r, mvn, n, ls)
        for name, a, b in zip(("cost", "mvq", "pred"), got,
                              me.subpel(y, r, mvn, n, ls, plain=True)):
            _same(torch, f"K10 n={n} {name}", a, b)
        ms = (_median_ms(lambda: me.subpel(y, r, mvn, n, ls)),
              _median_ms(lambda: me.subpel(y, r, mvn, n, ls, plain=True),
                         reps=1))
        b = hw // (n * n)
        w = (4 * (3 * hw + rr * b * (3 + n * n)), _subpel_ops(n, rr * b))
        print(f"kernel subpel n={n} (1080p P frame, {rr} refs, {b} blocks): "
              f"{ms[0]:.4f} ms, plain twin {ms[1]:.4f} ms, "
              + _subpel_bound_text(n, rr * b, w, ms[0]))
        if n == 8:
            sk = got
            timed["subpel"], work["subpel"] = ms, w

    # K11's earlier merge form: the merge candidates' MC (left
    # neighbours' MVs, mixed refs), then K2 on their predictions, one a
    # block, as the parent's P search launched them
    mvq = sk[1][0].reshape(ph // 8, WIDTH // 8, 2)
    left = torch.cat([torch.zeros_like(mvq[:, :1]), mvq[:, :-1]], 1)
    left = left.reshape(-1, 2).contiguous()
    sel = (torch.arange(b8, device=dev) % 3 == 0).to(torch.int32)
    margs = (r, base16, left, sel, 8, 16)
    mk = me.mc_sel(*margs)
    mp = me.mc_sel(*margs, plain=True)
    if not torch.equal(mk[1], mp[1]) or not bool(mk[1].any()):
        raise AssertionError("K11 mc_sel: valid differs from the twin")
    _same(torch, "K11 mc_sel raw", mk[0], mp[0])
    timed["mc_sel"] = (_median_ms(lambda: me.mc_sel(*margs)),
                       _median_ms(lambda: me.mc_sel(*margs, plain=True)))
    work["mc_sel"] = (4 * (rr * hw + b8 * (64 + 4)),
                      b8 * _interp_ops(8, 8))
    srcb = _blocks(y[None], 8).contiguous()
    predc = ((mk[0] + 32) >> 6).clamp(0, 255).reshape(b8, 1, 8, 8)
    predc = predc.contiguous()
    _same(torch, "K2 merge candidates n=8", cost.satd(srcb, predc),
          cost.satd_plain(srcb, predc))
    timed["satd"] = (_median_ms(lambda: cost.satd(srcb, predc)),
                     _median_ms(lambda: cost.satd_plain(srcb, predc)))
    work["satd"] = (4 * (2 * b8 * 64 + b8), 9 * b8 * 64)

    # K11's merge form, the P search's: one list over both references,
    # n = 8 (the kernels line's entry), 16 and 32
    sp = me.subpel_from_state(st, ls)
    for n in (8, 16, 32):
        _merge_check(torch, "1080p P frame", st,
                     _merge_lists(torch, st, sp, n, [(0, 1)]), n, ls,
                     *((timed, work) if n == 8 else ()))
    del sp

    # the P search of the frame gives the commit's decisions
    gh, gw = HEIGHT // 8, WIDTH // 8
    dm, im, mv, rm = d["dm"], d["im"], d["mv"], d["rm"]
    inter = float((im > 0).float().mean().item())
    ref1 = float((rm[..., 0] == 1).float().mean().item())
    print(f"P search of the phase-2 frame: {inter:.3f} of the granules "
          f"inter, {ref1:.3f} on the second reference")
    ref_stacks = tuple(p[None] for p in refs)

    def pred(form):
        if form == "earlier":
            return me.inter_pred_planes_by_comp(ref_stacks, None, im, mv,
                                                ref_map=rm)
        return me.inter_pred_planes(ref_stacks, None, im, mv, ref_map=rm,
                                    plain=form == "twin")

    for name, a, b in zip(("y", "cb", "cr"), d["pred"], pred("twin")):
        _same(torch, f"K11 inter_pred_fused {name} (route's call)", a, b)
    fpx = HEIGHT * WIDTH
    # uni-prediction: one luma 8x8 and two chroma 4x4 granules each
    _planes_check(torch, "1080p P frame, 2 refs", pred,
                  ("inter_pred_fused", "inter_pred"),
                  (4 * (rr * 1.5 * fpx + 1.5 * fpx) + 4 * 7 * gh * gw,
                   gh * gw * (_interp_ops(8, 8) + 2 * _interp_ops(4, 4))),
                  timed, work)

    # K5's mixed form, one frame, RDOQ on (its twin in the job k5-mixed)
    qc = QP
    rec = _run_mixed(torch, d, False)
    timed["commit_mixed"] = (
        _median_ms(lambda: _run_mixed(torch, d, False), reps=3), None)
    ph8 = -(-HEIGHT // 32) * 4
    ctu_intra = torch.nn.functional.pad(
        (im[0] == 0).float(), (0, 0, 0, ph8 - gh)).reshape(
        ph8 // 4, 4, gw // 4, 4).amax(dim=(1, 3))
    ms = timed["commit_mixed"][0]
    print(f"kernel commit_mixed, 1 1080p P frame, RDOQ on: {ms:.4f} ms, "
          f"{ms / _k5_steps():.4f} ms per dependent step ({_k5_steps()} "
          f"steps); {1 - inter:.4f} of the granules intra, "
          f"{ctu_intra.mean().item():.4f} of the CTUs holding an intra CU")
    step = _k5_mixed_least_step(torch, d)
    print(f"kernel commit_mixed: least CTU step {step:.4f} ms (the slope "
          f"of one-row P pictures of 4 and {WIDTH // 32} CTUs, the least of "
          f"3 rows); latency bound {_k5_steps()} x {step:.4f} = "
          f"{_k5_steps() * step:.4f} ms a 1080p call")
    work["commit_mixed"] = (fpx * 1.5 * (4 + 4 + 4 + 2),
                            _transform_ops(dm))

    # K6's cbf pass, then K6 with strengths from it, one frame
    lv = rec[3]
    cbf = deblock.tu_cbf(lv, dm, 5)
    _same(torch, "K6 cbf", cbf, deblock.tu_cbf(lv, dm, 5, plain=True))
    timed["deblock_cbf"] = (
        _median_ms(lambda: deblock.tu_cbf(lv, dm, 5)),
        _median_ms(lambda: deblock.tu_cbf(lv, dm, 5, plain=True)))
    _alone_text("deblock_cbf", "1080p P frame", timed,
                lambda: deblock.tu_cbf(lv, dm, 5), ("cbf_kernel",))
    work["deblock_cbf"] = (2 * fpx + 8 * gh * gw, fpx)
    dargs = (*rec[:3], dm, [QP], [qc], [qc], 5)
    kw = dict(dir_map=im, mv_map=mv, ref_map=rm, cbf=cbf)
    dk = deblock.deblock(*dargs, **kw)
    for name, a, b in zip(("y", "cb", "cr"), dk,
                          deblock.deblock(*dargs, plain=True, **kw)):
        _same(torch, f"K6 bs {name}", a, b)
    timed["deblock_bs"] = (
        _median_ms(lambda: deblock.deblock(*dargs, **kw)),
        _median_ms(lambda: deblock.deblock(*dargs, plain=True, **kw)))
    _alone_text("deblock_bs", "1080p P frame", timed,
                lambda: deblock.deblock(*dargs, **kw), ("deblock_kernel",))
    segs = HEIGHT // 4 * gw + WIDTH // 4 * gh
    work["deblock_bs"] = (fpx * 1.5 * 4 * 2 + 4 * gh * gw * 8,
                          (120 + 40) * segs)
    torch.cuda.synchronize()


def _ra_clip():
    from fasthevc_tpu_torch.utils import synthesize_yuv
    return synthesize_yuv(WIDTH, HEIGHT, RA_FRAMES, seed=7)


def _ra_cfg(frames: int):
    """random_access_gop16 at 1080p QP32 with the checksum hash."""
    from fasthevc_tpu_torch.config import random_access_gop16
    return random_access_gop16(width=WIDTH, height=HEIGHT, qp=QP,
                               frames=frames, hash_type=2)


def phase_b_kernels(torch, timed, work):
    """K9's fused form over the four state references, K11's merge form
    over both lists (n = 8, 16, 32), K12's selected form (and bi_cost at
    n = 8) and K11's bi-predicting planes against their twins on POC 4 of
    the random-access clip, with
    references 0, 8 (list 0) and 8, 16 (list 1) as the GOP-16 gives them,
    at SR 64 and POC 4's QP (32 + 2)."""
    from fasthevc_tpu_torch.codec.search import search_b_maps
    from fasthevc_tpu_torch.ops import me

    dev = torch.device("cuda")
    clip = _ra_clip()
    ph = -(-HEIGHT // 32) * 32

    def plane(k, i):
        return torch.from_numpy(np.asarray(clip[k][i], np.int32)).to(dev)

    def luma(k):
        return torch.nn.functional.pad(plane(k, 0)[None].float(),
                                       (0, 0, 0, ph - HEIGHT),
                                       mode="replicate")[0].to(torch.int32)

    y = luma(4)
    lists = ((0, 8), (8, 16))
    refs = torch.stack([luma(k) for lst in lists for k in lst])
    ls = _lambda_sqrt(QP + 2)
    # K9 over the four state references, K11's merge form over both lists
    st = _k9_check(torch, "1080p B frame, 4 state refs, SR 64", y, refs,
                   [16, 32])
    sp = me.subpel_from_state(st, ls)
    for n in (8, 16, 32):
        _merge_check(torch, "1080p B frame", st,
                     _merge_lists(torch, st, sp, n, [(0, 1), (2, 3)]), n, ls)
    for n in (8, 16, 32):
        args = _bi_args(torch, st, sp, n, ls)
        _bi_select_check(torch, "1080p B frame", args, timed, work)
        if n == 8:
            # the superseded bi_cost, on the same lists' winners
            cargs = args[:8] + args[12:]
            (pk, ck), (pp, cp) = (me.bi_cost(*cargs),
                                  me.bi_cost(*cargs, plain=True))
            _same(torch, f"K12 pbi n={n}", pk, pp)
            _same(torch, f"K12 cbi bits n={n}", ck.view(torch.int32),
                  cp.view(torch.int32))
            ms = _median_ms(lambda: me.bi_cost(*cargs))
            plain_ms = _median_ms(lambda: me.bi_cost(*cargs, plain=True))
            b = ph * WIDTH // (n * n)
            w = _bi_cost_work(refs.shape[0], ph * WIDTH, b, n)
            b_ms, b_by = _bound(*w)
            print(f"kernel bi_cost n={n} (no route launches it): {ms:.4f} "
                  f"ms, plain twin {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by})")
            timed["bi_cost"], work["bi_cost"] = (ms, plain_ms), w

    # K11's bi-predicting planes on this frame's B decisions
    pk = search_b_maps(y[None], refs[None, :2], refs[None, 2:], [ls], 5, 3,
                       WIDTH, HEIGHT, SR, nref0=[2], nref1=[2])
    gh, gw = HEIGHT // 8, WIDTH // 8
    im = pk[:, :gh, :gw, 2].to(torch.int32)
    mv = pk[:, :gh, :gw, 3:7].to(torch.int32)
    rm = pk[:, :gh, :gw, 7:9].to(torch.int32)
    share = [float((im == d).float().mean().item()) for d in (1, 2, 3)]
    print(f"B search of the phase-2c frame: L0 {share[0]:.3f}, L1 "
          f"{share[1]:.3f}, BI {share[2]:.3f} of the granules")
    stacks = [tuple(torch.stack([plane(k, i) for k in lst])[None]
                    for i in range(3)) for lst in lists]

    def pred(form):
        if form == "earlier":
            return me.inter_pred_planes_by_comp(stacks[0], stacks[1], im, mv,
                                                ref_map=rm)
        return me.inter_pred_planes(stacks[0], stacks[1], im, mv,
                                    ref_map=rm, plain=form == "twin")

    fpx = HEIGHT * WIDTH
    # each granule filters its lists: two for BI, one otherwise
    lists_per_granule = float((1 + (im == 3).to(torch.int64)).sum().item())
    _planes_check(torch, "1080p B frame, 2 refs a list", pred,
                  ("inter_pred_fused_bi", "inter_pred_bi"),
                  (4 * (4 * 1.5 * fpx + 1.5 * fpx) + 4 * 7 * gh * gw,
                   lists_per_granule * (_interp_ops(8, 8)
                                        + 2 * _interp_ops(4, 4))),
                  timed, work)
    torch.cuda.synchronize()


def _bi_args(torch, st, sp, n: int, ls: float) -> tuple:
    """bi_select's arguments as search_b_frame gives them, on an ME state
    of the references l0a l0b l1a l1b: each list's sub-pel winner of its
    two references, folded with the merge candidates (one mc_merge)."""
    from fasthevc_tpu_torch.ops import me
    (mv0, r0, p0, c0, b0), (mv1, r1, p1, c1, b1) = me.mc_merge(
        st, _merge_lists(torch, st, sp, n, [(0, 1), (2, 3)]), n, ls)
    return (st.y, st.refs, mv0, torch.where(r0 > 0, 1, 0), mv1,
            torch.where(r1 > 0, 3, 2), b0, b1, c0, c1, p0, p1, ls, n)


def _bi_parent(torch, me, args: tuple) -> tuple:
    """bi_select's function on the parent's path: bi_cost, then stack,
    argmin and the selects in PyTorch, as search_b_frame ran them."""
    pbi, cbi = me.bi_cost(*args[:8], *args[12:])
    dchoice = torch.argmin(torch.stack([args[8], args[9], cbi]), dim=0)
    d3 = dchoice[:, None, None]
    return (torch.where(d3 == 0, args[10],
                        torch.where(d3 == 1, args[11], pbi)),
            torch.where(dchoice == 0, args[6],
                        torch.where(dchoice == 1, args[7],
                                    args[6] + args[7])), dchoice)


def _shortlist_parent(torch, intra, top, left, lg: int, src, d, bits, ls):
    """The intra search's RD shortlist on the parent's path (3 candidates):
    the RMD cost in PyTorch, a stable sort, K1's selected form, the
    subtract and the bits' gather."""
    n, b = 1 << lg, src.shape[0]
    cost_rmd = d.to(torch.float32) + ls * bits
    take = torch.sort(cost_rmd, dim=1, stable=True).indices[:, :3]
    cands = intra.predict(top, left, lg, take)
    return (take, torch.take_along_dim(bits, take, dim=1),
            (src[:, None] - cands).reshape(b * 3, n, n))


def _bi_cost_work(rr: int, hw: int, b: int, n: int) -> tuple:
    """(bytes, operations) of K12's BI candidate on b n-blocks: the
    reference planes and the source read once (the blocks' windows
    overlap), each block's MVs, refs and rates in, pbi and cbi out; two
    lists' separable filters, the average (4 operations a sample) and the
    8x8 Hadamard (6 butterfly operations a sample, the difference and the
    absolute sum)."""
    return (4 * (rr * hw + hw + b * (8 + n * n + 1)),
            b * (2 * _interp_ops(n, 8) + n * n * (4 + 8)))


def _bi_select_check(torch, label: str, args: tuple, timed=None,
                     work=None) -> None:
    """K12's selected form against its twin, bit for bit, and against the
    parent's path (bi_cost, then stack, argmin and the selects in
    PyTorch); each timed with events and alone, beside the bound: bi_cost's
    bytes without pbi, plus c0 and c1, the p0 / p1 samples of the blocks
    where a list wins (this run's choices), and pred_sel, rate_sel and
    dchoice."""
    from fasthevc_tpu_torch.ops import me

    y, refs, n = args[0], args[1], args[-1]

    def new():
        return me.bi_select(*args)

    def parent():
        return _bi_parent(torch, me, args)

    got = new()
    want = me.bi_select_plain(*args)
    old = parent()
    for i, (a, w, o) in enumerate(zip(got, want, old)):
        o = o.to(a.dtype)
        if a.dtype == torch.float32:
            a, w, o = (t.view(torch.int32) for t in (a, w, o))
        _same(torch, f"bi_select n={n} output {i}", a, w)
        _same(torch, f"bi_select against the parent's path n={n} output {i}",
              a, o)
    share = [float((got[2] == d).float().mean().item()) for d in (0, 1, 2)]
    ms, dev = _median_ms(new), _device_ms(new)
    p_ms, p_dev = _median_ms(parent), _device_ms(parent)
    hw, b = y.numel(), got[2].numel()
    cb_bytes, ops = _bi_cost_work(refs.shape[0], hw, b, n)
    listwins = float((got[2] < 2).sum().item())
    w = (cb_bytes - 4 * b * n * n + 4 * b * (2 + n * n + 2)
         + 4 * listwins * n * n, ops)
    b_ms, b_by = _bound(*w)
    c_ms, c_by = _bound(cb_bytes, ops)
    print(f"kernel bi_select n={n} ({label}, {b} blocks; L0 / L1 / BI "
          f"{share[0]:.3f} / {share[1]:.3f} / {share[2]:.3f}): {ms:.4f} ms, "
          f"alone {_ms_text(dev)}; the parent's path (bi_cost, stack, "
          f"argmin, where) {p_ms:.4f} ms, alone {_ms_text(p_dev)}; bound "
          f"{b_ms:.4f} ms ({b_by}), {_share_text(b_ms, dev)} of the kernel "
          f"alone (bi_cost's own count: {c_ms:.4f} ms, {c_by})")
    if timed is not None and n == 8:
        timed["bi_select"] = (ms, _median_ms(
            lambda: me.bi_select_plain(*args)))
        work["bi_select"] = w


def _b64_inputs(torch):
    """Phase 2e's B frame (POC 4 of phase 10's clip) and its references (0,
    8 and 8, 16) padded to the CTU-64 grid, int32 on the card, its
    lambda_sqrt and its ME state at SR 64 with the 64 tier: (y, refs, ls,
    state)."""
    from fasthevc_tpu_torch.ops import me

    dev = torch.device("cuda")
    clip = _ra_clip()
    ph = -(-HEIGHT // 64) * 64

    def luma(k):
        p = torch.from_numpy(np.asarray(clip[k][0], np.int32)).to(dev)
        return torch.nn.functional.pad(p[None].float(),
                                       (0, 0, 0, ph - HEIGHT),
                                       mode="replicate")[0].to(torch.int32)

    y = luma(4)
    refs = torch.stack([luma(k) for k in (0, 8, 8, 16)])
    return y, refs, _lambda_sqrt(QP + 2), me.me_state(y, refs, SR,
                                                        max_size=64)


def phase_ctu64_kernels(torch) -> None:
    """Phase 2e: the forms the CTU-64 classic route adds, on phase 2c's B
    frame and references padded to the CTU-64 grid, SR 64: K9's fused form
    with its tier 64 (and the earlier form's tier-64 searches), K10 on
    the 64-blocks, K2 on the 64-blocks (the earlier merge candidates'
    SATD), K11's merge form and K12's selected form on the 64-blocks, each
    against its twin, exactly (K10's and K11's f32 costs and K12's rates
    bit for bit), with its time, twin time and bound."""
    from fasthevc_tpu_torch.codec.search import _blocks
    from fasthevc_tpu_torch.ops import cost, me

    y, refs, ls, st = _b64_inputs(torch)
    ph, n = y.shape[0], 64
    # K9's earlier form's two tier-64 calls of me_state: the coarse search
    # on the 1/4 planes, the +-3 refinement around its bases; then the
    # fused form, tier 64 included, against its twins and the earlier five
    # calls
    ds = me.downsample4(torch.cat([y[None], refs]))
    sr4 = -(-SR // 4)
    for name, args in (
            ("K9 tier-64 bases", (ds[0], ds[1:], None, n // 4, sr4, n // 4,
                                  4, SR)),
            ("K9 tier-64 MVs", (y, refs, st.base[n], n, 3, n, 1, SR))):
        _same(torch, name, me.sad_search(*args),
              me.sad_search(*args, plain=True))
    _k9_check(torch, "CTU 64, 1088x1920 B frame, 4 state refs", y, refs,
              [16, 32, 64])
    hw, rr, b = ph * WIDTH, refs.shape[0], ph * WIDTH // (n * n)
    rows = []

    def check(name, fn, plain_fn, w):
        got, want = fn(), plain_fn()
        for i, (a, c) in enumerate(zip(got, want)):
            if a.dtype == torch.float32:
                a, c = a.view(torch.int32), c.view(torch.int32)
            _same(torch, f"{name} n=64 output {i}", a, c)
        ms, plain_ms = _median_ms(fn), _median_ms(plain_fn, reps=1)
        rows.append((name, ms, plain_ms, w))
        return got

    sargs = (st.y, st.refs, st.mv_int[n], n, ls)
    sp = check("subpel", lambda: me.subpel(*sargs),
               lambda: me.subpel(*sargs, plain=True),
               (4 * (hw * (1 + rr) + rr * b * (3 + n * n)),
                _subpel_ops(n, rr * b)))
    src = _blocks(y[None], n).contiguous()
    pred = sp[2][0][:, None].contiguous()
    check("satd", lambda: (cost.satd(src, pred),),
          lambda: (cost.satd_plain(src, pred),),
          (4 * (2 * b * n * n + b), 9 * b * n * n))
    _merge_check(torch, "CTU 64, 1088x1920 B frame", st,
                 _merge_lists(torch, st, {n: sp}, n, [(0, 1), (2, 3)]), n,
                 ls)
    _bi_select_check(torch, "CTU 64, 1088x1920 B frame",
                     _bi_args(torch, st, {n: sp}, n, ls))
    for name, ms, plain_ms, w in rows:
        if name == "subpel":
            text = _subpel_bound_text(n, rr * b, w, ms)
        else:
            b_ms, b_by = _bound(*w)
            text = (f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% "
                    f"of the bound")
        print(f"kernel {name} n=64 (CTU 64, 1088x1920): {ms:.4f} ms, plain "
              f"twin {plain_ms:.4f} ms, {text}")


def _cnn_macs(ctu: int, d: int) -> tuple:
    """(forward, backward) f32 multiply-adds of the partition CNN on one
    CTU: the five layers' products; the backward takes every weight
    gradient (as many products as the forward) and the input gradients of
    Conv_4 to Conv_1 (Conv_3's over its 64 activation channels; Conv_0's
    input needs none)."""
    h2, h4, g = ctu // 2, ctu // 4, ctu // 8
    layers = (h2 * h2 * 16 * 9, h4 * h4 * 32 * 16 * 9, g * g * 64 * 32 * 9,
              g * g * 64 * 65 * 9, g * g * 64 * d)
    fwd = sum(layers)
    return fwd, 2 * fwd + g * g * 64 * 64 * 9 - layers[3] - layers[0]


def _cnn_frames(torch, lg: int, frames: int):
    """Phase 3's first frames, luma edge-padded to the CTU grid: uint8
    [F, PH, 1920] on the card."""
    from fasthevc_tpu_torch.utils.video import pad_plane
    ph = -(-HEIGHT // (1 << lg)) * (1 << lg)
    return torch.from_numpy(np.stack([
        pad_plane(np.asarray(f[0], np.int32), ph, WIDTH).astype(np.uint8)
        for f in _ai_clip()[:frames]])).to("cuda")


def _seeded_cnn(torch, lg: int):
    """A partition CNN of random weights made from a seed, on the card."""
    from fasthevc_tpu_torch.models import init_params
    return init_params(torch.Generator().manual_seed(lg), lg, "cuda")


def phase_cnn_kernels(torch, errs, timed, work, lib_ms):
    """Phase 2d: K13 at 1080p (a group of 8 at CTU 32, one frame at CTU
    64), K13's training mode, K14 and K15 on a training batch of 64
    CTUs, against their twins; the library calls are the conv2d chain
    (cuDNN, TF32 off), its backward and torch.optim.Adam."""
    from fasthevc_tpu_torch.ops import cnn

    for lg, frames in ((5, GROUP), (6, 1)):
        ctu, d = 1 << lg, lg - 2
        y = _cnn_frames(torch, lg, frames)
        theta = _seeded_cnn(torch, lg).flat_params()
        layers = cnn.unflatten(theta, d)
        got = cnn.cnn_depth(y, theta, QP, lg)
        want = cnn.cnn_depth(y, theta, QP, lg, plain=True)
        x = cnn.ctu_batch(y, ctu)
        q = torch.full((x.shape[0],), float(QP), device="cuda")
        lk, _ = cnn.cnn_train_forward(x[:, 0], q, theta)
        lp = cnn.logits_plain(x, q, layers)
        err = (lk - lp).abs().max().item()
        if err > CNN_TOL:
            raise AssertionError(f"K13 CTU {ctu}: logits differ from the "
                                 f"twin's by {err:.3g}")
        top2 = torch.topk(lp, 2, dim=-1).values
        sure = cnn._granule_map(top2[..., 0] - top2[..., 1] > 2 * CNN_TOL,
                                frames, y.shape[1], WIDTH, ctu)
        if not torch.equal(got[sure], want[sure]):
            raise AssertionError(f"K13 CTU {ctu}: depth differs from the "
                                 f"twin's beyond the margin")
        near = int((~sure).sum().item())
        flips = int((got != want)[~sure].sum().item())
        print(f"K13 CTU {ctu}: {flips} depth flip(s) against the twin in the "
              f"{near} granule(s) within 2 CNN_TOL of a tie "
              f"({got.numel()} granules)")
        tile = cnn.cnn_tile(x.shape[0], lg, cnn._sm_count(y))
        alts = {t: _with_k13_tile(cnn, t, lambda: _median_ms(
            lambda: cnn.cnn_depth(y, theta, QP, lg)))
            for t in cnn.CNN_TILES[lg]}
        print(f"K13 CTU {ctu}, {x.shape[0]} CTUs: the wrapper's T {tile}; "
              f"ms by T: "
              + ", ".join(f"{t} {v:.4f}" for t, v in alts.items()))
        ms = _median_ms(lambda: cnn.cnn_depth(y, theta, QP, lg))
        plain_ms = _median_ms(lambda: cnn.cnn_depth(y, theta, QP, lg,
                                                    plain=True))
        library = _median_ms(lambda: cnn.logits_plain(x, q, layers))
        # luma in and the weights read once, the int16 map written; f32
        # multiply-adds as two operations
        w = (y.numel() + 4 * theta.numel() + 2 * (y.numel() // 64),
             2 * x.shape[0] * _cnn_macs(ctu, d)[0], PEAK_F32_FLOPS_S)
        b_ms, b_by = _bound(*w)
        hist = torch.bincount(got.flatten().long(), minlength=d).tolist()
        print(f"kernel cnn_depth CTU {ctu}, {frames} 1080p frame(s) "
              f"({x.shape[0]} CTUs): {ms:.4f} ms, plain twin {plain_ms:.4f} "
              f"ms, conv2d chain {library:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); logits max err {err:.3g}, "
              f"{sure.float().mean().item():.5f} of the granules beyond "
              f"2 CNN_TOL, depth histogram {hist}")
        if lg == 5:
            timed["cnn_depth"], work["cnn_depth"] = (ms, plain_ms), w
            lib_ms["cnn_depth"], errs["cnn_depth"] = library, err

    # one training batch of CTU 32, as train_self_distilled draws it
    rng = np.random.default_rng(12)
    p_ = cnn.n_params(3)
    x = cnn.ctu_batch(_cnn_frames(torch, 5, 1), 32)[:CNN_BATCH, 0]
    x = x.contiguous()
    nb = x.shape[0]
    q = torch.from_numpy(rng.choice([27.0, 37.0], nb)
                         .astype(np.float32)).to("cuda")
    t = torch.from_numpy(rng.integers(0, 3, (nb, 4, 4))
                         .astype(np.int32)).to("cuda")
    theta = _seeded_cnn(torch, 5).flat_params()
    layers = cnn.unflatten(theta, 3)
    lk, acts = cnn.cnn_train_forward(x, q, theta)
    lp = cnn.logits_plain(x[:, None], q, layers)
    errs["cnn_train"] = (lk - lp).abs().max().item()
    if errs["cnn_train"] > CNN_TOL:
        raise AssertionError("K13's training mode: logits differ from the "
                             "twin's")
    timed["cnn_train"] = (
        _median_ms(lambda: cnn.cnn_train_forward(x, q, theta)),
        _median_ms(lambda: cnn.logits_plain(x[:, None], q, layers)))
    lib_ms["cnn_train"] = timed["cnn_train"][1]
    alts = {t: _with_k13_tile(cnn, t, lambda: _median_ms(
        lambda: cnn.cnn_train_forward(x, q, theta)))
        for t in cnn.CNN_TILES[5]}
    print(f"K13 training mode, {nb} CTUs of 32: the wrapper's T "
          f"{cnn.cnn_tile(nb, 5, cnn._sm_count(x))}; ms by T: "
          + ", ".join(f"{t} {v:.4f}" for t, v in alts.items()))
    fwd, bwd = _cnn_macs(32, 3)
    work["cnn_train"] = (4 * (x.numel() + nb + p_ + lk.numel()
                              + acts.numel()),
                         2 * nb * fwd, PEAK_F32_FLOPS_S)

    gk = cnn.cnn_backward(x, q, t, theta, acts, lk)
    _same(torch, "K14 run to run", cnn.cnn_backward(x, q, t, theta, acts, lk),
          gk)
    th = theta.clone().requires_grad_(True)
    loss_p, logits_p = cnn.cnn_loss_plain(th, x, q, t)
    gp, = torch.autograd.grad(loss_p, th, retain_graph=True)
    for (wk, bk), (wp, bp) in zip(cnn.unflatten(gk, 3),
                                  cnn.unflatten(gp, 3)):
        for a, b in ((wk, wp), (bk, bp)):
            if (a - b).abs().max().item() > 1e-4 * b.abs().max().item():
                raise AssertionError("K14: a gradient differs from "
                                     "autograd's")
    errs["cnn_backward"] = (gk - gp).abs().max().item()
    th_lib = theta.clone().requires_grad_(True)
    ce = torch.nn.functional.cross_entropy(
        cnn.logits_plain(x[:, None], q, cnn.unflatten(th_lib, 3))
        .permute(0, 3, 1, 2), t.long())
    # K14 against autograd through the chain in turns: single medians of
    # the two swung 2x between calls
    k14, chain = _interleaved_ms(
        lambda: cnn.cnn_backward(x, q, t, theta, acts, lk),
        lambda: torch.autograd.grad(ce, th_lib, retain_graph=True))
    qa, qb = np.percentile(k14, [25, 50, 75]), np.percentile(chain,
                                                             [25, 50, 75])
    verdict = ("K14 is faster" if qa[2] < qb[0] else "K14 is slower"
               if qa[0] > qb[2] else "their interquartile ranges overlap")
    _, grid, stages = cnn.cnn_backward_plan(nb, 5)
    work["cnn_backward"] = (4 * (x.numel() + nb + t.numel() + p_
                                 + acts.numel() + lk.numel() + p_),
                            2 * nb * bwd, PEAK_F32_FLOPS_S)
    b_ms = _bound(*work["cnn_backward"])[0]
    print(f"K14 against autograd through the conv2d chain (cuDNN TF32 "
          f"{torch.backends.cudnn.allow_tf32}), {K14_PAIRS} pairs in turns "
          f"after a warm-up: K14 median {qa[1]:.4f} ms (IQR {qa[0]:.4f}-"
          f"{qa[2]:.4f}), autograd median {qb[1]:.4f} ms (IQR {qb[0]:.4f}-"
          f"{qb[2]:.4f}): {verdict}; K14's grid {grid} CTAs of 256 "
          f"threads, {stages} stages (one launch), "
          f"{100 * b_ms / qa[1]:.2f}% of its bound {b_ms:.4f} ms; two calls "
          f"bit for bit equal")
    timed["cnn_backward"] = (
        float(qa[1]), _median_ms(lambda: torch.autograd.grad(
            loss_p, th, retain_graph=True)))
    lib_ms["cnn_backward"] = float(qb[1])

    bufs = [theta.clone(), torch.zeros_like(theta), torch.zeros_like(theta)]
    twin = [b.clone() for b in bufs]
    for step in (1, 2):
        cnn.adam_update(bufs[0], gk, bufs[1], bufs[2], step, 3e-3)
        cnn.adam_update(twin[0], gk, twin[1], twin[2], step, 3e-3,
                        plain=True)
        for a, b in zip(bufs, twin):
            _same(torch, "K15", a, b)
    errs["adam"] = 0.0
    timed["adam"] = (
        _median_ms(lambda: cnn.adam_update(bufs[0], gk, bufs[1], bufs[2], 3,
                                           3e-3)),
        _median_ms(lambda: cnn.adam_update(twin[0], gk, twin[1], twin[2], 3,
                                           3e-3, plain=True)))
    param = torch.nn.Parameter(theta.clone())
    param.grad = gk.clone()
    opt = torch.optim.Adam([param], lr=3e-3, betas=(0.9, 0.999), eps=1e-8,
                           fused=True)
    lib_ms["adam"] = _median_ms(opt.step)
    # theta, the gradient and both moments read, theta and the moments
    # written; about 12 f32 operations an element
    work["adam"] = (4 * 7 * p_, 12 * p_, PEAK_F32_FLOPS_S)
    for name in TRAIN_KERNELS:
        b_ms, b_by = _bound(*work[name])
        print(f"kernel {name} ({nb} CTUs of 32): "
              f"{timed[name][0]:.4f} ms, plain twin {timed[name][1]:.4f} ms, "
              f"library {lib_ms[name]:.4f} ms, bound {b_ms:.4f} ms ({b_by}),"
              f" max abs err {errs[name]:.3g}")
    torch.cuda.synchronize()


def _encode(torch, cfg, clip, device="cuda", plain=False, params=None):
    from fasthevc_tpu_torch.codec.encoder import TorchEncoder
    enc = TorchEncoder(cfg, device, plain=plain, partition_params=params)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream, recons = enc.encode(clip)
    return stream, recons, time.perf_counter() - t0, enc


def _require(launches: dict, names, what: str) -> None:
    """Every kernel of `names` launched in `launches`, and none of
    UNLAUNCHED."""
    for name in names:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"{what}")
    for name in UNLAUNCHED:
        if launches.get(name, 0):
            raise AssertionError(f"kernel {name} was launched by the {what}"
                                 f", which should run the form that "
                                 f"superseded it")


def _per_picture(launches: dict, pictures: int, sizes: int, what: str,
                 intra_rd: int, b_pictures: int = 0, batches: int = 0,
                 p_batches: int = 0, b_batches: int = 0) -> None:
    """K9 at three launches an inter picture (the decimation, me_coarse,
    me_fine), K11's merge form at one a block size (SR 64), K12's selected
    form at one a B picture and block size, K1's rd form `intra_rd` times,
    K7's fused form at one launch a picture batch (`batches`) and K11's
    planes form at one a P batch and one a B batch."""
    want = {"me_downsample4": pictures, "me_coarse": pictures,
            "me_fine": pictures, "mc_merge": pictures * sizes,
            "bi_select": b_pictures * sizes, "intra_rd_cands": intra_rd,
            "sao_fused": batches, "inter_pred_fused": p_batches,
            "inter_pred_fused_bi": b_batches}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{what}: K1 / K7 / K9 / K11 / K12 launches "
                             f"{got}, expected {want} for {pictures} inter "
                             f"pictures")


def _ai_clip():
    from fasthevc_tpu_torch.utils import synthesize_yuv
    return synthesize_yuv(WIDTH, HEIGHT, GROUP + TIMED, seed=1)


def _ai_cfg(frames: int, log2_ctu: int = 5):
    """bench.py's 1080p all-intra tools: default tools, auto tiles, the
    checksum hash."""
    from fasthevc_tpu_torch.config import EncoderConfig
    from fasthevc_tpu_torch.config.config import auto_tile_grid
    tc, tr = auto_tile_grid(WIDTH, HEIGHT)
    return EncoderConfig(width=WIDTH, height=HEIGHT, qp=QP, frames=frames,
                         tile_cols=tc, tile_rows=tr, hash_type=2,
                         log2_ctu=log2_ctu)


def _fast(cfg, params):
    """cfg with fast_partition when the CNN's parameters are given."""
    return cfg if params is None else cfg.replace(fast_partition=True)


def _label(params) -> str:
    return "full search" if params is None else "fast partition"


def _stats(fps: float, stream: bytes, frames: int, psnrs) -> dict:
    return {"fps": fps, "kbit": len(stream) * 8 / frames / 1000,
            "psnr": float(np.mean(psnrs))}


def phase_device_route(torch, params=None):
    """Phase 3 (phase 13 with the CNN's parameters); returns (launches,
    stats)."""
    from fasthevc_tpu_torch import _build
    from fasthevc_tpu_torch.codec.encoder import TorchEncoder
    from fasthevc_tpu_torch.utils import psnr, yuv_from_planes

    clip = _ai_clip()
    warm, timed_clip = clip[:GROUP], clip[GROUP:]
    cfg = _fast(_ai_cfg(TIMED), params)
    tc, tr = cfg.tile_cols, cfg.tile_rows
    enc = TorchEncoder(cfg, "cuda", partition_params=params)
    enc.encode(warm)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    stream, recons = enc.encode(timed_clip)
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    ps = []
    for f, r in zip(timed_clip, recons):
        ry, _, _ = yuv_from_planes((r.y, r.cb, r.cr), WIDTH, HEIGHT)
        ps.append(psnr(f[0], ry))
    tm = enc.timing
    st = _stats(TIMED / dt, stream, TIMED, ps)
    print(f"device route ({_label(params)}), 1080p QP32 all-intra, {TIMED} "
          f"frames, tiles {tc}x{tr}: {st['fps']:.4f} fps, "
          f"{st['kbit']:.2f} kbit/frame, Y-PSNR {st['psnr']:.3f} dB; wall "
          f"{dt:.3f} s; group programs on the card {tm['device_s']:.4f} s "
          f"(host blocked on them {tm['wait_s']:.4f} s); host CABAC "
          f"{tm['entropy_s']:.3f} thread-s over the pool")
    print(f"launches in the timed device-route encode: {launches}")
    _require(launches, INTRA_ROUTE + (() if params is None
                                      else ("cnn_depth",)),
             f"all-intra device-route encode ({_label(params)})")
    # K1's rd form RD_PER_GROUP times and K7's fused form once a group
    groups = TIMED // GROUP
    want = {"intra_rd_cands": RD_PER_GROUP * groups, "sao_fused": groups}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"all-intra encode: launches {got}, expected "
                             f"{want} ({RD_PER_GROUP} and 1 a group of "
                             f"{GROUP})")
    return launches, st


def _twin_route(torch, cfg, clip, what: str) -> str:
    """clip through the kernels and through the twins on the card:
    byte-identical streams, no kernel launched by the twins."""
    from fasthevc_tpu_torch import _build
    kernel_stream, _, _, _ = _encode(torch, cfg, clip)
    before = dict(_build.LAUNCHES)
    plain_stream, _, pdt, _ = _encode(torch, cfg, clip, plain=True)
    if dict(_build.LAUNCHES) != before:
        raise AssertionError(f"the {what} twin route launched a kernel")
    if plain_stream != kernel_stream:
        raise AssertionError(f"{what} kernel-route stream differs from the "
                             f"twin route's")
    return (f"{what} kernel route == twin route: {len(kernel_stream)} "
            f"bytes identical ({len(clip)} frames; twins {pdt:.1f} s)")


def _small_stream(torch, cfg, frames: int, device="cuda", plain=False,
                  keys=None) -> bytes:
    """A 416x240 clip of `frames` frames encoded with cfg (keys: timing
    keys the route must report)."""
    from fasthevc_tpu_torch.utils import synthesize_yuv

    clip = synthesize_yuv(416, 240, frames, seed=3)
    stream, _, _, enc = _encode(torch, cfg, clip, device=device, plain=plain)
    if keys is not None and not keys <= set(enc.timing):
        raise AssertionError(f"416x240 did not take the route with {keys}")
    return stream


def _decode_clean(stream: bytes, frames: int) -> bool:
    from fasthevc_tpu_torch.spec.decoder import SpecDecoder
    pics = SpecDecoder().decode(stream)
    return len(pics) == frames and all(p.hash_ok for p in pics)


def _small_cfgs():
    """The 416x240 checks: name -> (config, frames, route, timing keys)."""
    from fasthevc_tpu_torch.config import (EncoderConfig, low_delay_p,
                                           random_access_gop16)
    dev_keys = {"device_s", "entropy_s"}
    return {
        "device (CTU 32)": (EncoderConfig(width=416, height=240, qp=QP,
                                          frames=2), 2, dev_keys),
        "pipelined (CTU 64)": (EncoderConfig(width=416, height=240, qp=QP,
                                             frames=2, log2_ctu=6), 2,
                               {"search_s", "commit_s"}),
        "low-delay P": (low_delay_p(width=416, height=240, qp=QP, frames=4),
                        4, dev_keys),
        "random-access": (random_access_gop16(width=416, height=240, qp=QP,
                                              frames=RA_FRAMES), RA_FRAMES,
                          dev_keys),
    }


def job_small(torch, route: str, against: str) -> dict:
    """A 416x240 check: the clip on the card must give the stream of the
    twins on the CPU (against "cpu"; that stream must also decode
    hash-clean) or of the twins on the card ("card")."""
    import hashlib
    cfg, frames, keys = _small_cfgs()[route]
    stream = _small_stream(torch, cfg, frames, keys=keys)
    if against == "card":
        if _small_stream(torch, cfg, frames, plain=True) != stream:
            raise AssertionError(f"416x240 {route} route: kernel stream "
                                 f"differs from the card twins' stream")
        log = "equal to the card twins' stream"
    else:
        if _small_stream(torch, cfg, frames, device="cpu") != stream:
            raise AssertionError(f"416x240 {route} route: card stream "
                                 f"differs from the CPU twins' stream")
        if not _decode_clean(stream, frames):
            raise AssertionError(f"416x240 {route} route stream does not "
                                 f"decode hash-clean")
        log = f"equal to the CPU twins' stream, {frames} pictures hash_ok"
    return {"sha": hashlib.sha256(stream).hexdigest(),
            "log": f"416x240 {route} route: {len(stream)} bytes, {log}"}


def phase_pipelined_route(torch, device_fps: float):
    from fasthevc_tpu_torch import _build
    from fasthevc_tpu_torch.utils import synthesize_yuv

    clip = synthesize_yuv(WIDTH, HEIGHT, 2 * GROUP, seed=1)
    cfg = _ai_cfg(GROUP, log2_ctu=6)
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
    _require(launches, SEARCH_KERNELS, "pipelined encode")


def _ldp_clip():
    from fasthevc_tpu_torch.utils import synthesize_yuv
    return synthesize_yuv(WIDTH, HEIGHT, 1 + LDP_TIMED_P, seed=5)


def _ldp_cfg(frames: int):
    """low_delay_p at 1080p QP32 with phase 3's hash type (the checksum
    from the card)."""
    from fasthevc_tpu_torch.config import low_delay_p
    return low_delay_p(width=WIDTH, height=HEIGHT, qp=QP, frames=frames,
                       hash_type=2)


def phase_ldp_route(torch, params=None):
    """Phase 7 (phase 13 with the CNN's parameters); returns (the launches
    of the timed encode, stats)."""
    from fasthevc_tpu_torch import _build
    from fasthevc_tpu_torch.codec.encoder import TorchEncoder
    from fasthevc_tpu_torch.utils import psnr, yuv_from_planes

    clip = _ldp_clip()
    n = len(clip)
    enc = TorchEncoder(_fast(_ldp_cfg(n), params), "cuda",
                       partition_params=params)
    enc.encode(clip[:3])                   # warm-up: I + 2 P
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    stream, recons = enc.encode(clip)
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    tm = enc.timing
    ps = []
    for f, r in zip(clip, recons):
        ry, _, _ = yuv_from_planes((r.y, r.cb, r.cr), WIDTH, HEIGHT)
        ps.append(psnr(f[0], ry))
    batches = enc.spans
    st = _stats(n / dt, stream, n, ps)
    print(f"low-delay P device route ({_label(params)}), 1080p QP32 SR "
          f"{SR}, 1 I + {LDP_TIMED_P} P frames: {st['fps']:.4f} fps, "
          f"{st['kbit']:.2f} kbit/frame, Y-PSNR "
          f"{st['psnr']:.3f} dB (I {ps[0]:.3f}, P mean "
          f"{np.mean(ps[1:]):.3f}); wall {dt:.3f} s; batches on the card "
          f"{tm['device_s']:.4f} s (I {batches[0]:.4f} s, P mean "
          f"{np.mean(batches[1:]):.4f} s), host blocked on them "
          f"{tm['wait_s']:.4f} s; host CABAC {tm['entropy_s']:.3f} "
          f"thread-s")
    print(f"launches in the timed low-delay P encode: {launches}")
    _require(launches, LDP_ROUTE + (() if params is None
                                    else ("cnn_depth",)),
             f"low-delay P encode ({_label(params)})")
    # the P searches' luma shortlists, three sizes a picture, and the I
    # picture's all-intra batch
    _per_picture(launches, n - 1, 3,
                 f"low-delay P encode ({_label(params)})",
                 3 * (n - 1) + RD_PER_GROUP, batches=n, p_batches=n - 1)
    return launches, st


def phase_ra_route(torch, params=None):
    """Phase 10 (phase 13 with the CNN's parameters); returns (the launches
    of the timed encode, stats)."""
    from fasthevc_tpu_torch import _build
    from fasthevc_tpu_torch.codec.encoder import TorchEncoder
    from fasthevc_tpu_torch.utils import psnr, yuv_from_planes

    clip = _ra_clip()
    enc = TorchEncoder(_fast(_ra_cfg(RA_FRAMES), params), "cuda",
                       partition_params=params)
    enc.encode(clip)                       # warm-up: the same 17 frames
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    stream, recons = enc.encode(clip)
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    tm = enc.timing
    ps = []
    for f, r in zip(clip, recons):
        ry, _, _ = yuv_from_planes((r.y, r.cb, r.cr), WIDTH, HEIGHT)
        ps.append(psnr(f[0], ry))
    spans = ", ".join(f"{v:.4f}" for v in enc.spans)
    st = _stats(RA_FRAMES / dt, stream, RA_FRAMES, ps)
    print(f"random-access device route ({_label(params)}), 1080p QP32 SR "
          f"{SR}, 1 I + {RA_FRAMES - 1} B frames: {st['fps']:.4f} fps, "
          f"{st['kbit']:.2f} kbit/frame, Y-PSNR "
          f"{st['psnr']:.3f} dB (I {ps[0]:.3f}, B mean "
          f"{np.mean(ps[1:]):.3f}); wall {dt:.3f} s; {len(enc.spans)} "
          f"batches on the card {tm['device_s']:.4f} s (spans {spans} s), "
          f"host blocked on them {tm['wait_s']:.4f} s; host CABAC "
          f"{tm['entropy_s']:.3f} thread-s")
    print(f"launches in the timed random-access encode: {launches}")
    _require(launches, RA_ROUTE + (() if params is None
                                   else ("cnn_depth",)),
             f"random-access encode ({_label(params)})")
    if len(enc.spans) != RA_BATCHES:
        raise AssertionError(f"random-access encode: {len(enc.spans)} "
                             f"batches, expected {RA_BATCHES}")
    _per_picture(launches, RA_FRAMES - 1, 3,
                 f"random-access encode ({_label(params)})",
                 3 * (RA_FRAMES - 1) + RD_PER_GROUP, RA_FRAMES - 1,
                 batches=RA_BATCHES, b_batches=RA_BATCHES - 1)
    return launches, st


def _classic_cfg(frames: int):
    """Phase 7's low_delay_p at CTU 64: the classic per-frame route."""
    return _ldp_cfg(frames).replace(log2_ctu=6)


def phase_classic_route(torch):
    """Phase 14: 1 I + CLASSIC_TIMED_P P frames of phase 7's clip at CTU 64
    on the classic per-frame route, after a warm-up; returns (the launches
    of the timed encode, stats)."""
    from fasthevc_tpu_torch import _build
    from fasthevc_tpu_torch.codec.encoder import TorchEncoder
    from fasthevc_tpu_torch.utils import psnr, yuv_from_planes

    clip = _ldp_clip()[:1 + CLASSIC_TIMED_P]
    n = len(clip)
    enc = TorchEncoder(_classic_cfg(n), "cuda")
    enc.encode(clip[:2])                   # warm-up: I + P
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    stream, recons = enc.encode(clip)
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    tm = enc.timing
    if set(tm) != {"search_s", "commit_s", "wall_s"}:
        raise AssertionError(f"phase 14 did not take the classic route: {tm}")
    ps = []
    for f, r in zip(clip, recons):
        ry, _, _ = yuv_from_planes((r.y, r.cb, r.cr), WIDTH, HEIGHT)
        ps.append(psnr(f[0], ry))
    st = _stats(n / dt, stream, n, ps)
    spans = ", ".join(f"{v:.4f}" for v in enc.spans)
    print(f"classic per-frame route, 1080p QP32 CTU 64 SR {SR}, 1 I + "
          f"{CLASSIC_TIMED_P} P frames: {st['fps']:.4f} fps, "
          f"{st['kbit']:.2f} kbit/frame, Y-PSNR {st['psnr']:.3f} dB (I "
          f"{ps[0]:.3f}, P mean {np.mean(ps[1:]):.3f}); wall {dt:.3f} s; "
          f"searches on the card {tm['search_s']:.4f} s (spans {spans} s), "
          f"host C++ commit {tm['commit_s']:.4f} s")
    print(f"launches in the timed classic-route encode: {launches}")
    _require(launches, CLASSIC_ROUTE, "classic-route encode")
    # four luma sizes a P picture; the I picture's search adds the chroma
    # DM residuals of both planes at 8, 16 and 32; the host commits,
    # filters and compensates (no K7, no K11 planes)
    _per_picture(launches, n - 1, 4, "classic-route encode",
                 4 * (n - 1) + 4 + 6)
    return launches, st


def phase_rate_control(torch, full: dict) -> None:
    """Phase 15: the all-intra device route on phase 3's 16 timed frames
    and the low-delay P device route on phase 7's 9 frames, each with
    target_bitrate at RC_SHARE of the rate its fixed-QP phase realized
    (frame_rate 30), after a warm-up; prints the realized rate beside the
    target and the fps beside the fixed-QP phase's, and requires each
    route's kernels."""
    from fasthevc_tpu_torch import _build
    from fasthevc_tpu_torch.codec.encoder import TorchEncoder

    for name, clip, cfg_of, warm, kernels in (
            ("all-intra", _ai_clip()[GROUP:], _ai_cfg, 2, INTRA_ROUTE),
            ("low-delay P", _ldp_clip(), _ldp_cfg, 3, LDP_ROUTE)):
        n = len(clip)
        cfg = cfg_of(n)
        target = int(RC_SHARE * full[name]["kbit"] * 1000 * cfg.frame_rate)
        enc = TorchEncoder(cfg.replace(target_bitrate=target), "cuda")
        enc.encode(clip[:warm])
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        stream, _ = enc.encode(clip)
        dt = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        realized = len(stream) * 8 * cfg.frame_rate / n
        print(f"rate control, {name} device route, 1080p, {n} frames: "
              f"target {target} bit/s, realized {realized:.0f} bit/s "
              f"({realized / target:.4f} of the target); {n / dt:.4f} fps "
              f"(fixed QP32: {full[name]['fps']:.4f} fps, "
              f"{full[name]['kbit'] * 1000 * cfg.frame_rate:.0f} bit/s); "
              f"batches on the card {enc.timing['device_s']:.4f} s")
        print(f"launches in the rate-controlled {name} encode: {launches}")
        _require(launches, kernels, f"rate-controlled {name} encode")


def _fade_clip(frames: int):
    """A global luminance fade at 416x240 (tests/test_weighted_pred.py's):
    frame t is the first frame of synthesize_yuv, luma times (1 - t/4)
    plus 10 t, chroma's distance from 128 times (1 - t/4)."""
    from fasthevc_tpu_torch.utils import synthesize_yuv
    y0, cb0, cr0 = (p.astype(np.float64) for p in
                    synthesize_yuv(416, 240, 1, seed=3, motion=False)[0])
    out = []
    for t in range(frames):
        gain = 1.0 - 0.25 * t
        out.append((np.clip(y0 * gain + 10 * t, 0, 255).astype(np.uint8),
                    np.clip((cb0 - 128) * gain + 128, 0, 255)
                    .astype(np.uint8),
                    np.clip((cr0 - 128) * gain + 128, 0, 255)
                    .astype(np.uint8)))
    return out


def _classic_small(torch, name: str):
    """The 416x240 streams of the classic_small jobs: (config, clip, CNN
    parameters, FASTHEVC_FORCE_CLASSIC, kernels the card must launch)."""
    from fasthevc_tpu_torch.config import (EncoderConfig, low_delay_p,
                                           quality, random_access_gop16)
    from fasthevc_tpu_torch.models import params_to_flax
    from fasthevc_tpu_torch.utils import synthesize_yuv

    w, h = 416, 240

    def clip(n):
        return synthesize_yuv(w, h, n, seed=3)

    if name == "RA GOP-16 at CTU 64":
        return (random_access_gop16(width=w, height=h, qp=QP,
                                    frames=RA_FRAMES, log2_ctu=6),
                clip(RA_FRAMES), None, False, CLASSIC_ROUTE + ("bi_select",))
    if name == "fast-partition LDP at CTU 64":
        return (low_delay_p(width=w, height=h, qp=QP, frames=4, log2_ctu=6,
                            fast_partition=True), clip(4),
                params_to_flax(_seeded_cnn(torch, 6).cpu()), False,
                CLASSIC_ROUTE + ("cnn_depth",))
    if name == "weighted prediction on a fade":
        return (low_delay_p(width=w, height=h, qp=QP, frames=3,
                            weighted_pred=True), _fade_clip(3), None, False,
                CLASSIC_ROUTE)
    if name == "lossless LDP":
        return (low_delay_p(width=w, height=h, qp=QP, frames=2,
                            lossless=True), clip(2), None, False,
                CLASSIC_ROUTE)
    if name == "quality() two-pass search":
        return (quality(EncoderConfig(width=w, height=h, qp=QP, frames=1)),
                clip(1), None, True, SEARCH_KERNELS)
    # the device routes with the main path's checksum hash (K8)
    if name == "HRD on the RA device route":
        return (random_access_gop16(width=w, height=h, qp=QP,
                                    frames=RA_FRAMES, hrd=True, hash_type=2),
                clip(RA_FRAMES), None, False, RA_ROUTE)
    assert name == "rate-controlled all-intra device route"
    return (EncoderConfig(width=w, height=h, qp=QP, frames=4, hash_type=2,
                          target_bitrate=1_000_000), clip(4), None, False,
            INTRA_ROUTE)


def job_classic_small(torch, names) -> dict:
    """416x240 streams of this slice's paths through the kernels on the
    card (each of its kernels launched), through the twins on the card
    (none launched) and through the twins on the CPU: identical streams
    that decode hash-clean in SpecDecoder."""
    from fasthevc_tpu_torch import _build

    logs = []
    for name in names:
        cfg, clip, params, force, kernels = _classic_small(torch, name)
        if force:
            os.environ["FASTHEVC_FORCE_CLASSIC"] = "1"
        try:
            _build.LAUNCHES.clear()
            stream = _encode(torch, cfg, clip, params=params)[0]
            _require(_build.LAUNCHES, kernels, f"416x240 {name} encode")
            before = dict(_build.LAUNCHES)
            twins = _encode(torch, cfg, clip, plain=True, params=params)[0]
            if dict(_build.LAUNCHES) != before:
                raise AssertionError(f"416x240 {name}: the twins launched "
                                     f"a kernel")
            cpu = _encode(torch, cfg, clip, device="cpu", params=params)[0]
        finally:
            os.environ.pop("FASTHEVC_FORCE_CLASSIC", None)
        if twins != stream or cpu != stream:
            raise AssertionError(f"416x240 {name}: the card's stream differs "
                                 f"from the card twins' or the CPU twins'")
        if not _decode_clean(stream, len(clip)):
            raise AssertionError(f"416x240 {name}: the stream does not "
                                 f"decode hash-clean")
        logs.append(f"{name}: {len(stream)} bytes, {len(clip)} pictures")
    return {"log": "416x240 " + "; ".join(logs) + " (each equal on the "
                   "card, the card twins and the CPU twins, hash_ok)"}


def params_path() -> str:
    """Where phase 12 leaves the trained parameters for the jobs (under the
    git-ignored build directory)."""
    from fasthevc_tpu_torch import _build
    return os.path.join(_build.BUILD_DIR, "partition_cnn_smoke.pkl")


def phase_train(torch):
    """Phase 12: config 4's training recipe on the card; returns (the
    parameter tree, the launches of the training)."""
    from fasthevc_tpu_torch import _build
    from fasthevc_tpu_torch.models import save_params, train_self_distilled

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    marks = []

    def log(line):
        # the first line follows the distillation targets' search; the
        # step lines carry the loss and accuracy
        marks.append(time.perf_counter())
        print(line)

    t0 = time.perf_counter()
    params = train_self_distilled(qps=(27, 37), steps=400, device="cuda",
                                  log=log)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"train_self_distilled(qps=(27, 37), steps=400) on the card: "
          f"{dt:.2f} s wall: the distillation targets (the port's intra "
          f"search) {marks[0] - t0:.2f} s, then the 400 steps of K13's "
          f"training mode, K14 and K15 {t0 + dt - marks[0]:.2f} s")
    print(f"launches in the training: {launches}")
    _require(launches, SEARCH_KERNELS + TRAIN_KERNELS, "training")
    save_params(params, params_path())
    return params, launches


def phase_fast_routes(torch, params, full: dict) -> dict:
    """Phase 13's timed encodes: phases 3, 7 and 10 with fast_partition,
    beside the full search's stats; returns the summed launches."""
    launches: dict = {}
    for name, phase in (("all-intra", phase_device_route),
                        ("low-delay P", phase_ldp_route),
                        ("random access", phase_ra_route)):
        torch.cuda.empty_cache()
        got, st = phase(torch, params)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        ref = full[name]
        print(f"{name} 1080p QP32, fast partition vs full search: "
              f"{st['fps']:.4f} vs {ref['fps']:.4f} fps, {st['kbit']:.2f} "
              f"vs {ref['kbit']:.2f} kbit/frame, Y-PSNR {st['psnr']:.3f} vs "
              f"{ref['psnr']:.3f} dB")
    return launches


def phase_cnn_stream(torch, params) -> None:
    """Phase 13: one 1080p all-intra fast-partition stream (phase 3's
    first GROUP frames) with K13 and with cnn_depth(..., plain=True) (the
    conv2d chain on the card), every other kernel the same: byte identity,
    and K13's depth flips against the chain on those frames."""
    from fasthevc_tpu_torch.codec import search
    from fasthevc_tpu_torch.ops import cnn
    from fasthevc_tpu_torch.utils.video import pad_plane

    clip = _ai_clip()[:GROUP]
    cfg = _fast(_ai_cfg(GROUP), params)
    got = _encode(torch, cfg, clip, params=params)[0]
    kernel = search.cnn_depth
    search.cnn_depth = lambda *a, **kw: kernel(*a, **{**kw, "plain": True})
    try:
        want = _encode(torch, cfg, clip, params=params)[0]
    finally:
        search.cnn_depth = kernel
    y = torch.from_numpy(np.stack([
        pad_plane(np.asarray(f[0], np.int32), -(-HEIGHT // 32) * 32,
                  WIDTH).astype(np.uint8) for f in clip])).to("cuda")
    from fasthevc_tpu_torch.models.partition_cnn import as_partition_cnn
    theta = as_partition_cnn(params, "cuda", 5).flat_params()
    flips = int((cnn.cnn_depth(y, theta, QP, 5)
                 != cnn.cnn_depth(y, theta, QP, 5, plain=True)).sum().item())
    print(f"1080p all-intra fast-partition stream, {GROUP} frames, K13 vs "
          f"the conv2d chain: {'byte-identical' if got == want else 'DIFFERENT'}"
          f" ({len(got)} vs {len(want)} bytes); {flips} depth flip(s) of "
          f"{y.numel() // 64} granules on those frames")


def job_config4(torch) -> dict:
    """BASELINE config 4 (fasthevc_tpu/cli/evaluate.py:136-163) on the
    card: 416x240, 4 frames, the rate points of CNN_QPS with the full
    search and with the trained CNN, every stream hash-clean; the BD-rate
    of fast against full by the port's utils.bd_rate."""
    from fasthevc_tpu_torch.config import EncoderConfig
    from fasthevc_tpu_torch.models import load_params
    from fasthevc_tpu_torch.utils import (bd_rate, psnr, synthesize_yuv,
                                          yuv_from_planes)

    params = load_params(params_path())
    w, h, n = 416, 240, 4
    frames = synthesize_yuv(w, h, n, seed=4)
    curves = {}
    for label, p in (("full", None), ("fast", params)):
        rates, psnrs = [], []
        for qp in CNN_QPS:
            cfg = _fast(EncoderConfig(width=w, height=h, frames=n, qp=qp), p)
            stream, recons, _, _ = _encode(torch, cfg, frames, params=p)
            if not _decode_clean(stream, n):
                raise AssertionError(f"config 4 {label} QP{qp}: the stream "
                                     f"does not decode hash-clean")
            rates.append(len(stream) * 8)
            psnrs.append(float(np.mean([
                psnr(f[0], yuv_from_planes((r.y, r.cb, r.cr), w, h)[0])
                for f, r in zip(frames, recons)])))
        curves[label] = (rates, psnrs)
    bd = bd_rate(*curves["full"], *curves["fast"])
    pts = "; ".join(
        f"QP{qp}: full {curves['full'][0][i] / n / 1000:.2f} kbit/frame "
        f"{curves['full'][1][i]:.3f} dB, fast "
        f"{curves['fast'][0][i] / n / 1000:.2f} kbit/frame "
        f"{curves['fast'][1][i]:.3f} dB" for i, qp in enumerate(CNN_QPS))
    return {"bd_rate_pct": bd,
            "log": f"config 4 (416x240, {n} frames, fast vs full, every "
                   f"stream hash-clean): BD-rate {bd:+.4f}% (the gate is "
                   f"<= 2%: {'within' if bd <= 2.0 else 'outside'} it; a "
                   f"measurement, not a pass or fail); {pts}"}


def _fast_small(torch, route: str):
    """The 416x240 fast-partition checks: (config, frames, parameters)."""
    from fasthevc_tpu_torch.config import EncoderConfig, random_access_gop16
    from fasthevc_tpu_torch.models import load_params, params_to_flax

    if route == "pipelined (CTU 64)":
        cnn64 = params_to_flax(_seeded_cnn(torch, 6).cpu())
        return (EncoderConfig(width=416, height=240, qp=QP, frames=2,
                              log2_ctu=6, fast_partition=True), 2, cnn64)
    params = load_params(params_path())
    if route == "all-intra":
        return (EncoderConfig(width=416, height=240, qp=QP, frames=2,
                              fast_partition=True), 2, params)
    return (random_access_gop16(width=416, height=240, qp=QP,
                                frames=RA_FRAMES, fast_partition=True),
            RA_FRAMES, params)


def job_fast_small(torch, route: str) -> dict:
    """A 416x240 fast-partition clip through the kernels on the card (K13
    launched) and through the twins on the CPU: identical streams that
    decode hash-clean."""
    from fasthevc_tpu_torch import _build
    from fasthevc_tpu_torch.utils import synthesize_yuv

    cfg, frames, params = _fast_small(torch, route)
    clip = synthesize_yuv(416, 240, frames, seed=3)
    _build.LAUNCHES.clear()
    stream = _encode(torch, cfg, clip, params=params)[0]
    if _build.LAUNCHES["cnn_depth"] <= 0:
        raise AssertionError(f"416x240 fast {route}: K13 was not launched")
    if _encode(torch, cfg, clip, device="cpu", params=params)[0] != stream:
        raise AssertionError(f"416x240 fast {route}: the card's stream "
                             f"differs from the CPU twins'")
    if not _decode_clean(stream, frames):
        raise AssertionError(f"416x240 fast {route}: the stream does not "
                             f"decode hash-clean")
    return {"log": f"416x240 fast-partition {route}: {len(stream)} bytes, "
                   f"equal to the CPU twins' stream, {frames} pictures "
                   f"hash_ok"}


def _device_busy_us(events) -> float:
    """Microseconds in which the card ran at least one of `events`."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile_route(torch, label, clip, cfg, warm) -> None:
    """One profiled 1080p encode of `clip` (after a warm-up on `warm` and
    one unprofiled repeat): device busy share, and device time by
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    from fasthevc_tpu_torch.codec.encoder import TorchEncoder

    print(f"--- {label}")
    enc = TorchEncoder(cfg, "cuda")
    enc.encode(warm)
    for run in ("unprofiled", "profiled"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if run == "profiled":
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        enc.encode(clip)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if run == "profiled":
            prof.__exit__(None, None, None)
        print(f"{run} encode: {len(clip) / wall:.4f} fps, wall "
              f"{wall:.4f} s, device_s {enc.timing['device_s']:.4f}, "
              f"entropy {enc.timing['entropy_s']:.3f} thread-s, peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
              f" MiB")
    events = [e for e in prof.events()
              if str(e.device_type).endswith("CUDA")
              and e.time_range.elapsed_us() > 0]
    if not events:
        print("profiled: the profiler recorded no device time")
        return
    busy = _device_busy_us(events)
    idle = 100 * (1 - busy / 1e3 / (wall * 1e3))
    print(f"profiled: device busy {busy / 1e3:.3f} ms of a "
          f"{wall * 1e3:.3f} ms wall, idle {idle:.2f}%")
    by_name: dict = {}
    for e in events:
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), k + 1)
    total = sum(t for t, _ in by_name.values())
    for name, (t, k) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][0])[:25]:
        print(f"  {t / 1e3:10.3f} ms {100 * t / total:5.1f}% {k:6d}x "
              f"{name[:90]}")
    # the kernels by the work they do, every form of each
    for what, keys in (
            ("the search's T/Q/IQ/IT and RD terms (K3's forms, K4)",
             ("tq_kernel", "sse_rate_kernel")),
            ("K9's integer search (sad_search, me_coarse, me_fine)",
             ("sad_search_kernel", "me_coarse_kernel", "me_fine_kernel")),
            ("K9's decimation", ("downsample4_kernel",)),
            ("the merge candidates (mc_sel + K2, or mc_merge)",
             ("mc_sel_kernel", "::satd_kernel", "mc_merge_kernel")),
            ("the RD shortlist's K1 (the selected form, or intra_rd_cands)",
             ("intra_pred_kernel", "intra_rd_cands_kernel")),
            ("K12 (bi_cost, or bi_select)",
             ("bi_cost_kernel", "bi_select_kernel")),
            ("K7, SAO (sao_stats + sao_apply, or sao_fused)",
             ("sao_stats_kernel", "sao_apply_kernel", "sao_fused_kernel")),
            ("K11's commit planes (inter_pred a component, or "
             "inter_planes)", ("inter_pred_kernel", "inter_planes_kernel")),
            ("K6, the deblocking (deblock_kernel, cbf_kernel)",
             ("deblock_kernel", "cbf_kernel")),
            ("K8, the checksum", ("checksum_kernel",)),
            ("PyTorch's sorts (the shortlist's stable sort)", ("sort",
                                                             "Sort")),
            ("PyTorch's where / argmin / stack (the direction's glue "
             "among them)", ("where", "ArgMin", "CatArrayBatchedCopy")),
            ("PyTorch's own kernels (at::native)", ("at::native",))):
        grp = [v for name, v in by_name.items()
               if any(k in name for k in keys)]
        t_g = sum(t for t, _ in grp)
        print(f"  {what}: {t_g / 1e3:.3f} ms, {100 * t_g / total:.1f}%, "
              f"{sum(k for _, k in grp)} launches")


def _intra_sp():
    from fasthevc_tpu_torch.spec.encoder import config_to_sp
    return config_to_sp(_ai_cfg(GROUP))


def job_k5_intra(torch) -> dict:
    """Phase 2a's K5 against its twin on the first TWIN_FRAMES frames."""
    y, c = _kernel_inputs(torch, torch.device("cuda"))
    run_commit, _ = _intra_commit(torch, y, c, _intra_sp())
    want = run_commit(TWIN_FRAMES, False)
    twin, twin_ms = _timed_once(lambda: run_commit(TWIN_FRAMES, True))
    for name, a, b in zip(LEVEL_NAMES, want, twin):
        _same(torch, f"K5 {name}", a, b)
    return {"twin_ms": twin_ms,
            "log": f"K5 == its twin on {TWIN_FRAMES} 1080p frames"}


def job_k5_mixed(torch) -> dict:
    """Phase 2b's mixed K5 against its twin."""
    d = _p_commit_inputs(torch)
    want = _run_mixed(torch, d, False)
    twin, twin_ms = _timed_once(lambda: _run_mixed(torch, d, True))
    for name, a, b in zip(LEVEL_NAMES, want, twin):
        _same(torch, f"K5 mixed {name}", a, b)
    return {"twin_ms": twin_ms, "log": "K5 mixed == its twin (1080p P frame)"}


def _quadtree_depth(rng, gh: int, gw: int):
    """A seeded random CTU-32 depth map [gh, gw] (depths 0-2)."""
    depth = np.zeros((gh, gw), np.int32)
    for cy in range(0, gh, 4):
        for cx in range(0, gw, 4):
            if rng.random() < 0.7:
                for sy in range(2):
                    for sx in range(2):
                        depth[cy + 2 * sy:cy + 2 * sy + 2,
                              cx + 2 * sx:cx + 2 * sx + 2] = \
                            1 + (rng.random() < 0.5)
    return depth


def phase_mesh_kernels(torch, timed, work):
    """Phase 2f: K16, K6's tile-column form (with its CU cbf pass) and K7's
    halo form against their twins at the shapes of an interior rank of a
    1080p (2, 4) mesh (tile 1: 480 columns), exactly."""
    from fasthevc_tpu_torch.ops import deblock, halo

    dev = torch.device("cuda")
    rng = np.random.default_rng(2025)
    tw, ph = WIDTH // MESH[1], -(-HEIGHT // 32) * 32

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape)
                                .astype(np.uint8)).to(dev)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    # K16: the intra search's source exchange (a CTU left, two right)
    shapes = [(1, ph, tw), (1, ph // 2, tw // 2), (1, ph // 2, tw // 2)]
    own, left, right = ([u8(*s) for s in shapes] for _ in range(3))
    wl, wr = [32, 16, 16], [64, 32, 32]
    got = halo.halo_extend(own, left, right, wl, wr)
    for k, (a, b) in enumerate(zip(got, halo.halo_extend(
            own, left, right, wl, wr, plain=True))):
        _same(torch, f"K16 plane {k}", a, b)
    for k, (a, b) in enumerate(zip(halo.halo_pack(own, wl, wr),
                                   halo.halo_pack(own, wl, wr, plain=True))):
        _same(torch, f"K16 pack {k}", a, b)
    timed["halo"] = (
        _median_ms(lambda: halo.halo_extend(own, left, right, wl, wr)),
        _median_ms(lambda: halo.halo_extend(own, left, right, wl, wr,
                                            plain=True)))
    out_bytes = sum(g.numel() * g.element_size() for g in got)
    work["halo"] = (2 * out_bytes, 0.0)

    # K6's tile-column form on the tile's recon extended by 8 luma columns
    # each side, with P strengths from seeded maps
    ew = tw + 16
    gh, gw = HEIGHT // 8, ew // 8
    yy, xx = np.mgrid[0:HEIGHT, 0:ew]
    base = 110 + 50 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
    planes = [i32(np.clip(base + rng.integers(-20, 21, base.shape),
                          0, 255))[None]]
    planes += [i32(rng.integers(90, 170, (HEIGHT // 2, ew // 2)))[None]
               for _ in range(2)]
    dm = i32(_quadtree_depth(rng, gh, gw))[None]
    lv = torch.from_numpy((rng.random((HEIGHT, ew)) < 0.004)
                          .astype(np.int16) * 3)[None].to(dev)
    maps = dict(dir_map=i32(rng.integers(0, 4, (gh, gw)))[None],
                mv_map=i32(rng.integers(-12, 12, (gh, gw, 4)))[None])
    cbf = deblock.tu_cbf(lv, dm, 5)
    _same(torch, "K6 cbf (tile)", cbf, deblock.tu_cbf(lv, dm, 5,
                                                      plain=True))
    dargs = (*planes, dm, QP, QP - 1, QP - 1, 5)
    dkw = dict(maps, cbf=cbf, x0=tw - 8, pic_w=WIDTH)
    dk = deblock.deblock(*dargs, **dkw)
    for name, a, b in zip(("y", "cb", "cr"), dk,
                          deblock.deblock(*dargs, plain=True, **dkw)):
        _same(torch, f"K6 window {name}", a, b)
    timed["deblock_window"] = (
        _median_ms(lambda: deblock.deblock(*dargs, **dkw)),
        _median_ms(lambda: deblock.deblock(*dargs, plain=True, **dkw)))
    px = HEIGHT * ew
    segs = HEIGHT // 4 * gw + ew // 4 * gh
    work["deblock_window"] = (px * 1.5 * 4 * 2 + 4 * gh * gw * 7, 120 * segs)

    # K7's fused halo form on the tile with both neighbours' columns
    src = [i32(rng.integers(0, 256, (HEIGHT >> (c > 0), tw >> (c > 0))))
           [None] for c in range(3)]
    rec = [(s + i32(rng.integers(-5, 6, s.shape[1:]))[None]).clamp(0, 255)
           for s in src]
    cols = [tuple(i32(rng.integers(0, 256, HEIGHT >> (c > 0)))[None]
                  for _ in range(2)) for c in range(3)]
    skw = dict(halo_y=cols[0], halo_cb=cols[1], halo_cr=cols[2],
               l_avail=True, r_avail=True)
    _sao_check(torch, f"halo form, a {tw}-column tile, both neighbours",
               (*src, *rec, 5), skw, HEIGHT * tw, timed, work,
               ("sao_fused_halo", "sao_halo"))
    torch.cuda.synchronize()


def _mesh_cases():
    """Phase 16's cases: name -> (config, clip, driver name)."""
    from fasthevc_tpu_torch.config import EncoderConfig, GopEntry
    from fasthevc_tpu_torch.utils import synthesize_yuv

    ai = EncoderConfig(width=WIDTH, height=HEIGHT, qp=QP, frames=GROUP,
                       tile_cols=MESH[1], tile_rows=1, sao=True, hash_type=2)
    ldp = _ldp_cfg(2 * 4).replace(num_ref_per_list=1, tile_cols=MESH[1],
                                  tile_rows=1, intra_period=4)
    ipb = EncoderConfig(width=WIDTH, height=HEIGHT, qp=QP, frames=6,
                        tile_cols=MESH[1], tile_rows=1, sao=True,
                        hash_type=2, intra_period=3, search_range=SR,
                        num_ref_per_list=1,
                        gop=[GopEntry(2, 0, "P", (-2,)),
                             GopEntry(1, 1, "B", (-1, 1))])
    return {
        "all-intra": (ai, _ai_clip()[:GROUP], "sharded_encode_all_intra"),
        "low-delay P": (ldp, _ldp_clip()[:8], "sharded_encode_gop"),
        "IDR+P+B": (ipb, synthesize_yuv(WIDTH, HEIGHT, 6, seed=9),
                    "sharded_encode_gop"),
    }


def _mesh_stream_path(name: str) -> str:
    """Where phases 16 and 17 leave a stream for the decode jobs (under the
    git-ignored build directory)."""
    from fasthevc_tpu_torch import _build
    tag = name.replace(" ", "_").replace("+", "")
    return os.path.join(_build.BUILD_DIR, f"mesh_{tag}.bin")


def phase_mesh(torch) -> dict:
    """Phase 16: the in-process ("gop", "tile") mesh of MESH ranks on the
    card, every rank on its own stream: each case's sharded stream must
    equal TorchEncoder's single-device route byte for byte; prints both
    fps; requires the mesh kernels and returns their launches.  The
    streams go to the build directory for the decode jobs."""
    from fasthevc_tpu_torch import _build
    from fasthevc_tpu_torch.parallel import gop_tile_mesh, sharded

    mesh = gop_tile_mesh(MESH[0] * MESH[1], n_tile=MESH[1], device="cuda")
    launches: dict = {}
    for name, (cfg, clip, driver) in _mesh_cases().items():
        encode = getattr(sharded, driver)
        encode(clip, cfg, mesh)          # warm-up: streams, tables, caches
        _encode(torch, cfg, clip)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        tm: dict = {}
        t0 = time.perf_counter()
        stream, _ = encode(clip, cfg, mesh, timing=tm)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = -(-len(clip) // MESH[0])
        ranks = MESH[0] * MESH[1]
        print(f"launches in the mesh {name} encode ({steps} steps of "
              f"{ranks} ranks): "
              f"{ {k: v for k, v in _build.LAUNCHES.items()} }")
        # K7's fused halo form once a rank and step; K11's planes once a
        # rank and inter step (every step but each segment's IDR)
        inter = 0 if name == "all-intra" else (steps - 1) * ranks
        want = {"sao_fused_halo": steps * ranks, "planes": inter}
        got = {"sao_fused_halo": _build.LAUNCHES.get("sao_fused_halo", 0),
               "planes": _build.LAUNCHES.get("inter_pred_fused", 0)
               + _build.LAUNCHES.get("inter_pred_fused_bi", 0)}
        if got != want:
            raise AssertionError(f"mesh {name}: K7 / K11 planes launches "
                                 f"{got}, expected {want}")
        for k, v in _build.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        single, _, sdt, _ = _encode(torch, cfg, clip)
        if stream != single:
            raise AssertionError(f"mesh {name}: sharded stream ({len(stream)}"
                                 f" B) differs from the single-device route's"
                                 f" ({len(single)} B)")
        os.makedirs(os.path.dirname(_mesh_stream_path(name)), exist_ok=True)
        with open(_mesh_stream_path(name), "wb") as f:
            f.write(stream)
        print(f"mesh {MESH} {name}, 1080p QP32, {len(clip)} frames, "
              f"{cfg.tile_cols} tile columns: sharded == single-device "
              f"({len(stream)} bytes); sharded {len(clip) / dt:.4f} fps "
              f"(wall {dt:.3f} s: the ranks' threads {tm['run_s']:.3f} s, "
              f"fetching their outputs {tm['fetch_s']:.3f} s, host CABAC "
              f"and NAL glue {tm['entropy_s']:.3f} s), single-device "
              f"{len(clip) / sdt:.4f} fps (both after a warm-up)")
    print(f"launches in the mesh encodes: {launches}")
    _require(launches, MESH_KERNELS + ("deblock_cbf", "bi_select")
             + SEARCH_KERNELS + ME_KERNELS, "mesh encodes")
    return launches


def profile_mesh(torch) -> None:
    """`--profile-mesh`: each phase-16 case on the (2, 4) mesh, after a
    warm-up, once unprofiled and once under torch.profiler (device
    activity only).  The unprofiled run splits the host's time: each rank
    thread's wall into its CPU time, its waits in the mesh's barriers and
    the rest (ready but held off the CPU: the GIL, or a blocking call),
    and K16's host time into describing its planes (outputs, descriptors)
    and the launch call.  The profiled run gives the card's busy share of
    the wall and its time by kernel, K16's own kernel time included."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from fasthevc_tpu_torch.ops import halo
    from fasthevc_tpu_torch.parallel import gop_tile_mesh, group, sharded

    lock = threading.Lock()
    k16 = dict(extend_s=0.0, launch_s=0.0, extend_n=0, launch_n=0)

    def timed(fn, key):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    k16[key + "_s"] += time.perf_counter() - t0
                    k16[key + "_n"] += 1
        return wrapper

    # group.py calls halo_extend by its own name; halo_extend calls _launch
    group.halo_extend = timed(halo.halo_extend, "extend")
    halo._launch = timed(halo._launch, "launch")
    mesh = gop_tile_mesh(MESH[0] * MESH[1], n_tile=MESH[1], device="cuda")
    for name, (cfg, clip, driver) in _mesh_cases().items():
        encode = getattr(sharded, driver)
        encode(clip, cfg, mesh)          # warm-up
        torch.cuda.synchronize()
        mesh.rank_times.clear()
        k16.update(extend_s=0.0, launch_s=0.0, extend_n=0, launch_n=0)
        tm: dict = {}
        t0 = time.perf_counter()
        encode(clip, cfg, mesh, timing=tm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rt = mesh.rank_times
        w = sum(v["wall_s"] for v in rt.values())
        c = sum(v["cpu_s"] for v in rt.values())
        b = sum(v["wait_s"] for v in rt.values())
        print(f"--- mesh {MESH} {name}, {len(clip)} frames, unprofiled: wall "
              f"{wall:.4f} s (ranks' programs {tm['run_s']:.4f}, fetch "
              f"{tm['fetch_s']:.4f}, host CABAC and glue "
              f"{tm['entropy_s']:.4f}); the {len(rt)} rank threads: wall "
              f"{w:.4f} thread-s = CPU {c:.4f} + barrier waits {b:.4f} + "
              f"held off the CPU {w - c - b:.4f}; K16 host: "
              f"{k16['extend_n']} calls, {k16['extend_s'] * 1e3:.3f} ms "
              f"= describing {(k16['extend_s'] - k16['launch_s']) * 1e3:.3f}"
              f" + launching {k16['launch_s'] * 1e3:.3f} ms "
              f"({k16['launch_n']} launches)")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            encode(clip, cfg, mesh)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        events = [e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")
                  and e.time_range.elapsed_us() > 0]
        if not events:
            print("profiled: the profiler recorded no device time")
            continue
        busy = _device_busy_us(events)
        by_name: dict = {}
        for e in events:
            t, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), k + 1)
        total = sum(t for t, _ in by_name.values())
        print(f"profiled: wall {pwall:.4f} s, device busy "
              f"{busy / 1e3:.3f} ms, idle {100 * (1 - busy / 1e6 / pwall):.2f}"
              f"%; device time summed over streams {total / 1e3:.3f} ms")
        for kname, (t, k) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:14]:
            print(f"  {t / 1e3:10.3f} ms {100 * t / total:5.1f}% {k:6d}x "
                  f"{kname[:80]}")
        t, k = next(((t, k) for n, (t, k) in by_name.items()
                     if "halo_kernel" in n), (0.0, 0))
        print(f"  K16 on the card: {k} launches, {t / 1e3:.3f} ms, "
              f"{t / max(k, 1):.2f} us a launch")


def phase_config5(torch) -> None:
    """Phase 17: BASELINE config 5 through gop_parallel_encode_check: 4K,
    16 frames, 2 processes on the card, tiles 2x2, intra period 8; the
    concatenated stream must equal one process's byte for byte (its
    hash-clean decode runs in the config5-decode job)."""
    from fasthevc_tpu_torch.parallel.multiproc import (
        gop_parallel_encode_check)

    res = gop_parallel_encode_check(3840, 2160, 16, n_procs=2, tile_cols=2,
                                    tile_rows=2, intra_period=8,
                                    device="cuda", timeout=600, decode=False,
                                    keep=_mesh_stream_path("config5"))
    if not (res["byte_identical"] and all(rc == 0 for rc in res["rcs"])):
        raise AssertionError(f"config 5: {res}")
    print(f"config 5 (3840x2160, 16 frames, tiles 2x2, intra period 8): 2 "
          f"processes == 1 process ({res['bytes']} bytes); 2 processes "
          f"{16 / res['parallel_s']:.4f} fps, 1 process "
          f"{16 / res['single_s']:.4f} fps (wall, process start and "
          f"CUDA context included)")


def job_mesh_decode(torch, names) -> dict:
    """Phase 16-17's streams decode with matching hashes in SpecDecoder
    (pictures [first, last) of each, IDR-led)."""
    from fasthevc_tpu_torch.spec import bitstream as bs
    from fasthevc_tpu_torch.spec.decoder import SpecDecoder

    logs = []
    for name, first, last in names:
        t0 = time.perf_counter()
        with open(_mesh_stream_path(name), "rb") as f:
            stream = f.read()
        nals = list(bs.split_annexb(stream))
        # the parameter sets, then the access units of pictures
        # [first, last): each picture is its slice NAL and hash SEI
        head = [n for n in nals if n[0] in (bs.NAL_VPS, bs.NAL_SPS,
                                            bs.NAL_PPS)]
        pics, cur = [], []
        for n in nals:
            if n in head:
                continue
            cur.append(n)
            if n[0] == bs.NAL_SUFFIX_SEI:
                pics.append(cur)
                cur = []
        dec = SpecDecoder()
        for nal_type, _, rbsp in head + [n for p in pics[first:last]
                                          for n in p]:
            dec._decode_nal(nal_type, rbsp)
        if not (len(dec.pictures) == last - first
                and all(p.hash_ok for p in dec.pictures)):
            raise AssertionError(f"{name}: pictures {first}-{last - 1} do "
                                 f"not decode hash-clean")
        logs.append(f"{name} pictures {first}-{last - 1} hash_ok "
                    f"({time.perf_counter() - t0:.1f} s)")
    return {"log": "; ".join(logs)}


def job_sharded_small(torch) -> dict:
    """The dry run's two configurations on an in-process mesh of 8 ranks:
    through the kernels on the card, the twins on the card and the twins
    on the CPU (each equal to the single-device route and hash-clean);
    all three streams must be identical."""
    from fasthevc_tpu_torch.parallel.dryrun import dryrun_multichip

    runs = [dryrun_multichip(8, "cuda"), dryrun_multichip(8, "cuda",
                                                          plain=True),
            dryrun_multichip(8, "cpu")]
    if not runs[0] == runs[1] == runs[2]:
        raise AssertionError("sharded-small: kernel, card-twin and CPU-twin "
                             "streams differ")
    return {"log": "sharded-small (dry run, 8 ranks): kernels == card twins "
            "== CPU twins, " + ", ".join(f"{k} {len(v)} bytes"
                                         for k, v in runs[0].items())}


# Checks that run the twins, each in its own process (the twins are bound
# by the host's launches and Python, so they overlap): phase 2's K5
# twins, 4, 5 and 6's 416x240 check, 8, 9, 11, and phase 13's config 4
# and 416x240 fast-partition checks (these read phase 12's parameters).
JOBS = {
    "k5-intra": job_k5_intra,
    "k5-mixed": job_k5_mixed,
    "ai-twin-route": lambda torch: {"log": _twin_route(
        torch, _ai_cfg(GROUP), _ai_clip()[GROUP:2 * GROUP], "all-intra")},
    "ldp-twin-route": lambda torch: {"log": _twin_route(
        torch, _ldp_cfg(LDP_TWIN_FRAMES), _ldp_clip()[:LDP_TWIN_FRAMES],
        "low-delay P")},
    "small-device": lambda torch: job_small(torch, "device (CTU 32)", "cpu"),
    "small-pipelined": lambda torch: job_small(torch, "pipelined (CTU 64)",
                                               "cpu"),
    "small-ldp": lambda torch: job_small(torch, "low-delay P", "cpu"),
    "small-ra-card": lambda torch: job_small(torch, "random-access", "card"),
    "small-ra-cpu": lambda torch: job_small(torch, "random-access", "cpu"),
    "config4": job_config4,
    "fast-small-ai": lambda torch: job_fast_small(torch, "all-intra"),
    "fast-small-ra": lambda torch: job_fast_small(torch, "random-access"),
    "fast-small-pipelined": lambda torch: job_fast_small(
        torch, "pipelined (CTU 64)"),
    # this slice's 416x240 streams, in three processes of similar length
    "classic-small-ra64": lambda torch: job_classic_small(
        torch, ["RA GOP-16 at CTU 64"]),
    "classic-small-hrd-ra": lambda torch: job_classic_small(
        torch, ["HRD on the RA device route"]),
    "classic-small": lambda torch: job_classic_small(
        torch, ["fast-partition LDP at CTU 64",
                "weighted prediction on a fade", "lossless LDP",
                "quality() two-pass search",
                "rate-controlled all-intra device route"]),
    # the multi-device layer: the dry run's streams three ways, and the
    # hash-clean decodes of phase 16's and 17's streams, started as soon as
    # each stream exists (EARLY_JOBS).  SpecDecoder is pure Python, slow
    # at 1080p and slower at 4K: the IDR+P+B stream is decoded whole (I, P
    # and B pictures of both gop rows); of the others, IDR-led spans: each
    # gop row's first pictures, config 5's second process's IDR and P
    "sharded-small": job_sharded_small,
    "mesh-decode": lambda torch: job_mesh_decode(
        torch, [("all-intra", 0, 2), ("low-delay P", 0, 2),
                ("low-delay P", 4, 6)]),
    "mesh-decode-ipb": lambda torch: job_mesh_decode(
        torch, [("IDR+P+B", 0, 6)]),
    "config5-decode": lambda torch: job_mesh_decode(
        torch, [("config5", 8, 10)]),
}
# the jobs started before the others, each once its stream is written
EARLY_JOBS = ("mesh-decode", "mesh-decode-ipb", "config5-decode")


# The twin routes at 1080p set the length of the jobs' phase: every other
# job runs at a lower CPU priority, so that it takes the cores they leave.
LONG_JOBS = ("ai-twin-route", "ldp-twin-route")


def _start_jobs(names) -> dict:
    """JOBS entries in processes of their own (`chip_smoke.py --job
    NAME`), those outside LONG_JOBS at niceness 10."""
    here = os.path.abspath(__file__)
    return {name: subprocess.Popen(
        [sys.executable, here, "--job", name], cwd=os.path.dirname(here),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        preexec_fn=None if name in LONG_JOBS else lambda: os.nice(10))
        for name in names}


def _run_jobs(t_start: float, early: dict) -> dict:
    """Every JOBS entry not in `early` (the processes already started) in
    its own process, all at once; each prints its log and, last, a JSON
    line of results.  Raises if one fails; stops every process it
    started."""
    procs = dict(early)
    procs.update(_start_jobs([n for n in JOBS if n not in early]))
    results, failed = {}, []
    try:
        for name, proc in procs.items():
            left = max(1.0, JOBS_DEADLINE_S - (time.perf_counter() - t_start))
            out, _ = proc.communicate(timeout=left)
            lines = out.strip().splitlines()
            last = [ln for ln in lines if ln.startswith("{")][-1:]
            if proc.returncode != 0 or not last:
                failed.append(f"job {name} (exit {proc.returncode}):\n"
                              + "\n".join(lines[-30:]))
                continue
            results[name] = json.loads(last[0])
            print(f"[{name}] {results[name]['log']}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise AssertionError("\n".join(failed))
    return results


def bench_kernels(torch) -> None:
    """`--bench-kernels`: the kernels this slice redesigned and the timed
    encodes, with no twin and no launch check, so that two checkouts can
    be timed in turns on one card (`--root DIR` imports the package from
    DIR): K10 at n = 8, 16, 32 on phase 2b's P frame and n = 64 on phase
    2e's B frame; K1's all-mode form, K2 and (where the package has it)
    K1's fused form at n = 8, 16, 32 on phase 2a's group, with K3 + K4
    and (where the package has it) K3's costed form on three candidates a
    block; K14 and autograd through the chain in turns on phase 2d's
    training batch; then phases 3, 7 and 10's encodes, each BENCH_ENCODES
    times after its warm-up, every fps and their median printed beside
    the medians of the encoder's timing split and the stream's size and
    SHA-256; then phase 14's classic-route encode and phase 16's three mesh
    encodes, each once after its warm-up, with the stream's size and
    SHA-256.  First of all, K9's integer stage (`me_state`: the earlier
    form's downsample4 + five sad_search calls, or downsample4 + me_coarse
    + me_fine) and the merge candidates (the earlier form's
    `_with_merge_cands` a list, on mc_sel, K2 and the fold's torch ops, or
    one mc_merge for the lists) on phase 2b's P frame (two references, one
    list) and phase 2c's B frame (four state references, two lists), at n
    = 8, 16, 32, and on that B frame K12 (the parent's path, bi_cost and
    the stack / argmin / where glue, and bi_select where the package has
    it); beside K1's fused form, the RD shortlist on 3 candidates a block
    (the parent's path, the cost / sort / gather / subtract glue around K1's
    selected form, and intra_rd_cands where the package has it); every
    path's glue is the device time of the path alone less its kernel's."""
    import hashlib

    from fasthevc_tpu_torch.codec import search
    from fasthevc_tpu_torch.codec.encoder import TorchEncoder
    from fasthevc_tpu_torch.codec.search import _blocks, search_qp
    from fasthevc_tpu_torch.ops import cnn, cost, intra, me, transform

    def bench_bi(st, sp, n, ls):
        """K12 on the B frame's merge winners: the parent's path (bi_cost,
        stack, argmin, where), its glue's device time apart, and
        bi_select where the package has it."""
        args = _bi_args(torch, st, sp, n, ls)
        ms, dev = (_median_ms(lambda: _bi_parent(torch, me, args)),
                   _device_ms(lambda: _bi_parent(torch, me, args)))
        k12 = _device_ms(lambda: _bi_parent(torch, me, args),
                         keys=("bi_cost_kernel",))
        glue = None if dev is None or k12 is None else dev - k12
        text = (f"bench BI and direction n={n} (B frame): the parent's path "
                f"{ms:.4f} ms, the card's own {_ms_text(dev)} (bi_cost "
                f"{_ms_text(k12)}, the stack / argmin / where glue "
                f"{_ms_text(glue)})")
        if hasattr(me, "bi_select"):
            text += (f"; bi_select {_median_ms(lambda: me.bi_select(*args)):.4f}"
                     f" ms, the card's own "
                     f"{_ms_text(_device_ms(lambda: me.bi_select(*args)))}")
        print(text)

    def bench_shortlist(gy, n, top, left, src, d):
        """The intra search's RD shortlist on the group's n-blocks: the
        parent's path (sort, K1's selected form, subtract), its glue's
        device time apart, and intra_rd_cands where the package has it."""
        lg = n.bit_length() - 1
        bits = search._intra_mode_bits(torch.argmin(d, dim=1).to(
            torch.int32), GROUP, gy.shape[1] // n, gy.shape[2] // n)
        ls = torch.tensor(_lambda_sqrt(QP), dtype=torch.float32)

        def par():
            return _shortlist_parent(torch, intra, top, left, lg, src, d,
                                     bits, ls)
        ms, dev = _median_ms(par), _device_ms(par)
        k1 = _device_ms(par, keys=("intra_pred_kernel",))
        glue = None if dev is None or k1 is None else dev - k1
        text = (f"bench RD shortlist n={n} ({src.shape[0]} blocks, 3 "
                f"candidates): the parent's path {ms:.4f} ms, the card's own "
                f"{_ms_text(dev)} (intra_pred_selected {_ms_text(k1)}, the "
                f"cost / sort / gather / subtract glue {_ms_text(glue)})")
        if hasattr(intra, "intra_rd_cands"):
            def new():
                return intra.intra_rd_cands(top, left, lg, src, d, bits, ls,
                                            3)
            text += (f"; intra_rd_cands {_median_ms(new):.4f} ms, the card's"
                     f" own {_ms_text(_device_ms(new))}")
        print(text)

    src, refs = _p_frames(torch, torch.device("cuda"))
    pad = (0, 0, 0, -(-HEIGHT // 32) * 32 - HEIGHT)
    y = torch.nn.functional.pad(src[0][None].float(), pad,
                                mode="replicate")[0].to(torch.int32)
    r = torch.nn.functional.pad(refs[0].float(), pad,
                                mode="replicate").to(torch.int32)
    clip = _ra_clip()
    yb = torch.nn.functional.pad(torch.from_numpy(np.asarray(
        clip[4][0], np.int32))[None].float().cuda(), pad,
        mode="replicate")[0].to(torch.int32)
    rb = torch.stack([torch.nn.functional.pad(torch.from_numpy(np.asarray(
        clip[k][0], np.int32))[None].float().cuda(), pad,
        mode="replicate")[0].to(torch.int32) for k in (0, 8, 8, 16)])
    del clip
    fused = hasattr(me, "mc_merge")
    for label, yy, rr, ls, pairs in (
            ("P frame, 2 refs", y, r, _lambda_sqrt(QP), [(0, 1)]),
            ("B frame, 4 state refs", yb, rb, _lambda_sqrt(QP + 2),
             [(0, 1), (2, 3)])):
        ms = _median_ms(lambda: me.me_state(yy, rr, SR))
        dev = _device_ms(lambda: me.me_state(yy, rr, SR))
        print(f"bench me_state ({label}, SR {SR}): {ms:.4f} ms, the card's "
              f"own {_ms_text(dev)} ("
              + ("downsample4 + me_coarse + me_fine" if fused else
                 "downsample4 + five sad_search") + ")")
        st = me.me_state(yy, rr, SR)
        sp = me.subpel_from_state(st, ls)
        for n in (8, 16, 32):
            lists = _merge_lists(torch, st, sp, n, pairs)
            if fused:
                def run():
                    return me.mc_merge(st, lists, n, ls)
            else:
                ls_t = torch.tensor(ls, dtype=torch.float32)
                src_b = _blocks(yy[None], n)

                def run():
                    return [search._with_merge_cands(
                        st, src_b, *li[:2], *li[2:], n, ls_t, cost.satd,
                        False) for li in lists]
            ms, dev = _median_ms(run), _device_ms(run)
            print(f"bench merge candidates n={n} ({label}, {len(pairs)} "
                  f"list(s)): {ms:.4f} ms, the card's own {_ms_text(dev)} ("
                  + ("mc_merge" if fused else "mc_sel + satd + the fold, a "
                     "list at a time") + ")")
            if len(pairs) == 2:
                bench_bi(st, sp, n, ls)
        del st, sp
    del yb, rb
    cases = [(n, y, r, me.me_state(y, r, SR).mv_int[n], _lambda_sqrt(QP))
             for n in (8, 16, 32)]
    y64, r64, ls64, st64 = _b64_inputs(torch)
    cases.append((64, y64, r64, st64.mv_int[64], ls64))
    for n, yy, rr, mv, ls in cases:
        ms = _median_ms(lambda: me.subpel(yy, rr, mv, n, ls))
        print(f"bench subpel n={n} ({rr.shape[0]} refs): {ms:.4f} ms")
    del cases, y64, r64, st64
    bench_filters_and_planes(torch)
    gy, _ = _kernel_inputs(torch, torch.device("cuda"))
    for n in (8, 16, 32):
        lg = n.bit_length() - 1
        top, left = intra.grid_refs(gy, n)
        src = _blocks(gy, n).contiguous()
        pk = intra.predict_all_modes(top, left, lg)
        k1 = _median_ms(lambda: intra.predict_all_modes(top, left, lg))
        k2 = _median_ms(lambda: cost.satd(src, pk))
        res = (src[:, None] - pk[:, :3]).reshape(-1, n, n).contiguous()
        del pk
        fused = ""
        if hasattr(intra, "predict_satd"):
            fused = ", intra_satd {:.4f} ms".format(_median_ms(
                lambda: intra.predict_satd(top, left, lg, src)))
        print(f"bench n={n}: intra_pred all-mode {k1:.4f} ms + satd "
              f"{k2:.4f} ms = {k1 + k2:.4f} ms{fused}")
        bench_shortlist(gy, n, top, left, src,
                        intra.predict_satd(top, left, lg, src))
        qp = search_qp(_lambda_sqrt(QP))
        lk, rk = transform.tq_roundtrip(res, qp, lg)
        k3 = _median_ms(lambda: transform.tq_roundtrip(res, qp, lg))
        k4 = _median_ms(lambda: cost.sse_rate(res, rk, lk))
        costed = ""
        if hasattr(transform, "tq_cost"):
            costed = ", tq_cost {:.4f} ms".format(_median_ms(
                lambda: transform.tq_cost(res, qp, lg)))
        print(f"bench n={n} ({res.shape[0]} residuals): tq_roundtrip "
              f"{k3:.4f} ms + sse_rate {k4:.4f} ms = {k3 + k4:.4f} ms"
              f"{costed}")
        del res, lk, rk
    del gy
    rng = np.random.default_rng(12)
    x = cnn.ctu_batch(_cnn_frames(torch, 5, 1), 32)[:CNN_BATCH, 0]
    x = x.contiguous()
    q = torch.from_numpy(rng.choice([27.0, 37.0], CNN_BATCH)
                         .astype(np.float32)).to("cuda")
    t = torch.from_numpy(rng.integers(0, 3, (CNN_BATCH, 4, 4))
                         .astype(np.int32)).to("cuda")
    theta = _seeded_cnn(torch, 5).flat_params()
    lk, acts = cnn.cnn_train_forward(x, q, theta)
    th_lib = theta.clone().requires_grad_(True)
    ce = torch.nn.functional.cross_entropy(
        cnn.logits_plain(x[:, None], q, cnn.unflatten(th_lib, 3))
        .permute(0, 3, 1, 2), t.long())
    k14, chain = _interleaved_ms(
        lambda: cnn.cnn_backward(x, q, t, theta, acts, lk),
        lambda: torch.autograd.grad(ce, th_lib, retain_graph=True))
    qa, qb = np.percentile(k14, [25, 50, 75]), np.percentile(chain,
                                                             [25, 50, 75])
    print(f"bench cnn_backward ({CNN_BATCH} CTUs of 32), {K14_PAIRS} pairs "
          f"in turns with autograd through the chain: K14 median "
          f"{qa[1]:.4f} ms (IQR {qa[0]:.4f}-{qa[2]:.4f}), autograd median "
          f"{qb[1]:.4f} ms (IQR {qb[0]:.4f}-{qb[2]:.4f})")
    del x, acts, lk, ce
    torch.cuda.empty_cache()
    ai, ldp, ra = _ai_clip(), _ldp_clip(), _ra_clip()
    for name, cfg, warm, clip in (
            ("all-intra", _ai_cfg(TIMED), ai[:GROUP], ai[GROUP:]),
            ("low-delay P", _ldp_cfg(len(ldp)), ldp[:3], ldp),
            ("random access", _ra_cfg(RA_FRAMES), ra, ra)):
        enc = TorchEncoder(cfg, "cuda")
        enc.encode(warm)
        fps, split = [], []
        for _ in range(BENCH_ENCODES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream, _ = enc.encode(clip)
            fps.append(len(clip) / (time.perf_counter() - t0))
            split.append(enc.timing)
        split = ", ".join(f"{k} {np.median([t[k] for t in split]):.4f}"
                          for k in split[0])
        print(f"bench {name}: median {np.median(fps):.4f} fps ("
              + ", ".join(f"{v:.4f}" for v in fps) + f"), timing medians "
              f"{split}, {len(stream)} bytes, sha256 "
              f"{hashlib.sha256(stream).hexdigest()[:16]}")
    clip = ldp[:1 + CLASSIC_TIMED_P]
    enc = TorchEncoder(_classic_cfg(len(clip)), "cuda")
    enc.encode(clip[:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream, _ = enc.encode(clip)
    print(f"bench classic per-frame (phase 14): "
          f"{len(clip) / (time.perf_counter() - t0):.4f} fps, "
          f"{len(stream)} bytes, sha256 "
          f"{hashlib.sha256(stream).hexdigest()[:16]}")
    from fasthevc_tpu_torch.parallel import gop_tile_mesh, sharded
    mesh = gop_tile_mesh(MESH[0] * MESH[1], n_tile=MESH[1], device="cuda")
    for name, (cfg, clip, driver) in _mesh_cases().items():
        encode = getattr(sharded, driver)
        encode(clip, cfg, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream, _ = encode(clip, cfg, mesh)
        torch.cuda.synchronize()
        print(f"bench mesh {MESH} {name} (phase 16): "
              f"{len(clip) / (time.perf_counter() - t0):.4f} fps, "
              f"{len(stream)} bytes, sha256 "
              f"{hashlib.sha256(stream).hexdigest()[:16]}")


def bench_filters_and_planes(torch) -> None:
    """K7 and K11's commit planes through the routes' calls (`sao`,
    `inter_pred_planes`), whichever form the package launches there: SAO
    on phase 2a's 1080p group (its frames as the source, a recon within
    +-6 of them), the planes on phase 2b's P decisions and, from the same
    maps, seeded directions 1-3 over both lists (the references reversed
    as list 1); each with events and the card's own time."""
    from fasthevc_tpu_torch.ops import me, sao

    dev = torch.device("cuda")
    gy, gc = _kernel_inputs(torch, dev)
    rng = np.random.default_rng(13)

    def near(p):
        noise = rng.integers(-6, 7, tuple(p.shape)).astype(np.int32)
        return (p + torch.from_numpy(noise).to(dev)).clamp(0, 255)

    src = (gy[:, :HEIGHT].contiguous(), gc[:, :HEIGHT // 2].contiguous(),
           gc.flip(0)[:, :HEIGHT // 2].contiguous())
    sargs = src + tuple(near(p) for p in src) + (5,)
    del gy, gc

    def run_sao():
        return sao.sao(*sargs)

    print(f"bench sao (1080p group of {GROUP}): {_median_ms(run_sao):.4f} "
          f"ms, the card's own {_ms_text(_device_ms(run_sao))}")
    del sargs, src
    d = _p_commit_inputs(torch)
    l0 = tuple(p[None] for p in d["refs"])
    l1 = tuple(p.flip(1) for p in l0)
    bdir = torch.from_numpy(rng.integers(1, 4, tuple(d["im"].shape))
                            .astype(np.int32)).to(dev)

    def uni():
        return me.inter_pred_planes(l0, None, d["im"], d["mv"],
                                    ref_map=d["rm"])

    def bi():
        return me.inter_pred_planes(l0, l1, bdir, d["mv"], ref_map=d["rm"])

    for label, fn in (("1080p P decisions, 2 refs", uni),
                      ("seeded directions 1-3 on them, 2 refs a list", bi)):
        print(f"bench commit planes ({label}): {_median_ms(fn):.4f} ms, "
              f"the card's own {_ms_text(_device_ms(fn))}")


def _stamp(t_start: float, what: str) -> None:
    print(f"[{time.perf_counter() - t_start:.1f} s] {what}")


def main() -> int:
    argv = sys.argv[1:]
    if "--root" in argv:
        # time another checkout's package; its twins and jobs are not run
        if "--bench-kernels" not in argv and "--profile" not in argv:
            raise SystemExit("chip_smoke: --root is only for --bench-kernels"
                             " and --profile")
        sys.path.insert(0, os.path.abspath(argv[argv.index("--root") + 1]))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    # the device routes are the default; this variable would force the
    # pipelined all-intra route (and refuse P orders)
    os.environ.pop("FASTHEVC_FORCE_CLASSIC", None)
    if "--job" in argv:
        # one twin check in its own process: the library is built already
        torch.set_num_threads(2)
        name = argv[argv.index("--job") + 1]
        print(json.dumps(JOBS[name](torch)))
        return 0
    card = _card_line()
    from fasthevc_tpu_torch import _build

    t_start = time.perf_counter()
    _build.lib()
    print(f"kernel build: {time.perf_counter() - t_start:.2f} s "
          f"({len(_build.sources())} sources)")
    if "--profile-mesh" in argv:
        profile_mesh(torch)
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--bench-kernels" in argv:
        bench_kernels(torch)
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--profile" in argv:
        clip = _ldp_clip()
        profile_route(torch, "low-delay P", clip, _ldp_cfg(len(clip)),
                      clip[:3])
        clip = _ra_clip()
        profile_route(torch, "random access", clip, _ra_cfg(len(clip)), clip)
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    dev = torch.device("cuda")
    errs = {name: 0.0 for name in META}
    timed: dict = {}
    work: dict = {}
    lib_ms = {name: None for name in META}
    y, c = _kernel_inputs(torch, dev)
    phase_search_kernels(torch, y, c, errs, timed, work)
    phase_pixel_kernels(torch, y, c, _intra_sp(), timed, work)
    del y, c
    torch.cuda.empty_cache()
    phase_inter_kernels(torch, timed, work)
    phase_b_kernels(torch, timed, work)
    phase_ctu64_kernels(torch)
    torch.cuda.empty_cache()
    phase_cnn_kernels(torch, errs, timed, work, lib_ms)
    torch.cuda.empty_cache()
    phase_mesh_kernels(torch, timed, work)
    _stamp(t_start, "phase 2 (kernels; K5's twins run in the jobs)")
    # the timed encodes first, alone on the card and the host
    torch.cuda.empty_cache()
    full = {}
    launches, full["all-intra"] = phase_device_route(torch)
    phase_pipelined_route(torch, full["all-intra"]["fps"])
    torch.cuda.empty_cache()
    got, full["low-delay P"] = phase_ldp_route(torch)
    launches.update({k: v for k, v in got.items() if k in P_KERNELS})
    torch.cuda.empty_cache()
    got, full["random access"] = phase_ra_route(torch)
    launches.update({k: v for k, v in got.items() if k in B_KERNELS})
    _stamp(t_start, "phases 3, 6, 7, 10 (the timed encodes)")
    torch.cuda.empty_cache()
    params, got = phase_train(torch)
    launches.update({k: v for k, v in got.items() if k in TRAIN_KERNELS})
    _stamp(t_start, "phase 12 (training)")
    got = phase_fast_routes(torch, params, full)
    launches["cnn_depth"] = got["cnn_depth"]
    phase_cnn_stream(torch, params)
    _stamp(t_start, "phase 13's timed fast-partition encodes")
    torch.cuda.empty_cache()
    phase_classic_route(torch)
    phase_rate_control(torch, full)
    _stamp(t_start, "phases 14 and 15 (the classic route, rate control)")
    torch.cuda.empty_cache()
    got = phase_mesh(torch)
    launches.update({k: v for k, v in got.items() if k in MESH_KERNELS})
    early = _start_jobs(["mesh-decode", "mesh-decode-ipb"])
    _stamp(t_start, "phase 16 (the (2, 4) mesh)")
    torch.cuda.empty_cache()
    phase_config5(torch)
    early.update(_start_jobs(["config5-decode"]))
    _stamp(t_start, "phase 17 (config 5, 2 processes)")
    torch.cuda.empty_cache()
    jobs = _run_jobs(t_start, early)
    if jobs["small-ra-card"]["sha"] != jobs["small-ra-cpu"]["sha"]:
        raise AssertionError("416x240 random-access: the kernel streams of "
                             "the two checks differ")
    _stamp(t_start, "phases 2a/2b's K5 twins, 4, 5, 6's 416x240, 8, 9, 11, "
           "13's config 4 and 416x240 checks and classic_small (the jobs, "
           "in parallel)")
    timed["commit_intra"] = (timed["commit_intra"][0],
                             jobs["k5-intra"]["twin_ms"])
    timed["commit_mixed"] = (timed["commit_mixed"][0],
                             jobs["k5-mixed"]["twin_ms"])
    bounds = {name: _bound(*work[name]) for name in META}
    for name in META:
        ms, plain_ms = timed[name]
        b_ms, b_by = bounds[name]
        lib = ("" if lib_ms[name] is None
               else f", library {lib_ms[name]:.4f} ms")
        print(f"kernel {name}: {ms:.4f} ms, plain twin {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}){lib}, route launches "
              f"{launches.get(name, 0)}")
    print("(phase 2a: 1080p group-of-8 shapes, K3's costed form (tq_cost) "
          "and K1's fused form (intra_satd) at luma n=8, "
          "intra_rd_cands, intra_pred_selected (no route launches it) "
          "and tq_cost on the 3 rd candidates a block, commit_intra "
          f"on {TWIN_FRAMES} frame(s) with RDOQ, sao_fused and sao (the "
          "earlier two-launch form, no route launches it) on the group; "
          "phase 2b: one 1080p P "
          "frame, SR 64, two references, me_coarse and me_fine on the "
          "whole frame, the earlier forms me_full_search and me_refine on "
          "the coarse tier 16 and the 8-blocks, subpel and mc_merge on the "
          "8-blocks, mc_sel and satd on their merge candidates, "
          "commit_mixed with RDOQ, inter_pred_fused and inter_pred (the "
          "earlier form a component, no route launches it) on its P "
          "decisions; phase 2c: one 1080p B frame, two "
          "references per list, bi_select and bi_cost (no route launches "
          "it) on the 8-blocks' merge winners, inter_pred_fused_bi and "
          "inter_pred_bi (no route launches it) on its B decisions; "
          "phase 2d: cnn_depth on the 1080p group of 8 "
          f"at CTU 32, cnn_train, cnn_backward and adam on {CNN_BATCH} "
          "CTUs of 32; the K5 twins' times were taken beside the other "
          "twin jobs; cnn_depth's launches are phase 13's three timed "
          "encodes', the training kernels' phase 12's; phase 2f: an "
          "interior rank of the 1080p (2, 4) mesh, halo on its source "
          "exchange, deblock_window on its recon extended by 8 columns "
          "with P maps, sao_fused_halo and sao_halo (no route launches it) "
          "with both neighbours; their launches are "
          "phase 16's three mesh encodes'; deblock_cbf is timed in phase "
          "2b on the whole 1080p P frame)")
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s")
    kernels = [{"name": name, "route": "cuda",
                "source": f"fasthevc_tpu_torch/{src}", "replaces": rep,
                "launches": launches.get(name, 0),
                "max_abs_err": errs[name],
                "ms": timed[name][0], "plain_ms": timed[name][1],
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": lib_ms[name]}
               for name, (src, rep) in META.items()]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
