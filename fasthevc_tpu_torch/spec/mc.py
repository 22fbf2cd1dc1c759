"""Motion compensation: HEVC interpolation filters (spec 8.5.4).

Reference parity: HM TComPrediction::motionCompensation +
TComInterpolationFilter (SURVEY.md C4). Luma: 8-tap filters at quarter-pel
positions; chroma: 4-tap at eighth-pel.

The *_raw functions return the spec's 14-bit intermediate predSampleLX
values; uni-prediction rounds them with (x + 32) >> 6 and bi-prediction
averages two lists with (a + b + 64) >> 7 (8-bit depth), per the weighted
sample process defaults (spec 8.5.4.3.5).

Out-of-picture references use edge clamping (equivalent to the spec's
padded reference pictures).
"""

from __future__ import annotations

import numpy as np

# Luma quarter-pel filter coefficients (spec Table 8-11), index = frac.
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# Chroma eighth-pel filter coefficients (spec Table 8-12), index = frac.
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)


def _fetch(ref: np.ndarray, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """Fetch a w x h window at (x0, y0) with edge clamping."""
    ph, pw = ref.shape
    ys = np.clip(np.arange(y0, y0 + h), 0, ph - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, pw - 1)
    return ref[np.ix_(ys, xs)]


def mc_luma_raw(ref: np.ndarray, x: int, y: int, w: int, h: int,
                mv_x: int, mv_y: int, bit_depth: int = 8) -> np.ndarray:
    """14-bit intermediate luma prediction (spec 8.5.4.2.2.1)."""
    ix, iy = x + (mv_x >> 2), y + (mv_y >> 2)
    fx, fy = mv_x & 3, mv_y & 3
    shift1 = bit_depth - 8
    shift3 = 14 - bit_depth
    if fx == 0 and fy == 0:
        return _fetch(ref, ix, iy, w, h).astype(np.int64) << shift3
    if fy == 0:
        win = _fetch(ref, ix - 3, iy, w + 7, h).astype(np.int64)
        f = LUMA_FILTERS[fx]
        acc = sum(int(f[k]) * win[:, k:k + w] for k in range(8))
        return acc >> shift1
    if fx == 0:
        win = _fetch(ref, ix, iy - 3, w, h + 7).astype(np.int64)
        f = LUMA_FILTERS[fy]
        acc = sum(int(f[k]) * win[k:k + h, :] for k in range(8))
        return acc >> shift1
    win = _fetch(ref, ix - 3, iy - 3, w + 7, h + 7).astype(np.int64)
    fh = LUMA_FILTERS[fx]
    tmp = sum(int(fh[k]) * win[:, k:k + w] for k in range(8)) >> shift1
    fv = LUMA_FILTERS[fy]
    acc = sum(int(fv[k]) * tmp[k:k + h, :] for k in range(8))
    return acc >> 6


def mc_chroma_raw(ref: np.ndarray, x: int, y: int, w: int, h: int,
                  mv_x: int, mv_y: int, bit_depth: int = 8) -> np.ndarray:
    """14-bit intermediate chroma prediction (eighth-pel on the chroma
    grid; mv in luma quarter-pel units)."""
    ix, iy = x + (mv_x >> 3), y + (mv_y >> 3)
    fx, fy = mv_x & 7, mv_y & 7
    shift1 = bit_depth - 8
    shift3 = 14 - bit_depth
    if fx == 0 and fy == 0:
        return _fetch(ref, ix, iy, w, h).astype(np.int64) << shift3
    if fy == 0:
        win = _fetch(ref, ix - 1, iy, w + 3, h).astype(np.int64)
        f = CHROMA_FILTERS[fx]
        acc = sum(int(f[k]) * win[:, k:k + w] for k in range(4))
        return acc >> shift1
    if fx == 0:
        win = _fetch(ref, ix, iy - 1, w, h + 3).astype(np.int64)
        f = CHROMA_FILTERS[fy]
        acc = sum(int(f[k]) * win[k:k + h, :] for k in range(4))
        return acc >> shift1
    win = _fetch(ref, ix - 1, iy - 1, w + 3, h + 3).astype(np.int64)
    fh = CHROMA_FILTERS[fx]
    tmp = sum(int(fh[k]) * win[:, k:k + w] for k in range(4)) >> shift1
    fv = CHROMA_FILTERS[fy]
    acc = sum(int(fv[k]) * tmp[k:k + h, :] for k in range(4))
    return acc >> 6


def _uni(raw: np.ndarray, bit_depth: int) -> np.ndarray:
    shift = 14 - bit_depth  # 6 for 8-bit
    off = 1 << (shift - 1)
    return np.clip((raw + off) >> shift, 0,
                   (1 << bit_depth) - 1).astype(np.int32)


def _bi(raw0: np.ndarray, raw1: np.ndarray, bit_depth: int) -> np.ndarray:
    shift = 15 - bit_depth  # 7 for 8-bit
    off = 1 << (shift - 1)
    return np.clip((raw0 + raw1 + off) >> shift, 0,
                   (1 << bit_depth) - 1).astype(np.int32)


def _uni_w(raw: np.ndarray, w: int, o: int, log2_denom: int,
           bit_depth: int) -> np.ndarray:
    """Explicit weighted uni-prediction (spec 8.5.3.3.4.3).  With the
    default weight (w = 1 << denom, o = 0) this is bit-identical to
    _uni: (raw*2^d + 2^(log2Wd-1)) >> log2Wd == (raw + 32) >> 6."""
    log2_wd = log2_denom + (14 - bit_depth)
    off = 1 << (log2_wd - 1)
    return np.clip(((raw * w + off) >> log2_wd) + o, 0,
                   (1 << bit_depth) - 1).astype(np.int32)


def _bi_w(raw0: np.ndarray, raw1: np.ndarray, w0: int, o0: int,
          w1: int, o1: int, log2_denom: int, bit_depth: int) -> np.ndarray:
    """Explicit weighted bi-prediction (spec 8.5.3.3.4.3); default
    weights reduce bit-exactly to _bi."""
    log2_wd = log2_denom + (14 - bit_depth)
    return np.clip(
        (raw0 * w0 + raw1 * w1 + ((o0 + o1 + 1) << log2_wd))
        >> (log2_wd + 1),
        0, (1 << bit_depth) - 1).astype(np.int32)


def mc_luma(ref: np.ndarray, x: int, y: int, w: int, h: int,
            mv_x: int, mv_y: int, bit_depth: int = 8) -> np.ndarray:
    """Uni-prediction luma block (final sample values)."""
    return _uni(mc_luma_raw(ref, x, y, w, h, mv_x, mv_y, bit_depth),
                bit_depth)


def mc_chroma(ref: np.ndarray, x: int, y: int, w: int, h: int,
              mv_x: int, mv_y: int, bit_depth: int = 8) -> np.ndarray:
    return _uni(mc_chroma_raw(ref, x, y, w, h, mv_x, mv_y, bit_depth),
                bit_depth)


def mc_cu(planes_ref, x: int, y: int, size: int, mv, bit_depth: int = 8):
    """Full-CU uni-prediction: returns (pred_y, pred_cb, pred_cr)."""
    mvx, mvy = int(mv[0]), int(mv[1])
    py = mc_luma(planes_ref.y, x, y, size, size, mvx, mvy, bit_depth)
    pcb = mc_chroma(planes_ref.cb, x >> 1, y >> 1, size >> 1, size >> 1,
                    mvx, mvy, bit_depth)
    pcr = mc_chroma(planes_ref.cr, x >> 1, y >> 1, size >> 1, size >> 1,
                    mvx, mvy, bit_depth)
    return py, pcb, pcr


def mc_cu_motion(motion, refs_l0, refs_l1, x: int, y: int, size: int,
                 bit_depth: int = 8, wp=None):
    """Full-CU prediction for a Motion (L0 / L1 / BI) given both ref lists.

    refs_lX: list of Planes for each list. Returns (y, cb, cr) int32.
    wp: spec.wp.WpTables for explicit weighted prediction (None = the
    default weighted sample process, i.e. plain uni/bi rounding).
    """
    from .inter import DIR_L0, DIR_L1

    cs = size >> 1
    cx, cy = x >> 1, y >> 1
    if motion.inter_dir == DIR_L0 and wp is None:
        return mc_cu(refs_l0[motion.ref0], x, y, size,
                     motion.mv0, bit_depth)
    if motion.inter_dir == DIR_L1 and wp is None:
        return mc_cu(refs_l1[motion.ref1], x, y, size,
                     motion.mv1, bit_depth)
    if motion.inter_dir in (DIR_L0, DIR_L1):
        li = 0 if motion.inter_dir == DIR_L0 else 1
        ref = (refs_l0[motion.ref0] if li == 0
               else refs_l1[motion.ref1])
        mv = motion.mv0 if li == 0 else motion.mv1
        e = (wp.l0 if li == 0 else wp.l1)[
            motion.ref0 if li == 0 else motion.ref1]
        py = _uni_w(mc_luma_raw(ref.y, x, y, size, size, mv[0], mv[1],
                                bit_depth),
                    e.w_y, e.o_y, wp.log2_denom_y, bit_depth)
        pcb = _uni_w(mc_chroma_raw(ref.cb, cx, cy, cs, cs, mv[0], mv[1],
                                   bit_depth),
                     e.w_cb, e.o_cb, wp.log2_denom_c, bit_depth)
        pcr = _uni_w(mc_chroma_raw(ref.cr, cx, cy, cs, cs, mv[0], mv[1],
                                   bit_depth),
                     e.w_cr, e.o_cr, wp.log2_denom_c, bit_depth)
        return py, pcb, pcr
    # BI: average (or explicitly weight) the 14-bit intermediates
    r0 = refs_l0[motion.ref0]
    r1 = refs_l1[motion.ref1]
    mv0, mv1 = motion.mv0, motion.mv1
    ry0 = mc_luma_raw(r0.y, x, y, size, size, mv0[0], mv0[1], bit_depth)
    ry1 = mc_luma_raw(r1.y, x, y, size, size, mv1[0], mv1[1], bit_depth)
    rcb0 = mc_chroma_raw(r0.cb, cx, cy, cs, cs, mv0[0], mv0[1], bit_depth)
    rcb1 = mc_chroma_raw(r1.cb, cx, cy, cs, cs, mv1[0], mv1[1], bit_depth)
    rcr0 = mc_chroma_raw(r0.cr, cx, cy, cs, cs, mv0[0], mv0[1], bit_depth)
    rcr1 = mc_chroma_raw(r1.cr, cx, cy, cs, cs, mv1[0], mv1[1], bit_depth)
    if wp is None:
        return (_bi(ry0, ry1, bit_depth), _bi(rcb0, rcb1, bit_depth),
                _bi(rcr0, rcr1, bit_depth))
    e0 = wp.l0[motion.ref0]
    e1 = wp.l1[motion.ref1]
    py = _bi_w(ry0, ry1, e0.w_y, e0.o_y, e1.w_y, e1.o_y,
               wp.log2_denom_y, bit_depth)
    pcb = _bi_w(rcb0, rcb1, e0.w_cb, e0.o_cb, e1.w_cb, e1.o_cb,
                wp.log2_denom_c, bit_depth)
    pcr = _bi_w(rcr0, rcr1, e0.w_cr, e0.o_cr, e1.w_cr, e1.o_cr,
                wp.log2_denom_c, bit_depth)
    return py, pcb, pcr
