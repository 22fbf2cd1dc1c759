"""Spec-exact intra prediction (NumPy oracle).

Reference parity: HM TLibCommon/TComPrediction.cpp + TComPattern.cpp
(SURVEY.md C3) — reimplemented from H.265 spec 8.4.4.2.

Modes: 0 = Planar, 1 = DC, 2..34 = angular. All math is integer and
bit-exact; this module is the oracle for ops/intra.py (batched JAX).
"""

from __future__ import annotations

import numpy as np

from .tables import INTRA_FILTER_THRESH, INTRA_INV_ANGLE, INTRA_PRED_ANGLE

PLANAR, DC = 0, 1


# ---------------------------------------------------------------------------
# Availability (z-scan order, spec 6.4.1)
# ---------------------------------------------------------------------------

def _z_order(x4: int, y4: int) -> int:
    """Morton/z-order index of a 4x4-granule position within a CTU."""
    z = 0
    for b in range(8):
        z |= ((x4 >> b) & 1) << (2 * b)
        z |= ((y4 >> b) & 1) << (2 * b + 1)
    return z


def sample_available(xn: int, yn: int, x_cur: int, y_cur: int,
                     pic_w: int, pic_h: int, log2_ctu: int,
                     tile_rect=None) -> bool:
    """Is the reconstructed sample (xn, yn) available for prediction at the
    block whose top-left is (x_cur, y_cur)?  True iff inside the picture
    (and the current tile, when tiles are used) and earlier in CTU-raster +
    z-scan coding order (single slice)."""
    if xn < 0 or yn < 0 or xn >= pic_w or yn >= pic_h:
        return False
    if tile_rect is not None:
        tx0, ty0, tx1, ty1 = tile_rect
        if not (tx0 <= xn < tx1 and ty0 <= yn < ty1):
            return False
    ctu_size = 1 << log2_ctu
    ctus_per_row = (pic_w + ctu_size - 1) >> log2_ctu
    ctu_n = (yn >> log2_ctu) * ctus_per_row + (xn >> log2_ctu)
    ctu_c = (y_cur >> log2_ctu) * ctus_per_row + (x_cur >> log2_ctu)
    if ctu_n != ctu_c:
        return ctu_n < ctu_c
    zn = _z_order((xn & (ctu_size - 1)) >> 2, (yn & (ctu_size - 1)) >> 2)
    zc = _z_order((x_cur & (ctu_size - 1)) >> 2, (y_cur & (ctu_size - 1)) >> 2)
    return zn < zc


# ---------------------------------------------------------------------------
# Reference sample derivation (spec 8.4.4.2.2)
# ---------------------------------------------------------------------------

def get_reference_samples(plane: np.ndarray, x0: int, y0: int, n: int,
                          x_luma: int, y_luma: int, log2_ctu: int,
                          pic_w_luma: int, pic_h_luma: int,
                          subsample: int = 0,
                          bit_depth: int = 8,
                          tile_rect=None) -> tuple[np.ndarray, np.ndarray]:
    """Fetch + substitute the 4N+1 reference samples of an NxN block.

    plane       -- the reconstructed sample plane this block lives in
    (x0, y0)    -- block position in *plane* coordinates
    (x_luma, y_luma) -- block position in luma coordinates (for availability)
    subsample   -- 1 for 4:2:0 chroma planes (availability runs on the luma
                   grid; plane coords are half of luma coords)

    Returns (top, left):
      top  -- length 2N+1 array: [corner, p[0][-1] .. p[2N-1][-1]]
      left -- length 2N+1 array: [corner, p[-1][0] .. p[-1][2N-1]]
    """
    s = subsample
    h, w = plane.shape

    # Ordered sample list per spec substitution scan: bottom-left up the left
    # column, corner, then along the top row left->right.
    coords = []  # (x, y) in plane coords
    for y in range(2 * n - 1, -1, -1):
        coords.append((x0 - 1, y0 + y))
    coords.append((x0 - 1, y0 - 1))
    for x in range(2 * n):
        coords.append((x0 + x, y0 - 1))

    vals = np.zeros(len(coords), dtype=np.int32)
    avail = np.zeros(len(coords), dtype=bool)
    for i, (xs, ys) in enumerate(coords):
        ok = sample_available(xs << s, ys << s, x_luma, y_luma,
                              pic_w_luma, pic_h_luma, log2_ctu, tile_rect)
        if ok:
            vals[i] = plane[min(ys, h - 1), min(xs, w - 1)]
            avail[i] = True

    if not avail.any():
        vals[:] = 1 << (bit_depth - 1)
    else:
        # First sample: if unavailable, copy the first available in order.
        if not avail[0]:
            vals[0] = vals[np.argmax(avail)]
            avail[0] = True
        for i in range(1, len(coords)):
            if not avail[i]:
                vals[i] = vals[i - 1]

    left = np.empty(2 * n + 1, dtype=np.int32)
    top = np.empty(2 * n + 1, dtype=np.int32)
    left[0] = vals[2 * n]  # corner
    left[1:] = vals[2 * n - 1::-1]  # p[-1][0..2N-1]
    top[0] = vals[2 * n]
    top[1:] = vals[2 * n + 1:]
    return top, left


def filter_reference_samples(top: np.ndarray, left: np.ndarray):
    """[1 2 1]/4 smoothing of the reference samples (spec 8.4.4.2.3)."""
    n2 = len(top) - 1  # == 2N
    seq = np.concatenate([left[1:][::-1], [left[0]], top[1:]]).astype(np.int32)
    f = seq.copy()
    f[1:-1] = (seq[:-2] + 2 * seq[1:-1] + seq[2:] + 2) >> 2
    left_f = np.empty_like(left)
    top_f = np.empty_like(top)
    left_f[0] = f[n2]
    left_f[1:] = f[n2 - 1::-1]
    top_f[0] = f[n2]
    top_f[1:] = f[n2 + 1:]
    return top_f, left_f


def should_filter(mode: int, n: int, is_luma: bool) -> bool:
    """Smoothing decision (spec 8.4.4.2.3; strong smoothing not used)."""
    if not is_luma or mode == DC or n == 4:
        return False
    min_dist = min(abs(mode - 26), abs(mode - 10))
    return min_dist > INTRA_FILTER_THRESH[n]


# ---------------------------------------------------------------------------
# Predictors (spec 8.4.4.2.4-6)
# ---------------------------------------------------------------------------

def predict_planar(top: np.ndarray, left: np.ndarray, n: int) -> np.ndarray:
    log2n = int(np.log2(n))
    t = top[1:n + 1].astype(np.int64)      # p[x][-1]
    l = left[1:n + 1].astype(np.int64)     # p[-1][y]
    tr = int(top[n + 1])                   # p[N][-1]
    bl = int(left[n + 1])                  # p[-1][N]
    x = np.arange(n)
    y = np.arange(n)
    xx, yy = np.meshgrid(x, y)  # [y][x]
    pred = ((n - 1 - xx) * l[yy] + (xx + 1) * tr
            + (n - 1 - yy) * t[xx] + (yy + 1) * bl + n) >> (log2n + 1)
    return pred.astype(np.int32)


def predict_dc(top: np.ndarray, left: np.ndarray, n: int,
               is_luma: bool) -> np.ndarray:
    log2n = int(np.log2(n))
    dc = (int(top[1:n + 1].sum()) + int(left[1:n + 1].sum()) + n) >> (log2n + 1)
    pred = np.full((n, n), dc, dtype=np.int32)
    if is_luma and n < 32:
        pred[0, 0] = (int(left[1]) + 2 * dc + int(top[1]) + 2) >> 2
        pred[0, 1:] = (top[2:n + 1] + 3 * dc + 2) >> 2
        pred[1:, 0] = (left[2:n + 1] + 3 * dc + 2) >> 2
    return pred


def _predict_angular_vertical(main: np.ndarray, side: np.ndarray, n: int,
                              mode: int, angle: int) -> np.ndarray:
    """Angular prediction with the main reference on top (modes >= 18 shape).

    main -- length 2N+1: [corner, m[0], ..., m[2N-1]] (the top row)
    side -- length 2N+1: [corner, s[0], ..., s[2N-1]] (the left column)
    Returns pred[y][x].
    """
    # Build extended reference ref[k] for k in [-N .. 2N], index offset N.
    ref = np.zeros(3 * n + 1, dtype=np.int32)
    off = n
    ref[off] = main[0]  # ref[0] = corner
    ref[off + 1: off + 2 * n + 1] = main[1:2 * n + 1]
    if angle < 0:
        inv = INTRA_INV_ANGLE[mode]
        # Lowest index ever read is ((n*angle)>>5)+1 (read as ref[iIdx+1]),
        # so extend down to there only (matches HM's exclusive loop bound).
        lowest = ((n * angle) >> 5) + 1
        for k in range(-1, lowest - 1, -1):
            # project onto the side reference: side[m] = p[-1][m-1], m>=0
            idx = (k * inv + 128) >> 8
            ref[off + k] = side[idx]
    pred = np.zeros((n, n), dtype=np.int32)
    for y in range(n):
        i_idx = ((y + 1) * angle) >> 5
        i_fact = ((y + 1) * angle) & 31
        base = off + i_idx + 1
        row = ref[base: base + n].astype(np.int64)
        if i_fact == 0:
            pred[y] = row
        else:
            nxt = ref[base + 1: base + n + 1].astype(np.int64)
            pred[y] = ((32 - i_fact) * row + i_fact * nxt + 16) >> 5
    return pred


def predict_angular(top: np.ndarray, left: np.ndarray, n: int, mode: int,
                    is_luma: bool, bit_depth: int = 8) -> np.ndarray:
    angle = INTRA_PRED_ANGLE[mode]
    max_val = (1 << bit_depth) - 1
    if mode >= 18:
        pred = _predict_angular_vertical(top, left, n, mode, angle)
        if mode == 26 and is_luma and n < 32:
            # vertical edge filter on first column
            col = top[1] + ((left[1:n + 1].astype(np.int64) - int(top[0])) >> 1)
            pred[:, 0] = np.clip(col, 0, max_val)
    else:
        # Horizontal family: swap roles of top/left and transpose.
        pred = _predict_angular_vertical(left, top, n, mode, angle).T
        if mode == 10 and is_luma and n < 32:
            row = left[1] + ((top[1:n + 1].astype(np.int64) - int(left[0])) >> 1)
            pred[0, :] = np.clip(row, 0, max_val)
    return pred.astype(np.int32)


def predict(mode: int, top: np.ndarray, left: np.ndarray, n: int,
            is_luma: bool, bit_depth: int = 8) -> np.ndarray:
    """Dispatch over the 35 modes. References must already be filtered per
    should_filter()."""
    if mode == PLANAR:
        return predict_planar(top, left, n)
    if mode == DC:
        return predict_dc(top, left, n, is_luma)
    return predict_angular(top, left, n, mode, is_luma, bit_depth)


# ---------------------------------------------------------------------------
# Most-probable-mode derivation (spec 8.4.2)
# ---------------------------------------------------------------------------

def mpm_candidates(left_mode: int | None, above_mode: int | None,
                   above_in_ctu: bool) -> list[int]:
    """candModeList for luma intra mode coding.

    left_mode/above_mode: neighbor luma modes, None if unavailable or not
    intra. above_in_ctu: False forces the above candidate to DC (neighbor
    is outside the current CTU row).
    """
    a = left_mode if left_mode is not None else DC
    b = above_mode if (above_mode is not None and above_in_ctu) else DC
    if a == b:
        if a < 2:
            return [PLANAR, DC, 26]
        return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
    cands = [a, b]
    if PLANAR not in cands:
        cands.append(PLANAR)
    elif DC not in cands:
        cands.append(DC)
    else:
        cands.append(26)
    return cands
