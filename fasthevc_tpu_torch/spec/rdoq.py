"""Rate-distortion optimized quantization (SURVEY.md §2.2 C5 "RDOQ").

Reference parity: HM TComTrQuant::xRateDistOptQuant — the trellis over
per-coefficient levels, coded-sub-block zeroing, and last-position
optimization, using CABAC fractional-bit costs.  Differences from HM kept
deliberately (both are encoder freedom, conformance is unaffected):

  * the rate model reads the slice-start CABAC context states (this
    pipeline quantizes whole frames before any bit is emitted, so there
    is no live coder to track; HM's own estimator also drifts from the
    true coder within a slice);
  * the context schedule (c1/c2 progression, rice adaptation, ctx_set
    selection) mirrors spec.residual.encode_residual exactly, evaluated
    greedily in the same decreasing-scan-order the real coder uses.

Distortion model: the HEVC core transform satisfies
c = 2^(15-bd-lg) x orthonormal(residual) (T = 64*sqrt(N)*O with the
normative shifts: (64^2*N) / 2^(shift1+shift2) = 2^(15-bd-lg)), so by
Parseval pixel-domain SSE = coeff SSE / 2^(2*(15-bd-lg)).  With
level_double = |c|*quantScale and e(l) = level_double - (l << qbits),
the pixel SSE contribution is e^2 / (quantScale^2 * 2^(2*tshift)),
tshift = 15 - bd - lg (sanity: the implied orthonormal-domain step
2^qbits/(quantScale*2^tshift) equals the textbook Qstep 2^((qp-4)/6)).
"""

from __future__ import annotations

import numpy as np

from .cabac import FRAC_BITS, ContextSet
from .residual import (SCAN_VER, _last_prefix_suffix, get_scan,
                       last_ctx_params, sig_ctx_inc)
from .tables import QUANT_SCALES

_BYP = 32768  # one bypass bin, 2^-15 bit units


def _bits(ctx: ContextSet, name: str, idx: int, b: int) -> int:
    state = int(ctx.state[name][idx])
    mps = int(ctx.mps[name][idx])
    return int(FRAC_BITS[state, int(b != mps)])


def _rem_bits(value: int, rice: int) -> int:
    """Bit count of coeff_abs_level_remaining (9.3.3.9), bypass bins."""
    if value < (3 << rice):
        return ((value >> rice) + 1 + rice) * _BYP
    length = rice
    v = value - (3 << rice)
    while v >= (1 << length):
        v -= 1 << length
        length += 1
    return ((3 + length + 1 - rice) + length) * _BYP


def _last_bits(ctx, pos_x: int, pos_y: int, log2_size: int,
               c_idx: int) -> int:
    g_max = (log2_size << 1) - 1
    offset, shift = last_ctx_params(log2_size, c_idx)
    total = 0
    for pos in (pos_x, pos_y):
        p, _s, slen = _last_prefix_suffix(pos)
        for i in range(p):
            total += _bits(ctx, "last_sig_coeff_prefix",
                           offset + (i >> shift), 1)
        if p < g_max:
            total += _bits(ctx, "last_sig_coeff_prefix",
                           offset + (p >> shift), 0)
        if p > 3:
            total += slen * _BYP
    return total


def _level_bits(ctx, lvl: int, k: int, c1: int, ctx_set: int,
                gt2_open: bool, rice: int, c_idx: int) -> int:
    """Rate of coding abs level lvl (>0) at sig-slot k of its CG, bypass
    sign included, per the exact encode_residual schedule."""
    total = _BYP  # sign
    if k < 8:
        base = (16 if c_idx else 0) + 4 * ctx_set + c1
        if lvl > 1:
            total += _bits(ctx, "coeff_abs_level_greater1_flag", base, 1)
            if gt2_open:
                ctx2 = (4 if c_idx else 0) + ctx_set
                total += _bits(ctx, "coeff_abs_level_greater2_flag", ctx2,
                               int(lvl > 2))
                if lvl > 2:
                    total += _rem_bits(lvl - 3, rice)
            else:
                total += _rem_bits(lvl - 2, rice)
        else:
            total += _bits(ctx, "coeff_abs_level_greater1_flag", base, 0)
    else:
        total += _rem_bits(lvl - 1, rice)
    return total


def rdoq_quantize(coeffs: np.ndarray, qp: int, bit_depth: int,
                  log2_size: int, c_idx: int, scan_idx: int,
                  lam: float, ctx: ContextSet) -> np.ndarray:
    """RDO-quantize one transform block; returns int32 levels [N, N].

    coeffs: int transform coefficients [N, N] ([y][x]); lam: pixel-SSE
    lambda; ctx: slice-start contexts for the rate model (not mutated).
    """
    size = 1 << log2_size
    scan = get_scan(log2_size, scan_idx)
    n_coeffs = size * size
    tshift = 15 - bit_depth - log2_size
    qbits = 14 + qp // 6 + tshift
    q_scale = int(QUANT_SCALES[qp % 6])
    err_scale = 1.0 / (float(q_scale) ** 2 * float(1 << (2 * tshift)))
    lam_frac = lam / _BYP  # cost of one 2^-15-bit unit

    c = coeffs[scan[:, 1], scan[:, 0]].astype(np.int64)   # scan order
    sgn = np.sign(c)
    ld = np.abs(c) * q_scale                               # level_double
    m = np.minimum((ld + (1 << (qbits - 1))) >> qbits, 32767).astype(int)

    last_init = -1
    nz = np.nonzero(m)[0]
    if len(nz) == 0:
        return np.zeros((size, size), np.int32)
    last_init = int(nz[-1])

    n_cgs = (last_init >> 4) + 1
    nsb = max(1, size // 4)
    # csbf of already-processed (higher-frequency) CGs
    csbf = np.zeros((nsb, nsb), np.int32)

    levels = np.zeros(n_coeffs, np.int64)
    cost_lv = np.zeros(n_coeffs)       # chosen D + lam*R per coded pos
    cost_zero = np.zeros(n_coeffs)     # D of level 0 (no bits)
    sig_bits1 = np.zeros(n_coeffs)     # lam cost of its sig=1 flag
    c1 = 1
    for ci in range(n_cgs - 1, -1, -1):
        cg_scan = scan[ci * 16:(ci + 1) * 16]
        sx, sy = int(cg_scan[0, 0]) >> 2, int(cg_scan[0, 1]) >> 2
        right = int(csbf[sy, sx + 1]) if sx + 1 < nsb else 0
        below = int(csbf[sy + 1, sx]) if sy + 1 < nsb else 0
        is_last_cg = ci == n_cgs - 1
        ctx_set = (2 if (ci > 0 and c_idx == 0) else 0) + (0 if c1 else 1)
        c1 = 1
        k = 0
        gt2_open = True
        rice = 0
        cg_keep = 0.0
        cg_zero = 0.0
        start = min(15, last_init - ci * 16)
        for n in range(start, -1, -1):
            p = ci * 16 + n
            x, y = int(cg_scan[n, 0]), int(cg_scan[n, 1])
            d0 = float(ld[p]) ** 2 * err_scale
            cost_zero[p] = d0
            sig_ctx = sig_ctx_inc(log2_size, c_idx, x, y, scan_idx,
                                  right, below)
            s0 = _bits(ctx, "sig_coeff_flag", sig_ctx, 0)
            s1 = _bits(ctx, "sig_coeff_flag", sig_ctx, 1)
            best_cost = d0 + lam_frac * s0
            best_lvl = 0
            if m[p] > 0:
                # defined candidate order (m, then m-1), strict < keeps the
                # earlier candidate on cost ties — mirrored bit-for-bit by
                # the C++ quantize_rdoq loop
                cands = (m[p],) if m[p] == 1 else (m[p], m[p] - 1)
                for lvl in cands:
                    e = float(ld[p] - (lvl << qbits))
                    d = e * e * err_scale
                    r = s1 + _level_bits(ctx, lvl, k, c1, ctx_set,
                                         gt2_open, rice, c_idx)
                    cst = d + lam_frac * r
                    if cst < best_cost:
                        best_cost = cst
                        best_lvl = lvl
            levels[p] = best_lvl
            cost_lv[p] = best_cost
            sig_bits1[p] = lam_frac * s1
            cg_keep += best_cost
            cg_zero += d0
            if best_lvl:
                # context schedule progression (encode_residual order)
                if k < 8:
                    if best_lvl > 1:
                        if gt2_open:
                            gt2_open = False
                        c1 = 0
                    elif 0 < c1 < 3:
                        c1 += 1
                    if best_lvl > (3 << rice) and rice < 4:
                        rice = min(rice + 1, 4)
                else:
                    if best_lvl > (3 << rice) and rice < 4:
                        rice = min(rice + 1, 4)
                k += 1
        # coded_sub_block decision (not for the last or DC group)
        cg_nz = levels[ci * 16:ci * 16 + start + 1].any()
        if not is_last_cg and ci > 0:
            cctx = min(right + below, 1) + (2 if c_idx else 0)
            b0 = lam_frac * _bits(ctx, "coded_sub_block_flag", cctx, 0)
            b1 = lam_frac * _bits(ctx, "coded_sub_block_flag", cctx, 1)
            if (not cg_nz) or cg_zero + b0 < cg_keep + b1:
                levels[ci * 16:(ci + 1) * 16] = 0
                cg_nz = False
        csbf[sy, sx] = 1 if cg_nz else 0

    # ---- last-position optimization ------------------------------------
    nz = np.nonzero(levels)[0]
    if len(nz) == 0:
        return np.zeros((size, size), np.int32)

    def last_cost(p):
        x, y = int(scan[p, 0]), int(scan[p, 1])
        if scan_idx == SCAN_VER:
            x, y = y, x
        return lam_frac * _last_bits(ctx, x, y, log2_size, c_idx)

    # moving the last down from nz[-1] to candidate nz[j]: every position
    # strictly above the new last stops being coded (its sig flag and
    # level bits vanish; its distortion becomes D0); the new last's own
    # sig flag is inferred.  Evaluate all nonzero candidates.
    best_total = None
    best_j = len(nz) - 1
    drop = 0.0  # running Sum over positions above the candidate
    for j in range(len(nz) - 1, -1, -1):
        p = int(nz[j])
        total = drop + last_cost(p) - sig_bits1[p]
        if best_total is None or total < best_total:
            best_total = total
            best_j = j
        # extend the dropped set: position p itself + zeros below it down
        # to the next nonzero
        drop += cost_zero[p] - cost_lv[p]
        lo = int(nz[j - 1]) + 1 if j > 0 else 0
        for q in range(lo, p):
            drop -= cost_lv[q] - cost_zero[q]  # zero positions: lose sig0
    new_last = int(nz[best_j])
    levels[new_last + 1:] = 0

    out = np.zeros((size, size), np.int64)
    out[scan[:, 1], scan[:, 0]] = levels * sgn
    return out.astype(np.int32)
