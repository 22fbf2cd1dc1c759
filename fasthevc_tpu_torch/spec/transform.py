"""Spec-exact integer transforms + quantization (NumPy oracle).

Reference parity: HM TLibCommon/TComTrQuant.cpp (SURVEY.md C5) —
reimplemented from H.265 spec 8.6.2-8.6.4.

All functions operate on one NxN int32 block. The *inverse* transform and
dequantization are normative (must be bit-exact for conformance); the
forward transform/quant follow the HM conventions so that encoder rate/
distortion behavior is comparable.
"""

from __future__ import annotations

import numpy as np

from .tables import (
    DCT_MATRICES,
    DST4,
    INV_QUANT_SCALES,
    MAX_TR_DYNAMIC_RANGE,
    QUANT_SCALES,
    QUANT_SHIFT,
)


def _mat(size: int, use_dst: bool) -> np.ndarray:
    if use_dst:
        assert size == 4
        return DST4
    return DCT_MATRICES[size]


def forward_transform(residual: np.ndarray, bit_depth: int = 8,
                      use_dst: bool = False) -> np.ndarray:
    """Forward core transform, HM convention (two-stage with shifts).

    residual: (N, N) int array of prediction residuals.
    Returns (N, N) int32 coefficients (16-bit range).
    """
    n = residual.shape[0]
    log2n = int(np.log2(n))
    t = _mat(n, use_dst).astype(np.int64)
    x = residual.astype(np.int64)
    shift1 = log2n + bit_depth - 9
    shift2 = log2n + 6
    # Stage 1 transforms columns (t @ x), stage 2 transforms rows.
    tmp = (t @ x + (1 << (shift1 - 1) if shift1 > 0 else 0)) >> shift1
    out = (tmp @ t.T + (1 << (shift2 - 1))) >> shift2
    return out.astype(np.int32)


def inverse_transform(coeffs: np.ndarray, bit_depth: int = 8,
                      use_dst: bool = False) -> np.ndarray:
    """Normative inverse transform (spec 8.6.4).

    Stage 1 (columns): shift 7, clip to 16-bit. Stage 2 (rows): shift
    (20 - bitDepth), clip to 16-bit. Returns (N, N) int32 residual.
    """
    n = coeffs.shape[0]
    t = _mat(n, use_dst).astype(np.int64)
    c = coeffs.astype(np.int64)
    shift1 = 7
    shift2 = 20 - bit_depth
    lo, hi = -(1 << 15), (1 << 15) - 1
    e = (t.T @ c + (1 << (shift1 - 1))) >> shift1
    e = np.clip(e, lo, hi)
    r = (e @ t + (1 << (shift2 - 1))) >> shift2
    r = np.clip(r, lo, hi)
    return r.astype(np.int32)


def forward_transform_skip(residual: np.ndarray,
                           bit_depth: int = 8) -> np.ndarray:
    """transform_skip forward path (4x4 only): coeff = res << (15 - B -
    log2TbSize) — the scale that makes the shared quant/dequant ladder
    land on the same working point as the DCT path (HM convention)."""
    return (residual.astype(np.int32) << (15 - bit_depth - 2))


def inverse_transform_skip(coeffs: np.ndarray,
                           bit_depth: int = 8) -> np.ndarray:
    """transform_skip inverse (spec 8.6.4.2): r = coeff << 7, then the
    bdShift = 20 - bitDepth rounding shift of the regular stage-2."""
    bd_shift = 20 - bit_depth
    r = (coeffs.astype(np.int64) << 7)
    out = (r + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(out, -(1 << 15), (1 << 15) - 1).astype(np.int32)


def quantize(coeffs: np.ndarray, qp: int, bit_depth: int = 8,
             is_intra: bool = True, m: np.ndarray | None = None
             ) -> np.ndarray:
    """Forward scalar quantization (HM convention, non-RDOQ).

    level = sign(c) * ((|c| * quantScale + f) >> qbits)
    with qbits = 14 + qp/6 + transformShift and f the dead-zone offset
    (intra: 171/512, inter: 85/512 of the step).
    m: optional ScalingFactor matrix (spec 8.6.3 scaling lists); the
    per-coefficient encoder scale is quantScale*16/m (HM
    xSetScalingListEnc convention, integer division).
    """
    n = coeffs.shape[0]
    log2n = int(np.log2(n))
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2n
    qbits = QUANT_SHIFT + qp // 6 + transform_shift
    scale = int(QUANT_SCALES[qp % 6])
    f = (171 if is_intra else 85) << (qbits - 9)
    c = coeffs.astype(np.int64)
    if m is None:
        level = (np.abs(c) * scale + f) >> qbits
    else:
        sc = (scale * 16) // m.astype(np.int64)
        level = (np.abs(c) * sc + f) >> qbits
    level = np.clip(level, 0, 32767)
    return (np.sign(c) * level).astype(np.int32)


def dequantize(levels: np.ndarray, qp: int, bit_depth: int = 8,
               m: np.ndarray | None = None) -> np.ndarray:
    """Normative dequantization (spec 8.6.3).

    d = Clip3(-32768, 32767,
              ((level * m * levScale[qp%6] << (qp/6)) + (1 << (bdShift-1)))
               >> bdShift)
    with bdShift = bitDepth + log2(nTbS) - 5 and m = 16 (flat) when
    scaling lists are off, else the active ScalingFactor matrix.
    """
    n = levels.shape[0]
    log2n = int(np.log2(n))
    bd_shift = bit_depth + log2n - 5
    if m is None:
        scale = int(INV_QUANT_SCALES[qp % 6]) * 16
        d = ((levels.astype(np.int64) * scale << (qp // 6))
             + (1 << (bd_shift - 1)))
    else:
        lev_scale = int(INV_QUANT_SCALES[qp % 6])
        d = ((levels.astype(np.int64) * m.astype(np.int64) * lev_scale
              << (qp // 6)) + (1 << (bd_shift - 1)))
    d >>= bd_shift
    return np.clip(d, -32768, 32767).astype(np.int32)


def transform_quantize(residual: np.ndarray, qp: int, bit_depth: int = 8,
                       use_dst: bool = False, is_intra: bool = True):
    """Full encoder path: T -> Q. Returns (levels, dequantized recon residual)."""
    coeffs = forward_transform(residual, bit_depth, use_dst)
    levels = quantize(coeffs, qp, bit_depth, is_intra)
    deq = dequantize(levels, qp, bit_depth)
    recon = inverse_transform(deq, bit_depth, use_dst)
    return levels, recon
