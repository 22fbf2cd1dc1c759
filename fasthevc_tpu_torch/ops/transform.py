"""Exact integer transforms and quantisers: the search's T/Q/IQ/IT round
trip and the commit's building blocks.

Counterpart of fasthevc_tpu/ops/transform.py.  `fwd_transform`,
`inv_transform`, `quantize`, `quantize_mixed`, `dequantize` and the thin
`tq_roundtrip_plain` over them are the plain PyTorch forms of the JAX
functions of the same names; on the card the commit runs them inside
kernel K5 (csrc/commit.cu).  `tq_roundtrip` goes through kernel K3
(csrc/tq_roundtrip.cu) for CUDA tensors: the exact integer form of the JAX
search's f32 stand-in `tq_roundtrip_fast`.  K3 and K5 share one device
implementation of these stages (csrc/tq_common.cuh).

The matrix stages run in float64, which is exact here (every product and
sum stays below 2^31); shifts, clips and the quantisers are int64.
`dequantize` follows spec/transform.py where the JAX function's int32
product wraps (|level| * 1152 << qp//6 >= 2^31; ROADMAP.md queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..spec.tables import (
    DCT_MATRICES,
    DST4,
    INV_QUANT_SCALES,
    MAX_TR_DYNAMIC_RANGE,
    QUANT_SCALES,
    QUANT_SHIFT,
)

from .. import _build

_DEVICE_MATS: dict = {}


def _mat(log2_size: int, use_dst: bool, device, dtype) -> torch.Tensor:
    key = (log2_size, use_dst, str(device), dtype)
    if key not in _DEVICE_MATS:
        m = DST4 if use_dst else DCT_MATRICES[1 << log2_size]
        _DEVICE_MATS[key] = torch.from_numpy(
            np.ascontiguousarray(m, dtype=np.int64)).to(device=device,
                                                        dtype=dtype)
    return _DEVICE_MATS[key]


def _round_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    return (x + (1 << (shift - 1))) >> shift


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)
                        ).round().to(torch.int64)


def fwd_transform(res: torch.Tensor, log2_size: int, bit_depth: int = 8,
                  use_dst: bool = False) -> torch.Tensor:
    """Forward core transform of [..., N, N] residuals (int64 out)."""
    t = _mat(log2_size, use_dst, res.device, torch.float64)
    shift1 = log2_size + bit_depth - 9
    tmp = _mm(t, res)                                   # T @ X
    if shift1 > 0:
        tmp = _round_shift(tmp, shift1)
    return _round_shift(_mm(tmp, t.T), log2_size + 6)   # (T X) @ T^T


def inv_transform(coeffs: torch.Tensor, log2_size: int, bit_depth: int = 8,
                  use_dst: bool = False) -> torch.Tensor:
    """Normative inverse transform (spec 8.6.4) of [..., N, N] (int64)."""
    t = _mat(log2_size, use_dst, coeffs.device, torch.float64)
    e = _round_shift(_mm(t.T, coeffs), 7).clamp(-32768, 32767)  # T^T @ D
    return _round_shift(_mm(e, t), 20 - bit_depth).clamp(-32768, 32767)


def quantize_mixed(coeffs: torch.Tensor, qp: int, log2_size: int,
                   bit_depth: int, intra_mask: torch.Tensor) -> torch.Tensor:
    """Dead-zone quantiser with a per-block offset: 171/512 where
    intra_mask [B] is set, 85/512 elsewhere.  coeffs [B, N, N]."""
    qbits = QUANT_SHIFT + qp // 6 + (MAX_TR_DYNAMIC_RANGE - bit_depth
                                     - log2_size)
    scale = int(QUANT_SCALES[qp % 6])
    dz = torch.where(intra_mask, 171, 85).to(torch.int64)[:, None, None]
    c = coeffs.to(torch.int64)
    level = ((c.abs() * scale + (dz << (qbits - 9))) >> qbits).clamp(0, 32767)
    return torch.sign(c) * level


def quantize(coeffs: torch.Tensor, qp: int, log2_size: int,
             bit_depth: int = 8, is_intra: bool = True) -> torch.Tensor:
    """Forward scalar quantisation of [B, N, N] at one QP."""
    mask = torch.full((coeffs.shape[0],), is_intra, dtype=torch.bool,
                      device=coeffs.device)
    return quantize_mixed(coeffs, qp, log2_size, bit_depth, mask)


def dequantize(levels: torch.Tensor, qp: int, log2_size: int,
               bit_depth: int = 8) -> torch.Tensor:
    """Normative flat-list dequantisation (spec 8.6.3), int64 products."""
    bd_shift = bit_depth + log2_size - 5
    scale = int(INV_QUANT_SCALES[qp % 6]) * 16
    d = _round_shift((levels.to(torch.int64) * scale) << (qp // 6), bd_shift)
    return d.clamp(-32768, 32767)


def tq_roundtrip_plain(res: torch.Tensor, qp: int, log2_size: int,
                       bit_depth: int = 8, is_intra: bool = True):
    """K3's twin: res [B, N, N] -> (levels, recon residual), int32."""
    levels = quantize(fwd_transform(res, log2_size, bit_depth), qp,
                      log2_size, bit_depth, is_intra)
    r = inv_transform(dequantize(levels, qp, log2_size, bit_depth),
                      log2_size, bit_depth)
    return levels.to(torch.int32), r.to(torch.int32)


def tq_roundtrip(res: torch.Tensor, qp: int, log2_size: int,
                 bit_depth: int = 8, is_intra: bool = True):
    """Forward DCT, HM dead-zone quantisation (offset 171/512 intra,
    85/512 inter), flat-list dequantisation and inverse DCT of res [B, N,
    N] at scalar `qp`: returns (levels, recon residual), both [B, N, N]
    int32."""
    if not res.is_cuda:
        return tq_roundtrip_plain(res, qp, log2_size, bit_depth, is_intra)
    n = 1 << log2_size
    res = res.to(torch.int32).contiguous()
    _build.require_cuda("tq_roundtrip", res, dtype=torch.int32)
    if res.shape[1:] != (n, n):
        raise ValueError("tq_roundtrip: res must be [B, N, N]")
    b = res.shape[0]
    levels = torch.empty_like(res)
    recon = torch.empty_like(res)
    mat = _mat(log2_size, False, res.device, torch.int32)
    rc = _build.lib().fhv_tq_roundtrip(
        res.data_ptr(), mat.data_ptr(), levels.data_ptr(), recon.data_ptr(),
        b, n, log2_size, int(qp), bit_depth, 171 if is_intra else 85,
        _build.stream_handle(res))
    _build.launched("tq_roundtrip")
    _build.check(rc, "tq_roundtrip")
    return levels, recon
