"""Exact integer T -> Q -> IQ -> IT of the intra search.

Counterpart of fasthevc_tpu/ops/transform.py tq_roundtrip_fast, the JAX
search's f32 stand-in, computed here in the exact integer form of its
tq_roundtrip (the two agree on the search's inputs; see the tests).
`tq_roundtrip` goes through kernel K3 (csrc/tq_roundtrip.cu) for CUDA
tensors; `tq_roundtrip_plain` is its PyTorch twin.
"""

from __future__ import annotations

import numpy as np
import torch

from fasthevc_tpu.spec.tables import (
    DCT_MATRICES,
    INV_QUANT_SCALES,
    MAX_TR_DYNAMIC_RANGE,
    QUANT_SCALES,
    QUANT_SHIFT,
)

from .. import _build

_DEVICE_MATS: dict = {}


def _dct(n: int, device, dtype) -> torch.Tensor:
    key = (n, str(device), dtype)
    if key not in _DEVICE_MATS:
        _DEVICE_MATS[key] = torch.from_numpy(
            np.ascontiguousarray(DCT_MATRICES[n], dtype=np.int64)
        ).to(device=device, dtype=dtype)
    return _DEVICE_MATS[key]


def _round_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    return (x + (1 << (shift - 1))) >> shift


def tq_roundtrip_plain(res: torch.Tensor, qp: int, log2_size: int,
                       bit_depth: int = 8):
    """K3's twin: res [B, N, N] -> (levels, recon residual), int32.

    The matrix stages run in float64, which is exact here (every product
    and sum stays below 2^31); shifts, clips and the quantiser are int64."""
    n = 1 << log2_size
    t = _dct(n, res.device, torch.float64)

    def mm(a, b):
        return torch.matmul(a.to(torch.float64), b.to(torch.float64)
                            ).round().to(torch.int64)

    x = res.to(torch.float64)
    shift1 = log2_size + bit_depth - 9
    tmp = mm(t, x)                                      # T @ X
    if shift1 > 0:
        tmp = _round_shift(tmp, shift1)
    coeffs = _round_shift(mm(tmp, t.T), log2_size + 6)  # (T X) @ T^T
    qbits = QUANT_SHIFT + qp // 6 + (MAX_TR_DYNAMIC_RANGE - bit_depth
                                     - log2_size)
    scale = int(QUANT_SCALES[qp % 6])
    level = ((coeffs.abs() * scale + (171 << (qbits - 9))) >> qbits)
    levels = torch.sign(coeffs) * level.clamp(0, 32767)
    bd_shift = bit_depth + log2_size - 5
    dscale = int(INV_QUANT_SCALES[qp % 6]) * 16
    deq = _round_shift((levels * dscale) << (qp // 6), bd_shift)
    deq = deq.clamp(-32768, 32767)
    e = _round_shift(mm(t.T, deq), 7).clamp(-32768, 32767)   # T^T @ D
    r = _round_shift(mm(e, t), 20 - bit_depth).clamp(-32768, 32767)
    return levels.to(torch.int32), r.to(torch.int32)


def tq_roundtrip(res: torch.Tensor, qp: int, log2_size: int,
                 bit_depth: int = 8):
    """Forward DCT, HM dead-zone quantisation (intra offset), flat-list
    dequantisation and inverse DCT of res [B, N, N] at scalar `qp`:
    returns (levels, recon residual), both [B, N, N] int32."""
    if not res.is_cuda:
        return tq_roundtrip_plain(res, qp, log2_size, bit_depth)
    n = 1 << log2_size
    res = res.to(torch.int32).contiguous()
    _build.require_cuda("tq_roundtrip", res, dtype=torch.int32)
    if res.shape[1:] != (n, n):
        raise ValueError("tq_roundtrip: res must be [B, N, N]")
    b = res.shape[0]
    levels = torch.empty_like(res)
    recon = torch.empty_like(res)
    mat = _dct(n, res.device, torch.int32)
    rc = _build.lib().fhv_tq_roundtrip(
        res.data_ptr(), mat.data_ptr(), levels.data_ptr(), recon.data_ptr(),
        b, n, log2_size, int(qp), bit_depth, _build.stream_handle(res))
    _build.LAUNCHES["tq_roundtrip"] += 1
    _build.check(rc, "tq_roundtrip")
    return levels, recon
