"""Batched RD-cost primitives of the intra search: SATD, SSE, rate proxy.

Counterpart of fasthevc_tpu/ops/cost.py.  `satd` goes through kernel K2
(csrc/satd.cu) and `sse_rate` through K4 (csrc/sse_rate.cu) for CUDA
tensors; `satd_plain` and `sse_rate_plain` are their PyTorch twins.
"""

from __future__ import annotations

import torch

from .. import _build

# Per-TB-size CABAC residual-bits model over the features [count(|l|==1),
# count(|l|==2), count(|l|>2), sum log2(1+|l|) over |l|>2,
# log2(1+last_diag), bias]; copied from fasthevc_tpu/ops/cost.py _RATE_W
# (least-squares calibrated there against the exact CABAC estimator).
_RATE_W = {
    2: (1.246, 2.654, -4.429, 4.018, 6.446, 1.447),
    3: (2.969, 2.735, -7.342, 5.811, 9.340, -4.835),
    4: (3.920, 2.018, -7.155, 5.853, 12.375, -15.337),
    5: (4.295, 1.402, -5.354, 5.323, 34.466, -117.854),
}


def _rate_weights(n: int) -> tuple:
    lg = n.bit_length() - 1
    return _RATE_W.get(lg, _RATE_W[5])


def _hadamard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Walsh-Hadamard butterflies along `dim` (size a power of two)."""
    size = x.shape[dim]
    h = 1
    while h < size:
        shp = x.shape[:dim] + (size // (2 * h), 2, h) + x.shape[dim + 1:]
        v = x.reshape(shp)
        a = v.select(dim + 1, 0)
        b = v.select(dim + 1, 1)
        x = torch.stack([a + b, a - b], dim=dim + 1).reshape(x.shape)
        h *= 2
    return x


def fma_f32(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32, as the fused multiply-add that XLA's
    CPU backend contracts `c + a * b` into (and `__fmaf_rn` on the card).
    The f64 product of two f32 values is exact; TwoSum recovers the f64
    sum's rounding error, and a sum that lands exactly halfway between two
    f32 values is nudged toward the exact one before the final rounding.
    At least one of b and c is a tensor."""
    def f64(v):
        # a 0-dim tensor or a number enters as a scalar: no host-to-device
        # copy when the others lie on the card
        if isinstance(v, torch.Tensor) and v.dim() > 0:
            return v.to(torch.float64)
        return float(v)

    p = f64(a) * f64(b)
    c64 = f64(c)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    halfway = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where(halfway & (err != 0), torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def satd_plain(src: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """K2's twin: src [B, N, N], preds [B, M, N, N] -> [B, M] int32 SATD of
    src - pred over 8x8 sub-blocks (4x4 when N == 4), each abs-sum divided
    by the sub-block size (floor), summed."""
    b, m, n, _ = preds.shape
    hb = min(8, n)
    nb = n // hb
    x = (src[:, None].to(torch.int32) - preds.to(torch.int32))
    x = x.reshape(b, m, nb, hb, nb, hb).transpose(3, 4)   # [..,nb,nb,hb,hb]
    x = _hadamard(_hadamard(x, 4), 5)
    per_block = x.abs().sum(dim=(4, 5), dtype=torch.int32) // hb
    return per_block.sum(dim=(2, 3), dtype=torch.int32)


def satd(src: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """SATD of src [B, N, N] against each of preds [B, M, N, N]: [B, M]
    int32.  The residual is formed inside the kernel."""
    if not src.is_cuda:
        return satd_plain(src, preds)
    b, m, n, _ = preds.shape
    src = src.to(torch.int32).contiguous()
    preds = preds.to(torch.int32).contiguous()
    _build.require_cuda("satd", src, preds, dtype=torch.int32)
    if src.shape != (b, n, n) or n not in (4, 8, 16, 32, 64):
        raise ValueError("satd: src [B, N, N] and preds [B, M, N, N], "
                         "N in 4..64")
    out = torch.zeros((b, m), dtype=torch.int32, device=src.device)
    rc = _build.lib().fhv_satd(src.data_ptr(), preds.data_ptr(),
                               out.data_ptr(), b, m, n,
                               _build.stream_handle(src))
    _build.launched("satd")
    _build.check(rc, "satd")
    return out


def sse_rate_plain(res: torch.Tensor, rq: torch.Tensor,
                   levels: torch.Tensor):
    """K4's twin: [B, N, N] residual, reconstructed residual and levels ->
    (dist [B] f32, rate [B] f32).  dist is the int64 SSE rounded once to
    f32; rate is the level-rate proxy of fasthevc_tpu/ops/cost.py."""
    n = levels.shape[-1]
    w = _rate_weights(n)
    d = res.to(torch.int64) - rq.to(torch.int64)
    dist = (d * d).sum(dim=(-2, -1)).to(torch.float32)
    a = levels.abs().to(torch.float32)
    nz = a > 0
    any_nz = nz.any(dim=(-2, -1))
    ar = torch.arange(n, device=levels.device, dtype=torch.float32)
    ii = ar[None, :] + ar[:, None]
    last_diag = torch.where(nz, ii, -1.0).amax(dim=(-2, -1))
    ones = (a == 1.0).sum(dim=(-2, -1)).to(torch.float32)
    twos = (a == 2.0).sum(dim=(-2, -1)).to(torch.float32)
    esc = (a > 2.0).sum(dim=(-2, -1)).to(torch.float32)
    esclog = torch.where(a > 2.0, torch.log2(1.0 + a), 0.0).sum(dim=(-2, -1))
    wf = [torch.tensor(v, dtype=torch.float32) for v in w]
    bits = (wf[0] * ones + wf[1] * twos + wf[2] * esc + wf[3] * esclog
            + wf[4] * torch.log2(1.0 + last_diag.clamp_min(0.0)) + wf[5])
    bits = torch.maximum(bits, 2.0 + ones + twos + esc)
    return dist, torch.where(any_nz, bits, 0.0)


def sse_rate(res: torch.Tensor, rq: torch.Tensor, levels: torch.Tensor):
    """Per-block SSE between res and rq and the level-rate proxy of the
    quantized levels, all [B, N, N] int32 -> (dist [B], rate [B]) f32."""
    if not res.is_cuda:
        return sse_rate_plain(res, rq, levels)
    b, n, _ = levels.shape
    res = res.to(torch.int32).contiguous()
    rq = rq.to(torch.int32).contiguous()
    levels = levels.to(torch.int32).contiguous()
    _build.require_cuda("sse_rate", res, rq, levels, dtype=torch.int32)
    if res.shape != levels.shape or rq.shape != levels.shape:
        raise ValueError("sse_rate: res, rq and levels must be [B, N, N]")
    dist = torch.empty(b, dtype=torch.float32, device=res.device)
    rate = torch.empty(b, dtype=torch.float32, device=res.device)
    rc = _build.lib().fhv_sse_rate(
        res.data_ptr(), rq.data_ptr(), levels.data_ptr(), dist.data_ptr(),
        rate.data_ptr(), b, n, n.bit_length() - 1, *_rate_weights(n),
        _build.stream_handle(res))
    _build.launched("sse_rate")
    _build.check(rc, "sse_rate")
    return dist, rate
