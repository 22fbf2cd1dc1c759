"""In-loop deblocking of intra pictures (spec 8.7.2).

Counterpart of fasthevc_tpu/ops/deblock.py `deblock_device` for the
all-intra case (BS 2 on every CU/TU edge; the P/B strengths come with the
P/B slice).  `deblock` goes through kernel K6 (csrc/deblock.cu: all
vertical edges, then all horizontal edges, one thread per 4-sample
segment) for CUDA tensors; `deblock_plain` is its PyTorch twin, the JAX
package's dense masked form: every possible segment is filtered and
masked, since same-direction edges are at least 8 samples apart and no
two segments touch the same samples.  All arithmetic is integer.
"""

from __future__ import annotations

import numpy as np
import torch

from fasthevc_tpu.spec.deblock import BETA_TABLE, TC_TABLE

from .. import _build

_TABLES: dict = {}


def _tables(device) -> tuple:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = (torch.from_numpy(np.asarray(BETA_TABLE, np.int32))
                        .to(device),
                        torch.from_numpy(np.asarray(TC_TABLE, np.int32))
                        .to(device))
    return _TABLES[key]


def edge_masks(depth: torch.Tensor, log2_ctu: int):
    """(vert, horz) bool edge maps on the 8x8 luma grid of depth maps
    [..., gh, gw], TUs of at most 32 (twin of deblock.py:25
    edge_masks_device)."""
    gh, gw = depth.shape[-2:]
    dev = depth.device
    size = (1 << log2_ctu) >> depth.to(torch.int64)
    gx = (torch.arange(gw, device=dev) * 8)[None, :]
    gy = (torch.arange(gh, device=dev) * 8)[:, None]
    max_tu = 32
    tu_size = size.clamp_max(max_tu)
    tu_left = ((gx % size) == 0) | (((gx % tu_size) == 0) & (size > max_tu))
    tu_top = ((gy % size) == 0) | (((gy % tu_size) == 0) & (size > max_tu))
    vert = tu_left & (torch.arange(gw, device=dev) > 0)[None, :]
    horz = tu_top & (torch.arange(gh, device=dev) > 0)[:, None]
    return vert, horz


def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


def _filter_vert_luma(plane, seg_mask, qp: int, bit_depth: int):
    """All vertical BS-2 luma edges of [F, H, W]; seg_mask [F, H/4, W/8]
    (twin of deblock.py:49 with bs == 2 where masked)."""
    f, h, w = plane.shape
    nh, nw = h // 4, w // 8
    max_val = (1 << bit_depth) - 1
    beta_t, tc_t = _tables(plane.device)
    x = plane.reshape(f, nh, 4, nw, 8).permute(0, 1, 3, 2, 4)
    pb = torch.roll(x, 1, dims=2)              # block c-1 sits at slot c
    blk = torch.cat([pb[..., 4:], x[..., :4]], dim=-1)
    p3, p2, p1, p0 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    q0, q1, q2, q3 = blk[..., 4], blk[..., 5], blk[..., 6], blk[..., 7]
    beta = int(beta_t[min(max(qp, 0), 51)])
    tc_s = int(tc_t[min(max(qp + 2, 0), 53)])
    tc = tc_s

    dp = (p2 - 2 * p1 + p0).abs()
    dq = (q2 - 2 * q1 + q0).abs()
    d = (dp[..., 0] + dq[..., 0]) + (dp[..., 3] + dq[..., 3])
    do_filter = seg_mask & (d < beta)

    def strong_line(i):
        return ((2 * (dp[..., i] + dq[..., i]) < (beta >> 2))
                & ((p3[..., i] - p0[..., i]).abs()
                   + (q0[..., i] - q3[..., i]).abs() < (beta >> 3))
                & ((p0[..., i] - q0[..., i]).abs() < ((5 * tc_s + 1) >> 1)))

    strong = do_filter & strong_line(0) & strong_line(3)
    weak = do_filter & ~strong
    st = strong[..., None]
    zero = torch.zeros_like(p0)
    top = torch.full_like(p0, max_val)

    sp0 = _clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                p0 - 2 * tc, p0 + 2 * tc)
    sp1 = _clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tc, p1 + 2 * tc)
    sp2 = _clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                p2 - 2 * tc, p2 + 2 * tc)
    sq0 = _clip((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                q0 - 2 * tc, q0 + 2 * tc)
    sq1 = _clip((q2 + q1 + q0 + p0 + 2) >> 2, q1 - 2 * tc, q1 + 2 * tc)
    sq2 = _clip((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
                q2 - 2 * tc, q2 + 2 * tc)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    w_ok = weak[..., None] & (delta.abs() < 10 * tc)
    dlt = delta.clamp(-tc, tc)
    wp0 = _clip(p0 + dlt, zero, top)
    wq0 = _clip(q0 - dlt, zero, top)
    side_thresh = (beta + (beta >> 1)) >> 3
    dEp = ((dp[..., 0] + dp[..., 3]) < side_thresh)[..., None]
    dEq = ((dq[..., 0] + dq[..., 3]) < side_thresh)[..., None]
    tc2 = tc >> 1
    dp1 = ((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1).clamp(-tc2, tc2)
    dq1 = ((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1).clamp(-tc2, tc2)
    wp1 = _clip(p1 + dp1, zero, top)
    wq1 = _clip(q1 + dq1, zero, top)

    np2 = torch.where(st, _clip(sp2, zero, top), p2)
    np1 = torch.where(st, _clip(sp1, zero, top),
                      torch.where(w_ok & dEp, wp1, p1))
    np0 = torch.where(st, _clip(sp0, zero, top), torch.where(w_ok, wp0, p0))
    nq0 = torch.where(st, _clip(sq0, zero, top), torch.where(w_ok, wq0, q0))
    nq1 = torch.where(st, _clip(sq1, zero, top),
                      torch.where(w_ok & dEq, wq1, q1))
    nq2 = torch.where(st, _clip(sq2, zero, top), q2)

    x = x.clone()
    x[..., 0:3] = torch.stack([nq0, nq1, nq2], dim=-1)
    x[..., 5:8] = torch.roll(torch.stack([np2, np1, np0], dim=-1), -1, dims=2)
    return x.permute(0, 1, 3, 2, 4).reshape(f, h, w)


def _filter_vert_chroma(plane, seg_mask, qp_c: int, bit_depth: int):
    """Vertical BS-2 chroma edges of [F, H, W] on the chroma 4-column grid;
    seg_mask [F, H/4, W/4] (twin of deblock.py:133)."""
    f, h, w = plane.shape
    nh, nw = h // 4, w // 4
    max_val = (1 << bit_depth) - 1
    tc = int(_tables(plane.device)[1][min(max(qp_c + 2, 0), 53)])
    x = plane.reshape(f, nh, 4, nw, 4).permute(0, 1, 3, 2, 4)
    pb = torch.roll(x, 1, dims=2)
    p1, p0 = pb[..., 2], pb[..., 3]
    q0, q1 = x[..., 0], x[..., 1]
    delta = ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3).clamp(-tc, tc)
    m = seg_mask[..., None]
    np0 = torch.where(m, (p0 + delta).clamp(0, max_val), p0)
    nq0 = torch.where(m, (q0 - delta).clamp(0, max_val), q0)
    x = x.clone()
    x[..., 0] = nq0
    x[..., 3] = torch.roll(np0, -1, dims=2)
    return x.permute(0, 1, 3, 2, 4).reshape(f, h, w)


def deblock_plain(rec_y, rec_cb, rec_cr, depth, qp: int, qp_cb: int,
                  qp_cr: int, log2_ctu: int, bit_depth: int = 8):
    """K6's twin: deblock [F, H, W] planes (int32 out) with BS 2 on every
    CU/TU edge of the depth maps [F, H/8, W/8]."""
    vert, horz = edge_masks(depth, log2_ctu)
    y = rec_y.to(torch.int32)
    y = _filter_vert_luma(y, vert.repeat_interleave(2, 1), qp, bit_depth)
    y = _filter_vert_luma(y.transpose(1, 2),
                          horz.repeat_interleave(2, 2).transpose(1, 2),
                          qp, bit_depth).transpose(1, 2)
    gh, gw = depth.shape[-2:]
    even_x = (torch.arange(gw, device=depth.device) % 2 == 0)[None, :]
    even_y = (torch.arange(gh, device=depth.device) % 2 == 0)[:, None]
    cvert, chorz = vert & even_x, horz & even_y
    out = [y.contiguous()]
    for plane, qpc in ((rec_cb, qp_cb), (rec_cr, qp_cr)):
        c = _filter_vert_chroma(plane.to(torch.int32), cvert, qpc, bit_depth)
        c = _filter_vert_chroma(c.transpose(1, 2), chorz.transpose(1, 2),
                                qpc, bit_depth).transpose(1, 2)
        out.append(c.contiguous())
    return tuple(out)


def deblock(rec_y, rec_cb, rec_cr, depth, qp: int, qp_cb: int, qp_cr: int,
            log2_ctu: int, bit_depth: int = 8, plain: bool = False):
    """Deblock F intra pictures: rec_* [F, H, W] (chroma halved; H, W
    multiples of 8), depth [F, H/8, W/8] CU depths.  Returns int32
    (y, cb, cr).  CUDA tensors go through K6 unless `plain`."""
    if plain or not rec_y.is_cuda:
        return deblock_plain(rec_y, rec_cb, rec_cr, depth, qp, qp_cb, qp_cr,
                             log2_ctu, bit_depth)
    return _deblock_cuda(rec_y, rec_cb, rec_cr, depth, qp, qp_cb, qp_cr,
                         log2_ctu, bit_depth)


def _deblock_cuda(rec_y, rec_cb, rec_cr, depth, qp, qp_cb, qp_cr, log2_ctu,
                  bit_depth):
    planes = [p.to(torch.int32).contiguous() for p in (rec_y, rec_cb,
                                                       rec_cr)]
    dm = depth.to(torch.int32).contiguous()
    _build.require_cuda("deblock", *planes, dm, dtype=torch.int32)
    f, h, w = planes[0].shape
    if planes[1].shape != (f, h // 2, w // 2) or dm.shape != (f, h // 8,
                                                              w // 8):
        raise ValueError("deblock: planes must be [F, H, W], [F, H/2, W/2] "
                         "and depth [F, H/8, W/8]")
    beta_t, tc_t = _tables(dm.device)
    lib = _build.lib()
    src = planes
    for direction in (0, 1):       # vertical edges, then horizontal
        # the kernel writes only filtered samples: start from a copy, so
        # each pass reads what the reference's pass reads
        dst = [p.clone() for p in src]
        rc = lib.fhv_deblock(
            *(p.data_ptr() for p in src), *(p.data_ptr() for p in dst),
            dm.data_ptr(), beta_t.data_ptr(), tc_t.data_ptr(), f, h, w,
            log2_ctu, int(qp), int(qp_cb), int(qp_cr), bit_depth, direction,
            _build.stream_handle(dm))
        _build.LAUNCHES["deblock"] += 1
        _build.check(rc, "deblock")
        src = dst
    return tuple(src)
