"""In-loop deblocking (spec 8.7.2) of intra and P/B pictures.

Counterpart of fasthevc_tpu/ops/deblock.py `deblock_device`, with
`tu_cbf_map` and `inter_bs_maps` for the boundary strengths of P/B
pictures (intra pictures have BS 2 on every CU/TU edge).  The routes call
`deblock_fused`: kernel K6's one-launch form (csrc/deblock.cu
`fhv_deblock_fused`: a CTA a frame and 32x32 luma tile filters the tile's
vertical, then its horizontal edges in shared memory from a 4-sample halo
and writes it once, the strength of a P/B segment worked out in the kernel
from the granule maps and the CU luma cbf of `tu_cbf_ctu`, K6's cbf pass
a CTA a CTU).  `deblock` and `tu_cbf` are K6's earlier forms (all vertical
edges, then all horizontal edges, one launch each, a thread a 4-sample
segment, from copies of the planes; the cbf a thread a granule), kept
callable under their own launch counters.  `deblock_plain` is the twin of
both, the JAX package's dense masked form: every possible segment is
filtered and masked, since same-direction edges are at least 8 samples
apart and no two segments touch the same samples.  All arithmetic is
integer.  QPs may be given per frame.

The tile-column form of the sharded pipelines (fasthevc_tpu/parallel/
sharded.py `_deblock_sharded_cols`) is the same call on a tile's planes
extended by its neighbours' columns: `x0` is the global luma column of the
planes' first column and `pic_w` the picture's coded width, so the edge
tests run on global columns, and `cbf` is the halo-extended per-granule
CU cbf.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..spec.deblock import BETA_TABLE, TC_TABLE

from .. import _build
from . import per_frame

_TABLES: dict = {}


def _tables(device) -> tuple:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = (torch.from_numpy(np.asarray(BETA_TABLE, np.int32))
                        .to(device),
                        torch.from_numpy(np.asarray(TC_TABLE, np.int32))
                        .to(device))
    return _TABLES[key]


def _global_cols(gw: int, x0: int, device) -> torch.Tensor:
    """The global luma column of each granule column of a plane whose first
    column is the picture's column x0, [1, gw]."""
    return (x0 + torch.arange(gw, device=device) * 8)[None, :]


def edge_masks(depth: torch.Tensor, log2_ctu: int, x0: int = 0,
               pic_w: int | None = None):
    """(vert, horz) bool edge maps on the 8x8 luma grid of depth maps
    [..., gh, gw], TUs of at most 32 (twin of deblock.py:25
    edge_masks_device).  x0, pic_w: the global column of the maps' first
    granule and the picture's coded width (sharded.py:94-101): a vertical
    edge lies strictly inside the picture and past the plane's first
    column."""
    gh, gw = depth.shape[-2:]
    dev = depth.device
    pic_w = gw * 8 + x0 if pic_w is None else pic_w
    size = (1 << log2_ctu) >> depth.to(torch.int64)
    gx = _global_cols(gw, x0, dev)
    gy = (torch.arange(gh, device=dev) * 8)[:, None]
    max_tu = 32
    tu_size = size.clamp_max(max_tu)
    tu_left = ((gx % size) == 0) | (((gx % tu_size) == 0) & (size > max_tu))
    tu_top = ((gy % size) == 0) | (((gy % tu_size) == 0) & (size > max_tu))
    vert = tu_left & ((torch.arange(gw, device=dev) > 0)[None, :]
                      & (gx > 0) & (gx < pic_w))
    horz = tu_top & (torch.arange(gh, device=dev) > 0)[:, None]
    return vert, horz


def tu_cbf(lv_y: torch.Tensor, depth: torch.Tensor, log2_ctu: int,
           plain: bool = False) -> torch.Tensor:
    """`tu_cbf_map` as int32 [F, H/8, W/8], the `cbf` argument of
    `deblock` on P/B pictures: CUDA tensors go through K6's earlier cbf
    pass (a thread a granule) unless `plain`."""
    if plain or not lv_y.is_cuda:
        return tu_cbf_map(lv_y, depth, log2_ctu).to(torch.int32)
    lv, dm = _cbf_inputs(lv_y, depth, "deblock_cbf")
    f, h, w = lv.shape
    cbf = torch.empty((f, h // 8, w // 8), dtype=torch.int32,
                      device=lv.device)
    rc = _build.lib().fhv_deblock_cbf(lv.data_ptr(), dm.data_ptr(),
                                      cbf.data_ptr(), f, h, w, log2_ctu,
                                      _build.stream_handle(lv))
    _build.launched("deblock_cbf")
    _build.check(rc, "deblock_cbf")
    return cbf


def tu_cbf_ctu(lv_y: torch.Tensor, depth: torch.Tensor, log2_ctu: int,
               plain: bool = False) -> torch.Tensor:
    """`tu_cbf` through K6's cbf pass a CTA a CTU (every level read once,
    16 bytes at a time), the form the routes launch: int32 [F, H/8, W/8].
    CPU tensors, or `plain`, run the twin."""
    if plain or not lv_y.is_cuda:
        return tu_cbf_map(lv_y, depth, log2_ctu).to(torch.int32)
    lv, dm = _cbf_inputs(lv_y, depth, "deblock_cbf_ctu")
    if not 3 <= log2_ctu <= 6:
        raise ValueError("deblock_cbf_ctu: CTU 8 to 64")
    f, h, w = lv.shape
    cbf = torch.empty((f, h // 8, w // 8), dtype=torch.int32,
                      device=lv.device)
    rc = _build.lib().fhv_deblock_cbf_ctu(lv.data_ptr(), dm.data_ptr(),
                                          cbf.data_ptr(), f, h, w, log2_ctu,
                                          _build.stream_handle(lv))
    _build.launched("deblock_cbf_ctu")
    _build.check(rc, "deblock_cbf_ctu")
    return cbf


def _cbf_inputs(lv_y, depth, name: str) -> tuple:
    lv = lv_y.to(torch.int16).contiguous()
    dm = depth.to(torch.int32).contiguous()
    _build.require_cuda(name, lv, dtype=torch.int16)
    _build.require_cuda(name, dm, dtype=torch.int32)
    f, h, w = lv.shape
    if h % 8 or w % 8 or dm.shape != (f, h // 8, w // 8):
        raise ValueError(f"{name}: levels [F, H, W] and depth [F, H/8, "
                         "W/8], H and W multiples of 8")
    return lv, dm


def tu_cbf_map(lv_y: torch.Tensor, depth: torch.Tensor,
               log2_ctu: int) -> torch.Tensor:
    """Per-granule luma cbf of [F, H, W] levels: any nonzero level in the
    granule's CU (TU == CU), [F, H/8, W/8] bool; a CU that overflows the
    granule grid reads False, as in the reference (deblock.py:154)."""
    f, h, w = lv_y.shape
    gh, gw = h // 8, w // 8
    nz8 = (lv_y != 0).reshape(f, gh, 8, gw, 8).any(dim=4).any(dim=2)
    size = (1 << log2_ctu) >> depth.to(torch.int64)
    cbf = nz8
    n = 16
    while n <= (1 << log2_ctu):
        r = n // 8
        hh, ww = gh - gh % r, gw - gw % r
        red = (nz8[:, :hh, :ww].reshape(f, hh // r, r, ww // r, r)
               .any(dim=4).any(dim=2))
        up = red.repeat_interleave(r, 1).repeat_interleave(r, 2)
        up = torch.nn.functional.pad(up, (0, gw - ww, 0, gh - hh))
        cbf = torch.where(size == n, up, cbf)
        n *= 2
    return cbf


def inter_bs_maps(depth, dir_map, mv_map, cbf, ref_map=None):
    """Boundary strengths of [F] P/B pictures (twin of deblock.py:177):
    granule maps depth/dir/cbf [F, gh, gw], mv_map [F, gh, gw, 4] (MVs of
    unused lists are zeroed here), ref_map [F, gh, gw, 2] or None (the
    per-list reference vector is -1 for an unused list).  Returns
    (bs_vert [F, h/4, w/8], bs_horz [F, w/4, h/8]) int32; positions off
    the CU/TU edges carry strengths the edge masks suppress."""
    d = dir_map.to(torch.int64)
    mv = mv_map.to(torch.int64)
    mv = torch.cat([torch.where((d[..., None] & 1) > 0, mv[..., 0:2], 0),
                    torch.where((d[..., None] & 2) > 0, mv[..., 2:4], 0)],
                   dim=-1)
    if ref_map is None:
        r0 = r1 = torch.zeros_like(d)
    else:
        r0, r1 = ref_map[..., 0].to(torch.int64), ref_map[..., 1].to(
            torch.int64)
    refv = torch.stack([torch.where((d & 1) > 0, r0, -1),
                        torch.where((d & 2) > 0, r1, -1)], dim=-1)

    def up2(a):
        return a.repeat_interleave(2, 1).repeat_interleave(2, 2)

    intra4, ref4, cbf4, mv4 = up2(d == 0), up2(refv), up2(cbf.bool()), up2(mv)

    def bs_pairs(i4, rf4, cb4, m4):
        def shift(a):
            return torch.cat([torch.zeros_like(a[:, :, :1]), a[:, :, :-1]], 2)
        pi, qi = shift(i4)[:, :, 0::2], i4[:, :, 0::2]
        pr, qr = shift(rf4)[:, :, 0::2], rf4[:, :, 0::2]
        pc, qc = shift(cb4)[:, :, 0::2], cb4[:, :, 0::2]
        pm, qm = shift(m4)[:, :, 0::2], m4[:, :, 0::2]
        dref = (pr != qr).any(dim=-1)
        dmv = ((pm - qm).abs() >= 4).any(dim=-1)
        return torch.where(pi | qi, 2,
                           torch.where(pc | qc | dref | dmv, 1, 0))

    bs_vert = bs_pairs(intra4, ref4, cbf4, mv4)
    bs_horz = bs_pairs(intra4.transpose(1, 2), ref4.transpose(1, 2),
                       cbf4.transpose(1, 2), mv4.transpose(1, 2))
    return bs_vert.to(torch.int32), bs_horz.to(torch.int32)


def _frame_qps(qp, f: int, device) -> torch.Tensor:
    """A QP or per-frame QPs as an int64 [F, 1, 1] tensor."""
    return torch.tensor([int(v) for v in per_frame(qp, f)],
                        dtype=torch.int64, device=device)[:, None, None]


def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


def _filter_vert_luma(plane, seg_mask, seg_bs, qp, bit_depth: int):
    """All vertical luma edges of [F, H, W]; seg_mask, seg_bs [F, H/4,
    W/8] (twin of deblock.py:49); qp [F, 1, 1]."""
    f, h, w = plane.shape
    nh, nw = h // 4, w // 8
    max_val = (1 << bit_depth) - 1
    beta_t, tc_t = _tables(plane.device)
    x = plane.reshape(f, nh, 4, nw, 8).permute(0, 1, 3, 2, 4)
    pb = torch.roll(x, 1, dims=2)              # block c-1 sits at slot c
    blk = torch.cat([pb[..., 4:], x[..., :4]], dim=-1)
    p3, p2, p1, p0 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    q0, q1, q2, q3 = blk[..., 4], blk[..., 5], blk[..., 6], blk[..., 7]
    beta = beta_t[qp.clamp(0, 51)]                          # [F, 1, 1]
    bs = seg_bs.to(torch.int64)
    tc_s = tc_t[(qp + 2 * (bs - 1)).clamp(0, 53)]           # [F, nh, nw]
    tc = tc_s[..., None]

    dp = (p2 - 2 * p1 + p0).abs()
    dq = (q2 - 2 * q1 + q0).abs()
    d = (dp[..., 0] + dq[..., 0]) + (dp[..., 3] + dq[..., 3])
    do_filter = seg_mask & (bs > 0) & (d < beta)

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
    dlt = torch.minimum(torch.maximum(delta, -tc), tc)
    wp0 = _clip(p0 + dlt, zero, top)
    wq0 = _clip(q0 - dlt, zero, top)
    side_thresh = (beta + (beta >> 1)) >> 3
    dEp = ((dp[..., 0] + dp[..., 3]) < side_thresh)[..., None]
    dEq = ((dq[..., 0] + dq[..., 3]) < side_thresh)[..., None]
    tc2 = tc >> 1
    dp1 = _clip(((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1), -tc2, tc2)
    dq1 = _clip(((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1), -tc2, tc2)
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


def _filter_vert_chroma(plane, seg_mask, qp_c, bit_depth: int):
    """Vertical BS-2 chroma edges of [F, H, W] on the chroma 4-column grid;
    seg_mask [F, H/4, W/4] (twin of deblock.py:133); qp_c [F, 1, 1]."""
    f, h, w = plane.shape
    nh, nw = h // 4, w // 4
    max_val = (1 << bit_depth) - 1
    tc = _tables(plane.device)[1][(qp_c + 2).clamp(0, 53)][..., None]
    x = plane.reshape(f, nh, 4, nw, 4).permute(0, 1, 3, 2, 4)
    pb = torch.roll(x, 1, dims=2)
    p1, p0 = pb[..., 2], pb[..., 3]
    q0, q1 = x[..., 0], x[..., 1]
    delta = _clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    m = seg_mask[..., None]
    np0 = torch.where(m, (p0 + delta).clamp(0, max_val), p0)
    nq0 = torch.where(m, (q0 - delta).clamp(0, max_val), q0)
    x = x.clone()
    x[..., 0] = nq0
    x[..., 3] = torch.roll(np0, -1, dims=2)
    return x.permute(0, 1, 3, 2, 4).reshape(f, h, w)


def deblock_plain(rec_y, rec_cb, rec_cr, depth, qp, qp_cb, qp_cr,
                  log2_ctu: int, bit_depth: int = 8, bs_vert=None,
                  bs_horz=None, x0: int = 0, pic_w: int | None = None):
    """K6's twin: deblock [F, H, W] planes (int32 out) on the CU/TU edges
    of the depth maps [F, H/8, W/8]: BS 2 everywhere, or the strengths
    bs_vert [F, H/4, W/8] / bs_horz [F, W/4, H/8] of P/B pictures, where a
    chroma edge is filtered only where the luma BS is 2.  x0, pic_w: the
    tile-column form's global position of the planes (`edge_masks`)."""
    f = rec_y.shape[0]
    dev = rec_y.device
    qy, qcb, qcr = (_frame_qps(v, f, dev) for v in (qp, qp_cb, qp_cr))
    vert, horz = edge_masks(depth, log2_ctu, x0, pic_w)
    vseg = vert.repeat_interleave(2, 1)
    hseg = horz.repeat_interleave(2, 2).transpose(1, 2)
    bsv = bs_vert if bs_vert is not None else torch.where(vseg, 2, 0)
    bsh = bs_horz if bs_horz is not None else torch.where(hseg, 2, 0)
    y = _filter_vert_luma(rec_y.to(torch.int64), vseg, bsv, qy, bit_depth)
    y = _filter_vert_luma(y.transpose(1, 2), hseg, bsh, qy,
                          bit_depth).transpose(1, 2)
    gh, gw = depth.shape[-2:]
    even_x = _global_cols(gw, x0, dev) % 16 == 0
    even_y = (torch.arange(gh, device=dev) % 2 == 0)[:, None]
    cvert, chorz = vert & even_x, horz & even_y
    if bs_vert is not None:
        cvert = cvert & (bs_vert[:, 0::2] == 2)
    if bs_horz is not None:
        chorz = chorz & (bs_horz[:, 0::2] == 2).transpose(1, 2)
    out = [y.to(torch.int32).contiguous()]
    for plane, qpc in ((rec_cb, qcb), (rec_cr, qcr)):
        c = _filter_vert_chroma(plane.to(torch.int64), cvert, qpc, bit_depth)
        c = _filter_vert_chroma(c.transpose(1, 2), chorz.transpose(1, 2),
                                qpc, bit_depth).transpose(1, 2)
        out.append(c.to(torch.int32).contiguous())
    return tuple(out)


def deblock(rec_y, rec_cb, rec_cr, depth, qp, qp_cb, qp_cr, log2_ctu: int,
            bit_depth: int = 8, plain: bool = False, dir_map=None,
            mv_map=None, ref_map=None, cbf=None, x0: int = 0,
            pic_w: int | None = None):
    """Deblock F pictures: rec_* [F, H, W] (chroma halved; H, W multiples
    of 8), depth [F, H/8, W/8] CU depths, QPs scalar or per frame.  Intra
    pictures have BS 2 on every CU/TU edge; P/B pictures give dir_map [F,
    H/8, W/8], mv_map [F, H/8, W/8, 4], ref_map [F, H/8, W/8, 2] (or None)
    and the per-granule CU luma cbf `cbf` [F, H/8, W/8] (`tu_cbf` of their
    levels), from which the strengths follow (deblock.py:283-289).  x0,
    pic_w: the global luma column
    of the planes' first column and the picture's coded width (the
    tile-column form; defaults 0 and W).  Returns int32 (y, cb, cr) of the
    planes given.  CUDA tensors go through K6's earlier form (two launches
    on copies of the planes) unless `plain`."""
    if plain or not rec_y.is_cuda:
        bsv = bsh = None
        if dir_map is not None:
            bsv, bsh = inter_bs_maps(depth, dir_map, mv_map, cbf, ref_map)
        return deblock_plain(rec_y, rec_cb, rec_cr, depth, qp, qp_cb, qp_cr,
                             log2_ctu, bit_depth, bsv, bsh, x0, pic_w)
    return _deblock_cuda(rec_y, rec_cb, rec_cr, depth, qp, qp_cb, qp_cr,
                         log2_ctu, bit_depth, dir_map, mv_map, ref_map, cbf,
                         x0, pic_w)


def deblock_fused(rec_y, rec_cb, rec_cr, depth, qp, qp_cb, qp_cr,
                  log2_ctu: int, bit_depth: int = 8, plain: bool = False,
                  dir_map=None, mv_map=None, ref_map=None, cbf=None,
                  x0: int = 0, pic_w: int | None = None):
    """`deblock` in one launch a call of up to 8 frames (K6's one-launch
    form: a CTA a frame and 32x32 luma tile, into fresh planes, the QPs
    passed by value); arguments and result as `deblock`, `cbf` from
    `tu_cbf_ctu` (or `tu_cbf`).  CPU tensors, or `plain`, run the twin."""
    if plain or not rec_y.is_cuda:
        return deblock(rec_y, rec_cb, rec_cr, depth, qp, qp_cb, qp_cr,
                       log2_ctu, bit_depth, True, dir_map, mv_map, ref_map,
                       cbf, x0, pic_w)
    planes, dm, maps, pic_w, name = _cuda_inputs(
        rec_y, rec_cb, rec_cr, depth, dir_map, mv_map, ref_map, cbf, x0,
        pic_w, "deblock_fused", strided=True)
    f, h, w = planes[0].shape
    qps = [int(v) for trio in zip(*(per_frame(v, f)
                                    for v in (qp, qp_cb, qp_cr)))
           for v in trio]
    host_qps = (ctypes.c_int * len(qps))(*qps)
    beta_t, tc_t = _tables(dm.device)
    # the kernel writes contiguous planes, whatever the inputs' layout
    outs = [torch.empty(p.shape, dtype=torch.int32, device=p.device)
            for p in planes]
    rc = _build.lib().fhv_deblock_fused(
        *(p.data_ptr() for p in planes), planes[0].stride(1),
        planes[1].stride(1), planes[0].stride(0), planes[1].stride(0),
        *(p.data_ptr() for p in outs), dm.data_ptr(),
        *(None if t is None else t.data_ptr() for t in maps),
        beta_t.data_ptr(), tc_t.data_ptr(), ctypes.addressof(host_qps), f,
        h, w, log2_ctu, bit_depth, x0, pic_w, _build.stream_handle(dm))
    # one launch a group of 8 frames (the QPs' by-value table)
    _build.launched(name, -(-f // 8))
    _build.check(rc, name)
    return tuple(outs)


def _vector_rows(p: torch.Tensor) -> bool:
    """Whether an int32 plane stack's rows are runs of 16-byte vectors
    (contiguous rows; row pitch and frame stride multiples of 4 samples;
    16-byte aligned), as K6's one-launch form reads them."""
    return (p.stride(2) == 1 and p.stride(1) % 4 == 0
            and (p.shape[0] == 1 or p.stride(0) % 4 == 0)
            and p.data_ptr() % 16 == 0)


def _cuda_inputs(rec_y, rec_cb, rec_cr, depth, dir_map, mv_map, ref_map,
                 cbf, x0, pic_w, name: str, strided: bool = False) -> tuple:
    """The kernels' int32 planes, depth and P/B maps (None on intra
    pictures), checked, all contiguous but, with `strided`, planes whose
    rows are runs of 16-byte vectors (the commit's row crops: the chroma
    planes share a layout); the picture's width; the launch counter's name
    (P/B pictures, whose strengths the kernel works out, and the
    tile-column form count apart from the intra ones)."""
    planes = [p.to(torch.int32) for p in (rec_y, rec_cb, rec_cr)]
    if not (strided and all(_vector_rows(p) for p in planes)
            and planes[1].stride() == planes[2].stride()):
        planes = [p.contiguous() for p in planes]
    dm = depth.to(torch.int32).contiguous()
    _build.require_cuda(name, dm, dtype=torch.int32)
    if any(p.device != dm.device for p in planes):
        raise ValueError(f"{name}: all tensors must be on {dm.device}")
    f, h, w = planes[0].shape
    if (h % 8 or w % 8 or planes[1].shape != (f, h // 2, w // 2)
            or dm.shape != (f, h // 8, w // 8)):
        raise ValueError(f"{name}: planes must be [F, H, W], [F, H/2, W/2]"
                         " and depth [F, H/8, W/8], H and W multiples of 8")
    maps = (None, None, None, None)
    if dir_map is not None:
        im = dir_map.to(torch.int32).contiguous()
        mv = mv_map.to(torch.int32).contiguous()
        rm = (None if ref_map is None
              else ref_map.to(torch.int32).contiguous())
        nz = cbf.to(torch.int32).contiguous()
        _build.require_cuda(name, im, mv, nz,
                            *([] if rm is None else [rm]), dtype=torch.int32)
        if im.shape != dm.shape or mv.shape != dm.shape + (4,):
            raise ValueError(f"{name}: dir [F, H/8, W/8], mv [F, H/8, W/8, "
                             "4]")
        if nz.shape != dm.shape:
            raise ValueError(f"{name}: cbf [F, H/8, W/8]")
        maps = (im, mv, rm, nz)
    pic_w = w + x0 if pic_w is None else pic_w
    window = (x0, pic_w) != (0, w)
    name += "_window" if window else "" if dir_map is None else "_bs"
    return planes, dm, maps, pic_w, name


def _deblock_cuda(rec_y, rec_cb, rec_cr, depth, qp, qp_cb, qp_cr, log2_ctu,
                  bit_depth, dir_map, mv_map, ref_map, cbf, x0, pic_w):
    planes, dm, maps, pic_w, name = _cuda_inputs(
        rec_y, rec_cb, rec_cr, depth, dir_map, mv_map, ref_map, cbf, x0,
        pic_w, "deblock")
    f, h, w = planes[0].shape
    dev = dm.device
    qps = _build.upload(torch.cat([_frame_qps(v, f, "cpu")
                                   for v in (qp, qp_cb, qp_cr)], dim=1)
                        .reshape(f, 3).to(torch.int32), dev)
    beta_t, tc_t = _tables(dev)
    lib = _build.lib()
    stream = _build.stream_handle(dm)
    src = planes
    for direction in (0, 1):       # vertical edges, then horizontal
        # the kernel writes only filtered samples: start from a copy, so
        # each pass reads what the reference's pass reads
        dst = [p.clone() for p in src]
        rc = lib.fhv_deblock(
            *(p.data_ptr() for p in src), *(p.data_ptr() for p in dst),
            dm.data_ptr(), *(None if t is None else t.data_ptr()
                             for t in maps),
            beta_t.data_ptr(), tc_t.data_ptr(), qps.data_ptr(), f, h, w,
            log2_ctu, bit_depth, direction, x0, pic_w, stream)
        _build.launched(name)
        _build.check(rc, name)
        src = dst
    return tuple(src)
