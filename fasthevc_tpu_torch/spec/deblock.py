"""In-loop deblocking filter (spec 8.7.2) — vectorized NumPy.

Reference parity: HM TComLoopFilter (SURVEY.md C8). Vectorized over all
edge segments at once (adjacent same-direction edges are >= 8 samples apart
so they never overlap — fully parallel, the same property the TPU kernel
exploits).

Scope: intra pictures (boundary strength 2 on all coding-block edges).
Inter BS derivation (MV/ref differences) extends `edge_bs` when inter
arrives. Lossless (transquant-bypass) pictures skip filtering entirely.
"""

from __future__ import annotations

import numpy as np

BETA_TABLE = np.array(
    [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
                26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54,
                56, 58, 60, 62, 64], dtype=np.int32)

TC_TABLE = np.array(
    [0] * 18 + [1] * 9 + [2] * 4 + [3] * 4 + [4] * 3 + [5] * 2 + [6] * 2
    + [7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24], dtype=np.int32)


def cu_size_map(depth_map: np.ndarray, log2_ctu: int) -> np.ndarray:
    """Per-8x8-granule CU size in luma samples from the CU depth map."""
    return (1 << log2_ctu) >> depth_map.astype(np.int32)


def edge_flags(depth_map: np.ndarray, log2_ctu: int, log2_max_tu: int = 5,
               tusplit: np.ndarray | None = None):
    """Derive (vert_edges, horz_edges) bool maps on the 8x8 luma grid.

    vert_edges[gy, gx] True => a deblockable vertical edge at luma column
    gx*8 crossing rows gy*8..gy*8+7 (CU or TU boundary). Picture-boundary
    edges excluded.

    tusplit: optional bool [gh, gw] per-8x8-granule map of CUs whose TU
    is split once (depth-1 RQT): adds the interior half-offset TU edges
    (spec 8.7.1 transform-block edges).
    """
    gh, gw = depth_map.shape
    size = cu_size_map(depth_map, log2_ctu)
    gx = np.arange(gw) * 8
    gy = np.arange(gh) * 8
    # CU left/top boundary at a granule: granule origin aligned to CU size
    cu_left = (gx[None, :] % size) == 0
    cu_top = (gy[:, None] % size) == 0
    # TU boundary: forced RQT split of 64x64 CUs adds 32-aligned edges
    max_tu = 1 << log2_max_tu
    tu_left = cu_left | (((gx[None, :] % np.minimum(size, max_tu)) == 0)
                         & (size > max_tu))
    tu_top = cu_top | (((gy[:, None] % np.minimum(size, max_tu)) == 0)
                       & (size > max_tu))
    if tusplit is not None:
        half = np.maximum(size >> 1, 8)
        tu_left |= tusplit & ((gx[None, :] % half) == 0)
        tu_top |= tusplit & ((gy[:, None] % half) == 0)
    vert = tu_left.copy()
    horz = tu_top.copy()
    vert[:, 0] = False  # picture boundary
    horz[0, :] = False
    return vert, horz


def _clip(v, lo, hi):
    return np.minimum(np.maximum(v, lo), hi)


def _filter_luma_edges(plane: np.ndarray, seg_y: np.ndarray,
                       seg_x: np.ndarray, qp: int, max_val: int,
                       bs: np.ndarray | None = None,
                       beta_offset: int = 0, tc_offset: int = 0) -> None:
    """Filter vertical luma edges at (seg_y, seg_x): 4-row segments whose
    p/q samples are plane[seg_y+i, seg_x-4 .. seg_x+3]. In-place.

    bs: per-segment boundary strength (1 or 2); defaults to 2 (intra)."""
    if len(seg_x) == 0:
        return
    beta = int(BETA_TABLE[np.clip(qp + beta_offset, 0, 51)])
    if bs is None:
        bs = np.full(len(seg_x), 2, dtype=np.int64)
    tc_s = TC_TABLE[np.clip(qp + 2 * (np.asarray(bs) - 1) + tc_offset,
                            0, 53)].astype(np.int64)         # [S]
    tc = tc_s[:, None]                                       # [S, 1]
    if beta == 0:
        return
    rows = seg_y[:, None] + np.arange(4)[None, :]       # [S, 4]
    cols = seg_x[:, None] + np.arange(-4, 4)[None, :]   # [S, 8]
    # block: [S, 4, 8] = p3 p2 p1 p0 q0 q1 q2 q3
    blk = plane[rows[:, :, None], cols[:, None, :]].astype(np.int64)
    p3, p2, p1, p0 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    q0, q1, q2, q3 = blk[..., 4], blk[..., 5], blk[..., 6], blk[..., 7]

    dp = np.abs(p2 - 2 * p1 + p0)     # [S, 4]
    dq = np.abs(q2 - 2 * q1 + q0)
    dpq0 = dp[:, 0] + dq[:, 0]
    dpq3 = dp[:, 3] + dq[:, 3]
    d = dpq0 + dpq3                    # [S]
    do_filter = d < beta

    def strong_line(i):
        return ((2 * (dp[:, i] + dq[:, i]) < (beta >> 2))
                & (np.abs(p3[:, i] - p0[:, i])
                   + np.abs(q0[:, i] - q3[:, i]) < (beta >> 3))
                & (np.abs(p0[:, i] - q0[:, i]) < ((5 * tc_s + 1) >> 1)))

    strong = do_filter & strong_line(0) & strong_line(3)   # [S]
    weak = do_filter & ~strong

    st = strong[:, None]
    # ---- strong filter ----
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

    # ---- weak filter ----
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4     # [S, 4]
    w_ok = weak[:, None] & (np.abs(delta) < 10 * tc)
    dlt = _clip(delta, -tc, tc)
    wp0 = _clip(p0 + dlt, 0, max_val)
    wq0 = _clip(q0 - dlt, 0, max_val)
    side_thresh = (beta + (beta >> 1)) >> 3
    dEp = (dp[:, 0] + dp[:, 3]) < side_thresh            # [S]
    dEq = (dq[:, 0] + dq[:, 3]) < side_thresh
    tc2 = tc >> 1
    dp1 = _clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tc2, tc2)
    dq1 = _clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tc2, tc2)
    wp1 = _clip(p1 + dp1, 0, max_val)
    wq1 = _clip(q1 + dq1, 0, max_val)

    out = blk.copy()
    out[..., 1] = np.where(st, _clip(sp2, 0, max_val), out[..., 1])
    out[..., 2] = np.where(st, _clip(sp1, 0, max_val),
                           np.where(w_ok & dEp[:, None], wp1, out[..., 2]))
    out[..., 3] = np.where(st, _clip(sp0, 0, max_val),
                           np.where(w_ok, wp0, out[..., 3]))
    out[..., 4] = np.where(st, _clip(sq0, 0, max_val),
                           np.where(w_ok, wq0, out[..., 4]))
    out[..., 5] = np.where(st, _clip(sq1, 0, max_val),
                           np.where(w_ok & dEq[:, None], wq1, out[..., 5]))
    out[..., 6] = np.where(st, _clip(sq2, 0, max_val), out[..., 6])
    plane[rows[:, :, None], cols[:, None, :]] = out.astype(plane.dtype)


def _filter_chroma_edges(plane: np.ndarray, seg_y: np.ndarray,
                         seg_x: np.ndarray, qp_c: int, max_val: int,
                         tc_offset: int = 0) -> None:
    """Chroma vertical edges: 4-row segments at chroma column seg_x."""
    if len(seg_x) == 0:
        return
    tc = int(TC_TABLE[np.clip(qp_c + 2 + tc_offset, 0, 53)])
    if tc == 0:
        return
    rows = seg_y[:, None] + np.arange(4)[None, :]
    cols = seg_x[:, None] + np.arange(-2, 2)[None, :]  # p1 p0 q0 q1
    blk = plane[rows[:, :, None], cols[:, None, :]].astype(np.int64)
    p1, p0, q0, q1 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    delta = _clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    blk[..., 1] = _clip(p0 + delta, 0, max_val)
    blk[..., 2] = _clip(q0 - delta, 0, max_val)
    plane[rows[:, :, None], cols[:, None, :]] = blk.astype(plane.dtype)


def _segment_bs(maps, vert: bool, y4: np.ndarray, g8: np.ndarray):
    """Boundary strength per 4-sample segment (spec 8.7.2.4).

    vert: direction; y4: along-edge 4x4 granule index; g8: across-edge
    8-grid index (edge at luma coord g8*8). Uses the FrameMaps 4x4 state:
    intra (ref_idx < 0), luma cbf, MV, ref. All flagged edges are TU edges.
    """
    mf = maps.motion
    if vert:
        py, px = y4, g8 * 2 - 1
        qy, qx = y4, g8 * 2
    else:
        py, px = g8 * 2 - 1, y4
        qy, qx = g8 * 2, y4
    intra_p = (mf.ref_idx[py, px] < 0).all(axis=-1)
    intra_q = (mf.ref_idx[qy, qx] < 0).all(axis=-1)
    cbf = mf.cbf_y[py, px] | mf.cbf_y[qy, qx]
    dref = (mf.ref_idx[py, px] != mf.ref_idx[qy, qx]).any(axis=-1)
    dmv = (np.abs(mf.mv[py, px] - mf.mv[qy, qx]) >= 4).any(axis=(-2, -1))
    bs = np.where(intra_p | intra_q, 2,
                  np.where(cbf | dref | dmv, 1, 0))
    return bs


def deblock_picture(planes, sp, depth_map: np.ndarray, slice_qp: int,
                    qp_cb: int, qp_cr: int, maps=None,
                    tusplit=None) -> None:
    """Deblock the reconstructed picture in place.

    planes: object with .y/.cb/.cr int arrays in coded dims.
    depth_map: [coded_h/8, coded_w/8] int CU depths.
    maps: FrameMaps with motion state for inter BS derivation; None =>
    all-intra picture (BS=2 everywhere).
    """
    max_val = (1 << sp.bit_depth) - 1
    if tusplit is None:
        tusplit = (maps.tusplit[::2, ::2]
                   if maps is not None and hasattr(maps, "tusplit")
                   else None)
    vert, horz = edge_flags(depth_map, sp.log2_ctu, sp.log2_max_tu,
                            tusplit=tusplit)
    gh, gw = vert.shape

    def _segments(edge8, vert_dir):
        """4-line segments: (along4, across8) index arrays + BS."""
        e4 = np.repeat(edge8, 2, axis=0) if vert_dir else \
            np.repeat(edge8, 2, axis=1)
        if vert_dir:
            a4, g8 = np.nonzero(e4)      # a4: 4-row index, g8: edge col
        else:
            g8, a4 = np.nonzero(e4)
        if maps is None:
            bs = np.full(len(a4), 2, dtype=np.int64)
        else:
            bs = _segment_bs(maps, vert_dir, a4, g8)
        keep = bs > 0
        return a4[keep], g8[keep], bs[keep]

    # ---- luma vertical ----
    a4, g8, bsv = _segments(vert, True)
    _filter_luma_edges(planes.y, a4 * 4, g8 * 8, slice_qp, max_val, bsv)
    # ---- luma horizontal: transpose trick ----
    a4, g8, bsh = _segments(horz, False)
    yt = planes.y.T.copy()
    _filter_luma_edges(yt, a4 * 4, g8 * 8, slice_qp, max_val, bsh)
    planes.y[:] = yt.T

    # ---- chroma: edges on the 16-luma grid (8-chroma), BS=2 only ----
    cvert = vert & ((np.arange(gw) % 2 == 0)[None, :])
    chorz = horz & ((np.arange(gh) % 2 == 0)[:, None])
    for plane, qpc in ((planes.cb, qp_cb), (planes.cr, qp_cr)):
        vy, vx = np.nonzero(cvert)
        if maps is not None and len(vy):
            bs2 = _segment_bs(maps, True, vy * 2, vx)  # first luma unit
            m = bs2 == 2
            vy, vx = vy[m], vx[m]
        _filter_chroma_edges(plane, vy * 4, vx * 4, qpc, max_val)
        hy, hx = np.nonzero(chorz)
        if maps is not None and len(hy):
            bs2 = _segment_bs(maps, False, hx * 2, hy)
            m = bs2 == 2
            hy, hx = hy[m], hx[m]
        pt = plane.T.copy()
        _filter_chroma_edges(pt, hx * 4, hy * 4, qpc, max_val)
        plane[:] = pt.T
