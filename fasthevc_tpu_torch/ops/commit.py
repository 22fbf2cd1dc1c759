"""Wavefront commit: exact reconstruction of whole frames, intra or mixed.

Counterpart of fasthevc_tpu/ops/commit.py `wavefront_commit_intra` and
`wavefront_commit_mixed`.  CTUs
run in anti-diagonal waves (wave = cx + 2*cy), so every intra reference a
CTU reads from its left, top-left, top and top-right neighbours is final
when its wave starts.  Inside a CTU the CUs commit in the z-order of
`_GROUPS`: reference assembly with the decoding-order availability rule
and the spec's substitution, the selected intra prediction, the exact
transform, dead-zone quantisation or the parallel RDOQ trellis, sign-data
hiding, dequantisation, the inverse transform and the clip.

In the mixed form (P/B pictures), a CU whose direction is > 0 takes its
prediction from the MC planes (ops/me.py `inter_pred_planes`), the inter
dead-zone offset and the diagonal scan; intra CUs read reconstructed inter
neighbours as any others, and the trellis tables are those of init_type 1.

Both go through kernel K5 (csrc/commit.cu) for CUDA tensors: one launch
per call, whose CTAs take CTUs in the wave order of `ticket_order` and wait
only on the flags of the left, top-left, top and top-right CTUs; a CTU
commits its inter CUs before it waits.  `wavefront_commit_plain` is its
PyTorch twin: it commits every inter CU of the call in one batch first (the
furthest ahead any order of the kernel moves them), then the intra CUs wave
by wave (each tile its own wavefront, the tiles side by side), reading its
references from the recon planes it writes.  Each step is one group of
`_GROUPS` over the blocks of a wave's CTUs and frames that the decision
maps make active, found on the host once a call, so no step waits on the
device; both chroma planes go through one step.  The JAX package's
one-hot boundary buffers, permutation matmuls and scan-out reassembly
(commit.py:16-39) are TPU workarounds and are not carried over.

QPs and lambda may be given per frame (sequences of length F), so a batch
may mix temporal layers.  Scope: CTU 32, TU == CU.  Chroma blocks of both
planes quantise at qp_cb, as the reference's commit does (qp_cr is taken
for the signature's sake).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..spec.residual import get_scan
from ..spec.tables import (DCT_MATRICES, INTRA_INV_ANGLE,
                           INTRA_PRED_ANGLE, QUANT_SCALES)

from .. import _build
from . import intra, per_frame, rdoq as rdoq_ops
from .transform import (dequantize, fwd_transform, inv_transform,
                        quantize_mixed)

CTU = 32

# z-order index -> (gx, gy) within the 4x4 granule grid (commit.py:66)
_ZXY = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
        (0, 2), (1, 2), (0, 3), (1, 3), (2, 2), (3, 2), (2, 3), (3, 3)]


def _z_of(u, v):
    """z index of granule (u, v) within its CTU (commit.py:70)."""
    return ((u & 1) | ((v & 1) << 1) | ((u & 2) << 1) | ((v & 2) << 2))


def wave_tables(nctux: int, nctuy: int):
    """Static wavefront schedule: wave w holds CTUs with cx + 2*cy == w.
    Returns (ctu_x [W, A], ctu_y [W, A], valid [W, A]) numpy arrays.
    Copied from fasthevc_tpu/ops/commit.py:75."""
    n_waves = nctux + 2 * (nctuy - 1)
    waves = [[] for _ in range(n_waves)]
    for cy in range(nctuy):
        for cx in range(nctux):
            waves[cx + 2 * cy].append((cx, cy))
    a_max = max(len(wv) for wv in waves)
    ctu_x = np.zeros((n_waves, a_max), np.int32)
    ctu_y = np.zeros((n_waves, a_max), np.int32)
    valid = np.zeros((n_waves, a_max), bool)
    for w, wv in enumerate(waves):
        for a, (cx, cy) in enumerate(wv):
            ctu_x[w, a] = cx
            ctu_y[w, a] = cy
            valid[w, a] = True
    return ctu_x, ctu_y, valid


def ticket_order(nctux: int, nctuy: int) -> np.ndarray:
    """K5's schedule: the CTU (cy * nctux + cx) of each (wave, cy) slot,
    waves in order, cy rising inside a wave; ticket k of a call of F
    frames is frame k % F of slot k // F."""
    wx, wy, valid = wave_tables(nctux, nctuy)
    return (wy * nctux + wx)[valid].astype(np.int32)


def _np_tile_idx(coord, bounds):
    t = np.zeros_like(coord)
    for b in bounds:
        t = t + (coord >= b).astype(coord.dtype)
    return t


def _np_avail(x0, y0, lx, ly, n, sub, coded_w, coded_h, nctux,
              tile_bounds_x, tile_bounds_y):
    """Decoding-order availability (spec 6.4.1) of the 4n+1 references of
    a block at local (lx, ly), size n, in the CTUs at luma origins x0/y0
    [A].  Returns bool [A, 4n+1].  Copied from commit.py:108."""
    offs_x, offs_y = [], []
    for j in range(2 * n - 1, -1, -1):
        offs_x.append(lx - 1)
        offs_y.append(ly + j)
    offs_x.append(lx - 1)
    offs_y.append(ly - 1)
    for j in range(2 * n):
        offs_x.append(lx + j)
        offs_y.append(ly - 1)
    ox = np.asarray(offs_x, np.int64) << sub   # luma units
    oy = np.asarray(offs_y, np.int64) << sub
    px = x0[:, None].astype(np.int64) + ox[None, :]
    py = y0[:, None].astype(np.int64) + oy[None, :]
    in_pic = (px >= 0) & (py >= 0) & (px < coded_w) & (py < coded_h)
    pa, pb = px >> 3, py >> 3
    cx_l = (x0.astype(np.int64) + (lx << sub))
    cy_l = (y0.astype(np.int64) + (ly << sub))
    ca, cb = cx_l >> 3, cy_l >> 3
    ctu_p = (pb >> 2) * nctux + (pa >> 2)
    ctu_c = ((cb >> 2) * nctux + (ca >> 2))[:, None]
    z_p = _z_of(pa & 3, pb & 3)
    z_c = _z_of(ca & 3, cb & 3)[:, None]
    earlier = (ctu_p < ctu_c) | ((ctu_p == ctu_c) & (z_p < z_c))
    ok = in_pic & earlier
    if tile_bounds_x:
        ok = ok & (_np_tile_idx(px, tile_bounds_x)
                   == _np_tile_idx(cx_l, tile_bounds_x)[:, None])
    if tile_bounds_y:
        ok = ok & (_np_tile_idx(py, tile_bounds_y)
                   == _np_tile_idx(cy_l, tile_bounds_y)[:, None])
    return ok


def _np_sub_take(avail):
    """Substitution (spec 8.4.4.2.2) as take indices into the references
    extended by one half-range slot (index L).  Copied from
    commit.py:146."""
    L = avail.shape[-1]
    idx = np.where(avail, np.arange(L), -1)
    ff = np.maximum.accumulate(idx, axis=-1)
    first = np.argmax(avail, axis=-1)
    take = np.where(ff >= 0, ff, first[..., None])
    none = ~avail.any(axis=-1)
    return np.where(none[..., None], L, take).astype(np.int32)


def _group_schedule():
    """The commit order of the C++ engine's z-order recursion (8x8 at every
    z-step; 16x16 when the step enters a new 16-quadrant; 32x32 at step
    0): (kind, lx, ly, n, depth condition).  Copied from commit.py:163."""
    groups = []
    for g, (gx, gy) in enumerate(_ZXY):
        groups.append(("l", gx * 8, gy * 8, 8, 2))    # d >= 2
        groups.append(("c", gx * 4, gy * 4, 4, 2))
        if g % 4 == 0:
            groups.append(("l", gx * 8, gy * 8, 16, 1))  # d == 1
            groups.append(("c", gx * 4, gy * 4, 8, 1))
        if g == 0:
            groups.append(("l", 0, 0, 32, 0))            # d == 0
            groups.append(("c", 0, 0, 16, 0))
    return groups


_GROUPS = _group_schedule()
_TWIN_CACHE: dict = {}


def _twin_waves(nctux, nctuy, tile_bounds_x, tile_bounds_y):
    """The twin's CTU waves: CTU (cx, cy) of a tile whose first CTU is
    (x0, y0) joins wave (cx - x0) + 2 (cy - y0).  A CTU reads references
    only from its own tile, so the tiles advance side by side; inside one,
    every reference a CTU reads is final when its wave starts, as in
    `wave_tables`.  Returns [(cx, cy)] numpy int64 arrays, wave by wave."""
    def local(count, bounds):
        starts = np.zeros(count, np.int64)
        for b in bounds:
            c = b // CTU
            starts[c:] = c
        return np.arange(count) - starts

    lx, ly = local(nctux, tile_bounds_x), local(nctuy, tile_bounds_y)
    cy, cx = (a.ravel() for a in np.mgrid[0:nctuy, 0:nctux])
    wave = lx[cx] + 2 * ly[cy]
    return [(cx[wave == w], cy[wave == w]) for w in range(wave.max() + 1)]


def _twin_tables(nctux, nctuy, coded_w, coded_h, tbx, tby, device):
    """The waves and, per wave and group, the substitution take table
    [A_w, 4n+1] on `device` (the take part of commit.py:182), cached per
    geometry and device."""
    key = (nctux, nctuy, coded_w, coded_h, tbx, tby, str(device))
    if key not in _TWIN_CACHE:
        waves = []
        for cx, cy in _twin_waves(nctux, nctuy, tbx, tby):
            takes = []
            for kind, lx, ly, n, _d in _GROUPS:
                sub = 0 if kind == "l" else 1
                av = _np_avail(cx * CTU, cy * CTU, lx, ly, n, sub, coded_w,
                               coded_h, nctux, tbx, tby)
                takes.append(torch.from_numpy(_np_sub_take(av)).long()
                             .to(device))
            waves.append((cx, cy, takes))
        _TWIN_CACHE[key] = waves
    return _TWIN_CACHE[key]


def _twin_steps(ctus, dm, mm, im, nf, coded_w, coded_h, inter_pass):
    """The twin's steps over the CTU lists `ctus` [(cx, cy)], from the
    decision maps on the host (dm, mm, im: [F, H/8, W/8] numpy, padded):
    (steps, rows).  A step (wave, group, start, end) commits the blocks
    of one group that are active (inside the picture, at the group's
    depth, and inter in the inter pass, intra otherwise) in rows
    [start, end) of rows [5, R] int64: frame (chroma: cr's as F + frame),
    block x, y in the plane's samples, intra mode (>= 0), the CTU's index
    in its wave.  Groups without an active block make no step."""
    steps, cols, total = [], [], 0
    for w, (cx, cy) in enumerate(ctus):
        a_w = cx.shape[0]
        f = np.tile(np.arange(nf), a_w)                  # CTU-major
        bcx, bcy = np.repeat(cx, nf), np.repeat(cy, nf)
        arow = np.repeat(np.arange(a_w), nf)
        for gi, (kind, lx, ly, _n, dcond) in enumerate(_GROUPS):
            gx, gy = (lx // 8, ly // 8) if kind == "l" else (lx // 4, ly // 4)
            gyy, gxx = bcy * 4 + gy, bcx * 4 + gx
            d = dm[f, gyy, gxx]
            act = ((bcx * CTU + gx * 8 < coded_w) & (bcy * CTU + gy * 8
                                                     < coded_h)
                   & ((d >= 2) if dcond == 2 else (d == dcond)))
            if im is not None:
                inter = im[f, gyy, gxx] > 0
                act &= inter if inter_pass else ~inter
            rows = np.flatnonzero(act)
            if rows.size == 0:
                continue
            s = CTU if kind == "l" else CTU // 2
            col = np.stack([f[rows], bcx[rows] * s + lx, bcy[rows] * s + ly,
                            np.maximum(mm[f[rows], gyy[rows], gxx[rows]], 0),
                            arow[rows]])
            if kind == "c":
                cr = col.copy()
                cr[0] += nf
                col = np.concatenate([col, cr], 1)
            steps.append((w, gi, total, total + col.shape[1]))
            cols.append(col)
            total += col.shape[1]
    rows = (np.concatenate(cols, 1) if cols
            else np.zeros((5, 0), np.int64)).astype(np.int64)
    return steps, rows


# ---------------------------------------------------------------------------
# Scan order and sign-data hiding
# ---------------------------------------------------------------------------

def _n_perm_scans(lg: int) -> int:
    return 3 if lg in (2, 3) else 1


_PERM_CACHE: dict = {}


def _scan_perm(lg: int, inverse: bool, device) -> torch.Tensor:
    """[S, nn] gather indices: forward, scan position j reads raster
    position perm[s, j]; inverse, raster k reads scan position."""
    key = (lg, inverse, str(device))
    if key not in _PERM_CACHE:
        n = 1 << lg
        rows = []
        for s in range(_n_perm_scans(lg)):
            sc = get_scan(lg, s)
            flat = (sc[:, 1] * n + sc[:, 0]).astype(np.int64)
            rows.append(np.argsort(flat) if inverse else flat)
        _PERM_CACHE[key] = torch.from_numpy(np.stack(rows)).to(device)
    return _PERM_CACHE[key]


def scan_permute(x: torch.Tensor, lg: int, scan_sel=None,
                 inverse: bool = False) -> torch.Tensor:
    """Raster <-> scan order of [A, nn] blocks; scan_sel [A] in {0 diag,
    1 hor, 2 ver} (ignored where the size has one scan).  An index
    permutation: the counterpart of commit.py:315's permutation matmuls."""
    perm = _scan_perm(lg, inverse, x.device)
    if perm.shape[0] == 1 or scan_sel is None:
        idx = perm[0].expand(x.shape[0], -1)
    else:
        idx = perm[scan_sel.long()]
    return torch.take_along_dim(x, idx, dim=1)


def _scan_sel(lg: int, c_idx: int, modes: torch.Tensor) -> torch.Tensor:
    """Mode-dependent scan (spec.residual.intra_scan_idx, vectorized)."""
    if lg == 2 or (lg == 3 and c_idx == 0):
        ver = (modes >= 6) & (modes <= 14)
        hor = (modes >= 22) & (modes <= 30)
        return torch.where(ver, 2, torch.where(hor, 1, 0))
    return torch.zeros_like(modes)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the value int32 arithmetic wraps it to."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _sdh_adjust_scan(lv: torch.Tensor, cf: torch.Tensor, qp: int, lg: int,
                     bit_depth: int) -> torch.Tensor:
    """SDH parity fix on scan-ordered [A, nn] levels/coeffs: twin of
    commit.py:353, with its int32 arithmetic."""
    a_n, nn = lv.shape
    qbits = 14 + qp // 6 + (15 - bit_depth - lg)
    scale = int(QUANT_SCALES[qp % 6])
    g = nn // 16
    lvg = lv.to(torch.int64).reshape(a_n, g, 16)
    cfg = cf.to(torch.int64).reshape(a_n, g, 16)
    nzm = lvg != 0
    any_nz = nzm.any(-1)
    pos = torch.arange(16, device=lv.device)
    # torch.argmax returns the first index on ties, as jnp.argmax does
    first = torch.argmax(nzm.long(), dim=-1)
    last = 15 - torch.argmax(torch.flip(nzm, [-1]).long(), dim=-1)
    lv_first = torch.take_along_dim(lvg, first[..., None], -1)[..., 0]
    want = (lv_first < 0).long()
    parity = lvg.abs().sum(-1) & 1
    need = any_nz & ((last - first) > 3) & (parity != want)

    la = lvg.abs()
    aa = cfg.abs() * scale                          # < 2^31
    r = _wrap32((((aa >> qbits) - la) << qbits) + (aa & ((1 << qbits) - 1)))
    big = -(2 ** 31) + 1
    r = torch.where(la >= 32767, big, r)
    in_span = (pos >= first[..., None]) & (pos <= last[..., None])
    r = torch.where(in_span, r, big)
    k = torch.argmax(r, dim=-1)                     # [A, g]
    cur = torch.take_along_dim(lvg, k[..., None], -1)[..., 0]
    cf_k = torch.take_along_dim(cfg, k[..., None], -1)[..., 0]
    bump = torch.where(cur > 0, cur + 1,
                       torch.where(cur < 0, cur - 1,
                                   torch.where(cf_k < 0, -1, 1)))
    sel = (pos == k[..., None]) & need[..., None]
    return torch.where(sel, bump[..., None], lvg).reshape(a_n, nn)


def _tq_recon(pred, src, lg, qp, c_idx, modes, bit_depth, sdh, rd=None,
              intra_mask=None):
    """Exact T/Q/SDH/IQ/IT + clip of blocks [B, n, n]; returns (recon,
    levels).  rd: the (c_idx, lg) RDOQ tables, or None for the dead-zone
    quantiser; intra_mask [B] (None: all intra) selects the intra offset
    and the mode-dependent scan, the others take the inter offset and the
    diagonal scan.  Twin of commit.py:416."""
    res = src - pred
    coeffs = fwd_transform(res, lg, bit_depth)
    a_n, n = coeffs.shape[0], coeffs.shape[-1]
    if intra_mask is None:
        intra_mask = torch.ones(a_n, dtype=torch.bool, device=coeffs.device)
    sel = torch.where(intra_mask, _scan_sel(lg, c_idx, modes), 0)
    if rd is not None:
        cf_s = scan_permute(coeffs.reshape(a_n, n * n), lg, sel)
        lv_s = rdoq_ops.rdoq_scan_plain(cf_s, sel, rd, lg, c_idx)
        if sdh:
            lv_s = _sdh_adjust_scan(lv_s, cf_s, qp, lg, bit_depth)
        levels = scan_permute(lv_s, lg, sel, inverse=True).reshape(a_n, n, n)
    else:
        levels = quantize_mixed(coeffs, qp, lg, bit_depth, intra_mask)
        if sdh:
            lv_s = scan_permute(levels.reshape(a_n, n * n), lg, sel)
            cf_s = scan_permute(coeffs.reshape(a_n, n * n), lg, sel)
            lv_s = _sdh_adjust_scan(lv_s, cf_s, qp, lg, bit_depth)
            levels = scan_permute(lv_s, lg, sel,
                                  inverse=True).reshape(a_n, n, n)
    rres = inv_transform(dequantize(levels, qp, lg, bit_depth), lg,
                         bit_depth)
    return (pred + rres).clamp(0, (1 << bit_depth) - 1), levels


# ---------------------------------------------------------------------------
# The wavefront commit
# ---------------------------------------------------------------------------

def _pad(p: torch.Tensor, h: int, w: int, value: int = 0) -> torch.Tensor:
    return torch.nn.functional.pad(p, (0, w - p.shape[-1], 0,
                                       h - p.shape[-2]), value=value)


def _block_index(f, y0, x0, n, h, w):
    """Flat indices [B, n, n] of n x n blocks at (y0, x0) of frame f in
    [F, h, w] planes."""
    r = torch.arange(n, device=f.device)
    return (f[:, None, None] * (h * w) + (y0[:, None, None] + r[:, None]) * w
            + x0[:, None, None] + r[None, :])


def _ref_index(f, y0, x0, n, h, w):
    """Flat indices [B, 4n+1] of a block's raw references, ordered as the
    take tables expect (bottom-most left ... corner ... right-most top);
    clamped into the plane (those positions are never available)."""
    dev = f.device
    j = torch.arange(2 * n, device=dev)
    dx = torch.cat([torch.full((2 * n + 1,), -1, device=dev), j])
    dy = torch.cat([2 * n - 1 - j, torch.full((2 * n + 1,), -1, device=dev)])
    xs = (x0[:, None] + dx).clamp(0, w - 1)
    ys = (y0[:, None] + dy).clamp(0, h - 1)
    return f[:, None] * (h * w) + ys * w + xs


def wavefront_commit_plain(src_y, src_cb, src_cr, depth, mode, qp_y, qp_cb,
                           coded_w, coded_h, sdh=True, tile_bounds_x=(),
                           tile_bounds_y=(), rdoq=False, lam=0.0,
                           bit_depth=8, dir_map=None, pred=None):
    """K5's twin; arguments as wavefront_commit_mixed (qp_cr dropped), or
    as wavefront_commit_intra when dir_map is None."""
    nf = src_y.shape[0]
    qys, qcs, lams = (per_frame(v, nf) for v in (qp_y, qp_cb, lam))
    if len(set(zip(qys, qcs, lams))) > 1:
        # one batched pass per frame: the quantiser takes one QP
        outs = [wavefront_commit_plain(
            src_y[i:i + 1], src_cb[i:i + 1], src_cr[i:i + 1],
            depth[i:i + 1], mode[i:i + 1], qys[i], qcs[i], coded_w, coded_h,
            sdh, tile_bounds_x, tile_bounds_y, rdoq, lams[i], bit_depth,
            None if dir_map is None else dir_map[i:i + 1],
            None if pred is None else tuple(p[i:i + 1] for p in pred))
            for i in range(nf)]
        return tuple(torch.cat(parts) for parts in zip(*outs))
    qp_y, qp_cb, lam = qys[0], qcs[0], lams[0]
    dev = src_y.device
    nctux, nctuy = -(-coded_w // CTU), -(-coded_h // CTU)
    pw, ph = nctux * CTU, nctuy * CTU

    def plane(y, cb_cr):
        """The luma plane [F, ph, pw] and both chroma planes stacked
        [2F, ph/2, pw/2] (cb's frames, then cr's), int64."""
        return (_pad(y.to(torch.int64), ph, pw),
                _pad(torch.cat(cb_cr).to(torch.int64), ph // 2, pw // 2))

    planes = {k: dict(src=s, h=hh, w=ww) for k, s, hh, ww in zip(
        ("l", "c"), plane(src_y, (src_cb, src_cr)), (ph, ph // 2),
        (pw, pw // 2))}
    for p in planes.values():
        p["rec"] = torch.zeros_like(p["src"])
        p["lv"] = torch.zeros_like(p["src"])
    mixed = dir_map is not None
    if mixed:
        for k, ip in zip(("l", "c"), plane(pred[0], pred[1:])):
            planes[k]["ipred"] = ip
    # the decision maps on the host, once: which blocks each step commits
    maps = [_pad(m.to(torch.int64), ph // 8, pw // 8, fill).cpu().numpy()
            for m, fill in ((depth, 2), (mode, 0))
            + (((dir_map, 0),) if mixed else ())]
    dm, mm, im = maps[0], maps[1], maps[2] if mixed else None
    rd_tabs = (rdoq_ops.build_rdoq_tables(qp_y, qp_y, qp_cb, lam,
                                          1 if mixed else 0, bit_depth, dev)
               if rdoq else None)
    half = 1 << (bit_depth - 1)
    waves = _twin_tables(nctux, nctuy, coded_w, coded_h,
                         tuple(tile_bounds_x), tuple(tile_bounds_y), dev)

    def commit(ctus, inter_pass):
        """The blocks of the CTU lists `ctus` of every frame: the inter CUs
        (inter_pass, prediction from the MC planes) or the intra CUs."""
        steps, rows = _twin_steps(ctus, dm, mm, im, nf, coded_w, coded_h,
                                  inter_pass)
        rows = torch.from_numpy(rows).to(dev)
        for w, gi, s, e in steps:
            kind, _lx, _ly, n, _d = _GROUPS[gi]
            f, x0, y0, modes, arow = rows[:, s:e]
            lg = n.bit_length() - 1
            p = planes[kind]
            rec_flat = p["rec"].view(-1)
            idx = _block_index(f, y0, x0, n, p["h"], p["w"])
            if inter_pass:
                blk = p["ipred"].view(-1)[idx]
            else:
                # the wave's take table, a row for each active block
                take = waves[w][2][gi][arow]
                raw = rec_flat[_ref_index(f, y0, x0, n, p["h"], p["w"])]
                raw = torch.cat([raw, torch.full_like(raw[:, :1], half)], 1)
                refs = torch.take_along_dim(raw, take, dim=1)
                top = refs[:, 2 * n:]
                left = torch.flip(refs[:, :2 * n + 1], [1])
                blk = intra.predict_plain(top, left, lg, modes[:, None],
                                          kind == "l", bit_depth)[:, 0]
                blk = blk.to(torch.int64)
            src = p["src"].view(-1)[idx]
            c_idx = 0 if kind == "l" else 1
            qp = qp_y if kind == "l" else qp_cb
            rd = rd_tabs[(c_idx, lg)] if rdoq else None
            recon, levels = _tq_recon(
                blk, src, lg, qp, c_idx, modes, bit_depth, sdh, rd,
                torch.zeros_like(f, dtype=torch.bool) if inter_pass
                else None)
            rec_flat[idx] = recon
            p["lv"].view(-1)[idx] = levels

    if mixed:
        # every inter CU of the call first, in one batch
        cx, cy = (a.ravel() for a in np.mgrid[0:nctux, 0:nctuy])
        commit([(cx, cy)], True)
    commit([(cx, cy) for cx, cy, _ in waves], False)
    ch, cw = coded_h // 2, coded_w // 2
    luma, chroma = planes["l"], planes["c"]
    return (luma["rec"][:, :coded_h, :coded_w].to(torch.int32),
            chroma["rec"][:nf, :ch, :cw].to(torch.int32),
            chroma["rec"][nf:, :ch, :cw].to(torch.int32),
            luma["lv"][:, :coded_h, :coded_w].to(torch.int16),
            chroma["lv"][:nf, :ch, :cw].to(torch.int16),
            chroma["lv"][nf:, :ch, :cw].to(torch.int16))


def wavefront_commit_intra(src_y, src_cb, src_cr, depth, mode, qp_y, qp_cb,
                           qp_cr, coded_w, coded_h, sdh=True,
                           tile_bounds_x=(), tile_bounds_y=(), rdoq=False,
                           lam=0.0, plain=False, bit_depth=8):
    """Exact intra reconstruction of F frames.

    src_*: [F, coded_h, coded_w] (chroma halved) source planes; depth,
    mode: [F, coded_h/8, coded_w/8] decision maps; qp_*: ints or per-frame
    sequences; tile_bounds_*: inner tile boundaries in luma samples; lam:
    the f32 lambda of the RDOQ trellis (or per frame).  Returns (rec_y,
    rec_cb, rec_cr, lv_y, lv_cb, lv_cr): recon int32 and levels int16, in
    coded dims.  CUDA tensors go through K5 unless `plain`."""
    if plain or not src_y.is_cuda:
        return wavefront_commit_plain(src_y, src_cb, src_cr, depth, mode,
                                      qp_y, qp_cb, coded_w, coded_h, sdh,
                                      tile_bounds_x, tile_bounds_y, rdoq,
                                      lam, bit_depth)
    return _commit_cuda(src_y, src_cb, src_cr, depth, mode, None, None,
                        qp_y, qp_cb, coded_w, coded_h, sdh,
                        tuple(tile_bounds_x), tuple(tile_bounds_y), rdoq, lam,
                        bit_depth)


def wavefront_commit_mixed(src_y, src_cb, src_cr, depth, mode, dir_map,
                           pred_y, pred_cb, pred_cr, qp_y, qp_cb, qp_cr,
                           coded_w, coded_h, sdh=True, tile_bounds_x=(),
                           tile_bounds_y=(), rdoq=False, lam=0.0,
                           plain=False, bit_depth=8):
    """Mixed intra/inter exact reconstruction of F P/B frames: as
    wavefront_commit_intra, plus dir_map [F, coded_h/8, coded_w/8] (0
    intra, 1/2/3 L0/L1/BI) and the MC prediction planes pred_* (coded
    dims, ops/me.py inter_pred_planes).  CUDA tensors go through K5 unless
    `plain`."""
    pred = (pred_y, pred_cb, pred_cr)
    if plain or not src_y.is_cuda:
        return wavefront_commit_plain(src_y, src_cb, src_cr, depth, mode,
                                      qp_y, qp_cb, coded_w, coded_h, sdh,
                                      tile_bounds_x, tile_bounds_y, rdoq,
                                      lam, bit_depth, dir_map, pred)
    return _commit_cuda(src_y, src_cb, src_cr, depth, mode, dir_map, pred,
                        qp_y, qp_cb, coded_w, coded_h, sdh,
                        tuple(tile_bounds_x), tuple(tile_bounds_y), rdoq, lam,
                        bit_depth)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

# The kernel's RDOQ table layout: one f32 blob and one int32 blob, and per
# (c_idx, lg) a row of RD_FIELDS offsets/values in an int32 meta table.
RD_FIELDS = ("sig", "last", "g1", "g2", "csb", "nbr", "qbits", "q_scale",
             "err_scale", "n_scans", "step")
_KERNEL_TABLES: dict = {}


def _kernel_static(device) -> tuple:
    """K5's static tables on `device`: the DCT matrices of n = 4..32 at
    int offsets 0, 16, 80, 336; the scan permutations of lg 2..5 (three
    scans each, [4, 3, 1024], unused slots 0); the intra mode table
    [5, 35] (angle, inverse angle, filtered-refs flag for luma n = 8, 16,
    32)."""
    key = str(device)
    if key not in _KERNEL_TABLES:
        dct = np.concatenate([np.asarray(DCT_MATRICES[n], np.int32).ravel()
                              for n in (4, 8, 16, 32)])
        scans = np.zeros((4, 3, 1024), np.int32)
        for lg in range(2, 6):
            for s in range(_n_perm_scans(lg)):
                sc = get_scan(lg, s)
                scans[lg - 2, s, :sc.shape[0]] = (sc[:, 1] * (1 << lg)
                                                  + sc[:, 0])
        tab = np.zeros((5, 35), np.int32)
        for m in range(2, 35):
            tab[0, m] = INTRA_PRED_ANGLE[m]
            tab[1, m] = INTRA_INV_ANGLE.get(m, 0)
        for i, n in enumerate((8, 16, 32)):
            tab[2 + i] = intra._filter_flags(n, True)
        _KERNEL_TABLES[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (dct, scans, tab))
    return _KERNEL_TABLES[key]


def _rdoq_kernel_tables(rd_tabs: list, device) -> tuple:
    """Flatten build_rdoq_tables' output of each frame into K5's (ftab
    f32, itab int32, meta int32 [F, 2, 6, len(RD_FIELDS)]) on `device`,
    each distinct table once (frames that share one point at it).  The
    copies finish before this returns, so any stream may read them."""
    fparts, iparts = [], []
    meta = np.zeros((len(rd_tabs), 2, 6, len(RD_FIELDS)), np.int32)
    fo = io = 0
    first: dict = {}
    for fi, tabs in enumerate(rd_tabs):
        if id(tabs) in first:
            meta[fi] = meta[first[id(tabs)]]
            continue
        first[id(tabs)] = fi
        for c_idx, lgs in ((0, rdoq_ops.LUMA_LGS), (1, rdoq_ops.CHROMA_LGS)):
            for lg in lgs:
                t = tabs[(c_idx, lg)]
                row = meta[fi, c_idx, lg]
                for name in ("sig", "last", "g1", "g2", "csb"):
                    arr = t[name].detach().cpu().to(torch.float32).reshape(-1)
                    row[RD_FIELDS.index(name)] = fo
                    fparts.append(arr)
                    fo += arr.numel()
                row[RD_FIELDS.index("err_scale")] = fo
                fparts.append(t["err_scale"].detach().cpu().reshape(1))
                row[RD_FIELDS.index("step")] = fo + 1
                fparts.append(torch.tensor([t["step"]], dtype=torch.float32))
                fo += 2
                nbr = t["nbr"].detach().cpu().to(torch.int32).reshape(-1)
                row[RD_FIELDS.index("nbr")] = io
                iparts.append(nbr)
                io += nbr.numel()
                row[RD_FIELDS.index("qbits")] = t["qbits"]
                row[RD_FIELDS.index("q_scale")] = t["q_scale"]
                row[RD_FIELDS.index("n_scans")] = t["sig"].shape[0]
    return tuple(t.to(device) for t in
                 (torch.cat(fparts), torch.cat(iparts),
                  torch.from_numpy(meta)))


_RD_CACHE: dict = {}
_RD_CACHE_SIZE = 64
_rd_lock = threading.Lock()


def _rdoq_tables_for(qys, qcs, lams, init_type: int, bit_depth: int,
                     device) -> tuple:
    """K5's trellis tables for a call's frames on `device`: built on the
    host once per distinct (QP, chroma QP, lambda) and kept per call
    pattern (a group's frames share theirs; the last _RD_CACHE_SIZE
    patterns stay), since building them took longer than the kernel."""
    key = (tuple(zip(qys, qcs, lams)), init_type, bit_depth, str(device))
    with _rd_lock:
        hit = _RD_CACHE.get(key)
    if hit is not None:
        return hit
    built: dict = {}
    for k in key[0]:
        if k not in built:
            built[k] = rdoq_ops.build_rdoq_tables(k[0], k[0], k[1], k[2],
                                                  init_type, bit_depth)
    tabs = _rdoq_kernel_tables([built[k] for k in key[0]], device)
    with _rd_lock:
        if len(_RD_CACHE) >= _RD_CACHE_SIZE:
            _RD_CACHE.pop(next(iter(_RD_CACHE)))
        _RD_CACHE[key] = tabs
    return tabs


def _order_table(nctux: int, nctuy: int, device) -> torch.Tensor:
    """`ticket_order` on `device`, cached per geometry."""
    key = ("order", nctux, nctuy, str(device))
    if key not in _KERNEL_TABLES:
        _KERNEL_TABLES[key] = torch.from_numpy(
            ticket_order(nctux, nctuy)).to(device)
    return _KERNEL_TABLES[key]


def _commit_cuda(src_y, src_cb, src_cr, depth, mode, dir_map, pred, qp_y,
                 qp_cb, coded_w, coded_h, sdh, tbx, tby, rdoq, lam,
                 bit_depth):
    dev = src_y.device
    nf = src_y.shape[0]
    qys, qcs, lams = (per_frame(v, nf) for v in (qp_y, qp_cb, lam))
    nctux, nctuy = -(-coded_w // CTU), -(-coded_h // CTU)
    pw, ph = nctux * CTU, nctuy * CTU
    i32 = torch.int32
    sy = _pad(src_y.to(i32), ph, pw).contiguous()
    scb = _pad(src_cb.to(i32), ph // 2, pw // 2).contiguous()
    scr = _pad(src_cr.to(i32), ph // 2, pw // 2).contiguous()
    dm = _pad(depth.to(i32), ph // 8, pw // 8, value=2).contiguous()
    mm = _pad(mode.to(i32), ph // 8, pw // 8).contiguous()
    tensors = [sy, scb, scr, dm, mm]
    mixed = dir_map is not None
    im = ipy = ipcb = ipcr = None
    if mixed:
        im = _pad(dir_map.to(i32), ph // 8, pw // 8).contiguous()
        ipy, ipcb, ipcr = (_pad(p.to(i32), h, w).contiguous() for p, h, w in
                           zip(pred, (ph, ph // 2, ph // 2),
                               (pw, pw // 2, pw // 2)))
        tensors += [im, ipy, ipcb, ipcr]
    rec_y = torch.zeros_like(sy)
    rec_cb = torch.zeros_like(scb)
    rec_cr = torch.zeros_like(scr)
    lv_y = torch.zeros(sy.shape, dtype=torch.int16, device=dev)
    lv_cb = torch.zeros(scb.shape, dtype=torch.int16, device=dev)
    lv_cr = torch.zeros(scr.shape, dtype=torch.int16, device=dev)
    name = "commit_mixed" if mixed else "commit_intra"
    _build.require_cuda(name, *tensors, rec_y, rec_cb, rec_cr, dtype=i32)
    dct, scans, mode_tab = _kernel_static(dev)
    tiles = _build.upload(torch.tensor(list(tbx) + list(tby) + [0],
                                       dtype=i32), dev)
    qps = _build.upload(torch.tensor([[y, c] for y, c in zip(qys, qcs)],
                                     dtype=i32), dev)
    lam_t = _build.upload(torch.tensor(lams, dtype=torch.float32), dev)
    rd = (None, None, None)
    if rdoq:
        rd = _rdoq_tables_for(qys, qcs, lams, 1 if mixed else 0, bit_depth,
                              dev)
    # the CTU flags, then the ticket counter: zero, as the kernel needs them
    flags = torch.zeros(nf * nctux * nctuy + 1, dtype=i32, device=dev)
    order = _order_table(nctux, nctuy, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = _build.lib().fhv_commit(
        sy.data_ptr(), scb.data_ptr(), scr.data_ptr(), dm.data_ptr(),
        mm.data_ptr(), ptr(im), ptr(ipy), ptr(ipcb), ptr(ipcr),
        rec_y.data_ptr(), rec_cb.data_ptr(), rec_cr.data_ptr(),
        lv_y.data_ptr(), lv_cb.data_ptr(), lv_cr.data_ptr(), dct.data_ptr(),
        scans.data_ptr(), mode_tab.data_ptr(), tiles.data_ptr(), len(tbx),
        len(tby), *(ptr(t) for t in rd), lam_t.data_ptr(), qps.data_ptr(),
        flags.data_ptr(), order.data_ptr(), nf, ph, pw, coded_w, coded_h,
        int(bool(sdh)), int(bool(rdoq)), bit_depth, _build.stream_handle(sy))
    _build.launched(name)
    _build.check(rc, name)
    ch, cw = coded_h // 2, coded_w // 2
    return (rec_y[:, :coded_h, :coded_w], rec_cb[:, :ch, :cw],
            rec_cr[:, :ch, :cw], lv_y[:, :coded_h, :coded_w],
            lv_cb[:, :ch, :cw], lv_cr[:, :ch, :cw])
