"""The sharded all-intra and P/B pipelines on a ("gop", "tile") mesh.

Counterpart of fasthevc_tpu/parallel/sharded.py.  Each (gop, tile) rank
owns a CTU-aligned tile column of its frames and runs the whole device
pixel path on it:
  1. the search on a halo-extended source (intra: the left neighbour's
     last CTU column and the right neighbour's first two; P/B: the ME halo
     of `_me_halo_ctus` on the source and on each reference, and above
     SR 8 the tiles' decimated planes extended by a quarter of it), with
     the picture's left edge at the halo's end on tile 0 (`mpm_edge_x`),
     so every kept block decides as the single-device search does;
  2. the exact commit (K5) per tile at tile-local width: tiles never
     predict across their bounds; P/B first predict on the extended
     geometry (K11) and keep the tile's columns;
  3. the deblocking of K6's tile-column form on the recon extended by 8
     luma columns of each neighbour, with the P/B strengths worked out on
     the halo-extended maps;
  4. SAO's halo form (K7) with the neighbours' deblocked edge columns,
     then K8's cast form (the uint8 recon, no checksum).
Every exchange is one K16 launch (`group.halo`).  The streams are
byte-identical to the single-device route on the same tile grid
(tests/test_torch_sharded.py); CABAC runs on the host per tile
(`cabac_cpp.entropy_slice_native`).

The host drivers code at cfg.qp (plus the GOP entries' offsets) and write
no buffering-period or pic-timing SEI: like the reference's, they take no
rate control, HRD, fast partition or second reference per list.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import cabac_cpp
from ..codec.device_pipeline import _lam, cast_checksum
from ..codec.encoder import lambda_sqrt
from ..codec.gop import coding_order, ref_lists
from ..codec.search import search_b_maps, search_intra_maps_batch, \
    search_p_maps
from ..ops.commit import wavefront_commit_intra, wavefront_commit_mixed
from ..ops.deblock import deblock_fused, tu_cbf_ctu
from ..ops.me import downsample4, inter_pred_planes
from ..ops.sao import sao
from ..spec import bitstream as bs
from ..spec.cabac import ContextSet
from ..spec.ctu import Planes, tu_qps
from ..spec.encoder import config_to_sp
from ..spec.inter import MotionCtx
from ..spec.syntax import (SliceHeader, write_picture_hash_sei, write_pps,
                           write_slice_header, write_sps, write_vps)
from ..utils.video import pad_plane, picture_hash

CTU = 32
DEBLOCK_HALO = 8      # luma columns of recon each side of a tile boundary


def _deblock_sharded_cols(group, rec_y, rec_cb, rec_cr, depth, qp, qp_cb,
                          qp_cr, pic_w: int, log2_ctu: int = 5,
                          bit_depth: int = 8, inter_maps=None,
                          plain: bool = False):
    """Cross-tile deblocking of a tile's [F, H, W] recon (sharded.py:67):
    one K16 exchange extends the planes by DEBLOCK_HALO luma columns and
    the granule maps by one column each side, K6's tile-column form
    filters the extended planes (edges on global columns inside the
    picture), and the tile keeps its own columns.  inter_maps: the P/B
    granule maps (dir, mv [F, gh, gw, 4], cbf), whose halo-extended forms
    give the vertical strengths and whose own columns the horizontal ones
    (:434-451; one reference per list, so no ref map)."""
    f, h, w = rec_y.shape
    gh, gw = h // 8, w // 8
    hl, hc = DEBLOCK_HALO, DEBLOCK_HALO // 2
    planes = [rec_y, rec_cb, rec_cr, depth.to(torch.int32)]
    widths = [hl, hc, hc, 1]
    if inter_maps is not None:
        dir_map, mv, cbf = inter_maps
        planes += [dir_map.to(torch.int32),
                   mv.to(torch.int32).reshape(f, gh, gw * 4),
                   cbf.to(torch.int32)]
        widths += [1, 4, 1]
    ext = group.halo(planes, widths, widths)
    kw = {}
    if inter_maps is not None:
        kw = dict(dir_map=ext[4], mv_map=ext[5].reshape(f, gh, gw + 2, 4),
                  cbf=ext[6])
    t = group.axis_index("tile")
    ry, rcb, rcr = deblock_fused(ext[0], ext[1], ext[2], ext[3], qp, qp_cb,
                                 qp_cr, log2_ctu, bit_depth, plain=plain,
                                 x0=t * w - hl, pic_w=pic_w, **kw)
    return (ry[..., hl:hl + w], rcb[..., hc:hc + w // 2],
            rcr[..., hc:hc + w // 2])


def _filters(group, sy, scb, scr, committed, dm, qp, qp_cb, qp_cr,
             coded_w: int, log2_ctu: int, deblock_on: bool, sao_on: bool,
             packed, inter_maps=None, plain: bool = False) -> dict:
    """Deblocking and SAO of a tile's committed frames; the rank's output
    dict: packed maps, int16 levels, uint8 recon, SAO parameters."""
    ry, rcb, rcr, lv_y, lv_cb, lv_cr = committed
    f, h, w = sy.shape
    if deblock_on:
        ry, rcb, rcr = _deblock_sharded_cols(
            group, ry, rcb, rcr, dm, qp, qp_cb, qp_cr, coded_w, log2_ctu,
            inter_maps=inter_maps, plain=plain)
    if sao_on:
        # the deblocked neighbour columns ride one K16 exchange, so each
        # tile's estimate and apply equal the full-plane pass (:185-203)
        t = group.axis_index("tile")
        ey, ecb, ecr = group.halo([ry, rcb, rcr], 1, 1, own=False)
        ry, rcb, rcr, sao_p = sao(
            sy, scb, scr, ry, rcb, rcr, log2_ctu, plain=plain,
            halo_y=(ey[..., 0], ey[..., 1]),
            halo_cb=(ecb[..., 0], ecb[..., 1]),
            halo_cr=(ecr[..., 0], ecr[..., 1]),
            l_avail=t > 0, r_avail=t < group.axis_size("tile") - 1)
    else:
        ctb = 1 << log2_ctu
        sao_p = torch.zeros((f, -(-h // ctb), w // ctb, 3, 7),
                            dtype=torch.int32, device=sy.device)
    rec_y, rec_cb, rec_cr, _ = cast_checksum(ry, rcb, rcr, checksum=False,
                                             plain=plain)
    return dict(packed=packed, lv_y=lv_y.contiguous(),
                lv_cb=lv_cb.contiguous(), lv_cr=lv_cr.contiguous(),
                rec_y=rec_y, rec_cb=rec_cb, rec_cr=rec_cr, sao=sao_p)


def _tile_width(mesh, coded_w: int, log2_ctu: int) -> int:
    n_tile = mesh.shape["tile"]
    if coded_w % (n_tile * (1 << log2_ctu)):
        raise ValueError("uniform CTU-aligned tile columns required")
    return coded_w // n_tile


def build_sharded_intra_pipeline(mesh, coded_w: int, coded_h: int,
                                 log2_ctu: int = 5, log2_min_cu: int = 3,
                                 deblock_on: bool = True, sdh: bool = True,
                                 rdoq: bool = False, sao_on: bool = False,
                                 plain: bool = False):
    """The per-rank program of intra frames (sharded.py:136):
    run(group, y, cb, cr, lambda_sqrt, qp_y, qp_cb, qp_cr, qp) on the
    rank's tile column, y [F, PH, tile_w] uint8 (CTU-padded rows), cb, cr
    [F, PH/2, tile_w/2]; returns the dict of `_filters` (packed [F, PH/8,
    tile_w/8, 9] int16, levels and recon in coded rows, sao [F, ny,
    nx_tile, 3, 7]).  plain runs the kernels' twins on any device."""
    tile_w = _tile_width(mesh, coded_w, log2_ctu)
    if tile_w < 2 * CTU:
        raise ValueError("tile columns must be >= 2 CTUs wide (halo from "
                         "one neighbour)")
    halo_r = 2 * CTU   # the top-right source references reach 2N right

    def run(group, y, cb, cr, lam_sqrt, qp_y, qp_cb, qp_cr, qp):
        t = group.axis_index("tile")
        ext, ext_cb, ext_cr = group.halo(
            [y, cb, cr], [CTU, CTU // 2, CTU // 2],
            [halo_r, halo_r // 2, halo_r // 2])
        packed_ext = search_intra_maps_batch(
            ext, lam_sqrt, log2_ctu, log2_min_cu, ext.shape[-1], coded_h,
            cb_batch=ext_cb, cr_batch=ext_cr, plain=plain, mpm_edge_x=CTU,
            mpm_edge_on=t == 0)
        g0 = CTU >> 3
        packed = packed_ext[:, :, g0:g0 + (tile_w >> 3)].contiguous()
        gh = coded_h >> 3
        dm = packed[:, :gh, :, 0].to(torch.int32)
        mm = packed[:, :gh, :, 1].to(torch.int32)
        ch = coded_h // 2
        sy = y[:, :coded_h].to(torch.int32)
        scb = cb[:, :ch].to(torch.int32)
        scr = cr[:, :ch].to(torch.int32)
        committed = wavefront_commit_intra(
            sy, scb, scr, dm, mm, qp_y, qp_cb, qp_cr, tile_w, coded_h, sdh,
            rdoq=rdoq, lam=_lam(lam_sqrt), plain=plain)
        return _filters(group, sy, scb, scr, committed, dm, qp, qp_cb, qp_cr,
                        coded_w, log2_ctu, deblock_on, sao_on, packed,
                        plain=plain)

    return run


def _me_halo_ctus(search_range: int) -> int:
    """CTU columns of halo each side so that every kept block's decision
    chain is exact (sharded.py:332): its own ME windows (+-SR, +8 sub-pel
    and tap margin) and its left neighbour's (one 32-block further);
    intra needs >= 1 left and >= 2 right."""
    need = 32 + search_range + 8
    return max(2, -(-need // 32))


def build_sharded_p_pipeline(mesh, coded_w: int, coded_h: int,
                             search_range: int, log2_ctu: int = 5,
                             log2_min_cu: int = 3, deblock_on: bool = True,
                             sdh: bool = True, rdoq: bool = False,
                             sao_on: bool = False, is_b: bool = False,
                             plain: bool = False):
    """The per-rank program of P frames, or B frames with `is_b`
    (sharded.py:341): run(group, y, cb, cr, r0, r1, lambda_sqrt, qp_y,
    qp_cb, qp_cr, qp) with y, cb, cr as the intra program's and r0, r1 the
    (y, cb, cr) uint8 reference tiles of lists 0 and 1 ([F, PH, tile_w],
    rows edge-padded to the CTU grid; r1 unused for P).  One K16 exchange
    extends the source and the references by the ME halo; the search runs
    on the extended geometry, MC (K11) predicts there and the tile keeps
    its columns, K5 commits mixed, and the strengths come from the
    halo-extended maps."""
    tile_w = _tile_width(mesh, coded_w, log2_ctu)
    halo = _me_halo_ctus(search_range) * CTU
    if tile_w < halo:
        raise ValueError(f"tile columns ({tile_w}) must be >= the ME halo "
                         f"({halo}): one-neighbour exchange")

    def run(group, y, cb, cr, r0, r1, lam_sqrt, qp_y, qp_cb, qp_cr, qp):
        t = group.axis_index("tile")
        planes = [y, cb, cr, *r0] + (list(r1) if is_b else [])
        widths = [halo, halo // 2, halo // 2] * (3 if is_b else 2)
        ext = group.halo(planes, widths, widths)
        ext_y, ref0 = ext[0], ext[3:6]
        ref1 = ext[6:9] if is_b else None
        common = dict(plain=plain, mpm_edge_x=halo, mpm_edge_on=t == 0)
        if search_range > 8:
            # the coarse search runs on 4x4-decimated planes: decimate the
            # tile, then extend it, so that a picture bound repeats the
            # decimated edge column as the whole picture's search clamps
            # to it (decimating the extended planes would average the
            # repeated edge pixels instead)
            lum = [y, r0[0]] + ([r1[0]] if is_b else [])
            f, ph_, _ = y.shape
            dec = downsample4(torch.stack(lum, 1).reshape(-1, ph_, tile_w)
                              .to(torch.int32), plain=plain)
            dec = dec.reshape(f, len(lum), ph_ // 4, tile_w // 4)
            common["me_decimated"] = group.halo([dec], halo // 4,
                                                halo // 4)[0]
        ew = ext_y.shape[-1]
        if is_b:
            packed_ext = search_b_maps(
                ext_y, ref0[0][:, None], ref1[0][:, None], lam_sqrt,
                log2_ctu, log2_min_cu, ew, coded_h, search_range, nref0=1,
                nref1=1, **common)
        else:
            packed_ext = search_p_maps(
                ext_y, ref0[0][:, None], lam_sqrt, log2_ctu, log2_min_cu, ew,
                coded_h, search_range, nref=1, **common)
        gh = coded_h >> 3
        g0, gt = halo >> 3, tile_w >> 3
        packed = packed_ext[:, :, g0:g0 + gt].contiguous()
        dm = packed[:, :gh, :, 0].to(torch.int32)
        mm = packed[:, :gh, :, 1].to(torch.int32)
        im = packed[:, :gh, :, 2].to(torch.int32)
        mv = packed[:, :gh, :, 3:7].to(torch.int32)
        ch = coded_h // 2

        def rows(planes3):
            return tuple(p[:, None, :coded_h >> (k > 0)].to(torch.int32)
                         for k, p in enumerate(planes3))

        # MC on the extended geometry, then the tile's own columns
        ipy, ipcb, ipcr = inter_pred_planes(
            rows(ref0), rows(ref1) if is_b else None,
            packed_ext[:, :gh, :, 2].to(torch.int32),
            packed_ext[:, :gh, :, 3:7].to(torch.int32), plain=plain)
        ipy = ipy[..., halo:halo + tile_w]
        ipcb = ipcb[..., halo // 2:(halo + tile_w) // 2]
        ipcr = ipcr[..., halo // 2:(halo + tile_w) // 2]
        sy = y[:, :coded_h].to(torch.int32)
        scb = cb[:, :ch].to(torch.int32)
        scr = cr[:, :ch].to(torch.int32)
        committed = wavefront_commit_mixed(
            sy, scb, scr, dm, mm, im, ipy, ipcb, ipcr, qp_y, qp_cb, qp_cr,
            tile_w, coded_h, sdh, rdoq=rdoq, lam=_lam(lam_sqrt),
            plain=plain)
        maps = None
        if deblock_on:
            maps = (im, mv, tu_cbf_ctu(committed[3], dm, log2_ctu,
                                       plain=plain))
        return _filters(group, sy, scb, scr, committed, dm, qp, qp_cb, qp_cr,
                        coded_w, log2_ctu, deblock_on, sao_on, packed, maps,
                        plain=plain)

    return run


def _padded(frames, idx, ph: int, w: int) -> tuple:
    """The frames idx edge-padded to [n, ph, w] (chroma halved), uint8."""
    return tuple(
        np.stack([pad_plane(np.asarray(frames[i][c], np.int32),
                            ph >> (c > 0), w >> (c > 0)).astype(np.uint8)
                  for i in idx]) for c in range(3))


def _tiles_of(planes, mesh, rank: int, tile_w: int) -> list:
    """Rank's tile column of [G, ...] planes on its device: frame g of the
    gop axis, columns [t * tile_w, (t + 1) * tile_w) (chroma halved)."""
    g, t = divmod(rank, mesh.shape["tile"])
    out = []
    for c, p in enumerate(planes):
        tw = tile_w >> (c > 0)
        part = np.ascontiguousarray(p[g:g + 1, :, t * tw:(t + 1) * tw])
        out.append(torch.from_numpy(part).to(mesh.devices[rank]))
    return out


def _assemble(host: list, mesh, g: int) -> dict:
    """Gop row g's picture from its tiles' host outputs: maps, levels,
    recon and SAO parameters side by side (frame 0 of each rank)."""
    n_tile = mesh.shape["tile"]
    parts = [host[g * n_tile + t] for t in range(n_tile)]
    out = {}
    for k in parts[0]:
        axis = {"packed": 1, "sao": 1}.get(k, -1)
        out[k] = np.concatenate([p[k][0] for p in parts], axis=axis)
    return out


def _slice_nal(sp, cfg, res, qp: int, is_idr: bool, st: int, poc: int,
               deltas=((), ()), l0=(), l1=(), mctx=None,
               gop_route: bool = False) -> tuple:
    """The picture's slice NAL (per-tile CABAC on the host) and hash SEI,
    and its recon Planes.  gop_route: the inter driver's entropy call,
    which states the inter RQT depth for every picture (sharded.py:703)."""
    gh, gw = sp.coded_height >> 3, sp.coded_width >> 3
    qp_y, qp_cb, qp_cr = tu_qps(sp, qp)
    pk = res["packed"][:gh, :gw]
    kw = {}
    if gop_route:
        kw = dict(rqt=sp.max_transform_hierarchy_depth_inter > 0, mctx=mctx)
    if st != 2:
        kw.update(slice_type=st,
                  dir_map=np.ascontiguousarray(pk[..., 2].astype(np.int8)),
                  mv_map=np.ascontiguousarray(pk[..., 3:7].astype(np.int16)),
                  ref_map=np.ascontiguousarray(pk[..., 7:9].astype(np.int8)))
    init_type = 0 if st == 2 else (1 if st == 1 else 2)
    subs = cabac_cpp.entropy_slice_native(
        sp, qp_y, qp_cb, qp_cr,
        np.ascontiguousarray(pk[..., 0].astype(np.int8)),
        np.ascontiguousarray(pk[..., 1].astype(np.int8)),
        res["lv_y"], res["lv_cb"], res["lv_cr"], ContextSet(init_type, qp),
        sao_params=res["sao"] if cfg.sao else None,
        sdh=sp.sign_data_hiding, ts=sp.transform_skip_enabled, **kw)
    sh = SliceHeader(
        slice_type=st, slice_qp=qp, is_idr=is_idr,
        poc_lsb=poc & ((1 << sp.log2_max_poc_lsb) - 1),
        ref_pocs_before=() if is_idr else deltas[0],
        ref_pocs_after=() if is_idr else deltas[1],
        num_ref_idx_l0=max(1, len(l0)), num_ref_idx_l1=max(1, len(l1)),
        temporal_mvp=bool(mctx and mctx.tmvp),
        collocated_from_l0=(mctx.col_from_l0 if mctx else True),
        sao_luma=bool(cfg.sao), sao_chroma=bool(cfg.sao),
        entry_points=tuple(len(x) for x in subs[:-1]))
    nal_type = bs.NAL_IDR_W_RADL if is_idr else bs.NAL_TRAIL_R
    w = write_slice_header(sh, sp, nal_type)
    for s_bytes in subs:
        w.append_bytes(s_bytes)
    planes = Planes.__new__(Planes)
    planes.y = res["rec_y"].astype(np.int32)
    planes.cb = res["rec_cb"].astype(np.int32)
    planes.cr = res["rec_cr"].astype(np.int32)
    nal = bs.write_nal(nal_type, w.get_bytes())
    md5s = picture_hash((planes.y, planes.cb, planes.cr), cfg.hash_type)
    nal += bs.write_nal(bs.NAL_SUFFIX_SEI,
                        write_picture_hash_sei(md5s, cfg.hash_type))
    return nal, planes


class _Clock:
    """Wall seconds by phase into a caller's `timing` dict (run_s: the
    ranks' programs, fetch_s: their outputs to the host, entropy_s: CABAC
    and the NAL glue)."""

    def __init__(self, timing) -> None:
        self.timing = {} if timing is None else timing
        for key in ("run_s", "fetch_s", "entropy_s"):
            self.timing.setdefault(key, 0.0)
        self.t = time.perf_counter()

    def lap(self, key: str) -> None:
        now = time.perf_counter()
        self.timing[key] += now - self.t
        self.t = now


def _stream_params(cfg, mesh, **over):
    cfg = cfg.replace(tile_cols=mesh.shape["tile"], tile_rows=1, **over)
    sp = config_to_sp(cfg)
    sp.sao_enabled = bool(cfg.sao)
    sp.deblocking_disabled = not cfg.deblocking
    headers = (bs.write_nal(bs.NAL_VPS, write_vps(sp))
               + bs.write_nal(bs.NAL_SPS, write_sps(sp))
               + bs.write_nal(bs.NAL_PPS, write_pps(sp)))
    return cfg, sp, headers


def sharded_encode_all_intra(frames, cfg, mesh, plain: bool = False,
                             timing: dict | None = None):
    """Encode an all-intra clip on a ("gop", "tile") mesh (sharded.py:233):
    groups of n_gop frames fill the gop axis, each rank codes its tile
    column of its frame, and the host emits each picture's per-tile CABAC,
    slice header with entry points and hash SEI.  Returns (stream, recons)
    on every process; the stream equals TorchEncoder(cfg)'s device route
    with the mesh's tile columns.  timing: a dict to add run_s, fetch_s
    and entropy_s to."""
    n_tile, n_gop = mesh.shape["tile"], mesh.shape["gop"]
    cfg, sp, headers = _stream_params(cfg, mesh)
    qp = cfg.qp
    qp_y, qp_cb, qp_cr = tu_qps(sp, qp)
    run = build_sharded_intra_pipeline(
        mesh, sp.coded_width, sp.coded_height, sp.log2_ctu, sp.log2_min_cu,
        deblock_on=cfg.deblocking, sdh=sp.sign_data_hiding,
        rdoq=bool(cfg.rdoq), sao_on=bool(cfg.sao), plain=plain)
    tile_w = sp.coded_width // n_tile
    ph = -(-sp.coded_height // CTU) * CTU
    lam = lambda_sqrt(qp)
    out = bytearray(headers)
    recons = []
    n = len(frames)
    clock = _Clock(timing)
    for s in range(0, n, n_gop):
        grp = list(range(s, min(s + n_gop, n)))
        grp += [grp[-1]] * (n_gop - len(grp))     # pad the gop axis
        planes = _padded(frames, grp, ph, sp.coded_width)
        results = mesh.run(
            run, lambda r: (*_tiles_of(planes, mesh, r, tile_w), lam, qp_y,
                            qp_cb, qp_cr, qp))
        clock.lap("run_s")
        host = mesh.to_host(results)
        clock.lap("fetch_s")
        for j, i in enumerate(grp):
            if i != s + j:                        # a padded duplicate
                break
            nal, pl = _slice_nal(sp, cfg, _assemble(host, mesh, j), qp, True,
                                 2, 0)
            out += nal
            recons.append(pl)
        clock.lap("entropy_s")
    return bytes(out), recons


def sharded_encode_gop(frames, cfg, mesh, plain: bool = False,
                       timing: dict | None = None):
    """Encode a clip of I, P and B slices on a ("gop", "tile") mesh
    (sharded.py:500): gop row r owns the IDR-led segment r of len(frames)
    / n_gop frames (closed GOPs), the tile ranks cooperate on each picture
    through K16's halos, and each rank keeps its tile of every reference
    (the DPB never leaves the ranks).  Pictures run in coding order; the
    host replays each picture's motion for TMVP and emits per-tile CABAC.

    cfg describes the equivalent single-device encode with tiles = the
    mesh's tile columns and intra_period = the segment length; a GOP entry
    may have one active reference per list.  The stream holds each
    segment's pictures in coding order: it equals TorchEncoder(cfg) where
    that route's batch order is the coding order (low-delay P; an
    I P B segment), not for a hierarchical GOP-16 (ROADMAP S8).  timing:
    as sharded_encode_all_intra's."""
    n_tile, n_gop = mesh.shape["tile"], mesh.shape["gop"]
    n = len(frames)
    if n % n_gop:
        raise ValueError("frames must split evenly into gop segments")
    seg = n // n_gop
    cfg, sp, headers = _stream_params(cfg, mesh, intra_period=seg)
    common = dict(log2_ctu=sp.log2_ctu, log2_min_cu=sp.log2_min_cu,
                  deblock_on=cfg.deblocking, sdh=sp.sign_data_hiding,
                  rdoq=bool(cfg.rdoq), sao_on=bool(cfg.sao), plain=plain)
    cw, chh = sp.coded_width, sp.coded_height
    run_i = build_sharded_intra_pipeline(mesh, cw, chh, **common)
    runs = {}

    def run_inter(is_b):
        if is_b not in runs:
            runs[is_b] = build_sharded_p_pipeline(
                mesh, cw, chh, cfg.search_range, is_b=is_b, **common)
        return runs[is_b]

    tile_w = cw // n_tile
    ph = -(-chh // CTU) * CTU
    gh, gw = chh >> 3, cw >> 3

    # the per-segment coding schedule (sharded.py:567-591)
    order = coding_order(cfg.replace(frames=seg), seg, 0)
    entries = []
    sim: set = set()
    for poc, st0, ref_deltas, qp_off in order:
        st, _, _, deltas = ref_lists({p: None for p in sim}, poc, st0,
                                     ref_deltas, st0 == 2)
        l0 = [poc - d for d in deltas[0]] + [poc + d for d in deltas[1]]
        l1 = [poc + d for d in deltas[1]] + [poc - d for d in deltas[0]]
        nr = max(1, min(2, cfg.num_ref_per_list))
        l0, l1 = l0[:nr], l1[:nr]
        if st != 2 and (len(l0) > 1 or (st != 1 and len(l1) > 1)):
            raise ValueError("sharded_encode_gop supports one active "
                             "reference per list; set num_ref_per_list=1 "
                             "or use single-reference GOP entries")
        entries.append((poc, st, l0, l1, deltas,
                        min(max(cfg.qp + qp_off, 0), 51)))
        sim.add(poc)
    last_use: dict = {}
    for ci, e in enumerate(entries):
        for p2 in e[2] + e[3]:
            last_use[p2] = ci

    def pad_ref(ref, rank):
        """A reference tile's rows edge-padded to the CTU grid, as the
        single-device route pads them (device_pipeline.py:209-211; the
        reference's sharded driver pads with zeros, sharded.py:604-610,
        which differs only where the coded height is off the CTU grid)."""
        out = []
        for c, p in enumerate(ref[rank]):
            extra = (ph >> (c > 0)) - p.shape[1]
            out.append(torch.cat([p, p[:, -1:].expand(-1, extra, -1)], dim=1)
                       if extra else p)
        return tuple(out)

    dpb: dict = {}          # poc -> {rank: (y, cb, cr) uint8 tiles}
    motion_dpb: dict = {}   # poc -> per gop row (dir8, mv8, ref POCs)
    per_frame: dict = {}    # (row, ci) -> (nal, planes, poc)
    clock = _Clock(timing)
    for ci, (poc, st, l0, l1, deltas, qpf) in enumerate(entries):
        planes = _padded(frames, [r * seg + poc for r in range(n_gop)], ph,
                         cw)
        qy, qcb, qcr = tu_qps(sp, qpf)
        lam = lambda_sqrt(qpf)

        def args_of(rank, planes=planes, st=st, l0=l0, l1=l1, qy=qy,
                    qcb=qcb, qcr=qcr, lam=lam, qpf=qpf):
            tiles = _tiles_of(planes, mesh, rank, tile_w)
            if st == 2:
                return (*tiles, lam, qy, qcb, qcr, qpf)
            r0 = pad_ref(dpb[l0[0]], rank)
            r1 = pad_ref(dpb[l1[0]], rank) if st == 0 else r0
            return (*tiles, r0, r1, lam, qy, qcb, qcr, qpf)

        fn = run_i if st == 2 else run_inter(st == 0)
        results = mesh.run(fn, args_of)
        clock.lap("run_s")
        dpb[poc] = {r: (v["rec_y"], v["rec_cb"], v["rec_cr"])
                    for r, v in results.items()}
        evict = [k for k, v in last_use.items() if v == ci and k != poc]
        for p2 in evict:
            dpb.pop(p2, None)
        host = mesh.to_host(results)
        clock.lap("fetch_s")
        rows = [_assemble(host, mesh, r) for r in range(n_gop)]
        # every picture's motion, the IDR's too, for the TMVP replay of
        # later pictures (:649-670)
        if sp.temporal_mvp_enabled:
            rows_m = []
            for res in rows:
                pk = res["packed"][:gh, :gw]
                r8 = pk[..., 7:9].astype(np.int32)
                rp = np.zeros((gh, gw, 2), np.int32)
                for li, lst in ((0, l0), (1, l1)):
                    if lst:
                        lut = np.asarray(lst, np.int32)
                        rp[..., li] = lut[np.clip(r8[..., li], 0,
                                                  len(lst) - 1)]
                rows_m.append((np.ascontiguousarray(pk[..., 2]
                                                    .astype(np.int8)),
                               np.ascontiguousarray(pk[..., 3:7]
                                                    .astype(np.int16)), rp))
            motion_dpb[poc] = rows_m
        for r, res in enumerate(rows):
            mctx = None
            if st != 2:
                col_from_l0 = st != 0
                mctx = MotionCtx(cur_poc=poc, l0_pocs=tuple(l0),
                                 l1_pocs=tuple(l1), tmvp=False,
                                 col_from_l0=col_from_l0,
                                 log2_ctu=sp.log2_ctu)
                if sp.temporal_mvp_enabled:
                    col_poc = (l0[0] if col_from_l0
                               else (l1[0] if l1 else None))
                    col = (motion_dpb.get(col_poc)
                           if col_poc is not None else None)
                    if col is not None:
                        mctx.tmvp = True
                        mctx.col_poc = col_poc
                        mctx.col_dir, mctx.col_mv, mctx.col_refpoc = col[r]
            nal, pl = _slice_nal(sp, cfg, res, qpf, st == 2, st, poc, deltas,
                                 l0, l1, mctx, gop_route=True)
            per_frame[(r, ci)] = (nal, pl, poc)
        # the collocated motion goes only after the pictures that read it
        # (the reference drops it before, sharded.py:643-646 against :695,
        # which turns TMVP off there: ROADMAP S10)
        for p2 in evict:
            motion_dpb.pop(p2, None)
        clock.lap("entropy_s")
    out = bytearray(headers)
    recon_by_disp: dict = {}
    for r in range(n_gop):
        for ci in range(len(entries)):
            nal, pl, poc = per_frame[(r, ci)]
            out += nal
            recon_by_disp[r * seg + poc] = pl
    return bytes(out), [recon_by_disp[i] for i in range(n)]
