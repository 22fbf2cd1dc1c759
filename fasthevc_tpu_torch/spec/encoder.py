"""Spec golden encoder: all-intra HEVC encoder with recursive RDO (NumPy).

Reference parity: HM TEncTop/TEncSlice/TEncCu/TEncSearch (SURVEY.md E3-E7,
call stack §3.1) — reimplemented as a clean decision-then-entropy design:
per CU the search picks a mode via RMD (SATD shortlist) + full RD, the
quadtree is chosen bottom-up, the decided tree is serialized once by the
exact CABAC coder. Slow by construction; serves as the quality anchor and
the oracle for the TPU encoder in fasthevc_tpu/codec.
"""

from __future__ import annotations

import numpy as np

from ..config import EncoderConfig
from ..utils.video import pad_plane, picture_hash
from . import bitstream as bs
from . import ctu as ctu_mod
from . import residual, transform
from .cabac import CabacEncoder, CabacEstimator, ContextSet
from .rdoq import rdoq_quantize
from .ctu import CHROMA_DM, CuDecision, FrameMaps, Planes, TuData
from .syntax import (
    SLICE_I,
    SequenceParams,
    SliceHeader,
    write_buffering_period_sei,
    write_pic_timing_sei,
    write_picture_hash_sei,
    write_pps,
    write_slice_header,
    write_sps,
    write_vps,
)

# 8x8 Hadamard for SATD (HM TComRdCost xCalcHADs8x8 analog).
def _hadamard_matrix(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


_H8 = _hadamard_matrix(8)
_H4 = _hadamard_matrix(4)


def satd(res: np.ndarray) -> int:
    """Sum of absolute Hadamard-transformed differences, 8x8 blocks."""
    n = res.shape[0]
    hn = 8 if n >= 8 else 4
    h = _H8 if hn == 8 else _H4
    total = 0
    r = res.astype(np.int64)
    for by in range(0, n, hn):
        for bx in range(0, n, hn):
            blk = r[by:by + hn, bx:bx + hn]
            total += int(np.abs(h @ blk @ h).sum()) // hn
    return total


def sse(a: np.ndarray, b: np.ndarray) -> int:
    d = a.astype(np.int64) - b.astype(np.int64)
    return int((d * d).sum())


def config_to_sp(cfg: EncoderConfig) -> SequenceParams:
    sp = SequenceParams(
        width=cfg.width, height=cfg.height, bit_depth=cfg.bit_depth,
        log2_ctu=cfg.log2_ctu, log2_min_cu=cfg.log2_min_cu,
        log2_min_tu=cfg.log2_min_tu, log2_max_tu=cfg.log2_max_tu,
        sao_enabled=cfg.sao,
        strong_intra_smoothing=cfg.strong_intra_smoothing,
        init_qp=cfg.qp,
        transquant_bypass_enabled=cfg.lossless,
        sign_data_hiding=cfg.sign_data_hiding and not cfg.lossless,
        deblocking_disabled=not cfg.deblocking,
        tile_cols=cfg.tile_cols,
        tile_rows=cfg.tile_rows,
        transform_skip_enabled=cfg.transform_skip and not cfg.lossless,
        temporal_mvp_enabled=cfg.temporal_mvp,
        weighted_pred=getattr(cfg, "weighted_pred", False),
        weighted_bipred=getattr(cfg, "weighted_pred", False),
        scaling_lists=getattr(cfg, "scaling_lists", False),
        wpp=getattr(cfg, "wpp", False),
        max_transform_hierarchy_depth_inter=(
            1 if getattr(cfg, "rqt_inter", False) else 0),
        max_transform_hierarchy_depth_intra=(
            1 if getattr(cfg, "rqt_intra", False) else 0),
        hrd_enabled=getattr(cfg, "hrd", False),
        frame_rate=getattr(cfg, "frame_rate", 30.0),
    )
    if sp.hrd_enabled and cfg.target_bitrate > 0:
        sp.hrd_bitrate = cfg.target_bitrate
        sp.hrd_cpb_size = 2 * cfg.target_bitrate
    return sp


def hrd_reorder_delay(cfg) -> int:
    """sps-style max reorder (coding index ahead of display) of the GOP
    table — the constant in pic-timing dpb_output_delay accounting."""
    if not cfg.gop:
        return 0
    r = 0
    for i, e in enumerate(cfg.gop):
        r = max(r, (i + 1) - e.poc_offset)
    return max(0, r)


class SpecEncoder:
    """All-intra golden encoder."""

    def __init__(self, cfg: EncoderConfig) -> None:
        cfg.validate()
        self.cfg = cfg
        self.sp = config_to_sp(cfg)
        # lossless pictures are never filtered (transquant-bypass CUs)
        self.sp.sao_enabled = cfg.sao and not cfg.lossless
        self.sp.deblocking_disabled = (not cfg.deblocking) or cfg.lossless
        self.lambda_mode = 0.57 * 2.0 ** ((cfg.qp - 12) / 3.0)

    # -- public API --------------------------------------------------------

    def encode(self, frames, start_poc: int = 0,
               write_headers: bool = True,
               on_frame=None) -> tuple[bytes, list]:
        """Encode (y, cb, cr) uint8 frames -> (annexb bytes, recon frames).

        GOP structure: frame 0 (and every intra_period-th frame) is an IDR
        I picture; other frames are low-delay P referencing the previous
        reconstructed picture (HM LDP shape with one active ref).

        start_poc / write_headers support GOP-journal resume
        (codec/journal.py): resuming at an IDR boundary with start_poc=k
        reproduces the uninterrupted stream exactly.
        on_frame(poc, is_idr, nal_bytes) is called per picture.
        """
        sp = self.sp
        out = bytearray()
        if write_headers:
            headers = (bs.write_nal(bs.NAL_VPS, write_vps(sp))
                       + bs.write_nal(bs.NAL_SPS, write_sps(sp))
                       + bs.write_nal(bs.NAL_PPS, write_pps(sp)))
            out += headers
            if on_frame is not None:
                on_frame(-1, False, bytes(headers))  # poc -1 = headers
        recons: dict = {}
        self.dpb: dict[int, Planes] = {}
        rc = None
        if self.cfg.target_bitrate > 0:
            from ..codec.rate_control import RateController
            rc = RateController(self.cfg.target_bitrate,
                                self.cfg.frame_rate,
                                sp.coded_width, sp.coded_height)
        from ..codec.gop import coding_order, ref_lists
        order = coding_order(self.cfg, len(frames), start_poc)
        last_idr = start_poc
        au_since_bp = 0
        au_idx_cvs = 0
        reorder = hrd_reorder_delay(self.cfg)
        for poc, slice_type, ref_deltas, qp_off in order:
            is_idr = slice_type == SLICE_I
            if is_idr:
                last_idr = poc
                self.dpb = {}
                au_since_bp = 0
                au_idx_cvs = 0
            cvs_poc = poc - last_idr  # POC resets at IDR (spec 8.3.1)
            if sp.hrd_enabled:
                if is_idr:
                    out += bs.write_nal(bs.NAL_PREFIX_SEI,
                                        write_buffering_period_sei(sp))
                out += bs.write_nal(
                    bs.NAL_PREFIX_SEI,
                    write_pic_timing_sei(sp, au_since_bp,
                                         cvs_poc - au_idx_cvs + reorder))
                au_since_bp += 1
                au_idx_cvs += 1
            slice_type, refs_l0, refs_l1, (before, after) = ref_lists(
                self.dpb, cvs_poc, slice_type, ref_deltas, is_idr,
                self.cfg.num_ref_per_list)
            if rc is not None:
                qp = rc.picture_qp(len(frames), is_intra=is_idr)
            else:
                # temporal-layer QP cascade (HM TEncGOP, SURVEY.md §3.5)
                qp = min(max(self.cfg.qp + qp_off, 0), 51)
            nal_bytes, planes = self.encode_frame(
                frames[poc - start_poc], poc=cvs_poc,
                slice_type=slice_type, refs=(refs_l0, refs_l1), qp=qp,
                ref_deltas=(before, after))
            if rc is not None:
                rc.update_after_picture(len(nal_bytes) * 8)
            out += nal_bytes
            recons[poc] = planes
            if on_frame is not None:
                on_frame(poc, is_idr, bytes(nal_bytes))
            # DPB holds RefPic records: planes + motion field + active
            # list POCs, so a later picture's TMVP can read them
            from .inter import RefPic
            mctx = self.maps.mctx
            self.dpb[cvs_poc] = RefPic(
                planes, cvs_poc, self.maps.motion,
                mctx.l0_pocs if mctx else (), mctx.l1_pocs if mctx else ())
        return bytes(out), [recons[start_poc + i]
                            for i in range(len(frames))]

    def encode_frame(self, frame, poc: int = 0, slice_type: int = SLICE_I,
                     refs=((), ()), qp: int | None = None,
                     ref_deltas=((), ())) -> tuple[bytes, Planes]:
        sp = self.sp
        y, cb, cr = frame
        src = Planes(sp)
        src.y[:] = pad_plane(np.asarray(y, dtype=np.int32),
                             sp.coded_height, sp.coded_width)
        src.cb[:] = pad_plane(np.asarray(cb, dtype=np.int32),
                              sp.coded_height // 2, sp.coded_width // 2)
        src.cr[:] = pad_plane(np.asarray(cr, dtype=np.int32),
                              sp.coded_height // 2, sp.coded_width // 2)

        self.src = src
        self.planes = Planes(sp)
        self.maps = FrameMaps(sp)
        self.qp = self.cfg.qp if qp is None else qp
        self.lambda_mode = 0.57 * 2.0 ** ((self.qp - 12) / 3.0)
        self.qp_y, self.qp_cb, self.qp_cr = ctu_mod.tu_qps(sp, self.qp)
        init_type = 0 if slice_type == SLICE_I else (
            1 if slice_type == 1 else 2)
        self.est = CabacEstimator(ContextSet(init_type, self.qp))
        self.slice_type = slice_type
        self.refs = (list(refs[0]), list(refs[1]))

        # per-slice reference context: active-list POCs + collocated
        # motion for TMVP (spec 8.5.3.2.7); refs may be bare Planes from
        # direct encode_frame callers — then POCs degenerate to 0 and
        # TMVP stays off, reproducing single-ref semantics
        from .inter import build_mctx
        mctx = build_mctx(sp, poc, slice_type, self.refs[0], self.refs[1])
        # explicit weighted prediction (E13): per-slice DC/AC estimation
        # vs each active ref; every mc_cu_motion below applies the tables
        self.wp = None
        use_wp = ((sp.weighted_pred and slice_type == 1)
                  or (sp.weighted_bipred and slice_type == 0))
        if use_wp and self.refs[0]:
            from .wp import estimate_wp_tables
            self.wp = estimate_wp_tables(
                (src.y, src.cb, src.cr), self.refs[0], self.refs[1],
                sp.bit_depth)
        if mctx is not None:
            mctx.wp = self.wp
        self.maps.mctx = mctx

        ctu_size = 1 << sp.log2_ctu
        n_slices = max(1, getattr(self.cfg, "slices", 1))
        if n_slices > 1:
            # multi-slice (SURVEY.md P3): row-aligned independent slice
            # segments; the full-width rects reuse the tile availability
            # machinery so prediction/contexts never cross a slice edge
            n_rows = sp.ctus_y()
            sbounds = [(i * n_rows) // n_slices
                       for i in range(n_slices + 1)]
            tile_rects, tile_ctus = [], []
            for s in range(n_slices):
                r0, r1 = sbounds[s], sbounds[s + 1]
                tile_rects.append((0, r0 * ctu_size, sp.coded_width,
                                   r1 * ctu_size))
                tile_ctus.append([(cx * ctu_size, cy * ctu_size)
                                  for cy in range(r0, r1)
                                  for cx in range(sp.ctus_x())])
            constrain = True
        else:
            tile_ctus = sp.tile_ctus()
            tile_rects = sp.tile_rects()
            constrain = sp.tiles_enabled
        tile_decisions = []
        for rect, ctus in zip(tile_rects, tile_ctus):
            self.maps.tile_rect = rect if constrain else None
            self.planes.tile_rect = rect if constrain else None
            decs = []
            for cx, cy in ctus:
                cu, _ = self._compress_cu(cx, cy, sp.log2_ctu, 0)
                decs.append((cx, cy, cu))
            tile_decisions.append(decs)
        self.maps.tile_rect = None
        self.planes.tile_rect = None

        # in-loop filters BEFORE entropy: SAO params are slice syntax
        if not sp.deblocking_disabled:
            from .deblock import deblock_picture
            deblock_picture(self.planes, sp,
                            self.maps.depth[::2, ::2].astype(np.int32),
                            self.qp, self.qp_cb, self.qp_cr,
                            maps=None if slice_type == SLICE_I else
                            self.maps)
        sao_params = None
        if sp.sao_enabled:
            from . import sao as sao_mod
            sao_params = self._estimate_sao(sao_mod)

        # serialize: per-tile CABAC substreams, then slice header with
        # entry points (tile substream sizes), then concatenation
        is_idr = slice_type == SLICE_I
        nal_type = bs.NAL_IDR_W_RADL if is_idr else bs.NAL_TRAIL_R
        maps2 = FrameMaps(sp)
        maps2.mctx = mctx  # the entropy replay derives the same lists
        if n_slices > 1:
            nal = self._serialize_multi_slice(
                sp, slice_type, poc, ref_deltas, mctx, tile_rects,
                tile_decisions, sbounds, sao_params, maps2, nal_type,
                is_idr)
            if sao_params is not None:
                from . import sao as sao_mod
                sao_mod.apply_sao(self.planes, sp, *sao_params)
            ht = self.cfg.hash_type
            md5s = picture_hash(
                (self.planes.y, self.planes.cb, self.planes.cr), ht)
            nal += bs.write_nal(bs.NAL_SUFFIX_SEI,
                                write_picture_hash_sei(md5s, ht))
            return nal, self.planes
        col_starts = set(b * ctu_size for b in sp.tile_col_bounds()[1:-1])
        row_starts = set(b * ctu_size for b in sp.tile_row_bounds()[1:-1])
        if sp.wpp:
            substreams = self._serialize_wpp(sp, slice_type, init_type,
                                             maps2, tile_decisions[0],
                                             sao_params)
            tile_decisions = []  # rows serialized; skip the tile loop
        else:
            substreams = []
        n_tiles = len(tile_decisions)
        for t, (rect, decs) in enumerate(zip(tile_rects, tile_decisions)):
            maps2.tile_rect = rect if sp.tiles_enabled else None
            wt = bs.BitWriter()
            enc = CabacEncoder(wt, ContextSet(init_type, self.qp))
            for i, (cx, cy, cu) in enumerate(decs):
                if sao_params is not None:
                    from . import sao as sao_mod
                    ry, rx = cy // ctu_size, cx // ctu_size
                    sao_mod.encode_sao_ctu(
                        enc, sao_params[0][ry][rx], sao_params[1][ry][rx],
                        sao_params[2][ry][rx], rx, ry, True, True,
                        left_in_tile=cx not in col_starts,
                        up_in_tile=cy not in row_starts)
                ctu_mod.encode_ctu(enc, maps2, sp, cx, cy, cu, slice_type)
                last_of_slice = (t == n_tiles - 1 and i == len(decs) - 1)
                enc.encode_terminate(1 if last_of_slice else 0)
                if i == len(decs) - 1 and not last_of_slice:
                    enc.encode_terminate(1)  # end_of_subset_one_bit
            enc.finish()
            wt.byte_align()
            substreams.append(wt.get_bytes())
        sh = SliceHeader(slice_type=slice_type, slice_qp=self.qp,
                         is_idr=is_idr,
                         poc_lsb=poc & ((1 << sp.log2_max_poc_lsb) - 1),
                         ref_pocs_before=() if is_idr else ref_deltas[0],
                         ref_pocs_after=() if is_idr else ref_deltas[1],
                         num_ref_idx_l0=max(1, len(self.refs[0])),
                         num_ref_idx_l1=max(1, len(self.refs[1])),
                         temporal_mvp=bool(mctx and mctx.tmvp),
                         collocated_from_l0=(mctx.col_from_l0 if mctx
                                             else True),
                         sao_luma=sp.sao_enabled, sao_chroma=sp.sao_enabled,
                         entry_points=tuple(len(s) for s in
                                            substreams[:-1]),
                         wp=getattr(self, "wp", None))
        w = write_slice_header(sh, sp, nal_type)
        for s in substreams:
            w.append_bytes(s)
        nal = bs.write_nal(nal_type, w.get_bytes())
        if sao_params is not None:
            from . import sao as sao_mod
            sao_mod.apply_sao(self.planes, sp, *sao_params)
        # decoded picture hash SEI (suffix)
        ht = self.cfg.hash_type
        md5s = picture_hash((self.planes.y, self.planes.cb, self.planes.cr),
                            ht)
        nal += bs.write_nal(bs.NAL_SUFFIX_SEI,
                            write_picture_hash_sei(md5s, ht))
        return nal, self.planes

    def _serialize_wpp(self, sp, slice_type, init_type, maps2, decs,
                       sao_params) -> list:
        """WPP serialization (SURVEY.md P2, spec 9.3.1): one CABAC
        substream per CTU row; row r > 0 inherits the context state
        stored after the SECOND CTB of row r-1 (fresh slice-start init
        when the picture is one CTB wide).  Returns the per-row
        byte-aligned substreams (entry points = their sizes)."""
        ctu_size = 1 << sp.log2_ctu
        n_x = sp.ctus_x()
        rows = [decs[i * n_x:(i + 1) * n_x] for i in range(sp.ctus_y())]
        substreams = []
        inherit = None
        next_inherit = None
        if sao_params is not None:
            from . import sao as sao_mod
        for ri, row in enumerate(rows):
            ctx = (inherit.copy() if inherit is not None
                   else ContextSet(init_type, self.qp))
            wt = bs.BitWriter()
            enc = CabacEncoder(wt, ctx)
            for i, (cx, cy, cu) in enumerate(row):
                if sao_params is not None:
                    ry, rx = cy // ctu_size, cx // ctu_size
                    sao_mod.encode_sao_ctu(
                        enc, sao_params[0][ry][rx], sao_params[1][ry][rx],
                        sao_params[2][ry][rx], rx, ry, True, True,
                        left_in_tile=True, up_in_tile=True)
                ctu_mod.encode_ctu(enc, maps2, sp, cx, cy, cu, slice_type)
                if i == 1:
                    next_inherit = enc.ctx.copy()  # sync point (9.3.1)
                last_of_slice = (ri == len(rows) - 1
                                 and i == len(row) - 1)
                enc.encode_terminate(1 if last_of_slice else 0)
                if i == len(row) - 1 and not last_of_slice:
                    enc.encode_terminate(1)  # end_of_subset_one_bit
            enc.finish()
            wt.byte_align()
            substreams.append(wt.get_bytes())
            inherit = next_inherit if n_x >= 2 else None
        return substreams

    def _serialize_multi_slice(self, sp, slice_type, poc, ref_deltas,
                               mctx, slice_rects, slice_decisions,
                               sbounds, sao_params, maps2, nal_type,
                               is_idr) -> bytes:
        """Emit one NAL per independent slice segment (SURVEY.md P3):
        per-slice CABAC init, slice_segment_address in the header, and
        end_of_slice_segment_flag = 1 on each slice's last CTU."""
        ctu_size = 1 << sp.log2_ctu
        init_type = 0 if slice_type == SLICE_I else (
            1 if slice_type == 1 else 2)
        out = bytearray()
        for si, (rect, decs) in enumerate(zip(slice_rects,
                                              slice_decisions)):
            maps2.tile_rect = rect
            wt = bs.BitWriter()
            enc = CabacEncoder(wt, ContextSet(init_type, self.qp))
            y0 = rect[1]
            for i, (cx, cy, cu) in enumerate(decs):
                if sao_params is not None:
                    from . import sao as sao_mod
                    ry, rx = cy // ctu_size, cx // ctu_size
                    sao_mod.encode_sao_ctu(
                        enc, sao_params[0][ry][rx], sao_params[1][ry][rx],
                        sao_params[2][ry][rx], rx, ry, True, True,
                        left_in_tile=True, up_in_tile=cy != y0)
                ctu_mod.encode_ctu(enc, maps2, sp, cx, cy, cu, slice_type)
                enc.encode_terminate(1 if i == len(decs) - 1 else 0)
            enc.finish()
            wt.byte_align()
            sh = SliceHeader(
                slice_type=slice_type, slice_qp=self.qp, is_idr=is_idr,
                poc_lsb=poc & ((1 << sp.log2_max_poc_lsb) - 1),
                first_slice=si == 0,
                segment_address=sbounds[si] * sp.ctus_x(),
                ref_pocs_before=() if is_idr else ref_deltas[0],
                ref_pocs_after=() if is_idr else ref_deltas[1],
                num_ref_idx_l0=max(1, len(self.refs[0])),
                num_ref_idx_l1=max(1, len(self.refs[1])),
                temporal_mvp=bool(mctx and mctx.tmvp),
                collocated_from_l0=(mctx.col_from_l0 if mctx else True),
                sao_luma=sp.sao_enabled, sao_chroma=sp.sao_enabled,
                wp=getattr(self, "wp", None))
            w = write_slice_header(sh, sp, nal_type)
            w.append_bytes(wt.get_bytes())
            out += bs.write_nal(nal_type, w.get_bytes())
        maps2.tile_rect = None
        return bytes(out)

    def _estimate_sao(self, sao_mod):
        """Per-CTB SAO parameter estimation for all three components."""
        sp = self.sp
        ctb = 1 << sp.log2_ctu
        n_y = -(-sp.coded_height // ctb)
        n_x = -(-sp.coded_width // ctb)
        out = ([], [], [])
        for by in range(n_y):
            rows = [[], [], []]
            for bx in range(n_x):
                half = ctb // 2
                ys = slice(by * ctb, (by + 1) * ctb)
                xs = slice(bx * ctb, (bx + 1) * ctb)
                cys = slice(by * half, (by + 1) * half)
                cxs = slice(bx * half, (bx + 1) * half)
                p_y = sao_mod.estimate_ctb(self.src.y[ys, xs],
                                           self.planes.y[ys, xs],
                                           sp.bit_depth)
                p_cb = sao_mod.estimate_ctb(self.src.cb[cys, cxs],
                                            self.planes.cb[cys, cxs],
                                            sp.bit_depth)
                # Cr shares Cb's type/class (spec); offsets re-estimated
                p_cr = sao_mod.estimate_ctb_given(
                    self.src.cr[cys, cxs], self.planes.cr[cys, cxs],
                    p_cb.type_idx, p_cb.eo_class, sp.bit_depth)
                rows[0].append(p_y)
                rows[1].append(p_cb)
                rows[2].append(p_cr)
            for ci in range(3):
                out[ci].append(rows[ci])
        return out

    # -- RDO ---------------------------------------------------------------

    def _granule_arrays(self):
        m = self.maps
        return (m.depth, m.mode, m.coded, m.skip, m.tusplit,
                m.motion.inter, m.motion.mv, m.motion.ref_idx,
                m.motion.cbf_y)

    def _save_state(self, x, y, size):
        cs = size >> 1
        cx, cy = x >> 1, y >> 1
        g = slice(y >> 2, (y + size) >> 2), slice(x >> 2, (x + size) >> 2)
        return (
            self.planes.y[y:y + size, x:x + size].copy(),
            self.planes.cb[cy:cy + cs, cx:cx + cs].copy(),
            self.planes.cr[cy:cy + cs, cx:cx + cs].copy(),
            tuple(a[g].copy() for a in self._granule_arrays()),
            self.est.ctx.copy(),
        )

    def _restore_state(self, x, y, size, st):
        cs = size >> 1
        cx, cy = x >> 1, y >> 1
        g = slice(y >> 2, (y + size) >> 2), slice(x >> 2, (x + size) >> 2)
        (self.planes.y[y:y + size, x:x + size],
         self.planes.cb[cy:cy + cs, cx:cx + cs],
         self.planes.cr[cy:cy + cs, cx:cx + cs]) = st[0], st[1], st[2]
        for a, saved in zip(self._granule_arrays(), st[3]):
            a[g] = saved
        self.est.ctx = st[4]

    def _compress_cu(self, x, y, log2_size, depth):
        """Returns (CuDecision, rd_cost). Commits recon/maps/est of the
        winning alternative into self state."""
        sp = self.sp
        size = 1 << log2_size
        inside = (x + size <= sp.coded_width) and (y + size <= sp.coded_height)

        if not inside:
            # forced split; code only children inside the picture
            cu = CuDecision(split=True, children=[])
            cost = 0.0
            half = size >> 1
            for i in range(4):
                cx_, cy_ = x + (i & 1) * half, y + (i >> 1) * half
                if cx_ < sp.coded_width and cy_ < sp.coded_height:
                    child, c = self._compress_cu(cx_, cy_, log2_size - 1,
                                                 depth + 1)
                    cu.children.append(child)
                    cost += c
                else:
                    cu.children.append(None)
            return cu, cost

        can_split = log2_size > sp.log2_min_cu

        pre = self._save_state(x, y, size)
        nosplit_cu, nosplit_cost = self._try_cu_modes(x, y, log2_size, depth)
        if can_split:
            nosplit_cost += self.lambda_mode * self._split_flag_bits(
                x, y, depth, 0, pre[4])
        if not can_split or (self.cfg.fast_partition and False):
            return nosplit_cu, nosplit_cost

        post_nosplit = self._save_state(x, y, size)
        self._restore_state(x, y, size, pre)

        split_cost = self.lambda_mode * self._split_flag_bits(
            x, y, depth, 1, pre[4])
        cu = CuDecision(split=True, children=[])
        half = size >> 1
        for i in range(4):
            cx_, cy_ = x + (i & 1) * half, y + (i >> 1) * half
            child, c = self._compress_cu(cx_, cy_, log2_size - 1, depth + 1)
            cu.children.append(child)
            split_cost += c

        if nosplit_cost <= split_cost:
            self._restore_state(x, y, size, post_nosplit)
            return nosplit_cu, nosplit_cost
        return cu, split_cost

    def _split_flag_bits(self, x, y, depth, value, ctx_set) -> float:
        est = CabacEstimator(ctx_set.copy())
        est.encode_bin("split_cu_flag",
                       ctu_mod._split_ctx(self.maps, x, y, depth), value)
        return est.bits

    def _try_cu_modes(self, x, y, log2_size, depth):
        """Pick the best intra mode for a no-split CU; commit recon + maps
        + estimator context. Returns (CuDecision, rd_cost)."""
        sp = self.sp
        n = 1 << log2_size
        src_y = self.src.y[y:y + n, x:x + n]
        entry_state = (self._save_state(x, y, n)
                       if (log2_size == sp.log2_min_cu
                           and self.cfg.nxn_intra) else None)

        # --- RMD: SATD over all 35 modes. Intra prediction tops out at the
        # max TU size (32), so for a 64x64 CU the shortlist is computed on
        # its first 32x32 TU (the full RD stage below handles all TUs).
        rmd_log2 = min(log2_size, sp.log2_max_tu)
        rmd_n = 1 << rmd_log2
        rmd_src = self.src.y[y:y + rmd_n, x:x + rmd_n]
        lm, am, in_ctu = self.maps.neighbor_modes(x, y)
        cands = ctu_mod.intra.mpm_candidates(lm, am, in_ctu)
        satd_costs = []
        for mode in range(35):
            pred = ctu_mod.predict_block(self.planes, sp, x, y, rmd_log2,
                                         mode, 0)
            # approximate mode bits: MPM ~2 bits, else ~6
            mode_bits = 2.0 if mode in cands else 6.0
            cost = satd(rmd_src - pred) + self.lambda_mode * mode_bits
            satd_costs.append((cost, mode))
        satd_costs.sort()
        k = self.cfg.num_intra_rd_candidates
        rd_modes = [m for _, m in satd_costs[:k]]
        for m in cands:
            if m not in rd_modes:
                rd_modes.append(m)

        best = None
        for mode in rd_modes:
            cu = CuDecision(split=False, luma_mode=mode,
                            chroma_mode=CHROMA_DM, bypass=self.cfg.lossless)
            dist, tus = self._build_tus(x, y, log2_size, cu)
            cu.tus = tus
            est = CabacEstimator(self.est.ctx.copy())
            self._est_cu_syntax(est, x, y, log2_size, cu)
            cost = dist + self.lambda_mode * est.bits
            if best is None or cost < best[0]:
                best = (cost, cu)
            # restore recon after each trial (the trial wrote planes)
        # depth-1 intra RQT (SURVEY.md E7): try split_transform_flag = 1
        # for the winning mode — 4 sub-TBs each predicted from the
        # previous sub-TB's recon (finer prediction at 2x the TQ cost)
        if (sp.max_transform_hierarchy_depth_intra > 0
                and not self.cfg.lossless
                and sp.log2_min_tu + 1 < log2_size <= sp.log2_max_tu):
            import copy as _copy
            cu2 = _copy.copy(best[1])
            cu2.tu_split = True
            dist2, tus2 = self._build_tus(x, y, log2_size, cu2, split=True)
            cu2.tus = tus2
            est2 = CabacEstimator(self.est.ctx.copy())
            self._est_cu_syntax(est2, x, y, log2_size, cu2)
            cost2 = dist2 + self.lambda_mode * est2.bits
            if cost2 < best[0]:
                best = (cost2, cu2)
        cost, cu = best

        # ---- inter candidates (P/B slices) --------------------------------
        if self.slice_type != SLICE_I and self.refs[0]:
            icost, icu = self._try_inter(x, y, log2_size)
            if icu is not None and icost < cost:
                cost, cu = icost, icu
                ctu_mod._reconstruct_inter_cu(self.planes, sp, x, y,
                                              log2_size, cu, self.refs,
                                              self.qp,
                                              wp=getattr(self, "wp", None))
                self.maps.set_cu(x, y, n, depth, -1)
                self.maps.set_skip(x, y, n, cu.skip)
                cbf_y = any(tu.levels_y is not None for tu in cu.tus)
                self.maps.motion.set_cu(x, y, n, cu.motion, cbf_y)
                ctu_mod.apply_tu_cbf(self.maps, x, y, n, cu)
                self._est_cu_syntax(self.est, x, y, log2_size, cu)
                return cu, cost

        # rebuild the winner (recon currently holds last trial)
        dist, tus = self._build_tus(x, y, log2_size, cu,
                                    split=cu.tu_split)
        cu.tus = tus
        self.maps.set_cu(x, y, n, depth, cu.luma_mode)
        self.maps.set_skip(x, y, n, False)
        self.maps.tusplit[y >> 2:(y + n) >> 2,
                          x >> 2:(x + n) >> 2] = cu.tu_split
        self.maps.motion.set_intra_cu(
            x, y, n, any(tu.levels_y is not None for tu in cu.tus))
        self._est_cu_syntax(self.est, x, y, log2_size, cu)

        # ---- PART_NxN alternative at min CU (SURVEY.md E7/C5: makes the
        # 4x4 luma TB / DST-VII path reachable) -------------------------
        if (log2_size == sp.log2_min_cu and self.cfg.nxn_intra
                and entry_state is not None):
            post_2nx2n = self._save_state(x, y, n)
            self._restore_state(x, y, n, entry_state)
            ncost, ncu = self._try_nxn(x, y, log2_size, depth)
            if ncost < cost:
                return ncu, ncost
            self._restore_state(x, y, n, post_2nx2n)
        return cu, cost

    def _try_nxn(self, x, y, log2_size, depth):
        """PART_NxN RD: per-PU (z-order) RMD + RD mode choice with exact
        recon feedback (each PU predicts from the previous PUs' recon),
        then the 4x4 chroma TB and an exact syntax-bit estimate. Commits
        recon/maps/est. Returns (cost, CuDecision)."""
        sp = self.sp
        half = 1 << (log2_size - 1)
        bypass = self.cfg.lossless
        modes, tus = [], []
        dist_total = 0.0
        for i, (dx, dy) in enumerate(ctu_mod._pu_offsets(1 << log2_size)):
            px, py = x + dx, y + dy
            src = self.src.y[py:py + half, px:px + half]
            lm, am, in_ctu = self.maps.neighbor_modes(px, py)
            cands = ctu_mod.intra.mpm_candidates(lm, am, in_ctu)
            satd_costs = []
            for mode in range(35):
                pred = ctu_mod.predict_block(self.planes, sp, px, py,
                                             log2_size - 1, mode, 0)
                mode_bits = 2.0 if mode in cands else 6.0
                satd_costs.append((satd(src - pred)
                                   + self.lambda_mode * mode_bits, mode))
            satd_costs.sort()
            rd_modes = [m for _, m in
                        satd_costs[:self.cfg.num_intra_rd_candidates]]
            for m in cands:
                if m not in rd_modes:
                    rd_modes.append(m)
            best = None
            for mode in rd_modes:
                d, levels, ts = self._build_luma_tb(px, py, log2_size - 1,
                                                    mode, bypass)
                est = CabacEstimator(self.est.ctx.copy())
                est.encode_bin("cbf_luma", 0, int(levels is not None))
                if levels is not None:
                    if sp.transform_skip_enabled and not bypass:
                        est.encode_bin("transform_skip_flag", 0, int(ts))
                    scan = residual.intra_scan_idx(log2_size - 1, 0, mode)
                    residual.encode_residual(est, levels, log2_size - 1,
                                             0, scan,
                                             sp.sign_data_hiding
                                             and not bypass)
                mode_bits = (2.0 if mode == cands[0] else
                             3.0 if mode in cands else 6.0)
                c = d + self.lambda_mode * (est.bits + mode_bits)
                if best is None or c < best[0]:
                    best = (c, mode, levels, d, ts)
            _, mode_i, levels_i, d_i, ts_i = best
            # re-apply the winning PU's recon (trials overwrote it)
            ctu_mod.reconstruct_tb(self.planes, sp, px, py, log2_size - 1,
                                   mode_i, 0, levels_i, self.qp_y, bypass,
                                   ts_i)
            self.maps.set_cu(px, py, half, depth, mode_i)
            modes.append(mode_i)
            tus.append(TuData(levels_y=levels_i, ts_y=ts_i))
            dist_total += d_i
        cu = CuDecision(split=False, nxn=True, luma_modes=tuple(modes),
                        chroma_mode=CHROMA_DM, bypass=bypass, tus=tus)
        # chroma 4x4 (DM from PU0), carried by tus[3]
        cmode = ctu_mod.chroma_mode_from_cu(cu)
        cx, cy = x >> 1, y >> 1
        for c_idx, qp in ((1, self.qp_cb), (2, self.qp_cr)):
            src_c = self.src.plane(c_idx)[cy:cy + half, cx:cx + half]
            pred = ctu_mod.predict_block(self.planes, sp, cx, cy,
                                         log2_size - 1, cmode, c_idx)
            res = src_c - pred
            ts = False
            if bypass:
                levels = res.astype(np.int32)
                if not levels.any():
                    levels = None
            else:
                levels, ts = self._tq_intra_tb(
                    res, qp, log2_size - 1, c_idx,
                    residual.intra_scan_idx(log2_size - 1, c_idx, cmode))
            ctu_mod.reconstruct_tb(self.planes, sp, cx, cy, log2_size - 1,
                                   cmode, c_idx, levels, qp, bypass, ts)
            rec = self.planes.plane(c_idx)[cy:cy + half, cx:cx + half]
            dist_total += sse(src_c, rec)
            if c_idx == 1:
                tus[3].levels_cb = levels
                tus[3].ts_cb = ts
            else:
                tus[3].levels_cr = levels
                tus[3].ts_cr = ts
        est = CabacEstimator(self.est.ctx.copy())
        self._est_cu_syntax(est, x, y, log2_size, cu)
        cost = dist_total + self.lambda_mode * est.bits
        n = 1 << log2_size
        self.maps.set_skip(x, y, n, False)
        self.maps.motion.set_intra_cu(
            x, y, n, any(tu.levels_y is not None for tu in tus))
        self._est_cu_syntax(self.est, x, y, log2_size, cu)
        return cost, cu

    def _tq_intra_tb(self, res, qp, blog2, c_idx, scan):
        """TQ one intra TB, choosing DCT/DST vs transform_skip by RD when
        the PPS enables TS and the TB is 4x4. Returns (levels|None, ts)."""
        sp = self.sp
        use_dst = (c_idx == 0 and blog2 == 2)
        variants = ((False,) if not (sp.transform_skip_enabled
                                     and blog2 == 2) else (False, True))
        best = None
        for ts in variants:
            if ts:
                coeffs = transform.forward_transform_skip(res, sp.bit_depth)
                levels = transform.quantize(coeffs, qp, sp.bit_depth,
                                            is_intra=True,
                                            m=self._m(blog2, True, c_idx))
            else:
                coeffs = transform.forward_transform(res, sp.bit_depth,
                                                     use_dst)
                levels = self._quantize_tb(coeffs, qp, True, blog2, c_idx,
                                           scan)
            if sp.sign_data_hiding and levels.any():
                levels = residual.sdh_adjust(levels, coeffs, qp,
                                             sp.bit_depth, blog2, scan)
            deq = transform.dequantize(levels, qp, sp.bit_depth,
                                       m=self._m(blog2, True, c_idx))
            if ts:
                rhat = transform.inverse_transform_skip(deq, sp.bit_depth)
            else:
                rhat = transform.inverse_transform(deq, sp.bit_depth,
                                                   use_dst)
            a = np.abs(levels)
            bits = float((a > 0).sum()) * 2.0 + \
                2.0 * float(np.log2(1.0 + a[a > 0]).sum())
            cost = sse(res, rhat) + self.lambda_mode * bits
            if best is None or cost < best[0]:
                best = (cost, levels if levels.any() else None, ts)
        return best[1], best[2]

    _rdoq_ctx_cache: dict = {}

    def _m(self, blog2, is_intra, c_idx):
        """Active ScalingFactor matrix for a TB (None = flat 16)."""
        if not getattr(self.sp, "scaling_lists", False):
            return None
        from .scaling import scaling_matrix
        return scaling_matrix(self.sp, 1 << blog2, not is_intra, c_idx)

    def _quantize_tb(self, coeffs, qp, is_intra, blog2, c_idx, scan):
        """Quantize one TB: trellis RDOQ (spec/rdoq.py) when cfg.rdoq,
        else the HM dead-zone quantizer (SURVEY.md C5).  With scaling
        lists the matrix-aware dead-zone quantizer is used (the trellis
        rate model assumes the flat list, HM QpParam-style)."""
        m = self._m(blog2, is_intra, c_idx)
        if m is not None:
            return transform.quantize(coeffs, qp, self.sp.bit_depth,
                                      is_intra=is_intra, m=m)
        if not getattr(self.cfg, "rdoq", False):
            return transform.quantize(coeffs, qp, self.sp.bit_depth,
                                      is_intra=is_intra)
        key = (0 if is_intra else 2, qp)
        ctx = self._rdoq_ctx_cache.get(key)
        if ctx is None:
            ctx = self._rdoq_ctx_cache[key] = ContextSet(*key)
        return rdoq_quantize(coeffs, qp, self.sp.bit_depth, blog2,
                             0 if c_idx == 0 else 1, scan,
                             self.lambda_mode, ctx)

    def _build_luma_tb(self, x, y, blog2, mode, bypass):
        """TQ + reconstruct one luma TB; returns (sse_dist, levels|None,
        transform_skip)."""
        sp = self.sp
        bn = 1 << blog2
        src = self.src.y[y:y + bn, x:x + bn]
        pred = ctu_mod.predict_block(self.planes, sp, x, y, blog2, mode, 0)
        res = src - pred
        ts = False
        if bypass:
            levels = res.astype(np.int32)
            if not levels.any():
                levels = None
        else:
            levels, ts = self._tq_intra_tb(
                res, self.qp_y, blog2, 0,
                residual.intra_scan_idx(blog2, 0, mode))
        ctu_mod.reconstruct_tb(self.planes, sp, x, y, blog2, mode, 0,
                               levels, self.qp_y, bypass, ts)
        rec = self.planes.y[y:y + bn, x:x + bn]
        return sse(src, rec), levels, ts

    # ---- inter search ----------------------------------------------------

    def _try_inter(self, x, y, log2_size):
        """Evaluate merge candidates + per-list ME (+ BI for B slices);
        returns (cost, CuDecision|None). Does not commit."""
        from . import inter as inter_mod
        from .inter import DIR_BI, DIR_L0, DIR_L1, Motion
        from .mc import mc_luma

        sp = self.sp
        n = 1 << log2_size
        src_y = self.src.y[y:y + n, x:x + n]
        is_b = self.slice_type == 0
        merge_cands = inter_mod.merge_candidates(
            self.maps, self.maps.motion, x, y, n, is_b)

        def run_me(list_idx, ref_idx):
            refs = self.refs[list_idx]
            if ref_idx >= len(refs):
                return None, None, None
            ref = refs[ref_idx]
            amvp = inter_mod.amvp_candidates(self.maps, self.maps.motion,
                                             x, y, n, list_idx, ref_idx)
            base_x, base_y = amvp[0][0] >> 2, amvp[0][1] >> 2

            def int_sad(ix, iy):
                px = np.clip(np.arange(x + ix, x + ix + n), 0,
                             sp.coded_width - 1)
                py = np.clip(np.arange(y + iy, y + iy + n), 0,
                             sp.coded_height - 1)
                return int(np.abs(src_y - ref.y[np.ix_(py, px)]).sum())

            r = min(self.cfg.search_range, 12)
            best_sad, best_int = None, (base_x, base_y)
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    sad = int_sad(base_x + dx, base_y + dy)
                    if best_sad is None or sad < best_sad:
                        best_sad = sad
                        best_int = (base_x + dx, base_y + dy)
            best_mv = (best_int[0] << 2, best_int[1] << 2)
            for step in (2, 1):
                center = best_mv
                for dy in (-step, 0, step):
                    for dx in (-step, 0, step):
                        mv = (center[0] + dx, center[1] + dy)
                        if mv == center:
                            continue
                        pred = mc_luma(ref.y, x, y, n, n, mv[0], mv[1],
                                       sp.bit_depth)
                        sad = int(np.abs(src_y - pred).sum())
                        if sad < best_sad:
                            best_sad, best_mv = sad, mv
            return best_mv, amvp, best_sad

        # ME per (list, ref_idx): multi-ref search (SURVEY.md E7) — each
        # active reference is searched, uni candidates cover every
        # (list, ref) pair, BI pairs the SAD-best ref of each list
        me = {}
        for li in ((0, 1) if is_b else (0,)):
            for ri in range(len(self.refs[li])):
                mv, amvp, sad = run_me(li, ri)
                if mv is not None:
                    me[(li, ri)] = (mv, amvp, sad)

        def best_ref(li):
            opts = [(s, ri) for (l, ri), (_, _, s) in me.items()
                    if l == li]
            return min(opts)[1] if opts else None

        def mvp_pick(mv, amvp):
            b0 = abs(mv[0] - amvp[0][0]) + abs(mv[1] - amvp[0][1])
            b1 = abs(mv[0] - amvp[1][0]) + abs(mv[1] - amvp[1][1])
            return 0 if b0 <= b1 else 1

        candidates = [("merge", i) for i in range(5)]
        for (li, ri) in me:
            candidates.append(("me", (DIR_L0 if li == 0 else DIR_L1,
                                      ri if li == 0 else None,
                                      ri if li == 1 else None)))
        b0r, b1r = best_ref(0), best_ref(1)
        if b0r is not None and b1r is not None:
            candidates.append(("me", (DIR_BI, b0r, b1r)))

        tried = set()
        best = (None, None)
        for kind, payload in candidates:
            if kind == "merge":
                m = merge_cands[payload]
                key = ("m", m)
                if key in tried:
                    continue
                tried.add(key)
                cu = CuDecision(split=False, is_inter=True, merge_flag=True,
                                merge_idx=payload, motion=m,
                                bypass=self.cfg.lossless)
            else:
                d, r0, r1 = payload
                m0 = me[(0, r0)][0] if d & DIR_L0 else (0, 0)
                m1 = me[(1, r1)][0] if d & DIR_L1 else (0, 0)
                motion = Motion(d, m0, r0 if d & DIR_L0 else -1,
                                m1, r1 if d & DIR_L1 else -1)
                cu = CuDecision(split=False, is_inter=True,
                                merge_flag=False, motion=motion,
                                bypass=self.cfg.lossless)
                if d & DIR_L0:
                    amvp0 = me[(0, r0)][1]
                    cu.mvp_flag = mvp_pick(m0, amvp0)
                    pr = amvp0[cu.mvp_flag]
                    cu.mvd = (m0[0] - pr[0], m0[1] - pr[1])
                if d & DIR_L1:
                    amvp1 = me[(1, r1)][1]
                    cu.mvp_flag_l1 = mvp_pick(m1, amvp1)
                    pr = amvp1[cu.mvp_flag_l1]
                    cu.mvd_l1 = (m1[0] - pr[0], m1[1] - pr[1])
            # motion with an unavailable list cannot be reconstructed
            md = cu.motion
            if (md.inter_dir & DIR_L0 and not self.refs[0]) or \
                    (md.inter_dir & DIR_L1 and not self.refs[1]):
                continue
            dist, tus = self._build_inter_tus(x, y, log2_size, cu)
            cu.tus = tus
            cbf_any = any(t.levels_y is not None or t.levels_cb is not None
                          or t.levels_cr is not None for t in tus)
            if cu.merge_flag and not cbf_any:
                cu.skip = True
                cu.tus = []
            est = CabacEstimator(self.est.ctx.copy())
            self._est_cu_syntax(est, x, y, log2_size, cu)
            cost = dist + self.lambda_mode * est.bits
            if best[0] is None or cost < best[0]:
                best = (cost, cu)
        # depth-1 RQT (SURVEY.md E7 "RQT residual-tree search"): try the
        # split_transform_flag=1 variant of the winning motion with the
        # oracle's exact syntax-bit estimate
        if (best[1] is not None and not best[1].skip
                and not self.cfg.lossless
                and sp.max_transform_hierarchy_depth_inter > 0
                and sp.log2_min_tu + 1 < log2_size <= sp.log2_max_tu):
            import copy as _copy
            cu2 = _copy.copy(best[1])
            cu2.tu_split = True
            dist2, tus2 = self._build_inter_tus(x, y, log2_size, cu2,
                                                split=True)
            cu2.tus = tus2
            cbf2 = any(t.levels_y is not None or t.levels_cb is not None
                       or t.levels_cr is not None for t in tus2)
            if not cbf2:
                cu2.tu_split = False  # all-zero: the flag buys nothing
            if cbf2 or not cu2.merge_flag:
                est = CabacEstimator(self.est.ctx.copy())
                self._est_cu_syntax(est, x, y, log2_size, cu2)
                cost2 = dist2 + self.lambda_mode * est.bits
                if cost2 < best[0]:
                    best = (cost2, cu2)
        return best

    def _build_inter_tus(self, x, y, log2_size, cu, split=False):
        """Residual TQ for an inter CU (MC prediction); returns
        (distortion, [TuData...]). Does NOT write recon."""
        from .mc import mc_cu_motion

        sp = self.sp
        n = 1 << log2_size
        pred_y, pred_cb, pred_cr = mc_cu_motion(
            cu.motion, self.refs[0], self.refs[1], x, y, n, sp.bit_depth,
            wp=getattr(self, "wp", None))
        qps = (self.qp_y, self.qp_cb, self.qp_cr)
        n_tus = 4 if (log2_size > sp.log2_max_tu or split) else 1
        tlg = log2_size - 1 if n_tus == 4 else log2_size
        half = n >> 1
        dist = 0
        tus = []
        for i in range(n_tus):
            oy, ox = (0, 0) if n_tus == 1 else ((i >> 1) * half,
                                                (i & 1) * half)
            tu = TuData()
            for ci, (srcp, predp) in enumerate((
                    (self.src.y[y:y + n, x:x + n], pred_y),
                    (self.src.cb[y >> 1:(y >> 1) + (n >> 1),
                                 x >> 1:(x >> 1) + (n >> 1)], pred_cb),
                    (self.src.cr[y >> 1:(y >> 1) + (n >> 1),
                                 x >> 1:(x >> 1) + (n >> 1)], pred_cr))):
                sub = 0 if ci == 0 else 1
                tn = 1 << (tlg - sub)
                o_y, o_x = oy >> sub, ox >> sub
                s2 = srcp[o_y:o_y + tn, o_x:o_x + tn]
                p2 = predp[o_y:o_y + tn, o_x:o_x + tn]
                res = s2 - p2
                if cu.bypass:
                    levels = res.astype(np.int32)
                else:
                    coeffs = transform.forward_transform(res, sp.bit_depth,
                                                         False)
                    levels = self._quantize_tb(coeffs, qps[ci], False,
                                               tlg - sub, ci, 0)
                    if sp.sign_data_hiding and levels.any():
                        levels = residual.sdh_adjust(levels, coeffs,
                                                     qps[ci], sp.bit_depth,
                                                     tlg - sub, 0)
                if not levels.any():
                    levels = None
                    rec = p2
                elif cu.bypass:
                    rec = s2
                else:
                    deq = transform.dequantize(
                        levels, qps[ci], sp.bit_depth,
                        m=self._m(tlg - sub, False, ci))
                    rec = np.clip(
                        p2 + transform.inverse_transform(deq, sp.bit_depth,
                                                         False),
                        0, (1 << sp.bit_depth) - 1)
                dist += sse(s2, rec)
                if ci == 0:
                    tu.levels_y = levels
                elif ci == 1:
                    tu.levels_cb = levels
                else:
                    tu.levels_cr = levels
            tus.append(tu)
        return dist, tus

    def _est_cu_syntax(self, est, x, y, log2_size, cu) -> None:
        """Estimate-encode CU syntax (sans split flag) into `est`, reusing
        the real serializer. _encode_cu mutates maps, so the granule region
        is saved/restored around the call."""
        sp = self.sp
        n = 1 << log2_size
        g = (slice(y >> 2, (y + n) >> 2), slice(x >> 2, (x + n) >> 2))
        saved = [a[g].copy() for a in self._granule_arrays()]
        ctu_mod._encode_cu(est, self.maps, sp, x, y, log2_size, 0, cu,
                           self.slice_type)
        for a, s in zip(self._granule_arrays(), saved):
            a[g] = s

    def _build_tus(self, x, y, log2_size, cu,
                   split: bool = False) -> tuple[int, list]:
        """Transform-quantize-reconstruct the CU for a given mode; returns
        (distortion, [TuData...]). Writes recon into self.planes.
        split: depth-1 intra RQT variant (4 sub-TBs, z-order, each
        predicted from the previous sub-TB's reconstruction)."""
        sp = self.sp
        if log2_size > sp.log2_max_tu or split:
            half = 1 << (log2_size - 1)
            dist = 0
            tus = []
            for i in range(4):
                tx, ty = x + (i & 1) * half, y + (i >> 1) * half
                d, tu = self._build_one_tu(tx, ty, log2_size - 1, cu)
                dist += d
                tus.append(tu)
            return dist, tus
        d, tu = self._build_one_tu(x, y, log2_size, cu)
        return d, [tu]

    def _build_one_tu(self, x, y, log2_size, cu) -> tuple[int, TuData]:
        sp = self.sp
        n = 1 << log2_size
        tu = TuData()
        dist = 0
        cmode = ctu_mod.chroma_mode_from_cu(cu)
        for c_idx, mode, qp in ((0, cu.luma_mode, self.qp_y),
                                (1, cmode, self.qp_cb),
                                (2, cmode, self.qp_cr)):
            if c_idx == 0:
                bx, by, bn, blog2 = x, y, n, log2_size
            else:
                bx, by, bn, blog2 = x >> 1, y >> 1, n >> 1, log2_size - 1
            src = self.src.plane(c_idx)[by:by + bn, bx:bx + bn]
            pred = ctu_mod.predict_block(self.planes, sp, bx, by, blog2,
                                         mode, c_idx)
            res = src - pred
            ts = False
            if cu.bypass:
                levels = res.astype(np.int32)
                if not levels.any():
                    levels = None
            else:
                levels, ts = self._tq_intra_tb(
                    res, qp, blog2, c_idx,
                    residual.intra_scan_idx(blog2, c_idx, mode))
            ctu_mod.reconstruct_tb(self.planes, sp, bx, by, blog2, mode,
                                   c_idx, levels, qp, cu.bypass, ts)
            rec = self.planes.plane(c_idx)[by:by + bn, bx:bx + bn]
            dist += sse(src, rec)
            if c_idx == 0:
                tu.levels_y = levels
                tu.ts_y = ts
            elif c_idx == 1:
                tu.levels_cb = levels
                tu.ts_cb = ts
            else:
                tu.levels_cr = levels
                tu.ts_cr = ts
        return dist, tu
