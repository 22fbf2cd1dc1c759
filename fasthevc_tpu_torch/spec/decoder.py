"""Spec golden decoder: full HEVC decoder for the emitted tool subset.

Reference parity: HM TAppDecTop/TDecTop/TDecSlice/TDecCu (SURVEY.md D1-D6,
call stack §3.2) — NAL dispatch, parameter-set activation, CTU parse +
reconstruct, decoded-picture-hash verification.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.video import picture_hash
from . import bitstream as bs
from . import ctu as ctu_mod
from .cabac import CabacDecoder, ContextSet
from .ctu import FrameMaps, Planes
from .syntax import (
    SLICE_I,
    SequenceParams,
    parse_pps,
    parse_sei,
    parse_slice_header,
    parse_sps,
)


@dataclass
class DecodedPicture:
    poc: int
    planes: Planes
    hash_ok: bool | None = None  # None = no hash SEI seen


class SpecDecoder:
    """Decode an Annex-B HEVC stream produced by this framework."""

    def __init__(self) -> None:
        self.sp = SequenceParams()
        self._have_sps = False
        self.pictures: list[DecodedPicture] = []
        self._dpb: dict = {}  # cvs-local POC -> Planes
        self._poc = 0
        self._cur = None  # in-flight picture state (multi-slice)
        # HRD SEI payloads in stream order (buffering_period / pic_timing)
        self.hrd_buffering_periods: list = []
        self.hrd_pic_timings: list = []

    def decode(self, stream: bytes) -> list[DecodedPicture]:
        for nal_type, temporal_id, rbsp in bs.split_annexb(stream):
            self._decode_nal(nal_type, rbsp)
        return self.pictures

    def _decode_nal(self, nal_type: int, rbsp: bytes) -> None:
        if nal_type == bs.NAL_VPS:
            return
        if nal_type == bs.NAL_SPS:
            parse_sps(rbsp, self.sp)
            self._have_sps = True
            return
        if nal_type == bs.NAL_PPS:
            parse_pps(rbsp, self.sp)
            return
        if nal_type in (bs.NAL_PREFIX_SEI, bs.NAL_SUFFIX_SEI):
            sei = parse_sei(rbsp, self.sp)
            if "buffering_period" in sei:
                self.hrd_buffering_periods.append(sei["buffering_period"])
            if "pic_timing" in sei:
                self.hrd_pic_timings.append(sei["pic_timing"])
            if "picture_hash" in sei and self.pictures:
                pic = self.pictures[-1]
                got = picture_hash((pic.planes.y, pic.planes.cb,
                                    pic.planes.cr),
                                   sei.get("picture_hash_type", 0))
                pic.hash_ok = (got == sei["picture_hash"])
            return
        if nal_type <= 31:  # VCL
            self._decode_slice(nal_type, rbsp)

    def _decode_slice(self, nal_type: int, rbsp: bytes) -> None:
        assert self._have_sps, "slice before SPS"
        sp = self.sp
        r = bs.BitReader(rbsp)
        sh = parse_slice_header(r, sp, nal_type)

        poc = 0 if sh.is_idr else sh.poc_lsb
        if sh.first_slice:
            if sh.is_idr:
                self._dpb = {}  # IDR flushes the DPB (spec C.3.2)
            refs = ([], [])
            l0_pocs = l1_pocs = ()
            planes = Planes(sp)
            maps = FrameMaps(sp)
            if sh.slice_type != SLICE_I:
                # L0 = [before..., after...], L1 = [after..., before...]
                # truncated to the signaled active counts (GPB when no
                # future refs); the DPB holds RefPic records (planes +
                # motion) so TMVP can read the collocated picture's MVs
                before = [poc - d for d in sh.ref_pocs_before]
                after = [poc + d for d in sh.ref_pocs_after]
                for p_ref in before + after:
                    assert p_ref in self._dpb, f"missing ref POC {p_ref}"
                l0 = (before + after)[:sh.num_ref_idx_l0]
                l1 = (after + before)[:sh.num_ref_idx_l1]
                refs = ([self._dpb[p] for p in l0],
                        [self._dpb[p] for p in l1])
                l0_pocs, l1_pocs = tuple(l0), tuple(l1)
            sao_grid = None
            if sh.sao_luma or sh.sao_chroma:
                n_x = -(-sp.coded_width // (1 << sp.log2_ctu))
                n_yy = -(-sp.coded_height // (1 << sp.log2_ctu))
                sao_grid = [[None] * n_x for _ in range(n_yy)]
            self._cur = {"planes": planes, "maps": maps, "refs": refs,
                         "l0_pocs": l0_pocs, "l1_pocs": l1_pocs,
                         "sh0": sh, "sao_grid": sao_grid, "ctus_done": 0,
                         "poc": poc}
        cur = self._cur
        assert cur is not None, "non-first slice without a first slice"
        planes, maps, refs = cur["planes"], cur["maps"], cur["refs"]
        if sh.slice_type != SLICE_I:
            # per-slice reference context (identical across the picture's
            # slices; rebuilt so each slice's wp tables are honored)
            from .inter import MotionCtx, col_arrays
            mctx = MotionCtx(cur_poc=poc, l0_pocs=cur["l0_pocs"],
                             l1_pocs=cur["l1_pocs"], tmvp=sh.temporal_mvp,
                             col_from_l0=sh.collocated_from_l0,
                             log2_ctu=sp.log2_ctu, wp=sh.wp)
            if sh.temporal_mvp:
                col_list = refs[0] if sh.collocated_from_l0 else refs[1]
                col = col_list[min(sh.collocated_ref_idx,
                                   len(col_list) - 1)]
                mctx.col_poc = col.poc
                (mctx.col_dir, mctx.col_mv,
                 mctx.col_refpoc) = col_arrays(col, sp.coded_width,
                                               sp.coded_height)
            maps.mctx = mctx
        init_type = 0 if sh.slice_type == SLICE_I else (
            1 if sh.slice_type == 1 else 2)
        # hand the remaining byte-aligned payload to CABAC
        assert r.bit_position % 8 == 0
        payload = rbsp[r.bit_position // 8:]
        ctu_size = 1 << sp.log2_ctu
        use_sao = sh.sao_luma or sh.sao_chroma
        sao_grid = cur["sao_grid"]
        if use_sao:
            from . import sao as sao_mod

        n_ctus_x = sp.ctus_x()
        total_ctus = n_ctus_x * sp.ctus_y()
        if sp.tiles_enabled:
            self._decode_tiled_payload(sh, payload, planes, maps, refs,
                                       sao_grid)
            cur["ctus_done"] = total_ctus
        elif sp.wpp:
            # WPP (SURVEY.md P2): one substream per CTU row; row r > 0
            # inherits the context state saved after the 2nd CTB of the
            # row above (spec 9.3.1); prediction is unconstrained
            offsets = [0]
            for size in sh.entry_points:
                offsets.append(offsets[-1] + size)
            n_rows = sp.ctus_y()
            inherit = None
            next_inherit = None
            for ri in range(n_rows):
                ctx = (inherit.copy() if inherit is not None
                       else ContextSet(init_type, sh.slice_qp))
                dec = CabacDecoder(
                    bs.BitReader(payload[offsets[ri]:] + b"\x00\x00"),
                    ctx)
                for i in range(n_ctus_x):
                    cx, cy = i * ctu_size, ri * ctu_size
                    if use_sao:
                        left = sao_grid[ri][i - 1] if i > 0 else None
                        up = sao_grid[ri - 1][i] if ri > 0 else None
                        sao_grid[ri][i] = sao_mod.decode_sao_ctu(
                            dec, i, ri, sh.sao_luma, sh.sao_chroma,
                            left, up, left_in_tile=True, up_in_tile=True)
                    ctu_mod.decode_ctu(dec, maps, sp, planes, cx, cy,
                                       sh.slice_qp, sh.slice_type, refs)
                    cur["ctus_done"] += 1
                    if i == 1:
                        next_inherit = dec.ctx.copy()
                    last_of_slice = (ri == n_rows - 1
                                     and i == n_ctus_x - 1)
                    end = dec.decode_terminate()
                    assert end == (1 if last_of_slice else 0), \
                        f"end_of_slice mismatch row {ri} ctu {i}"
                    if i == n_ctus_x - 1 and not last_of_slice:
                        assert dec.decode_terminate() == 1, \
                            "end_of_subset"
                inherit = next_inherit if n_ctus_x >= 2 else None
        else:
            # one independent slice segment: CTUs in raster order from
            # segment_address until end_of_slice_segment_flag == 1
            # (SURVEY.md P3 multi-slice); prediction is constrained to
            # the slice via the availability rect (only the top edge of
            # the rect ever matters: availability looks left/up only)
            addr = sh.segment_address
            y0 = (addr // n_ctus_x) * ctu_size
            rect = (0, y0, sp.coded_width, sp.coded_height)
            maps.tile_rect = rect if addr != 0 else None
            planes.tile_rect = rect if addr != 0 else None
            dec = CabacDecoder(bs.BitReader(payload + b"\x00\x00"),
                               ContextSet(init_type, sh.slice_qp))
            a = addr
            while a < total_ctus:
                cx = (a % n_ctus_x) * ctu_size
                cy = (a // n_ctus_x) * ctu_size
                if use_sao:
                    ry, rx = cy // ctu_size, cx // ctu_size
                    left = sao_grid[ry][rx - 1] if rx > 0 else None
                    up = sao_grid[ry - 1][rx] if ry > 0 else None
                    sao_grid[ry][rx] = sao_mod.decode_sao_ctu(
                        dec, rx, ry, sh.sao_luma, sh.sao_chroma, left, up,
                        left_in_tile=True, up_in_tile=cy != y0)
                ctu_mod.decode_ctu(dec, maps, sp, planes, cx, cy,
                                   sh.slice_qp, sh.slice_type, refs)
                cur["ctus_done"] += 1
                a += 1
                if dec.decode_terminate():
                    break
            maps.tile_rect = None
            planes.tile_rect = None
        if cur["ctus_done"] >= total_ctus:
            self._finalize_picture()

    def _decode_tiled_payload(self, sh, payload, planes, maps, refs,
                              sao_grid) -> None:
        """Tile-substream decode (single slice per picture when tiled)."""
        sp = self.sp
        ctu_size = 1 << sp.log2_ctu
        use_sao = sh.sao_luma or sh.sao_chroma
        if use_sao:
            from . import sao as sao_mod
        init_type = 0 if sh.slice_type == SLICE_I else (
            1 if sh.slice_type == 1 else 2)
        tile_ctus = sp.tile_ctus()
        tile_rects = sp.tile_rects()
        offsets = [0]
        for size in sh.entry_points:
            offsets.append(offsets[-1] + size)
        col_starts = set(b * ctu_size for b in sp.tile_col_bounds()[1:-1])
        row_starts = set(b * ctu_size for b in sp.tile_row_bounds()[1:-1])
        n_tiles = len(tile_ctus)
        for t, (rect, ctus) in enumerate(zip(tile_rects, tile_ctus)):
            maps.tile_rect = rect
            planes.tile_rect = rect
            sub = payload[offsets[t]:] + b"\x00\x00"
            dec = CabacDecoder(bs.BitReader(sub),
                               ContextSet(init_type, sh.slice_qp))
            for i, (cx, cy) in enumerate(ctus):
                if use_sao:
                    ry, rx = cy // ctu_size, cx // ctu_size
                    left = sao_grid[ry][rx - 1] if rx > 0 else None
                    up = sao_grid[ry - 1][rx] if ry > 0 else None
                    sao_grid[ry][rx] = sao_mod.decode_sao_ctu(
                        dec, rx, ry, sh.sao_luma, sh.sao_chroma, left, up,
                        left_in_tile=cx not in col_starts,
                        up_in_tile=cy not in row_starts)
                ctu_mod.decode_ctu(dec, maps, sp, planes, cx, cy,
                                   sh.slice_qp, sh.slice_type, refs)
                last_of_slice = (t == n_tiles - 1 and i == len(ctus) - 1)
                end = dec.decode_terminate()
                assert end == (1 if last_of_slice else 0), \
                    f"end_of_slice mismatch tile {t} ctu {i}"
                if i == len(ctus) - 1 and not last_of_slice:
                    assert dec.decode_terminate() == 1, "end_of_subset"
        maps.tile_rect = None
        planes.tile_rect = None

    def _finalize_picture(self) -> None:
        """All slices of the current picture decoded: run the in-loop
        filters, emit the DecodedPicture, store the DPB record."""
        cur = self._cur
        self._cur = None
        sp = self.sp
        planes, maps = cur["planes"], cur["maps"]
        sh = cur["sh0"]
        sao_grid = cur["sao_grid"]
        if not sp.deblocking_disabled:
            from .deblock import deblock_picture
            from .tables import chroma_qp
            deblock_picture(planes, sp,
                            maps.depth[::2, ::2].astype(np.int32),
                            sh.slice_qp,
                            chroma_qp(sh.slice_qp, sp.cb_qp_offset),
                            chroma_qp(sh.slice_qp, sp.cr_qp_offset),
                            maps=None if sh.slice_type == SLICE_I else
                            maps)
        if sao_grid is not None:
            from . import sao as sao_mod
            params_y = [[p[0] for p in row] for row in sao_grid]
            params_cb = [[p[1] for p in row] for row in sao_grid]
            params_cr = [[p[2] for p in row] for row in sao_grid]
            sao_mod.apply_sao(planes, sp, params_y, params_cb, params_cr)
        poc = cur["poc"]
        self.pictures.append(DecodedPicture(poc=poc, planes=planes))
        from .inter import RefPic
        self._dpb[poc] = RefPic(planes, poc, maps.motion,
                                cur["l0_pocs"], cur["l1_pocs"])
        self._poc = poc
