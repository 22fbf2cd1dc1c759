"""CTU-level syntax coding + reconstruction core (shared encoder/decoder).

Reference parity: HM TEncCu/TDecCu + TEncSbac/TDecSbac CU syntax
(SURVEY.md E6, D4, C6) — reimplemented from H.265 spec 7.3.8 (coding tree,
coding unit, transform tree/unit) for the tool subset this codec emits:
intra 2Nx2N CUs, TU == CU (forced RQT split for 64x64), DM chroma optional
explicit chroma mode, optional cu_transquant_bypass.

The *decision structure* (CuDecision tree per CTU) is the contract between
the RDO search (spec encoder now, TPU batched search in ops/) and the
entropy coder: search produces decisions; this module serializes them and
mirrors them back on decode, with bit-exact shared reconstruction.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import intra, residual, transform
from .syntax import SLICE_I, SequenceParams
from .tables import chroma_qp

CHROMA_DM = 4  # intra_chroma_pred_mode value meaning "same as luma"
# chroma mode candidate list (spec 8.4.3): index 0..3 -> mode, DM handled sep.
CHROMA_MODE_LIST = [intra.PLANAR, 26, 10, intra.DC]


@dataclass
class TuData:
    """Quantized levels for one transform unit (None = cbf 0)."""
    levels_y: np.ndarray | None = None
    levels_cb: np.ndarray | None = None
    levels_cr: np.ndarray | None = None
    # transform_skip_flag per component (4x4 TBs only, spec 7.3.8.11)
    ts_y: bool = False
    ts_cb: bool = False
    ts_cr: bool = False


@dataclass
class CuDecision:
    split: bool = False
    children: list | None = None
    luma_mode: int = 0
    chroma_mode: int = CHROMA_DM
    bypass: bool = False          # cu_transquant_bypass
    tus: list = field(default_factory=list)  # 1 TU, or 4 for 64x64 CU
    # depth-1 RQT (spec 7.3.8.8 split_transform_flag): 4 sub-TUs below
    # the CU for inter CUs of size 16/32; tus then holds 4 entries
    tu_split: bool = False
    # PART_NxN intra at min CU (spec 7.3.8.5): 4 luma PUs/TBs of 4x4,
    # chroma stays one 4x4 TB (carried in tus[3], spec blkIdx-3 rule)
    nxn: bool = False
    luma_modes: tuple = ()        # 4 per-PU modes (z-order) when nxn
    # inter fields (P/B slices; PU == CU, one active ref per list)
    is_inter: bool = False
    skip: bool = False            # cu_skip_flag (merge + no residual)
    merge_flag: bool = False
    merge_idx: int = 0
    motion: object = None         # inter.Motion (dir + per-list mv/ref)
    mvd: tuple = (0, 0)           # L0 mvd (non-merge)
    mvd_l1: tuple = (0, 0)
    mvp_flag: int = 0
    mvp_flag_l1: int = 0


class FrameMaps:
    """Per-picture 4x4-granule state used for context derivation and MPM
    (HM TComDataCU analog, SoA over the picture)."""

    def __init__(self, sp: SequenceParams) -> None:
        self.sp = sp
        gw = sp.coded_width >> 2
        gh = sp.coded_height >> 2
        self.depth = np.full((gh, gw), -1, dtype=np.int8)
        self.mode = np.full((gh, gw), -1, dtype=np.int8)  # luma intra mode
        self.coded = np.zeros((gh, gw), dtype=bool)
        self.skip = np.zeros((gh, gw), dtype=bool)  # cu_skip_flag ctx
        # depth-1 RQT: split_transform_flag of the covering CU (deblock
        # must filter the interior TU edges, spec 8.7.2)
        self.tusplit = np.zeros((gh, gw), dtype=bool)
        from .inter import MotionField
        self.motion = MotionField(sp.coded_width, sp.coded_height)
        # current tile rect (x0, y0, x1, y1) in luma samples; None = no tiles
        self.tile_rect = None
        # per-slice reference context (inter.MotionCtx): active-list POCs
        # + collocated-picture motion for TMVP; None = single-ref default
        self.mctx = None

    def _in_tile(self, x: int, y: int) -> bool:
        if self.tile_rect is None:
            return True
        x0, y0, x1, y1 = self.tile_rect
        return x0 <= x < x1 and y0 <= y < y1

    def neighbor_skip(self, x: int, y: int) -> int:
        """cu_skip_flag context increment (left + above skip flags)."""
        ctx = 0
        if x > 0 and self._in_tile(x - 1, y) \
                and self.coded[y >> 2, (x - 1) >> 2] \
                and self.skip[y >> 2, (x - 1) >> 2]:
            ctx += 1
        if y > 0 and self._in_tile(x, y - 1) \
                and self.coded[(y - 1) >> 2, x >> 2] \
                and self.skip[(y - 1) >> 2, x >> 2]:
            ctx += 1
        return ctx

    def set_skip(self, x: int, y: int, size: int, skip: bool) -> None:
        g = slice(y >> 2, (y + size) >> 2), slice(x >> 2, (x + size) >> 2)
        self.skip[g] = skip

    def set_cu(self, x: int, y: int, size: int, depth: int, mode: int) -> None:
        g = slice(y >> 2, (y + size) >> 2), slice(x >> 2, (x + size) >> 2)
        self.depth[g] = depth
        self.mode[g] = mode
        self.coded[g] = True

    def neighbor_depth(self, x: int, y: int):
        """(left_depth, above_depth), None where unavailable."""
        left = above = None
        if x > 0 and self._in_tile(x - 1, y) \
                and self.coded[y >> 2, (x - 1) >> 2]:
            left = int(self.depth[y >> 2, (x - 1) >> 2])
        if y > 0 and self._in_tile(x, y - 1) \
                and self.coded[(y - 1) >> 2, x >> 2]:
            above = int(self.depth[(y - 1) >> 2, x >> 2])
        return left, above

    def neighbor_modes(self, x: int, y: int):
        """(left_mode, above_mode, above_in_ctu) for MPM derivation."""
        left = above = None
        if x > 0 and self._in_tile(x - 1, y) \
                and self.coded[y >> 2, (x - 1) >> 2]:
            m = int(self.mode[y >> 2, (x - 1) >> 2])
            left = m if m >= 0 else None
        above_in_ctu = (y & ((1 << self.sp.log2_ctu) - 1)) != 0
        if y > 0 and self._in_tile(x, y - 1) \
                and self.coded[(y - 1) >> 2, x >> 2]:
            m = int(self.mode[(y - 1) >> 2, x >> 2])
            above = m if m >= 0 else None
        return left, above, above_in_ctu


# ---------------------------------------------------------------------------
# Reconstruction (shared, bit-exact between encoder and decoder)
# ---------------------------------------------------------------------------

class Planes:
    """Reconstruction planes in coded (padded) dimensions."""

    def __init__(self, sp: SequenceParams) -> None:
        self.y = np.zeros((sp.coded_height, sp.coded_width), dtype=np.int32)
        self.cb = np.zeros((sp.coded_height // 2, sp.coded_width // 2),
                           dtype=np.int32)
        self.cr = np.zeros_like(self.cb)

    def plane(self, c_idx: int) -> np.ndarray:
        return (self.y, self.cb, self.cr)[c_idx]


def predict_block(planes: Planes, sp: SequenceParams, x: int, y: int,
                  log2_size: int, mode: int, c_idx: int) -> np.ndarray:
    """Intra-predict one transform block (plane coords for chroma).
    Tile-constrained availability via planes.tile_rect (set per tile)."""
    n = 1 << log2_size
    sub = 0 if c_idx == 0 else 1
    plane = planes.plane(c_idx)
    x_luma, y_luma = x << sub, y << sub
    top, left = intra.get_reference_samples(
        plane, x, y, n, x_luma, y_luma, sp.log2_ctu,
        sp.coded_width, sp.coded_height, subsample=sub,
        bit_depth=sp.bit_depth, tile_rect=getattr(planes, "tile_rect", None))
    if c_idx == 0 and intra.should_filter(mode, n, True):
        top, left = intra.filter_reference_samples(top, left)
    return intra.predict(mode, top, left, n, c_idx == 0, sp.bit_depth)


def reconstruct_tb(planes: Planes, sp: SequenceParams, x: int, y: int,
                   log2_size: int, mode: int, c_idx: int,
                   levels: np.ndarray | None, qp: int,
                   bypass: bool, ts: bool = False) -> np.ndarray:
    """Predict + inverse TQ + clip; writes into the plane and returns pred."""
    n = 1 << log2_size
    pred = predict_block(planes, sp, x, y, log2_size, mode, c_idx)
    if levels is None:
        res = 0
    elif bypass:
        res = levels
    else:
        from .scaling import scaling_matrix
        deq = transform.dequantize(
            levels, qp, sp.bit_depth,
            m=scaling_matrix(sp, 1 << log2_size, False, c_idx))
        if ts:
            res = transform.inverse_transform_skip(deq, sp.bit_depth)
        else:
            use_dst = (c_idx == 0 and log2_size == 2)
            res = transform.inverse_transform(deq, sp.bit_depth, use_dst)
    rec = np.clip(pred + res, 0, (1 << sp.bit_depth) - 1)
    planes.plane(c_idx)[y:y + n, x:x + n] = rec
    return pred


def tu_qps(sp: SequenceParams, slice_qp: int) -> tuple[int, int, int]:
    """(qp_y, qp_cb, qp_cr) for the slice (no cu_qp_delta)."""
    return (slice_qp,
            chroma_qp(slice_qp, sp.cb_qp_offset),
            chroma_qp(slice_qp, sp.cr_qp_offset))


def reconstruct_cu(planes: Planes, sp: SequenceParams, x: int, y: int,
                   log2_size: int, cu: CuDecision, slice_qp: int) -> None:
    """Apply a no-split CU decision's reconstruction (luma + chroma)."""
    qp_y, qp_cb, qp_cr = tu_qps(sp, slice_qp)
    if cu.nxn:
        half = 1 << (log2_size - 1)
        for i in range(4):
            tx = x + (i & 1) * half
            ty = y + (i >> 1) * half
            reconstruct_tb(planes, sp, tx, ty, log2_size - 1,
                           cu.luma_modes[i], 0, cu.tus[i].levels_y, qp_y,
                           cu.bypass)
        cmode = chroma_mode_from_cu(cu)
        reconstruct_tb(planes, sp, x >> 1, y >> 1, log2_size - 1, cmode, 1,
                       cu.tus[3].levels_cb, qp_cb, cu.bypass)
        reconstruct_tb(planes, sp, x >> 1, y >> 1, log2_size - 1, cmode, 2,
                       cu.tus[3].levels_cr, qp_cr, cu.bypass)
        return
    if log2_size > sp.log2_max_tu:
        # forced RQT split (64x64 CU -> 4 32x32 TUs)
        half = 1 << (log2_size - 1)
        for i, tu in enumerate(cu.tus):
            tx = x + (i & 1) * half
            ty = y + (i >> 1) * half
            _reconstruct_tu(planes, sp, tx, ty, log2_size - 1, cu, tu,
                            qp_y, qp_cb, qp_cr)
    else:
        _reconstruct_tu(planes, sp, x, y, log2_size, cu, cu.tus[0],
                        qp_y, qp_cb, qp_cr)


def chroma_mode_from_cu(cu: CuDecision) -> int:
    # spec 8.4.3: DM and the substitution rule reference the FIRST luma
    # PU's mode (xCb, yCb) — PU0 for PART_NxN
    luma0 = cu.luma_modes[0] if cu.nxn else cu.luma_mode
    if cu.chroma_mode == CHROMA_DM:
        return luma0
    m = CHROMA_MODE_LIST[cu.chroma_mode]
    # spec 8.4.3: if candidate equals luma mode, substitute 34
    return 34 if m == luma0 else m


def _reconstruct_tu(planes: Planes, sp: SequenceParams, x: int, y: int,
                    log2_size: int, cu: CuDecision, tu: TuData,
                    qp_y: int, qp_cb: int, qp_cr: int) -> None:
    reconstruct_tb(planes, sp, x, y, log2_size, cu.luma_mode, 0,
                   tu.levels_y, qp_y, cu.bypass, tu.ts_y)
    cmode = chroma_mode_from_cu(cu)
    cx, cy, clog2 = x >> 1, y >> 1, log2_size - 1
    reconstruct_tb(planes, sp, cx, cy, clog2, cmode, 1, tu.levels_cb,
                   qp_cb, cu.bypass, tu.ts_cb)
    reconstruct_tb(planes, sp, cx, cy, clog2, cmode, 2, tu.levels_cr,
                   qp_cr, cu.bypass, tu.ts_cr)


# ---------------------------------------------------------------------------
# Entropy: encode a decided CTU / decode one CTU
# ---------------------------------------------------------------------------

def _split_ctx(maps: FrameMaps, x: int, y: int, depth: int) -> int:
    left, above = maps.neighbor_depth(x, y)
    ctx = 0
    if left is not None and left > depth:
        ctx += 1
    if above is not None and above > depth:
        ctx += 1
    return ctx


def encode_ctu(coder, maps: FrameMaps, sp: SequenceParams, x0: int, y0: int,
               ctu: CuDecision, slice_type: int = SLICE_I) -> None:
    _encode_cq(coder, maps, sp, x0, y0, sp.log2_ctu, 0, ctu, slice_type)


def _encode_cq(coder, maps, sp, x, y, log2_size, depth, cu: CuDecision,
               slice_type):
    size = 1 << log2_size
    inside = (x + size <= sp.coded_width) and (y + size <= sp.coded_height)
    if inside and log2_size > sp.log2_min_cu:
        coder.encode_bin("split_cu_flag", _split_ctx(maps, x, y, depth),
                         int(cu.split))
    else:
        # split inferred: forced when the block overflows the picture,
        # impossible at min CU size (coded dims are min-CU aligned)
        assert cu.split == (not inside)
    if cu.split:
        half = size >> 1
        for i, child in enumerate(cu.children):
            cx = x + (i & 1) * half
            cy = y + (i >> 1) * half
            if cx < sp.coded_width and cy < sp.coded_height:
                _encode_cq(coder, maps, sp, cx, cy, log2_size - 1,
                           depth + 1, child, slice_type)
        return
    _encode_cu(coder, maps, sp, x, y, log2_size, depth, cu, slice_type)


def _encode_merge_idx(coder, idx: int) -> None:
    """TR cMax=4: first bin context-coded, rest bypass unary."""
    coder.encode_bin("merge_idx", 0, 1 if idx > 0 else 0)
    if idx > 0:
        for k in range(1, idx):
            coder.encode_bypass(1)
        if idx < 4:
            coder.encode_bypass(0)


def _decode_merge_idx(dec) -> int:
    if not dec.decode_bin("merge_idx", 0):
        return 0
    idx = 1
    while idx < 4 and dec.decode_bypass():
        idx += 1
    return idx


def _encode_cu(coder, maps, sp, x, y, log2_size, depth, cu: CuDecision,
               slice_type=SLICE_I):
    from . import inter as inter_mod

    size = 1 << log2_size
    is_b = slice_type == 0  # SLICE_B
    if slice_type != SLICE_I:
        coder.encode_bin("cu_skip_flag", maps.neighbor_skip(x, y),
                         int(cu.skip))
        if cu.skip:
            _encode_merge_idx(coder, cu.merge_idx)
            maps.set_cu(x, y, size, depth, -1)
            maps.set_skip(x, y, size, True)
            maps.motion.set_cu(x, y, size, cu.motion, False)
            return
    if sp.transquant_bypass_enabled:
        coder.encode_bin("cu_transquant_bypass_flag", 0, int(cu.bypass))
    if slice_type != SLICE_I:
        coder.encode_bin("pred_mode_flag", 0, 0 if cu.is_inter else 1)
    if cu.is_inter:
        coder.encode_bin("part_mode", 0, 1)  # PART_2Nx2N
        coder.encode_bin("merge_flag", 0, int(cu.merge_flag))
        if cu.merge_flag:
            _encode_merge_idx(coder, cu.merge_idx)
        else:
            m = cu.motion
            if is_b:
                inter_mod.encode_inter_pred_idc(coder, m.inter_dir, depth)
            mctx = inter_mod._default_mctx(maps)
            if m.inter_dir & inter_mod.DIR_L0:
                inter_mod.encode_ref_idx(coder, m.ref0,
                                         len(mctx.l0_pocs))
                inter_mod.encode_mvd(coder, cu.mvd[0], cu.mvd[1])
                coder.encode_bin("mvp_flag", 0, cu.mvp_flag)
            if m.inter_dir & inter_mod.DIR_L1:
                inter_mod.encode_ref_idx(coder, m.ref1,
                                         len(mctx.l1_pocs))
                inter_mod.encode_mvd(coder, cu.mvd_l1[0], cu.mvd_l1[1])
                coder.encode_bin("mvp_flag", 0, cu.mvp_flag_l1)
        cbf_any = any(tu.levels_y is not None or tu.levels_cb is not None
                      or tu.levels_cr is not None for tu in cu.tus)
        if not cu.merge_flag:
            coder.encode_bin("rqt_root_cbf", 0, int(cbf_any))
        if cbf_any or cu.merge_flag:
            _encode_transform_tree(coder, sp, x, y, log2_size, cu)
        maps.set_cu(x, y, size, depth, -1)
        maps.set_skip(x, y, size, False)
        cbf_y = any(tu.levels_y is not None for tu in cu.tus)
        maps.motion.set_cu(x, y, size, cu.motion, cbf_y)
        apply_tu_cbf(maps, x, y, size, cu)
        return
    _encode_intra_cu_body(coder, maps, sp, x, y, log2_size, depth, cu,
                          slice_type)


def _pu_offsets(size: int):
    h = size >> 1
    return ((0, 0), (h, 0), (0, h), (h, h))


def _encode_mpm_idx_or_rem(coder, cands, mode) -> None:
    if mode in cands:
        idx = cands.index(mode)
        coder.encode_bypass(0 if idx == 0 else 1)
        if idx > 0:
            coder.encode_bypass(idx - 1)
    else:
        rem = mode
        for c in sorted(cands, reverse=True):
            if mode > c:
                rem -= 1
        coder.encode_bypass_bits(rem, 5)


def _encode_intra_cu_body(coder, maps, sp, x, y, log2_size, depth,
                          cu: CuDecision, slice_type=SLICE_I):
    size = 1 << log2_size
    if log2_size == sp.log2_min_cu:
        coder.encode_bin("part_mode", 0, 0 if cu.nxn else 1)
    if cu.nxn:
        # spec 7.3.8.5 PART_NxN: all four prev_intra_luma_pred_flag bins
        # first, then per-PU mpm_idx / rem_intra. MPM candidates of later
        # PUs reference earlier PUs' modes (z-order), so the granule mode
        # map is updated per PU as the list is derived.
        half = size >> 1
        cands_list = []
        for i, (dx, dy) in enumerate(_pu_offsets(size)):
            px, py = x + dx, y + dy
            lm, am, in_ctu = maps.neighbor_modes(px, py)
            cands = intra.mpm_candidates(lm, am, in_ctu)
            cands_list.append(cands)
            maps.set_cu(px, py, half, depth, cu.luma_modes[i])
        for i, cands in enumerate(cands_list):
            coder.encode_bin("prev_intra_luma_pred_flag", 0,
                             1 if cu.luma_modes[i] in cands else 0)
        for i, cands in enumerate(cands_list):
            _encode_mpm_idx_or_rem(coder, cands, cu.luma_modes[i])
    else:
        lm, am, in_ctu = maps.neighbor_modes(x, y)
        cands = intra.mpm_candidates(lm, am, in_ctu)
        mode = cu.luma_mode
        coder.encode_bin("prev_intra_luma_pred_flag", 0,
                         1 if mode in cands else 0)
        _encode_mpm_idx_or_rem(coder, cands, mode)
    # chroma mode
    if cu.chroma_mode == CHROMA_DM:
        coder.encode_bin("intra_chroma_pred_mode", 0, 0)
    else:
        coder.encode_bin("intra_chroma_pred_mode", 0, 1)
        coder.encode_bypass_bits(cu.chroma_mode, 2)
    _encode_transform_tree(coder, sp, x, y, log2_size, cu)
    if cu.nxn:
        half = size >> 1
        for i, (dx, dy) in enumerate(_pu_offsets(size)):
            maps.set_cu(x + dx, y + dy, half, depth, cu.luma_modes[i])
    else:
        maps.set_cu(x, y, size, depth, cu.luma_mode)
    maps.set_skip(x, y, size, False)
    maps.motion.set_intra_cu(x, y, size,
                             any(tu.levels_y is not None for tu in cu.tus))


def apply_tu_cbf(maps: FrameMaps, x: int, y: int, size: int,
                 cu: CuDecision) -> None:
    """Per-TU luma-cbf granules + the tusplit map after an inter CU is
    placed: deblock boundary strength at TU edges reads the cbf of the
    ADJACENT TB (spec 8.7.2.4), so a split CU must not smear one child's
    cbf across the whole CU; tusplit feeds edge derivation (8.7.1)."""
    if len(cu.tus) == 4:
        half = size >> 1
        for i, tu in enumerate(cu.tus):
            tx, ty = x + (i & 1) * half, y + (i >> 1) * half
            maps.motion.cbf_y[ty >> 2:(ty + half) >> 2,
                              tx >> 2:(tx + half) >> 2] = \
                tu.levels_y is not None
    maps.tusplit[y >> 2:(y + size) >> 2,
                 x >> 2:(x + size) >> 2] = cu.tu_split


def _encode_transform_tree(coder, sp, x, y, log2_size, cu: CuDecision):
    forced_split = log2_size > sp.log2_max_tu
    # depth-1 RQT (spec 7.3.8.8): split_transform_flag precedes the
    # depth-0 chroma cbfs; present when the size is in [MinTb+1, MaxTb]
    # and the hierarchy depth allows a split (inter CUs here — intra
    # keeps max_transform_hierarchy_depth_intra == 0)
    max_depth = (sp.max_transform_hierarchy_depth_inter if cu.is_inter
                 else sp.max_transform_hierarchy_depth_intra)
    if (max_depth > 0 and not cu.nxn
            and sp.log2_min_tu < log2_size <= sp.log2_max_tu):
        coder.encode_bin("split_transform_flag", 5 - log2_size,
                         int(cu.tu_split))
    # depth-0 chroma cbf
    cbf_cb0 = any(tu.levels_cb is not None for tu in cu.tus)
    cbf_cr0 = any(tu.levels_cr is not None for tu in cu.tus)
    coder.encode_bin("cbf_chroma", 0, int(cbf_cb0))
    coder.encode_bin("cbf_chroma", 0, int(cbf_cr0))
    if cu.nxn:
        # IntraSplitFlag: split_transform_flag inferred 1; 4 luma 4x4 TBs
        # (per-PU mode scan + DST), chroma 4x4 coded with the LAST child
        # transform_unit (spec 7.3.8.10 blkIdx == 3 rule, tus[3])
        half = 1 << (log2_size - 1)
        sdh = sp.sign_data_hiding and not cu.bypass
        ts_ok = sp.transform_skip_enabled and not cu.bypass
        for i, (dx, dy) in enumerate(_pu_offsets(1 << log2_size)):
            tu = cu.tus[i]
            cbf_y = tu.levels_y is not None
            coder.encode_bin("cbf_luma", 0, int(cbf_y))   # trafoDepth 1
            if cbf_y:
                if ts_ok:
                    coder.encode_bin("transform_skip_flag", 0,
                                     int(tu.ts_y))
                scan = residual.intra_scan_idx(log2_size - 1, 0,
                                               cu.luma_modes[i])
                residual.encode_residual(coder, tu.levels_y,
                                         log2_size - 1, 0, scan, sdh)
            if i == 3:
                cmode = chroma_mode_from_cu(cu)
                cscan = residual.intra_scan_idx(log2_size - 1, 1, cmode)
                if tu.levels_cb is not None:
                    if ts_ok:
                        coder.encode_bin("transform_skip_flag", 1,
                                         int(tu.ts_cb))
                    residual.encode_residual(coder, tu.levels_cb,
                                             log2_size - 1, 1, cscan, sdh)
                if tu.levels_cr is not None:
                    if ts_ok:
                        coder.encode_bin("transform_skip_flag", 1,
                                         int(tu.ts_cr))
                    residual.encode_residual(coder, tu.levels_cr,
                                             log2_size - 1, 2, cscan, sdh)
        return
    if forced_split or cu.tu_split:
        half = 1 << (log2_size - 1)
        for i, tu in enumerate(cu.tus):
            tx, ty = x + (i & 1) * half, y + (i >> 1) * half
            if cbf_cb0:
                coder.encode_bin("cbf_chroma", 1, int(tu.levels_cb is not None))
            if cbf_cr0:
                coder.encode_bin("cbf_chroma", 1, int(tu.levels_cr is not None))
            _encode_transform_unit(coder, sp, tx, ty, log2_size - 1, cu, tu,
                                   trafo_depth=1)
    else:
        _encode_transform_unit(coder, sp, x, y, log2_size, cu, cu.tus[0],
                               trafo_depth=0)


def _encode_transform_unit(coder, sp, x, y, log2_size, cu: CuDecision,
                           tu: TuData, trafo_depth: int):
    cbf_y = tu.levels_y is not None
    # cbf_luma presence (spec 7.3.8.8): inferred 1 for inter depth-0 TUs
    # with no chroma cbf
    present = ((not cu.is_inter) or trafo_depth != 0
               or tu.levels_cb is not None or tu.levels_cr is not None)
    if present:
        coder.encode_bin("cbf_luma", 1 if trafo_depth == 0 else 0, int(cbf_y))
    else:
        assert cbf_y, "inter TU with no coded cbf must have luma residual"
    # inter blocks scan diagonally; MDCS applies to intra only
    cmode = chroma_mode_from_cu(cu)
    luma_scan = (residual.intra_scan_idx(log2_size, 0, cu.luma_mode)
                 if not cu.is_inter else 0)
    chroma_scan = (residual.intra_scan_idx(log2_size - 1, 1, cmode)
                   if not cu.is_inter else 0)
    sdh = sp.sign_data_hiding and not cu.bypass
    ts_ok = sp.transform_skip_enabled and not cu.bypass
    if cbf_y:
        if ts_ok and log2_size == 2:
            coder.encode_bin("transform_skip_flag", 0, int(tu.ts_y))
        residual.encode_residual(coder, tu.levels_y, log2_size, 0, luma_scan,
                                 sdh)
    if tu.levels_cb is not None:
        if ts_ok and log2_size - 1 == 2:
            coder.encode_bin("transform_skip_flag", 1, int(tu.ts_cb))
        residual.encode_residual(coder, tu.levels_cb, log2_size - 1, 1,
                                 chroma_scan, sdh)
    if tu.levels_cr is not None:
        if ts_ok and log2_size - 1 == 2:
            coder.encode_bin("transform_skip_flag", 1, int(tu.ts_cr))
        residual.encode_residual(coder, tu.levels_cr, log2_size - 1, 2,
                                 chroma_scan, sdh)


# ---------------------------------------------------------------------------
# Decode side
# ---------------------------------------------------------------------------

def decode_ctu(dec, maps: FrameMaps, sp: SequenceParams, planes: Planes,
               x0: int, y0: int, slice_qp: int, slice_type: int = SLICE_I,
               refs=None) -> CuDecision:
    return _decode_cq(dec, maps, sp, planes, x0, y0, sp.log2_ctu, 0,
                      slice_qp, slice_type, refs)


def _decode_cq(dec, maps, sp, planes, x, y, log2_size, depth, slice_qp,
               slice_type=SLICE_I, refs=None):
    size = 1 << log2_size
    inside = (x + size <= sp.coded_width) and (y + size <= sp.coded_height)
    if inside and log2_size > sp.log2_min_cu:
        split = bool(dec.decode_bin("split_cu_flag",
                                    _split_ctx(maps, x, y, depth)))
    else:
        split = not inside
    cu = CuDecision(split=split)
    if split:
        cu.children = []
        half = size >> 1
        for i in range(4):
            cx = x + (i & 1) * half
            cy = y + (i >> 1) * half
            if cx < sp.coded_width and cy < sp.coded_height:
                cu.children.append(_decode_cq(dec, maps, sp, planes, cx, cy,
                                              log2_size - 1, depth + 1,
                                              slice_qp, slice_type, refs))
            else:
                cu.children.append(None)
        return cu
    _decode_cu(dec, maps, sp, planes, x, y, log2_size, depth, cu, slice_qp,
               slice_type, refs)
    return cu


def _decode_cu(dec, maps, sp, planes, x, y, log2_size, depth, cu, slice_qp,
               slice_type=SLICE_I, refs=None):
    from . import inter as inter_mod

    size = 1 << log2_size
    is_b = slice_type == 0  # SLICE_B
    if slice_type != SLICE_I:
        cu.skip = bool(dec.decode_bin("cu_skip_flag",
                                      maps.neighbor_skip(x, y)))
        if cu.skip:
            cu.is_inter = True
            cu.merge_flag = True
            cu.merge_idx = _decode_merge_idx(dec)
            cands = inter_mod.merge_candidates(maps, maps.motion, x, y,
                                               size, is_b)
            cu.motion = cands[cu.merge_idx]
            _reconstruct_inter_cu(planes, sp, x, y, log2_size, cu, refs,
                                  slice_qp,
                                  wp=maps.mctx.wp if maps.mctx else None)
            maps.set_cu(x, y, size, depth, -1)
            maps.set_skip(x, y, size, True)
            maps.motion.set_cu(x, y, size, cu.motion, False)
            return
    if sp.transquant_bypass_enabled:
        cu.bypass = bool(dec.decode_bin("cu_transquant_bypass_flag", 0))
    if slice_type != SLICE_I:
        cu.is_inter = dec.decode_bin("pred_mode_flag", 0) == 0
    if cu.is_inter:
        part = dec.decode_bin("part_mode", 0)
        assert part == 1, "only 2Nx2N PUs emitted"
        cu.merge_flag = bool(dec.decode_bin("merge_flag", 0))
        if cu.merge_flag:
            cu.merge_idx = _decode_merge_idx(dec)
            cands = inter_mod.merge_candidates(maps, maps.motion, x, y,
                                               size, is_b)
            cu.motion = cands[cu.merge_idx]
            cbf_any = True  # rqt_root_cbf inferred 1
        else:
            inter_dir = inter_mod.decode_inter_pred_idc(dec, depth) \
                if is_b else inter_mod.DIR_L0
            mctx = inter_mod._default_mctx(maps)
            mv0 = mv1 = (0, 0)
            r0 = r1 = -1
            if inter_dir & inter_mod.DIR_L0:
                r0 = inter_mod.decode_ref_idx(dec, len(mctx.l0_pocs))
                cu.mvd = inter_mod.decode_mvd(dec)
                cu.mvp_flag = dec.decode_bin("mvp_flag", 0)
                amvp = inter_mod.amvp_candidates(maps, maps.motion, x, y,
                                                 size, 0, r0)
                p = amvp[cu.mvp_flag]
                mv0 = (p[0] + cu.mvd[0], p[1] + cu.mvd[1])
            if inter_dir & inter_mod.DIR_L1:
                r1 = inter_mod.decode_ref_idx(dec, len(mctx.l1_pocs))
                cu.mvd_l1 = inter_mod.decode_mvd(dec)
                cu.mvp_flag_l1 = dec.decode_bin("mvp_flag", 0)
                amvp = inter_mod.amvp_candidates(maps, maps.motion, x, y,
                                                 size, 1, r1)
                p = amvp[cu.mvp_flag_l1]
                mv1 = (p[0] + cu.mvd_l1[0], p[1] + cu.mvd_l1[1])
            cu.motion = inter_mod.Motion(inter_dir, mv0, r0, mv1, r1)
            cbf_any = bool(dec.decode_bin("rqt_root_cbf", 0))
        if cbf_any:
            _decode_inter_residual_tree(dec, sp, x, y, log2_size, cu)
        _reconstruct_inter_cu(planes, sp, x, y, log2_size, cu, refs,
                              slice_qp,
                              wp=maps.mctx.wp if maps.mctx else None)
        maps.set_cu(x, y, size, depth, -1)
        maps.set_skip(x, y, size, False)
        cbf_y = any(tu.levels_y is not None for tu in cu.tus)
        maps.motion.set_cu(x, y, size, cu.motion, cbf_y)
        apply_tu_cbf(maps, x, y, size, cu)
        return
    if log2_size == sp.log2_min_cu:
        cu.nxn = dec.decode_bin("part_mode", 0) == 0
    if cu.nxn:
        half = size >> 1
        flags = [dec.decode_bin("prev_intra_luma_pred_flag", 0)
                 for _ in range(4)]
        modes = []
        for i, (dx, dy) in enumerate(_pu_offsets(size)):
            px, py = x + dx, y + dy
            lm, am, in_ctu = maps.neighbor_modes(px, py)
            cands = intra.mpm_candidates(lm, am, in_ctu)
            modes.append(_decode_mode_from_cands(dec, cands, flags[i]))
            maps.set_cu(px, py, half, depth, modes[i])
        cu.luma_modes = tuple(modes)
    else:
        lm, am, in_ctu = maps.neighbor_modes(x, y)
        cands = intra.mpm_candidates(lm, am, in_ctu)
        flag = dec.decode_bin("prev_intra_luma_pred_flag", 0)
        cu.luma_mode = _decode_mode_from_cands(dec, cands, flag)
    if dec.decode_bin("intra_chroma_pred_mode", 0):
        cu.chroma_mode = dec.decode_bypass_bits(2)
    else:
        cu.chroma_mode = CHROMA_DM
    _decode_transform_tree(dec, sp, planes, x, y, log2_size, cu, slice_qp)
    if cu.nxn:
        half = size >> 1
        for i, (dx, dy) in enumerate(_pu_offsets(size)):
            maps.set_cu(x + dx, y + dy, half, depth, cu.luma_modes[i])
    else:
        maps.set_cu(x, y, size, depth, cu.luma_mode)
    maps.set_skip(x, y, size, False)
    maps.tusplit[y >> 2:(y + size) >> 2,
                 x >> 2:(x + size) >> 2] = cu.tu_split
    maps.motion.set_intra_cu(x, y, size,
                             any(tu.levels_y is not None for tu in cu.tus))


def _decode_inter_residual_tree(dec, sp, x, y, log2_size, cu) -> None:
    """Parse the inter transform tree (cbfs + residuals) into cu.tus,
    mirroring _encode_transform_tree (no reconstruction here)."""
    forced_split = log2_size > sp.log2_max_tu
    if (sp.max_transform_hierarchy_depth_inter > 0
            and sp.log2_min_tu < log2_size <= sp.log2_max_tu):
        cu.tu_split = bool(dec.decode_bin("split_transform_flag",
                                          5 - log2_size))
    do_split = forced_split or cu.tu_split
    cbf_cb0 = bool(dec.decode_bin("cbf_chroma", 0))
    cbf_cr0 = bool(dec.decode_bin("cbf_chroma", 0))
    n_tus = 4 if do_split else 1
    for i in range(n_tus):
        tlg = log2_size - 1 if do_split else log2_size
        trafo_depth = 1 if do_split else 0
        cb = bool(dec.decode_bin("cbf_chroma", 1)) if (do_split
                                                       and cbf_cb0) else \
            (cbf_cb0 if not do_split else False)
        cr = bool(dec.decode_bin("cbf_chroma", 1)) if (do_split
                                                       and cbf_cr0) else \
            (cbf_cr0 if not do_split else False)
        present = trafo_depth != 0 or cb or cr
        if present:
            cbf_y = bool(dec.decode_bin("cbf_luma",
                                        1 if trafo_depth == 0 else 0))
        else:
            cbf_y = True  # inferred
        tu = TuData()
        sdh = sp.sign_data_hiding and not cu.bypass
        ts_ok = sp.transform_skip_enabled and not cu.bypass
        if cbf_y:
            if ts_ok and tlg == 2:
                tu.ts_y = bool(dec.decode_bin("transform_skip_flag", 0))
            tu.levels_y = residual.decode_residual(dec, tlg, 0, 0, sdh)
        if cb:
            if ts_ok and tlg - 1 == 2:
                tu.ts_cb = bool(dec.decode_bin("transform_skip_flag", 1))
            tu.levels_cb = residual.decode_residual(dec, tlg - 1, 1, 0, sdh)
        if cr:
            if ts_ok and tlg - 1 == 2:
                tu.ts_cr = bool(dec.decode_bin("transform_skip_flag", 1))
            tu.levels_cr = residual.decode_residual(dec, tlg - 1, 2, 0,
                                                    sdh)
        cu.tus.append(tu)


def _reconstruct_inter_cu(planes, sp, x, y, log2_size, cu, refs,
                          slice_qp, wp=None) -> None:
    """MC prediction + residual reconstruction for an inter CU.

    refs: (refs_l0, refs_l1) lists of Planes.
    wp: spec.wp.WpTables (explicit weighted prediction) or None."""
    from .mc import mc_cu_motion

    size = 1 << log2_size
    qp_y, qp_cb, qp_cr = tu_qps(sp, slice_qp)
    refs_l0, refs_l1 = refs
    pred_y, pred_cb, pred_cr = mc_cu_motion(cu.motion, refs_l0, refs_l1,
                                            x, y, size, sp.bit_depth,
                                            wp=wp)
    max_val = (1 << sp.bit_depth) - 1

    def add_residual(pred, levels, qp, bypass, ts=False, c_idx=0):
        if levels is None:
            return pred
        if bypass:
            return pred + levels
        from .scaling import scaling_matrix
        deq = transform.dequantize(
            levels, qp, sp.bit_depth,
            m=scaling_matrix(sp, levels.shape[0], True, c_idx))
        if ts:
            return pred + transform.inverse_transform_skip(deq,
                                                           sp.bit_depth)
        return pred + transform.inverse_transform(deq, sp.bit_depth, False)

    n_tus = len(cu.tus) if cu.tus else 0
    if n_tus == 0:
        cu.tus = []  # skip CU: pure prediction
        recon_y, recon_cb, recon_cr = pred_y, pred_cb, pred_cr
    elif n_tus == 1:
        tu = cu.tus[0]
        recon_y = add_residual(pred_y, tu.levels_y, qp_y, cu.bypass,
                               tu.ts_y, 0)
        recon_cb = add_residual(pred_cb, tu.levels_cb, qp_cb, cu.bypass,
                                tu.ts_cb, 1)
        recon_cr = add_residual(pred_cr, tu.levels_cr, qp_cr, cu.bypass,
                                tu.ts_cr, 2)
    else:  # forced 64->4x32 split
        recon_y = pred_y.copy()
        recon_cb = pred_cb.copy()
        recon_cr = pred_cr.copy()
        half = size >> 1
        ch = half >> 1
        for i, tu in enumerate(cu.tus):
            oy, ox = (i >> 1) * half, (i & 1) * half
            recon_y[oy:oy + half, ox:ox + half] = add_residual(
                pred_y[oy:oy + half, ox:ox + half], tu.levels_y, qp_y,
                cu.bypass, tu.ts_y, 0)
            coy, cox = (i >> 1) * ch, (i & 1) * ch
            recon_cb[coy:coy + ch, cox:cox + ch] = add_residual(
                pred_cb[coy:coy + ch, cox:cox + ch], tu.levels_cb, qp_cb,
                cu.bypass, tu.ts_cb, 1)
            recon_cr[coy:coy + ch, cox:cox + ch] = add_residual(
                pred_cr[coy:coy + ch, cox:cox + ch], tu.levels_cr, qp_cr,
                cu.bypass, tu.ts_cr, 2)
    planes.y[y:y + size, x:x + size] = np.clip(recon_y, 0, max_val)
    cs = size >> 1
    planes.cb[y >> 1:(y >> 1) + cs, x >> 1:(x >> 1) + cs] = np.clip(
        recon_cb, 0, max_val)
    planes.cr[y >> 1:(y >> 1) + cs, x >> 1:(x >> 1) + cs] = np.clip(
        recon_cr, 0, max_val)


def _decode_mode_from_cands(dec, cands, prev_flag: int) -> int:
    if prev_flag:
        idx = dec.decode_bypass()
        if idx:
            idx = 1 + dec.decode_bypass()
        return cands[idx]
    mode = dec.decode_bypass_bits(5)
    for c in sorted(cands):
        if mode >= c:
            mode += 1
    return mode


def _decode_transform_tree(dec, sp, planes, x, y, log2_size, cu, slice_qp):
    forced_split = log2_size > sp.log2_max_tu
    # depth-1 intra RQT (spec 7.3.8.8): the flag precedes the chroma cbfs
    if (sp.max_transform_hierarchy_depth_intra > 0 and not cu.nxn
            and sp.log2_min_tu < log2_size <= sp.log2_max_tu):
        cu.tu_split = bool(dec.decode_bin("split_transform_flag",
                                          5 - log2_size))
    cbf_cb0 = bool(dec.decode_bin("cbf_chroma", 0))
    cbf_cr0 = bool(dec.decode_bin("cbf_chroma", 0))
    qp_y, qp_cb, qp_cr = tu_qps(sp, slice_qp)
    if cu.nxn:
        # PART_NxN: 4 luma 4x4 TBs (parse + reconstruct per PU so each
        # PU predicts from the previous PUs' recon), chroma 4x4 with the
        # last child TU (spec blkIdx == 3)
        half = 1 << (log2_size - 1)
        sdh = sp.sign_data_hiding and not cu.bypass
        ts_ok = sp.transform_skip_enabled and not cu.bypass
        for i, (dx, dy) in enumerate(_pu_offsets(1 << log2_size)):
            tx, ty = x + dx, y + dy
            tu = TuData()
            if dec.decode_bin("cbf_luma", 0):                # trafoDepth 1
                if ts_ok:
                    tu.ts_y = bool(dec.decode_bin("transform_skip_flag",
                                                  0))
                scan = residual.intra_scan_idx(log2_size - 1, 0,
                                               cu.luma_modes[i])
                tu.levels_y = residual.decode_residual(
                    dec, log2_size - 1, 0, scan, sdh)
            if i == 3:
                cmode = chroma_mode_from_cu(cu)
                cscan = residual.intra_scan_idx(log2_size - 1, 1, cmode)
                if cbf_cb0:
                    if ts_ok:
                        tu.ts_cb = bool(dec.decode_bin(
                            "transform_skip_flag", 1))
                    tu.levels_cb = residual.decode_residual(
                        dec, log2_size - 1, 1, cscan, sdh)
                if cbf_cr0:
                    if ts_ok:
                        tu.ts_cr = bool(dec.decode_bin(
                            "transform_skip_flag", 1))
                    tu.levels_cr = residual.decode_residual(
                        dec, log2_size - 1, 2, cscan, sdh)
            cu.tus.append(tu)
            reconstruct_tb(planes, sp, tx, ty, log2_size - 1,
                           cu.luma_modes[i], 0, tu.levels_y, qp_y,
                           cu.bypass, tu.ts_y)
        cmode = chroma_mode_from_cu(cu)
        cx, cy = x >> 1, y >> 1
        reconstruct_tb(planes, sp, cx, cy, log2_size - 1, cmode, 1,
                       cu.tus[3].levels_cb, qp_cb, cu.bypass,
                       cu.tus[3].ts_cb)
        reconstruct_tb(planes, sp, cx, cy, log2_size - 1, cmode, 2,
                       cu.tus[3].levels_cr, qp_cr, cu.bypass,
                       cu.tus[3].ts_cr)
        return
    if forced_split or cu.tu_split:
        half = 1 << (log2_size - 1)
        for i in range(4):
            tx, ty = x + (i & 1) * half, y + (i >> 1) * half
            cb = bool(dec.decode_bin("cbf_chroma", 1)) if cbf_cb0 else False
            cr = bool(dec.decode_bin("cbf_chroma", 1)) if cbf_cr0 else False
            tu = _decode_transform_unit(dec, sp, x, y, tx, ty, log2_size - 1,
                                        cu, cb, cr, trafo_depth=1)
            cu.tus.append(tu)
            _reconstruct_tu(planes, sp, tx, ty, log2_size - 1, cu, tu,
                            qp_y, qp_cb, qp_cr)
    else:
        tu = _decode_transform_unit(dec, sp, x, y, x, y, log2_size, cu,
                                    cbf_cb0, cbf_cr0, trafo_depth=0)
        cu.tus.append(tu)
        _reconstruct_tu(planes, sp, x, y, log2_size, cu, tu,
                        qp_y, qp_cb, qp_cr)


def _decode_transform_unit(dec, sp, cu_x, cu_y, x, y, log2_size, cu,
                           cbf_cb: bool, cbf_cr: bool, trafo_depth: int):
    tu = TuData()
    cbf_y = bool(dec.decode_bin("cbf_luma", 1 if trafo_depth == 0 else 0))
    cmode = chroma_mode_from_cu(cu)
    sdh = sp.sign_data_hiding and not cu.bypass
    ts_ok = sp.transform_skip_enabled and not cu.bypass
    if cbf_y:
        if ts_ok and log2_size == 2:
            tu.ts_y = bool(dec.decode_bin("transform_skip_flag", 0))
        scan = residual.intra_scan_idx(log2_size, 0, cu.luma_mode)
        tu.levels_y = residual.decode_residual(dec, log2_size, 0, scan, sdh)
    if cbf_cb:
        if ts_ok and log2_size - 1 == 2:
            tu.ts_cb = bool(dec.decode_bin("transform_skip_flag", 1))
        scan = residual.intra_scan_idx(log2_size - 1, 1, cmode)
        tu.levels_cb = residual.decode_residual(dec, log2_size - 1, 1, scan,
                                                sdh)
    if cbf_cr:
        if ts_ok and log2_size - 1 == 2:
            tu.ts_cr = bool(dec.decode_bin("transform_skip_flag", 1))
        scan = residual.intra_scan_idx(log2_size - 1, 2, cmode)
        tu.levels_cr = residual.decode_residual(dec, log2_size - 1, 2, scan,
                                                sdh)
    return tu
