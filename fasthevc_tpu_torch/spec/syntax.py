"""High-level syntax: VPS/SPS/PPS, slice headers, SEI (write + parse).

Reference parity: HM TComSlice/TEncCavlc/TDecCavlc/SEI (SURVEY.md C2, D5,
E12) — reimplemented from H.265 spec 7.3.2 / 7.3.6 / Annex D.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bitstream import BitReader, BitWriter

SLICE_B, SLICE_P, SLICE_I = 0, 1, 2


@dataclass
class SequenceParams:
    """The subset of VPS/SPS/PPS state the codec needs (akin to HM's
    active-parameter-set view)."""
    width: int = 416
    height: int = 240
    bit_depth: int = 8
    log2_ctu: int = 5
    log2_min_cu: int = 3
    log2_min_tu: int = 2
    log2_max_tu: int = 5
    max_transform_hierarchy_depth_intra: int = 0
    max_transform_hierarchy_depth_inter: int = 0
    log2_max_poc_lsb: int = 8
    sao_enabled: bool = False
    strong_intra_smoothing: bool = False
    amp_enabled: bool = False
    pcm_enabled: bool = False
    temporal_mvp_enabled: bool = False  # sps_temporal_mvp_enabled_flag
    # quantization scaling lists (SURVEY.md C2/C5): default lists when
    # enabled with scaling_data None; custom {(sizeId, matrixId): m}
    scaling_lists: bool = False
    scaling_data: object = None
    # HRD / VUI timing (SURVEY.md E12: buffering-period + pic-timing SEI)
    hrd_enabled: bool = False
    frame_rate: float = 30.0
    hrd_bitrate: int = 1_000_000    # bits/s (CPB arrival rate)
    hrd_cpb_size: int = 2_000_000   # bits

    # PPS-level
    # explicit weighted prediction (SURVEY.md E13): P and B flags travel
    # together off one config switch (HM WeightedPredP/WeightedPredB)
    weighted_pred: bool = False      # weighted_pred_flag (P slices)
    weighted_bipred: bool = False    # weighted_bipred_flag (B slices)
    init_qp: int = 26
    transquant_bypass_enabled: bool = False
    sign_data_hiding: bool = False
    cu_qp_delta_enabled: bool = False
    transform_skip_enabled: bool = False
    deblocking_disabled: bool = True
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    # tiles (uniform spacing); 1x1 = no tiles
    tile_cols: int = 1
    tile_rows: int = 1
    # wavefront parallel processing (SURVEY.md P2): per-CTU-row CABAC
    # substreams with context inheritance from the row above's 2nd CTB
    wpp: bool = False

    @property
    def tiles_enabled(self) -> bool:
        return self.tile_cols > 1 or self.tile_rows > 1

    def ctus_x(self) -> int:
        return -(-self.coded_width // (1 << self.log2_ctu))

    def ctus_y(self) -> int:
        return -(-self.coded_height // (1 << self.log2_ctu))

    def tile_col_bounds(self) -> list:
        """CTU-column boundaries [b0..bN] (uniform spacing, spec 6.5.1)."""
        n = self.ctus_x()
        return [(i * n) // self.tile_cols for i in range(self.tile_cols + 1)]

    def tile_row_bounds(self) -> list:
        n = self.ctus_y()
        return [(i * n) // self.tile_rows for i in range(self.tile_rows + 1)]

    def tile_rects(self) -> list:
        """Per tile (raster order): luma-sample rect (x0, y0, x1, y1)."""
        cs = 1 << self.log2_ctu
        cb = self.tile_col_bounds()
        rb = self.tile_row_bounds()
        rects = []
        for tr in range(self.tile_rows):
            for tc in range(self.tile_cols):
                rects.append((cb[tc] * cs, rb[tr] * cs,
                              min(cb[tc + 1] * cs, self.coded_width),
                              min(rb[tr + 1] * cs, self.coded_height)))
        return rects

    def tile_ctus(self) -> list:
        """Per tile (raster order): list of (x, y) CTU origins in coding
        order (raster within the tile)."""
        cs = 1 << self.log2_ctu
        cb = self.tile_col_bounds()
        rb = self.tile_row_bounds()
        out = []
        for tr in range(self.tile_rows):
            for tc in range(self.tile_cols):
                ctus = []
                for cy in range(rb[tr], rb[tr + 1]):
                    for cx in range(cb[tc], cb[tc + 1]):
                        ctus.append((cx * cs, cy * cs))
                out.append(ctus)
        return out

    # Conformance window (right/bottom padding in luma samples)
    @property
    def pad_right(self) -> int:
        align = 1 << self.log2_min_cu
        return (-self.width) % align

    @property
    def pad_bottom(self) -> int:
        align = 1 << self.log2_min_cu
        return (-self.height) % align

    @property
    def coded_width(self) -> int:
        return self.width + self.pad_right

    @property
    def coded_height(self) -> int:
        return self.height + self.pad_bottom


def _write_ptl(w: BitWriter) -> None:
    """profile_tier_level for Main profile, one layer (spec 7.3.3)."""
    w.write_bits(0, 2)   # general_profile_space
    w.write_flag(0)      # general_tier_flag
    w.write_bits(1, 5)   # general_profile_idc = Main
    for i in range(32):  # compatibility flags: Main (1) and Main10 (2)
        w.write_flag(1 if i in (1, 2) else 0)
    w.write_flag(1)      # general_progressive_source_flag
    w.write_flag(0)      # general_interlaced_source_flag
    w.write_flag(0)      # general_non_packed_constraint_flag
    w.write_flag(0)      # general_frame_only_constraint_flag
    w.write_bits(0, 32)  # general_reserved_zero_44bits
    w.write_bits(0, 12)
    w.write_bits(123, 8)  # general_level_idc (level 4.1)


def _parse_ptl(r: BitReader) -> None:
    r.read_bits(2 + 1 + 5)
    r.read_bits(32)
    r.read_bits(4)
    r.read_bits(32)
    r.read_bits(12)
    r.read_bits(8)


# ---------------------------------------------------------------------------
# VPS
# ---------------------------------------------------------------------------

def write_vps(sp: SequenceParams) -> bytes:
    w = BitWriter()
    w.write_bits(0, 4)    # vps_video_parameter_set_id
    w.write_bits(3, 2)    # vps_base_layer_internal/available flags
    w.write_bits(0, 6)    # vps_max_layers_minus1
    w.write_bits(0, 3)    # vps_max_sub_layers_minus1
    w.write_flag(1)       # vps_temporal_id_nesting_flag
    w.write_bits(0xFFFF, 16)  # vps_reserved_0xffff_16bits
    _write_ptl(w)
    w.write_flag(1)       # vps_sub_layer_ordering_info_present_flag
    w.write_ue(5)         # vps_max_dec_pic_buffering_minus1
    w.write_ue(0)         # vps_max_num_reorder_pics
    w.write_ue(0)         # vps_max_latency_increase_plus1
    w.write_bits(0, 6)    # vps_max_layer_id
    w.write_ue(0)         # vps_num_layer_sets_minus1
    w.write_flag(0)       # vps_timing_info_present_flag
    w.write_flag(0)       # vps_extension_flag
    w.byte_align()
    return w.get_bytes()


# ---------------------------------------------------------------------------
# SPS
# ---------------------------------------------------------------------------

def write_sps(sp: SequenceParams) -> bytes:
    w = BitWriter()
    w.write_bits(0, 4)    # sps_video_parameter_set_id
    w.write_bits(0, 3)    # sps_max_sub_layers_minus1
    w.write_flag(1)       # sps_temporal_id_nesting_flag
    _write_ptl(w)
    w.write_ue(0)         # sps_seq_parameter_set_id
    w.write_ue(1)         # chroma_format_idc = 4:2:0
    w.write_ue(sp.coded_width)
    w.write_ue(sp.coded_height)
    if sp.pad_right or sp.pad_bottom:
        w.write_flag(1)   # conformance_window_flag
        w.write_ue(0)                      # left offset
        w.write_ue(sp.pad_right // 2)      # right (chroma units)
        w.write_ue(0)                      # top
        w.write_ue(sp.pad_bottom // 2)     # bottom
    else:
        w.write_flag(0)
    w.write_ue(sp.bit_depth - 8)  # bit_depth_luma_minus8
    w.write_ue(sp.bit_depth - 8)  # bit_depth_chroma_minus8
    w.write_ue(sp.log2_max_poc_lsb - 4)
    w.write_flag(1)       # sps_sub_layer_ordering_info_present_flag
    w.write_ue(5)         # sps_max_dec_pic_buffering_minus1
    w.write_ue(0)         # sps_max_num_reorder_pics
    w.write_ue(0)         # sps_max_latency_increase_plus1
    w.write_ue(sp.log2_min_cu - 3)
    w.write_ue(sp.log2_ctu - sp.log2_min_cu)
    w.write_ue(sp.log2_min_tu - 2)
    w.write_ue(sp.log2_max_tu - sp.log2_min_tu)
    w.write_ue(sp.max_transform_hierarchy_depth_inter)
    w.write_ue(sp.max_transform_hierarchy_depth_intra)
    w.write_flag(1 if sp.scaling_lists else 0)  # scaling_list_enabled
    if sp.scaling_lists:
        if sp.scaling_data is None:
            w.write_flag(0)  # sps_scaling_list_data_present: defaults
        else:
            from .scaling import write_scaling_list_data
            w.write_flag(1)
            write_scaling_list_data(w, sp.scaling_data)
    w.write_flag(1 if sp.amp_enabled else 0)
    w.write_flag(1 if sp.sao_enabled else 0)
    w.write_flag(0)       # pcm_enabled_flag
    w.write_ue(0)         # num_short_term_ref_pic_sets
    w.write_flag(0)       # long_term_ref_pics_present_flag
    w.write_flag(1 if sp.temporal_mvp_enabled else 0)
    w.write_flag(1 if sp.strong_intra_smoothing else 0)
    w.write_flag(1 if sp.hrd_enabled else 0)  # vui_parameters_present
    if sp.hrd_enabled:
        _write_vui_hrd(w, sp)
    w.write_flag(0)       # sps_extension_present_flag
    w.byte_align()
    return w.get_bytes()


# initial/au-removal/output delay field widths (minus1 coded in HRD)
HRD_INIT_LEN = 24
HRD_AU_LEN = 16
HRD_DPB_LEN = 16


def _write_vui_hrd(w: BitWriter, sp: SequenceParams) -> None:
    """Minimal VUI: timing_info + one-CPB NAL hrd_parameters
    (spec E.2.1/E.2.2) — what buffering-period and pic-timing SEI need
    to be interpretable."""
    w.write_flag(0)   # aspect_ratio_info_present_flag
    w.write_flag(0)   # overscan_info_present_flag
    w.write_flag(0)   # video_signal_type_present_flag
    w.write_flag(0)   # chroma_loc_info_present_flag
    w.write_flag(0)   # neutral_chroma_indication_flag
    w.write_flag(0)   # field_seq_flag
    w.write_flag(0)   # frame_field_info_present_flag
    w.write_flag(0)   # default_display_window_flag
    w.write_flag(1)   # vui_timing_info_present_flag
    num_units, scale = 1000, int(round(sp.frame_rate * 1000))
    w.write_bits(num_units, 32)   # vui_num_units_in_tick
    w.write_bits(scale, 32)       # vui_time_scale
    w.write_flag(0)   # vui_poc_proportional_to_timing_flag
    w.write_flag(1)   # vui_hrd_parameters_present_flag
    # hrd_parameters(commonInfPresent=1, maxNumSubLayersMinus1=0)
    w.write_flag(1)   # nal_hrd_parameters_present_flag
    w.write_flag(0)   # vcl_hrd_parameters_present_flag
    w.write_flag(0)   # sub_pic_hrd_params_present_flag
    w.write_bits(6, 4)    # bit_rate_scale (BitRate = value << (6+scale))
    w.write_bits(4, 4)    # cpb_size_scale (CpbSize = value << (4+scale))
    w.write_bits(HRD_INIT_LEN - 1, 5)  # initial_cpb_removal_delay_len-1
    w.write_bits(HRD_AU_LEN - 1, 5)    # au_cpb_removal_delay_len-1
    w.write_bits(HRD_DPB_LEN - 1, 5)   # dpb_output_delay_len-1
    # sub-layer 0
    w.write_flag(1)   # fixed_pic_rate_general_flag
    w.write_ue(0)     # elemental_duration_in_tc_minus1
    w.write_ue(0)     # cpb_cnt_minus1 -> 1 CPB
    # sub_layer_hrd_parameters: one CPB
    w.write_ue(max(0, (sp.hrd_bitrate >> 12) - 1))   # bit_rate_value-1
    w.write_ue(max(0, (sp.hrd_cpb_size >> 8) - 1))   # cpb_size_value-1
    w.write_flag(0)   # cbr_flag
    w.write_flag(0)   # bitstream_restriction_flag


def parse_sps(rbsp: bytes, sp: SequenceParams) -> SequenceParams:
    r = BitReader(rbsp)
    r.read_bits(4)
    r.read_bits(3)
    r.read_flag()
    _parse_ptl(r)
    r.read_ue()           # sps id
    chroma = r.read_ue()
    assert chroma == 1, "only 4:2:0 supported"
    cw = r.read_ue()
    ch = r.read_ue()
    pad_r = pad_b = 0
    if r.read_flag():
        r.read_ue()
        pad_r = r.read_ue() * 2
        r.read_ue()
        pad_b = r.read_ue() * 2
    sp.width = cw - pad_r
    sp.height = ch - pad_b
    sp.bit_depth = r.read_ue() + 8
    r.read_ue()           # chroma bit depth
    sp.log2_max_poc_lsb = r.read_ue() + 4
    if r.read_flag():
        r.read_ue(); r.read_ue(); r.read_ue()
    sp.log2_min_cu = r.read_ue() + 3
    sp.log2_ctu = sp.log2_min_cu + r.read_ue()
    sp.log2_min_tu = r.read_ue() + 2
    sp.log2_max_tu = sp.log2_min_tu + r.read_ue()
    sp.max_transform_hierarchy_depth_inter = r.read_ue()
    sp.max_transform_hierarchy_depth_intra = r.read_ue()
    sp.scaling_lists = bool(r.read_flag())
    if sp.scaling_lists:
        sp._scaling_cache = None  # invalidate the derived matrices
        if r.read_flag():  # sps_scaling_list_data_present_flag
            from .scaling import parse_scaling_list_data
            sp.scaling_data = parse_scaling_list_data(r)
        else:
            sp.scaling_data = None  # default lists (Table 7-5/7-6)
    sp.amp_enabled = bool(r.read_flag())
    sp.sao_enabled = bool(r.read_flag())
    assert r.read_flag() == 0  # pcm unsupported
    n_rps = r.read_ue()
    assert n_rps == 0, "SPS-level RPS not used by this encoder"
    assert r.read_flag() == 0  # long-term refs
    sp.temporal_mvp_enabled = bool(r.read_flag())
    sp.strong_intra_smoothing = bool(r.read_flag())
    if r.read_flag():     # vui_parameters_present
        _parse_vui_hrd(r, sp)
    r.read_flag()         # extension
    return sp


def _parse_vui_hrd(r: BitReader, sp: SequenceParams) -> None:
    """Parse the minimal VUI this encoder writes (_write_vui_hrd)."""
    for _ in range(8):
        assert r.read_flag() == 0  # the 8 leading absent-info flags
    assert r.read_flag() == 1     # vui_timing_info_present
    num_units = r.read_bits(32)
    scale = r.read_bits(32)
    sp.frame_rate = scale / num_units
    assert r.read_flag() == 0     # poc_proportional
    assert r.read_flag() == 1     # hrd present
    assert r.read_flag() == 1     # nal hrd
    assert r.read_flag() == 0     # vcl hrd
    assert r.read_flag() == 0     # sub_pic
    r.read_bits(4)                # bit_rate_scale
    r.read_bits(4)                # cpb_size_scale
    r.read_bits(5); r.read_bits(5); r.read_bits(5)
    assert r.read_flag() == 1     # fixed_pic_rate_general
    r.read_ue()                   # elemental duration
    assert r.read_ue() == 0       # cpb_cnt_minus1
    sp.hrd_bitrate = (r.read_ue() + 1) << 12
    sp.hrd_cpb_size = (r.read_ue() + 1) << 8
    r.read_flag()                 # cbr
    assert r.read_flag() == 0     # bitstream_restriction
    sp.hrd_enabled = True


# ---------------------------------------------------------------------------
# PPS
# ---------------------------------------------------------------------------

def write_pps(sp: SequenceParams) -> bytes:
    w = BitWriter()
    w.write_ue(0)         # pps id
    w.write_ue(0)         # sps id
    w.write_flag(0)       # dependent_slice_segments_enabled_flag
    w.write_flag(0)       # output_flag_present_flag
    w.write_bits(0, 3)    # num_extra_slice_header_bits
    w.write_flag(1 if sp.sign_data_hiding else 0)
    w.write_flag(0)       # cabac_init_present_flag
    w.write_ue(0)         # num_ref_idx_l0_default_active_minus1
    w.write_ue(0)         # num_ref_idx_l1_default_active_minus1
    w.write_se(sp.init_qp - 26)
    w.write_flag(0)       # constrained_intra_pred_flag
    w.write_flag(1 if sp.transform_skip_enabled else 0)
    w.write_flag(1 if sp.cu_qp_delta_enabled else 0)
    if sp.cu_qp_delta_enabled:
        w.write_ue(0)     # diff_cu_qp_delta_depth
    w.write_se(sp.cb_qp_offset)
    w.write_se(sp.cr_qp_offset)
    w.write_flag(0)       # pps_slice_chroma_qp_offsets_present_flag
    w.write_flag(1 if sp.weighted_pred else 0)    # weighted_pred_flag
    w.write_flag(1 if sp.weighted_bipred else 0)  # weighted_bipred_flag
    w.write_flag(1 if sp.transquant_bypass_enabled else 0)
    w.write_flag(1 if sp.tiles_enabled else 0)  # tiles_enabled_flag
    w.write_flag(1 if sp.wpp else 0)  # entropy_coding_sync_enabled_flag
    if sp.tiles_enabled:
        w.write_ue(sp.tile_cols - 1)
        w.write_ue(sp.tile_rows - 1)
        w.write_flag(1)   # uniform_spacing_flag
        w.write_flag(1)   # loop_filter_across_tiles_enabled_flag
    w.write_flag(1)       # pps_loop_filter_across_slices_enabled_flag
    w.write_flag(1)       # deblocking_filter_control_present_flag
    w.write_flag(0)       # deblocking_filter_override_enabled_flag
    w.write_flag(1 if sp.deblocking_disabled else 0)
    if not sp.deblocking_disabled:
        w.write_se(0)     # pps_beta_offset_div2
        w.write_se(0)     # pps_tc_offset_div2
    w.write_flag(0)       # pps_scaling_list_data_present_flag
    w.write_flag(0)       # lists_modification_present_flag
    w.write_ue(0)         # log2_parallel_merge_level_minus2
    w.write_flag(0)       # slice_segment_header_extension_present_flag
    w.write_flag(0)       # pps_extension_present_flag
    w.byte_align()
    return w.get_bytes()


def parse_pps(rbsp: bytes, sp: SequenceParams) -> SequenceParams:
    r = BitReader(rbsp)
    r.read_ue(); r.read_ue()
    assert r.read_flag() == 0
    assert r.read_flag() == 0
    r.read_bits(3)
    sp.sign_data_hiding = bool(r.read_flag())
    assert r.read_flag() == 0  # cabac_init_present
    r.read_ue(); r.read_ue()
    sp.init_qp = 26 + r.read_se()
    assert r.read_flag() == 0  # constrained intra
    sp.transform_skip_enabled = bool(r.read_flag())
    sp.cu_qp_delta_enabled = bool(r.read_flag())
    if sp.cu_qp_delta_enabled:
        r.read_ue()
    sp.cb_qp_offset = r.read_se()
    sp.cr_qp_offset = r.read_se()
    assert r.read_flag() == 0
    sp.weighted_pred = bool(r.read_flag())
    sp.weighted_bipred = bool(r.read_flag())
    sp.transquant_bypass_enabled = bool(r.read_flag())
    tiles = bool(r.read_flag())
    sp.wpp = bool(r.read_flag())
    if tiles:
        sp.tile_cols = r.read_ue() + 1
        sp.tile_rows = r.read_ue() + 1
        assert r.read_flag() == 1, "only uniform tile spacing supported"
        r.read_flag()  # loop_filter_across_tiles
    else:
        sp.tile_cols = sp.tile_rows = 1
    r.read_flag()
    if r.read_flag():          # deblocking control present
        assert r.read_flag() == 0
        sp.deblocking_disabled = bool(r.read_flag())
        if not sp.deblocking_disabled:
            r.read_se(); r.read_se()
    return sp


# ---------------------------------------------------------------------------
# Slice header
# ---------------------------------------------------------------------------

@dataclass
class SliceHeader:
    slice_type: int = SLICE_I
    slice_qp: int = 32
    poc_lsb: int = 0
    is_idr: bool = True
    first_slice: bool = True
    # multi-slice (SURVEY.md P3): CTU raster address of this independent
    # slice segment (0 for the first slice of a picture)
    segment_address: int = 0
    # explicit short-term RPS (negative deltas = past refs, used by P slices)
    ref_pocs_before: tuple = ()   # POC deltas (positive values, past)
    ref_pocs_after: tuple = ()
    num_ref_idx_l0: int = 1
    num_ref_idx_l1: int = 1
    temporal_mvp: bool = False    # slice_temporal_mvp_enabled_flag
    collocated_from_l0: bool = True
    collocated_ref_idx: int = 0
    sao_luma: bool = False
    sao_chroma: bool = False
    entry_points: tuple = ()  # per-substream byte sizes (all but last tile)
    # explicit weighted prediction (spec 7.3.6.3): wp.WpTables; required
    # (defaults written) when the PPS flag covers this slice type
    wp: object = None


def write_slice_header(sh: SliceHeader, sp: SequenceParams,
                       nal_type: int) -> BitWriter:
    """Write the slice segment header; returns the writer (caller appends
    CABAC payload after byte alignment)."""
    w = BitWriter()
    w.write_flag(1 if sh.first_slice else 0)
    if 16 <= nal_type <= 23:  # IRAP
        w.write_flag(0)       # no_output_of_prior_pics_flag
    w.write_ue(0)             # slice_pic_parameter_set_id
    if not sh.first_slice:
        # slice_segment_address: u(ceil(log2(PicSizeInCtbsY)))
        pic_ctbs = sp.ctus_x() * sp.ctus_y()
        w.write_bits(sh.segment_address,
                     max(1, (pic_ctbs - 1).bit_length()))
    w.write_ue(sh.slice_type)
    if not sh.is_idr:
        w.write_bits(sh.poc_lsb, sp.log2_max_poc_lsb)
        w.write_flag(0)       # short_term_ref_pic_set_sps_flag
        # st_ref_pic_set(0): explicit
        n_neg = len(sh.ref_pocs_before)
        n_pos = len(sh.ref_pocs_after)
        w.write_ue(n_neg)
        w.write_ue(n_pos)
        prev = 0
        for d in sh.ref_pocs_before:   # increasing distance into the past
            w.write_ue(d - prev - 1)   # delta_poc_s0_minus1
            prev = d
            w.write_flag(1)            # used_by_curr_pic_s0_flag
        prev = 0
        for d in sh.ref_pocs_after:
            w.write_ue(d - prev - 1)
            prev = d
            w.write_flag(1)
        if sp.temporal_mvp_enabled:
            w.write_flag(1 if sh.temporal_mvp else 0)
    if sp.sao_enabled:
        w.write_flag(1 if sh.sao_luma else 0)
        w.write_flag(1 if sh.sao_chroma else 0)
    if sh.slice_type != SLICE_I:
        is_b = sh.slice_type == SLICE_B
        override = (sh.num_ref_idx_l0 != 1
                    or (is_b and sh.num_ref_idx_l1 != 1))
        w.write_flag(1 if override else 0)  # num_ref_idx_active_override
        if override:
            w.write_ue(sh.num_ref_idx_l0 - 1)
            if is_b:
                w.write_ue(sh.num_ref_idx_l1 - 1)
        if is_b:
            w.write_flag(0)   # mvd_l1_zero_flag
        if sh.temporal_mvp:
            if is_b:
                w.write_flag(1 if sh.collocated_from_l0 else 0)
            n_col = (sh.num_ref_idx_l0 if sh.collocated_from_l0
                     else sh.num_ref_idx_l1)
            if n_col > 1:
                w.write_ue(sh.collocated_ref_idx)
        if (sp.weighted_pred and not is_b) or (sp.weighted_bipred and is_b):
            from .wp import default_tables, write_pred_weight_table
            wp = sh.wp
            if wp is None:
                wp = default_tables(sh.num_ref_idx_l0,
                                    sh.num_ref_idx_l1 if is_b else 0)
            write_pred_weight_table(w, wp, is_b)
        # five_minus_max_num_merge_cand
        w.write_ue(5 - 5)
    w.write_se(sh.slice_qp - sp.init_qp)
    # deblocking override absent; loop filter across slices not present
    if sp.tiles_enabled or sp.wpp:
        w.write_ue(len(sh.entry_points))
        if sh.entry_points:
            max_off = max(sh.entry_points)
            nbits = max(1, (max_off - 1).bit_length() if max_off > 1 else 1)
            w.write_ue(nbits - 1)  # offset_len_minus1
            for size in sh.entry_points:
                w.write_bits(size - 1, nbits)
    w.byte_align()            # byte_alignment() before slice data
    return w


def parse_slice_header(r: BitReader, sp: SequenceParams,
                       nal_type: int) -> SliceHeader:
    sh = SliceHeader()
    sh.is_idr = nal_type in (19, 20)
    sh.first_slice = bool(r.read_flag())
    if 16 <= nal_type <= 23:
        r.read_flag()
    r.read_ue()
    if not sh.first_slice:
        pic_ctbs = sp.ctus_x() * sp.ctus_y()
        sh.segment_address = r.read_bits(
            max(1, (pic_ctbs - 1).bit_length()))
    sh.slice_type = r.read_ue()
    if not sh.is_idr:
        sh.poc_lsb = r.read_bits(sp.log2_max_poc_lsb)
        assert r.read_flag() == 0
        n_neg = r.read_ue()
        n_pos = r.read_ue()
        before, after = [], []
        prev = 0
        for _ in range(n_neg):
            prev = prev + r.read_ue() + 1
            before.append(prev)
            r.read_flag()
        prev = 0
        for _ in range(n_pos):
            prev = prev + r.read_ue() + 1
            after.append(prev)
            r.read_flag()
        sh.ref_pocs_before = tuple(before)
        sh.ref_pocs_after = tuple(after)
        if sp.temporal_mvp_enabled:
            sh.temporal_mvp = bool(r.read_flag())
    if sp.sao_enabled:
        sh.sao_luma = bool(r.read_flag())
        sh.sao_chroma = bool(r.read_flag())
    if sh.slice_type != SLICE_I:
        is_b = sh.slice_type == SLICE_B
        if r.read_flag():     # num_ref_idx_active_override_flag
            sh.num_ref_idx_l0 = r.read_ue() + 1
            if is_b:
                sh.num_ref_idx_l1 = r.read_ue() + 1
        if is_b:
            r.read_flag()     # mvd_l1_zero_flag
        if sh.temporal_mvp:
            if is_b:
                sh.collocated_from_l0 = bool(r.read_flag())
            n_col = (sh.num_ref_idx_l0 if sh.collocated_from_l0
                     else sh.num_ref_idx_l1)
            if n_col > 1:
                sh.collocated_ref_idx = r.read_ue()
        if (sp.weighted_pred and not is_b) or (sp.weighted_bipred and is_b):
            from .wp import parse_pred_weight_table
            sh.wp = parse_pred_weight_table(
                r, sh.num_ref_idx_l0,
                sh.num_ref_idx_l1 if is_b else 0, is_b)
        r.read_ue()           # five_minus_max_num_merge_cand
    sh.slice_qp = sp.init_qp + r.read_se()
    if sp.tiles_enabled or sp.wpp:
        n = r.read_ue()
        if n:
            nbits = r.read_ue() + 1
            sh.entry_points = tuple(r.read_bits(nbits) + 1
                                    for _ in range(n))
    r.read_byte_alignment()  # byte_alignment() before slice data
    return sh


# ---------------------------------------------------------------------------
# SEI: decoded picture hash (Annex D.3.19)
# ---------------------------------------------------------------------------

_HASH_LEN = {0: 16, 1: 2, 2: 4}  # MD5 / CRC / checksum bytes per plane


def write_picture_hash_sei(hashes: list[bytes], hash_type: int = 0) -> bytes:
    """decoded_picture_hash SEI (suffix payload): MD5 (0), CRC (1) or
    checksum (2) per plane — the full Annex D.3.19 type set."""
    n = _HASH_LEN[hash_type]
    w = BitWriter()
    w.write_bits(132, 8)              # payloadType = decoded_picture_hash
    w.write_bits(1 + n * len(hashes), 8)  # payloadSize
    w.write_bits(hash_type, 8)
    for h in hashes:
        assert len(h) == n
        w.append_bytes(h)
    w.byte_align()
    return w.get_bytes()


def write_buffering_period_sei(sp: SequenceParams) -> bytes:
    """buffering_period SEI (spec D.2.2 / D.3.2): initial CPB removal
    delay for the single NAL CPB this encoder signals. Emitted as a
    PREFIX SEI on every IRAP access unit."""
    assert sp.hrd_enabled
    body = BitWriter()
    body.write_ue(0)        # bp_seq_parameter_set_id
    body.write_flag(0)      # irap_cpb_params_present_flag
    body.write_flag(0)      # concatenation_flag
    body.write_bits(0, HRD_AU_LEN)  # au_cpb_removal_delay_delta_minus1
    # 90 kHz initial removal delay: a full CPB's worth of arrival time
    delay90k = min((1 << HRD_INIT_LEN) - 1,
                   int(90000 * sp.hrd_cpb_size / max(1, sp.hrd_bitrate)))
    body.write_bits(delay90k, HRD_INIT_LEN)  # initial_cpb_removal_delay
    body.write_bits(0, HRD_INIT_LEN)         # initial_cpb_removal_offset
    body.byte_align()
    payload = body.get_bytes()
    w = BitWriter()
    w.write_bits(0, 8)                  # payloadType = buffering_period
    w.write_bits(len(payload), 8)
    w.append_bytes(payload)
    w.byte_align()
    return w.get_bytes()


def write_pic_timing_sei(sp: SequenceParams, au_cpb_removal_delay: int,
                         dpb_output_delay: int) -> bytes:
    """pic_timing SEI (spec D.2.3 / D.3.3): per-AU CPB removal +
    DPB output delays (frame_field_info absent, no DU info)."""
    assert sp.hrd_enabled
    body = BitWriter()
    body.write_bits(min((1 << HRD_AU_LEN) - 1,
                        max(0, au_cpb_removal_delay - 1)), HRD_AU_LEN)
    body.write_bits(min((1 << HRD_DPB_LEN) - 1, dpb_output_delay),
                    HRD_DPB_LEN)
    body.byte_align()
    payload = body.get_bytes()
    w = BitWriter()
    w.write_bits(1, 8)                  # payloadType = pic_timing
    w.write_bits(len(payload), 8)
    w.append_bytes(payload)
    w.byte_align()
    return w.get_bytes()


def parse_sei(rbsp: bytes, sp: SequenceParams | None = None) -> dict:
    """Parse SEI messages; returns {'picture_hash': [md5, ...]} if present."""
    out: dict = {}
    r = BitReader(rbsp)
    total_bits = len(rbsp) * 8
    while r.bit_position + 16 <= total_bits:
        ptype = 0
        b = r.read_bits(8)
        while b == 0xFF:
            ptype += 255
            b = r.read_bits(8)
        ptype += b
        psize = 0
        b = r.read_bits(8)
        while b == 0xFF:
            psize += 255
            b = r.read_bits(8)
        psize += b
        if ptype == 0 and sp is not None and sp.hrd_enabled:
            # parse from the extracted payload so the outer reader stays
            # byte-aligned at the next SEI message
            pr = BitReader(bytes(r.read_bits(8) for _ in range(psize)))
            pr.read_ue()                      # bp_seq_parameter_set_id
            pr.read_bits(1)                   # irap_cpb_params_present
            pr.read_bits(1)                   # concatenation_flag
            pr.read_bits(HRD_AU_LEN)          # au_cpb_removal_delay_delta-1
            out["buffering_period"] = {
                "initial_cpb_removal_delay": pr.read_bits(HRD_INIT_LEN),
                "initial_cpb_removal_offset": pr.read_bits(HRD_INIT_LEN),
            }
        elif ptype == 1 and sp is not None and sp.hrd_enabled:
            pr = BitReader(bytes(r.read_bits(8) for _ in range(psize)))
            out["pic_timing"] = {
                "au_cpb_removal_delay":
                    pr.read_bits(HRD_AU_LEN) + 1,
                "dpb_output_delay": pr.read_bits(HRD_DPB_LEN),
            }
        elif ptype == 132:
            hash_type = r.read_bits(8)
            hashes = []
            n = _HASH_LEN.get(hash_type)
            if n is not None:
                for _ in range((psize - 1) // n):
                    hashes.append(bytes(r.read_bits(8) for _ in range(n)))
            out["picture_hash"] = hashes
            out["picture_hash_type"] = hash_type
        else:
            for _ in range(psize):
                r.read_bits(8)
        # stop at rbsp trailing bits
        if r.bit_position >= total_bits - 8:
            break
    return out
