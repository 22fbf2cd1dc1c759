"""HEVC ROM tables (H.265 spec constants).

Reference parity: HM TLibCommon/TComRom.cpp + TComCABACTables (SURVEY.md C9,
C6) — reimplemented from the ITU-T H.265 standard, not copied.

Contents:
  * Core transform matrices T4/T8/T16/T32 (integer DCT-II approximations,
    spec 8.6.4) built recursively from the odd-row coefficient sets.
  * 4x4 DST-VII matrix (intra luma 4x4).
  * Quantization scale tables (spec 8.6.3).
  * Intra prediction angle / inverse-angle tables (spec 8.4.4.2.6).
  * Coefficient scan orders: diagonal / horizontal / vertical, 4x4-subblock
    based (spec 6.5.3).
  * CABAC engine tables: rangeTabLPS, transIdxLPS/MPS (spec 9.3.4.3.2.2)
    and context initValues (spec 9.3.2.2 tables).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Core transforms (spec 8.6.4)
# ---------------------------------------------------------------------------

# Odd-row coefficient sets c_S: |T_S[odd m][n]| values in first-quadrant
# order.  The full matrices follow from DCT-II symmetry: even rows of T_2N
# embed T_N; odd rows are antisymmetric with entries drawn from c_2N.
_C2 = [64]
_C4 = [83, 36]
_C8 = [89, 75, 50, 18]
_C16 = [90, 87, 80, 70, 57, 43, 25, 9]
_C32 = [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4]
_ODD_COEFS = {2: _C2, 4: _C4, 8: _C8, 16: _C16, 32: _C32}


def _build_dct(size: int) -> np.ndarray:
    """Build the HEVC integer transform matrix of the given size."""
    if size == 1:
        return np.array([[64]], dtype=np.int32)
    half = _build_dct(size // 2)
    t = np.zeros((size, size), dtype=np.int32)
    # Even rows: symmetric embedding of the half-size matrix.
    for k in range(size // 2):
        for n in range(size // 2):
            t[2 * k, n] = half[k, n]
            t[2 * k, size - 1 - n] = half[k, n]
    # Odd rows: entries are +/- c_size[j]; for row m, column n the angle is
    # cos(pi*m*(2n+1)/(2*size)), reduced into the first quadrant.
    c = _ODD_COEFS[size]
    period = 4 * size
    for k in range(size // 2):
        m = 2 * k + 1
        for n in range(size):
            u = (m * (2 * n + 1)) % period
            if u > 2 * size:
                u = period - u  # cos symmetric around 2*pi
            if u < size:
                t[m, n] = c[(u - 1) // 2]
            elif u == size:
                t[m, n] = 0  # never happens for odd u with power-of-2 size
            else:
                t[m, n] = -c[(2 * size - u - 1) // 2]
    return t


T4 = _build_dct(4)
T8 = _build_dct(8)
T16 = _build_dct(16)
T32 = _build_dct(32)
DCT_MATRICES = {4: T4, 8: T8, 16: T16, 32: T32}

# DST-VII 4x4 (spec 8.6.4.2) — used for 4x4 intra luma transform blocks.
DST4 = np.array(
    [
        [29, 55, 74, 84],
        [74, 74, 0, -74],
        [84, -29, -74, 55],
        [55, -84, 74, -29],
    ],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# Quantization (spec 8.6.3)
# ---------------------------------------------------------------------------

# Forward quantizer scales (encoder side, HM convention f = 2^14/Qstep).
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int64)
# Inverse (normative) level scales, spec 8.6.3 levScale[k] (m=16 applied
# separately as the flat scaling-list value).
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int64)

MAX_TR_DYNAMIC_RANGE = 15  # 8-bit profiles
QUANT_SHIFT = 14
IQUANT_SHIFT = 20

# Chroma QP mapping (spec Table 8-10), 4:2:0: qPi -> QpC for qPi in [30, 43].
CHROMA_QP_TABLE = np.array(
    [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37], dtype=np.int32
)


def chroma_qp(qp_y: int, qp_offset: int = 0) -> int:
    """Derive chroma QP from luma QP (4:2:0, spec 8.6.1)."""
    qpi = int(np.clip(qp_y + qp_offset, -12, 57))
    if qpi < 30:
        return max(qpi, 0)
    if qpi > 43:
        return qpi - 6
    return int(CHROMA_QP_TABLE[qpi - 30])


# ---------------------------------------------------------------------------
# Intra prediction (spec 8.4.4.2.6)
# ---------------------------------------------------------------------------

# intraPredAngle for modes 2..34 (index by mode).
INTRA_PRED_ANGLE = {
    2: 32, 3: 26, 4: 21, 5: 17, 6: 13, 7: 9, 8: 5, 9: 2, 10: 0,
    11: -2, 12: -5, 13: -9, 14: -13, 15: -17, 16: -21, 17: -26, 18: -32,
    19: -26, 20: -21, 21: -17, 22: -13, 23: -9, 24: -5, 25: -2, 26: 0,
    27: 2, 28: 5, 29: 9, 30: 13, 31: 17, 32: 21, 33: 26, 34: 32,
}

# invAngle = round(8192 / intraPredAngle) for negative-angle modes 11..25.
INTRA_INV_ANGLE = {
    11: -4096, 12: -1638, 13: -910, 14: -630, 15: -482, 16: -390,
    17: -315, 18: -256, 19: -315, 20: -390, 21: -482, 22: -630,
    23: -910, 24: -1638, 25: -4096,
}

# Intra reference-smoothing thresholds: minDistVerHor > thresh => filter
# (spec 8.4.4.2.3); indexed by nTbS.
INTRA_FILTER_THRESH = {8: 7, 16: 1, 32: 0}

# ---------------------------------------------------------------------------
# Scan orders (spec 6.5.3)
# ---------------------------------------------------------------------------

SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2


def _diag_scan_4x4() -> np.ndarray:
    """Up-right diagonal scan of a 4x4 block -> (16, 2) array of (x, y)."""
    order = []
    for s in range(7):
        # diagonal s: x + y = s, traversed from bottom-left to top-right
        for x in range(max(0, s - 3), min(s, 3) + 1):
            y = s - x
            if y <= 3:
                order.append((x, y))
    return np.array(order, dtype=np.int32)


def scan_order(log2_size: int, scan_idx: int) -> np.ndarray:
    """Full coefficient scan for a transform block.

    Returns an (N*N, 2) array of (x, y) positions in scan order, where the
    scan runs over 4x4 sub-blocks (sub-block order and in-sub-block order use
    the same pattern), except for 4x4 blocks which have a single sub-block.
    Horizontal/vertical scans only occur for 4x4 and 8x8 blocks (MDCS).
    """
    size = 1 << log2_size
    if scan_idx == SCAN_HOR:
        sub = np.array([(x, y) for y in range(4) for x in range(4)], np.int32)
    elif scan_idx == SCAN_VER:
        sub = np.array([(x, y) for x in range(4) for y in range(4)], np.int32)
    else:
        sub = _diag_scan_4x4()
    if size == 4:
        return sub
    nsb = size // 4
    if scan_idx == SCAN_HOR:
        sb_order = np.array([(x, y) for y in range(nsb) for x in range(nsb)], np.int32)
    elif scan_idx == SCAN_VER:
        sb_order = np.array([(x, y) for x in range(nsb) for y in range(nsb)], np.int32)
    else:
        order = []
        for s in range(2 * nsb - 1):
            for x in range(max(0, s - (nsb - 1)), min(s, nsb - 1) + 1):
                y = s - x
                if y <= nsb - 1:
                    order.append((x, y))
        sb_order = np.array(order, np.int32)
    out = np.zeros((size * size, 2), dtype=np.int32)
    i = 0
    for sx, sy in sb_order:
        out[i : i + 16, 0] = sub[:, 0] + 4 * sx
        out[i : i + 16, 1] = sub[:, 1] + 4 * sy
        i += 16
    return out


# sig_coeff_flag context map for 4x4 blocks (spec 9.3.4.2.5 ctxIdxMap).
SIG_CTX_MAP_4x4 = np.array(
    [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8], dtype=np.int32
)

# ---------------------------------------------------------------------------
# CABAC engine tables (spec 9.3.4.3)
# ---------------------------------------------------------------------------

RANGE_TAB_LPS = np.array(
    [
        [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
        [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
        [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
        [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
        [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
        [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
        [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
        [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
        [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
        [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
        [30, 37, 43, 50], [28, 35, 41, 48], [27, 33, 39, 45],
        [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
        [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
        [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
        [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
        [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
        [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
        [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
        [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
        [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
        [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
    ],
    dtype=np.int32,
)

TRANS_IDX_LPS = np.array(
    [
        0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
        13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 23, 22, 23, 24,
        24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
        33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
    ],
    dtype=np.int32,
)

TRANS_IDX_MPS = np.minimum(np.arange(64, dtype=np.int32) + 1, 62)
TRANS_IDX_MPS[63] = 63

# ---------------------------------------------------------------------------
# CABAC context initialization values (spec 9.3.2.2)
# ---------------------------------------------------------------------------
# Indexed by initType (0 = I slice, 1 = P, 2 = B with default flag).
# NOTE: only values used by currently-implemented syntax need to be exact for
# external conformance; encoder/decoder self-conformance holds for any
# consistent values (both sides share these tables).

CTX_INIT = {
    # name: [initType0(I), initType1(P), initType2(B)] each a list per ctxIdx
    "split_cu_flag": [[139, 141, 157], [107, 139, 126], [107, 139, 126]],
    "cu_transquant_bypass_flag": [[154], [154], [154]],
    "cu_skip_flag": [[0, 0, 0], [197, 185, 201], [197, 185, 201]],
    "pred_mode_flag": [[0], [149], [134]],
    "part_mode": [[184], [154, 139, 154, 154], [154, 139, 154, 154]],
    "prev_intra_luma_pred_flag": [[184], [154], [183]],
    "intra_chroma_pred_mode": [[63], [152], [152]],
    "rqt_root_cbf": [[0], [79], [79]],
    "merge_flag": [[0], [110], [154]],
    "merge_idx": [[0], [122], [137]],
    "inter_pred_idc": [[0] * 5, [95, 79, 63, 31, 31], [95, 79, 63, 31, 31]],
    "ref_idx": [[0, 0], [153, 153], [153, 153]],
    "mvd_flag": [[0, 0], [169, 198], [169, 198]],
    "mvp_flag": [[0], [168], [168]],
    "split_transform_flag": [[153, 138, 138], [124, 138, 94], [224, 167, 122]],
    "cbf_luma": [[111, 141], [153, 111], [153, 111]],
    "cbf_chroma": [[94, 138, 182, 154, 154], [149, 107, 167, 154, 154],
                   [149, 92, 167, 154, 154]],
    "transform_skip_flag": [[139, 139], [139, 139], [139, 139]],
    "cu_qp_delta_abs": [[154, 154], [154, 154], [154, 154]],
    # last significant coefficient prefix (x and y share the init table);
    # 15 luma + 3 chroma contexts.
    "last_sig_coeff_prefix": [
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
         79, 108, 123, 63],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
         108, 123, 108],
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111,
         79, 108, 123, 93],
    ],
    "coded_sub_block_flag": [[91, 171, 134, 141], [121, 140, 61, 154],
                             [121, 140, 61, 154]],
    # 27 luma + 15 chroma significance contexts.
    "sig_coeff_flag": [
        [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153,
         125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140,
         139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111],
        [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170,
         153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140],
        [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170,
         153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140],
    ],
    "coeff_abs_level_greater1_flag": [
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
         122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 122, 169, 208, 166, 167, 154, 152, 167, 182],
    ],
    "coeff_abs_level_greater2_flag": [
        [138, 153, 136, 167, 152, 152], [107, 167, 91, 122, 107, 167],
        [107, 167, 91, 107, 107, 167],
    ],
    "sao_merge_flag": [[153], [153], [153]],
    "sao_type_idx": [[200], [185], [160]],
}


def init_context_state(init_value: int, slice_qp: int) -> tuple[int, int]:
    """Derive (pStateIdx, valMps) from an 8-bit initValue (spec 9.3.2.2)."""
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = np.clip((slope * np.clip(slice_qp, 0, 51) >> 4) + offset, 1, 126)
    pre = int(pre)
    if pre <= 63:
        return 63 - pre, 0
    return pre - 64, 1


# Fractional-bit cost per (pStateIdx<<1 | bin!=valMps), in 1/32768 bit units.
# Computed from the CABAC state probabilities the way HM's counter-mode
# estimator does: entropy of the LPS probability implied by each state.
def _build_frac_bits() -> np.ndarray:
    # Probability model underlying the 64-state machine: p_lps(state) =
    # 0.5 * alpha^state with alpha = (0.01875/0.5)^(1/63).
    alpha = (0.01875 / 0.5) ** (1.0 / 63.0)
    p_lps = 0.5 * alpha ** np.arange(64)
    bits = np.zeros((64, 2))
    bits[:, 0] = -np.log2(1.0 - p_lps)  # cost of coding the MPS
    bits[:, 1] = -np.log2(p_lps)  # cost of coding the LPS
    return np.round(bits * 32768.0).astype(np.int32)


FRAC_BITS = _build_frac_bits()  # [state, is_lps] -> cost in 2^-15 bits
