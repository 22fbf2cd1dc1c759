"""Transform-coefficient syntax coding (residual_coding, spec 7.3.8.11).

Reference parity: HM TEncSbac::codeCoeffNxN / TDecSbac::parseCoeffNxN
(SURVEY.md C6) — reimplemented from H.265 spec 7.3.8.11 + 9.3.4.2.5-7
and 9.3.3.9 (coeff_abs_level_remaining binarization).

Works against any coder exposing encode_bin/encode_bypass/encode_bypass_bits
(CabacEncoder or CabacEstimator) and the mirror CabacDecoder.
Sign-data hiding and transform-skip are not used (disabled in the PPS).
"""

from __future__ import annotations

import numpy as np

from .tables import SCAN_DIAG, SCAN_HOR, SCAN_VER, SIG_CTX_MAP_4x4, scan_order

_SCAN_CACHE: dict[tuple[int, int], np.ndarray] = {}


def get_scan(log2_size: int, scan_idx: int) -> np.ndarray:
    key = (log2_size, scan_idx)
    if key not in _SCAN_CACHE:
        _SCAN_CACHE[key] = scan_order(log2_size, scan_idx)
    return _SCAN_CACHE[key]


def intra_scan_idx(log2_size: int, c_idx: int, pred_mode: int) -> int:
    """Mode-dependent coefficient scan (spec: intra 4x4/8x8 luma + 4x4 chroma)."""
    if log2_size == 2 or (log2_size == 3 and c_idx == 0):
        if 6 <= pred_mode <= 14:
            return SCAN_VER
        if 22 <= pred_mode <= 30:
            return SCAN_HOR
    return SCAN_DIAG


# ---------------------------------------------------------------------------
# Context index derivations (9.3.4.2.3-7)
# ---------------------------------------------------------------------------

def last_ctx_params(log2_size: int, c_idx: int) -> tuple[int, int]:
    if c_idx == 0:
        offset = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
        shift = (log2_size + 1) >> 2
    else:
        offset = 15
        shift = log2_size - 2
    return offset, shift


def sig_ctx_inc(log2_size: int, c_idx: int, x: int, y: int, scan_idx: int,
                csbf_right: int, csbf_below: int) -> int:
    """Context increment for sig_coeff_flag (spec 9.3.4.2.5)."""
    if log2_size == 2:
        sig = int(SIG_CTX_MAP_4x4[(y << 2) + x])
    elif x == 0 and y == 0:
        sig = 0
    else:
        xp, yp = x & 3, y & 3
        prev = csbf_right + 2 * csbf_below
        if prev == 0:
            sig = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
        elif prev == 1:
            sig = 2 if yp == 0 else (1 if yp == 1 else 0)
        elif prev == 2:
            sig = 2 if xp == 0 else (1 if xp == 1 else 0)
        else:
            sig = 2
        if c_idx == 0:
            if (x >> 2) + (y >> 2) > 0:
                sig += 3
            sig += (9 if scan_idx == SCAN_DIAG else 15) if log2_size == 3 else 21
        else:
            sig += 9 if log2_size == 3 else 12
    return sig + (27 if c_idx else 0)


# ---------------------------------------------------------------------------
# coeff_abs_level_remaining binarization (9.3.3.9)
# ---------------------------------------------------------------------------

def write_remaining(coder, value: int, rice: int) -> None:
    if value < (3 << rice):
        length = value >> rice
        coder.encode_bypass_bits((1 << (length + 1)) - 2, length + 1)
        if rice:
            coder.encode_bypass_bits(value & ((1 << rice) - 1), rice)
    else:
        length = rice
        v = value - (3 << rice)
        while v >= (1 << length):
            v -= 1 << length
            length += 1
        n_pref = 3 + length + 1 - rice
        coder.encode_bypass_bits((1 << n_pref) - 2, n_pref)
        if length:
            coder.encode_bypass_bits(v, length)


def read_remaining(dec, rice: int) -> int:
    prefix = 0
    while dec.decode_bypass() == 1:
        prefix += 1
        if prefix > 32:
            raise ValueError("corrupt remaining prefix")
    if prefix < 3:
        return (prefix << rice) + (dec.decode_bypass_bits(rice) if rice else 0)
    length = prefix - 3 + rice
    base = (3 << rice) + ((1 << length) - (1 << rice))
    return base + (dec.decode_bypass_bits(length) if length else 0)


# ---------------------------------------------------------------------------
# last position binarization (9.3.3.2)
# ---------------------------------------------------------------------------

def _last_prefix_suffix(pos: int) -> tuple[int, int, int]:
    """pos -> (prefix, suffix, suffix_len)."""
    if pos <= 3:
        return pos, 0, 0
    suffix_len = (pos.bit_length() - 2)
    prefix = 2 + suffix_len * 2 + ((pos >> suffix_len) & 1)
    suffix = pos - ((2 + (prefix & 1)) << suffix_len)
    return prefix, suffix, suffix_len


def _write_last_position(coder, last_x: int, last_y: int, log2_size: int,
                         c_idx: int) -> None:
    g_max = (log2_size << 1) - 1
    offset, shift = last_ctx_params(log2_size, c_idx)
    px, sx, slx = _last_prefix_suffix(last_x)
    py, sy, sly = _last_prefix_suffix(last_y)
    for i in range(px):
        coder.encode_bin("last_sig_coeff_prefix", offset + (i >> shift), 1)
    if px < g_max:
        coder.encode_bin("last_sig_coeff_prefix", offset + (px >> shift), 0)
    for i in range(py):
        coder.encode_bin("last_sig_coeff_prefix", offset + (i >> shift), 1)
    if py < g_max:
        coder.encode_bin("last_sig_coeff_prefix", offset + (py >> shift), 0)
    if px > 3:
        coder.encode_bypass_bits(sx, slx)
    if py > 3:
        coder.encode_bypass_bits(sy, sly)


def _read_last_component(dec, offset: int, shift: int, g_max: int) -> int:
    prefix = 0
    while prefix < g_max and dec.decode_bin(
            "last_sig_coeff_prefix", offset + (prefix >> shift)) == 1:
        prefix += 1
    return prefix


def _last_from_prefix(dec, prefix: int) -> int:
    if prefix <= 3:
        return prefix
    suffix_len = (prefix >> 1) - 1
    suffix = dec.decode_bypass_bits(suffix_len)
    return ((2 + (prefix & 1)) << suffix_len) + suffix


# ---------------------------------------------------------------------------
# Main encode / decode
# ---------------------------------------------------------------------------

def sdh_adjust(levels: np.ndarray, coeff: np.ndarray, qp: int,
               bit_depth: int, log2_size: int, scan_idx: int) -> np.ndarray:
    """Encoder-side sign-data-hiding parity fix (spec 7.4.9.11 inference,
    HM xSignBitHidingHDQ essence): per 4x4 sub-block whose significant
    span exceeds 3 scan positions, force (sum |levels|) & 1 == sign of the
    lowest-scan-pos coefficient by bumping |level| +1 at the in-span
    position with the largest quantizer residue. Returns adjusted levels
    (modified copy only when a fix is needed)."""
    from .transform import QUANT_SCALES

    size = 1 << log2_size
    scan = get_scan(log2_size, scan_idx)
    vals = levels[scan[:, 1], scan[:, 0]]
    cvals = coeff[scan[:, 1], scan[:, 0]].astype(np.int64)
    qbits = 14 + qp // 6 + (15 - bit_depth - log2_size)
    scale = int(QUANT_SCALES[qp % 6])
    out = None
    for base in range(0, size * size, 16):
        sub = vals[base:base + 16]
        nz = np.nonzero(sub)[0]
        if len(nz) == 0 or nz[-1] - nz[0] <= 3:
            continue
        want = 1 if sub[nz[0]] < 0 else 0
        if (int(np.abs(sub).sum()) & 1) == want:
            continue
        if out is None:
            out = levels.copy()
            vals = out[scan[:, 1], scan[:, 0]]  # view-by-copy; re-read below
        first, last = int(nz[0]), int(nz[-1])
        span = slice(base + first, base + last + 1)
        a = np.abs(cvals[span]) * scale
        la = np.abs(vals[span]).astype(np.int64)
        r = np.where(la >= 32767, np.int64(-2**62), a - (la << qbits))
        k = base + first + int(np.argmax(r))
        x, y = int(scan[k, 0]), int(scan[k, 1])
        if out[y, x] > 0:
            out[y, x] += 1
        elif out[y, x] < 0:
            out[y, x] -= 1
        else:
            out[y, x] = -1 if coeff[y, x] < 0 else 1
        vals = out[scan[:, 1], scan[:, 0]]
    return levels if out is None else out


def encode_residual(coder, levels: np.ndarray, log2_size: int, c_idx: int,
                    scan_idx: int, sdh: bool = False) -> None:
    """Entropy-code one transform block's quantized levels.

    levels: (N, N) int array indexed [y][x], at least one nonzero.
    sdh: PPS sign_data_hiding_enabled_flag (and not transquant bypass) —
    the caller's quantizer must have applied sdh_adjust."""
    if hasattr(coder, "encode_residual_native"):
        coder.encode_residual_native(levels, log2_size, c_idx, scan_idx,
                                     sdh)
        return
    size = 1 << log2_size
    scan = get_scan(log2_size, scan_idx)
    n_coeffs = size * size
    lv = levels  # [y][x]

    # scan-position values
    vals = lv[scan[:, 1], scan[:, 0]]
    nz = np.nonzero(vals)[0]
    assert len(nz) > 0, "encode_residual requires a coded block"
    last_scan_pos = int(nz[-1])

    # last position coordinates (swapped for vertical scan)
    last_x = int(scan[last_scan_pos, 0])
    last_y = int(scan[last_scan_pos, 1])
    if scan_idx == SCAN_VER:
        last_x, last_y = last_y, last_x
    _write_last_position(coder, last_x, last_y, log2_size, c_idx)

    nsb = max(1, size // 4)
    num_subsets = (last_scan_pos >> 4) + 1
    csbf = np.zeros((nsb, nsb), dtype=np.int32)
    for i in range(num_subsets):
        sub_vals = vals[i * 16:(i + 1) * 16]
        sx = scan[i * 16, 0] >> 2
        sy = scan[i * 16, 1] >> 2
        csbf[sy, sx] = 1 if np.any(sub_vals) else 0

    c1 = 1
    for i in range(num_subsets - 1, -1, -1):
        sub_scan = scan[i * 16:(i + 1) * 16]
        sub_vals = vals[i * 16:(i + 1) * 16]
        sx = int(sub_scan[0, 0]) >> 2
        sy = int(sub_scan[0, 1]) >> 2
        is_last_subset = (i == num_subsets - 1)
        infer_sb_dc_sig = False
        if is_last_subset or i == 0:
            sb_coded = 1  # csbf inferred
        else:
            sb_coded = int(csbf[sy, sx])
            right = int(csbf[sy, sx + 1]) if sx + 1 < nsb else 0
            below = int(csbf[sy + 1, sx]) if sy + 1 < nsb else 0
            ctx = min(right + below, 1) + (2 if c_idx else 0)
            coder.encode_bin("coded_sub_block_flag", ctx, sb_coded)
            infer_sb_dc_sig = bool(sb_coded)
        if not sb_coded:
            continue

        # significance flags
        start = 15 if not is_last_subset else (last_scan_pos - i * 16) - 1
        right = int(csbf[sy, sx + 1]) if sx + 1 < nsb else 0
        below = int(csbf[sy + 1, sx]) if sy + 1 < nsb else 0
        sig = (sub_vals != 0).astype(np.int32)
        coded_positions = []  # scan positions (within subset) with sig==1
        if is_last_subset:
            coded_positions.append(last_scan_pos - i * 16)
        for n in range(start, -1, -1):
            x, y = int(sub_scan[n, 0]), int(sub_scan[n, 1])
            if n == 0 and infer_sb_dc_sig and not any(
                    sig[m] for m in range(1, 16)):
                # DC sig inferred to 1
                coded_positions.append(0)
                assert sig[0] == 1, "csbf=1 but empty sub-block"
                continue
            ctx = sig_ctx_inc(log2_size, c_idx, x, y, scan_idx, right, below)
            coder.encode_bin("sig_coeff_flag", ctx, int(sig[n]))
            if sig[n]:
                coded_positions.append(n)

        # coded_positions is in decreasing scan order
        abs_vals = [abs(int(sub_vals[n])) for n in coded_positions]
        signs = [1 if int(sub_vals[n]) < 0 else 0 for n in coded_positions]
        num_sig = len(coded_positions)

        # greater1 flags (first 8), greater2 (first gt1)
        ctx_set = 2 if (i > 0 and c_idx == 0) else 0
        if c1 == 0:
            ctx_set += 1
        c1 = 1
        gt1_flags = []
        first_gt1_idx = -1
        for k in range(min(8, num_sig)):
            g = 1 if abs_vals[k] > 1 else 0
            base = (16 if c_idx else 0) + 4 * ctx_set + c1
            coder.encode_bin("coeff_abs_level_greater1_flag", base, g)
            gt1_flags.append(g)
            if g:
                if first_gt1_idx < 0:
                    first_gt1_idx = k
                c1 = 0
            elif 0 < c1 < 3:
                c1 += 1
        if first_gt1_idx >= 0:
            g2 = 1 if abs_vals[first_gt1_idx] > 2 else 0
            ctx2 = (4 if c_idx else 0) + ctx_set
            coder.encode_bin("coeff_abs_level_greater2_flag", ctx2, g2)

        # signs (bypass); with SDH the lowest-scan-pos sign is inferred
        # from the level-sum parity (spec 7.4.9.11)
        sign_hidden = (sdh and num_sig > 0
                       and coded_positions[0] - coded_positions[-1] > 3)
        for s in (signs[:-1] if sign_hidden else signs):
            coder.encode_bypass(s)

        # remaining levels
        rice = 0
        for k in range(num_sig):
            if k < 8:
                if gt1_flags[k] == 0:
                    base_level = 1
                elif k == first_gt1_idx:
                    base_level = 3 if abs_vals[k] > 2 else 2
                    # remaining present only if gt2 == 1
                    if abs_vals[k] <= 2:
                        continue
                else:
                    base_level = 2
            else:
                base_level = 1
            if k < 8 and gt1_flags[k] == 0:
                continue  # level == 1 exactly, nothing more to code
            rem = abs_vals[k] - base_level
            write_remaining(coder, rem, rice)
            if abs_vals[k] > (3 << rice) and rice < 4:
                rice += 1


def decode_residual(dec, log2_size: int, c_idx: int,
                    scan_idx: int, sdh: bool = False) -> np.ndarray:
    """Parse one coded transform block -> (N, N) int32 levels [y][x]."""
    size = 1 << log2_size
    scan = get_scan(log2_size, scan_idx)
    g_max = (log2_size << 1) - 1
    offset, shift = last_ctx_params(log2_size, c_idx)

    px = _read_last_component(dec, offset, shift, g_max)
    py = _read_last_component(dec, offset, shift, g_max)
    last_x = _last_from_prefix(dec, px)
    last_y = _last_from_prefix(dec, py)
    if scan_idx == SCAN_VER:
        last_x, last_y = last_y, last_x

    # find last scan pos
    pos_of = {(int(x), int(y)): n for n, (x, y) in enumerate(scan)}
    last_scan_pos = pos_of[(last_x, last_y)]

    levels = np.zeros((size, size), dtype=np.int32)
    nsb = max(1, size // 4)
    num_subsets = (last_scan_pos >> 4) + 1
    csbf = np.zeros((nsb, nsb), dtype=np.int32)

    c1 = 1
    for i in range(num_subsets - 1, -1, -1):
        sub_scan = scan[i * 16:(i + 1) * 16]
        sx = int(sub_scan[0, 0]) >> 2
        sy = int(sub_scan[0, 1]) >> 2
        is_last_subset = (i == num_subsets - 1)
        infer_sb_dc_sig = False
        if is_last_subset or i == 0:
            sb_coded = 1
            csbf[sy, sx] = 1
        else:
            right = int(csbf[sy, sx + 1]) if sx + 1 < nsb else 0
            below = int(csbf[sy + 1, sx]) if sy + 1 < nsb else 0
            ctx = min(right + below, 1) + (2 if c_idx else 0)
            sb_coded = dec.decode_bin("coded_sub_block_flag", ctx)
            csbf[sy, sx] = sb_coded
            infer_sb_dc_sig = bool(sb_coded)
        if not sb_coded:
            continue

        right = int(csbf[sy, sx + 1]) if sx + 1 < nsb else 0
        below = int(csbf[sy + 1, sx]) if sy + 1 < nsb else 0
        sig = np.zeros(16, dtype=np.int32)
        coded_positions = []
        start = 15 if not is_last_subset else (last_scan_pos - i * 16) - 1
        if is_last_subset:
            sig[last_scan_pos - i * 16] = 1
            coded_positions.append(last_scan_pos - i * 16)
        any_sig_above_dc = False
        for n in range(start, -1, -1):
            x, y = int(sub_scan[n, 0]), int(sub_scan[n, 1])
            if n == 0 and infer_sb_dc_sig and not any_sig_above_dc:
                sig[0] = 1
                coded_positions.append(0)
                continue
            ctx = sig_ctx_inc(log2_size, c_idx, x, y, scan_idx, right, below)
            s = dec.decode_bin("sig_coeff_flag", ctx)
            sig[n] = s
            if s:
                coded_positions.append(n)
                if n > 0:
                    any_sig_above_dc = True

        num_sig = len(coded_positions)
        ctx_set = 2 if (i > 0 and c_idx == 0) else 0
        if c1 == 0:
            ctx_set += 1
        c1 = 1
        gt1_flags = []
        first_gt1_idx = -1
        for k in range(min(8, num_sig)):
            base = (16 if c_idx else 0) + 4 * ctx_set + c1
            g = dec.decode_bin("coeff_abs_level_greater1_flag", base)
            gt1_flags.append(g)
            if g:
                if first_gt1_idx < 0:
                    first_gt1_idx = k
                c1 = 0
            elif 0 < c1 < 3:
                c1 += 1
        gt2 = 0
        if first_gt1_idx >= 0:
            ctx2 = (4 if c_idx else 0) + ctx_set
            gt2 = dec.decode_bin("coeff_abs_level_greater2_flag", ctx2)

        sign_hidden = (sdh and num_sig > 0
                       and coded_positions[0] - coded_positions[-1] > 3)
        signs = [dec.decode_bypass()
                 for _ in range(num_sig - (1 if sign_hidden else 0))]

        rice = 0
        abs_out = []
        for k in range(num_sig):
            if k < 8:
                if gt1_flags[k] == 0:
                    val = 1
                elif k == first_gt1_idx:
                    if gt2:
                        val = 3 + read_remaining(dec, rice)
                    else:
                        val = 2
                else:
                    val = 2 + read_remaining(dec, rice)
            else:
                val = 1 + read_remaining(dec, rice)
            if val > (3 << rice) and rice < 4:
                rice += 1
            abs_out.append(val)
        if sign_hidden:
            # hidden sign = parity of the sub-block's abs-level sum
            signs.append(sum(abs_out) & 1)
        for k in range(num_sig):
            n = coded_positions[k]
            x, y = int(sub_scan[n, 0]), int(sub_scan[n, 1])
            levels[y, x] = -abs_out[k] if signs[k] else abs_out[k]
    return levels
