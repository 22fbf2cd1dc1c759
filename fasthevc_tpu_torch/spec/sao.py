"""Sample-adaptive offset (spec 8.7.3, syntax 7.3.8.3) — estimation,
application, and CTU-level syntax.

Reference parity: HM TComSampleAdaptiveOffset + TEncSampleAdaptiveOffset
(SURVEY.md C8). Estimation follows HM's shape: per CTB collect (count,
sum-of-diff) statistics per category for every candidate type/class, pick
offsets minimizing the distortion delta, then choose the best candidate
with a small rate penalty.

SAO classifies on the deblocked (pre-SAO) picture; application never feeds
back into classification, so it vectorizes over the whole frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SAO_OFF, SAO_BAND, SAO_EDGE = 0, 1, 2
MAX_OFFSET = 7  # (1 << (min(bitDepth,10) - 5)) - 1 for 8-bit

# EO class -> neighbor offsets ((y0,x0),(y1,x1))
EO_NEIGHBORS = {
    0: ((0, -1), (0, 1)),     # horizontal
    1: ((-1, 0), (1, 0)),     # vertical
    2: ((-1, -1), (1, 1)),    # 135 degrees
    3: ((1, -1), (-1, 1)),    # 45 degrees
}


@dataclass
class SaoParam:
    """Per-CTB, per-component SAO parameters."""
    type_idx: int = SAO_OFF
    eo_class: int = 0
    band_pos: int = 0
    offsets: tuple = (0, 0, 0, 0)  # signed applied values


def _edge_categories(plane: np.ndarray, eo_class: int) -> np.ndarray:
    """Category map (0..4) for a full plane; boundary samples category 0."""
    (y0, x0), (y1, x1) = EO_NEIGHBORS[eo_class]
    h, w = plane.shape
    cat = np.zeros((h, w), dtype=np.int32)
    ty, by = max(0, -y0, -y1), max(0, y0, y1)
    lx, rx = max(0, -x0, -x1), max(0, x0, x1)
    c = plane[ty:h - by, lx:w - rx].astype(np.int32)
    n0 = plane[ty + y0:h - by + y0, lx + x0:w - rx + x0].astype(np.int32)
    n1 = plane[ty + y1:h - by + y1, lx + x1:w - rx + x1].astype(np.int32)
    raw = 2 + np.sign(c - n0) + np.sign(c - n1)
    remap = np.array([1, 2, 0, 3, 4], dtype=np.int32)
    cat[ty:h - by, lx:w - rx] = remap[raw]
    return cat


def _band_index(plane: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    return plane >> (bit_depth - 5)


def estimate_ctb(src: np.ndarray, rec: np.ndarray,
                 bit_depth: int = 8,
                 lambda_rate: float = 0.0) -> SaoParam:
    """Pick the best SAO parameters for one CTB of one component.

    src/rec: the CTB region (source vs deblocked recon), plus rec must be
    classified with full-plane context by the caller passing pre-computed
    category maps — here we classify within the CTB (boundary samples of
    the CTB use in-CTB neighbors only, a conservative approximation that
    only affects parameter choice, not conformance).
    """
    diff = src.astype(np.int64) - rec.astype(np.int64)
    best = (0.0, SaoParam())  # (gain, param)

    def offset_for(count, s):
        if count == 0:
            return 0
        o = int(np.clip(round(s / count), -MAX_OFFSET, MAX_OFFSET))
        return o

    def gain_of(counts, sums, offs):
        # distortion reduction: sum 2*o*s - o^2*n  (positive = better)
        return sum(2 * o * s - o * o * n
                   for o, s, n in zip(offs, sums, counts))

    # ---- edge offset candidates ----
    for cls in range(4):
        cat = _edge_categories(rec, cls)
        counts, sums = [], []
        for c in range(1, 5):
            m = cat == c
            counts.append(int(m.sum()))
            sums.append(int(diff[m].sum()))
        offs = [offset_for(n, s) for n, s in zip(counts, sums)]
        # EO sign constraint: cats 1,2 non-negative; 3,4 non-positive
        offs[0] = max(0, offs[0])
        offs[1] = max(0, offs[1])
        offs[2] = min(0, offs[2])
        offs[3] = min(0, offs[3])
        g = gain_of(counts, sums, offs) - lambda_rate * 8
        if g > best[0]:
            best = (g, SaoParam(SAO_EDGE, cls, 0, tuple(offs)))

    # ---- band offset candidate ----
    band = _band_index(rec, bit_depth)
    counts = np.zeros(32, dtype=np.int64)
    sums = np.zeros(32, dtype=np.int64)
    np.add.at(counts, band.ravel(), 1)
    np.add.at(sums, band.ravel(), diff.ravel())
    band_offs = [offset_for(int(counts[b]), int(sums[b])) for b in range(32)]
    band_gain = [2 * band_offs[b] * sums[b] - band_offs[b] ** 2 * counts[b]
                 for b in range(32)]
    # best run of 4 consecutive bands
    best_pos, best_g = 0, -1e18
    for pos in range(29):
        g = float(sum(band_gain[pos:pos + 4]))
        if g > best_g:
            best_g, best_pos = g, pos
    g = best_g - lambda_rate * 10
    if g > best[0]:
        offs = tuple(band_offs[best_pos:best_pos + 4])
        best = (g, SaoParam(SAO_BAND, 0, best_pos, offs))

    return best[1]


def estimate_ctb_given(src: np.ndarray, rec: np.ndarray, type_idx: int,
                       eo_class: int, bit_depth: int = 8) -> SaoParam:
    """Estimate offsets for a fixed type/class (Cr shares Cb's type_idx and
    eo_class per spec; only offsets and band position are free)."""
    diff = src.astype(np.int64) - rec.astype(np.int64)

    def offset_for(count, s):
        if count == 0:
            return 0
        return int(np.clip(round(s / count), -MAX_OFFSET, MAX_OFFSET))

    if type_idx == SAO_OFF:
        return SaoParam()
    if type_idx == SAO_EDGE:
        cat = _edge_categories(rec, eo_class)
        offs = []
        for c in range(1, 5):
            m = cat == c
            offs.append(offset_for(int(m.sum()), int(diff[m].sum())))
        offs[0] = max(0, offs[0])
        offs[1] = max(0, offs[1])
        offs[2] = min(0, offs[2])
        offs[3] = min(0, offs[3])
        return SaoParam(SAO_EDGE, eo_class, 0, tuple(offs))
    band = _band_index(rec, bit_depth)
    counts = np.zeros(32, dtype=np.int64)
    sums = np.zeros(32, dtype=np.int64)
    np.add.at(counts, band.ravel(), 1)
    np.add.at(sums, band.ravel(), diff.ravel())
    offs = [offset_for(int(counts[b]), int(sums[b])) for b in range(32)]
    gains = [2 * offs[b] * sums[b] - offs[b] ** 2 * counts[b]
             for b in range(32)]
    best_pos = max(range(29), key=lambda p: sum(gains[p:p + 4]))
    return SaoParam(SAO_BAND, 0, best_pos, tuple(offs[best_pos:best_pos + 4]))


def apply_sao_plane(plane: np.ndarray, params: list, ctb_size: int,
                    bit_depth: int = 8) -> np.ndarray:
    """Apply per-CTB SAO params to a deblocked plane; returns new plane.

    params: [ctbs_y][ctbs_x] -> SaoParam. Classification reads the input
    plane (never the output).
    """
    h, w = plane.shape
    out = plane.copy()
    max_val = (1 << bit_depth) - 1
    n_y = (h + ctb_size - 1) // ctb_size
    n_x = (w + ctb_size - 1) // ctb_size
    # cache full-plane category maps per used eo class
    cat_maps = {}
    for by in range(n_y):
        for bx in range(n_x):
            p: SaoParam = params[by][bx]
            if p.type_idx == SAO_OFF:
                continue
            ys = slice(by * ctb_size, min((by + 1) * ctb_size, h))
            xs = slice(bx * ctb_size, min((bx + 1) * ctb_size, w))
            region = plane[ys, xs].astype(np.int32)
            if p.type_idx == SAO_EDGE:
                if p.eo_class not in cat_maps:
                    cat_maps[p.eo_class] = _edge_categories(plane, p.eo_class)
                cat = cat_maps[p.eo_class][ys, xs]
                lut = np.array([0, p.offsets[0], p.offsets[1], p.offsets[2],
                                p.offsets[3]], dtype=np.int32)
                region = region + lut[cat]
            else:  # band
                band = _band_index(region, bit_depth)
                lut = np.zeros(32, dtype=np.int32)
                for i in range(4):
                    lut[(p.band_pos + i) % 32] = p.offsets[i]
                region = region + lut[band]
            out[ys, xs] = np.clip(region, 0, max_val)
    return out


def apply_sao(planes, sp, params_y, params_cb, params_cr) -> None:
    ctb = 1 << sp.log2_ctu
    planes.y[:] = apply_sao_plane(planes.y, params_y, ctb, sp.bit_depth)
    planes.cb[:] = apply_sao_plane(planes.cb, params_cb, ctb // 2,
                                   sp.bit_depth)
    planes.cr[:] = apply_sao_plane(planes.cr, params_cr, ctb // 2,
                                   sp.bit_depth)


# ---------------------------------------------------------------------------
# Syntax (7.3.8.3): coded at the start of each CTU
# ---------------------------------------------------------------------------

def encode_sao_ctu(coder, p_y: SaoParam, p_cb: SaoParam, p_cr: SaoParam,
                   rx: int, ry: int, sao_luma: bool, sao_chroma: bool,
                   left_in_tile: bool = True, up_in_tile: bool = True):
    """Encode SAO params for one CTU (merge flags always 0 — this encoder
    signals explicit params; merging is a rate optimization, not required).
    Merge flags are only present when the neighbor CTB is in the same
    slice AND tile (spec 7.3.8.3)."""
    if rx > 0 and left_in_tile:
        coder.encode_bin("sao_merge_flag", 0, 0)
    if ry > 0 and up_in_tile:
        coder.encode_bin("sao_merge_flag", 0, 0)

    def type_and_offsets(p: SaoParam, is_luma: bool, write_class: bool):
        # sao_type_idx: TR cMax=2: 0 -> '0'; 1(BAND) -> '10'; 2(EDGE) -> '11'
        coder.encode_bin("sao_type_idx", 0, 1 if p.type_idx else 0)
        if p.type_idx:
            coder.encode_bypass(1 if p.type_idx == SAO_EDGE else 0)
            for i in range(4):
                a = abs(p.offsets[i])
                # TR cMax=7 bypass
                for k in range(a):
                    coder.encode_bypass(1)
                if a < MAX_OFFSET:
                    coder.encode_bypass(0)
            if p.type_idx == SAO_BAND:
                for i in range(4):
                    if p.offsets[i] != 0:
                        coder.encode_bypass(1 if p.offsets[i] < 0 else 0)
                coder.encode_bypass_bits(p.band_pos, 5)
            elif write_class:
                coder.encode_bypass_bits(p.eo_class, 2)

    if sao_luma:
        type_and_offsets(p_y, True, True)
    if sao_chroma:
        type_and_offsets(p_cb, False, True)
        # Cr shares type and eo_class with Cb; offsets coded separately
        _encode_offsets_only(coder, p_cr)


def _encode_offsets_only(coder, p: SaoParam):
    if p.type_idx:
        for i in range(4):
            a = abs(p.offsets[i])
            for k in range(a):
                coder.encode_bypass(1)
            if a < MAX_OFFSET:
                coder.encode_bypass(0)
        if p.type_idx == SAO_BAND:
            for i in range(4):
                if p.offsets[i] != 0:
                    coder.encode_bypass(1 if p.offsets[i] < 0 else 0)
            coder.encode_bypass_bits(p.band_pos, 5)


def decode_sao_ctu(dec, rx: int, ry: int, sao_luma: bool, sao_chroma: bool,
                   left_params=None, up_params=None,
                   left_in_tile: bool = True, up_in_tile: bool = True):
    """Decode SAO params for one CTU -> (p_y, p_cb, p_cr)."""
    merge_left = merge_up = 0
    if rx > 0 and left_in_tile:
        merge_left = dec.decode_bin("sao_merge_flag", 0)
    if not merge_left and ry > 0 and up_in_tile:
        merge_up = dec.decode_bin("sao_merge_flag", 0)
    if merge_left:
        return tuple(SaoParam(**vars(p)) for p in left_params)
    if merge_up:
        return tuple(SaoParam(**vars(p)) for p in up_params)

    def read_type_offsets(read_class: bool, shared=None):
        p = SaoParam()
        if shared is None:
            if dec.decode_bin("sao_type_idx", 0):
                p.type_idx = SAO_EDGE if dec.decode_bypass() else SAO_BAND
        else:
            p.type_idx = shared.type_idx
            p.eo_class = shared.eo_class
        if p.type_idx:
            abss = []
            for i in range(4):
                a = 0
                while a < MAX_OFFSET and dec.decode_bypass():
                    a += 1
                abss.append(a)
            if p.type_idx == SAO_BAND:
                offs = []
                for a in abss:
                    if a != 0 and dec.decode_bypass():
                        offs.append(-a)
                    else:
                        offs.append(a)
                p.offsets = tuple(offs)
                p.band_pos = dec.decode_bypass_bits(5)
            else:
                if shared is None and read_class:
                    p.eo_class = dec.decode_bypass_bits(2)
                p.offsets = (abss[0], abss[1], -abss[2], -abss[3])
        return p

    p_y = SaoParam()
    p_cb = SaoParam()
    p_cr = SaoParam()
    if sao_luma:
        p_y = read_type_offsets(True)
    if sao_chroma:
        p_cb = read_type_offsets(True)
        p_cr = read_type_offsets(False, shared=p_cb)
    return p_y, p_cb, p_cr
