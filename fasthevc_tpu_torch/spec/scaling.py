"""Quantization scaling lists (SURVEY.md C2/C5).

Reference parity: HM TComScalingList + TComTrQuant::xSetScalingListDec
(spec 7.3.4 scaling_list_data, 7.4.5 derivation, 8.6.3 scaling process).

Default matrices (spec Table 7-5/7-6): sizeId 0 (4x4) is flat 16 for all
matrixIds; sizeId 1..3 use the 8x8 intra/inter matrices below, with
16x16/32x32 derived by 2x/4x upsampling and an explicit DC coefficient
(default 16).  matrixId = cIdx + 3*predMode for sizeId < 3; sizeId 3 has
only matrixIds 0 (intra luma) and 1 (inter luma).
"""

from __future__ import annotations

import numpy as np

# spec Table 7-6 (raster order, as HM g_quantIntraDefault8x8)
DEFAULT_8X8_INTRA = np.array([
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115], dtype=np.int32).reshape(8, 8)

# spec Table 7-6 (g_quantInterDefault8x8)
DEFAULT_8X8_INTER = np.array([
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91], dtype=np.int32).reshape(8, 8)


def default_matrix(n: int, is_inter: bool) -> np.ndarray:
    """ScalingFactor[sizeId][matrixId] for the DEFAULT lists at TB size
    n (raster [n, n]); DC of 16/32 stays 16 (default dc coefficient)."""
    if n == 4:
        return np.full((4, 4), 16, dtype=np.int32)
    base = DEFAULT_8X8_INTER if is_inter else DEFAULT_8X8_INTRA
    if n == 8:
        return base.copy()
    r = n // 8
    m = np.repeat(np.repeat(base, r, axis=0), r, axis=1)
    m[0, 0] = 16  # scaling_list_dc_coef default
    return m


def scaling_matrix(sp, n: int, is_inter: bool,
                   c_idx: int = 0) -> np.ndarray | None:
    """The active ScalingFactor matrix for a TB, or None when scaling
    lists are off (flat m = 16, the fast path in transform.py).

    Resolves sp.scaling_data custom lists when present (parsed or
    provided), else the spec default lists (HM CTC `ScalingList=1`)."""
    if not getattr(sp, "scaling_lists", False):
        return None
    cache = getattr(sp, "_scaling_cache", None)
    if cache is None:
        cache = sp._scaling_cache = {}
    key = (n, is_inter, c_idx)
    m = cache.get(key)
    if m is None:
        data = getattr(sp, "scaling_data", None)
        if data is not None:
            size_id = {4: 0, 8: 1, 16: 2, 32: 3}[n]
            if size_id == 3:
                matrix_id = 1 if is_inter else 0
            else:
                matrix_id = c_idx + (3 if is_inter else 0)
            m = data.get((size_id, matrix_id))
        if m is None:
            m = default_matrix(n, is_inter)
        cache[key] = m
    return m


# ---------------------------------------------------------------------------
# scaling_list_data syntax (spec 7.3.4) — up-right diagonal coding order
# ---------------------------------------------------------------------------

def _diag_scan(n: int) -> list[tuple[int, int]]:
    """Up-right diagonal scan (spec 6.5.3) as (y, x) pairs."""
    out = []
    for s in range(2 * n - 1):
        y = min(s, n - 1)
        x = s - y
        while y >= 0 and x < n:
            out.append((y, x))
            y -= 1
            x += 1
    return out


def write_scaling_list_data(w, lists: dict | None = None) -> None:
    """scaling_list_data(): all-default signalling when lists is None
    (scaling_list_pred_mode_flag = 0, pred_matrix_id_delta = 0), else
    explicit coefficients for the provided {(size_id, matrix_id): matrix}
    entries (delta coding in diagonal order, DC first for sizeId >= 2)."""
    for size_id in range(4):
        n_mat = 2 if size_id == 3 else 6
        for matrix_id in range(n_mat):
            mat = None if lists is None else lists.get((size_id, matrix_id))
            if mat is None:
                w.write_flag(0)   # pred_mode: from reference
                w.write_ue(0)     # pred_matrix_id_delta: default list
                continue
            w.write_flag(1)       # explicit DPCM coefficients
            n = 4 << size_id
            coef_n = min(64, n * n)
            side = 4 if size_id == 0 else 8
            sub = n // side
            prev = 8              # nextCoef init (spec 7.3.4)
            if size_id > 1:
                dc = int(mat[0, 0])
                w.write_se(dc - 8)  # scaling_list_dc_coef_minus8
                prev = dc
            # delta-coded list in diagonal order over the downsampled grid
            for (y, x) in _diag_scan(side)[:coef_n]:
                if size_id > 1 and y == 0 and x == 0:
                    # matrix position (0,0) holds the DC override; the
                    # underlying list[0] survives at the un-overridden
                    # neighbor of the same upsampled block
                    v = int(mat[0, 1])
                else:
                    v = int(mat[y * sub, x * sub])
                delta = (v - prev + 256) % 256
                if delta > 127:
                    delta -= 256
                w.write_se(delta)
                prev = v


def parse_scaling_list_data(r) -> dict:
    """Parse scaling_list_data() -> {(size_id, matrix_id): [n, n] matrix}
    with default-list references resolved (spec 7.4.5)."""
    out: dict = {}
    for size_id in range(4):
        n_mat = 2 if size_id == 3 else 6
        for matrix_id in range(n_mat):
            n = 4 << size_id
            is_inter = (matrix_id >= 3 if size_id < 3 else matrix_id >= 1)
            if not r.read_flag():       # pred from reference matrix
                delta = r.read_ue()
                if delta == 0:
                    out[(size_id, matrix_id)] = default_matrix(
                        min(n, 32), is_inter)
                else:
                    ref = matrix_id - delta * (3 if size_id == 3 else 1)
                    out[(size_id, matrix_id)] = out[(size_id, ref)].copy()
                continue
            side = 4 if size_id == 0 else 8
            sub = n // side
            coef_n = min(64, n * n)
            dc = 16
            if size_id > 1:
                dc = r.read_se() + 8
            small = np.zeros((side, side), dtype=np.int32)
            prev = dc if size_id > 1 else 8
            for (y, x) in _diag_scan(side)[:coef_n]:
                prev = (prev + r.read_se() + 256) % 256
                small[y, x] = prev
            m = np.repeat(np.repeat(small, sub, axis=0), sub, axis=1)
            if size_id > 1:
                m[0, 0] = dc
            out[(size_id, matrix_id)] = m
    return out
