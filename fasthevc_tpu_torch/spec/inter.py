"""Inter prediction support: two-list MV field, merge and AMVP derivation.

Reference parity: HM TComDataCU motion field + TEncSearch AMVP/merge
(SURVEY.md E7, C1) — reimplemented from spec 8.5.3.2. Scope: P and B
slices, 2Nx2N PUs (PU == CU), up to 2 active references per list,
temporal MVP (merge + AMVP) with POC-distance MV scaling, combined
bi-predictive merge candidates, max 5 merge candidates.

Motion is carried as (inter_dir, mv_l0, ref_l0, mv_l1, ref_l1) with
inter_dir 1 = L0, 2 = L1, 3 = BI (spec PredFlagLX).

Candidate derivation needs slice-level reference context (POC of every
active ref, and the collocated picture's motion for TMVP); that travels
as a MotionCtx attached to the per-picture FrameMaps (maps.mctx) by both
encoder and decoder, so the two derive identical lists.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX_MERGE_CAND = 5
DIR_L0, DIR_L1, DIR_BI = 1, 2, 3


@dataclass(frozen=True)
class Motion:
    """Motion of one PU: per-list MV + ref idx (-1 = list unused)."""
    inter_dir: int = DIR_L0
    mv0: tuple = (0, 0)
    ref0: int = -1
    mv1: tuple = (0, 0)
    ref1: int = -1


class RefPic:
    """A decoded picture in the DPB: pixel planes + per-granule motion
    (for TMVP) + its own active-list POCs (to resolve a col PU's ref
    POC).  Exposes .y/.cb/.cr so motion compensation treats it exactly
    like bare Planes."""

    def __init__(self, planes, poc: int, motion=None,
                 l0_pocs: tuple = (), l1_pocs: tuple = ()) -> None:
        self.planes = planes
        self.poc = poc
        self.motion = motion
        self.l0_pocs = l0_pocs
        self.l1_pocs = l1_pocs

    @property
    def y(self):
        return self.planes.y

    @property
    def cb(self):
        return self.planes.cb

    @property
    def cr(self):
        return self.planes.cr


@dataclass
class MotionCtx:
    """Per-slice reference context for merge/AMVP derivation.

    col_dir/col_mv/col_refpoc are per-8x8-granule arrays of the
    COLLOCATED picture's motion ([gh, gw], [gh, gw, 4], [gh, gw, 2]):
    direction (0 = intra/none), quarter-pel MVs per list, and the POC of
    the picture each list references — precomputed once per slice (see
    col_arrays) so TMVP needs no per-PU indirection through the col
    picture's ref lists.  This same canonical form feeds the native C++
    engine and the device search."""
    cur_poc: int = 0
    l0_pocs: tuple = (0,)
    l1_pocs: tuple = (0,)
    tmvp: bool = False
    col_from_l0: bool = True
    col_poc: int = 0
    col_dir: object = None
    col_mv: object = None
    col_refpoc: object = None
    log2_ctu: int = 5
    # explicit weighted prediction tables (spec.wp.WpTables) — per-slice,
    # applied by every mc_cu_motion call site through maps.mctx (E13)
    wp: object = None

    @property
    def no_backward(self) -> bool:
        """NoBackwardPredFlag: every active ref precedes the current
        picture in output order."""
        return (all(p <= self.cur_poc for p in self.l0_pocs)
                and all(p <= self.cur_poc for p in self.l1_pocs))


def col_arrays(col: "RefPic", coded_w: int, coded_h: int):
    """Canonical per-8x8-granule (dir, mv, refpoc) arrays of a collocated
    picture, from its 4x4-granule MotionField (motion is constant within
    the 8x8 min CU, so sampling every other granule is exact)."""
    mf = col.motion
    gh, gw = coded_h >> 3, coded_w >> 3
    inter = mf.inter[::2, ::2][:gh, :gw]
    ref_idx = mf.ref_idx[::2, ::2][:gh, :gw]         # [gh, gw, 2]
    mv = mf.mv[::2, ::2][:gh, :gw]                   # [gh, gw, 2, 2]
    d = (np.where(ref_idx[..., 0] >= 0, 1, 0)
         | np.where(ref_idx[..., 1] >= 0, 2, 0))
    d = np.where(inter, d, 0).astype(np.int8)
    col_mv = mv.reshape(gh, gw, 4).astype(np.int16)
    refpoc = np.zeros((gh, gw, 2), np.int32)
    for li, pocs in ((0, col.l0_pocs), (1, col.l1_pocs)):
        r = np.clip(ref_idx[..., li], 0, max(len(pocs) - 1, 0))
        lut = np.asarray(list(pocs) + [0], np.int32)
        refpoc[..., li] = lut[r]
    return d, col_mv, refpoc


def build_mctx(sp, poc: int, slice_type: int, refs_l0, refs_l1):
    """MotionCtx for one slice from RefPic lists (shared by the spec and
    TPU encoders so every tier derives identical candidate lists).
    Returns None for I slices; TMVP engages only when the collocated
    RefPic carries a motion field."""
    if slice_type == 2 or not refs_l0:
        return None
    is_b = slice_type == 0
    l0p = tuple(getattr(r, "poc", 0) for r in refs_l0)
    l1p = tuple(getattr(r, "poc", 0) for r in refs_l1)
    col_from_l0 = not is_b  # HM default: B collocates from L1
    mctx = MotionCtx(cur_poc=poc, l0_pocs=l0p, l1_pocs=l1p, tmvp=False,
                     col_from_l0=col_from_l0, log2_ctu=sp.log2_ctu)
    if sp.temporal_mvp_enabled:
        col_list = refs_l0 if col_from_l0 else refs_l1
        col = col_list[0] if col_list else None
        if col is not None and getattr(col, "motion", None) is not None:
            mctx.tmvp = True
            mctx.col_poc = getattr(col, "poc", 0)
            (mctx.col_dir, mctx.col_mv,
             mctx.col_refpoc) = col_arrays(col, sp.coded_width,
                                           sp.coded_height)
    return mctx


def mv_scale(mv: tuple, tb: int, td: int) -> tuple:
    """POC-distance MV scaling (spec 8.5.3.2.8 / 8.5.3.1.6).

    tb = cur_poc - target_ref_poc, td = neighbor/col distance; both are
    clipped to [-128, 127]; tx uses C-style truncating division."""
    td = max(-128, min(127, td))
    tb = max(-128, min(127, tb))
    q = 16384 + (abs(td) >> 1)
    tx = q // td if td > 0 else -(q // -td)
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))

    def s(c):
        v = dsf * c
        m = (abs(v) + 127) >> 8
        return max(-32768, min(32767, -m if v < 0 else m))

    return (s(mv[0]), s(mv[1]))


def _col_sample(mctx: MotionCtx, xc: int, yc: int):
    """Collocated motion at 16x16-aligned (xc, yc) (spec motion-data
    compression sampling): (dir, mv4, refpoc2) or None if intra."""
    gx, gy = ((xc >> 4) << 4) >> 3, ((yc >> 4) << 4) >> 3
    if (mctx.col_dir is None or gy >= mctx.col_dir.shape[0]
            or gx >= mctx.col_dir.shape[1]):
        return None
    d = int(mctx.col_dir[gy, gx])
    if d == 0:
        return None
    return (d, mctx.col_mv[gy, gx], mctx.col_refpoc[gy, gx])


def _derive_col_mv(mctx: MotionCtx, sample, x_list: int,
                   target_refpoc: int):
    """Collocated MV for target list X (spec 8.5.3.2.8): pick the col
    block's list, then scale by POC distances."""
    d, mv4, refpoc2 = sample
    if not (d & DIR_L0):
        list_col = 1
    elif not (d & DIR_L1):
        list_col = 0
    elif mctx.no_backward:
        list_col = x_list
    else:
        list_col = 1 if mctx.col_from_l0 else 0
    mv = (int(mv4[2 * list_col]), int(mv4[2 * list_col + 1]))
    col_refpoc = int(refpoc2[list_col])
    td = mctx.col_poc - col_refpoc
    tb = mctx.cur_poc - target_refpoc
    if td == tb:
        return mv
    return mv_scale(mv, tb, td)


def temporal_candidate(mctx: MotionCtx, x: int, y: int, size: int,
                       x_list: int, ref_idx: int, coded_w: int,
                       coded_h: int):
    """TMVP for (list X, ref_idx) (spec 8.5.3.2.7): bottom-right C0 when
    inside the picture and the same CTU row, else center C1."""
    if mctx is None or not mctx.tmvp or mctx.col_dir is None:
        return None
    pocs = mctx.l0_pocs if x_list == 0 else mctx.l1_pocs
    if ref_idx >= len(pocs):
        return None
    target_refpoc = pocs[ref_idx]
    ctb = 1 << mctx.log2_ctu
    xbr, ybr = x + size, y + size
    if (y // ctb == ybr // ctb) and ybr < coded_h and xbr < coded_w:
        s = _col_sample(mctx, xbr, ybr)
        if s is not None:
            return _derive_col_mv(mctx, s, x_list, target_refpoc)
    s = _col_sample(mctx, x + size // 2, y + size // 2)
    if s is not None:
        return _derive_col_mv(mctx, s, x_list, target_refpoc)
    return None


class MotionField:
    """Per-4x4-granule motion state for one picture (two lists)."""

    def __init__(self, coded_w: int, coded_h: int) -> None:
        gw, gh = coded_w >> 2, coded_h >> 2
        self.inter = np.zeros((gh, gw), dtype=bool)
        self.mv = np.zeros((gh, gw, 2, 2), dtype=np.int32)  # [list][x,y]
        self.ref_idx = np.full((gh, gw, 2), -1, dtype=np.int32)
        self.cbf_y = np.zeros((gh, gw), dtype=bool)

    def set_cu(self, x: int, y: int, size: int, motion: "Motion",
               cbf_y: bool) -> None:
        g = slice(y >> 2, (y + size) >> 2), slice(x >> 2, (x + size) >> 2)
        self.inter[g] = True
        self.mv[g] = 0
        self.ref_idx[g] = -1
        if motion.inter_dir & DIR_L0:
            self.mv[g[0], g[1], 0] = motion.mv0
            self.ref_idx[g[0], g[1], 0] = motion.ref0
        if motion.inter_dir & DIR_L1:
            self.mv[g[0], g[1], 1] = motion.mv1
            self.ref_idx[g[0], g[1], 1] = motion.ref1
        self.cbf_y[g] = cbf_y

    def set_intra_cu(self, x: int, y: int, size: int, cbf_y: bool) -> None:
        g = slice(y >> 2, (y + size) >> 2), slice(x >> 2, (x + size) >> 2)
        self.inter[g] = False
        self.ref_idx[g] = -1
        self.cbf_y[g] = cbf_y


def _motion_at(maps, mf: MotionField, xn: int, yn: int, x: int,
               y: int) -> Motion | None:
    """Motion of the PU covering (xn, yn) if available+inter, else None.
    Availability follows z-scan decode order relative to (x, y)."""
    from .intra import sample_available

    sp = maps.sp
    if not sample_available(xn, yn, x, y, sp.coded_width, sp.coded_height,
                            sp.log2_ctu, getattr(maps, "tile_rect", None)):
        return None
    gy, gx = yn >> 2, xn >> 2
    if not mf.inter[gy, gx]:
        return None
    r0 = int(mf.ref_idx[gy, gx, 0])
    r1 = int(mf.ref_idx[gy, gx, 1])
    d = (1 if r0 >= 0 else 0) | (2 if r1 >= 0 else 0)
    return Motion(d, (int(mf.mv[gy, gx, 0, 0]), int(mf.mv[gy, gx, 0, 1])),
                  r0, (int(mf.mv[gy, gx, 1, 0]), int(mf.mv[gy, gx, 1, 1])),
                  r1)


def _default_mctx(maps) -> MotionCtx:
    m = getattr(maps, "mctx", None)
    return m if m is not None else MotionCtx()


def merge_candidates(maps, mf: MotionField, x: int, y: int, size: int,
                     is_b: bool = False, mctx: MotionCtx | None = None
                     ) -> list:
    """Merge candidate list (spec 8.5.3.2.3): spatial + temporal +
    combined-bi (B) + zero candidates with ref cycling.

    Returns a list of Motion, length MAX_MERGE_CAND.
    """
    if mctx is None:
        mctx = _default_mctx(maps)
    a1 = _motion_at(maps, mf, x - 1, y + size - 1, x, y)
    b1 = _motion_at(maps, mf, x + size - 1, y - 1, x, y)
    b0 = _motion_at(maps, mf, x + size, y - 1, x, y)
    a0 = _motion_at(maps, mf, x - 1, y + size, x, y)
    b2 = _motion_at(maps, mf, x - 1, y - 1, x, y)

    cands: list[Motion] = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and b1 != a1:
        cands.append(b1)
    if b0 is not None and b0 != b1:
        cands.append(b0)
    if a0 is not None and a0 != a1:
        cands.append(a0)
    n_spatial4 = sum(c is not None for c in (a0, a1, b0, b1))
    if (len(cands) < 4 and n_spatial4 < 4 and b2 is not None
            and b2 != a1 and b2 != b1):
        cands.append(b2)

    # temporal candidate, refIdx 0 per list (spec 8.5.3.2.3 step 4)
    if mctx.tmvp and len(cands) < MAX_MERGE_CAND:
        sp = maps.sp
        mv0 = temporal_candidate(mctx, x, y, size, 0, 0, sp.coded_width,
                                 sp.coded_height)
        mv1 = (temporal_candidate(mctx, x, y, size, 1, 0, sp.coded_width,
                                  sp.coded_height) if is_b else None)
        if mv0 is not None or mv1 is not None:
            d = (DIR_L0 if mv0 is not None else 0) | \
                (DIR_L1 if mv1 is not None else 0)
            cands.append(Motion(d, mv0 or (0, 0), 0 if mv0 else -1,
                                mv1 or (0, 0), 0 if mv1 else -1))

    # combined bi-predictive candidates (spec 8.5.3.2.4, B slices)
    n_orig = len(cands)
    if is_b and n_orig > 1 and len(cands) < MAX_MERGE_CAND:
        L0C = (0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3)
        L1C = (1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2)
        for k in range(min(n_orig * (n_orig - 1), 12)):
            c0, c1 = cands[L0C[k]], cands[L1C[k]]
            if not ((c0.inter_dir & DIR_L0) and (c1.inter_dir & DIR_L1)):
                continue
            p0 = mctx.l0_pocs[c0.ref0] if c0.ref0 < len(mctx.l0_pocs) \
                else 0
            p1 = mctx.l1_pocs[c1.ref1] if c1.ref1 < len(mctx.l1_pocs) \
                else 0
            if p0 != p1 or c0.mv0 != c1.mv1:
                cands.append(Motion(DIR_BI, c0.mv0, c0.ref0, c1.mv1,
                                    c1.ref1))
                if len(cands) == MAX_MERGE_CAND:
                    break

    # zero candidates with reference cycling (spec 8.5.3.2.5)
    n_ref = (min(len(mctx.l0_pocs), len(mctx.l1_pocs)) if is_b
             else len(mctx.l0_pocs)) or 1
    zero_idx = 0
    while len(cands) < MAX_MERGE_CAND:
        r = zero_idx if zero_idx < n_ref else 0
        cands.append(Motion(DIR_BI, (0, 0), r, (0, 0), r) if is_b
                     else Motion(DIR_L0, (0, 0), r))
        zero_idx += 1
    return cands[:MAX_MERGE_CAND]


def amvp_candidates(maps, mf: MotionField, x: int, y: int, size: int,
                    list_idx: int = 0, ref_idx: int = 0,
                    mctx: MotionCtx | None = None) -> list:
    """AMVP predictor list for (list, ref_idx) (spec 8.5.3.2.6/.7):
    spatial A (A0/A1: same-POC pass then scaled pass) and B (B0/B1/B2:
    same-POC pass; scaled pass only when no left neighbor exists),
    dedup, temporal candidate, zero fill."""
    if mctx is None:
        mctx = _default_mctx(maps)
    pocs = mctx.l0_pocs if list_idx == 0 else mctx.l1_pocs
    target_poc = pocs[ref_idx] if ref_idx < len(pocs) else 0

    def ref_poc_of(m: Motion, li: int) -> int:
        lp = mctx.l0_pocs if li == 0 else mctx.l1_pocs
        r = m.ref0 if li == 0 else m.ref1
        return lp[r] if 0 <= r < len(lp) else 0

    def mv_same_poc(m: Motion | None):
        if m is None:
            return None
        for li in (list_idx, 1 - list_idx):
            if m.inter_dir & (1 << li):
                if ref_poc_of(m, li) == target_poc:
                    return m.mv0 if li == 0 else m.mv1
        return None

    def mv_scaled(m: Motion | None):
        if m is None:
            return None
        for li in (list_idx, 1 - list_idx):
            if m.inter_dir & (1 << li):
                mv = m.mv0 if li == 0 else m.mv1
                npoc = ref_poc_of(m, li)
                td = mctx.cur_poc - npoc
                tb = mctx.cur_poc - target_poc
                if td == tb:
                    return mv
                return mv_scale(mv, tb, td)
        return None

    a0 = _motion_at(maps, mf, x - 1, y + size, x, y)
    a1 = _motion_at(maps, mf, x - 1, y + size - 1, x, y)
    b0 = _motion_at(maps, mf, x + size, y - 1, x, y)
    b1 = _motion_at(maps, mf, x + size - 1, y - 1, x, y)
    b2 = _motion_at(maps, mf, x - 1, y - 1, x, y)

    is_scaled = a0 is not None or a1 is not None
    cand_a = next((mv_same_poc(c) for c in (a0, a1)
                   if mv_same_poc(c) is not None), None)
    if cand_a is None:
        cand_a = next((mv_scaled(c) for c in (a0, a1)
                       if mv_scaled(c) is not None), None)
    cand_b = next((mv_same_poc(c) for c in (b0, b1, b2)
                   if mv_same_poc(c) is not None), None)
    if cand_b is None and not is_scaled:
        cand_b = next((mv_scaled(c) for c in (b0, b1, b2)
                       if mv_scaled(c) is not None), None)

    out = []
    if cand_a is not None:
        out.append(cand_a)
    if cand_b is not None and (cand_a is None or cand_b != cand_a):
        out.append(cand_b)
    if len(out) < 2 and mctx.tmvp:
        sp = maps.sp
        tmv = temporal_candidate(mctx, x, y, size, list_idx, ref_idx,
                                 sp.coded_width, sp.coded_height)
        if tmv is not None:
            out.append(tmv)
    while len(out) < 2:
        out.append((0, 0))
    return out[:2]


# ---------------------------------------------------------------------------
# MVD syntax (7.3.8.9 / 9.3.3.8)
# ---------------------------------------------------------------------------

def encode_mvd(coder, mvd_x: int, mvd_y: int) -> None:
    gt0 = [int(mvd_x != 0), int(mvd_y != 0)]
    coder.encode_bin("mvd_flag", 0, gt0[0])
    coder.encode_bin("mvd_flag", 0, gt0[1])
    gt1 = [int(abs(mvd_x) > 1), int(abs(mvd_y) > 1)]
    if gt0[0]:
        coder.encode_bin("mvd_flag", 1, gt1[0])
    if gt0[1]:
        coder.encode_bin("mvd_flag", 1, gt1[1])
    for v, g0, g1 in ((mvd_x, gt0[0], gt1[0]), (mvd_y, gt0[1], gt1[1])):
        if g0:
            if g1:
                _write_eg1(coder, abs(v) - 2)
            coder.encode_bypass(1 if v < 0 else 0)


def decode_mvd(dec) -> tuple[int, int]:
    g0x = dec.decode_bin("mvd_flag", 0)
    g0y = dec.decode_bin("mvd_flag", 0)
    g1x = dec.decode_bin("mvd_flag", 1) if g0x else 0
    g1y = dec.decode_bin("mvd_flag", 1) if g0y else 0
    out = []
    for g0, g1 in ((g0x, g1x), (g0y, g1y)):
        if not g0:
            out.append(0)
            continue
        v = 2 + _read_eg1(dec) if g1 else 1
        if dec.decode_bypass():
            v = -v
        out.append(v)
    return out[0], out[1]


def encode_ref_idx(coder, idx: int, num_active: int) -> None:
    """ref_idx_lX (spec 9.3.3.x): TR cMax = num_active-1; bins 0/1 are
    context-coded ("ref_idx" 0/1), the rest bypass."""
    if num_active <= 1:
        return
    cmax = num_active - 1
    for k in range(idx):
        if k < 2:
            coder.encode_bin("ref_idx", k, 1)
        else:
            coder.encode_bypass(1)
    if idx < cmax:
        if idx < 2:
            coder.encode_bin("ref_idx", idx, 0)
        else:
            coder.encode_bypass(0)


def decode_ref_idx(dec, num_active: int) -> int:
    if num_active <= 1:
        return 0
    cmax = num_active - 1
    idx = 0
    while idx < cmax:
        b = (dec.decode_bin("ref_idx", idx) if idx < 2
             else dec.decode_bypass())
        if not b:
            break
        idx += 1
    return idx


def encode_inter_pred_idc(coder, inter_dir: int, depth: int) -> None:
    """inter_pred_idc for 2Nx2N B PUs (spec 9.3.3.7): bin0 ctx = CtDepth
    (1 = BI); if not BI: bin1 ctx 4 (0 = L0, 1 = L1)."""
    coder.encode_bin("inter_pred_idc", depth, 1 if inter_dir == DIR_BI else 0)
    if inter_dir != DIR_BI:
        coder.encode_bin("inter_pred_idc", 4,
                         1 if inter_dir == DIR_L1 else 0)


def decode_inter_pred_idc(dec, depth: int) -> int:
    if dec.decode_bin("inter_pred_idc", depth):
        return DIR_BI
    return DIR_L1 if dec.decode_bin("inter_pred_idc", 4) else DIR_L0


def _write_eg1(coder, value: int) -> None:
    """1st-order Exp-Golomb, bypass bins (abs_mvd_minus2)."""
    k = 1
    while value >= (1 << k):
        coder.encode_bypass(1)
        value -= 1 << k
        k += 1
    coder.encode_bypass(0)
    coder.encode_bypass_bits(value, k)


def _read_eg1(dec) -> int:
    k = 1
    base = 0
    while dec.decode_bypass():
        base += 1 << k
        k += 1
        if k > 31:
            raise ValueError("corrupt mvd")
    return base + dec.decode_bypass_bits(k)
