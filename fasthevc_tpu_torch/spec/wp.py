"""Weighted prediction (SURVEY.md §2.1 E13).

Reference parity: HM WeightPredAnalysis (xCalcACDCParamSlice /
xEstimateWPParamSlice / xSelectWP) + TComWeightPrediction, reimplemented
from spec 7.3.6.3 (pred_weight_table) and 8.5.3.3.4.3 (explicit weighted
sample prediction).  Explicit WP only — the reference enables it for
fades, where uni/bi default averaging models the luminance ramp poorly.

Weight model per (list, ref, component): final = ((pred14 * w) >> log2Wd)
rounded, plus offset o, where log2Wd = log2_denom + (14 - bit_depth).
Default (w = 1 << denom, o = 0) is EXACTLY the spec's default weighted
sample process: the uni/bi rounding in spec/mc.py is the denom-folded
special case, so applying WpTables of defaults is bit-identical to not
applying them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class WpEntry:
    """Weights/offsets of one reference picture (luma + both chroma)."""
    w_y: int
    o_y: int
    w_cb: int
    o_cb: int
    w_cr: int
    o_cr: int


def default_entry(log2_denom_y: int, log2_denom_c: int) -> WpEntry:
    return WpEntry(1 << log2_denom_y, 0, 1 << log2_denom_c, 0,
                   1 << log2_denom_c, 0)


@dataclass(frozen=True)
class WpTables:
    """Per-slice explicit weight tables (spec 7.4.7.3 derived values)."""
    log2_denom_y: int = 6
    log2_denom_c: int = 6
    l0: tuple = ()   # WpEntry per active L0 reference
    l1: tuple = ()

    def luma_default(self, li: int, ri: int) -> bool:
        e = (self.l0 if li == 0 else self.l1)[ri]
        return e.w_y == (1 << self.log2_denom_y) and e.o_y == 0

    def chroma_default(self, li: int, ri: int) -> bool:
        e = (self.l0 if li == 0 else self.l1)[ri]
        d = 1 << self.log2_denom_c
        return (e.w_cb == d and e.o_cb == 0
                and e.w_cr == d and e.o_cr == 0)


def default_tables(n_l0: int, n_l1: int, log2_denom_y: int = 6,
                   log2_denom_c: int = 6) -> WpTables:
    e_y = default_entry(log2_denom_y, log2_denom_c)
    return WpTables(log2_denom_y, log2_denom_c,
                    tuple(e_y for _ in range(n_l0)),
                    tuple(e_y for _ in range(n_l1)))


# ---------------------------------------------------------------------------
# Estimation (encoder side): HM's DC/AC model + SAD selection gate
# ---------------------------------------------------------------------------

def _est_component(cur: np.ndarray, ref: np.ndarray, denom: int,
                   max_off: int):
    """HM xEstimateWPParamSlice: w ~= acCur/acRef scaled by the denom,
    o = dcCur - (w * dcRef >> denom); both clipped to the syntax range."""
    cur = cur.astype(np.int64)
    ref = ref.astype(np.int64)
    dc_c = float(cur.mean())
    dc_r = float(ref.mean())
    ac_c = float(np.abs(cur - dc_c).mean())
    ac_r = float(np.abs(ref - dc_r).mean())
    if ac_r < 1e-6:
        w = 1 << denom
    else:
        w = int(np.clip(round(ac_c / ac_r * (1 << denom)), -128, 127))
    o = int(np.clip(round(dc_c - w * dc_r / (1 << denom)),
                    -max_off, max_off - 1))
    return w, o


def _wp_useful(cur: np.ndarray, ref: np.ndarray, w: int, o: int,
               denom: int, bit_depth: int) -> bool:
    """HM xSelectWP analog: keep the weights only if the full-pel weighted
    reference beats the plain reference in SAD (strict <, so a tie keeps
    the cheaper default syntax)."""
    maxv = (1 << bit_depth) - 1
    half = 1 << (denom - 1) if denom > 0 else 0
    wref = np.clip(((ref.astype(np.int64) * w + half) >> denom) + o,
                   0, maxv)
    sad_w = int(np.abs(cur.astype(np.int64) - wref).sum())
    sad_p = int(np.abs(cur.astype(np.int64) - ref.astype(np.int64)).sum())
    return sad_w < sad_p


def estimate_wp_tables(src_planes, refs_l0, refs_l1, bit_depth: int = 8,
                       log2_denom_y: int = 6,
                       log2_denom_c: int = 6) -> WpTables:
    """Estimate per-reference explicit weights for one slice.

    src_planes: (y, cb, cr) of the current picture (coded dims).
    refs_lX: list of Planes-like refs (``.y/.cb/.cr``).  References whose
    weights do not beat the default in SAD get the default entry (their
    syntax flags stay 0)."""
    cur_y, cur_cb, cur_cr = (np.asarray(p) for p in src_planes)

    def est_ref(ref) -> WpEntry:
        w_y, o_y = _est_component(cur_y, np.asarray(ref.y),
                                  log2_denom_y, 128)
        if not _wp_useful(cur_y, np.asarray(ref.y), w_y, o_y,
                          log2_denom_y, bit_depth):
            w_y, o_y = 1 << log2_denom_y, 0
        w_cb, o_cb = _est_component(cur_cb, np.asarray(ref.cb),
                                    log2_denom_c, 128)
        w_cr, o_cr = _est_component(cur_cr, np.asarray(ref.cr),
                                    log2_denom_c, 128)
        if not (_wp_useful(cur_cb, np.asarray(ref.cb), w_cb, o_cb,
                           log2_denom_c, bit_depth)
                and _wp_useful(cur_cr, np.asarray(ref.cr), w_cr, o_cr,
                               log2_denom_c, bit_depth)):
            d = 1 << log2_denom_c
            w_cb, o_cb, w_cr, o_cr = d, 0, d, 0
        return WpEntry(w_y, o_y, w_cb, o_cb, w_cr, o_cr)

    return WpTables(log2_denom_y, log2_denom_c,
                    tuple(est_ref(r) for r in refs_l0),
                    tuple(est_ref(r) for r in refs_l1))


def is_all_default(wp: WpTables | None) -> bool:
    if wp is None:
        return True
    return all(wp.luma_default(0, i) and wp.chroma_default(0, i)
               for i in range(len(wp.l0))) and \
        all(wp.luma_default(1, i) and wp.chroma_default(1, i)
            for i in range(len(wp.l1)))


# ---------------------------------------------------------------------------
# Syntax: pred_weight_table (spec 7.3.6.3 / 7.4.7.3)
# ---------------------------------------------------------------------------

def write_pred_weight_table(w, wp: WpTables, is_b: bool) -> None:
    w.write_ue(wp.log2_denom_y)
    w.write_se(wp.log2_denom_c - wp.log2_denom_y)
    for li, entries in ((0, wp.l0),) + (((1, wp.l1),) if is_b else ()):
        for ri in range(len(entries)):
            w.write_flag(0 if wp.luma_default(li, ri) else 1)
        for ri in range(len(entries)):
            w.write_flag(0 if wp.chroma_default(li, ri) else 1)
        for ri, e in enumerate(entries):
            if not wp.luma_default(li, ri):
                w.write_se(e.w_y - (1 << wp.log2_denom_y))
                w.write_se(e.o_y)
            if not wp.chroma_default(li, ri):
                for wc, oc in ((e.w_cb, e.o_cb), (e.w_cr, e.o_cr)):
                    w.write_se(wc - (1 << wp.log2_denom_c))
                    # delta_chroma_offset (spec 7.4.7.3): o is recovered
                    # as Clip3(-128,127, delta - ((128*w)>>denom) + 128)
                    w.write_se(oc + ((128 * wc) >> wp.log2_denom_c) - 128)


def parse_pred_weight_table(r, n_l0: int, n_l1: int,
                            is_b: bool) -> WpTables:
    denom_y = r.read_ue()
    denom_c = denom_y + r.read_se()

    def parse_list(n):
        luma_f = [r.read_flag() for _ in range(n)]
        chroma_f = [r.read_flag() for _ in range(n)]
        entries = []
        for i in range(n):
            w_y, o_y = 1 << denom_y, 0
            d = 1 << denom_c
            w_cb, o_cb, w_cr, o_cr = d, 0, d, 0
            if luma_f[i]:
                w_y = (1 << denom_y) + r.read_se()
                o_y = r.read_se()
            if chroma_f[i]:
                out = []
                for _ in range(2):
                    wc = (1 << denom_c) + r.read_se()
                    delta = r.read_se()
                    oc = int(np.clip(delta - ((128 * wc) >> denom_c) + 128,
                                     -128, 127))
                    out.append((wc, oc))
                (w_cb, o_cb), (w_cr, o_cr) = out
            entries.append(WpEntry(w_y, o_y, w_cb, o_cb, w_cr, o_cr))
        return tuple(entries)

    l0 = parse_list(n_l0)
    l1 = parse_list(n_l1) if is_b else ()
    return WpTables(denom_y, denom_c, l0, l1)
