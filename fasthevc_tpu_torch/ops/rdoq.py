"""The device-parallel RDOQ trellis: tables and the plain form.

Counterpart of fasthevc_tpu/ops/rdoq.py (the closed-form re-derivation of
HM's sequential trellis; its module docstring describes the algorithm).
On the card the trellis runs inside kernel K5 (csrc/commit.cu);
`rdoq_scan_plain` is its PyTorch twin, and `build_rdoq_tables` builds the
rate tables both read, once per dispatch.

Every f32 result must carry the reference's bits, so the float arithmetic
is written in the order XLA evaluates it on the CPU:
  * each product, sum and quotient is one rounded f32 operation, as torch
    evaluates an elementwise op (no fused multiply-add);
  * the 16-wide coding-group sums (rdoq.py:369-370) run left to right;
  * the cumulative sum of rdoq.py:390 is XLA's blocked scan
    (`blocked_cumsum`), not a sequential one;
  * the last-position table's contraction over the 18 contexts
    (rdoq.py:167-171) accumulates sequentially;
  * argmin and argmax keep the first index on ties (torch's and jnp's
    both do).
Explicit adds, not `torch.sum`/`torch.cumsum`, so the twin gives the same
bits on every device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..spec.residual import (SCAN_VER, _last_prefix_suffix, get_scan,
                             last_ctx_params, sig_ctx_inc)
from ..spec.tables import CTX_INIT, FRAC_BITS, QUANT_SCALES

F32 = torch.float32
LUMA_LGS = (3, 4, 5)
CHROMA_LGS = (2, 3, 4)

# The quantiser step 2^qbits of the trellis' distortion (rdoq.py:337) is
# jnp.exp2, which JAX lowers to exp(ln2 * x) and XLA's CPU backend
# evaluates inexactly at odd exponents.  These are its f32 values for the
# qbits of 8- and 10-bit video, so that the twin and K5 reproduce the
# reference's costs; tests/test_torch_rdoq.py holds them against jnp.exp2.
XLA_EXP2 = {12: 4096.0, 13: 8192.00390625, 14: 16384.0, 15: 32767.984375,
            16: 65536.0, 17: 131072.0625, 18: 262144.0, 19: 524287.78125,
            20: 1048576.0, 21: 2097153.0, 22: 4194304.0, 23: 8388604.5,
            24: 16777216.0, 25: 33554448.0, 26: 67108928.0,
            27: 134217672.0, 28: 268435456.0, 29: 536871168.0,
            30: 1073740864.0}


def _n_scans(lg: int, c_idx: int) -> int:
    return 3 if (lg == 2 or (lg == 3 and c_idx == 0)) else 1


@lru_cache(maxsize=None)
def _static_tabs(lg: int, c_idx: int):
    """Scan-order static tables: sig ctx indices [S,2,2,nn], last-prefix
    bin-count matrices W1/W0 [S,nn,18] + bypass counts [S,nn], CG spatial
    neighbor matrices R/B [S,g,g] (right/below csbf routing).  Copied from
    fasthevc_tpu/ops/rdoq.py:65 (numpy only)."""
    n = 1 << lg
    nn = n * n
    g = max(1, nn // 16)
    S = _n_scans(lg, c_idx)
    sig_idx = np.zeros((S, 2, 2, nn), np.int32)
    w1 = np.zeros((S, nn, 18), np.float32)
    w0 = np.zeros((S, nn, 18), np.float32)
    byp = np.zeros((S, nn), np.float32)
    rmat = np.zeros((S, g, g), np.float32)
    bmat = np.zeros((S, g, g), np.float32)
    g_max = (lg << 1) - 1
    offset, shift = last_ctx_params(lg, c_idx)
    for s in range(S):
        scan = get_scan(lg, s)
        cg_of = {}
        for p in range(nn):
            x, y = int(scan[p, 0]), int(scan[p, 1])
            for r in (0, 1):
                for b in (0, 1):
                    sig_idx[s, r, b, p] = sig_ctx_inc(lg, c_idx, x, y, s,
                                                      r, b)
            # last-position prefix cost of last == p (ver scan swaps x/y)
            lx, ly = (y, x) if s == SCAN_VER else (x, y)
            for pos in (lx, ly):
                pfx, _sfx, slen = _last_prefix_suffix(pos)
                for i in range(pfx):
                    w1[s, p, offset + (i >> shift)] += 1.0
                if pfx < g_max:
                    w0[s, p, offset + (pfx >> shift)] += 1.0
                if pfx > 3:
                    byp[s, p] += slen
            if lg > 2:
                cg_of[(x >> 2, y >> 2)] = p >> 4
        if lg > 2:
            for (sx, sy), ci in cg_of.items():
                if (sx + 1, sy) in cg_of:
                    rmat[s, ci, cg_of[(sx + 1, sy)]] = 1.0
                if (sx, sy + 1) in cg_of:
                    bmat[s, ci, cg_of[(sx, sy + 1)]] = 1.0
    return sig_idx, w1, w0, byp, rmat, bmat


@lru_cache(maxsize=None)
def cg_neighbors(lg: int, c_idx: int) -> np.ndarray:
    """[S, 2, g] int32: the CG whose coded_sub_block_flag the trellis reads
    as each CG's "right" / "below" neighbour (-1 where none) — the index
    form of the reference's routing through _static_tabs' R/B matrices.

    With one scan (rdoq.py:301) that is the right / below CG.  With three
    scans the reference contracts the other index of the same matrices
    (rdoq.py:305-308), which routes the LEFT / ABOVE CG's flag instead;
    the port reproduces that (ROADMAP.md queue 3)."""
    *_, rmat, bmat = _static_tabs(lg, c_idx)
    out = np.full((rmat.shape[0], 2, rmat.shape[1]), -1, np.int32)
    for k, mat in enumerate((rmat, bmat)):
        s, i, j = np.nonzero(mat)
        if rmat.shape[0] == 1:
            out[s, k, i] = j
        else:
            out[s, k, j] = i
    return out


def _ctx_bit_costs(init_vals, slice_qp: int) -> torch.Tensor:
    """[K, 2] f32 bit costs (bin 0 / bin 1) of contexts at their slice-start
    states (spec 9.3.2.2 init + FRAC_BITS entropy model)."""
    iv = torch.as_tensor(np.asarray(init_vals, np.int32))
    slope = (iv >> 4) * 5 - 45
    offs = ((iv & 15) << 3) - 16
    q = min(max(int(slice_qp), 0), 51)
    pre = torch.clamp(((slope * q) >> 4) + offs, 1, 126)
    state = torch.where(pre <= 63, 63 - pre, pre - 64).long()
    mps = (pre > 63)
    fb = torch.from_numpy(np.asarray(FRAC_BITS, np.float32) / 32768.0)
    c_mps = fb[state, 0]
    c_lps = fb[state, 1]
    cost0 = torch.where(~mps, c_mps, c_lps)
    cost1 = torch.where(mps, c_mps, c_lps)
    return torch.stack([cost0, cost1], dim=-1)


def _seq_dot(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[..., K] x [K] -> [...], accumulated over k in order (f32)."""
    acc = torch.zeros(w.shape[:-1], dtype=F32)
    for k in range(w.shape[-1]):
        acc = acc + w[..., k] * c[k]
    return acc


def build_rdoq_tables(slice_qp: int, qp_y: int, qp_c: int, lam,
                      init_type: int = 0, bit_depth: int = 8,
                      device="cpu") -> dict:
    """Rate/quant tables for one dispatch, keyed (c_idx, lg), on `device`.
    Costs are pre-multiplied by lambda (`lam`, the f32 pixel-SSE lambda):
    the tables hold lambda * bits.  Built in f32 on the host, bit-equal
    to fasthevc_tpu/ops/rdoq.py build_rdoq_tables."""
    lam = torch.tensor(lam, dtype=F32)
    sig_c = _ctx_bit_costs(CTX_INIT["sig_coeff_flag"][init_type], slice_qp)
    g1_c = _ctx_bit_costs(CTX_INIT["coeff_abs_level_greater1_flag"]
                          [init_type], slice_qp)
    g2_c = _ctx_bit_costs(CTX_INIT["coeff_abs_level_greater2_flag"]
                          [init_type], slice_qp)
    csb_c = _ctx_bit_costs(CTX_INIT["coded_sub_block_flag"][init_type],
                           slice_qp)
    last_c = _ctx_bit_costs(CTX_INIT["last_sig_coeff_prefix"][init_type],
                            slice_qp)
    out = {"lam": lam.to(device)}
    for c_idx, lgs, qp in ((0, LUMA_LGS, qp_y), (1, CHROMA_LGS, qp_c)):
        qp = int(qp)
        n_sets = 4 if c_idx == 0 else 2
        base = 16 * c_idx
        g1 = lam * torch.stack([torch.stack([g1_c[base + 4 * s + c1]
                                             for c1 in range(4)])
                                for s in range(n_sets)])   # [set, c1, bin]
        g2 = lam * torch.stack([g2_c[4 * c_idx + s] for s in range(n_sets)])
        csb = lam * torch.stack([csb_c[2 * c_idx + i] for i in range(2)])
        for lg in lgs:
            sig_idx, w1, w0, byp, _r, _b = _static_tabs(lg, c_idx)
            sig = lam * sig_c[torch.from_numpy(sig_idx).long()]
            last = lam * ((_seq_dot(torch.from_numpy(w1), last_c[:, 1])
                           + _seq_dot(torch.from_numpy(w0), last_c[:, 0]))
                          + torch.from_numpy(byp))         # [S, nn]
            tshift = 15 - bit_depth - lg
            q_scale = int(QUANT_SCALES[qp % 6])
            qs = torch.tensor(q_scale, dtype=F32)
            err_scale = torch.tensor(1.0, dtype=F32) / (
                (qs * qs) * float(1 << (2 * tshift)))
            qbits = 14 + qp // 6 + tshift
            out[(c_idx, lg)] = dict(
                sig=sig.to(device), last=last.to(device),
                g1=g1.to(device), g2=g2.to(device), csb=csb.to(device),
                nbr=torch.from_numpy(cg_neighbors(lg, c_idx)).to(device),
                qbits=qbits, q_scale=q_scale, step=XLA_EXP2[qbits],
                err_scale=err_scale.to(device), lam=lam.to(device))
    return out


# ---------------------------------------------------------------------------
# The parallel trellis, plain
# ---------------------------------------------------------------------------

def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along the last axis in XLA's CPU order: a
    sequential prefix inside each block of 16, the block totals scanned by
    the same rule (recursively), and each element its block prefix plus
    the scan of the earlier blocks' totals.  Length <= 16 or a multiple
    of 16."""
    n = x.shape[-1]
    if n <= 16:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    if n % 16:
        raise ValueError("blocked_cumsum: length must be a multiple of 16")
    inner = blocked_cumsum(x.reshape(x.shape[:-1] + (n // 16, 16)))
    tot = blocked_cumsum(inner[..., -1])
    excl = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]], -1)
    return (inner + excl[..., None]).reshape(x.shape)


def _seq_sum16(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _rev_excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Per-CG sum over the positions coded before each slot (higher scan
    index), integer."""
    return torch.flip(torch.cumsum(torch.flip(x, [-1]), -1), [-1]) - x


def _floor_log2(v: torch.Tensor) -> torch.Tensor:
    """floor(log2 v) of int64 v >= 1 (31 - clz): the exponent of v in
    float64, exact below 2^53."""
    return torch.frexp(v.to(torch.float64)).exponent.to(torch.int64) - 1


def _rem_bits(v: torch.Tensor, rice: torch.Tensor) -> torch.Tensor:
    """coeff_abs_level_remaining bit count (9.3.3.9), f32."""
    v = v.clamp_min(0)
    thresh = 3 << rice
    small = ((v >> rice) + 1 + rice).to(F32)
    u = (v - thresh).clamp_min(0)
    k = _floor_log2((u >> rice) + 1)
    large = (4 + 2 * k + rice).to(F32)
    return torch.where(v < thresh, small, large)


def _last_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the last True along the last axis, -1 where none."""
    pos = torch.arange(mask.shape[-1], device=mask.device)
    return torch.where(mask, pos, -1).max(dim=-1).values


def rdoq_scan_plain(c_s: torch.Tensor, scan_sel: torch.Tensor, tabs: dict,
                    lg: int, c_idx: int) -> torch.Tensor:
    """The parallel trellis on scan-ordered coefficients c_s [A, nn]
    (signed); scan_sel [A] in {0 diag, 1 hor, 2 ver} picks each block's
    tables (ignored when the size has one scan); tabs =
    build_rdoq_tables()[(c_idx, lg)].  Returns signed levels [A, nn] in
    scan order (int64).  Twin of fasthevc_tpu/ops/rdoq.py rdoq_scan."""
    c_s = c_s.to(torch.int64)
    a_n, nn = c_s.shape
    dev = c_s.device
    g = max(1, nn // 16)
    cg = min(16, nn)
    lam = tabs["lam"]
    n_scans = tabs["sig"].shape[0]
    sel = (scan_sel.long() if n_scans > 1
           else torch.zeros(a_n, dtype=torch.long, device=dev))

    sgn = torch.sign(c_s)
    a = c_s.abs()
    ld = a * tabs["q_scale"]                       # < 2^31
    qbits = tabs["qbits"]
    m = ((ld + (1 << (qbits - 1))) >> qbits).clamp_max(32767)
    ldf = ld.to(F32)
    d0 = ldf * ldf * tabs["err_scale"]

    # --- closed-form context schedule from the provisional map ----------
    mg = m.reshape(a_n, g, cg)
    nz = (mg > 0).long()
    gt1 = (mg > 1).long()
    k = _rev_excl_cumsum(nz)
    c1 = torch.where(_rev_excl_cumsum(gt1) > 0, 0,
                     torch.clamp_max(1 + _rev_excl_cumsum((mg == 1).long()),
                                     3))
    gt2_open = _rev_excl_cumsum(gt1 * (k < 8)) == 0
    rc_max = torch.flip(torch.cummax(torch.flip(mg, [-1]), -1).values, [-1])
    mprev = torch.cat([rc_max[..., 1:], torch.zeros_like(rc_max[..., :1])],
                      -1)
    rice = (_floor_log2(mprev.clamp_min(1)) - 1).clamp(0, 4)

    has_gt1 = (gt1 > 0).any(-1).long()            # [A, g]
    prev_gt1 = torch.cat([has_gt1[:, 1:], torch.zeros_like(has_gt1[:, :1])],
                         1)
    n_sets = 4 if c_idx == 0 else 2
    if c_idx == 0 and g > 1:
        cs = 2 * (torch.arange(g, device=dev) > 0).long()[None, :] + prev_gt1
    else:
        cs = prev_gt1
    cs = cs.clamp(0, n_sets - 1)
    g2_0 = tabs["g2"][cs, 0]                       # [A, g]
    g2_1 = tabs["g2"][cs, 1]
    g1_0 = tabs["g1"][cs[..., None], c1, 0]        # [A, g, 16]
    g1_1 = tabs["g1"][cs[..., None], c1, 1]

    # --- sig-flag costs per position -------------------------------------
    csbf_prov = (nz > 0).any(-1)                   # [A, g]
    nbr = tabs["nbr"][sel]                         # [A, 2, g]

    def neighbor(j):
        idx = nbr[:, j].long()
        got = torch.take_along_dim(csbf_prov, idx.clamp_min(0), dim=1)
        return (got & (idx >= 0)).to(F32)

    right, below = neighbor(0), neighbor(1)        # [A, g] 0/1
    r_b = right.repeat_interleave(cg, 1)
    b_b = below.repeat_interleave(cg, 1)
    sig = tabs["sig"][sel]                         # [A, 2, 2, nn, 2]

    # bilinear over (r, b), both bins at once: [A, nn, 2]
    t00, t01, t10, t11 = sig[:, 0, 0], sig[:, 0, 1], sig[:, 1, 0], sig[:, 1, 1]
    r_2, b_2 = r_b[..., None], b_b[..., None]
    s01 = (t00 + r_2 * (t10 - t00) + b_2 * (t01 - t00)
           + r_2 * b_2 * (t11 - t10 - t01 + t00))
    s0, s1 = s01[..., 0], s01[..., 1]

    # --- per-coefficient level choice ------------------------------------
    kf = k.reshape(a_n, nn)
    g1_0f = g1_0.reshape(a_n, nn)
    g1_1f = g1_1.reshape(a_n, nn)
    g2_0f = g2_0.repeat_interleave(cg, 1)
    g2_1f = g2_1.repeat_interleave(cg, 1)
    gt2f = gt2_open.reshape(a_n, nn)
    ricef = rice.reshape(a_n, nn)
    step = tabs["step"]

    def level_cost(lv):
        e = ldf - lv.to(F32) * step
        d = e * e * tabs["err_scale"]
        rem2 = lam * _rem_bits(lv - 2, ricef)
        rem3 = lam * _rem_bits(lv - 3, ricef)
        rem1 = lam * _rem_bits(lv - 1, ricef)
        r_gt1 = g1_1f + torch.where(
            gt2f, torch.where(lv > 2, g2_1f + rem3, g2_0f), rem2)
        r_ctx = torch.where(lv > 1, r_gt1, g1_0f)
        r = lam + torch.where(kf < 8, r_ctx, rem1)  # lam = sign bypass bit
        return d + s1 + r

    inf = torch.full((), float("inf"), dtype=F32, device=dev)
    cost0 = d0 + s0
    m1 = (m - 1).clamp_min(1)
    # both candidate levels in one pass (the costs are elementwise)
    cost_both = level_cost(torch.stack([m.clamp_min(1), m1]))
    cost_m = torch.where(m > 0, cost_both[0], inf)
    cost_m1 = torch.where(m > 1, cost_both[1], inf)
    lvl = torch.where((cost_m <= cost0) & (cost_m <= cost_m1), m,
                      torch.where(cost_m1 <= cost0, m1, 0))
    cost_lv = torch.minimum(cost0, torch.minimum(cost_m, cost_m1))

    pos = torch.arange(nn, device=dev)[None, :]
    last_init = _last_true(m > 0)
    valid = pos <= last_init[:, None]
    zero = torch.zeros((), dtype=F32, device=dev)
    lvl = torch.where(valid, lvl, 0)
    cost_lv = torch.where(valid, cost_lv, zero)
    cost_z = torch.where(valid, d0, zero)

    # --- coding-group zeroing (not DC, not the provisional last CG) ------
    if g > 1:
        keep_g, zero_g = _seq_sum16(torch.stack([cost_lv, cost_z])
                                    .reshape(2, a_n, g, cg))
        cinc = torch.clamp_max(right + below, 1.0)
        csb = tabs["csb"]                          # [2, 2]
        b0 = (1 - cinc) * csb[0, 0] + cinc * csb[1, 0]
        b1 = (1 - cinc) * csb[0, 1] + cinc * csb[1, 1]
        gi = torch.arange(g, device=dev)[None, :]
        last_cg = last_init[:, None] >> 4
        zeroable = (gi > 0) & (gi < last_cg)
        kill = zeroable & (zero_g + b0 < keep_g + b1)
        killf = kill.repeat_interleave(cg, 1)
        lvl = torch.where(killf, 0, lvl)
        cost_lv = torch.where(killf, cost_z, cost_lv)

    # --- last-position optimization (suffix-sum + argmin) ----------------
    nzl = lvl > 0
    old_last = _last_true(nzl)
    in_range = pos <= old_last[:, None]
    diff = torch.where(in_range, cost_z - cost_lv, zero)
    incl = blocked_cumsum(diff)
    suff = incl[:, -1:] - incl                     # sum over q > p
    total = suff + tabs["last"][sel] - s1
    total = torch.where(nzl, total, inf)
    new_last = torch.argmin(total, dim=-1)        # first index on ties
    lvl = torch.where(pos <= new_last[:, None], lvl, 0)
    lvl = torch.where((old_last >= 0)[:, None], lvl, 0)
    return lvl * sgn


def rdoq_device(coeffs: torch.Tensor, scan_sel: torch.Tensor, tabs: dict,
                lg: int, c_idx: int) -> torch.Tensor:
    """RDO-quantise raster blocks [A, n, n] (thin wrapper over
    rdoq_scan_plain): raster -> scan, trellis, scan -> raster."""
    from .commit import scan_permute
    n = 1 << lg
    a_n = coeffs.shape[0]
    c_s = scan_permute(coeffs.reshape(a_n, n * n), lg, scan_sel)
    lv = rdoq_scan_plain(c_s, scan_sel, tabs, lg, c_idx)
    return scan_permute(lv, lg, scan_sel, inverse=True).reshape(a_n, n, n)
