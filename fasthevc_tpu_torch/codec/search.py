"""Batched RDO search: the intra, P and B searches of
fasthevc_tpu/codec/search.py.

Intra, for every aligned block of every CU size of every frame: SATD over
the 35 intra modes (K1's fused form), MPM-aware mode bits, a true-RD pass
over the top-k shortlist, predicted again in K1's selected form, through
the exact T/Q/IQ/IT with SSE and the level-rate proxy (K3's costed form,
`tq_cost`: K3 and K4's arithmetic in one launch), the chroma DM cost (K1,
`tq_cost`), then the bottom-up
quadtree DP and the packed int16 [gh, gw, 9] decision maps of the C++
slice engine.  P frames add, per block, the best of up to two references
from integer ME (K9) and sub-pel refinement (K10), two merge candidates
priced through exact MC (K11) and SATD, and the inter RD leaf at the inter
dead-zone offset; the DP then runs over the per-block minimum.  B frames
run one ME state over both lists' references, the P candidates per list,
and the bi-prediction of the two lists' winners costed by K12; the
direction is chosen in the SATD domain before the one inter RD leaf.
With a partition CNN (the fast-partition path) every batch's packing
takes the CNN's depth maps (K13) in place of the DP's splits; the search
itself runs whole, as the reference runs it.

The f32 costs are built with the same operations, in the same order, as
the JAX search, so both take the same decisions.  `plain=True` runs the
kernels' PyTorch twins instead of the kernels (on any device).
"""

from __future__ import annotations

import torch

from ..ops import cost, intra, me, per_frame, transform
from ..ops.cnn import cnn_depth

# Bit proxies of the CU syntax (fasthevc_tpu/codec/search.py).
CU_OVERHEAD_BITS = 3.0
SPLIT_FLAG_BITS = 1.0
INTER_OVERHEAD_BITS = 2.0


def _ops(plain: bool) -> tuple:
    """The search's kernel entry points (predict, predict_satd, tq_cost):
    the wrappers, or with `plain` their twins."""
    if plain:
        return (intra.predict_plain, intra.predict_satd_plain,
                transform.tq_cost_plain)
    return (intra.predict, intra.predict_satd, transform.tq_cost)


def _blocks(planes: torch.Tensor, n: int) -> torch.Tensor:
    """[F, H, W] -> [F * H/n * W/n, n, n] in frame, then block raster
    order."""
    f, h, w = planes.shape
    return (planes.reshape(f, h // n, n, w // n, n)
            .permute(0, 1, 3, 2, 4)
            .reshape(-1, n, n))


def _edge(edge_col: int, edge_on, gx: int) -> bool:
    """Whether grid column edge_col is the picture's true left edge inside a
    halo-extended tile shard (search.py:61-75): edge_on None or True on
    the shard that holds the edge."""
    return 0 < edge_col < gx and (edge_on is None or bool(edge_on))


def _intra_mode_bits(best_mode: torch.Tensor, f: int, gy: int, gx: int,
                     edge_col: int = 0, edge_on=None) -> torch.Tensor:
    """MPM-aware per-mode rate [B, 35] from the provisional (SATD-best)
    modes of the same-size left/above neighbours (DC when unavailable):
    2 bits for MPM0, 3 for MPM1/2, 6 otherwise.  edge_col, edge_on: the
    picture's left edge at grid column edge_col of a halo-extended shard,
    whose left neighbour is unavailable (DC) as at column 0 (search.py:77,
    :86-100)."""
    m = best_mode.reshape(f, gy, gx)
    dc = torch.ones_like(m[:, :, :1])
    cand_a = torch.cat([dc, m[:, :, :-1]], dim=2)
    if _edge(edge_col, edge_on, gx):
        cand_a[:, :, edge_col] = 1
    cand_b = torch.cat([torch.ones_like(m[:, :1, :]), m[:, :-1, :]], dim=1)
    eq = cand_a == cand_b
    lt2 = cand_a < 2
    mpm0 = torch.where(eq & lt2, 0, cand_a)
    mpm1 = torch.where(eq, torch.where(lt2, 1, 2 + ((cand_a + 29) % 32)),
                       cand_b)
    third = torch.where((cand_a != 0) & (cand_b != 0), 0,
                        torch.where((cand_a != 1) & (cand_b != 1), 1, 26))
    mpm2 = torch.where(eq, torch.where(lt2, 26, 2 + ((cand_a - 1) % 32)),
                       third)
    modes = torch.arange(35, dtype=m.dtype, device=m.device)
    is0 = modes == mpm0[..., None]
    is12 = (modes == mpm1[..., None]) | (modes == mpm2[..., None])
    bits = torch.where(is0, 2.0, torch.where(is12, 3.0, 6.0))
    return bits.to(torch.float32).reshape(-1, 35)


def search_qp(lambda_sqrt: float) -> int:
    """The quantiser QP the search's T/Q uses: lambda(qp) inverted in f32,
    as fasthevc_tpu/codec/search.py does."""
    ls = torch.tensor(lambda_sqrt, dtype=torch.float32)
    lam = ls * ls
    qp = 12.0 + 3.0 * torch.log2(lam / 0.57)
    return int(torch.clamp(torch.round(qp), 0, 51).to(torch.int32))


def search_intra_frames(y: torch.Tensor, lambda_sqrt: float,
                        log2_ctu: int = 5, log2_min_cu: int = 3,
                        cb: torch.Tensor | None = None,
                        cr: torch.Tensor | None = None,
                        rd_cands: int = 3, plain: bool = False,
                        ref_y: torch.Tensor | None = None,
                        ref_cb: torch.Tensor | None = None,
                        ref_cr: torch.Tensor | None = None,
                        mpm_edge_x: int = 0, mpm_edge_on=None) -> dict:
    """Decide the CU quadtree and luma mode of every CTU of F frames.

    y: [F, H, W] int32 luma (H, W multiples of the CTU); cb, cr: optional
    [F, H/2, W/2] int32 chroma for the chroma DM cost.  ref_y, ref_cb,
    ref_cr: optional reconstructions of the same shapes whose pixels feed
    the intra reference rows in place of the source's (the two-pass
    recon-reference search, search.py:117); SATD, SSE and the residuals
    stay against the source.  mpm_edge_x, mpm_edge_on: the luma column of
    the picture's left edge inside a halo-extended tile shard, and whether
    this shard holds it (search.py:117; 0 for a whole picture).  Returns
    the JAX search's dict, every entry
    [F, B_n] in block raster order: mode{n}, cost{n} and split{n} (n above
    the min CU size), rawcost{n}.
    """
    predict, predict_satd, tq_cost = _ops(plain)
    f, h, w = y.shape
    sizes = [1 << lg for lg in range(log2_min_cu, log2_ctu + 1)]
    # f32 scalars stay on the host: a 0-dim CPU tensor enters a CUDA op as
    # a kernel argument, with no copy and no stream synchronisation
    ls = torch.tensor(lambda_sqrt, dtype=torch.float32)
    lam = ls * ls
    qp_i = search_qp(lambda_sqrt)
    kk = max(1, min(rd_cands, 35))
    modes, costs = {}, {}
    for n in sizes:
        # prediction tops out at 32: a 64-block's mode comes from its
        # top-left 32 quadrant (the commit re-derives it exactly)
        pn = min(n, 32)
        plg = pn.bit_length() - 1
        top, left = intra.grid_refs(y if ref_y is None else ref_y, n)
        if pn != n:
            top = top[:, :2 * pn + 1].contiguous()
            left = left[:, :2 * pn + 1].contiguous()
        src = _blocks(y, n)[:, :pn, :pn].contiguous()
        d = predict_satd(top, left, plg, src)                # [B,35]
        prov = torch.argmin(d, dim=1).to(torch.int32)
        mode_bits = _intra_mode_bits(prov, f, h // n, w // n,
                                     mpm_edge_x // n, mpm_edge_on)
        cost_rmd = d.to(torch.float32) + ls * mode_bits
        b = src.shape[0]
        # lower index first among equal costs, as jax.lax.top_k orders
        # them (torch.topk does not)
        top_idx = torch.sort(cost_rmd, dim=1, stable=True).indices[:, :kk]
        cands = predict(top, left, plg, top_idx)             # [B,kk,pn,pn]
        res = (src[:, None] - cands).reshape(b * kk, pn, pn)
        dist, rate = tq_cost(res, qp_i, plg)
        dist = dist.reshape(b, kk)
        rate = rate.reshape(b, kk)
        cand_bits = torch.take_along_dim(mode_bits, top_idx, dim=1)
        rd_k = dist + lam * (rate + cand_bits)
        kbest = torch.argmin(rd_k, dim=1, keepdim=True)
        best_mode = torch.take_along_dim(top_idx, kbest, dim=1)[:, 0]
        dist = torch.take_along_dim(dist, kbest, dim=1)[:, 0]
        rate = torch.take_along_dim(rate, kbest, dim=1)[:, 0]
        sel_bits = torch.take_along_dim(cand_bits, kbest, dim=1)[:, 0]
        modes[n] = best_mode.to(torch.int32)
        cost_n = dist + lam * (rate + sel_bits)
        if cb is not None and pn == n:
            # chroma DM cost of both planes
            cn = pn // 2
            clg = cn.bit_length() - 1
            for cp, rcp in ((cb, ref_cb), (cr, ref_cr)):
                ctop, cleft = intra.grid_refs(cp if rcp is None else rcp, cn)
                cpred = predict(ctop, cleft, clg, modes[n][:, None],
                                is_luma=False)[:, 0]
                cres = _blocks(cp, cn) - cpred
                cdist, crate = tq_cost(cres, qp_i, clg)
                cost_n = cost_n + (cdist + lam * crate)
        costs[n] = cost_n * (4.0 if pn != n else 1.0)

    # quadtree DP, bottom-up; the four children are summed in raster order
    # (top-left, top-right, bottom-left, bottom-right), as XLA does
    out = {}
    dp = costs[sizes[0]] + lam * CU_OVERHEAD_BITS
    out[f"mode{sizes[0]}"] = modes[sizes[0]].reshape(f, -1)
    for n in sizes[1:]:
        gy, gx = h // n, w // n
        c = dp.reshape(f, gy, 2, gx, 2)
        sum_child = (c[:, :, 0, :, 0] + c[:, :, 0, :, 1] + c[:, :, 1, :, 0]
                     + c[:, :, 1, :, 1]).reshape(-1)
        self_cost = costs[n] + lam * CU_OVERHEAD_BITS
        split = sum_child + lam * SPLIT_FLAG_BITS < self_cost
        dp = torch.where(split, sum_child + lam * SPLIT_FLAG_BITS, self_cost)
        out[f"mode{n}"] = modes[n].reshape(f, -1)
        out[f"split{n}"] = split.reshape(f, -1)
        out[f"cost{n}"] = dp.reshape(f, -1)
    for n, c in costs.items():
        out[f"rawcost{n}"] = c.reshape(f, -1)
    return out


def _one(t):
    """A plane as a batch of one frame (None stays None)."""
    return None if t is None else t[None]


def search_intra_frame(y_plane: torch.Tensor, lambda_sqrt: float,
                       log2_ctu: int = 5, log2_min_cu: int = 3,
                       cb_plane=None, cr_plane=None, rd_cands: int = 3,
                       plain: bool = False, ref_y=None, ref_cb=None,
                       ref_cr=None, mpm_edge_x: int = 0,
                       mpm_edge_on=None) -> dict:
    """One frame ([H, W] planes) of `search_intra_frames`; entries [B_n]."""
    dec = search_intra_frames(
        y_plane[None], lambda_sqrt, log2_ctu, log2_min_cu, _one(cb_plane),
        _one(cr_plane), rd_cands, plain, _one(ref_y), _one(ref_cb),
        _one(ref_cr), mpm_edge_x, mpm_edge_on)
    return {key: v[0] for key, v in dec.items()}


def _merge_edge(edge_x: int, edge_on, n: int, w: int) -> int:
    """The n-grid column whose left neighbour is the picture's edge inside
    a halo-extended shard (the merge candidates' left field is zero there,
    search.py:61-75), or -1."""
    col = edge_x // n
    return col if _edge(col, edge_on, w // n) else -1


def _pick_ref(sp_n, ia: int, ib: int) -> tuple:
    """Per-block choice between state refs ia and ib of one size's sub-pel
    results (search.py:424 `pick_ref`; ia == ib: one reference): (cost,
    mv, pred, sel)."""
    c, mvq, pred = sp_n
    if ia == ib:
        return (c[ia], mvq[ia], pred[ia],
                torch.zeros_like(c[ia], dtype=torch.bool))
    sel = c[ib] < c[ia]
    return (torch.minimum(c[ia], c[ib]),
            torch.where(sel[:, None], mvq[ib], mvq[ia]),
            torch.where(sel[:, None, None], pred[ib], pred[ia]), sel)


def _inter_leaf(y, n: int, pred, rate_bits, qp_i: int, lam, tq_cost):
    """The true-RD leaf cost of an inter candidate's residual at the inter
    dead-zone offset; XLA contracts dist + lam * (...) into one fused
    multiply-add."""
    pn = min(n, 32)
    res = (_blocks(y[None], n) - pred)[:, :pn, :pn].contiguous()
    dist, rate = tq_cost(res, qp_i, pn.bit_length() - 1, is_intra=False)
    return cost.fma_f32(lam, (rate + rate_bits) + INTER_OVERHEAD_BITS,
                        dist) * (4.0 if pn != n else 1.0)


def _dp_step(out: dict, dp, leaf, n: int, h: int, w: int, lam):
    """One bottom-up level of the inter quadtree DP: the four children
    summed in raster order against the leaf; records split{n}."""
    if dp is None:
        return leaf
    ch = dp.reshape(h // n, 2, w // n, 2)
    sum_child = (ch[:, 0, :, 0] + ch[:, 0, :, 1] + ch[:, 1, :, 0]
                 + ch[:, 1, :, 1]).reshape(-1)
    split = sum_child + lam * SPLIT_FLAG_BITS < leaf
    out[f"split{n}"] = split
    return torch.where(split, sum_child + lam * SPLIT_FLAG_BITS, leaf)


def search_p_frame(y: torch.Tensor, refs: torch.Tensor, lambda_sqrt: float,
                   log2_ctu: int = 5, log2_min_cu: int = 3,
                   search_range: int = 8, rd_cands: int = 3,
                   nref: int | None = None, plain: bool = False,
                   mpm_edge_x: int = 0, mpm_edge_on=None,
                   me_decimated=None) -> dict:
    """P-frame search (search.py:244): intra and inter candidates for every
    block over up to two active L0 references, then the quadtree DP over
    the per-block minimum.

    y [H, W] int32; refs [R, H, W] (R = 1 or 2) edge-padded to y's size;
    nref: the active references (default R).  mpm_edge_x, mpm_edge_on: the
    shard's picture edge of search_intra_frames, for the MPM and the merge
    candidates; me_decimated: a shard's decimated planes for me_state.
    Returns the B search's keys:
    the intra outputs' mode{n} and split{n} plus inter{n} (inter chosen),
    dir{n} (1), mv0{n} ([B_n, 2] quarter-pel) and ref0{n} ([B_n] ref
    index), with list 1's mv1{n} and ref1{n} zero, each in block raster
    order."""
    _, _, tq_cost = _ops(plain)
    h, w = y.shape
    sizes = [1 << lg for lg in range(log2_min_cu, log2_ctu + 1)]
    ls = torch.tensor(lambda_sqrt, dtype=torch.float32)
    lam = ls * ls
    qp_i = search_qp(lambda_sqrt)
    if refs.dim() == 2:
        refs = refs[None]
    # a second reference that nref masks out (cost inf, never selected,
    # no neighbour carries its index) changes nothing: leave it out
    refs = refs[:max(1, min(refs.shape[0] if nref is None else nref, 2))]
    ib = refs.shape[0] - 1
    intra_dec = search_intra_frame(y, lambda_sqrt, log2_ctu, log2_min_cu,
                                   rd_cands=rd_cands, plain=plain,
                                   mpm_edge_x=mpm_edge_x,
                                   mpm_edge_on=mpm_edge_on)
    st = me.me_state(y, refs, search_range, max_size=1 << log2_ctu,
                     plain=plain, decimated=me_decimated)
    sp = me.subpel_from_state(st, lambda_sqrt, plain=plain)
    out = {}
    dp = None
    for n in sizes:
        me_cost, mv, pred, sel = _pick_ref(sp[n], 0, ib)
        # the merge candidates, folded in one K11 launch
        (mv, ridx, pred, _, rate_bits), = me.mc_merge(
            st, [(0, ib, mv, sel.to(torch.int32), pred, me_cost,
                  me.mv_rate_bits(mv))], n, lambda_sqrt,
            _merge_edge(mpm_edge_x, mpm_edge_on, n, w), plain=plain)
        icost = _inter_leaf(y, n, pred, rate_bits, qp_i, lam, tq_cost)
        raw_intra = intra_dec[f"rawcost{n}"]
        out[f"mode{n}"] = intra_dec[f"mode{n}"]
        out[f"inter{n}"] = icost < raw_intra
        out[f"dir{n}"] = torch.ones_like(ridx, dtype=torch.int32)
        out[f"mv0{n}"] = mv.to(torch.int32)
        out[f"mv1{n}"] = torch.zeros_like(out[f"mv0{n}"])
        out[f"ref0{n}"] = ridx.to(torch.int32)
        out[f"ref1{n}"] = torch.zeros_like(out[f"ref0{n}"])
        leaf = torch.minimum(icost, raw_intra) + lam * CU_OVERHEAD_BITS
        dp = _dp_step(out, dp, leaf, n, h, w, lam)
    return out


def search_b_frame(y: torch.Tensor, refs0: torch.Tensor, refs1: torch.Tensor,
                   lambda_sqrt: float, log2_ctu: int = 5, log2_min_cu: int = 3,
                   search_range: int = 8, rd_cands: int = 3,
                   nref0: int | None = None, nref1: int | None = None,
                   plain: bool = False, mpm_edge_x: int = 0,
                   mpm_edge_on=None, me_decimated=None) -> dict:
    """B-frame search (search.py:359): intra, L0, L1 and BI candidates for
    every block over up to two active references per list, then the
    quadtree DP over the per-block minimum.

    y [H, W] int32; refs0, refs1 [R, H, W] (R = 1 or 2) the lists'
    references edge-padded to y's size; nref0, nref1 the active ones
    (default R).  One ME state serves both lists over the references l0a
    [l0b] l1a [l1b]: a second reference that its list's count masks out
    changes nothing (cost inf, never chosen, no neighbour carries its
    index), so it is left out and list 1's state indices move with it.
    BI (K12) averages the two lists' exact predictions at their final MVs.
    mpm_edge_x, mpm_edge_on, me_decimated: as search_p_frame's.
    Returns the intra outputs' mode{n} and split{n} plus inter{n}, dir{n}
    (1 L0, 2 L1, 3 BI; 1 for intra), mv0{n}, mv1{n} ([B_n, 2]
    quarter-pel), ref0{n} and ref1{n} ([B_n] ref index), each in block
    raster order."""
    _, _, tq_cost = _ops(plain)
    h, w = y.shape
    sizes = [1 << lg for lg in range(log2_min_cu, log2_ctu + 1)]
    ls = torch.tensor(lambda_sqrt, dtype=torch.float32)
    lam = ls * ls
    qp_i = search_qp(lambda_sqrt)
    lists = []
    for refs, nref in ((refs0, nref0), (refs1, nref1)):
        refs = refs[None] if refs.dim() == 2 else refs
        lists.append(refs[:max(1, min(refs.shape[0] if nref is None
                                      else nref, 2))])
    i0b = lists[0].shape[0] - 1
    i1a = i0b + 1
    i1b = i1a + lists[1].shape[0] - 1
    intra_dec = search_intra_frame(y, lambda_sqrt, log2_ctu, log2_min_cu,
                                   rd_cands=rd_cands, plain=plain,
                                   mpm_edge_x=mpm_edge_x,
                                   mpm_edge_on=mpm_edge_on)
    st = me.me_state(y, torch.cat(lists), search_range,
                     max_size=1 << log2_ctu, plain=plain,
                     decimated=me_decimated)
    sp = me.subpel_from_state(st, lambda_sqrt, plain=plain)
    out = {}
    dp = None
    for n in sizes:
        lists = []
        for ia, ib in ((0, i0b), (i1a, i1b)):
            c, mv, pred, sel = _pick_ref(sp[n], ia, ib)
            lists.append((ia, ib, mv, sel.to(torch.int32), pred, c,
                          me.mv_rate_bits(mv)))
        # both lists' merge candidates, folded in one K11 launch
        (mv0, r0idx, p0, c0, r0bits), (mv1, r1idx, p1, c1, r1bits) = \
            me.mc_merge(st, lists, n, lambda_sqrt,
                        _merge_edge(mpm_edge_x, mpm_edge_on, n, w),
                        plain=plain)
        pbi, cbi = me.bi_cost(
            st.y, st.refs, mv0, torch.where(r0idx > 0, i0b, 0), mv1,
            torch.where(r1idx > 0, i1b, i1a), r0bits, r1bits, lambda_sqrt,
            n, plain=plain)
        # direction in the SATD domain (the first of equal costs, as
        # jnp.argmin), then one T/Q on the winner; the reference's one-hot
        # einsum of the predictions and rates is exact, so a select
        dchoice = torch.argmin(torch.stack([c0, c1, cbi]), dim=0)
        d3 = dchoice[:, None, None]
        pred_sel = torch.where(d3 == 0, p0, torch.where(d3 == 1, p1, pbi))
        rate_sel = torch.where(dchoice == 0, r0bits,
                               torch.where(dchoice == 1, r1bits,
                                           r0bits + r1bits))
        icost = _inter_leaf(y, n, pred_sel, rate_sel, qp_i, lam, tq_cost)
        raw_intra = intra_dec[f"rawcost{n}"]
        use_inter = icost < raw_intra
        out[f"mode{n}"] = intra_dec[f"mode{n}"]
        out[f"inter{n}"] = use_inter
        out[f"dir{n}"] = torch.where(use_inter, dchoice + 1, 1).to(
            torch.int32)
        out[f"mv0{n}"] = mv0.to(torch.int32)
        out[f"mv1{n}"] = mv1.to(torch.int32)
        out[f"ref0{n}"] = r0idx.to(torch.int32)
        out[f"ref1{n}"] = r1idx.to(torch.int32)
        leaf = torch.minimum(icost, raw_intra) + lam * CU_OVERHEAD_BITS
        dp = _dp_step(out, dp, leaf, n, h, w, lam)
    return out


def _pack_maps(dec: dict, f: int, padded_w: int, padded_h: int,
               coded_w: int, coded_h: int, log2_ctu: int,
               log2_min_cu: int, depth_override=None) -> torch.Tensor:
    """Fold the per-size decisions into packed int16 [F, ph/8, pw/8, 9]
    maps = (depth, mode, dir, mv0x, mv0y, mv1x, mv1y, ref0, ref1), as
    fasthevc_tpu/codec/search.py _pack_maps_device does.  An inter
    search's entries carry inter{n}, dir{n}, mv0{n}, mv1{n}, ref0{n} and
    ref1{n}; the MVs are stored whatever the direction (the recorded TMVP
    motion reads them).  Inter CUs get mode -1.  Blocks that overflow the
    coded picture split whatever the DP chose.  depth_override: the
    partition CNN's [F, ph/8, pw/8] granule depth map, which replaces the
    DP's split{n}: an n-block of depth d splits when the largest depth
    over it exceeds d (search.py:586-595)."""
    gw, gh = padded_w >> 3, padded_h >> 3
    sizes = [1 << lg for lg in range(log2_ctu, log2_min_cu - 1, -1)]
    dev = dec[f"mode{sizes[0]}"].device
    i16 = torch.int16

    def up(a, n):
        r = n >> 3
        return a.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)

    def grid(key, n, *tail):
        return up(dec[key].reshape(f, padded_h // n, padded_w // n, *tail)
                  .to(i16), n)

    def forced(n):
        bx = torch.arange(padded_w // n, device=dev) * n
        by = torch.arange(padded_h // n, device=dev) * n
        fm = (by[:, None] + n > coded_h) | (bx[None, :] + n > coded_w)
        return up(fm[None], n)

    def level_maps(n):
        """(mode, dir, mv [.., 4], ref [.., 2]) of the n-level decisions."""
        mode = grid(f"mode{n}", n)
        if f"inter{n}" not in dec:
            return mode, None, None, None
        inter = grid(f"inter{n}", n) > 0
        dir_n = torch.where(inter, grid(f"dir{n}", n), 0).to(i16)
        mv = torch.cat([grid(f"mv0{n}", n, 2), grid(f"mv1{n}", n, 2)], dim=-1)
        ref = torch.stack([grid(f"ref0{n}", n), grid(f"ref1{n}", n)], dim=-1)
        return torch.where(dir_n > 0, -1, mode).to(i16), dir_n, mv, ref

    depth = torch.zeros((f, gh, gw), dtype=i16, device=dev)
    mode, dir_m, mv, ref = level_maps(sizes[0])
    for d, n in enumerate(sizes[:-1]):
        if depth_override is None:
            split = grid(f"split{n}", n) > 0
        else:
            g = n >> 3
            rm = depth_override.reshape(f, padded_h // n, g, padded_w // n,
                                        g).amax(dim=(2, 4))
            split = up(rm > d, n)
        active = (depth == d) & (split | forced(n))
        cmode, cdir, cmv, cref = level_maps(sizes[d + 1])
        depth = torch.where(active, d + 1, depth).to(i16)
        mode = torch.where(active, cmode, mode)
        if dir_m is not None:
            dir_m = torch.where(active, cdir, dir_m)
            mv = torch.where(active[..., None], cmv, mv)
            ref = torch.where(active[..., None], cref, ref)
    if dir_m is None:
        rest = torch.zeros((f, gh, gw, 7), dtype=i16, device=dev)
    else:
        rest = torch.cat([dir_m[..., None], mv, ref], dim=-1)
    return torch.cat([depth[..., None], mode[..., None], rest], dim=-1)


def _cnn_override(y_batch: torch.Tensor, cnn, qp, log2_ctu: int,
                  plain: bool):
    """The partition CNN's granule depth maps of the batch's padded luma
    (K13, one launch for the F frames), or None without a CNN."""
    if cnn is None:
        return None
    return cnn_depth(y_batch, cnn.flat_params(), qp, log2_ctu, plain=plain)


def _int32(t):
    return None if t is None else t.to(torch.int32)


def search_intra_maps_batch(y_batch: torch.Tensor, lambda_sqrt: float,
                            log2_ctu: int, log2_min_cu: int, coded_w: int,
                            coded_h: int, cb_batch=None, cr_batch=None,
                            rd_cands: int = 3, plain: bool = False,
                            cnn=None, qp=0, ref_y=None, ref_cb=None,
                            ref_cr=None, mpm_edge_x: int = 0,
                            mpm_edge_on=None) -> torch.Tensor:
    """Multi-frame intra search: [F, H, W] padded luma (uint8 or int32)
    -> [F, H/8, W/8, 9] int16 packed decision maps.  cnn: a
    models.PartitionCNN on the batch's device, whose depth maps at `qp`
    replace the DP's splits (the fast-partition path, search.py:622-624).
    ref_y, ref_cb, ref_cr: the recon-reference planes of
    search_intra_frames, padded as the source is.  mpm_edge_x, mpm_edge_on:
    the picture edge inside a halo-extended tile shard (search.py:607)."""
    y = y_batch.to(torch.int32)
    dec = search_intra_frames(y, lambda_sqrt, log2_ctu, log2_min_cu,
                              _int32(cb_batch), _int32(cr_batch), rd_cands,
                              plain, _int32(ref_y), _int32(ref_cb),
                              _int32(ref_cr), mpm_edge_x, mpm_edge_on)
    f, h, w = y.shape
    return _pack_maps(dec, f, w, h, coded_w, coded_h, log2_ctu, log2_min_cu,
                      _cnn_override(y_batch, cnn, qp, log2_ctu, plain))


def search_intra_maps(y: torch.Tensor, lambda_sqrt: float, log2_ctu: int,
                      log2_min_cu: int, coded_w: int, coded_h: int, cb=None,
                      cr=None, ref_y=None, ref_cb=None, ref_cr=None,
                      rd_cands: int = 3, plain: bool = False, cnn=None,
                      qp=0) -> torch.Tensor:
    """One picture's intra search (search.py:631 `search_intra_maps`,
    through `_search_intra_maps_impl` :607): [H, W] padded luma, optional
    [H/2, W/2] chroma and recon-reference planes, the CNN's override at
    the picture's own `qp`; returns its [H/8, W/8, 9] packed maps."""
    return search_intra_maps_batch(
        y[None], lambda_sqrt, log2_ctu, log2_min_cu, coded_w, coded_h,
        _one(cb), _one(cr), rd_cands, plain, cnn, qp, _one(ref_y),
        _one(ref_cb), _one(ref_cr))[0]


def search_p_maps(y_batch: torch.Tensor, refs: torch.Tensor, lambda_sqrt,
                  log2_ctu: int, log2_min_cu: int, coded_w: int,
                  coded_h: int, search_range: int, nref=None,
                  rd_cands: int = 3, plain: bool = False, cnn=None,
                  qp=0, mpm_edge_x: int = 0, mpm_edge_on=None,
                  me_decimated=None) -> torch.Tensor:
    """P search of F frames (search.py:682, one frame at a time): y_batch
    [F, H, W] padded luma, refs [F, R, H, W] its references edge-padded to
    the same size, lambda_sqrt and nref scalars or per-frame sequences.
    cnn, qp: the fast-partition override of search_intra_maps_batch (one
    K13 launch for the batch, search.py:700-702).  mpm_edge_x, mpm_edge_on:
    the shard's picture edge (search.py:682); me_decimated: per frame the
    shard's decimated [1 + R, H/4, W/4] planes (search_p_frame).  Returns
    packed
    [F, H/8, W/8, 9] int16 maps."""
    f, h, w = y_batch.shape
    lams, nrefs = per_frame(lambda_sqrt, f), per_frame(nref, f)
    decs = [search_p_frame(y_batch[i].to(torch.int32),
                           refs[i].to(torch.int32), lams[i], log2_ctu,
                           log2_min_cu, search_range, rd_cands, nrefs[i],
                           plain, mpm_edge_x, mpm_edge_on,
                           None if me_decimated is None
                           else me_decimated[i]) for i in range(f)]
    dec = {k: torch.stack([d[k] for d in decs]) for k in decs[0]}
    return _pack_maps(dec, f, w, h, coded_w, coded_h, log2_ctu, log2_min_cu,
                      _cnn_override(y_batch, cnn, qp, log2_ctu, plain))


def search_b_maps(y_batch: torch.Tensor, refs0: torch.Tensor,
                  refs1: torch.Tensor, lambda_sqrt, log2_ctu: int,
                  log2_min_cu: int, coded_w: int, coded_h: int,
                  search_range: int, nref0=None, nref1=None,
                  rd_cands: int = 3, plain: bool = False, cnn=None,
                  qp=0, mpm_edge_x: int = 0, mpm_edge_on=None,
                  me_decimated=None) -> torch.Tensor:
    """B search of F frames (search.py:710, one frame at a time): y_batch
    [F, H, W] padded luma, refs0/refs1 [F, R, H, W] each list's references
    edge-padded to the same size, lambda_sqrt, nref0 and nref1 scalars or
    per-frame sequences.  cnn, qp: the fast-partition override of
    search_intra_maps_batch (search.py:729-731).  mpm_edge_x, mpm_edge_on,
    me_decimated: as search_p_maps' (search.py:710).  Returns packed
    [F, H/8, W/8, 9] int16 maps."""
    f, h, w = y_batch.shape
    lams, n0s, n1s = (per_frame(v, f) for v in (lambda_sqrt, nref0, nref1))
    decs = [search_b_frame(y_batch[i].to(torch.int32),
                           refs0[i].to(torch.int32), refs1[i].to(torch.int32),
                           lams[i], log2_ctu, log2_min_cu, search_range,
                           rd_cands, n0s[i], n1s[i], plain, mpm_edge_x,
                           mpm_edge_on, None if me_decimated is None
                           else me_decimated[i])
            for i in range(f)]
    dec = {k: torch.stack([d[k] for d in decs]) for k in decs[0]}
    return _pack_maps(dec, f, w, h, coded_w, coded_h, log2_ctu, log2_min_cu,
                      _cnn_override(y_batch, cnn, qp, log2_ctu, plain))
