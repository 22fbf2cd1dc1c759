"""Batched all-intra RDO search over frame groups: the intra half of
fasthevc_tpu/codec/search.py.

For every aligned block of every CU size of every frame: SATD over the 35
intra modes (K1 + K2), MPM-aware mode bits, a true-RD pass over the top-k
shortlist through the exact T/Q/IQ/IT (K3) with SSE and the level-rate
proxy (K4), the chroma DM cost (K1, K3, K4), then the bottom-up quadtree
DP and the packed int16 [gh, gw, 9] decision maps of the C++ slice engine.

The f32 costs are built with the same operations, in the same order, as
the JAX search, so both take the same decisions.  `plain=True` runs the
kernels' PyTorch twins instead of the kernels (on any device).
"""

from __future__ import annotations

import torch

from ..ops import cost, intra, transform

# Bit proxies of the CU syntax (fasthevc_tpu/codec/search.py).
CU_OVERHEAD_BITS = 3.0
SPLIT_FLAG_BITS = 1.0


def _ops(plain: bool) -> tuple:
    """The search's kernel entry points (predict, satd, tq_roundtrip,
    sse_rate): the wrappers, or with `plain` their twins."""
    if plain:
        return (intra.predict_plain, cost.satd_plain,
                transform.tq_roundtrip_plain, cost.sse_rate_plain)
    return intra.predict, cost.satd, transform.tq_roundtrip, cost.sse_rate


def _blocks(planes: torch.Tensor, n: int) -> torch.Tensor:
    """[F, H, W] -> [F * H/n * W/n, n, n] in frame, then block raster
    order."""
    f, h, w = planes.shape
    return (planes.reshape(f, h // n, n, w // n, n)
            .permute(0, 1, 3, 2, 4)
            .reshape(-1, n, n))


def _intra_mode_bits(best_mode: torch.Tensor, f: int, gy: int,
                     gx: int) -> torch.Tensor:
    """MPM-aware per-mode rate [B, 35] from the provisional (SATD-best)
    modes of the same-size left/above neighbours (DC when unavailable):
    2 bits for MPM0, 3 for MPM1/2, 6 otherwise."""
    m = best_mode.reshape(f, gy, gx)
    dc = torch.ones_like(m[:, :, :1])
    cand_a = torch.cat([dc, m[:, :, :-1]], dim=2)
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
                        rd_cands: int = 3, plain: bool = False) -> dict:
    """Decide the CU quadtree and luma mode of every CTU of F frames.

    y: [F, H, W] int32 luma (H, W multiples of the CTU); cb, cr: optional
    [F, H/2, W/2] int32 chroma for the chroma DM cost.  Returns the JAX
    search's dict, every entry [F, B_n] in block raster order: mode{n},
    cost{n} and split{n} (n above the min CU size), rawcost{n}.
    """
    predict, satd, tq_roundtrip, sse_rate = _ops(plain)
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
        top, left = intra.grid_refs(y, n)
        if pn != n:
            top = top[:, :2 * pn + 1].contiguous()
            left = left[:, :2 * pn + 1].contiguous()
        src = _blocks(y, n)[:, :pn, :pn].contiguous()
        preds = predict(top, left, plg)                      # [B,35,pn,pn]
        d = satd(src, preds)                                 # [B,35]
        prov = torch.argmin(d, dim=1).to(torch.int32)
        mode_bits = _intra_mode_bits(prov, f, h // n, w // n)
        cost_rmd = d.to(torch.float32) + ls * mode_bits
        b = src.shape[0]
        # lower index first among equal costs, as jax.lax.top_k orders
        # them (torch.topk does not)
        top_idx = torch.sort(cost_rmd, dim=1, stable=True).indices[:, :kk]
        cands = torch.take_along_dim(preds, top_idx[:, :, None, None], dim=1)
        del preds
        res = (src[:, None] - cands).reshape(b * kk, pn, pn)
        levels, rq = tq_roundtrip(res, qp_i, plg)
        dist, rate = sse_rate(res, rq, levels)
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
            for cp in (cb, cr):
                ctop, cleft = intra.grid_refs(cp, cn)
                cpred = predict(ctop, cleft, clg, modes[n][:, None],
                                is_luma=False)[:, 0]
                cres = _blocks(cp, cn) - cpred
                clv, crq = tq_roundtrip(cres, qp_i, clg)
                cdist, crate = sse_rate(cres, crq, clv)
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


def search_intra_frame(y_plane: torch.Tensor, lambda_sqrt: float,
                       log2_ctu: int = 5, log2_min_cu: int = 3,
                       cb_plane=None, cr_plane=None, rd_cands: int = 3,
                       plain: bool = False) -> dict:
    """One frame ([H, W] planes) of `search_intra_frames`; entries [B_n]."""
    dec = search_intra_frames(
        y_plane[None], lambda_sqrt, log2_ctu, log2_min_cu,
        None if cb_plane is None else cb_plane[None],
        None if cr_plane is None else cr_plane[None], rd_cands, plain)
    return {key: v[0] for key, v in dec.items()}


def _pack_maps(dec: dict, f: int, padded_w: int, padded_h: int,
               coded_w: int, coded_h: int, log2_ctu: int,
               log2_min_cu: int) -> torch.Tensor:
    """Fold the per-size intra decisions into packed int16 [F, ph/8, pw/8,
    9] maps = (depth, mode, dir, mv0x, mv0y, mv1x, mv1y, ref0, ref1), the
    intra part of fasthevc_tpu/codec/search.py _pack_maps_device.  Blocks
    that overflow the coded picture split whatever the DP chose."""
    gw, gh = padded_w >> 3, padded_h >> 3
    sizes = [1 << lg for lg in range(log2_ctu, log2_min_cu - 1, -1)]
    dev = dec[f"mode{sizes[0]}"].device

    def up(a, n):
        r = n >> 3
        return a.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)

    def grid(key, n):
        return dec[key].reshape(f, padded_h // n, padded_w // n)

    def forced(n):
        bx = torch.arange(padded_w // n, device=dev) * n
        by = torch.arange(padded_h // n, device=dev) * n
        fm = (by[:, None] + n > coded_h) | (bx[None, :] + n > coded_w)
        return up(fm[None], n)

    depth = torch.zeros((f, gh, gw), dtype=torch.int16, device=dev)
    mode = up(grid(f"mode{sizes[0]}", sizes[0]).to(torch.int16), sizes[0])
    for d, n in enumerate(sizes[:-1]):
        child = sizes[d + 1]
        split = up(grid(f"split{n}", n), n)
        active = (depth == d) & (split | forced(n))
        cmode = up(grid(f"mode{child}", child).to(torch.int16), child)
        depth = torch.where(active, d + 1, depth).to(torch.int16)
        mode = torch.where(active, cmode, mode)
    rest = torch.zeros((f, gh, gw, 7), dtype=torch.int16, device=dev)
    return torch.cat([depth[..., None], mode[..., None], rest], dim=-1)


def search_intra_maps_batch(y_batch: torch.Tensor, lambda_sqrt: float,
                            log2_ctu: int, log2_min_cu: int, coded_w: int,
                            coded_h: int, cb_batch=None, cr_batch=None,
                            rd_cands: int = 3,
                            plain: bool = False) -> torch.Tensor:
    """Multi-frame intra search: [F, H, W] padded luma (uint8 or int32)
    -> [F, H/8, W/8, 9] int16 packed decision maps."""
    y = y_batch.to(torch.int32)
    cb = None if cb_batch is None else cb_batch.to(torch.int32)
    cr = None if cr_batch is None else cr_batch.to(torch.int32)
    dec = search_intra_frames(y, lambda_sqrt, log2_ctu, log2_min_cu, cb, cr,
                              rd_cands, plain)
    f, h, w = y.shape
    return _pack_maps(dec, f, w, h, coded_w, coded_h, log2_ctu, log2_min_cu)
