"""Batched intra prediction: all 35 modes, or selected modes, for B blocks.

Counterpart of fasthevc_tpu/ops/intra.py.  `predict` (and its two forms
`predict_all_modes` and `predict_selected`) goes through kernel K1
(csrc/intra_pred.cu) for CUDA tensors, counted as `intra_pred` (all 35
modes) or `intra_pred_selected`; `predict_plain` is its PyTorch twin.
`predict_satd`, K1's fused form, is the intra search's all-mode
step: the SATD of every mode's prediction (predict_all_modes, then
fasthevc_tpu/ops/cost.py satd), with `predict_satd_plain` as its twin.
`intra_rd_cands`, K1's rd form (counter `intra_rd_cands`), is the search's
RD shortlist: the K least RMD costs' modes, bits and residuals
(fasthevc_tpu/codec/search.py:170-185); `intra_rd_residuals`, its second
form, takes the modes (the chroma DM residual, search.py:209-212).  Their
twins are `intra_rd_cands_plain` and `intra_rd_residuals_plain`.  No route
launches the selected form any more.  `grid_refs` is plain tensor glue.

Reference layout (the spec oracle's): top[b] = [corner, p[0][-1] ..
p[2N-1][-1]], left[b] = [corner, p[-1][0] .. p[-1][2N-1]], both [B, 2N+1]
int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..spec.intra import should_filter
from ..spec.tables import INTRA_INV_ANGLE, INTRA_PRED_ANGLE

from .. import _build
from . import cost


@functools.lru_cache(maxsize=None)
def _angular_tables(n: int):
    """Gather tables for modes 2..34 over refcat = [top | left] (length
    2(2n+1)): pred[y][x] = (w_a*refcat[idx_a] + w_b*refcat[idx_b] + 16)
    >> 5, with the transpose of modes < 18 folded in.  Copied from
    fasthevc_tpu/ops/intra.py _angular_tables/_Tables (numpy only)."""
    ln = 2 * n + 1
    idx_a = np.zeros((33, n, n), dtype=np.int64)
    idx_b = np.zeros((33, n, n), dtype=np.int64)
    w_a = np.zeros((33, n, n), dtype=np.int32)
    w_b = np.zeros((33, n, n), dtype=np.int32)
    for mi, mode in enumerate(range(2, 35)):
        angle = INTRA_PRED_ANGLE[mode]
        vertical = mode >= 18
        main_off = 0 if vertical else ln
        side_off = ln if vertical else 0
        ext = np.zeros(3 * n + 1, dtype=np.int64)  # refcat index per k
        off = n
        for j in range(0, 2 * n + 1):
            ext[off + j] = main_off + j
        if angle < 0:
            inv = INTRA_INV_ANGLE[mode]
            lowest = ((n * angle) >> 5) + 1
            for k in range(-1, lowest - 1, -1):
                ext[off + k] = side_off + ((k * inv + 128) >> 8)
        for y in range(n):
            i_idx = ((y + 1) * angle) >> 5
            i_fact = ((y + 1) * angle) & 31
            for x in range(n):
                a = ext[off + i_idx + 1 + x]
                b = ext[off + min(i_idx + 2 + x, 2 * n)]
                pos = (y, x) if vertical else (x, y)
                idx_a[(mi,) + pos] = a
                idx_b[(mi,) + pos] = b
                w_a[(mi,) + pos] = 32 - i_fact
                w_b[(mi,) + pos] = i_fact
    return idx_a, idx_b, w_a, w_b


@functools.lru_cache(maxsize=None)
def _filter_flags(n: int, is_luma: bool) -> tuple:
    return tuple(bool(should_filter(m, n, is_luma)) for m in range(35))


@functools.lru_cache(maxsize=None)
def _mode_table_host(n: int, is_luma: bool) -> np.ndarray:
    """K1's [3, 35] int32 table: angle, inverse angle, filtered-refs flag."""
    tab = np.zeros((3, 35), dtype=np.int32)
    for m in range(2, 35):
        tab[0, m] = INTRA_PRED_ANGLE[m]
        tab[1, m] = INTRA_INV_ANGLE.get(m, 0)
    tab[2] = _filter_flags(n, is_luma)
    return tab


_DEVICE_TABLES: dict = {}


def _mode_table(n: int, is_luma: bool, device) -> torch.Tensor:
    key = (n, is_luma, str(device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = torch.from_numpy(
            _mode_table_host(n, is_luma)).to(device)
    return _DEVICE_TABLES[key]


def _plain_tables(n: int, is_luma: bool, device) -> tuple:
    """The twin's gather tables on `device`: indices into [top | left |
    top_f | left_f] (the filtered half for the modes that smooth) and the
    two weights, each flattened [33 * n * n]."""
    key = ("plain", n, is_luma, str(device))
    if key not in _DEVICE_TABLES:
        idx_a, idx_b, w_a, w_b = _angular_tables(n)
        flags = _filter_flags(n, is_luma)
        shift = 2 * (2 * n + 1) * np.array(flags[2:])[:, None, None]
        _DEVICE_TABLES[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a.reshape(-1))).to(device)
            for a in (idx_a + shift, idx_b + shift, w_a, w_b))
    return _DEVICE_TABLES[key]


def _filter_refs(top: torch.Tensor, left: torch.Tensor):
    """[1 2 1]/4 smoothing of [B, 2N+1] refs; the far ends stay as they
    are and the corner mixes both sides."""
    tf = top.clone()
    lf = left.clone()
    tf[:, 1:-1] = (top[:, :-2] + 2 * top[:, 1:-1] + top[:, 2:] + 2) >> 2
    lf[:, 1:-1] = (left[:, :-2] + 2 * left[:, 1:-1] + left[:, 2:] + 2) >> 2
    corner = (left[:, 1] + 2 * top[:, 0] + top[:, 1] + 2) >> 2
    tf[:, 0] = corner
    lf[:, 0] = corner
    return tf, lf


def predict_plain(top: torch.Tensor, left: torch.Tensor, log2_size: int,
                  modes: torch.Tensor | None = None, is_luma: bool = True,
                  bit_depth: int = 8) -> torch.Tensor:
    """K1's twin: [B, M, N, N] int32 predictions, M = 35 (all modes in
    order) when `modes` is None, else modes [B, M] selects them."""
    n = 1 << log2_size
    b = top.shape[0]
    dev = top.device
    max_val = (1 << bit_depth) - 1
    top = top.to(torch.int32)
    left = left.to(torch.int32)
    flags = _filter_flags(n, is_luma)
    if any(flags):
        top_f, left_f = _filter_refs(top, left)
    else:
        top_f, left_f = top, left
    refs = torch.cat([top, left, top_f, left_f], dim=1)  # [B, 4(2n+1)]
    ia, ib, wa, wb = _plain_tables(n, is_luma, dev)
    if modes is not None:
        # only the selected modes' angular rows: [B, M, n * n] of the
        # tables (planar and DC read row 0, replaced below)
        modes = modes.to(torch.int64)
        m = modes.shape[1]
        rows = (modes - 2).clamp(0, 32)[:, :, None] * (n * n) + torch.arange(
            n * n, device=dev)
        ia, ib, wa, wb = (t[rows] for t in (ia, ib, wa, wb))
        ang = ((wa * refs.gather(1, ia.view(b, -1)).view(b, m, -1)
                + wb * refs.gather(1, ib.view(b, -1)).view(b, m, -1)
                + 16) >> 5).view(b, m, n, n)
    else:
        ang = ((wa * refs[:, ia] + wb * refs[:, ib] + 16) >> 5).view(
            b, 33, n, n)

    edge = is_luma and n < 32
    if edge:
        v_col = (top[:, 1:2] + ((left[:, 1:n + 1] - left[:, :1]) >> 1)
                 ).clamp(0, max_val)                       # [B, N] down x=0
        h_row = (left[:, 1:2] + ((top[:, 1:n + 1] - top[:, :1]) >> 1)
                 ).clamp(0, max_val)                       # [B, N] along y=0
        if modes is None:
            ang[:, 26 - 2, :, 0] = v_col
            ang[:, 10 - 2, 0, :] = h_row
        else:
            ang[:, :, :, 0] = torch.where((modes == 26)[:, :, None],
                                          v_col[:, None], ang[:, :, :, 0])
            ang[:, :, 0, :] = torch.where((modes == 10)[:, :, None],
                                          h_row[:, None], ang[:, :, 0, :])

    pt, pl = (top_f, left_f) if flags[0] else (top, left)
    xs = torch.arange(n, device=dev, dtype=torch.int32)
    ys = xs[:, None]
    planar = (((n - 1 - xs) * pl[:, 1:n + 1, None] + (xs + 1) * pt[:, n + 1,
                                                               None, None]
               + (n - 1 - ys) * pt[:, None, 1:n + 1]
               + (ys + 1) * pl[:, n + 1, None, None] + n) >> (log2_size + 1))

    dc = (top[:, 1:n + 1].sum(1, dtype=torch.int32)
          + left[:, 1:n + 1].sum(1, dtype=torch.int32) + n) >> (log2_size + 1)
    dcp = dc[:, None, None].expand(b, n, n).clone()
    if edge:
        dcp[:, 0, :] = (top[:, 1:n + 1] + 3 * dc[:, None] + 2) >> 2
        dcp[:, :, 0] = (left[:, 1:n + 1] + 3 * dc[:, None] + 2) >> 2
        dcp[:, 0, 0] = (left[:, 1] + 2 * dc + top[:, 1] + 2) >> 2
    if modes is None:
        return torch.cat([planar[:, None], dcp[:, None], ang], dim=1)
    sel = modes[:, :, None, None]
    return torch.where(sel == 0, planar[:, None],
                       torch.where(sel == 1, dcp[:, None], ang))


def predict(top: torch.Tensor, left: torch.Tensor, log2_size: int,
            modes: torch.Tensor | None = None, is_luma: bool = True,
            bit_depth: int = 8) -> torch.Tensor:
    """K1: [B, M, N, N] int32 predictions from [B, 2N+1] refs, all 35 modes
    in order when `modes` is None, else the modes [B, M] selects."""
    if not top.is_cuda:
        return predict_plain(top, left, log2_size, modes, is_luma, bit_depth)
    n = 1 << log2_size
    b = top.shape[0]
    top = top.to(torch.int32).contiguous()
    left = left.to(torch.int32).contiguous()
    if modes is not None:
        modes = modes.to(torch.int32).contiguous()
        tensors = (top, left, modes)
    else:
        tensors = (top, left)
    _build.require_cuda("intra_pred", *tensors, dtype=torch.int32)
    if top.shape != (b, 2 * n + 1) or left.shape != top.shape:
        raise ValueError("intra_pred: refs must be [B, 2N+1]")
    m = 35 if modes is None else modes.shape[1]
    out = torch.empty((b, m, n, n), dtype=torch.int32, device=top.device)
    tab = _mode_table(n, is_luma, top.device)
    rc = _build.lib().fhv_intra_pred(
        top.data_ptr(), left.data_ptr(),
        None if modes is None else modes.data_ptr(), tab.data_ptr(),
        out.data_ptr(), b, n, log2_size, m, int(is_luma and n < 32),
        (1 << bit_depth) - 1, _build.stream_handle(top))
    # the all-mode form (no route launches it) and the selected form (the
    # rd candidates, chroma DM) are counted apart
    _build.launched("intra_pred" if modes is None else "intra_pred_selected")
    _build.check(rc, "intra_pred")
    return out


def predict_satd_plain(top: torch.Tensor, left: torch.Tensor,
                       log2_size: int, src: torch.Tensor,
                       bit_depth: int = 8) -> torch.Tensor:
    """The fused form's twin: [B, 35] int32 SATD of src [B, N, N] against
    each luma mode's prediction."""
    return cost.satd_plain(src, predict_plain(top, left, log2_size, None,
                                              True, bit_depth))


def predict_satd(top: torch.Tensor, left: torch.Tensor, log2_size: int,
                 src: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """K1's fused form, the intra search's all-mode step (search.py:163):
    [B, 35] int32 SATD of src [B, N, N] against the 35 luma predictions
    from [B, 2N+1] refs; the predictions never reach device memory."""
    if not top.is_cuda:
        return predict_satd_plain(top, left, log2_size, src, bit_depth)
    n = 1 << log2_size
    b = top.shape[0]
    top = top.to(torch.int32).contiguous()
    left = left.to(torch.int32).contiguous()
    src = src.to(torch.int32).contiguous()
    _build.require_cuda("intra_satd", top, left, src, dtype=torch.int32)
    if (top.shape != (b, 2 * n + 1) or left.shape != top.shape
            or src.shape != (b, n, n) or not 2 <= log2_size <= 5):
        raise ValueError("intra_satd: refs [B, 2N+1], src [B, N, N], N in "
                         "4..32")
    out = torch.empty((b, 35), dtype=torch.int32, device=top.device)
    tab = _mode_table(n, True, top.device)
    rc = _build.lib().fhv_intra_satd(
        top.data_ptr(), left.data_ptr(), src.data_ptr(), tab.data_ptr(),
        out.data_ptr(), b, n, log2_size, int(n < 32), (1 << bit_depth) - 1,
        _build.stream_handle(top))
    _build.launched("intra_satd")
    _build.check(rc, "intra_satd")
    return out


def intra_rd_residuals_plain(top: torch.Tensor, left: torch.Tensor,
                             log2_size: int, src: torch.Tensor,
                             modes: torch.Tensor, is_luma: bool = True,
                             bit_depth: int = 8) -> torch.Tensor:
    """The rd form's twin given the modes: src [B, N, N] minus the
    prediction of each of modes [B, K], as [B * K, N, N] int32 in (block,
    mode) order."""
    n = 1 << log2_size
    cands = predict_plain(top, left, log2_size, modes, is_luma, bit_depth)
    return (src.to(torch.int32)[:, None] - cands).reshape(-1, n, n)


def intra_rd_cands_plain(top: torch.Tensor, left: torch.Tensor,
                         log2_size: int, src: torch.Tensor, d: torch.Tensor,
                         mode_bits: torch.Tensor, lambda_sqrt, kk: int,
                         bit_depth: int = 8) -> tuple:
    """The rd form's twin, the intra search's RD shortlist as the reference
    composes it (search.py:170-185): the RMD costs fma(lambda_sqrt,
    mode_bits, float(d)), rounded once as XLA contracts the reference's
    `d + lambda_sqrt * mode_bits`; the kk least, lower mode first among
    equal costs (a stable sort, jax.lax.top_k's order); their residuals.
    Returns (top_idx [B, kk] int32, cand_bits [B, kk] f32, residuals
    [B * kk, N, N] int32)."""
    ls = torch.as_tensor(lambda_sqrt, dtype=torch.float32)
    cost_rmd = cost.fma_f32(ls, mode_bits, d.to(torch.float32))
    top_idx = torch.sort(cost_rmd, dim=1, stable=True).indices[:, :kk]
    res = intra_rd_residuals_plain(top, left, log2_size, src, top_idx, True,
                                   bit_depth)
    return (top_idx.to(torch.int32),
            torch.take_along_dim(mode_bits, top_idx, dim=1), res)


def _rd_launch(top, left, log2_size, src, d, mode_bits, modes, ls, kk,
               is_luma, bit_depth):
    """One launch of K1's rd form (counter `intra_rd_cands`): the luma
    shortlist from d and mode_bits, or the residuals of the given modes."""
    n = 1 << log2_size
    b = top.shape[0]
    top = top.to(torch.int32).contiguous()
    left = left.to(torch.int32).contiguous()
    src = src.to(torch.int32).contiguous()
    if modes is not None:
        modes = modes.to(torch.int32).contiguous()
        _build.require_cuda("intra_rd_cands", top, left, src, modes)
    else:
        d = d.to(torch.int32).contiguous()
        mode_bits = mode_bits.to(torch.float32).contiguous()
        _build.require_cuda("intra_rd_cands", top, left, src, d, mode_bits)
    if (top.shape != (b, 2 * n + 1) or left.shape != top.shape
            or src.shape != (b, n, n) or not 2 <= log2_size <= 5
            or not 1 <= kk <= 35
            or (modes is not None and modes.shape != (b, kk))
            or (modes is None and (d.shape != (b, 35)
                                   or mode_bits.shape != (b, 35)))):
        raise ValueError("intra_rd_cands: refs [B, 2N+1], src [B, N, N], "
                         "N in 4..32, d and mode_bits [B, 35] or modes "
                         "[B, K], K in 1..35")
    dev = top.device
    res = torch.empty((b * kk, n, n), dtype=torch.int32, device=dev)
    top_idx = cand_bits = None
    if modes is None:
        top_idx = torch.empty((b, kk), dtype=torch.int32, device=dev)
        cand_bits = torch.empty((b, kk), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    tab = _mode_table(n, is_luma, dev)
    rc = _build.lib().fhv_intra_rd_cands(
        top.data_ptr(), left.data_ptr(), src.data_ptr(), ptr(d),
        ptr(mode_bits), ptr(modes), tab.data_ptr(), ptr(top_idx),
        ptr(cand_bits), res.data_ptr(), b, n,
        kk, int(is_luma and n < 32), (1 << bit_depth) - 1, ls,
        _build.stream_handle(top))
    _build.launched("intra_rd_cands")
    _build.check(rc, "intra_rd_cands")
    return top_idx, cand_bits, res


def intra_rd_cands(top: torch.Tensor, left: torch.Tensor, log2_size: int,
                   src: torch.Tensor, d: torch.Tensor,
                   mode_bits: torch.Tensor, lambda_sqrt, kk: int,
                   bit_depth: int = 8) -> tuple:
    """K1's rd form, the intra search's RD shortlist (search.py:170-185):
    from the fused form's SATDs d [B, 35] int32 and the MPM mode bits [B,
    35] f32 of luma blocks src [B, N, N] with [B, 2N+1] refs, the kk least
    costs fma(lambda_sqrt, mode_bits, float(d)), lower mode first among
    equal costs.  Returns (top_idx [B, kk] int32, cand_bits [B, kk] f32,
    residuals src - prediction [B * kk, N, N] int32); no prediction
    reaches device memory."""
    if not top.is_cuda:
        return intra_rd_cands_plain(top, left, log2_size, src, d, mode_bits,
                                    lambda_sqrt, kk, bit_depth)
    ls = float(torch.as_tensor(lambda_sqrt, dtype=torch.float32))
    return _rd_launch(top, left, log2_size, src, d, mode_bits, None, ls, kk,
                      True, bit_depth)


def intra_rd_residuals(top: torch.Tensor, left: torch.Tensor,
                       log2_size: int, src: torch.Tensor,
                       modes: torch.Tensor, is_luma: bool = True,
                       bit_depth: int = 8) -> torch.Tensor:
    """K1's rd form given the modes [B, K] (the chroma DM cost's, K = 1):
    the residuals src [B, N, N] - prediction as [B * K, N, N] int32, one
    launch counted as `intra_rd_cands`."""
    if not top.is_cuda:
        return intra_rd_residuals_plain(top, left, log2_size, src, modes,
                                        is_luma, bit_depth)
    return _rd_launch(top, left, log2_size, src, None, None, modes, 0.0,
                      modes.shape[1], is_luma, bit_depth)[2]


def predict_all_modes(top: torch.Tensor, left: torch.Tensor, log2_size: int,
                      is_luma: bool = True,
                      bit_depth: int = 8) -> torch.Tensor:
    """All 35 intra predictions: [B, 2N+1] refs -> [B, 35, N, N] int32."""
    return predict(top, left, log2_size, None, is_luma, bit_depth)


def predict_selected(top: torch.Tensor, left: torch.Tensor, log2_size: int,
                     modes: torch.Tensor, is_luma: bool = True,
                     bit_depth: int = 8) -> torch.Tensor:
    """One intra prediction per block: modes [B] -> [B, N, N] int32."""
    return predict(top, left, log2_size, modes.reshape(-1, 1), is_luma,
                   bit_depth)[:, 0]


def grid_refs(plane: torch.Tensor, n: int):
    """Top/left references of every aligned n x n block, taken from the
    plane's own pixels with edge replication at the picture border.

    plane: [H, W] or [F, H, W] int32 (H, W multiples of n).  Returns (top,
    left), each [(F *) H/n * W/n, 2n+1] in (frame and) block raster order.
    """
    squeeze = plane.dim() == 2
    p = plane[None] if squeeze else plane
    f, h, w = p.shape
    gy, gx = h // n, w // n
    padded = F.pad(p[:, None].float(), (1, 3 * n, 1, 3 * n),
                   mode="replicate")[:, 0].to(torch.int32)
    rows = padded[:, 0:h:n, :]                       # [F, gy, w + 3n + 1]
    top = rows.unfold(2, 2 * n + 1, n)[:, :, :gx]    # [F, gy, gx, 2n+1]
    cols = padded[:, :, 0:w:n].transpose(1, 2)       # [F, gx, h + 3n + 1]
    left = cols.unfold(2, 2 * n + 1, n)[:, :, :gy].transpose(1, 2)
    return (top.reshape(f * gy * gx, 2 * n + 1).contiguous(),
            left.reshape(f * gy * gx, 2 * n + 1).contiguous())
