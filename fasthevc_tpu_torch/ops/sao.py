"""Sample-adaptive offset: per-CTB estimation and the decoder-exact apply
(spec 8.7.3).

Counterpart of fasthevc_tpu/ops/sao.py `sao_device` (without the tile
halo, which belongs to the multi-device port).  `sao` goes through kernel
K7 (csrc/sao.cu: `fhv_sao_stats`, one CTA per frame and CTB, then
`fhv_sao_apply`, one thread per sample) for CUDA tensors; `sao_plain` is
its PyTorch twin.

Estimation reproduces the reference's choices exactly: categories are
classified on the CTB-padded plane (zeros beyond the coded picture, the
picture-boundary rule at the padded bounds), statistics are exact integer
counts and sums of src - rec, offsets are round(|s|/n) in f32 clipped to
+-7, gains are int32, ties keep the first index, and Cr inherits Cb's
type and class.  The apply classifies against the coded bounds.
"""

from __future__ import annotations

import torch

from .. import _build

MAX_OFFSET = 7
# EO class -> (y0, x0, y1, x1) neighbour offsets (spec table 8-9 order)
EO_NEIGHBORS = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1), (1, -1, -1, 1))


def _edge_cats(p: torch.Tensor, h_lim: int, w_lim: int) -> torch.Tensor:
    """Category maps (0..4) of all 4 EO classes of [F, H, W]: [F, 4, H, W].
    A sample whose neighbour lies outside [0, h_lim) x [0, w_lim) is
    category 0 (twin of sao.py:33)."""
    f, h, w = p.shape
    dev = p.device
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    out = []
    for (y0, x0, y1, x1) in EO_NEIGHBORS:
        n0 = p[:, (ys + y0).clamp(0, h - 1)][:, :, (xs + x0).clamp(0, w - 1)]
        n1 = p[:, (ys + y1).clamp(0, h - 1)][:, :, (xs + x1).clamp(0, w - 1)]
        raw = 2 + torch.sign(p - n0) + torch.sign(p - n1)
        cat = torch.where(raw == 2, 0, torch.where(raw < 2, raw + 1, raw))
        ty, by = max(0, -y0, -y1), max(0, y0, y1)
        lx, rx = max(0, -x0, -x1), max(0, x0, x1)
        inside = (((ys >= ty) & (ys < h_lim - by))[:, None]
                  & ((xs >= lx) & (xs < w_lim - rx))[None, :])
        out.append(torch.where(inside, cat, 0))
    return torch.stack(out, dim=1)


def _ctb_sum(x: torch.Tensor, ctb: int) -> torch.Tensor:
    """[..., H, W] -> [..., H/ctb, W/ctb] block sums."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    return x.reshape(lead + (h // ctb, ctb, w // ctb, ctb)).sum(dim=(-3, -1))


def _round_div(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """clip(round(s/n), +-MAX_OFFSET), half away from zero, in f32; 0 where
    n == 0 (twin of sao.py:91)."""
    s = s.to(torch.float32)
    n = n.to(torch.float32)
    o = torch.sign(s) * torch.floor(s.abs() / n.clamp_min(1.0) + 0.5)
    o = torch.where(n > 0, o, torch.zeros_like(o))
    return o.clamp(-MAX_OFFSET, MAX_OFFSET).to(torch.int64)


def _pad_to(x: torch.Tensor, ctb: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    return torch.nn.functional.pad(x, (0, -(-w // ctb) * ctb - w, 0,
                                       -(-h // ctb) * ctb - h))


def _estimate_plane(src, rec, ctb: int, bit_depth: int, given=None):
    """Per-CTB SAO parameters [F, ny, nx, 7] = (type, eo_class, band_pos,
    off0..3) of one plane [F, H, W] (twin of sao.py:109).  given: the
    (type, class) maps [F, ny, nx] to inherit (the Cr plane)."""
    f, h, w = src.shape
    dev = src.device
    srcp = _pad_to(src.to(torch.int64), ctb)
    recp = _pad_to(rec.to(torch.int64), ctb)
    ph, pw = srcp.shape[-2:]
    valid = ((torch.arange(ph, device=dev) < h)[:, None]
             & (torch.arange(pw, device=dev) < w)[None, :])
    diff = torch.where(valid, srcp - recp, 0)                 # [F, ph, pw]
    cats = torch.where(valid, _edge_cats(recp, ph, pw), 0)     # [F,4,ph,pw]

    onehot = (cats[:, :, None] == torch.arange(1, 5, device=dev)
              [None, None, :, None, None]).long()              # [F,4,4,..]
    cnt_e = _ctb_sum(onehot, ctb)                              # [F,4,4,ny,nx]
    sum_e = _ctb_sum(onehot * diff[:, None, None], ctb)
    off_e = _round_div(sum_e, cnt_e)
    off_e = torch.stack([off_e[:, :, 0].clamp_min(0),
                         off_e[:, :, 1].clamp_min(0),
                         off_e[:, :, 2].clamp_max(0),
                         off_e[:, :, 3].clamp_max(0)], dim=2)
    gain_e = (2 * off_e * sum_e - off_e * off_e * cnt_e).sum(dim=2)  # [F,4,.]

    band = torch.where(valid, recp >> (bit_depth - 5), 32)
    onehot_b = (band[:, None] == torch.arange(32, device=dev)
                [None, :, None, None]).long()                  # [F,32,ph,pw]
    cnt_b = _ctb_sum(onehot_b, ctb)
    sum_b = _ctb_sum(onehot_b * diff[:, None], ctb)
    off_b = _round_div(sum_b, cnt_b)                           # [F,32,ny,nx]
    gain_b = 2 * off_b * sum_b - off_b * off_b * cnt_b
    run = (gain_b[:, 0:29] + gain_b[:, 1:30] + gain_b[:, 2:31]
           + gain_b[:, 3:32])
    band_pos = torch.argmax(run, dim=1)            # first index on ties
    band_gain = run.max(dim=1).values

    if given is None:
        eo_cls = torch.argmax(gain_e, dim=1)
        eo_gain = gain_e.max(dim=1).values
        use_band = band_gain > eo_gain.clamp_min(0)
        use_edge = (~use_band) & (eo_gain > 0)
        type_map = torch.where(use_band, 1, torch.where(use_edge, 2, 0))
        class_map = torch.where(use_edge, eo_cls, 0)
    else:
        type_map, class_map = given
        use_band = type_map == 1
        use_edge = type_map == 2

    eo_sel = torch.take_along_dim(
        off_e, class_map[:, None, None].expand(-1, 1, 4, -1, -1),
        dim=1)[:, 0]                                           # [F,4,ny,nx]
    pos = band_pos[:, None] + torch.arange(4, device=dev)[None, :, None, None]
    band_sel = torch.take_along_dim(off_b, pos, dim=1)         # [F,4,ny,nx]
    offs = torch.where(use_band[:, None], band_sel,
                       torch.where(use_edge[:, None], eo_sel, 0))
    return torch.stack([type_map, torch.where(use_edge, class_map, 0),
                        torch.where(use_band, band_pos, 0),
                        offs[:, 0], offs[:, 1], offs[:, 2], offs[:, 3]],
                       dim=-1)


def _apply_plane(rec, params, ctb: int, bit_depth: int):
    """Decoder-exact SAO of [F, H, W] with params [F, ny, nx, 7] (twin of
    sao.py:199)."""
    f, h, w = rec.shape
    dev = rec.device
    r = rec.to(torch.int64)
    cats = _edge_cats(r, h, w)                                 # [F,4,H,W]

    def up(a):
        return a.repeat_interleave(ctb, 1).repeat_interleave(ctb, 2)[:, :h,
                                                                      :w]

    type_m = up(params[..., 0])
    class_m = up(params[..., 1])
    band_pos = up(params[..., 2])
    offs = [up(params[..., 3 + i]) for i in range(4)]
    sel_cat = torch.take_along_dim(cats, class_m[:, None], dim=1)[:, 0]
    add = torch.zeros_like(r)
    for c in range(1, 5):
        add = add + torch.where((type_m == 2) & (sel_cat == c), offs[c - 1],
                                0)
    band = r >> (bit_depth - 5)
    for i in range(4):
        add = add + torch.where((type_m == 1) & (band == (band_pos + i) % 32),
                                offs[i], 0)
    return (r + add).clamp(0, (1 << bit_depth) - 1).to(torch.int32)


def sao_plain(src_y, src_cb, src_cr, rec_y, rec_cb, rec_cr, log2_ctu: int,
              bit_depth: int = 8):
    """K7's twin; arguments and result as `sao`."""
    ctb = 1 << log2_ctu
    p_y = _estimate_plane(src_y, rec_y, ctb, bit_depth)
    p_cb = _estimate_plane(src_cb, rec_cb, ctb // 2, bit_depth)
    # Cr inherits Cb's type/eo_class (spec: one type for both chroma)
    p_cr = _estimate_plane(src_cr, rec_cr, ctb // 2, bit_depth,
                           given=(p_cb[..., 0], p_cb[..., 1]))
    return (_apply_plane(rec_y, p_y, ctb, bit_depth),
            _apply_plane(rec_cb, p_cb, ctb // 2, bit_depth),
            _apply_plane(rec_cr, p_cr, ctb // 2, bit_depth),
            torch.stack([p_y, p_cb, p_cr], dim=-2).to(torch.int32))


def sao(src_y, src_cb, src_cr, rec_y, rec_cb, rec_cr, log2_ctu: int,
        bit_depth: int = 8, plain: bool = False):
    """SAO estimate + apply for F pictures: src_*/rec_* [F, H, W] (chroma
    halved), rec_* deblocked.  Returns (out_y, out_cb, out_cr, params):
    int32 planes and params int32 [F, ny, nx, 3, 7] per CTB and component
    (type 0/1/2 = off/band/edge, eo_class, band_pos, off0..3).  CUDA
    tensors go through K7 unless `plain`."""
    if plain or not rec_y.is_cuda:
        return sao_plain(src_y, src_cb, src_cr, rec_y, rec_cb, rec_cr,
                         log2_ctu, bit_depth)
    return _sao_cuda(src_y, src_cb, src_cr, rec_y, rec_cb, rec_cr, log2_ctu,
                     bit_depth)


def _sao_cuda(src_y, src_cb, src_cr, rec_y, rec_cb, rec_cr, log2_ctu,
              bit_depth):
    i32 = torch.int32
    srcs = [p.to(i32).contiguous() for p in (src_y, src_cb, src_cr)]
    recs = [p.to(i32).contiguous() for p in (rec_y, rec_cb, rec_cr)]
    _build.require_cuda("sao", *srcs, *recs, dtype=i32)
    f, h, w = recs[0].shape
    if srcs[0].shape != (f, h, w):
        raise ValueError("sao: src and rec planes differ in shape")
    if any(p.shape != (f, h // 2, w // 2) for p in srcs[1:] + recs[1:]):
        raise ValueError("sao: chroma planes must be [F, H/2, W/2]")
    ctb = 1 << log2_ctu
    ny, nx = -(-h // ctb), -(-w // ctb)
    params = torch.empty((f, ny, nx, 3, 7), dtype=i32, device=recs[0].device)
    outs = [torch.empty_like(p) for p in recs]
    lib = _build.lib()
    stream = _build.stream_handle(params)
    rc = lib.fhv_sao_stats(*(p.data_ptr() for p in srcs),
                           *(p.data_ptr() for p in recs), params.data_ptr(),
                           f, h, w, log2_ctu, bit_depth, stream)
    _build.LAUNCHES["sao"] += 1
    _build.check(rc, "sao_stats")
    rc = lib.fhv_sao_apply(*(p.data_ptr() for p in recs),
                           *(p.data_ptr() for p in outs), params.data_ptr(),
                           f, h, w, log2_ctu, bit_depth, stream)
    _build.LAUNCHES["sao"] += 1
    _build.check(rc, "sao_apply")
    return outs[0], outs[1], outs[2], params
