"""All-intra device pipeline: search, exact commit and in-loop filters of a
frame group on the card; the host emits CABAC only.

Counterpart of fasthevc_tpu/codec/device_pipeline.py `encode_group_device`:
the batched intra search (K1-K4), the wavefront commit with the parallel
RDOQ trellis (K5), deblocking (K6), SAO (K7) and the Annex D checksum
(K8), enqueued on the current stream for the whole group.  The JAX
package's int8 level packing with its overflow flag and its search
micro-batches exist for the TPU's host link and memory; the port returns
the int16 levels and runs the search over the whole group.
"""

from __future__ import annotations

import torch

from .. import _build
from ..ops.commit import wavefront_commit_intra
from ..ops.deblock import deblock
from ..ops.sao import sao
from .search import search_intra_maps_batch


def device_path_ok(cfg, sp) -> bool:
    """The configurations the device route takes (copy of
    device_pipeline.py:47): CTU 32, 8-bit, no lossless, no weighted
    prediction."""
    return (sp.log2_ctu == 5 and sp.bit_depth == 8 and not cfg.lossless
            and not getattr(cfg, "weighted_pred", False))


_MASKS: dict = {}


def _position_mask(h: int, w: int, device) -> torch.Tensor:
    key = (h, w, str(device))
    if key not in _MASKS:
        xs = torch.arange(w, device=device)
        ys = torch.arange(h, device=device)
        _MASKS[key] = ((xs[None, :] & 0xFF) ^ (ys[:, None] & 0xFF)
                       ^ (xs[None, :] >> 8) ^ (ys[:, None] >> 8))
    return _MASKS[key]


def device_checksum_plain(planes: torch.Tensor) -> torch.Tensor:
    """K8's twin: the Annex D.3.19 checksum of [F, H, W] uint8 planes,
    int64 [F] in [0, 2^32) (sum of samples XOR the position mask, mod
    2^32)."""
    h, w = planes.shape[-2:]
    vals = planes.to(torch.int64) ^ _position_mask(h, w, planes.device)
    return vals.sum(dim=(-2, -1)) & 0xFFFFFFFF


def device_checksum(planes: torch.Tensor, plain: bool = False):
    """Annex D.3.19 hash_type 2 checksum of each of F uint8 planes
    [F, H, W] (twin of device_pipeline.py:55 `_device_checksum`): int64 [F].
    CUDA tensors go through K8 unless `plain`."""
    if plain or not planes.is_cuda:
        return device_checksum_plain(planes)
    return _checksum_cuda(planes)


def _checksum_cuda(planes: torch.Tensor) -> torch.Tensor:
    planes = planes.contiguous()
    _build.require_cuda("checksum", planes, dtype=torch.uint8)
    f, h, w = planes.shape
    out = torch.zeros(f, dtype=torch.int32, device=planes.device)
    rc = _build.lib().fhv_checksum(planes.data_ptr(), out.data_ptr(), f, h, w,
                                   _build.stream_handle(planes))
    _build.LAUNCHES["checksum"] += 1
    _build.check(rc, "checksum")
    return out.to(torch.int64) & 0xFFFFFFFF


def encode_group_device(y, cb, cr, lambda_sqrt: float, qp_y: int, qp_cb: int,
                        qp_cr: int, qp_for_deblock: int, log2_ctu: int,
                        log2_min_cu: int, coded_w: int, coded_h: int,
                        sdh: bool, deblock_on: bool, sao_on: bool,
                        tile_bounds_x: tuple = (), tile_bounds_y: tuple = (),
                        rd_cands: int = 3, rdoq: bool = False,
                        checksum: bool = True, plain: bool = False) -> dict:
    """Search + exact commit + filters for F frames.

    y: [F, PH, PW] uint8 (CTU-padded), cb/cr: [F, PH/2, PW/2].  Returns a
    dict of tensors on y's device: packed [F, PH/8, PW/8, 9] int16 maps,
    lv_y/lv_cb/lv_cr int16 levels and rec_y/rec_cb/rec_cr uint8 recon in
    coded dims, sao [F, ny, nx, 3, 7] int32 (zeros when SAO is off) and,
    with `checksum`, cksum [F, 3] int64.  plain=True runs every kernel's
    twin instead."""
    gh, gw = coded_h >> 3, coded_w >> 3
    packed = search_intra_maps_batch(
        y, lambda_sqrt, log2_ctu, log2_min_cu, coded_w, coded_h,
        cb_batch=cb, cr_batch=cr, rd_cands=rd_cands, plain=plain)
    dm = packed[:, :gh, :gw, 0].to(torch.int32)
    mm = packed[:, :gh, :gw, 1].to(torch.int32)
    ch, cw = coded_h // 2, coded_w // 2
    sy = y[:, :coded_h, :coded_w].to(torch.int32)
    scb = cb[:, :ch, :cw].to(torch.int32)
    scr = cr[:, :ch, :cw].to(torch.int32)
    # the trellis' lambda, rounded as the reference rounds it
    ls = torch.tensor(lambda_sqrt, dtype=torch.float32)
    lam = float(ls * ls)
    ry, rcb, rcr, lv_y, lv_cb, lv_cr = wavefront_commit_intra(
        sy, scb, scr, dm, mm, qp_y, qp_cb, qp_cr, coded_w, coded_h, sdh,
        tile_bounds_x, tile_bounds_y, rdoq=rdoq, lam=lam, plain=plain)
    if deblock_on:
        ry, rcb, rcr = deblock(ry, rcb, rcr, dm, qp_for_deblock, qp_cb, qp_cr,
                               log2_ctu, plain=plain)
    if sao_on:
        ry, rcb, rcr, sao_params = sao(sy, scb, scr, ry, rcb, rcr, log2_ctu,
                                       plain=plain)
    else:
        ctb = 1 << log2_ctu
        sao_params = torch.zeros((y.shape[0], -(-coded_h // ctb),
                                  -(-coded_w // ctb), 3, 7),
                                 dtype=torch.int32, device=y.device)
    out = dict(packed=packed, lv_y=lv_y.contiguous(),
               lv_cb=lv_cb.contiguous(), lv_cr=lv_cr.contiguous(),
               rec_y=ry.to(torch.uint8).contiguous(),
               rec_cb=rcb.to(torch.uint8).contiguous(),
               rec_cr=rcr.to(torch.uint8).contiguous(), sao=sao_params)
    if checksum:
        out["cksum"] = torch.stack(
            [device_checksum(out[k], plain=plain)
             for k in ("rec_y", "rec_cb", "rec_cr")], dim=1)
    return out
