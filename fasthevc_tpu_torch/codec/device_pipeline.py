"""Device pipeline: search, exact commit and in-loop filters of a frame
group on the card; the host emits CABAC only.

Counterpart of fasthevc_tpu/codec/device_pipeline.py.  `encode_group_device`
(intra frames): the batched intra search (K1-K4), the wavefront commit with
the parallel RDOQ trellis (K5), deblocking (K6), SAO (K7) and the recon's
uint8 cast with the Annex D checksum (K8), enqueued on the current stream
for the whole group.
`encode_inter_group_device` (P or B frames): the P or B search (K1-K4 for
its intra candidates, K9 integer ME, K10 sub-pel, K11 merge-candidate MC,
K12 the bi-prediction cost of B), exact MC of the decided motion (K11,
bi-predicted where B chose it), the mixed wavefront commit (K5),
deblocking with both lists' boundary strengths (K6), SAO and the
checksum.  On the fast-partition path the partition CNN (K13) runs once
per batch and its depth maps replace the search's splits.  The JAX
package's int8 level packing with its overflow flag and its search
micro-batches exist for the TPU's host link and memory; the port returns
the int16 levels and runs the search over the whole group.
"""

from __future__ import annotations

import torch

from .. import _build
from ..ops.commit import wavefront_commit_intra, wavefront_commit_mixed
from ..ops.deblock import deblock_fused, tu_cbf_ctu
from ..ops.me import inter_pred_planes
from ..ops.sao import sao
from .search import search_b_maps, search_intra_maps_batch, search_p_maps


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
    CUDA tensors go through K8's earlier form (a launch a plane) unless
    `plain`."""
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
    _build.launched("checksum")
    _build.check(rc, "checksum")
    return out.to(torch.int64) & 0xFFFFFFFF


def cast_checksum_plain(rec_y, rec_cb, rec_cr, checksum: bool = True):
    """K8's cast form's twin: the three uint8 casts, then (with `checksum`)
    each plane's checksum, cksum [F, 3] int64 (else None)."""
    planes = tuple(p.to(torch.uint8).contiguous()
                   for p in (rec_y, rec_cb, rec_cr))
    cksum = (torch.stack([device_checksum_plain(p) for p in planes], dim=1)
             if checksum else None)
    return planes + (cksum,)


def cast_checksum(rec_y, rec_cb, rec_cr, checksum: bool = True,
                  plain: bool = False):
    """The recon's uint8 planes and their Annex D.3.19 checksums, the tail
    of the reference's batch program (device_pipeline.py:122-126): int32
    rec_* [F, H, W] (chroma halved; column slices of wider planes taken
    as they lie) -> (y, cb, cr) uint8 contiguous and cksum [F, 3] int64
    in [0, 2^32), or None without `checksum`.  CUDA tensors go through
    K8's cast form, one launch a call (`cast_checksum`, or `cast` when it
    only casts), unless `plain`."""
    if plain or not rec_y.is_cuda:
        return cast_checksum_plain(rec_y, rec_cb, rec_cr, checksum)
    planes = (rec_y, rec_cb, rec_cr)
    if any(p.device != rec_y.device or p.dtype != torch.int32
           for p in planes):
        raise ValueError("cast_checksum: int32 planes on one CUDA device")
    f, h, w = rec_y.shape
    if h % 2 or w % 8 or any(p.shape != (f, h // 2, w // 2)
                             for p in planes[1:]):
        raise ValueError("cast_checksum: planes [F, H, W] and [F, H/2, "
                         "W/2], W a multiple of 8")
    for p in planes:
        if (p.stride(2) != 1 or p.stride(1) % 4 or p.stride(0) % 4
                or p.data_ptr() % 16):
            raise ValueError("cast_checksum: rows of 16-byte aligned "
                             "vectors of 4 samples")
    outs = tuple(torch.empty(p.shape, dtype=torch.uint8, device=p.device)
                 for p in planes)
    cksum = (torch.empty((f, 3), dtype=torch.int64, device=rec_y.device)
             if checksum else None)
    rc = _build.lib().fhv_cast_checksum(
        *(p.data_ptr() for p in planes), *(o.data_ptr() for o in outs),
        None if cksum is None else cksum.data_ptr(),
        *(p.stride(1) for p in planes), *(p.stride(0) for p in planes), f,
        h, w, _build.stream_handle(rec_y))
    name = "cast_checksum" if checksum else "cast"
    _build.launched(name)
    _build.check(rc, name)
    return outs + (cksum,)


def _lam(lambda_sqrt: float) -> float:
    """The trellis' lambda, rounded as the reference rounds it (f32)."""
    ls = torch.tensor(lambda_sqrt, dtype=torch.float32)
    return float(ls * ls)


def _filter_and_pack(sy, scb, scr, dm, packed, committed, qp_deblock,
                     qp_cb, qp_cr, log2_ctu: int, deblock_on: bool,
                     sao_on: bool, checksum: bool, plain: bool,
                     inter_maps=None) -> dict:
    """Deblock, SAO, uint8 cast and checksum of committed frames; the
    output dict of encode_group_device.  inter_maps: (dir, mv, ref)
    granule maps of P/B frames, whose boundary strengths the deblocking
    works out."""
    ry, rcb, rcr, lv_y, lv_cb, lv_cr = committed
    f = sy.shape[0]
    coded_h, coded_w = sy.shape[1:]
    if deblock_on:
        bs_kw = {}
        if inter_maps is not None:
            bs_kw = dict(dir_map=inter_maps[0], mv_map=inter_maps[1],
                         ref_map=inter_maps[2],
                         cbf=tu_cbf_ctu(lv_y, dm, log2_ctu, plain=plain))
        ry, rcb, rcr = deblock_fused(ry, rcb, rcr, dm, qp_deblock, qp_cb,
                                     qp_cr, log2_ctu, plain=plain, **bs_kw)
    if sao_on:
        ry, rcb, rcr, sao_params = sao(sy, scb, scr, ry, rcb, rcr, log2_ctu,
                                       plain=plain)
    else:
        ctb = 1 << log2_ctu
        sao_params = torch.zeros((f, -(-coded_h // ctb), -(-coded_w // ctb),
                                  3, 7), dtype=torch.int32, device=sy.device)
    rec_y, rec_cb, rec_cr, cksum = cast_checksum(ry, rcb, rcr, checksum,
                                                 plain=plain)
    out = dict(packed=packed, lv_y=lv_y.contiguous(),
               lv_cb=lv_cb.contiguous(), lv_cr=lv_cr.contiguous(),
               rec_y=rec_y, rec_cb=rec_cb, rec_cr=rec_cr, sao=sao_params)
    if checksum:
        out["cksum"] = cksum
    return out


def encode_group_device(y, cb, cr, lambda_sqrt: float, qp_y: int, qp_cb: int,
                        qp_cr: int, qp_for_deblock: int, log2_ctu: int,
                        log2_min_cu: int, coded_w: int, coded_h: int,
                        sdh: bool, deblock_on: bool, sao_on: bool,
                        tile_bounds_x: tuple = (), tile_bounds_y: tuple = (),
                        rd_cands: int = 3, rdoq: bool = False,
                        checksum: bool = True, plain: bool = False,
                        cnn=None, qp: int = 0) -> dict:
    """Search + exact commit + filters for F intra frames.

    y: [F, PH, PW] uint8 (CTU-padded), cb/cr: [F, PH/2, PW/2].  Returns a
    dict of tensors on y's device: packed [F, PH/8, PW/8, 9] int16 maps,
    lv_y/lv_cb/lv_cr int16 levels and rec_y/rec_cb/rec_cr uint8 recon in
    coded dims, sao [F, ny, nx, 3, 7] int32 (zeros when SAO is off) and,
    with `checksum`, cksum [F, 3] int64.  plain=True runs every kernel's
    twin instead.  cnn, qp: the partition CNN of the fast-partition path
    and the qp it is fed (device_pipeline.py:78-95)."""
    gh, gw = coded_h >> 3, coded_w >> 3
    packed = search_intra_maps_batch(
        y, lambda_sqrt, log2_ctu, log2_min_cu, coded_w, coded_h,
        cb_batch=cb, cr_batch=cr, rd_cands=rd_cands, plain=plain, cnn=cnn,
        qp=qp)
    dm = packed[:, :gh, :gw, 0].to(torch.int32)
    mm = packed[:, :gh, :gw, 1].to(torch.int32)
    ch, cw = coded_h // 2, coded_w // 2
    sy = y[:, :coded_h, :coded_w].to(torch.int32)
    scb = cb[:, :ch, :cw].to(torch.int32)
    scr = cr[:, :ch, :cw].to(torch.int32)
    committed = wavefront_commit_intra(
        sy, scb, scr, dm, mm, qp_y, qp_cb, qp_cr, coded_w, coded_h, sdh,
        tile_bounds_x, tile_bounds_y, rdoq=rdoq, lam=_lam(lambda_sqrt),
        plain=plain)
    return _filter_and_pack(sy, scb, scr, dm, packed, committed,
                            qp_for_deblock, qp_cb, qp_cr, log2_ctu,
                            deblock_on, sao_on, checksum, plain)


def encode_inter_group_device(y, cb, cr, r0_y, r0_cb, r0_cr, lambda_sqrt,
                              qp_y, qp_cb, qp_cr, qp_for_deblock,
                              log2_ctu: int, log2_min_cu: int, coded_w: int,
                              coded_h: int, sdh: bool, deblock_on: bool,
                              sao_on: bool, search_range: int,
                              tile_bounds_x: tuple = (),
                              tile_bounds_y: tuple = (), rd_cands: int = 3,
                              nref0=None, rdoq: bool = False,
                              checksum: bool = True, plain: bool = False,
                              r1=None, nref1=None, cnn=None,
                              qp: int = 0) -> dict:
    """Search + MC + mixed exact commit + filters for F P frames, or F B
    frames when r1 is given (device_pipeline.py:170).

    y: [F, PH, PW] uint8 CTU-padded sources, cb/cr [F, PH/2, PW/2];
    r0_*: [F, 2, coded_h, coded_w] (chroma halved) uint8 list-0 reference
    stacks from the on-device DPB (the second duplicates the first when
    the frame has one reference, and nref0 says so); r1: the (y, cb, cr)
    list-1 stacks of B frames, masked by nref1 alike.  lambda_sqrt, qp_y,
    qp_cb, qp_cr, qp_for_deblock, nref0 and nref1 are per-frame sequences,
    so a batch may mix temporal layers.  The trellis tables are those of
    init_type 1 for B frames too, as the reference builds them
    (commit.py:590), although CABAC codes B slices with init_type 2.
    cnn, qp: the partition CNN and the one qp it is fed for the whole
    batch (device_pipeline.py:180-241).  Returns the dict of
    encode_group_device."""
    f, ph, pw = y.shape
    gh, gw = coded_h >> 3, coded_w >> 3
    nref0 = [2] * f if nref0 is None else [int(v) for v in nref0]
    lams = [float(v) for v in lambda_sqrt]

    def pad(r):
        # the search runs on the padded source against the references
        # edge-padded to it (device_pipeline.py:209-214)
        return torch.nn.functional.pad(
            r.to(torch.int32), (0, pw - coded_w, 0, ph - coded_h),
            mode="replicate")

    common = dict(rd_cands=rd_cands, plain=plain, cnn=cnn, qp=qp)
    if r1 is None:
        packed = search_p_maps(y, pad(r0_y), lams, log2_ctu, log2_min_cu,
                               coded_w, coded_h, search_range, nref=nref0,
                               **common)
        ref1 = None
    else:
        nref1 = [2] * f if nref1 is None else [int(v) for v in nref1]
        packed = search_b_maps(y, pad(r0_y), pad(r1[0]), lams, log2_ctu,
                               log2_min_cu, coded_w, coded_h, search_range,
                               nref0=nref0, nref1=nref1, **common)
        ref1 = tuple(r.to(torch.int32) for r in r1)
    dm = packed[:, :gh, :gw, 0].to(torch.int32)
    mm = packed[:, :gh, :gw, 1].to(torch.int32)
    im = packed[:, :gh, :gw, 2].to(torch.int32)
    mv = packed[:, :gh, :gw, 3:7].to(torch.int32)
    rmap = packed[:, :gh, :gw, 7:9].to(torch.int32)
    ch, cw = coded_h // 2, coded_w // 2
    sy = y[:, :coded_h, :coded_w].to(torch.int32)
    scb = cb[:, :ch, :cw].to(torch.int32)
    scr = cr[:, :ch, :cw].to(torch.int32)
    ipy, ipcb, ipcr = inter_pred_planes(
        tuple(r.to(torch.int32) for r in (r0_y, r0_cb, r0_cr)), ref1, im,
        mv, ref_map=rmap, plain=plain)
    committed = wavefront_commit_mixed(
        sy, scb, scr, dm, mm, im, ipy, ipcb, ipcr, qp_y, qp_cb, qp_cr,
        coded_w, coded_h, sdh, tile_bounds_x, tile_bounds_y, rdoq=rdoq,
        lam=[_lam(v) for v in lams], plain=plain)
    return _filter_and_pack(sy, scb, scr, dm, packed, committed,
                            qp_for_deblock, qp_cb, qp_cr, log2_ctu,
                            deblock_on, sao_on, checksum, plain,
                            inter_maps=(im, mv, rmap))
