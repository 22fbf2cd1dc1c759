"""The tile-column halo exchange of the sharded pipelines.

Counterpart of fasthevc_tpu/parallel/sharded.py `_ppermute_halo`: a tile
shard's planes extended by the left neighbour's last wl columns and the
right neighbour's first wr columns, a shard at a picture bound repeating
its own edge column instead.  `halo_extend` goes through kernel K16
(csrc/halo.cu, one launch for a set of planes of any element size) for CUDA
tensors; `halo_extend_plain` is its PyTorch twin.  The process transport
packs each plane's first and last columns into one contiguous send buffer
per direction (`halo_pack`, the same kernel), exchanges the buffers and
reads the received strips as views (`halo_strips`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

_ALIGN = 16      # byte alignment of each plane's strip in a send buffer
_MAX_PLANES = 16  # planes per K16 launch (csrc/halo.cu kMaxPlanes)


def _widths(v, n: int) -> list:
    return list(v) if isinstance(v, (list, tuple)) else [int(v)] * n


def halo_extend_plain(planes, lefts, rights, wl, wr,
                      own: bool = True) -> list:
    """K16's twin; arguments and result as `halo_extend`."""
    out = []
    for p, lt, rt, a, b in zip(planes, lefts, rights, _widths(wl, len(planes)),
                               _widths(wr, len(planes))):
        left = (p[..., :1].expand(*p.shape[:-1], a) if lt is None
                else lt[..., lt.shape[-1] - a:].to(p.device))
        right = (p[..., -1:].expand(*p.shape[:-1], b) if rt is None
                 else rt[..., :b].to(p.device))
        out.append(torch.cat([left, p, right] if own else [left, right],
                             dim=-1))
    return out


def _segment(t, col0: int, step: int, width: int) -> list:
    """A K16 column segment of contiguous t: (ptr, row stride, col0, step,
    width)."""
    return [t.data_ptr(), t.shape[-1], col0, step, width]


def _launch(descs: list, device) -> None:
    """One K16 launch per _MAX_PLANES plane descriptors."""
    lib = _build.lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    for i in range(0, len(descs), _MAX_PLANES):
        chunk = descs[i:i + _MAX_PLANES]
        arr = np.ascontiguousarray(np.asarray(chunk, np.int64).reshape(-1))
        rc = lib.fhv_halo(arr.ctypes.data, len(chunk), stream)
        _build.launched("halo")
        _build.check(rc, "halo")


def halo_extend(planes, lefts, rights, wl, wr, plain: bool = False,
                own: bool = True) -> list:
    """The halo-extended planes [..., H, wl + W + wr] of a tile shard, or
    with `own` False the halos alone [..., H, wl + wr].

    planes: the shard's planes [..., H, W] (any dtype; luma, chroma, maps);
    lefts: per plane a tensor whose last wl columns are the left halo (the
    left neighbour's plane, or the strip received from it), or None at the
    picture's left bound, where the plane's first column repeats; rights:
    per plane a tensor whose first wr columns are the right halo, or None at
    the right bound.  wl, wr: ints or per-plane lists.  CUDA tensors go
    through K16 unless `plain`; a neighbour on another device is copied
    over first."""
    if plain or not planes[0].is_cuda:
        return halo_extend_plain(planes, lefts, rights, wl, wr, own)
    n = len(planes)
    wls, wrs = _widths(wl, n), _widths(wr, n)
    dev = planes[0].device
    outs, descs, keep = [], [], []
    for p, lt, rt, a, b in zip(planes, lefts, rights, wls, wrs):
        p = p.contiguous()
        _build.require_cuda("halo", p)
        w = p.shape[-1]
        rows = p.numel() // w
        segs = []
        for side, t, width in ((0, lt, a), (1, rt, b)):
            if t is None:
                segs.append(_segment(p, 0 if side == 0 else w - 1, 0, width))
                continue
            if t.device != dev:
                t = (t[..., t.shape[-1] - width:] if side == 0
                     else t[..., :width]).to(dev)
            t = t.contiguous()
            if t.dtype != p.dtype or t.numel() // t.shape[-1] != rows:
                raise ValueError("halo: a neighbour's plane differs from the "
                                 "shard's in type or rows")
            keep.append(t)
            segs.append(_segment(t, t.shape[-1] - width if side == 0 else 0,
                                 1, width))
        wo = w if own else 0
        out = torch.empty(p.shape[:-1] + (a + wo + b,), dtype=p.dtype,
                          device=dev)
        keep.append(p)
        descs.append([out.data_ptr(), rows, a + wo + b, p.element_size()]
                     + segs[0] + _segment(p, 0, 1, wo) + segs[1])
        outs.append(out)
    _launch(descs, dev)
    return outs


def _strip_layout(planes, widths) -> tuple:
    """Byte offsets of each plane's [..., H, width] strip in a send buffer,
    and the buffer's size."""
    offs, total = [], 0
    for p, width in zip(planes, widths):
        offs.append(total)
        nbytes = p.numel() // p.shape[-1] * width * p.element_size()
        total += -(-nbytes // _ALIGN) * _ALIGN
    return offs, total


def halo_pack_plain(planes, wl, wr) -> tuple:
    """`halo_pack`'s twin."""
    n = len(planes)
    bufs = []
    for widths, first in ((_widths(wr, n), True), (_widths(wl, n), False)):
        offs, total = _strip_layout(planes, widths)
        buf = torch.zeros(total, dtype=torch.uint8, device=planes[0].device)
        for p, off, width in zip(planes, offs, widths):
            strip = p[..., :width] if first else p[..., p.shape[-1] - width:]
            raw = strip.contiguous().view(torch.uint8).reshape(-1)
            buf[off:off + raw.numel()] = raw
        bufs.append(buf)
    return tuple(bufs)


def halo_pack(planes, wl, wr, plain: bool = False) -> tuple:
    """The two send buffers of a shard (uint8, one launch of K16 for CUDA
    tensors unless `plain`): to_left, each plane's first wr columns (the
    left neighbour's right halo), and to_right, each plane's last wl
    columns (the right neighbour's left halo), each strip at a 16-byte
    aligned offset.  `halo_strips` reads them back."""
    if plain or not planes[0].is_cuda:
        return halo_pack_plain(planes, wl, wr)
    n = len(planes)
    dev = planes[0].device
    planes = [p.contiguous() for p in planes]
    _build.require_cuda("halo", *planes)
    bufs, descs = [], []
    for widths, first in ((_widths(wr, n), True), (_widths(wl, n), False)):
        offs, total = _strip_layout(planes, widths)
        buf = torch.zeros(total, dtype=torch.uint8, device=dev)
        for p, off, width in zip(planes, offs, widths):
            w = p.shape[-1]
            zero = [0, 0, 0, 0, 0]
            descs.append([buf.data_ptr() + off, p.numel() // w, width,
                          p.element_size()]
                         + _segment(p, 0 if first else w - width, 1, width)
                         + zero + zero)
        bufs.append(buf)
    _launch(descs, dev)
    return tuple(bufs)


def halo_strips(buf: torch.Tensor, planes, widths) -> list:
    """Views of a received send buffer as each plane's [..., H, width]
    strip, in the planes' dtypes (the layout of `halo_pack`)."""
    widths = _widths(widths, len(planes))
    offs, _ = _strip_layout(planes, widths)
    out = []
    for p, off, width in zip(planes, offs, widths):
        shape = p.shape[:-1] + (width,)
        nbytes = int(np.prod(shape)) * p.element_size()
        out.append(buf[off:off + nbytes].view(p.dtype).reshape(shape))
    return out
