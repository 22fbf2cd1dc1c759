"""The tile-column halo exchange of the sharded pipelines.

Counterpart of fasthevc_tpu/parallel/sharded.py `_ppermute_halo`: a tile
shard's planes extended by the left neighbour's last wl columns and the
right neighbour's first wr columns, a shard at a picture bound repeating
its own edge column instead.  `halo_extend` goes through kernel K16's row
form (csrc/halo.cu `fhv_halo_rows`, one launch for a set of planes of any
element size, launch counter `halo_rows`) for CUDA tensors;
`halo_extend_plain` is its PyTorch twin (one `torch.cat` a plane).  The
process transport packs each plane's first and last columns into one
contiguous send buffer per direction (`halo_pack`, the same kernel),
exchanges the buffers and reads the received strips as views
(`halo_strips`).  The earlier form, a thread an element (`fhv_halo`,
counter `halo`), stays callable (`halo_extend_by_element`,
`halo_pack_by_element`); no route launches it.  Both take one flat
descriptor list (`_describe`), written into a per-thread ctypes buffer.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .. import _build

_ALIGN = 16      # byte alignment of each plane's strip in a send buffer
_MAX_PLANES = 16  # planes per K16 launch (csrc/halo.cu kMaxPlanes)
_DESC = 4 + 5 * 3  # int64 fields of a plane descriptor (csrc/halo.cu kDesc)
_local = threading.local()


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


def _neighbour(t, width: int, first: bool, dev):
    """A neighbour's plane on `dev`, contiguous: only its halo columns
    travel when it lies on another device."""
    if t.device != dev:
        t = (t[..., t.shape[-1] - width:] if first else t[..., :width]).to(dev)
    return t.contiguous()


def _describe(planes, lefts, rights, wls, wrs, own: bool) -> tuple:
    """The K16 plane descriptors of `halo_extend` (csrc/halo.cu fhv_halo:
    per plane its output pointer, rows, width and element size, then three
    segments of (source pointer, source row stride, col0, step, width)),
    flat, with the new outputs and the neighbour tensors moved or copied
    here, which must live until the launch.  Pure over pointers and
    shapes: it runs on CPU tensors too."""
    dev = planes[0].device
    outs, desc, keep = [], [], []
    for p, lt, rt, a, b in zip(planes, lefts, rights, wls, wrs):
        shape = p.shape
        w = shape[-1]
        rows = p.numel() // w
        ptr = p.data_ptr()
        segs = []
        for t, width, first in ((lt, a, True), (rt, b, False)):
            if t is None:
                # the picture bound: the plane's edge column, repeated
                segs += (ptr, w, 0 if first else w - 1, 0, width)
                continue
            if t.device != dev or not t.is_contiguous():
                t = _neighbour(t, width, first, dev)
                keep.append(t)
            tw = t.shape[-1]
            if t.dtype != p.dtype or t.numel() != rows * tw or width > tw:
                raise ValueError("halo: a neighbour's plane differs from the "
                                 "shard's in type or rows, or is narrower "
                                 "than its halo")
            segs += (t.data_ptr(), tw, tw - width if first else 0, 1, width)
        wo = w if own else 0
        out = torch.empty((*shape[:-1], a + wo + b), dtype=p.dtype,
                          device=dev)
        outs.append(out)
        desc += (out.data_ptr(), rows, a + wo + b, p.element_size(),
                 *segs[:5], ptr, w, 0, 1, wo, *segs[5:])
    return outs, desc, keep


def _descriptor_buffer():
    """This thread's reusable ctypes buffer for one launch's descriptors
    (the ranks of an in-process mesh launch from their own threads)."""
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = (ctypes.c_longlong * (_MAX_PLANES * _DESC))()
    return buf


def _launch(desc: list, device, rows: bool = True) -> None:
    """One K16 launch per _MAX_PLANES plane descriptors of the flat `desc`:
    the row form (counter `halo_rows`) or the earlier form (`halo`)."""
    lib = _build.lib()
    fn, name = ((lib.fhv_halo_rows, "halo_rows") if rows
                else (lib.fhv_halo, "halo"))
    stream = torch.cuda.current_stream(device).cuda_stream
    buf = _descriptor_buffer()
    chunk = _MAX_PLANES * _DESC
    for i in range(0, len(desc), chunk):
        part = desc[i:i + chunk]
        buf[:len(part)] = part
        rc = fn(buf, len(part) // _DESC, stream)
        _build.launched(name)
        _build.check(rc, name)


def _extend(planes, lefts, rights, wl, wr, own: bool, rows: bool) -> list:
    n = len(planes)
    if not all(p.is_contiguous() for p in planes):
        planes = [p.contiguous() for p in planes]
    _build.require_cuda("halo", *planes)
    # `moved` holds the neighbours copied here until the launch
    outs, desc, moved = _describe(planes, lefts, rights, _widths(wl, n),
                                  _widths(wr, n), own)
    _launch(desc, planes[0].device, rows)
    return outs


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
    through K16's row form unless `plain`; a neighbour on another device is
    copied over first."""
    if plain or not planes[0].is_cuda:
        return halo_extend_plain(planes, lefts, rights, wl, wr, own)
    return _extend(planes, lefts, rights, wl, wr, own, True)


def halo_extend_by_element(planes, lefts, rights, wl, wr,
                           own: bool = True) -> list:
    """`halo_extend` through K16's earlier form (a thread an element,
    counter `halo`), which no route launches; CPU tensors run the twin."""
    if not planes[0].is_cuda:
        return halo_extend_plain(planes, lefts, rights, wl, wr, own)
    return _extend(planes, lefts, rights, wl, wr, own, False)


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


def _describe_pack(planes, wl, wr) -> tuple:
    """The two send buffers of `halo_pack`, zeroed, and the K16
    descriptors that fill them (flat, as `_describe`'s; one segment a
    strip).  Pure over pointers and shapes: it runs on CPU tensors too."""
    n = len(planes)
    bufs, desc = [], []
    unused = (0, 0, 0, 0, 0)
    for widths, first in ((_widths(wr, n), True), (_widths(wl, n), False)):
        offs, total = _strip_layout(planes, widths)
        buf = torch.zeros(total, dtype=torch.uint8, device=planes[0].device)
        base = buf.data_ptr()
        for p, off, width in zip(planes, offs, widths):
            w = p.shape[-1]
            desc += (base + off, p.numel() // w, width, p.element_size(),
                     p.data_ptr(), w, 0 if first else w - width, 1, width,
                     *unused, *unused)
        bufs.append(buf)
    return tuple(bufs), desc


def _pack(planes, wl, wr, rows: bool) -> tuple:
    planes = [p.contiguous() for p in planes]
    _build.require_cuda("halo", *planes)
    bufs, desc = _describe_pack(planes, wl, wr)
    _launch(desc, planes[0].device, rows)
    return bufs


def halo_pack(planes, wl, wr, plain: bool = False) -> tuple:
    """The two send buffers of a shard (uint8, one launch of K16's row form
    for CUDA tensors unless `plain`): to_left, each plane's first wr
    columns (the left neighbour's right halo), and to_right, each plane's
    last wl columns (the right neighbour's left halo), each strip at a
    16-byte aligned offset.  `halo_strips` reads them back."""
    if plain or not planes[0].is_cuda:
        return halo_pack_plain(planes, wl, wr)
    return _pack(planes, wl, wr, True)


def halo_pack_by_element(planes, wl, wr) -> tuple:
    """`halo_pack` through K16's earlier form (counter `halo`); CPU tensors
    run the twin."""
    if not planes[0].is_cuda:
        return halo_pack_plain(planes, wl, wr)
    return _pack(planes, wl, wr, False)


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
