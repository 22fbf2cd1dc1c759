"""K16's host side (`ops/halo.py`): the flat plane descriptors that both
of its kernel forms read, built on CPU tensors and executed here with
numpy as the row form executes them (a warp a row: a segment whose
source and destination agree modulo 16 bytes copies 16-byte vectors
between an element head and tail, any other one element at a time; a
replicating segment repeats one element), against the twin.  The kernels
themselves are held against the twin on the card (tests/test_torch_kernels.py,
`cuda`)."""

import ctypes

import numpy as np
import pytest
import torch

from fasthevc_tpu_torch import _build
from fasthevc_tpu_torch.ops import halo

torch.set_num_threads(1)

DESC = halo._DESC


def _bytes_at(addr: int, n: int) -> np.ndarray:
    return np.frombuffer((ctypes.c_uint8 * n).from_address(addr), np.uint8)


def _execute(desc: list) -> dict:
    """Run flat K16 descriptors on host memory as the row form does;
    returns how many segment rows took each path."""
    paths = {"vector": 0, "scalar": 0, "replicate": 0}
    assert len(desc) % DESC == 0
    for k in range(0, len(desc), DESC):
        out, rows, width, es = desc[k:k + 4]
        assert es in (1, 2, 4, 8)
        col = 0
        for s in range(3):
            ptr, stride, col0, step, w = desc[k + 4 + 5 * s:k + 9 + 5 * s]
            nbytes = w * es
            for r in range(rows if nbytes else 0):
                dst = out + (r * width + col) * es
                src = ptr + (r * stride + col0) * es
                d = _bytes_at(dst, nbytes)
                if step == 0:
                    d[:] = np.tile(_bytes_at(src, es), w)
                    paths["replicate"] += 1
                elif (dst - src) % 16 == 0:
                    head = min((16 - dst % 16) % 16, nbytes)
                    body = (nbytes - head) // 16 * 16
                    for a, b in ((0, head), (head, head + body),
                                 (head + body, nbytes)):
                        d[a:b] = _bytes_at(src + a, b - a)
                    paths["vector" if body else "scalar"] += 1
                else:
                    s_ = _bytes_at(src, nbytes)
                    for e in range(0, nbytes, es):
                        d[e:e + es] = s_[e:e + es]
                    paths["scalar"] += 1
            col += w
        assert col == width
    return paths


def _plane(rng, shape, dtype, skew: int):
    """A contiguous [..., H, W] plane whose data starts `skew` elements
    into its storage (so its rows sit at any alignment)."""
    n = int(np.prod(shape))
    flat = torch.from_numpy(rng.integers(0, 120, n + skew).astype(dtype))
    return flat[skew:].view(shape)


@pytest.mark.parametrize("own", [True, False])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32])
def test_descriptors_rebuild_the_twin(dtype, own):
    """Widths 1-128 each side (the mesh's 1, 4, 8, 16, 32, 64 and 128
    among them), own columns kept or not, both neighbours, each one
    missing and both missing: the executed descriptors equal
    `halo_extend_plain`; both the vector and the scalar path occur."""
    rng = np.random.default_rng(int(np.dtype(dtype).itemsize) + 7 * own)
    paths = {"vector": 0, "scalar": 0, "replicate": 0}
    for wl, wr in ((1, 1), (4, 4), (8, 4), (16, 32), (32, 64), (64, 128),
                   (128, 64), (3, 0), (0, 5), (127, 1)):
        for lt_on, rt_on in ((True, True), (False, True), (True, False),
                             (False, False)):
            w = 128 + int(rng.integers(0, 24))
            shape = (2, 3, w)
            p = _plane(rng, shape, dtype, int(rng.integers(0, 9)))
            lt = _plane(rng, shape, dtype, int(rng.integers(0, 9))) \
                if lt_on else None
            rt = _plane(rng, shape, dtype, int(rng.integers(0, 9))) \
                if rt_on else None
            want = halo.halo_extend_plain([p], [lt], [rt], wl, wr, own)[0]
            outs, desc, keep = halo._describe([p], [lt], [rt], [wl], [wr],
                                              own)
            for k, v in _execute(desc).items():
                paths[k] += v
            assert torch.equal(outs[0], want), (wl, wr, lt_on, rt_on)
    assert paths["vector"] > 0 and paths["scalar"] > 0
    assert paths["replicate"] > 0


def test_pack_descriptors_rebuild_the_twins_buffers():
    """More planes than one launch takes (K16 chunks them), three element
    types: the executed pack descriptors fill the send buffers as
    `halo_pack_plain` does, and the strips read back as views."""
    rng = np.random.default_rng(3)
    types = (np.uint8, np.int32, np.int16)
    planes = [_plane(rng, (2, 5, 40 + k), types[k % 3], 0)
              for k in range(halo._MAX_PLANES + 5)]
    wl = [1 + k % 9 for k in range(len(planes))]
    wr = [2 + k % 31 for k in range(len(planes))]
    bufs, desc = halo._describe_pack(planes, wl, wr)
    assert len(desc) == 2 * len(planes) * DESC
    _execute(desc)
    for a, b in zip(bufs, halo.halo_pack_plain(planes, wl, wr)):
        assert torch.equal(a, b)
    strips = halo.halo_strips(bufs[1], planes, wl)
    for p, s, w in zip(planes, strips, wl):
        assert torch.equal(s, p[..., p.shape[-1] - w:])


def test_the_earlier_form_runs_the_twin_on_the_cpu():
    """`halo_extend_by_element` and `halo_pack_by_element` (K16's earlier
    form, which no route launches) take the twin for CPU tensors, as the
    row form does, and count no launch."""
    rng = np.random.default_rng(4)
    planes = [_plane(rng, (1, 6, 20), np.uint8, 0),
              _plane(rng, (4, 10), np.int32, 0)]
    lefts = [p + 1 for p in planes]
    _build.LAUNCHES.clear()
    for fn in (halo.halo_extend, halo.halo_extend_by_element):
        for a, b in zip(fn(planes, lefts, [None, None], [4, 2], [8, 1]),
                        halo.halo_extend_plain(planes, lefts, [None, None],
                                               [4, 2], [8, 1])):
            assert torch.equal(a, b)
    for fn in (halo.halo_pack, halo.halo_pack_by_element):
        for a, b in zip(fn(planes, 2, 3), halo.halo_pack_plain(planes, 2,
                                                                 3)):
            assert torch.equal(a, b)
    assert sum(_build.LAUNCHES.values()) == 0
