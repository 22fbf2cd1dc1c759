"""The schedule of K6's one-launch form and K8's cast form, on the CPU.

`deblock_fused` (csrc/deblock.cu `deblock_fused_kernel`) filters each
frame's 32x32 luma tiles (and the 16x16 chroma tiles under them) apart:
the tile and a 4-sample halo in a local buffer, its vertical edges, then
its horizontal edges, and the core written once.  `_tile_model` below is
that schedule written plainly over the twin's dense segment filters, with
every sample outside the loaded halo set to noise (so a read beyond it
would show); it must equal the JAX `deblock_device` bit for bit, intra
and with `inter_bs_maps` strengths, on sizes off the 32-grid, and its
tile-column form must equal the whole picture's filter on the tile's own
columns.  The cast form's twin must equal JAX `_device_checksum` of the
uint8 casts and `utils.video.picture_checksum`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.codec.device_pipeline import _device_checksum
from fasthevc_tpu.ops.deblock import deblock_device, inter_bs_maps, tu_cbf_map
from fasthevc_tpu.utils.video import picture_checksum
from fasthevc_tpu_torch import _build
from fasthevc_tpu_torch.codec.device_pipeline import cast_checksum
from fasthevc_tpu_torch.ops import deblock

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

TILE, HALO = 32, 4


def _quadtree_depth(gh, gw, rng):
    """CU depths of CTU 32 on a granule grid, CTUs of one 32x32 CU, four
    16x16 or 8x8 CUs; a 32x32 CU may overflow the grid's last row or
    column."""
    depth = np.zeros((gh, gw), np.int32)
    for cy in range(0, gh, 4):
        for cx in range(0, gw, 4):
            if rng.random() < 0.7:
                for sy in range(2):
                    for sx in range(2):
                        depth[cy + 2 * sy:cy + 2 * sy + 2,
                              cx + 2 * sx:cx + 2 * sx + 2] = \
                            1 + (rng.random() < 0.5)
    return depth


def _planes(rng, frames, h, w):
    """Smooth int32 planes with noise (chroma halved), so that strong,
    weak and unfiltered segments all occur."""
    out = []
    for c, k in enumerate((3, 2, 4)):
        hh, ww = h >> (c > 0), w >> (c > 0)
        yy, xx = np.mgrid[0:hh, 0:ww]
        base = 120 + 40 * np.sin(xx / 9.0) * np.cos(yy / 7.0) \
            + 8 * ((xx // 8 + yy // 8) % 2)
        out.append(np.clip(base + rng.integers(-k, k + 1, (frames, hh, ww)),
                           0, 255).astype(np.int32))
    return out


def _masks(depth, log2_ctu, bsv, bsh, x0, pic_w):
    """The segment masks and strengths of deblock_plain: luma vertical
    [F, H/4, W/8], horizontal [F, W/4, H/8] (BS 2 where no strengths are
    given), chroma [F, H/8, W/8] both directions."""
    vert, horz = deblock.edge_masks(depth, log2_ctu, x0, pic_w)
    vseg = vert.repeat_interleave(2, 1)
    hseg = horz.repeat_interleave(2, 2).transpose(1, 2)
    bsv = torch.where(vseg, 2, 0) if bsv is None else bsv
    bsh = torch.where(hseg, 2, 0) if bsh is None else bsh
    gh, gw = depth.shape[-2:]
    cvert = vert & (deblock._global_cols(gw, x0, depth.device) % 16 == 0)
    chorz = horz & (torch.arange(gh) % 2 == 0)[:, None]
    cvert = cvert & (bsv[:, 0::2] == 2)
    chorz = chorz & (bsh[:, 0::2] == 2).transpose(1, 2)
    return vseg, bsv, hseg, bsh, cvert, chorz


def _window(grid, r0, c0, rows, cols):
    """grid[:, r0:r0+rows, c0:c0+cols] with False / 0 off the grid."""
    out = torch.zeros((grid.shape[0], rows, cols), dtype=grid.dtype)
    rs, cs = max(r0, 0), max(c0, 0)
    re, ce = min(r0 + rows, grid.shape[1]), min(c0 + cols, grid.shape[2])
    if rs < re and cs < ce:
        out[:, rs - r0:re - r0, cs - c0:ce - c0] = grid[:, rs:re, cs:ce]
    return out


def _tile_model(ry, rcb, rcr, depth, qps, log2_ctu=5, bsv=None, bsh=None,
                x0=0, pic_w=None, noise_seed=0):
    """The one-launch form's schedule: per frame and 32x32 core, a local
    buffer holding the core and a 4-sample halo (the rest noise), all its
    vertical edges that write into the core, then all its horizontal ones
    on the core's columns, and the core written once.  Returns the three
    int32 planes and how often each sample was written."""
    f, h, w = ry.shape
    pic_w = w + x0 if pic_w is None else pic_w
    vseg, bsv, hseg, bsh, cvert, chorz = _masks(depth, log2_ctu, bsv, bsh,
                                                 x0, pic_w)
    noise = np.random.default_rng(noise_seed)
    outs = [torch.zeros_like(p) for p in (ry, rcb, rcr)]
    writes = [torch.zeros_like(p) for p in outs]
    for fr in range(f):
        qy, qcb, qcr = (torch.tensor([[[int(v[fr])]]]) for v in qps)
        for y0 in range(0, h, TILE):
            for x0t in range(0, w, TILE):
                # luma: a 48x48 buffer whose edges lie at multiples of 8
                # (origin at the core less 8); only the 40x40 core and halo
                # come from the plane
                buf = torch.from_numpy(noise.integers(0, 256, (1, 48, 48)))
                ys, xs = max(y0 - HALO, 0), max(x0t - HALO, 0)
                ye, xe = min(y0 + TILE + HALO, h), min(x0t + TILE + HALO, w)
                buf[0, ys - y0 + 8:ye - y0 + 8, xs - x0t + 8:xe - x0t + 8] = \
                    ry[fr, ys:ye, xs:xe]
                # vertical: the 40 rows' segments (1-10), edges 1-5 (the
                # core's columns 0, 8, .., 32)
                keep = torch.zeros((1, 12, 6), dtype=torch.bool)
                keep[:, 1:11, 1:6] = True
                m = _window(vseg[fr:fr + 1], (y0 - 8) // 4, (x0t - 8) // 8,
                            12, 6) & keep
                b = _window(bsv[fr:fr + 1], (y0 - 8) // 4, (x0t - 8) // 8,
                            12, 6)
                buf = deblock._filter_vert_luma(buf, m, b, qy, 8)
                # horizontal: the core's column segments (2-9), edges 1-5
                keep = torch.zeros((1, 12, 6), dtype=torch.bool)
                keep[:, 2:10, 1:6] = True
                m = _window(hseg[fr:fr + 1], (x0t - 8) // 4, (y0 - 8) // 8,
                            12, 6) & keep
                b = _window(bsh[fr:fr + 1], (x0t - 8) // 4, (y0 - 8) // 8,
                            12, 6)
                buf = deblock._filter_vert_luma(buf.transpose(1, 2), m, b,
                                                qy, 8).transpose(1, 2)
                ch, cw = min(TILE, h - y0), min(TILE, w - x0t)
                outs[0][fr, y0:y0 + ch, x0t:x0t + cw] = buf[0, 8:8 + ch,
                                                            8:8 + cw]
                writes[0][fr, y0:y0 + ch, x0t:x0t + cw] += 1
                # chroma: a 24x24 buffer, the 16x16 core and a 4-sample
                # halo, edges at multiples of 4 (1-5 write into the core)
                cy0, cx0 = y0 // 2, x0t // 2
                for k, (plane, qc) in enumerate(((rcb, qcb), (rcr, qcr))):
                    hc, wc = plane.shape[1:]
                    cb = torch.from_numpy(noise.integers(0, 256, (1, 24, 24)))
                    ys, xs = max(cy0 - HALO, 0), max(cx0 - HALO, 0)
                    ye, xe = min(cy0 + 20, hc), min(cx0 + 20, wc)
                    cb[0, ys - cy0 + 4:ye - cy0 + 4,
                       xs - cx0 + 4:xe - cx0 + 4] = plane[fr, ys:ye, xs:xe]
                    keep = torch.zeros((1, 6, 6), dtype=torch.bool)
                    keep[:, :, 1:6] = True
                    m = _window(cvert[fr:fr + 1], (cy0 - 4) // 4,
                                (cx0 - 4) // 4, 6, 6) & keep
                    cb = deblock._filter_vert_chroma(cb, m, qc, 8)
                    keep = torch.zeros((1, 6, 6), dtype=torch.bool)
                    keep[:, 1:5, 1:6] = True
                    m = _window(chorz.transpose(1, 2)[fr:fr + 1],
                                (cx0 - 4) // 4, (cy0 - 4) // 4, 6, 6) & keep
                    cb = deblock._filter_vert_chroma(
                        cb.transpose(1, 2), m, qc, 8).transpose(1, 2)
                    ch, cw = min(16, hc - cy0), min(16, wc - cx0)
                    outs[1 + k][fr, cy0:cy0 + ch, cx0:cx0 + cw] = \
                        cb[0, 4:4 + ch, 4:4 + cw]
                    writes[1 + k][fr, cy0:cy0 + ch, cx0:cx0 + cw] += 1
    return outs, writes


def _jax_deblock(planes, depth, qps, fr, bs=None):
    kw = {} if bs is None else dict(bs_vert=bs[0], bs_horz=bs[1])
    return [np.asarray(a) for a in deblock_device(
        *(jnp.asarray(p[fr]) for p in planes), jnp.asarray(depth[fr]),
        *(int(q[fr]) for q in qps), 5, **kw)]


def _p_maps(rng, frames, gh, gw, h, w):
    """Seeded P/B granule maps: directions 0-3 (a sixth intra) on 16x16
    blocks, MVs within a quarter sample of each other but for a few whole
    samples off, reference indices mostly 0; levels with a few nonzero
    values."""
    d = (rng.choice([0, 1, 1, 1, 2, 3], (frames, gh // 2 + 1, gw // 2 + 1))
         .repeat(2, 1).repeat(2, 2)[:, :gh, :gw].astype(np.int32))
    mv = (rng.integers(-1, 2, (frames, gh, gw, 4))
          + 8 * (rng.random((frames, gh, gw, 1)) < 0.15)).astype(np.int32)
    rm = (rng.random((frames, gh, gw, 2)) < 0.1).astype(np.int32)
    lv = ((rng.random((frames, h, w)) < 0.004)
          * rng.integers(-2, 3, (frames, h, w))).astype(np.int16)
    return d, mv, rm, lv


def _check_writes(writes):
    for wr in writes:
        assert bool((wr == 1).all()), "a sample was not written exactly once"


@pytest.mark.parametrize("h,w,frames", [(72, 104, 1), (64, 96, 2)])
def test_tile_schedule_matches_jax_intra(h, w, frames):
    """Intra (BS 2 on every CU/TU edge), the chroma edges on the 16-luma
    grid; per-frame QPs."""
    rng = np.random.default_rng(h + w)
    planes = _planes(rng, frames, h, w)
    depth = np.stack([_quadtree_depth(h // 8, w // 8, rng)
                      for _ in range(frames)])
    qps = [[30 + 4 * k, 31 + 4 * k, 29 + 4 * k] for k in range(frames)]
    qps = [np.array(v) for v in zip(*qps)]
    tp = [torch.from_numpy(p) for p in planes]
    td = torch.from_numpy(depth)
    got, writes = _tile_model(*tp, td, qps)
    _check_writes(writes)
    fused = deblock.deblock_fused(*tp, td, *(list(q) for q in qps), 5)
    changed = 0
    for fr in range(frames):
        want = _jax_deblock(planes, depth, qps, fr)
        for g, wj, fu, src in zip(got, want, fused, planes):
            np.testing.assert_array_equal(g[fr].numpy(), wj)
            np.testing.assert_array_equal(fu[fr].numpy(), wj)
            changed += int((wj != src[fr]).sum())
    assert changed > 0


@pytest.mark.parametrize("h,w", [(72, 104), (64, 96)])
def test_tile_schedule_matches_jax_with_strengths(h, w):
    """P/B strengths (inter_bs_maps of the CU cbf of tu_cbf_map) with every
    strength 0, 1 and 2 present, with and without a reference map."""
    rng = np.random.default_rng(7 * h + w)
    gh, gw = h // 8, w // 8
    planes = _planes(rng, 1, h, w)
    depth = _quadtree_depth(gh, gw, rng)[None]
    d, mv, rm, lv = _p_maps(rng, 1, gh, gw, h, w)
    qps = [np.array([32]), np.array([33]), np.array([31])]
    tp = [torch.from_numpy(p) for p in planes]
    td = torch.from_numpy(depth)
    cbf = deblock.tu_cbf_ctu(torch.from_numpy(lv), td, 5)
    jcbf = tu_cbf_map(jnp.asarray(lv[0]), jnp.asarray(depth[0]), 5)
    np.testing.assert_array_equal(cbf[0].numpy(), np.asarray(jcbf))
    seen = set()
    for ref in (rm, None):
        jbs = inter_bs_maps(jnp.asarray(depth[0]), jnp.asarray(d[0]),
                            jnp.asarray(mv[0]), jcbf,
                            None if ref is None else jnp.asarray(ref[0]))
        seen |= set(np.unique(np.asarray(jbs[0])).tolist())
        maps = dict(dir_map=torch.from_numpy(d), mv_map=torch.from_numpy(mv),
                    ref_map=None if ref is None else torch.from_numpy(ref),
                    cbf=cbf)
        bsv, bsh = deblock.inter_bs_maps(td, maps["dir_map"],
                                         maps["mv_map"], cbf,
                                         maps["ref_map"])
        got, writes = _tile_model(*tp, td, qps, bsv=bsv, bsh=bsh)
        _check_writes(writes)
        fused = deblock.deblock_fused(*tp, td, [32], [33], [31], 5, **maps)
        want = _jax_deblock(planes, depth, qps, 0, jbs)
        for g, wj, fu in zip(got, want, fused):
            np.testing.assert_array_equal(g[0].numpy(), wj)
            np.testing.assert_array_equal(fu[0].numpy(), wj)
    assert {0, 1, 2} <= seen


@pytest.mark.parametrize("inter", [False, True])
def test_tile_schedule_window_form(inter):
    """The tile-column form on a 64-column tile's planes extended by 8
    columns of each neighbour (x0 = t*64 - 8), its tiles laid on the
    extended plane's columns: equal to the twin of _deblock_sharded_cols'
    call on the whole extended plane, and on the tile's own columns to
    the JAX filter of the whole picture."""
    rng = np.random.default_rng(90 + inter)
    h, w, tw = 72, 192, 64
    gh, gw = h // 8, w // 8
    planes = _planes(rng, 1, h, w)
    depth = _quadtree_depth(gh, gw, rng)[None]
    qps = [np.array([34]), np.array([35]), np.array([33])]
    maps, jbs = {}, None
    if inter:
        d, mv, _, lv = _p_maps(rng, 1, gh, gw, h, w)
        cbf = deblock.tu_cbf_ctu(torch.from_numpy(lv), torch.from_numpy(depth),
                                 5)
        maps = dict(dir_map=torch.from_numpy(d), mv_map=torch.from_numpy(mv),
                    cbf=cbf)
        jbs = inter_bs_maps(jnp.asarray(depth[0]), jnp.asarray(d[0]),
                            jnp.asarray(mv[0]), jnp.asarray(cbf[0].numpy()))
    whole = _jax_deblock(planes, depth, qps, 0, jbs)
    for t in (1, 2):
        lo, hi = t * tw - 8, min(t * tw + tw + 8, w)
        ext = [torch.from_numpy(p[..., lo >> (c > 0):hi >> (c > 0)].copy())
               for c, p in enumerate(planes)]
        sl = {k: v[:, :, lo // 8:hi // 8].contiguous()
              for k, v in maps.items()}
        td = torch.from_numpy(depth[:, :, lo // 8:hi // 8].copy())
        bsv = bsh = None
        if inter:
            bsv, bsh = deblock.inter_bs_maps(td, sl["dir_map"],
                                             sl["mv_map"], sl["cbf"])
        got, writes = _tile_model(*ext, td, qps, bsv=bsv, bsh=bsh, x0=lo,
                                  pic_w=w, noise_seed=t)
        _check_writes(writes)
        twin = deblock.deblock(*ext, td, 34, 35, 33, 5, plain=True, x0=lo,
                               pic_w=w, **sl)
        fused = deblock.deblock_fused(*ext, td, 34, 35, 33, 5, x0=lo,
                                      pic_w=w, **sl)
        for c, (g, tw_, fu, wj) in enumerate(zip(got, twin, fused, whole)):
            assert torch.equal(g, tw_) and torch.equal(fu, tw_)
            k = 8 >> (c > 0)
            own = slice(k, k + (tw >> (c > 0)))
            np.testing.assert_array_equal(
                g[0, :, own].numpy(),
                wj[:, t * tw >> (c > 0):(t + 1) * tw >> (c > 0)])


@pytest.mark.parametrize("h,w,frames", [(72, 104, 2), (36, 56, 1)])
def test_cast_checksum_twin_matches_jax(h, w, frames):
    """K8's cast form's twin: the uint8 casts and each plane's checksum,
    against JAX `_device_checksum(x.astype(uint8))` and
    `picture_checksum`; the cast-only mode; column slices of wider
    planes (the sharded route's deblocked windows)."""
    rng = np.random.default_rng(h * w)
    planes = [rng.integers(0, 256, (frames, h >> (c > 0), w >> (c > 0)))
              .astype(np.int32) for c in range(3)]
    wide = [np.pad(p, ((0, 0), (0, 0), (8 >> (c > 0), 8 >> (c > 0))),
                   constant_values=7) for c, p in enumerate(planes)]
    views = [torch.from_numpy(p)[..., (8 >> (c > 0)):-(8 >> (c > 0))]
             for c, p in enumerate(wide)]
    _build.LAUNCHES.clear()
    for src in ([torch.from_numpy(p) for p in planes], views):
        *u8, ck = cast_checksum(*src)
        assert ck.dtype == torch.int64 and ck.shape == (frames, 3)
        for c, (g, p) in enumerate(zip(u8, planes)):
            assert g.dtype == torch.uint8 and g.is_contiguous()
            np.testing.assert_array_equal(g.numpy(), p.astype(np.uint8))
            for fr in range(frames):
                want = int(_device_checksum(jnp.asarray(p[fr])
                                            .astype(jnp.uint8)))
                assert int(ck[fr, c]) == want
                assert want == int.from_bytes(
                    picture_checksum([p[fr].astype(np.uint8)])[0], "big")
        *u8_only, none = cast_checksum(*src, checksum=False)
        assert none is None
        for a, b in zip(u8_only, u8):
            assert torch.equal(a, b)
    assert sum(_build.LAUNCHES.values()) == 0
