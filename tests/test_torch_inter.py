"""The P-picture pixel path of the port against the JAX package on the CPU:
exact MC planes (K11's twin), the inter boundary strengths and the
deblocking that reads them (K6's twin), and the mixed wavefront commit
(K5's twin), on seeded 96x64 pictures whose decisions come from the port's
P search.  Every output is integer and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.ops import me as jme
from fasthevc_tpu.ops.commit import wavefront_commit_mixed as jax_mixed
from fasthevc_tpu.ops.deblock import deblock_device, inter_bs_maps, tu_cbf_map
from fasthevc_tpu_torch.codec.search import search_p_maps
from fasthevc_tpu_torch.ops import commit, deblock, me
from fasthevc_tpu_torch.utils import synthesize_yuv
from fasthevc_tpu_torch.utils.video import pad_plane

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

W, H = 96, 64
GH, GW = H // 8, W // 8


def _clip(seed):
    return synthesize_yuv(W, H, 3, seed=seed)


def _planes(frame):
    return [np.asarray(p, np.int32) for p in frame]


def _p_decisions(clip, qp=32, nref=2):
    """The port's P search of frame 2 against frames 1 and 0: (depth, mode,
    dir, mv [.., 4], ref [.., 2]) int32 numpy granule maps."""
    ph, pw = -(-H // 32) * 32, -(-W // 32) * 32

    def luma(k):
        return torch.from_numpy(pad_plane(np.asarray(clip[k][0], np.int32),
                                          ph, pw))

    ls = float(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))
    pk = search_p_maps(luma(2)[None], torch.stack([luma(1), luma(0)])[None],
                       [ls], 5, 3, W, H, 64, nref=[nref])[0].numpy()
    pk = pk[:GH, :GW].astype(np.int32)
    return pk[..., 0], pk[..., 1], pk[..., 2], pk[..., 3:7], pk[..., 7:9]


def _random_motion(seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 4, (GH, GW)).astype(np.int32)
    mv = rng.integers(-70, 71, (GH, GW, 4)).astype(np.int32)
    rm = rng.integers(0, 2, (GH, GW, 2)).astype(np.int32)
    return d, mv, rm


@pytest.mark.parametrize("kind", ["uni_l0", "bi", "uni_l0_ref_map",
                                  "bi_ref_map"])
def test_inter_pred_planes_match_jax(kind):
    clip = _clip(50)
    d, mv, rm = _random_motion(51)
    ref_map = rm if kind.endswith("ref_map") else None
    bi = kind.startswith("bi")
    if not bi:
        d = (d > 0).astype(np.int32)
    if ref_map is None:
        ref0 = _planes(clip[1])
        ref1 = _planes(clip[0]) if bi else None
    else:
        ref0 = [np.stack([a, b]) for a, b in zip(_planes(clip[1]),
                                                  _planes(clip[0]))]
        ref1 = [np.stack([b, a]) for a, b in zip(_planes(clip[1]),
                                                  _planes(clip[0]))] \
            if bi else None
    want = jme.inter_pred_planes(
        tuple(jnp.asarray(p) for p in ref0),
        None if ref1 is None else tuple(jnp.asarray(p) for p in ref1),
        jnp.asarray(d), jnp.asarray(mv),
        ref_map=None if ref_map is None else jnp.asarray(ref_map))
    got = me.inter_pred_planes(
        tuple(torch.from_numpy(p) for p in ref0),
        None if ref1 is None else tuple(torch.from_numpy(p) for p in ref1),
        torch.from_numpy(d), torch.from_numpy(mv),
        ref_map=None if ref_map is None else torch.from_numpy(ref_map))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _edge_motion(kind, frames, rng):
    """(dir, mv, ref_map) [frames, GH, GW, ...] int32 for the cases the
    planes kernel's edge logic must get right."""
    shape = (frames, GH, GW)
    d = rng.integers(0, 4, shape)
    mv = rng.integers(-70, 71, shape + (4,))
    if kind == "integer":
        # multiples of 4 (the luma copy) and of 8 (the chroma copy too)
        mv = 4 * rng.integers(-20, 21, shape + (4,))
    elif kind == "far":
        # +-(4 * 64 + 3) quarter pels and near it, on the edge granules
        far = rng.choice([-259, -258, -257, -256, 256, 257, 258, 259],
                         shape + (4,))
        edge = np.zeros((GH, GW), bool)
        edge[[0, -1], :] = edge[:, [0, -1]] = True
        mv = np.where(edge[None, :, :, None], far, mv)
    elif kind == "l1_only":
        d = np.where(rng.random(shape) < 0.75, 2, d)
    elif kind == "intra":
        d = np.where(rng.random(shape) < 0.5, 0, d)
        mv = np.where((d == 0)[..., None], 0, mv)
    rm = rng.integers(0, 2, shape + (2,))
    return (d.astype(np.int32), mv.astype(np.int32), rm.astype(np.int32))


@pytest.mark.parametrize("kind,frames", [("integer", 1), ("far", 1),
                                         ("l1_only", 1), ("intra", 1),
                                         ("random", 2)])
def test_inter_pred_planes_edge_cases_match_jax(kind, frames):
    """Integer MVs (the copy), MVs at +-(4 * 64 + 3) quarter pels on the
    picture's edge granules, direction-2 granules, intra granules at zero
    MVs, and two frames with a ref_map: bi-predicted from two references
    a list, against the reference frame by frame."""
    rng = np.random.default_rng(80 + frames + len(kind))
    clip = synthesize_yuv(W, H, 2 * frames + 1, seed=81)
    d, mv, rm = _edge_motion(kind, frames, rng)
    stacks = [[np.stack([a, b]) for a, b in zip(_planes(clip[2 * f + 1]),
                                                _planes(clip[2 * f]))]
              for f in range(frames)]
    ref0 = [np.stack([s[c] for s in stacks]) for c in range(3)]
    ref1 = [r[:, ::-1].copy() for r in ref0]
    got = me.inter_pred_planes(
        tuple(torch.from_numpy(p) for p in ref0),
        tuple(torch.from_numpy(p) for p in ref1), torch.from_numpy(d),
        torch.from_numpy(mv), ref_map=torch.from_numpy(rm))
    for f in range(frames):
        want = jme.inter_pred_planes(
            tuple(jnp.asarray(p[f]) for p in ref0),
            tuple(jnp.asarray(p[f]) for p in ref1), jnp.asarray(d[f]),
            jnp.asarray(mv[f]), ref_map=jnp.asarray(rm[f]))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b[f].numpy())


def test_cbf_and_boundary_strengths_match_jax():
    rng = np.random.default_rng(60)
    depth, _, d, mv, rm = _p_decisions(_clip(61))
    d_rand, mv_rand, rm_rand = _random_motion(62)
    # levels in the top-left CTU only, so both cbf values occur
    lv = np.zeros((H, W), np.int16)
    lv[:32, :32] = ((rng.random((32, 32)) < 0.02)
                    * rng.integers(-3, 4, (32, 32)))
    cbf = np.array(tu_cbf_map(jnp.asarray(lv), jnp.asarray(depth), 5))
    tcbf = deblock.tu_cbf_map(torch.from_numpy(lv)[None],
                              torch.from_numpy(depth)[None], 5)[0]
    np.testing.assert_array_equal(cbf, tcbf.numpy())
    assert cbf.any() and not cbf.all()
    seen = set()
    for dd, mm, rr in ((d, mv, rm), (d_rand, mv_rand, rm_rand),
                       (d_rand, mv_rand, None)):
        want = inter_bs_maps(jnp.asarray(depth), jnp.asarray(dd),
                             jnp.asarray(mm), jnp.asarray(cbf),
                             None if rr is None else jnp.asarray(rr))
        got = deblock.inter_bs_maps(
            torch.from_numpy(depth)[None], torch.from_numpy(dd)[None],
            torch.from_numpy(mm)[None], torch.from_numpy(cbf)[None],
            None if rr is None else torch.from_numpy(rr)[None])
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b[0].numpy())
            seen |= set(np.unique(np.asarray(a)).tolist())
    assert {0, 1, 2} <= seen


@pytest.mark.parametrize("qp", [27, 37])
def test_deblock_with_strengths_matches_jax(qp):
    clip = _clip(63 + qp)
    depth, _, d, mv, rm = _p_decisions(clip, qp=qp)
    rng = np.random.default_rng(qp)
    rec = [np.clip(p + rng.integers(-6, 7, p.shape), 0, 255).astype(np.int32)
           for p in _planes(clip[2])]
    lv = ((rng.random((H, W)) < 0.01) * 2).astype(np.int16)
    cbf = tu_cbf_map(jnp.asarray(lv), jnp.asarray(depth), 5)
    bsv, bsh = inter_bs_maps(jnp.asarray(depth), jnp.asarray(d),
                             jnp.asarray(mv), cbf, jnp.asarray(rm))
    want = deblock_device(*(jnp.asarray(p) for p in rec), jnp.asarray(depth),
                          qp, qp + 1, qp + 2, 5, bs_vert=bsv, bs_horz=bsh)
    got = deblock.deblock(*(torch.from_numpy(p)[None] for p in rec),
                          torch.from_numpy(depth)[None], [qp], [qp + 1],
                          [qp + 2], 5, dir_map=torch.from_numpy(d)[None],
                          mv_map=torch.from_numpy(mv)[None],
                          ref_map=torch.from_numpy(rm)[None],
                          cbf=deblock.tu_cbf(torch.from_numpy(lv)[None],
                                             torch.from_numpy(depth)[None],
                                             5))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b[0].numpy())


@pytest.mark.parametrize("rdoq", [False, True])
def test_mixed_commit_matches_jax(rdoq):
    """Inter CUs take the MC planes, the inter dead-zone offset and the
    diagonal scan; intra CUs read reconstructed inter neighbours; the
    trellis tables are built with init_type 1."""
    clip = _clip(70)
    qp = 30
    depth, mode, d, mv, rm = _p_decisions(clip, qp=qp)
    assert (d > 0).any() and (d == 0).any()
    ref0 = [np.stack([a, b]) for a, b in zip(_planes(clip[1]),
                                              _planes(clip[0]))]
    pred = me.inter_pred_planes(tuple(torch.from_numpy(p) for p in ref0),
                                None, torch.from_numpy(d),
                                torch.from_numpy(mv),
                                ref_map=torch.from_numpy(rm))
    src = _planes(clip[2])
    lam = float(np.float32(np.float32(0.57 * 2.0 ** ((qp - 12) / 3.0))))
    want = jax_mixed(*(jnp.asarray(p) for p in src), jnp.asarray(depth),
                     jnp.asarray(mode), jnp.asarray(d),
                     *(jnp.asarray(p.numpy()) for p in pred), qp, qp, qp,
                     W, H, 8, True, rdoq=rdoq, lam=jnp.float32(lam))
    got = commit.wavefront_commit_mixed(
        *(torch.from_numpy(p)[None] for p in src),
        torch.from_numpy(depth)[None], torch.from_numpy(mode)[None],
        torch.from_numpy(d)[None], *(p[None] for p in pred), [qp], [qp],
        [qp], W, H, True, rdoq=rdoq, lam=[lam])
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b[0].numpy())
