"""ops/me.py of the port against fasthevc_tpu/ops/me.py on the CPU.

The port's integer stage (K9's twin), sub-pel stage (K10's twin) and
merge-candidate MC (K11's twin) run on the same seeded 64x64 frames as the
JAX functions.  Integer outputs must be equal; the sub-pel costs equal bit
for bit, against the jitted reference, whose XLA program contracts
`satd + lambda_sqrt * rate` into one fused multiply-add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.codec.search import _mv_rate_bits
from fasthevc_tpu.ops import me as jme
from fasthevc_tpu_torch.ops import cost, me
from fasthevc_tpu_torch.utils import synthesize_yuv

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

LAMBDA_SQRT = float(np.sqrt(0.57 * 2.0 ** ((32 - 12) / 3.0)))
CASES = [(8, 1), (8, 2), (64, 1), (64, 2)]


# The JAX package's thin wrappers over the same kernels, written over the
# port's core functions (me_state, sad_search, subpel, mc_sel); nothing on
# the port's path calls them.

def _full_search(src, ref, block, search_range):
    mv = me.sad_search(src, ref[None], None, block, search_range, block, 1,
                       search_range)[0]
    srcb = me._blocks(src.to(torch.int64), block)
    oy, ox = me._block_origins(*src.shape, block, src.device)
    refb = me._windows(ref[None], torch.zeros_like(oy), oy + mv[:, 1],
                       ox + mv[:, 0], block, block).to(torch.int64)
    sad = (srcb - refb).abs().sum(dim=(1, 2)).to(torch.int32)
    return sad, mv * 4


def _hier_int_search(y, ref, log2_ctu, search_range):
    st = me.me_state(y, ref[None], search_range, max_size=1 << log2_ctu)
    return {n: mv[0] for n, mv in st.mv_int.items()}


def _subpel_refine(y, ref, mv_int, n, lambda_sqrt):
    c, mv, pred = me.subpel(y, ref[None], mv_int[None], n, lambda_sqrt)
    return c[0], mv[0], pred[0]


def _search_inter_costs(y, ref, lambda_sqrt, search_range):
    st = me.me_state(y, ref[None], search_range, max_size=32)
    return {n: (c[0], mv[0], p[0]) for n, (c, mv, p) in
            me.subpel_from_state(st, lambda_sqrt).items()}


def _mc_raw_from_state(st, ref_idx, n, mvq):
    sel = torch.zeros(mvq.shape[0], dtype=torch.bool)
    return me.mc_raw_from_state_sel(st, ref_idx, ref_idx, sel, n, mvq)


def _mc_blocks(ref, mvq, n, h, w):
    tier = 16 if n == 8 else n
    base = torch.zeros((1, (h // tier) * (w // tier), 2), dtype=torch.int32)
    sel = torch.zeros(mvq.shape[0], dtype=torch.int32)
    raw, _ = me.mc_sel(ref[None], base, mvq, sel, n, tier)
    return ((raw + 32) >> 6).clamp(0, 255)


def _frames(seed, w=64, h=64):
    """A P frame and its two predecessors, luma int32 numpy."""
    clip = synthesize_yuv(w, h, 3, seed=seed)
    return [np.asarray(clip[k][0], np.int32) for k in (2, 1, 0)]


def _jax_state(y, refs, sr):
    return jme.me_state(jnp.asarray(y), [jnp.asarray(r) for r in refs], sr,
                        max_size=32)


def _jax_subpel(st):
    """subpel_from_state of an eager MEState, jitted over its arrays."""
    def run(y, g16, g32, b16, b32, m8, m16, m32):
        s = jme.MEState(y, [None] * st.R, st.sr)
        s.tiers = st.tiers
        s.G = {16: g16, 32: g32}
        s.base = {16: b16, 32: b32}
        s.mv_int = {8: m8, 16: m16, 32: m32}
        return jme.subpel_from_state(s, jnp.float32(LAMBDA_SQRT))
    return jax.jit(run)(st.y, st.G[16], st.G[32], st.base[16], st.base[32],
                        st.mv_int[8], st.mv_int[16], st.mv_int[32])


@pytest.mark.parametrize("sr,nref", CASES)
def test_me_state_and_subpel_match_jax(sr, nref):
    y, *refs = _frames(seed=5 + sr)
    refs = refs[:nref]
    st = _jax_state(y, refs, sr)
    tst = me.me_state(torch.from_numpy(y), torch.from_numpy(np.stack(refs)),
                      sr, max_size=32)
    assert st.tiers == tst.tiers
    for n in st.tiers:
        np.testing.assert_array_equal(np.asarray(st.base[n]),
                                      tst.base[n].numpy())
    for n in (8, 16, 32):
        np.testing.assert_array_equal(np.asarray(st.mv_int[n]),
                                      tst.mv_int[n].numpy())
    assert any(np.abs(tst.mv_int[n].numpy()).max() > 0 for n in (8, 16))
    sp = _jax_subpel(st)
    tsp = me.subpel_from_state(tst, LAMBDA_SQRT)
    for n in (8, 16, 32):
        c, mvq, pred = (np.asarray(v) for v in sp[n])
        tc, tmvq, tpred = (v.numpy() for v in tsp[n])
        np.testing.assert_array_equal(c.view(np.uint32), tc.view(np.uint32))
        np.testing.assert_array_equal(mvq, tmvq)
        np.testing.assert_array_equal(pred, tpred)


def test_mv_rate_table_is_xlas():
    """XLA_MV_RATE holds the jitted `_mv_rate_bits` values bit for bit;
    torch's log2 differs from XLA's in the last ulp for many magnitudes
    (m = 2 among them), which is why the port carries the table."""
    m = np.arange(me.MV_RATE_MAX + 1, dtype=np.int32)
    mv = np.stack([m - m // 3, -(m // 3)], axis=1)   # |x| + |y| == m
    want = np.asarray(jax.jit(_mv_rate_bits)(jnp.asarray(mv)))
    got = me.mv_rate_bits(torch.from_numpy(mv)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert me.MV_RATE_MAX == 2 * (4 * me.MAX_SEARCH_RANGE + 3)
    plain = (4.0 + 2.0 * torch.log2(1.0 + torch.from_numpy(m).float()))
    differs = plain.numpy().view(np.uint32) != want.view(np.uint32)
    assert differs.any()


def test_fma_twin_matches_xla_contraction():
    """`c + a * b` as XLA's CPU program computes it: one rounding."""
    rng = np.random.default_rng(9)
    a = rng.uniform(1, 50, 20000).astype(np.float32)
    b = rng.uniform(0, 30, 20000).astype(np.float32)
    c = rng.integers(0, 300000, 20000).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: c + a * b)(a, b, c))
    got = cost.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_merge_candidate_mc_matches_jax(n):
    """mc_raw_from_state_sel: `valid` equal everywhere, the raw 14-bit
    prediction equal wherever the candidate is valid (the reference's
    window holds garbage elsewhere, and the search prices it out)."""
    y, r0, r1 = _frames(seed=40)
    st = _jax_state(y, [r0, r1], 64)
    tst = me.me_state(torch.from_numpy(y), torch.from_numpy(np.stack([r0,
                                                                      r1])),
                      64, max_size=32)
    rng = np.random.default_rng(n)
    b = (64 // n) ** 2
    mvq = rng.integers(-40, 41, (b, 2)).astype(np.int32)
    mvq[0] = np.asarray(tst.mv_int[n][1, 0]) * 4 + 1
    sel = rng.integers(0, 2, b).astype(bool)
    for lo, hi, s in ((0, 1, sel), (0, 0, np.zeros(b, bool))):
        raw, valid = jme.mc_raw_from_state_sel(st, lo, hi, jnp.asarray(s),
                                               n, jnp.asarray(mvq))
        traw, tvalid = me.mc_raw_from_state_sel(tst, lo, hi,
                                                torch.from_numpy(s), n,
                                                torch.from_numpy(mvq))
        valid = np.asarray(valid)
        np.testing.assert_array_equal(valid, tvalid.numpy())
        assert valid.any()
        np.testing.assert_array_equal(np.asarray(raw)[valid],
                                      traw.numpy()[valid])


def test_mc_blocks_matches_jax():
    y, r0, _ = _frames(seed=41)
    rng = np.random.default_rng(3)
    for n in (8, 16):
        b = (64 // n) ** 2
        mvq = rng.integers(-60, 61, (b, 2)).astype(np.int32)
        want = np.asarray(jme.mc_blocks(jnp.asarray(r0), jnp.asarray(mvq), n,
                                        64, 64))
        got = _mc_blocks(torch.from_numpy(r0), torch.from_numpy(mvq), n, 64,
                         64)
        np.testing.assert_array_equal(want, got.numpy())


def test_search_wrappers_match_jax():
    """The JAX package's thin wrappers against the adapters above:
    full_search, hier_int_search, subpel_refine (jitted, cost bits),
    search_inter_costs and mc_raw_from_state."""
    y, r0, _ = _frames(seed=42)
    jy, jr = jnp.asarray(y), jnp.asarray(r0)
    ty, tr = torch.from_numpy(y), torch.from_numpy(r0)
    sad, mv = jme.full_search(jy, jr, block=16, search_range=8)
    tsad, tmv = _full_search(ty, tr, 16, 8)
    np.testing.assert_array_equal(np.asarray(sad), tsad.numpy())
    np.testing.assert_array_equal(np.asarray(mv), tmv.numpy())
    hier = jme.hier_int_search(jy, jr, 5, 3, 64)
    thier = _hier_int_search(ty, tr, 5, 64)
    assert sorted(hier) == sorted(thier)
    for n in hier:
        np.testing.assert_array_equal(np.asarray(hier[n]), thier[n].numpy())
    mv16 = thier[16]
    c, mvq, pred = jax.jit(jme.subpel_refine, static_argnums=3)(
        jy, jr, jnp.asarray(mv16.numpy()), 16, jnp.float32(LAMBDA_SQRT))
    tc, tmvq, tpred = _subpel_refine(ty, tr, mv16, 16, LAMBDA_SQRT)
    np.testing.assert_array_equal(np.asarray(c).view(np.uint32),
                                  tc.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(mvq), tmvq.numpy())
    np.testing.assert_array_equal(np.asarray(pred), tpred.numpy())
    # eager JAX rounds the cost's multiply and add apart (the jitted
    # program above fuses them), so its costs may differ in the last ulp
    costs = jme.search_inter_costs(jy, jr, jnp.float32(LAMBDA_SQRT),
                                   search_range=64)
    tcosts = _search_inter_costs(ty, tr, LAMBDA_SQRT, 64)
    for n in (8, 16, 32):
        np.testing.assert_array_equal(np.asarray(costs[n][1]),
                                      tcosts[n][1].numpy())
        np.testing.assert_array_equal(np.asarray(costs[n][2]),
                                      tcosts[n][2].numpy())
        np.testing.assert_allclose(np.asarray(costs[n][0]),
                                   tcosts[n][0].numpy(), rtol=2e-7)
    st = _jax_state(y, [r0], 64)
    tst = me.me_state(ty, tr[None], 64)
    q = (tst.mv_int[32][0] * 4 + 3).contiguous()
    raw, valid = jme.mc_raw_from_state(st, 0, 32, jnp.asarray(q.numpy()))
    traw, tvalid = _mc_raw_from_state(tst, 0, 32, q)
    valid = np.asarray(valid)
    np.testing.assert_array_equal(valid, tvalid.numpy())
    assert valid.all()
    np.testing.assert_array_equal(np.asarray(raw), traw.numpy())
