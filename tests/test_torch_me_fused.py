"""K9's and K11's fused forms on the CPU: `me_coarse` / `me_fine` (the
integer stage in two launches a picture) and `mc_merge` (the merge
candidates' MC, SATD and fold in one launch a block size) run their plain
twins here.  The twins are held against fasthevc_tpu: `me_state` through
them against the JAX `me_state`, and the fold against the JAX searches'
composition (fasthevc_tpu/codec/search.py:438-460), written here from the
JAX package's own functions.  Integer outputs equal, f32 costs bit for
bit.  The kernels themselves are held against these twins on the card
(tests/test_torch_kernels.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.codec.search import _neighbor_mvs
from fasthevc_tpu.ops import me as jme
from fasthevc_tpu.ops.cost import satd as jax_satd
from fasthevc_tpu_torch import _build
from fasthevc_tpu_torch.ops import me
from fasthevc_tpu_torch.utils import synthesize_yuv

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

LAMBDA_SQRT = float(np.sqrt(0.57 * 2.0 ** ((32 - 12) / 3.0)))


def _frames(w, h, seed, count=3):
    """Luma of a seeded synthesized clip, int32 numpy, last frame first."""
    clip = synthesize_yuv(w, h, count, seed=seed)
    return [np.asarray(clip[k][0], np.int32) for k in range(count - 1, -1,
                                                            -1)]


@pytest.mark.parametrize("w,h", [(64, 64), (128, 64)])
@pytest.mark.parametrize("ctu", [32, 64])
@pytest.mark.parametrize("nref", [1, 2])
@pytest.mark.parametrize("sr", [8, 64])
def test_me_state_twins_match_jax(sr, nref, ctu, w, h):
    """me_state's coarse bases and refined MVs through `me_coarse_plain`
    and `me_fine_plain` (and through the wrappers, which take the twins
    for CPU tensors and launch nothing) equal the JAX me_state's."""
    y, *refs = _frames(w, h, seed=sr + nref + ctu + w)
    refs = refs[:nref]
    st = jme.me_state(jnp.asarray(y), [jnp.asarray(r) for r in refs], sr,
                      max_size=ctu)
    _build.LAUNCHES.clear()
    args = (torch.from_numpy(y), torch.from_numpy(np.stack(refs)), sr)
    tst = me.me_state(*args, max_size=ctu, plain=True)
    cpu = me.me_state(*args, max_size=ctu)
    assert sum(_build.LAUNCHES.values()) == 0
    assert st.tiers == tst.tiers == [n for n in (16, 32, 64) if n <= ctu]
    for n in st.tiers:
        np.testing.assert_array_equal(np.asarray(st.base[n]),
                                      tst.base[n].numpy())
        assert torch.equal(cpu.base[n], tst.base[n])
    assert list(tst.mv_int) == st.tiers + [8] == list(cpu.mv_int)
    for n in tst.mv_int:
        np.testing.assert_array_equal(np.asarray(st.mv_int[n]),
                                      tst.mv_int[n].numpy())
        assert torch.equal(cpu.mv_int[n], tst.mv_int[n])
    assert any(tst.mv_int[n].abs().max() > 0 for n in tst.mv_int)


def _jax_fold(st, ia, ib, mv, ridx, pred, cost, rate, n, edge_col,
              edge_on):
    """The reference's `with_merge_cands` (search.py:438-460) on a JAX
    MEState, from the JAX package's functions."""
    h, w = st.h, st.w
    src_b = (st.y.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3)
             .reshape(-1, n, n))
    mv, ridx, pred = jnp.asarray(mv), jnp.asarray(ridx), jnp.asarray(pred)
    cost, rate = jnp.asarray(cost), jnp.asarray(rate)
    field = jnp.concatenate([mv, ridx[:, None]], axis=1)
    for cand in _neighbor_mvs(field, h // n, w // n, edge_col, edge_on):
        cmv, cref = cand[:, :2], cand[:, 2]
        raw_c, valid = jme.mc_raw_from_state_sel(st, ia, ib, cref > 0, n,
                                                 cmv)
        predc = jnp.clip((raw_c + 32) >> 6, 0, 255)
        costc = jnp.where(
            valid, jax_satd(src_b - predc).astype(jnp.float32)
            + jnp.float32(LAMBDA_SQRT) * 2.0, jnp.inf)
        better = costc < cost
        cost = jnp.where(better, costc, cost)
        mv = jnp.where(better[:, None], cmv, mv)
        ridx = jnp.where(better, cref, ridx)
        pred = jnp.where(better[:, None, None], predc, pred)
        rate = jnp.where(better, 2.0, rate)
    return mv, ridx, pred, cost, rate


@functools.lru_cache(maxsize=1)
def _fold_states():
    """The JAX and the port's ME states (SR 64, four references) of the
    fold cases' 128x64 picture, made once for all of them."""
    y, *refs = _frames(128, 64, seed=41, count=5)
    st = jme.me_state(jnp.asarray(y), [jnp.asarray(r) for r in refs], 64,
                      max_size=32)
    tst = me.me_state(torch.from_numpy(y), torch.from_numpy(np.stack(refs)),
                      64, max_size=32, plain=True)
    return st, tst


@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("edge", [None, 1])
def test_merge_fold_twin_matches_jax(n, edge):
    """`mc_merge` on CPU tensors (its twin) for both lists of a four-ref
    state at once equals the reference's fold run on each list: seeded ME
    winners with MVs near and far (outside the tier window, so `valid`
    fails), mixed refs, and in every fourth block the ME cost set to the
    cost the fold would reach from inf, which strict < must leave to the
    ME winner.  edge: the shard's picture-edge column (search.py:61-75),
    else none."""
    w, h = 128, 64
    st, tst = _fold_states()
    b = (h // n) * (w // n)
    rng = np.random.default_rng(n + (edge or 0))
    lists = []
    for ia, ib in ((0, 1), (2, 3)):
        mv = rng.integers(-20, 21, (b, 2))
        mv[::5] = rng.integers(-259, 260, (b, 2))[::5]
        mv = mv.astype(np.int32)
        ridx = rng.integers(0, 2, b).astype(np.int32)
        pred = rng.integers(0, 256, (b, n, n)).astype(np.int32)
        cost = rng.uniform(0, 40 * n * n, b).astype(np.float32)
        rate = me.mv_rate_bits(torch.from_numpy(mv)).numpy()
        lists.append([ia, ib, mv, ridx, pred, cost, rate])
    edge_col = -1 if edge is None else edge
    ties = []
    for li in lists:
        # a tie: the cost of the best candidate, from a fold that starts at
        # inf
        first = _jax_fold(st, li[0], li[1], *li[2:5], np.full(b, np.inf,
                                                              np.float32),
                          li[6], n, 0 if edge is None else edge, None)
        best = np.asarray(first[3])
        ties.append((np.arange(b) % 4 == 0) & np.isfinite(best))
        li[5] = np.where(ties[-1], best, li[5]).astype(np.float32)
    got = me.mc_merge(tst, [(ia, ib, *(torch.from_numpy(a) for a in rest))
                            for ia, ib, *rest in lists], n, LAMBDA_SQRT,
                      edge_col)
    assert len(got) == 2
    merged = 0
    for li, g, tie in zip(lists, got, ties):
        want = _jax_fold(st, *li, n, 0 if edge is None else edge, None)
        for a, c in zip(g, want):
            a, c = a.numpy(), np.asarray(c)
            if a.dtype == np.float32:
                a, c = a.view(np.uint32), c.astype(np.float32).view(
                    np.uint32)
            np.testing.assert_array_equal(a, c)
        merged += int((g[4] == 2.0).sum())
        assert tie.any()
        assert torch.equal(g[0][tie], torch.from_numpy(li[2][tie]))
    assert merged > 0
