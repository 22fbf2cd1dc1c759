"""The port's B search against fasthevc_tpu/codec/search.py on the CPU.

`bi_cost_plain` (K12's twin) must give the reference's BI candidate,
search.py:476-481, bit for bit: the bi-averaged prediction and the f32
cost (XLA contracts `satd + lambda_sqrt * (r0bits + r1bits)` into one
fused multiply-add).  `search_b_maps` (intra candidates, one ME state over
both lists, per-list merge candidates, BI, the direction choice, the inter
RD leaf and the quadtree DP) must give the JAX search's packed decision
maps, called as TpuEncoder's per-frame B dispatch calls it
(encoder.py:1087-1099), at SR 64 with one and two references per list,
l0 == l1 included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasthevc_tpu.codec.search import _mv_rate_bits
from fasthevc_tpu.codec.search import search_b_maps as jax_b_maps
from fasthevc_tpu.ops.cost import satd as jax_satd
from fasthevc_tpu.ops.me import mc_raw_from_state_sel
from fasthevc_tpu.ops.me import me_state as jax_me_state
from fasthevc_tpu_torch.codec.search import search_b_maps
from fasthevc_tpu_torch.ops import me
from fasthevc_tpu_torch.utils import synthesize_yuv
from fasthevc_tpu_torch.utils.video import pad_plane

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

SR = 64
SIZES = (8, 16, 32)


def _ls(qp):
    return float(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))


def _luma(w, h, seed, frames=5):
    ph, pw = -(-h // 32) * 32, -(-w // 32) * 32
    clip = synthesize_yuv(w, h, frames, seed=seed)
    return [pad_plane(np.asarray(f[0], np.int32), ph, pw) for f in clip]


@jax.jit
def _jax_bi(y, refs, ls, sels0, sels1, mv0s, mv1s):
    """search.py:476-481 over an ME state of refs l0a l0b l1a l1b, for
    the 8-, 16- and 32-blocks."""
    st = jax_me_state(y, refs, SR, max_size=32)
    h, w = y.shape
    out = []
    for n, s0, s1, mv0, mv1 in zip(SIZES, sels0, sels1, mv0s, mv1s):
        raw0, _ = mc_raw_from_state_sel(st, 0, 1, s0, n, mv0)
        raw1, _ = mc_raw_from_state_sel(st, 2, 3, s1, n, mv1)
        pbi = jnp.clip((raw0 + raw1 + 64) >> 7, 0, 255)
        src_b = (y.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3)
                 .reshape(-1, n, n))
        cbi = (jax_satd(src_b - pbi).astype(jnp.float32)
               + ls * (_mv_rate_bits(mv0) + _mv_rate_bits(mv1)))
        out.append((pbi, cbi))
    return out


@pytest.fixture(scope="module")
def bi_case():
    """One 64x64 B frame with two references per list, each block's list
    reference and final quarter-pel MV drawn around the state's integer
    MVs; the JAX candidate of every size."""
    frames = _luma(64, 64, 4)
    y, refs = frames[2], [frames[k] for k in (1, 0, 3, 4)]
    ls = _ls(30)
    st = me.me_state(torch.from_numpy(y), torch.from_numpy(np.stack(refs)),
                     SR, max_size=32)
    rng = np.random.default_rng(0)
    draws = {}
    for n in SIZES:
        mi = st.mv_int[n].numpy()
        b = mi.shape[1]
        s0, s1 = rng.integers(0, 2, (2, b)).astype(bool)
        mv0 = np.where(s0[:, None], mi[1], mi[0]) * 4 + rng.integers(
            -3, 4, (b, 2))
        mv1 = np.where(s1[:, None], mi[3], mi[2]) * 4 + rng.integers(
            -3, 4, (b, 2))
        draws[n] = (s0, s1, mv0.astype(np.int32), mv1.astype(np.int32))
    want = _jax_bi(jnp.asarray(y), [jnp.asarray(r) for r in refs],
                   jnp.float32(ls), *[[draws[n][k] for n in SIZES]
                                      for k in range(4)])
    return st, ls, draws, dict(zip(SIZES, want))


@pytest.mark.parametrize("n", SIZES)
def test_bi_cost_plain_matches_jax(bi_case, n):
    st, ls, draws, want = bi_case
    s0, s1, mv0, mv1 = (torch.from_numpy(a) for a in draws[n])
    r0, r1 = me.mv_rate_bits(mv0), me.mv_rate_bits(mv1)
    pbi, cbi = me.bi_cost(st.y, st.refs, mv0, s0.int(), mv1, s1.int() + 2,
                          r0, r1, ls, n)
    np.testing.assert_array_equal(pbi.numpy(), np.asarray(want[n][0]))
    np.testing.assert_array_equal(cbi.numpy().view(np.int32),
                                  np.asarray(want[n][1]).view(np.int32))


def _jax_dispatch(y, r0, r1, ls, qp, w, h):
    """TpuEncoder._search_dispatch's B call with a second reference in
    each list.  A list of one passes its reference again: the JAX search
    keeps the first of two equal costs and rates no reference index, so
    that gives its one-reference decisions, and every case runs the one
    compiled program."""
    kw = dict(cnn_params=None, qp=qp, use_cnn=False, rd_cands=3,
              ref0b_u8=jnp.asarray(r0[-1].astype(np.uint8)),
              ref1b_u8=jnp.asarray(r1[-1].astype(np.uint8)))
    return np.asarray(jax_b_maps(
        jnp.asarray(y.astype(np.uint8)), jnp.asarray(r0[0].astype(np.uint8)),
        jnp.asarray(r1[0].astype(np.uint8)), jnp.float32(_ls(qp)), 5, 3, w,
        h, SR, **kw))


# (w, h, seed, qp, list-0 frames, list-1 frames) of a B frame at index 2
# of its clip: l0 == l1 with one reference, as POC 16 of a GOP-16 has
# them, and two references per list.  At 64x64 the JAX program is the
# two-reference one of tests/test_tpu_p_frames.py's random-access encode,
# so the persistent compile cache can serve it; 96x64 costs a compile of
# its own (about a minute on the CPU) and runs in the slow tier.
CASES = ([(64, 64, seed, qp, (0,), (0,)) for seed, qp in ((1, 27), (2, 37))]
         + [(64, 64, seed, qp, (1, 0), (3, 1))
            for seed, qp in ((1, 22), (2, 27), (3, 32), (4, 37), (5, 30),
                             (6, 35))]
         + [pytest.param(96, 64, seed, qp, (1, 0), (3, 4),
                         marks=pytest.mark.slow)
            for seed, qp in ((5, 27), (6, 35))])


@pytest.mark.parametrize("w,h,seed,qp,l0,l1", CASES)
def test_b_maps_match_jax(w, h, seed, qp, l0, l1):
    frames = _luma(w, h, seed)
    y = frames[2]
    r0 = [frames[k] for k in l0]
    r1 = [frames[k] for k in l1]
    want = _jax_dispatch(y, r0, r1, _ls(qp), qp, w, h)
    # the device route's form: two references per list, masked by nref
    stack = [torch.from_numpy(np.stack([r[0], r[-1]]))[None]
             for r in (r0, r1)]
    got = search_b_maps(torch.from_numpy(y[None]), *stack, [_ls(qp)], 5, 3,
                        w, h, SR, nref0=[len(l0)],
                        nref1=[len(l1)]).numpy()[0]
    np.testing.assert_array_equal(got, want)
    d = got[..., 2]
    assert (d > 0).any() and (got[..., 1][d > 0] == -1).all()
    if l0 == l1:
        assert not (d == 2).any()   # c0 == c1: list 0 wins the tie


def test_b_search_takes_every_direction():
    """On a clip with motion both ways the B search picks L0, L1 and BI
    CUs, and list 0's second reference."""
    frames = _luma(96, 64, 5)
    stack = [torch.from_numpy(np.stack([frames[a], frames[b]]))[None]
             for a, b in ((1, 0), (3, 4))]
    got = search_b_maps(torch.from_numpy(frames[2][None]), *stack,
                        [_ls(27)], 5, 3, 96, 64, SR, nref0=[2],
                        nref1=[2]).numpy()[0]
    d = got[..., 2]
    assert {1, 2, 3} <= set(np.unique(d).tolist())
    assert (got[..., 7][(d & 1) > 0] == 1).any()
