"""K1's rd form and K12's selected form: their twins against the JAX search.

`intra_rd_cands_plain` (the intra search's RD shortlist) must give the
reference's `jax.lax.top_k` of the RMD costs, the one-hot gather of the
candidates' bits and the residuals `src[:, None] - cands`
(fasthevc_tpu/codec/search.py:170-185), bit for bit;
`intra_rd_residuals_plain` (its form given the modes) the chroma DM
residual `_blocks(cp, cn) - predict_selected(...)` (:209-212); and
`bi_select_plain` the B search's BI candidate and direction choice
(:476-491).  The reference's pieces are jitted here at small shapes from
the JAX package's own functions.  The CUDA kernels are held against these
twins in test_torch_kernels.py.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_b_search import SIZES as BI_SIZES
from test_torch_b_search import bi_case  # noqa: F401 (a fixture)

from fasthevc_tpu.ops.cost import satd as jax_satd
from fasthevc_tpu.ops.intra import predict_all_modes, predict_selected
from fasthevc_tpu_torch.ops import cost, intra, me

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)


def _ls(qp):
    return np.float32(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))


@jax.jit
def _jax_rmd(d, ls, mode_bits):
    """The reference's RMD cost (search.py:170), as XLA's CPU backend
    evaluates it: one fused multiply-add."""
    return d.astype(jnp.float32) + ls * mode_bits


@partial(jax.jit, static_argnames=("lg", "k"))
def _jax_shortlist(top, left, src, d, mode_bits, ls, lg, k):
    """search.py:170-185 at one block size: the top-k of the RMD costs,
    the candidates' bits by the one-hot sum and their residuals by the
    one-hot einsum over the 35 predictions."""
    preds = predict_all_modes(top, left, lg, True)
    cost_rmd = d.astype(jnp.float32) + ls * mode_bits
    _, top_idx = jax.lax.top_k(-cost_rmd, k)
    onehot = jax.nn.one_hot(top_idx, 35, dtype=jnp.float32)
    cands = jnp.einsum("bkm,bmyx->bkyx", onehot, preds.astype(jnp.float32),
                       preferred_element_type=jnp.float32).astype(jnp.int32)
    cand_bits = jnp.sum(onehot * mode_bits[:, None, :], axis=2)
    return top_idx, cand_bits, src[:, None] - cands


@partial(jax.jit, static_argnames=("lg",))
def _jax_satd35(top, left, src, lg):
    """The fused form's SATDs as the reference takes them (:163-166)."""
    return jax_satd(src[:, None] - predict_all_modes(top, left, lg, True))


def _blocks(rng, lg, count, flat):
    """count blocks' refs and sources: uniform noise, or flat (every
    prediction and the source 128, so all 35 SATDs are 0 and the costs
    tie wherever the mode bits do)."""
    n = 1 << lg
    if flat:
        top = np.full((count, 2 * n + 1), 128, np.int32)
        return top, top.copy(), np.full((count, n, n), 128, np.int32)
    top = rng.integers(0, 256, (count, 2 * n + 1)).astype(np.int32)
    left = rng.integers(0, 256, (count, 2 * n + 1)).astype(np.int32)
    left[:, 0] = top[:, 0]
    src = rng.integers(0, 256, (count, n, n)).astype(np.int32)
    return top, left, src


def _mode_bits(rng, count):
    """MPM-shaped bits: 2, 3 or 6 a mode."""
    return rng.choice(np.float32([2, 3, 6]), (count, 35))


def _compare(top, left, src, d, bits, ls, lg, k):
    want = _jax_shortlist(top, left, src, d, bits, ls, lg, k)
    got = intra.intra_rd_cands_plain(*(torch.from_numpy(a) for a in (
        top, left)), lg, *(torch.from_numpy(a) for a in (src, d, bits)), ls,
        k)
    n = 1 << lg
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy().view(np.int32),
                                  np.asarray(want[1]).view(np.int32))
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.asarray(want[2]).reshape(-1, n, n))
    return got


def test_rmd_cost_is_rounded_once():
    """At QP 29 with 3 mode bits, the parent's rounded product then
    rounded sum is one ulp below the reference's cost for 512 of the SATDs
    496-1007 (the first at 496); the twin's fma_f32 agrees with it at
    every SATD, for 2, 3 and 6 bits."""
    ls = _ls(29)
    d = np.arange(0, 1200, dtype=np.int32)
    for b in (2.0, 3.0, 6.0):
        bits = np.full(d.shape, b, np.float32)
        want = np.asarray(_jax_rmd(d, ls, bits)).view(np.int32)
        got = cost.fma_f32(torch.tensor(ls), torch.from_numpy(bits),
                           torch.from_numpy(d).float())
        np.testing.assert_array_equal(got.numpy().view(np.int32), want)
        parent = (torch.from_numpy(d).float()
                  + torch.tensor(ls) * torch.from_numpy(bits))
        if b == 3.0:
            bad = np.nonzero(parent.numpy().view(np.int32) != want)[0]
            assert len(bad) == 512 and bad[0] == 496


@pytest.mark.parametrize("qp", [29, 32])
@pytest.mark.parametrize("lg,k", [(3, 3), (4, 1), (2, 8)])
def test_shortlist_matches_jax(qp, lg, k):
    """Noise blocks with the reference's own SATDs, and flat blocks whose
    35 SATDs are all 0 (equal costs wherever the bits are equal: lower
    mode first)."""
    rng = np.random.default_rng(lg * 100 + qp)
    ls = _ls(qp)
    for flat in (False, True):
        top, left, src = _blocks(rng, lg, 24, flat)
        d = np.array(_jax_satd35(top, left, src, lg))
        bits = _mode_bits(rng, len(d))
        got = _compare(top, left, src, d, bits, ls, lg, k)
        if flat:
            assert (d == 0).all()
            # the 2-bit modes come first, in mode order
            first = np.argmax(bits == 2, axis=1)
            has2 = (bits == 2).any(axis=1)
            np.testing.assert_array_equal(got[0][has2, 0].numpy(),
                                          first[has2])


def test_shortlist_takes_the_reference_rounding():
    """A planted one-ulp case at QP 29: mode 5 costs fma(ls, 3, 496),
    which the parent's unfused cost rounds one ulp lower, to exactly the
    cost of mode 20 (SATD 0, bits b20 = that cost / ls).  The reference
    ranks mode 20 first (its cost is lower); the parent's rounding would
    tie the two and rank mode 5 first.  Fails on the parent's unfused
    cost."""
    ls = _ls(29)
    lg, k = 3, 1
    top, left, src = _blocks(np.random.default_rng(3), lg, 2, False)
    c5 = np.float32(np.float32(496) + ls * np.float32(3))     # unfused
    ref5 = np.asarray(_jax_rmd(np.int32([496]), ls, np.float32([3])))[0]
    assert c5 < ref5
    b20 = np.float32(c5 / ls)
    while np.float32(ls * b20) != c5:
        b20 = np.nextafter(b20, np.float32(np.inf if ls * b20 < c5
                                           else -np.inf))
    d = np.full((2, 35), 100000, np.int32)
    bits = np.full((2, 35), 6, np.float32)
    d[:, 5], bits[:, 5] = 496, 3
    d[:, 20], bits[:, 20] = 0, b20
    got = _compare(top, left, src, d, bits, ls, lg, k)
    assert (got[0].numpy() == 20).all()


@pytest.mark.parametrize("lg", [2, 3, 4])
def test_chroma_residuals_match_jax(lg):
    """The form given the modes, at the chroma DM sizes: src minus
    predict_selected(is_luma=False), every mode taken."""
    rng = np.random.default_rng(40 + lg)
    top, left, src = _blocks(rng, lg, 40, False)
    modes = np.arange(40, dtype=np.int32) % 35
    want = src - np.asarray(predict_selected(jnp.asarray(top),
                                             jnp.asarray(left), lg,
                                             jnp.asarray(modes),
                                             is_luma=False))
    got = intra.intra_rd_residuals_plain(
        torch.from_numpy(top), torch.from_numpy(left), lg,
        torch.from_numpy(src), torch.from_numpy(modes[:, None]),
        is_luma=False)
    np.testing.assert_array_equal(got.numpy(), want)


@jax.jit
def _jax_direction(c0, c1, cbi, p0, p1, pbi, r0bits, r1bits):
    """search.py:484-491: the direction in the SATD domain and the
    one-hot selects of the prediction and the rate."""
    dchoice = jnp.argmin(jnp.stack([c0, c1, cbi]), axis=0)
    dsel = jax.nn.one_hot(dchoice, 3, dtype=jnp.float32)
    pred_sel = jnp.einsum(
        "bc,cbyx->byx", dsel, jnp.stack([p0, p1, pbi]).astype(jnp.float32),
        preferred_element_type=jnp.float32).astype(jnp.int32)
    rate_sel = (dsel[:, 0] * r0bits + dsel[:, 1] * r1bits
                + dsel[:, 2] * (r0bits + r1bits))
    return dchoice, pred_sel, rate_sel


@pytest.mark.parametrize("n", BI_SIZES)
def test_bi_select_plain_matches_jax(bi_case, n):
    """bi_case's draws with the lists' costs planted around the
    reference's cbi: ties between c0, c1 and cbi (the first wins), an inf
    c1, and lists that win outright; p0 and p1 distinct noise."""
    st, ls, draws, want = bi_case
    pbi, cbi = (np.asarray(a) for a in want[n])
    b = len(cbi)
    rng = np.random.default_rng(n)
    s0, s1, mv0, mv1 = (torch.from_numpy(a) for a in draws[n])
    r0, r1 = me.mv_rate_bits(mv0), me.mv_rate_bits(mv1)
    # (c0, c1) as offsets from cbi, a block each in turn: ties c0 == cbi
    # (L0), c1 == cbi (L1), c0 == c1 (L0); an inf c1 and both inf (BI);
    # outright wins of L0, L1 and BI
    plant = np.float32([[0, 5], [1, np.inf], [1, 0], [-1, -1],
                        [np.inf, np.inf], [-1, 5], [1, -2], [1, 5]])
    c0, c1 = (cbi + plant[np.arange(b) % len(plant), i] for i in (0, 1))
    p0 = rng.integers(0, 256, (b, n, n)).astype(np.int32)
    p1 = rng.integers(0, 256, (b, n, n)).astype(np.int32)
    wd, wp, wr = _jax_direction(c0, c1, cbi, p0, p1, pbi, r0.numpy(),
                                r1.numpy())
    got = me.bi_select_plain(
        st.y, st.refs, mv0, s0.int(), mv1, s1.int() + 2, r0, r1,
        torch.from_numpy(c0), torch.from_numpy(c1), torch.from_numpy(p0),
        torch.from_numpy(p1), ls, n)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(wd))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(wp))
    np.testing.assert_array_equal(got[1].numpy().view(np.int32),
                                  np.asarray(wr).view(np.int32))
    assert set(np.asarray(wd).tolist()) == {0, 1, 2}

