"""The CUDA kernels K1-K16 of fasthevc_tpu_torch against their plain twins.

Tests marked `cuda` need an NVIDIA card: the `cuda_device` fixture skips
them elsewhere (the decision is made inside the fixture, never at import
time, so every test worker collects the same tests).  This file imports
no JAX, so on a GPU host without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

The unmarked tests check the launch-counter contract on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from fasthevc_tpu_torch import _build
from fasthevc_tpu_torch.codec import device_pipeline
from fasthevc_tpu_torch.codec.search import (search_b_maps,
                                             search_intra_maps_batch,
                                             search_p_maps)
from fasthevc_tpu_torch.models import init_params
from fasthevc_tpu_torch.ops import (cnn, commit, cost, deblock, halo,
                                    intra, me, sao, transform)
from fasthevc_tpu_torch.utils import synthesize_yuv
from fasthevc_tpu_torch.utils.video import pad_plane

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

SIZES = [(2, True), (2, False), (3, True), (3, False), (4, True),
         (4, False), (5, True), (5, False)]
TQ_CASES = [(lg, qp) for qp in (22, 32, 37) for lg in (2, 3, 4, 5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _refs(lg, count, seed):
    n = 1 << lg
    rng = np.random.default_rng(seed)
    top = rng.integers(0, 256, (count, 2 * n + 1)).astype(np.int32)
    left = rng.integers(0, 256, (count, 2 * n + 1)).astype(np.int32)
    left[:, 0] = top[:, 0]
    return torch.from_numpy(top), torch.from_numpy(left)


def _residuals(n, count, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.concatenate([
        rng.integers(-255, 256, (count, n, n)),
        rng.integers(-20, 21, (count, n, n))]).astype(np.int32))


def test_cpu_tensors_run_the_twins_and_count_no_launch():
    _build.LAUNCHES.clear()
    top, left = _refs(3, 20, seed=1)
    preds = intra.predict_all_modes(top, left, 3)
    assert torch.equal(preds, intra.predict_plain(top, left, 3))
    src = preds[:, 5].clone()
    assert torch.equal(cost.satd(src, preds), cost.satd_plain(src, preds))
    assert torch.equal(intra.predict_satd(top, left, 3, src),
                       cost.satd_plain(src, preds))
    res = _residuals(8, 10, seed=2)
    lv, rq = transform.tq_roundtrip(res, 32, 3)
    for a, b in zip(cost.sse_rate(res, rq, lv),
                    cost.sse_rate_plain(res, rq, lv)):
        assert torch.equal(a, b)
    for a, b in zip(transform.tq_cost(res, 32, 3, is_intra=False),
                    transform.tq_cost_plain(res, 32, 3, is_intra=False)):
        assert torch.equal(a, b)
    d = intra.predict_satd(top, left, 3, src)
    bits = torch.from_numpy(np.random.default_rng(3).choice(
        np.float32([2, 3, 6]), (20, 35)))
    for a, b in zip(intra.intra_rd_cands(top, left, 3, src, d, bits, 7.5, 3),
                    intra.intra_rd_cands_plain(top, left, 3, src, d, bits,
                                               7.5, 3)):
        assert torch.equal(a, b)
    modes = torch.arange(20, dtype=torch.int32)[:, None] % 35
    assert torch.equal(
        intra.intra_rd_residuals(top, left, 3, src, modes, False),
        intra.intra_rd_residuals_plain(top, left, 3, src, modes, False))
    y, refs = _p_inputs(32, 32, 4, torch.device("cpu"))
    args = _bi_select_args(y, torch.cat([refs, refs]), 16, seed=5)
    for a, b in zip(me.bi_select(*args), me.bi_select_plain(*args)):
        assert torch.equal(a, b)
    src, rec = _sao_planes(1, 40, 56, seed=6)
    want = sao.sao_plain(*src, *rec, 4)
    for got in (sao.sao(*src, *rec, 4), sao.sao_two_pass(*src, *rec, 4)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    planes, depth, maps, lv = _deblock_case(2, 40, 56, 8, "cpu")
    cbf = deblock.tu_cbf_ctu(lv, depth, 5)
    assert torch.equal(cbf, deblock.tu_cbf(lv, depth, 5))
    for kw in ({}, dict(maps, cbf=cbf)):
        for a, b in zip(deblock.deblock_fused(*planes, depth, 32, 33, 31, 5,
                                              **kw),
                        deblock.deblock(*planes, depth, 32, 33, 31, 5,
                                        **kw)):
            assert torch.equal(a, b)
    *u8, ck = device_pipeline.cast_checksum(*planes)
    assert torch.equal(ck, torch.stack(
        [device_pipeline.device_checksum(p) for p in u8], dim=1))
    pargs = _planes_args(2, 2, True, True, "random", seed=7, device="cpu")
    want = me.inter_pred_planes(*pargs[:4], ref_map=pargs[4], plain=True)
    for got in (me.inter_pred_planes(*pargs[:4], ref_map=pargs[4]),
                me.inter_pred_planes_by_comp(*pargs[:4], ref_map=pargs[4])):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert sum(_build.LAUNCHES.values()) == 0


def _group(w, h, frames, seed, qp, device):
    """Seeded synthesized frames (CTU-padded, int32) and their decision maps
    from the search: (y, cb, cr, depth, mode, lambda_sqrt)."""
    clip = synthesize_yuv(w, h, frames, seed=seed)
    ph, pw = -(-h // 32) * 32, -(-w // 32) * 32

    def planes(i, hh, ww):
        return torch.from_numpy(np.stack([
            pad_plane(np.asarray(f[i], np.int32), hh, ww) for f in clip]))

    y, cb, cr = planes(0, ph, pw), planes(1, ph // 2, pw // 2), \
        planes(2, ph // 2, pw // 2)
    ls = float(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))
    pk = search_intra_maps_batch(y, ls, 5, 3, w, h, cb_batch=cb, cr_batch=cr)
    depth = pk[:, :h // 8, :w // 8, 0].to(torch.int32)
    mode = pk[:, :h // 8, :w // 8, 1].to(torch.int32)
    return tuple(t.to(device) for t in (y, cb, cr, depth, mode)) + (ls,)


def test_cpu_tensors_run_the_commit_twins_and_count_no_launch():
    _build.LAUNCHES.clear()
    y, cb, cr, depth, mode, ls = _group(64, 64, 1, 3, 32, "cpu")
    out = device_pipeline.encode_group_device(
        y.to(torch.uint8), cb.to(torch.uint8), cr.to(torch.uint8), ls, 32, 32,
        32, 32, 5, 3, 64, 64, True, True, True, rdoq=True)
    assert out["rec_y"].shape == (1, 64, 64)
    assert out["lv_y"].dtype == torch.int16
    assert out["sao"].shape == (1, 2, 2, 3, 7)
    assert sum(_build.LAUNCHES.values()) == 0


def test_library_is_keyed_by_the_sources():
    path = _build.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert path == _build.library_path()
    assert {os.path.basename(s) for s in _build.sources()} >= {
        "intra_pred.cu", "satd.cu", "tq_roundtrip.cu", "sse_rate.cu",
        "commit.cu", "deblock.cu", "sao.cu", "checksum.cu", "me_int.cu",
        "subpel.cu", "mc.cu", "intra_common.cuh", "tq_common.cuh",
        "satd_common.cuh", "rate_common.cuh", "cnn.cu", "halo.cu", "bi.cu",
        "copy_common.cuh", "mc_common.cuh"}
    assert set(_build._SIGNATURES) >= {
        "fhv_intra_satd", "fhv_intra_rd_cands", "fhv_bi_cost",
        "fhv_bi_select",
        "fhv_tq_roundtrip", "fhv_tq_cost", "fhv_cnn_bwd_plan",
        "fhv_downsample4", "fhv_sad_search", "fhv_me_coarse",
        "fhv_me_fine", "fhv_subpel", "fhv_mc_sel", "fhv_mc_merge",
        "fhv_inter_pred", "fhv_inter_planes", "fhv_commit", "fhv_deblock",
        "fhv_deblock_cbf", "fhv_deblock_fused", "fhv_deblock_cbf_ctu",
        "fhv_cast_checksum", "fhv_sao_stats", "fhv_sao_apply",
        "fhv_sao_fused",
        "fhv_cnn_fwd", "fhv_cnn_bwd", "fhv_adam", "fhv_halo"}


@pytest.mark.cuda
@pytest.mark.parametrize("lg,luma", SIZES)
def test_intra_kernel_matches_twin(cuda_device, lg, luma):
    top, left = (t.to(cuda_device) for t in _refs(lg, 300, seed=20 + lg))
    modes = torch.arange(top.shape[0], device=cuda_device) % 35
    before = (_build.LAUNCHES["intra_pred"],
              _build.LAUNCHES["intra_pred_selected"])
    assert torch.equal(intra.predict_all_modes(top, left, lg, luma),
                       intra.predict_plain(top, left, lg, None, luma))
    assert torch.equal(
        intra.predict_selected(top, left, lg, modes, luma),
        intra.predict_plain(top, left, lg, modes[:, None], luma)[:, 0])
    assert (_build.LAUNCHES["intra_pred"],
            _build.LAUNCHES["intra_pred_selected"]) == (before[0] + 1,
                                                        before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("lg", [2, 3, 4, 5])
def test_intra_satd_kernel_matches_twin(cuda_device, lg, bits):
    """K1's fused form (the intra search's all-mode SATDs) against its twin
    on 8- and 10-bit references and sources, 301 blocks (a partial CTA at
    the end), one launch."""
    n = 1 << lg
    rng = np.random.default_rng(40 + lg + bits)
    top = rng.integers(0, 1 << bits, (301, 2 * n + 1)).astype(np.int32)
    left = rng.integers(0, 1 << bits, (301, 2 * n + 1)).astype(np.int32)
    left[:, 0] = top[:, 0]
    src = rng.integers(0, 1 << bits, (301, n, n)).astype(np.int32)
    t, l, s = (torch.from_numpy(a).to(cuda_device) for a in (top, left, src))
    before = _build.LAUNCHES["intra_satd"]
    for depth in (8, bits):
        assert torch.equal(intra.predict_satd(t, l, lg, s, depth),
                           intra.predict_satd_plain(t, l, lg, s, depth))
    assert _build.LAUNCHES["intra_satd"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("lg", [2, 3, 4, 5])
def test_selected_candidates_match_the_gather(cuda_device, lg):
    """The intra search's rd candidates: K1's selected form with [B, 3]
    modes equals the gather of K1's 35-mode prediction, every mode taken
    at least once (the smoothed ones at 8 and 16 among them)."""
    top, left = (t.to(cuda_device) for t in _refs(lg, 300, seed=70 + lg))
    take = torch.from_numpy(np.random.default_rng(lg).integers(
        0, 35, (300, 3))).to(cuda_device)
    take[:35, 0] = torch.arange(35, device=cuda_device)
    allm = intra.predict_all_modes(top, left, lg)
    got = intra.predict(top, left, lg, take)
    assert torch.equal(got, torch.take_along_dim(allm, take[:, :, None, None],
                                                 dim=1))
    assert torch.equal(got, intra.predict_plain(top, left, lg, take))


def _ls(qp):
    return float(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [1, 3, 8])
@pytest.mark.parametrize("lg", [2, 3, 4, 5])
def test_intra_rd_cands_kernel_matches_twin(cuda_device, lg, kk):
    """K1's rd form (the RD shortlist) against its twin at QP 29, bit for
    bit: top_idx, the f32 bits of cand_bits and the residuals, on noise
    blocks with their own SATDs and on flat blocks (all 35 SATDs 0, every
    cost tied within its bits: lower mode first); 301 blocks, a partial
    CTA at the end, one launch each."""
    n = 1 << lg
    rng = np.random.default_rng(80 + lg * 10 + kk)
    top, left = (t.to(cuda_device) for t in _refs(lg, 301, seed=60 + lg))
    src = torch.from_numpy(rng.integers(0, 256, (301, n, n)).astype(
        np.int32)).to(cuda_device)
    flat_t = torch.full_like(top, 128)
    flat_s = torch.full_like(src, 128)
    bits = torch.from_numpy(rng.choice(np.float32([2, 3, 6]), (301, 35))).to(
        cuda_device)
    before = _build.LAUNCHES["intra_rd_cands"]
    for t, l, s in ((top, left, src), (flat_t, flat_t, flat_s)):
        d = intra.predict_satd(t, l, lg, s)
        got = intra.intra_rd_cands(t, l, lg, s, d, bits, _ls(29), kk)
        want = intra.intra_rd_cands_plain(t, l, lg, s, d, bits, _ls(29), kk)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
        assert torch.equal(got[2], want[2])
    assert _build.LAUNCHES["intra_rd_cands"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("lg", [2, 3, 4, 5])
def test_intra_rd_residuals_kernel_matches_twin(cuda_device, lg, luma):
    """K1's rd form given the modes (the chroma DM residual at n = 4, 8,
    16, and luma), one and three modes a block, every mode taken."""
    n = 1 << lg
    top, left = (t.to(cuda_device) for t in _refs(lg, 301, seed=90 + lg))
    src = torch.from_numpy(np.random.default_rng(lg).integers(
        0, 256, (301, n, n)).astype(np.int32)).to(cuda_device)
    modes = torch.arange(301 * 3, device=cuda_device).reshape(301, 3) % 35
    before = _build.LAUNCHES["intra_rd_cands"]
    for m in (modes[:, :1], modes):
        assert torch.equal(
            intra.intra_rd_residuals(top, left, lg, src, m, luma),
            intra.intra_rd_residuals_plain(top, left, lg, src, m, luma))
    assert _build.LAUNCHES["intra_rd_cands"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_satd_kernel_matches_twin(cuda_device, n):
    """Every intra size over 35 modes; 64, the merge candidates' blocks at
    CTU 64, over 2."""
    rng = np.random.default_rng(30 + n)
    m = 2 if n == 64 else 35
    src = torch.from_numpy(rng.integers(0, 256, (400, n, n)).astype(np.int32))
    preds = torch.from_numpy(rng.integers(0, 256, (400, m, n, n))
                             .astype(np.int32))
    s, p = src.to(cuda_device), preds.to(cuda_device)
    assert torch.equal(cost.satd(s, p), cost.satd_plain(s, p))


@pytest.mark.cuda
@pytest.mark.parametrize("lg,qp", TQ_CASES)
def test_tq_kernel_matches_twin(cuda_device, lg, qp):
    res = _residuals(1 << lg, 500, seed=lg + qp).to(cuda_device)
    lk, rk = transform.tq_roundtrip(res, qp, lg)
    lp, rp = transform.tq_roundtrip_plain(res, qp, lg)
    assert torch.equal(lk, lp)
    assert torch.equal(rk, rp)


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [22, 32, 37, 51])
@pytest.mark.parametrize("lg", [2, 3, 4, 5])
@pytest.mark.parametrize("intra", [True, False])
def test_tq_cost_equals_tq_roundtrip_then_sse_rate(cuda_device, lg, qp,
                                                   intra):
    """K3's costed form is K3 -> K4 bit for bit (K4's lane order and
    model), on random, all-zero and +-255 blocks; and within its twin's
    tolerance (dist exact, rate 1e-5 relative)."""
    n = 1 << lg
    res = torch.cat([_residuals(n, 200, seed=80 + lg + qp),
                     torch.zeros((2, n, n), dtype=torch.int32),
                     torch.full((1, n, n), 255, dtype=torch.int32),
                     torch.full((1, n, n), -255, dtype=torch.int32)]).to(
        cuda_device)
    before = _build.LAUNCHES["tq_cost"]
    dist, rate = transform.tq_cost(res, qp, lg, is_intra=intra)
    assert _build.LAUNCHES["tq_cost"] == before + 1
    lv, rq = transform.tq_roundtrip(res, qp, lg, is_intra=intra)
    d4, r4 = cost.sse_rate(res, rq, lv)
    assert torch.equal(dist, d4)
    assert torch.equal(rate, r4)
    dp, rp = transform.tq_cost_plain(res, qp, lg, is_intra=intra)
    assert torch.equal(dist, dp)
    torch.testing.assert_close(rate, rp, rtol=1e-5, atol=0)
    assert (rate[-4:-2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_sse_rate_kernel_matches_twin(cuda_device, n):
    res = _residuals(n, 500, seed=40 + n).to(cuda_device)
    lv, rq = transform.tq_roundtrip_plain(res, 32, n.bit_length() - 1)
    dk, rk = cost.sse_rate(res, rq, lv)
    dp, rp = cost.sse_rate_plain(res, rq, lv)
    assert torch.equal(dk, dp)
    # f32 log2 terms summed in another order: 1e-5 relative, as on the CPU
    torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rdoq", [False, True])
@pytest.mark.parametrize("w,h,qp,tiles", [(96, 64, 32, ()), (104, 72, 27, ()),
                                          (128, 96, 30, (64,))])
def test_commit_kernel_matches_twin(cuda_device, rdoq, w, h, qp, tiles):
    y, cb, cr, depth, mode, ls = _group(w, h, 2, w + qp, qp, cuda_device)
    lam = float(torch.tensor(ls, dtype=torch.float32) ** 2)
    args = (y[:, :h, :w], cb[:, :h // 2, :w // 2], cr[:, :h // 2, :w // 2],
            depth, mode, qp, qp, qp, w, h, True, tiles, ())
    before = _build.LAUNCHES["commit_intra"]
    got = commit.wavefront_commit_intra(*args, rdoq=rdoq, lam=lam)
    want = commit.wavefront_commit_intra(*args, rdoq=rdoq, lam=lam,
                                         plain=True)
    assert _build.LAUNCHES["commit_intra"] > before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _dir_map(form, shape, seed):
    """A direction map [F, gh, gw]: all intra (0), all inter (1) or a
    seeded mix of 0-3 (K5 reads it at each CU's top-left granule)."""
    if form == "intra":
        return torch.zeros(shape, dtype=torch.int32)
    if form == "inter":
        return torch.ones(shape, dtype=torch.int32)
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random(shape) < 0.6)
                            * rng.integers(1, 4, shape)).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("rdoq", [False, True])
@pytest.mark.parametrize("form", ["intra", "inter", "mixed"])
@pytest.mark.parametrize("frames", [1, 3])
def test_one_launch_commit_matches_twin(cuda_device, rdoq, form, frames):
    """K5's one dependency-driven launch against its twin, bit for bit, on
    a coded size off the CTU grid with two tile columns and two tile rows,
    per-frame QPs, all-intra, all-inter and mixed direction maps."""
    w, h, tiles = 136, 104, ((64,), (64,))
    y, cb, cr, depth, mode, ls = _group(w, h, frames, 7 + frames, 30,
                                        cuda_device)
    rng = np.random.default_rng(frames)
    pred = [torch.from_numpy(rng.integers(0, 256, (frames, hh, ww))
                             .astype(np.int32)).to(cuda_device)
            for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    dm = _dir_map(form, depth.shape, 90 + frames).to(cuda_device)
    qps = [30 + 2 * i for i in range(frames)]
    lam = [float(torch.tensor(ls, dtype=torch.float32) ** 2)] * frames
    args = (y[:, :h, :w], cb[:, :h // 2, :w // 2], cr[:, :h // 2, :w // 2],
            depth, mode, dm, *pred, qps, qps, qps, w, h, True, *tiles)
    before = _build.LAUNCHES["commit_mixed"]
    got = commit.wavefront_commit_mixed(*args, rdoq=rdoq, lam=lam)
    assert _build.LAUNCHES["commit_mixed"] == before + 1
    want = commit.wavefront_commit_mixed(*args, rdoq=rdoq, lam=lam,
                                         plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if form == "intra":
        # the intra form (its trellis on init_type 0, the mixed form's on 1)
        iargs = (*args[:5], qps, qps, qps, w, h, True, *tiles)
        before = _build.LAUNCHES["commit_intra"]
        got = commit.wavefront_commit_intra(*iargs, rdoq=rdoq, lam=lam)
        assert _build.LAUNCHES["commit_intra"] == before + 1
        want = commit.wavefront_commit_intra(*iargs, rdoq=rdoq, lam=lam,
                                             plain=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_deblock_kernel_matches_twin(cuda_device):
    rng = np.random.default_rng(50)
    depth = torch.from_numpy(rng.integers(0, 3, (3, 12, 16)).astype(np.int32))
    # smooth planes, so that strong, weak and unfiltered segments all occur
    base = rng.integers(60, 200, (3, 1, 1))
    planes = [torch.from_numpy((base + rng.integers(-k, k + 1, (3, hh, ww)))
                               .clip(0, 255).astype(np.int32))
              for k, hh, ww in ((6, 96, 128), (3, 48, 64), (9, 48, 64))]
    args = [p.to(cuda_device) for p in planes] + [depth.to(cuda_device)]
    for qp in (22, 37):
        got = deblock.deblock(*args, qp, qp + 1, qp - 1, 5)
        want = deblock.deblock(*args, qp, qp + 1, qp - 1, 5, plain=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_sao_kernel_matches_twin(cuda_device):
    rng = np.random.default_rng(51)
    src = [rng.integers(0, 256, (2, hh, ww)) for hh, ww in
           ((72, 104), (36, 52), (36, 52))]
    rec = [np.clip(s + rng.integers(-6, 7, s.shape), 0, 255) for s in src]
    args = [torch.from_numpy(a.astype(np.int32)).to(cuda_device)
            for a in src + rec]
    before = dict(_build.LAUNCHES)
    got = sao.sao(*args, 5)
    want = sao.sao(*args, 5, plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert _build.LAUNCHES["sao_fused"] == before.get("sao_fused", 0) + 1
    assert _build.LAUNCHES.get("sao", 0) == before.get("sao", 0)


def _sao_planes(frames, h, w, seed, device="cpu"):
    """Seeded (src, rec) lists of [frames, h, w] planes (chroma halved):
    smooth content with noise, rec within +-5 of src, between flat
    extremes above and below (rec 0 or 6 under src 0, 249 or 255 under
    src 255: band offsets of -3 and +3 that clip)."""
    rng = np.random.default_rng(seed)
    src, rec = [], []
    for c in range(3):
        hh, ww = h >> (c > 0), w >> (c > 0)
        yy, xx = np.mgrid[0:hh, 0:ww]
        s = (110 + 60 * np.sin(xx / 5.0) * np.cos(yy / 3.0))[None]
        s = np.clip(s + rng.integers(-3, 4, (frames, hh, ww)), 0, 255)
        r = np.clip(s + rng.integers(-5, 6, s.shape), 0, 255)
        step = np.where(xx < ww // 2, 6, 0)[None]
        top, bottom = yy[:, 0] < hh // 3, yy[:, 0] >= hh - hh // 3
        r[:, top], s[:, top] = step[:, top], 0
        r[:, bottom], s[:, bottom] = 255 - step[:, bottom], 255
        src.append(torch.from_numpy(s.astype(np.int32)).to(device))
        rec.append(torch.from_numpy(r.astype(np.int32)).to(device))
    return src, rec


@pytest.mark.cuda
@pytest.mark.parametrize("lg,h,w,frames", [
    (4, 48, 64, 1), (4, 40, 56, 3), (5, 64, 96, 2), (5, 72, 104, 4),
    (5, 1080 // 8, 1920 // 8, 1), (6, 128, 128, 2), (6, 88, 120, 1),
    (6, 136, 200, 4)])
def test_sao_fused_kernel_matches_twin_and_earlier_form(cuda_device, lg, h,
                                                        w, frames):
    """K7's fused form at CTU 16, 32 and 64, on and off the CTB grid, F =
    1-4: bit for bit its twin and the earlier two-launch form, one launch
    a call."""
    src, rec = _sao_planes(frames, h, w, seed=lg * 1000 + h + frames,
                           device=cuda_device)
    before = dict(_build.LAUNCHES)
    got = sao.sao(*src, *rec, lg)
    assert _build.LAUNCHES["sao_fused"] == before.get("sao_fused", 0) + 1
    earlier = sao.sao_two_pass(*src, *rec, lg)
    assert _build.LAUNCHES["sao"] == before.get("sao", 0) + 2
    want = sao.sao(*src, *rec, lg, plain=True)
    for a, b, c in zip(got, want, earlier):
        assert torch.equal(a, b)
        assert torch.equal(c, b)
    assert set(want[3][..., 0].unique().tolist()) >= {1, 2}


@pytest.mark.cuda
def test_checksum_kernel_matches_twin(cuda_device):
    rng = np.random.default_rng(52)
    planes = torch.from_numpy(rng.integers(0, 256, (3, 300, 520))
                              .astype(np.uint8)).to(cuda_device)
    assert torch.equal(device_pipeline.device_checksum(planes),
                       device_pipeline.device_checksum(planes, plain=True))


def _deblock_case(frames, h, w, seed, device, inter=True, ref=True):
    """Seeded smooth planes (chroma halved), CU depths and, with `inter`,
    P/B granule maps on 16x16 blocks (directions 0-3, MVs within a
    quarter sample but for a few whole samples off, reference indices
    mostly 0, levels with a few nonzero values): (planes, depth, maps,
    levels) on `device`, maps None when intra."""
    rng = np.random.default_rng(seed)
    gh, gw = h // 8, w // 8
    planes = []
    for c, k in enumerate((3, 2, 4)):
        hh, ww = h >> (c > 0), w >> (c > 0)
        yy, xx = np.mgrid[0:hh, 0:ww]
        base = 120 + 40 * np.sin(xx / 9.0) * np.cos(yy / 7.0) \
            + 8 * ((xx // 8 + yy // 8) % 2)
        planes.append(torch.from_numpy(np.clip(
            base + rng.integers(-k, k + 1, (frames, hh, ww)), 0, 255)
            .astype(np.int32)).to(device))
    depth = torch.from_numpy(rng.integers(0, 3, (frames, gh, gw))
                             .astype(np.int32)).to(device)
    lv = torch.from_numpy(((rng.random((frames, h, w)) < 0.004)
                           * rng.integers(-2, 3, (frames, h, w)))
                          .astype(np.int16)).to(device)
    if not inter:
        return planes, depth, None, lv
    d = (rng.choice([0, 1, 1, 1, 2, 3], (frames, gh // 2 + 1, gw // 2 + 1))
         .repeat(2, 1).repeat(2, 2)[:, :gh, :gw])
    mv = (rng.integers(-1, 2, (frames, gh, gw, 4))
          + 8 * (rng.random((frames, gh, gw, 1)) < 0.15))
    rm = (rng.random((frames, gh, gw, 2)) < 0.1)
    maps = dict(dir_map=torch.from_numpy(d.astype(np.int32)).to(device),
                mv_map=torch.from_numpy(mv.astype(np.int32)).to(device),
                ref_map=(torch.from_numpy(rm.astype(np.int32)).to(device)
                         if ref else None))
    return planes, depth, maps, lv


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["intra", "pb", "pb_noref", "window",
                                  "window_intra"])
@pytest.mark.parametrize("frames,h,w", [(1, 72, 104), (8, 64, 96),
                                        (1, 1080, 1920), (3, 136, 200)])
def test_deblock_fused_kernel_matches_twin(cuda_device, form, frames, h, w):
    """K6's one-launch form (with K6's CTU cbf pass on P/B pictures): bit
    for bit its twin and the earlier two-launch form, intra, P/B with
    every strength 0/1/2 present (with and without a reference map) and
    the tile-column form (x0 = t*w - 8 on a plane extended by 8 columns
    each side), frame counts 1-8, heights off the CTU grid; one launch a
    call (two with the cbf pass), none of the earlier forms."""
    planes, depth, maps, lv = _deblock_case(
        frames, h, w, 60 + h + frames, cuda_device,
        inter=form in ("pb", "pb_noref", "window"), ref=form == "pb")
    kw = {}
    if maps is not None:
        before = dict(_build.LAUNCHES)
        cbf = deblock.tu_cbf_ctu(lv, depth, 5)
        assert _build.LAUNCHES["deblock_cbf_ctu"] == before.get(
            "deblock_cbf_ctu", 0) + 1
        assert torch.equal(cbf, deblock.tu_cbf(lv, depth, 5, plain=True))
        kw = dict(maps, cbf=cbf)
        bsv, _ = deblock.inter_bs_maps(depth, maps["dir_map"],
                                       maps["mv_map"], cbf,
                                       maps["ref_map"])
        assert set(bsv.unique().tolist()) >= {0, 1, 2}
    name = ("deblock_fused_window" if form.startswith("window")
            else "deblock_fused" if form == "intra" else "deblock_fused_bs")
    if form.startswith("window"):
        kw.pop("ref_map", None)
        kw.update(x0=w - 8, pic_w=4 * w)
    qps = ([30 + k for k in range(frames)], [31] * frames,
           [29 + k % 3 for k in range(frames)])
    before = dict(_build.LAUNCHES)
    got = deblock.deblock_fused(*planes, depth, *qps, 5, **kw)
    after = dict(_build.LAUNCHES)
    assert after.get(name, 0) == before.get(name, 0) + 1
    assert sum(after.values()) == sum(before.values()) + 1
    want = deblock.deblock(*planes, depth, *qps, 5, plain=True, **kw)
    earlier = deblock.deblock(*planes, depth, *qps, 5, **kw)
    changed = 0
    for a, b, c, src in zip(got, want, earlier, planes):
        assert torch.equal(a, b)
        assert torch.equal(c, b)
        changed += int((a != src).sum())
    assert changed > 0


@pytest.mark.cuda
@pytest.mark.parametrize("frames,h,w,lg", [(1, 72, 104, 5), (8, 64, 96, 5),
                                           (2, 1080, 1920, 5),
                                           (2, 136, 200, 6),
                                           (1, 40, 56, 4)])
def test_deblock_cbf_ctu_kernel_matches_twin(cuda_device, frames, h, w, lg):
    """K6's cbf pass a CTA a CTU: the twin's CU cbf bit for bit, on and off
    the CTU grid (CUs that overflow it read 0), CTU 16-64."""
    rng = np.random.default_rng(h * w + lg)
    depth = torch.from_numpy(rng.integers(0, lg - 2, (frames, h // 8,
                                                      w // 8))
                             .astype(np.int32)).to(cuda_device)
    lv = torch.from_numpy(((rng.random((frames, h, w)) < 0.002)
                           * rng.integers(-3, 4, (frames, h, w)))
                          .astype(np.int16)).to(cuda_device)
    got = deblock.tu_cbf_ctu(lv, depth, lg)
    want = deblock.tu_cbf(lv, depth, lg, plain=True)
    assert torch.equal(got, want)
    assert torch.equal(deblock.tu_cbf(lv, depth, lg), want)
    assert 0 < int(want.sum()) < want.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("frames,h,w", [(1, 38, 56), (3, 72, 104),
                                        (8, 64, 96), (1, 1080, 1920)])
def test_cast_checksum_kernel_matches_twin(cuda_device, checksum, frames, h,
                                           w):
    """K8's cast form: the uint8 casts and checksums of its twin bit for
    bit, with and without the checksum, at odd plane sizes, on contiguous
    planes and on column slices of wider ones (the sharded route's
    windows); one launch a call; the checksums equal the earlier form's."""
    rng = np.random.default_rng(h + w + frames)
    planes = [torch.from_numpy(rng.integers(0, 256, (frames, h >> (c > 0),
                                                     w >> (c > 0)))
                               .astype(np.int32)).to(cuda_device)
              for c in range(3)]
    wide = [torch.nn.functional.pad(p, (8 >> (c > 0), 8 >> (c > 0)),
                                    value=7)
            for c, p in enumerate(planes)]
    views = [p[..., (8 >> (c > 0)):-(8 >> (c > 0))]
             for c, p in enumerate(wide)]
    name = "cast_checksum" if checksum else "cast"
    for src in (planes, views):
        before = dict(_build.LAUNCHES)
        *got, ck = device_pipeline.cast_checksum(*src, checksum)
        after = dict(_build.LAUNCHES)
        assert after.get(name, 0) == before.get(name, 0) + 1
        assert sum(after.values()) == sum(before.values()) + 1
        *want, wck = device_pipeline.cast_checksum(*src, checksum,
                                                   plain=True)
        for a, b in zip(got, want):
            assert a.is_contiguous() and torch.equal(a, b)
        if checksum:
            assert torch.equal(ck, wck)
            assert torch.equal(ck, torch.stack(
                [device_pipeline.device_checksum(p) for p in got], dim=1))
        else:
            assert ck is None and wck is None


def _p_inputs(w, h, seed, device):
    """A P frame of a seeded synthesized clip and its two predecessors as
    references, luma int32 on `device`: (y [H, W], refs [2, H, W])."""
    clip = synthesize_yuv(w, h, 3, seed=seed)
    fr = [torch.from_numpy(np.asarray(c[0], np.int32)) for c in clip]
    return fr[2].to(device), torch.stack([fr[1], fr[0]]).to(device)


def _old_me_state(y, refs, sr, ctu, plain):
    """The earlier integer stage: downsample4 and the five sad_search
    calls (the coarse tiers, the tier refinements, the 8-blocks), one
    search a launch.  Returns ({tier: base}, {n: mv_int})."""
    tiers = [n for n in (16, 32, 64) if n <= ctu]
    if sr <= 8:
        base = {n: me.sad_search(y, refs, None, n, sr, n, 1, sr,
                                 plain=plain) for n in tiers}
    else:
        ds = me.downsample4(torch.cat([y[None], refs]), plain=plain)
        sr4 = -(-sr // 4)
        base = {n: me.sad_search(ds[0], ds[1:], None, n // 4, sr4, n // 4,
                                 4, sr, plain=plain) for n in tiers}
    mv = {n: me.sad_search(y, refs, base[n], n, 3, n, 1, sr, plain=plain)
          for n in tiers}
    mv[8] = me.sad_search(y, refs, base[16], 8, 3, 16, 1, sr, plain=plain)
    return base, mv


@pytest.mark.cuda
@pytest.mark.parametrize("sr,nref,ctu", [(8, 1, 32), (8, 2, 32),
                                         (64, 1, 32), (64, 2, 32),
                                         (64, 2, 64)])
def test_me_kernels_match_twins(cuda_device, sr, nref, ctu):
    """K9 and K10 against their twins; at CTU 64 the tier-64 search and
    K10's 64-blocks (shared memory above the 48 KB default).  me_state
    runs K9's fused form (me_coarse, me_fine); the earlier form
    (sad_search, five launches) is held against its twin and against the
    fused form."""
    y, refs = _p_inputs(128, 96 if ctu == 32 else 128, 60 + sr, cuda_device)
    refs = refs[:nref].contiguous()
    before = dict(_build.LAUNCHES)
    got = me.me_state(y, refs, sr, max_size=ctu)
    want = me.me_state(y, refs, sr, max_size=ctu, plain=True)
    assert (64 in got.mv_int) == (ctu == 64)
    for n in got.base:
        assert torch.equal(got.base[n], want.base[n])
    for n in got.mv_int:
        assert torch.equal(got.mv_int[n], want.mv_int[n])
    ls = float(np.sqrt(0.57 * 2.0 ** ((32 - 12) / 3.0)))
    sk = me.subpel_from_state(got, ls)
    sp = me.subpel_from_state(want, ls, plain=True)
    for n in sk:
        for a, b in zip(sk[n], sp[n]):
            assert torch.equal(a, b)        # f32 costs bit for bit
    names = ["me_coarse", "me_fine", "subpel"] + (["me_downsample4"]
                                                  if sr > 8 else [])
    for name in names:
        assert _build.LAUNCHES[name] == before.get(name, 0) + (
            len(sk) if name == "subpel" else 1), name
    for name in ("me_full_search", "me_refine"):
        assert _build.LAUNCHES.get(name, 0) == before.get(name, 0), name
    old = _old_me_state(y, refs, sr, ctu, False)
    old_twin = _old_me_state(y, refs, sr, ctu, True)
    for a, b, c in zip(old, old_twin, (want.base, want.mv_int)):
        for n in c:
            assert torch.equal(a[n], b[n]) and torch.equal(a[n], c[n])
    assert _build.LAUNCHES["me_full_search"] == before.get(
        "me_full_search", 0) + len(got.base)
    assert _build.LAUNCHES["me_refine"] == before.get(
        "me_refine", 0) + len(got.base) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("ctu", [32, 64])
@pytest.mark.parametrize("sr", [8, 64])
@pytest.mark.parametrize("r", [1, 2, 4])
def test_me_coarse_and_fine_kernels_match_twins(cuda_device, r, sr, ctu):
    """K9's fused form against its twins, which search one tier at a time:
    me_state on R references of a 192x128 picture; me_fine on seeded
    bases within +-64, every third block's at +-64 on both axes, so that
    the windows of the blocks at the picture's edges leave it; and a flat
    picture, where every offset ties and the first must win.  One launch
    of each a call."""
    w, h = 192, 128
    clip = synthesize_yuv(w, h, r + 1, seed=100 + r + sr + ctu)
    fr = [torch.from_numpy(np.asarray(c[0], np.int32)) for c in clip]
    y, refs = fr[r].to(cuda_device), torch.stack(fr[:r]).to(cuda_device)
    tiers = [n for n in (16, 32, 64) if n <= ctu]
    flat = torch.full_like(y, 77)
    rng = np.random.default_rng(r + sr + ctu)
    base = {}
    for n in tiers:
        b = rng.integers(-64, 65, (r, (h // n) * (w // n), 2))
        b[:, ::3] = np.where(b[:, ::3] < 0, -64, 64)
        base[n] = torch.from_numpy(b.astype(np.int32)).to(cuda_device)
    before = dict(_build.LAUNCHES)
    calls = 0
    for yy, rr in ((y, refs), (flat, flat[None].repeat(r, 1, 1))):
        got = me.me_state(yy, rr, sr, max_size=ctu)
        want = me.me_state(yy, rr, sr, max_size=ctu, plain=True)
        for n in want.base:
            assert torch.equal(got.base[n], want.base[n]), n
        assert list(got.mv_int) == list(want.mv_int)
        for n in want.mv_int:
            assert torch.equal(got.mv_int[n], want.mv_int[n]), n
        calls += 1
    # the flat picture: the first offset wins, the corner of the range
    assert int(got.base[16].min()) == -sr and int(got.mv_int[8].min()) == -sr
    got = me.me_fine(y, refs, base, 64, tiers)
    want = me.me_fine(y, refs, base, 64, tiers, plain=True)
    for n in want:
        assert torch.equal(got[n], want[n]), n
    assert _build.LAUNCHES["me_coarse"] == before.get("me_coarse", 0) + calls
    assert _build.LAUNCHES["me_fine"] == before.get("me_fine", 0) + calls + 1


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_subpel_kernel_matches_twin(cuda_device, n, r):
    """K10 against its twin on R references of a 128x128 picture: integer
    MVs within +-64 (SR 64), every fourth block's at +-64 on both axes,
    far out of the picture from the blocks near its edges; then a flat
    picture at lambda_sqrt 0, where all 17 candidates tie and the first
    must win.  Costs bit for bit."""
    clip = synthesize_yuv(128, 128, r + 1, seed=80 + n)
    fr = [torch.from_numpy(np.asarray(c[0], np.int32)) for c in clip]
    y, refs = fr[r].to(cuda_device), torch.stack(fr[:r]).to(cuda_device)
    b = (128 // n) ** 2
    rng = np.random.default_rng(n + r)
    mv = rng.integers(-64, 65, (r, b, 2))
    mv[:, ::4] = np.where(mv[:, ::4] < 0, -64, 64)
    mv = torch.from_numpy(mv.astype(np.int32)).to(cuda_device)
    ls = float(np.sqrt(0.57 * 2.0 ** ((32 - 12) / 3.0)))
    flat = torch.full_like(y, 77)
    before = _build.LAUNCHES["subpel"]
    for args in ((y, refs, mv, n, ls),
                 (flat, flat[None].repeat(r, 1, 1), mv, n, 0.0)):
        got = me.subpel(*args)
        want = me.subpel(*args, plain=True)
        for a, c in zip(got, want):
            assert torch.equal(a, c)        # f32 costs bit for bit
    assert torch.equal(got[1], 4 * mv - 2)
    assert _build.LAUNCHES["subpel"] == before + 2


@pytest.mark.cuda
def test_mc_kernels_match_twins(cuda_device):
    y, refs = _p_inputs(128, 96, 70, cuda_device)
    st = me.me_state(y, refs, 64, plain=True)
    rng = np.random.default_rng(71)
    for n in (8, 16, 32):
        b = (128 // n) * (96 // n)
        mvq = torch.from_numpy(rng.integers(-300, 301, (b, 2))
                               .astype(np.int32)).to(cuda_device)
        sel = torch.from_numpy(rng.integers(0, 2, b).astype(bool)).to(
            cuda_device)
        got = me.mc_raw_from_state_sel(st, 0, 1, sel, n, mvq)
        want = me.mc_raw_from_state_sel(st, 0, 1, sel, n, mvq, plain=True)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])
    clip = synthesize_yuv(128, 96, 2, seed=72)
    ref = tuple(torch.stack([torch.stack([torch.from_numpy(
        np.asarray(clip[k][p], np.int32)) for k in range(2)])] * 2).to(
            cuda_device) for p in range(3))
    d = torch.from_numpy(rng.integers(0, 4, (2, 12, 16)).astype(np.int32))
    mv = torch.from_numpy(rng.integers(-90, 91, (2, 12, 16, 4))
                          .astype(np.int32))
    rm = torch.from_numpy(rng.integers(0, 2, (2, 12, 16, 2)).astype(np.int32))
    d, mv, rm = d.to(cuda_device), mv.to(cuda_device), rm.to(cuda_device)
    for ref1, dirs, rmap in ((None, (d > 0).to(torch.int32), None),
                             (ref, d, rm)):
        got = me.inter_pred_planes(ref, ref1, dirs, mv, ref_map=rmap)
        want = me.inter_pred_planes(ref, ref1, dirs, mv, ref_map=rmap,
                                    plain=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _planes_args(frames, nref, bi, use_rm, kind, seed, device,
                 w=128, h=96):
    """inter_pred_planes' (ref0, ref1, dir, mv, ref_map) on a seeded clip:
    [F, R, H, W] stacks of each list, directions 0-3 (0-1 for P), MVs of
    `kind`: random (+-90 quarter pels), integer (multiples of 4 and 8) or
    far (+-(4 * 64 + 3) and near it)."""
    rng = np.random.default_rng(seed)
    clip = synthesize_yuv(w, h, 3, seed=seed)

    def stack(order):
        return tuple(torch.from_numpy(np.stack([np.stack([np.asarray(
            clip[k][c], np.int32) for k in order[:nref]])] * frames)).to(
                device) for c in range(3))

    shape = (frames, h // 8, w // 8)
    d = rng.integers(0, 4 if bi else 2, shape)
    if kind == "integer":
        mv = 4 * rng.integers(-20, 21, shape + (4,))
    elif kind == "far":
        mv = rng.choice([-259, -258, -257, -256, 256, 257, 258, 259],
                        shape + (4,))
    else:
        mv = rng.integers(-90, 91, shape + (4,))
    rm = (torch.from_numpy(rng.integers(0, nref, shape + (2,))
                           .astype(np.int32)).to(device) if use_rm else None)
    return (stack([1, 0]), stack([2, 0]) if bi else None,
            torch.from_numpy(d.astype(np.int32)).to(device),
            torch.from_numpy(mv.astype(np.int32)).to(device), rm)


@pytest.mark.cuda
@pytest.mark.parametrize("bi", [False, True])
@pytest.mark.parametrize("nref,use_rm", [(1, False), (2, False), (2, True)])
@pytest.mark.parametrize("kind", ["random", "integer", "far"])
def test_inter_planes_kernel_matches_twin_and_earlier_form(
        cuda_device, bi, nref, use_rm, kind):
    """K11's planes form for P and B, one and two references a list, with
    and without a ref_map, at random, integer and far MVs: bit for bit its
    twin and the earlier form a component, one launch a call."""
    frames = 1 + bi
    args = _planes_args(frames, nref, bi, use_rm, kind,
                        seed=60 + 4 * bi + 2 * nref + use_rm + len(kind),
                        device=cuda_device)
    name = "inter_pred_fused_bi" if bi else "inter_pred_fused"
    before = dict(_build.LAUNCHES)
    got = me.inter_pred_planes(*args[:4], ref_map=args[4])
    assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    earlier = me.inter_pred_planes_by_comp(*args[:4], ref_map=args[4])
    old = "inter_pred_bi" if bi else "inter_pred"
    assert _build.LAUNCHES[old] == before.get(old, 0) + 3
    want = me.inter_pred_planes(*args[:4], ref_map=args[4], plain=True)
    for a, b, c in zip(got, want, earlier):
        assert torch.equal(a, b)
        assert torch.equal(c, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16, 32, 64])
@pytest.mark.parametrize("lists", [1, 2])
@pytest.mark.parametrize("edge", [-1, 1])
def test_mc_merge_kernel_matches_twin(cuda_device, n, lists, edge):
    """K11's merge form against its twin (mc_sel's and K2's twins and the
    fold's strict <, one candidate at a time) on a four-reference state of
    a 192x128 picture: MVs near the base and far out of the picture (the
    tier window test fails, `valid` false), mixed refs, one or both lists
    in a launch, a shard's picture edge at grid column 1 or none, and in
    every fourth block an ME cost equal to the best candidate's, which
    must not win.  Costs bit for bit; one launch a call."""
    w, h = 192, 128
    clip = synthesize_yuv(w, h, 5, seed=120 + n)
    fr = [torch.from_numpy(np.asarray(c[0], np.int32)) for c in clip]
    refs = torch.stack([fr[1], fr[0], fr[3], fr[4]]).to(cuda_device)
    st = me.me_state(fr[2].to(cuda_device), refs, 64, max_size=64,
                     plain=True)
    b = (h // n) * (w // n)
    rng = np.random.default_rng(n + lists + edge)
    args = []
    for ia, ib in ((0, 1), (2, 3))[:lists]:
        mv = rng.integers(-24, 25, (b, 2))
        mv[::4] = rng.integers(-259, 260, (b, 2))[::4]
        t = [torch.from_numpy(a).to(cuda_device) for a in (
            mv.astype(np.int32), rng.integers(0, 2, b).astype(np.int32),
            rng.integers(0, 256, (b, n, n)).astype(np.int32),
            rng.uniform(0, 40 * n * n, b).astype(np.float32))]
        t.append(me.mv_rate_bits(t[0]))
        # the cost the fold reaches from inf, as the ME cost of every
        # fourth block: a tie, which strict < leaves to the ME winner
        inf = torch.full_like(t[3], float("inf"))
        best = me.mc_merge_plain(st, [(ia, ib, *t[:3], inf, t[4])], n,
                                 9.75, edge)[0][3]
        tie = (torch.arange(b, device=cuda_device) % 4 == 0) & best.isfinite()
        t[3] = torch.where(tie, best, t[3])
        args.append((ia, ib, *t))
    before = _build.LAUNCHES["mc_merge"]
    got = me.mc_merge(st, args, n, 9.75, edge)
    assert _build.LAUNCHES["mc_merge"] == before + 1
    want = me.mc_merge(st, args, n, 9.75, edge, plain=True)
    assert len(got) == lists
    merged = 0
    for g, wl, a in zip(got, want, args):
        for x, y in zip(g, wl):
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y)
        merged += int((g[4] == 2.0).sum())
        assert torch.equal(g[2][g[4] != 2.0], a[4][g[4] != 2.0])
    assert merged > 0


def _p_group(w, h, seed, device, nref=2):
    """A P frame, its two references and its decisions from the P search
    (twins, on the CPU): the mixed commit's and the BS deblock's inputs."""
    clip = synthesize_yuv(w, h, 3, seed=seed)
    ph, pw = -(-h // 32) * 32, -(-w // 32) * 32

    def plane(k, i, hh, ww):
        return torch.from_numpy(pad_plane(np.asarray(clip[k][i], np.int32),
                                          hh, ww))

    y = plane(2, 0, ph, pw)
    refs = torch.stack([plane(1, 0, ph, pw), plane(0, 0, ph, pw)])
    ls = float(np.sqrt(0.57 * 2.0 ** ((32 - 12) / 3.0)))
    pk = search_p_maps(y[None], refs[None], [ls], 5, 3, w, h, 64,
                       nref=[nref])[0]
    gh, gw = h // 8, w // 8
    maps = [pk[:gh, :gw, k].to(torch.int32) for k in (0, 1, 2)]
    mv = pk[:gh, :gw, 3:7].to(torch.int32)
    rm = pk[:gh, :gw, 7:9].to(torch.int32)
    src = [torch.from_numpy(np.asarray(clip[2][i], np.int32)) for i in
           range(3)]
    ref = [torch.stack([torch.from_numpy(np.asarray(clip[k][i], np.int32))
                        for k in (1, 0)]) for i in range(3)]
    out = [t[None].to(device) for t in src + maps + [mv, rm]]
    return out + [tuple(r[None].to(device) for r in ref), ls]


@pytest.mark.cuda
@pytest.mark.parametrize("rdoq", [False, True])
def test_mixed_commit_and_bs_deblock_match_twins(cuda_device, rdoq):
    w, h = 96, 64
    sy, scb, scr, dm, mm, im, mv, rm, ref, ls = _p_group(w, h, 80,
                                                         cuda_device)
    assert bool((im > 0).any()) and bool((im == 0).any())
    pred = me.inter_pred_planes(ref, None, im, mv, ref_map=rm)
    lam = float(torch.tensor(ls, dtype=torch.float32) ** 2)
    args = (sy, scb, scr, dm, mm, im, *pred, [32], [33], [33], w, h, True)
    before = _build.LAUNCHES["commit_mixed"]
    got = commit.wavefront_commit_mixed(*args, rdoq=rdoq, lam=[lam])
    want = commit.wavefront_commit_mixed(*args, rdoq=rdoq, lam=[lam],
                                         plain=True)
    assert _build.LAUNCHES["commit_mixed"] > before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    before = _build.LAUNCHES["deblock_bs"], _build.LAUNCHES["deblock_cbf"]
    cbf = deblock.tu_cbf(got[3], dm, 5)
    assert torch.equal(cbf, deblock.tu_cbf(got[3], dm, 5, plain=True))
    dargs = (*got[:3], dm, [32], [33], [33], 5)
    kw = dict(dir_map=im, mv_map=mv, ref_map=rm, cbf=cbf)
    dk = deblock.deblock(*dargs, **kw)
    for a, b in zip(dk, deblock.deblock(*dargs, plain=True, **kw)):
        assert torch.equal(a, b)
    assert (_build.LAUNCHES["deblock_bs"],
            _build.LAUNCHES["deblock_cbf"]) == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_bi_cost_kernel_matches_twin(cuda_device):
    """K12 on an ME state of four references, with MVs far enough out to
    clamp at every picture edge (|mvx| + |mvy| within the rate table)."""
    y, refs = _p_inputs(128, 128, 90, cuda_device)
    refs = torch.cat([refs, refs.flip(0)])
    st = me.me_state(y, refs, 64, plain=True)
    rng = np.random.default_rng(91)
    before = _build.LAUNCHES["bi_cost"]
    for n in (8, 16, 32, 64):
        b = (128 // n) ** 2
        mvs = [torch.from_numpy(rng.integers(-259, 260, (b, 2)).astype(
            np.int32)).to(cuda_device) for _ in range(2)]
        sel0 = torch.from_numpy(rng.integers(0, 2, b)).to(cuda_device)
        sel1 = torch.from_numpy(rng.integers(2, 4, b)).to(cuda_device)
        rates = [me.mv_rate_bits(m) for m in mvs]
        args = (st.y, st.refs, mvs[0], sel0, mvs[1], sel1, *rates, 9.75, n)
        got, want = me.bi_cost(*args), me.bi_cost(*args, plain=True)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert _build.LAUNCHES["bi_cost"] == before + 4


def _bi_select_args(y, refs, n, seed):
    """bi_select's inputs on an ME state's y and refs (two lists of
    len(refs) / 2 references): MVs far enough out to clamp at every
    picture edge, each list's reference drawn per block, and the lists'
    costs planted around the BI cost (its twin's): ties c0 == cbi, c1 ==
    cbi, c0 == c1, an inf c1, both inf, and outright wins of each
    direction; p0 and p1 noise."""
    dev = y.device
    h, w = y.shape
    b = (h // n) * (w // n)
    half = refs.shape[0] // 2
    rng = np.random.default_rng(seed)
    mvs = [torch.from_numpy(rng.integers(-259, 260, (b, 2)).astype(
        np.int32)).to(dev) for _ in range(2)]
    sel0 = torch.from_numpy(rng.integers(0, half, b).astype(np.int32)).to(dev)
    sel1 = torch.from_numpy(rng.integers(half, 2 * half, b).astype(
        np.int32)).to(dev)
    rates = [me.mv_rate_bits(m) for m in mvs]
    ls = _ls(32)
    _, cbi = me.bi_cost_plain(y, refs, mvs[0], sel0, mvs[1], sel1, *rates,
                              ls, n)
    plant = torch.tensor([[0, 5], [1, float("inf")], [1, 0], [-1, -1],
                          [float("inf"), float("inf")], [-1, 5], [1, -2],
                          [1, 5]], device=dev)[torch.arange(b, device=dev)
                                               % 8]
    c0, c1 = cbi + plant[:, 0], cbi + plant[:, 1]
    p0, p1 = (torch.from_numpy(rng.integers(0, 256, (b, n, n)).astype(
        np.int32)).to(dev) for _ in range(2))
    return (y, refs, mvs[0], sel0, mvs[1], sel1, *rates, c0, c1, p0, p1, ls,
            n)


@pytest.mark.cuda
@pytest.mark.parametrize("nref", [1, 2])
@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_bi_select_kernel_matches_twin(cuda_device, n, nref):
    """K12's selected form against its twin, bit for bit (pred_sel,
    dchoice and the f32 bits of rate_sel), with one and two references a
    list, far MVs and ties and inf among c0, c1 and cbi; one launch."""
    y, refs = _p_inputs(128, 128, 94, cuda_device)
    refs = refs[:nref]
    st = me.me_state(y, torch.cat([refs, refs.flip(0)]), 64, plain=True)
    args = _bi_select_args(st.y, st.refs, n, seed=95 + n)
    before = _build.LAUNCHES["bi_select"]
    got, want = me.bi_select(*args), me.bi_select_plain(*args)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(got[2], want[2])
    assert set(want[2].tolist()) == {0, 1, 2}
    assert _build.LAUNCHES["bi_select"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["p", "b"])
def test_ctu64_searches_match_twins(cuda_device, kind):
    """The P and B searches at CTU 64 on the card against their twins:
    K11's merge form, K10 and K12 on 64-blocks, K9's fused form at tier
    64; the earlier forms (sad_search, mc_sel, K2) are not launched."""
    clip = synthesize_yuv(128, 128, 5, seed=12)
    fr = [torch.from_numpy(np.asarray(c[0], np.int32)).to(cuda_device)
          for c in clip]
    ls = [float(np.sqrt(0.57 * 2.0 ** ((27 - 12) / 3.0)))]
    l0 = torch.stack([fr[1], fr[0]])[None]
    if kind == "p":
        def run(plain):
            return search_p_maps(fr[2][None], l0, ls, 6, 3, 128, 128, 64,
                                 plain=plain)
    else:
        l1 = torch.stack([fr[3], fr[4]])[None]

        def run(plain):
            return search_b_maps(fr[2][None], l0, l1, ls, 6, 3, 128, 128,
                                 64, plain=plain)
    before = dict(_build.LAUNCHES)
    got = run(False)
    names = ["me_coarse", "me_fine", "mc_merge", "subpel",
             "intra_rd_cands"] + (["bi_select"] if kind == "b" else [])
    for name in names:
        assert _build.LAUNCHES[name] > before.get(name, 0), name
    for name in ("me_full_search", "me_refine", "mc_sel", "satd",
                 "intra_pred_selected", "bi_cost"):
        assert _build.LAUNCHES.get(name, 0) == before.get(name, 0), name
    assert torch.equal(got, run(True))
    assert (got[..., 2] > 0).any()


@pytest.mark.cuda
def test_b_search_kernels_match_twins(cuda_device):
    """The whole B search, K12 included, on the card against its twins:
    frame 2 of a clip between frames 1, 0 (list 0) and 3, 4 (list 1)."""
    clip = synthesize_yuv(96, 64, 5, seed=5)
    fr = [torch.from_numpy(np.asarray(c[0], np.int32)) for c in clip]
    ls = float(np.sqrt(0.57 * 2.0 ** ((27 - 12) / 3.0)))
    args = (fr[2][None], torch.stack([fr[1], fr[0]])[None],
            torch.stack([fr[3], fr[4]])[None], [ls], 5, 3, 96, 64, 64)
    args = tuple(a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                 for a in args)
    kw = dict(nref0=[2], nref1=[2])
    got = search_b_maps(*args, **kw)
    want = search_b_maps(*args, **kw, plain=True)
    assert torch.equal(got, want)
    assert set(torch.unique(got[..., 2]).tolist()) >= {1, 2, 3}


def test_bi_cost_on_the_cpu_runs_the_twin_and_counts_no_launch():
    y, refs = _p_inputs(64, 64, 93, torch.device("cpu"))
    st = me.me_state(y, torch.cat([refs, refs]), 16)
    mv = torch.zeros((64, 2), dtype=torch.int32)
    sel = torch.zeros(64, dtype=torch.int32)
    rate = me.mv_rate_bits(mv)
    _build.LAUNCHES.clear()
    pbi, cbi = me.bi_cost(st.y, st.refs, mv, sel, mv, sel + 2, rate, rate,
                          8.0, 8)
    assert sum(_build.LAUNCHES.values()) == 0
    assert pbi.shape == (64, 8, 8) and cbi.dtype == torch.float32
    # equal references and MVs: the bi average is the uni prediction
    raw = me.mc_sel_plain(st.refs, st.base[16], mv, sel, 8, 16)[0]
    assert torch.equal(pbi, ((raw + 32) >> 6).clamp(0, 255))


# The partition CNN's f32 logits: K13 sums up to 585 products per output in
# its own order, cuDNN (TF32 off) in another, so the two differ by a few
# ulps of the activations; 1e-4 bounds that with room (measured under 1e-6
# on the CPU), and a depth decision whose top-two logits lie closer than
# twice this may go either way.
CNN_TOL = 1e-4


def _cnn_planes(lg, frames, device):
    """Seeded synthesized 1920x1080 luma, edge-padded to the CTU grid:
    uint8 [F, PH, 1920]."""
    ctu = 1 << lg
    ph = -(-1080 // ctu) * ctu
    clip = synthesize_yuv(1920, 1080, frames, seed=40 + lg)
    return torch.from_numpy(np.stack([
        pad_plane(np.asarray(f[0], np.int32), ph, 1920).astype(np.uint8)
        for f in clip])).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("lg,frames", [(5, 2), (6, 1)])
def test_cnn_depth_kernel_matches_twin(cuda_device, lg, frames):
    """K13 at 1080p in one launch: its logits (training mode on the same
    CTUs) within CNN_TOL of the conv2d chain's, its depth map equal to the
    twin's wherever the twin's top-two margin exceeds 2 CNN_TOL."""
    y = _cnn_planes(lg, frames, cuda_device)
    theta = init_params(torch.Generator().manual_seed(lg), lg,
                        cuda_device).flat_params()
    before = _build.LAUNCHES["cnn_depth"]
    got = cnn.cnn_depth(y, theta, 32, lg)
    assert _build.LAUNCHES["cnn_depth"] == before + 1
    want = cnn.cnn_depth(y, theta, 32, lg, plain=True)
    ctu = 1 << lg
    x = cnn.ctu_batch(y, ctu)
    q = torch.full((x.shape[0],), 32.0, device=cuda_device)
    lk, _ = cnn.cnn_train_forward(x[:, 0], q, theta)
    lp = cnn.logits_plain(x, q, cnn.unflatten(theta, lg - 2))
    assert (lk - lp).abs().max().item() <= CNN_TOL
    top2 = torch.topk(lp, 2, dim=-1).values
    sure = cnn._granule_map(top2[..., 0] - top2[..., 1] > 2 * CNN_TOL,
                            frames, y.shape[1], y.shape[2], ctu)
    assert sure.float().mean().item() > 0.99
    assert torch.equal(got[sure], want[sure])


@pytest.mark.cuda
@pytest.mark.parametrize("lg,bsz", [(5, 64), (6, 64), (5, 1), (5, 17),
                                    (6, 17)])
def test_cnn_backward_kernel_matches_autograd(cuda_device, lg, bsz):
    """K13's training mode and K14 on a batch of CTUs (64 as the trainer
    draws them, 1, and 17: a batch no tile divides) against autograd
    through the conv2d chain: the loss within 1e-6 relative, each of the
    ten gradient tensors within 1e-4 of its largest magnitude (f32 sums of
    up to 64 x 1024 products, in another order)."""
    ctu = 1 << lg
    rng = np.random.default_rng(50 + lg + bsz)
    x = cnn.ctu_batch(_cnn_planes(lg, 1, cuda_device), ctu)[:bsz, 0]
    q = torch.from_numpy(rng.integers(22, 38, bsz).astype(np.float32)).to(
        cuda_device)
    t = torch.from_numpy(rng.integers(0, lg - 2, (bsz, ctu // 8, ctu // 8))
                         .astype(np.int32)).to(cuda_device)
    theta = init_params(torch.Generator().manual_seed(lg), lg,
                        cuda_device).flat_params()
    before = (_build.LAUNCHES["cnn_train"], _build.LAUNCHES["cnn_backward"])
    grads, losses = [], []
    for plain in (False, True):
        th = theta.clone().requires_grad_(True)
        loss, _ = cnn.cnn_loss(th, x, q, t, plain=plain)
        grads.append(torch.autograd.grad(loss, th)[0])
        losses.append(loss.item())
    assert (_build.LAUNCHES["cnn_train"],
            _build.LAUNCHES["cnn_backward"]) == (before[0] + 1, before[1] + 1)
    assert abs(losses[0] - losses[1]) <= 1e-6 * abs(losses[1])
    for (wk, bk), (wp, bp) in zip(cnn.unflatten(grads[0], lg - 2),
                                  cnn.unflatten(grads[1], lg - 2)):
        for a, b in ((wk, wp), (bk, bp)):
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("lg", [5, 6])
def test_cnn_backward_is_deterministic(cuda_device, lg):
    """K14 sums every gradient in an order fixed by the batch and the CTU
    size: two calls on the same inputs give the same bits."""
    ctu = 1 << lg
    rng = np.random.default_rng(90 + lg)
    x = cnn.ctu_batch(_cnn_planes(lg, 1, cuda_device), ctu)[:64, 0]
    q = torch.from_numpy(rng.integers(22, 38, 64).astype(np.float32)).to(
        cuda_device)
    t = torch.from_numpy(rng.integers(0, lg - 2, (64, ctu // 8, ctu // 8))
                         .astype(np.int32)).to(cuda_device)
    theta = init_params(torch.Generator().manual_seed(lg), lg,
                        cuda_device).flat_params()
    logits, acts = cnn.cnn_train_forward(x, q, theta)
    first = cnn.cnn_backward(x, q, t, theta, acts, logits)
    assert torch.equal(cnn.cnn_backward(x, q, t, theta, acts, logits), first)


@pytest.mark.cuda
def test_adam_kernel_matches_twin(cuda_device):
    """K15 rounds every operation as its twin does: bit for bit."""
    rng = np.random.default_rng(60)
    n = cnn.n_params(3)
    bufs = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             * s).to(cuda_device)
            for s in (1.0, 1e-3, 1e-3)] + [
        torch.from_numpy(rng.random(n).astype(np.float32) * 1e-6).to(
            cuda_device)]
    theta, grad, m, v = bufs
    twin = [b.clone() for b in (theta, m, v)]
    before = _build.LAUNCHES["adam"]
    for step in (1, 7):
        cnn.adam_update(theta, grad, m, v, step, 3e-3)
        cnn.adam_update(twin[0], grad, twin[1], twin[2], step, 3e-3,
                        plain=True)
        for a, b in zip((theta, m, v), twin):
            assert torch.equal(a, b)
    assert _build.LAUNCHES["adam"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("lg", [5, 6])
@pytest.mark.parametrize("bsz", [1, 64, 320])
def test_cnn_backward_adam_matches_backward_then_adam(cuda_device, lg, bsz):
    """K14 with K15's step in its sums (one cooperative launch) against
    `cnn_backward` then `adam_update` from the same parameters and
    moments, at counts 1 and 7: theta, m, v and the gradient (when asked
    for) bit for bit.  The fused launch reads each layer's weights before
    it updates them in place, so its gradient is the pre-step one."""
    ctu = 1 << lg
    rng = np.random.default_rng(100 + lg + bsz)
    x = cnn.ctu_batch(_cnn_planes(lg, 1, cuda_device), ctu)[:bsz, 0]
    x = x.contiguous()
    q = torch.from_numpy(rng.integers(22, 38, bsz).astype(np.float32)).to(
        cuda_device)
    t = torch.from_numpy(rng.integers(0, lg - 2, (bsz, ctu // 8, ctu // 8))
                         .astype(np.int32)).to(cuda_device)
    theta = init_params(torch.Generator().manual_seed(lg), lg,
                        cuda_device).flat_params()
    n = theta.numel()
    m = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                         * 1e-3).to(cuda_device)
    v = torch.from_numpy(rng.random(n).astype(np.float32) * 1e-6).to(
        cuda_device)
    logits, acts = cnn.cnn_train_forward(x, q, theta)
    table = cnn.adam_bias_table(7, cuda_device)
    before = _build.LAUNCHES["cnn_backward_adam"]
    for step in (1, 7):
        grad = cnn.cnn_backward(x, q, t, theta, acts, logits)
        want = [b.clone() for b in (theta, m, v)]
        cnn.adam_update(*want[:1], grad, *want[1:], step, 3e-3)
        for want_grad in (True, False):
            got = [b.clone() for b in (theta, m, v)]
            g = cnn.cnn_backward_adam(x, q, t, got[0], acts, logits, got[1],
                                      got[2], step, table, 3e-3,
                                      want_grad=want_grad)
            assert (g is None) != want_grad
            if want_grad:
                assert torch.equal(g, grad)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    assert _build.LAUNCHES["cnn_backward_adam"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("lg", [5, 6])
@pytest.mark.parametrize("n_ctus", [1, 64, 320])
def test_cnn_configurations_agree_and_match_twin(cuda_device, monkeypatch,
                                                 lg, n_ctus):
    """Every tile T of K13 (forced in place of `cnn_tile`'s choice) runs
    each output's FMA chain in one order, so their logits are equal bit
    for bit; they lie within CNN_TOL of the conv2d chain's, and the depth
    map of the tile the wrapper picks equals the twin's wherever the
    top-two margin exceeds 2 CNN_TOL."""
    ctu = 1 << lg
    rng = np.random.default_rng(70 + n_ctus)
    # n_ctus CTUs as frames of 4 x (n_ctus / 4) CTUs, or one 1 x 1 frame
    fy = 1 if n_ctus == 1 else 4
    fx = max(n_ctus // (fy * 4), 1)
    frames = n_ctus // (fy * fx)
    y = torch.from_numpy(rng.integers(0, 256, (frames, fy * ctu, fx * ctu))
                         .astype(np.uint8)).to(cuda_device)
    theta = init_params(torch.Generator().manual_seed(lg), lg,
                        cuda_device).flat_params()
    x = cnn.ctu_batch(y, ctu)
    assert x.shape[0] == n_ctus
    q = torch.from_numpy(rng.integers(22, 38, n_ctus).astype(np.float32)).to(
        cuda_device)
    logits = []
    for t in cnn.CNN_TILES[lg]:
        monkeypatch.setattr(cnn, "cnn_tile", lambda *_, t=t: t)
        logits.append(cnn.cnn_train_forward(x[:, 0], q, theta)[0])
    monkeypatch.undo()
    for other in logits[1:]:
        assert torch.equal(other, logits[0])
    lp = cnn.logits_plain(x, q, cnn.unflatten(theta, lg - 2))
    assert (logits[0] - lp).abs().max().item() <= CNN_TOL
    before = _build.LAUNCHES["cnn_depth"]
    got = cnn.cnn_depth(y, theta, 32, lg)
    assert _build.LAUNCHES["cnn_depth"] == before + 1
    want = cnn.cnn_depth(y, theta, 32, lg, plain=True)
    top2 = torch.topk(cnn.logits_plain(x, 32, cnn.unflatten(theta, lg - 2)),
                      2, dim=-1).values
    sure = cnn._granule_map(top2[..., 0] - top2[..., 1] > 2 * CNN_TOL,
                            frames, y.shape[1], y.shape[2], ctu)
    assert torch.equal(got[sure], want[sure])


def test_cnn_configurations_fit_shared_memory():
    """Every K13 tile, and the wrapper's choice for any batch, fits a
    CTA's 227 KB of shared memory at CTU 32 and 64; small batches take one
    CTU a CTA, large ones share each CTA's weights over T CTUs."""
    for lg, tiles in cnn.CNN_TILES.items():
        for t in tiles:
            assert cnn.cnn_smem_bytes(lg, t) <= cnn.SMEM_LIMIT == 232448
        for n in list(range(1, 300)) + [510, 1056, 2040, 4000, 16320]:
            assert cnn.cnn_tile(n, lg) in tiles
    assert cnn.cnn_tile(64, 5) == 1 and cnn.cnn_tile(64, 6) == 1
    assert cnn.cnn_tile(8 * 34 * 60, 5) > 1


def test_cnn_on_the_cpu_runs_the_twins_and_counts_no_launch():
    theta = init_params(torch.Generator().manual_seed(1),
                        device="cpu").flat_params()
    y = torch.from_numpy(np.random.default_rng(61).integers(
        0, 256, (1, 64, 96)).astype(np.uint8))
    _build.LAUNCHES.clear()
    depth = cnn.cnn_depth(y, theta, 30, 5)
    assert depth.shape == (1, 8, 12) and depth.dtype == torch.int16
    th = theta.clone().requires_grad_(True)
    x = cnn.ctu_batch(y, 32)[:, 0]
    loss, logits = cnn.cnn_loss(th, x, torch.full((6,), 30.0),
                                torch.zeros((6, 4, 4), dtype=torch.int32))
    loss.backward()
    cnn.adam_update(th.detach(), th.grad, torch.zeros_like(theta),
                    torch.zeros_like(theta), 1, 3e-3)
    assert sum(_build.LAUNCHES.values()) == 0
    assert logits.shape == (6, 4, 4, 3)
    with pytest.raises(ValueError):
        cnn.cnn_depth(y, theta, 30, 6)   # a CTU-32 network on CTU 64


# ---------------------------------------------------------------------------
# The multi-device layer: K16, K6's tile-column form, K7's halo form
# ---------------------------------------------------------------------------

def _halo_planes(seed, dev):
    rng = np.random.default_rng(seed)
    shapes = [((1, 64, 96), np.uint8), ((1, 32, 48), np.int32),
              ((2, 8, 12), np.int16), ((1, 8, 48), np.int32)]
    return [[torch.from_numpy(rng.integers(0, 200, s).astype(t)).to(dev)
             for s, t in shapes] for _ in range(3)]


# The mesh's exchanges at an interior rank of a 96-column tile (1080p
# tiles are 480): (shape, dtype, wl, wr, own) of the intra source exchange
# (uint8, a CTU left and two right), the ME halo (128 / 64 columns), the
# decimated planes (32 int32 columns), the deblocking's recon (8 / 4 int32
# columns) and maps (1 and 4 int32 columns), SAO's 1-column strips
# (own=False), and uint8 / int16 planes whose rows start off any 16-byte
# boundary (a 93-column plane, 16-byte-unaligned segments)
MESH_HALOS = [((1, 64, 96), np.uint8, 32, 64, True),
              ((1, 32, 48), np.uint8, 16, 32, True),
              ((1, 64, 160), np.uint8, 128, 128, True),
              ((1, 32, 80), np.uint8, 64, 64, True),
              ((1, 2, 16, 40), np.int32, 32, 32, True),
              ((1, 64, 96), np.int32, 8, 8, True),
              ((1, 32, 48), np.int32, 4, 4, True),
              ((1, 8, 12), np.int32, 1, 1, True),
              ((1, 8, 48), np.int32, 4, 4, True),
              ((1, 64, 96), np.int32, 1, 1, False),
              ((1, 64, 93), np.uint8, 19, 37, True),
              ((2, 8, 45), np.int16, 7, 11, True)]


def _unaligned(rng, shape, dtype, dev, skew):
    """A contiguous plane whose data starts `skew` elements into its
    storage."""
    n = int(np.prod(shape))
    flat = torch.from_numpy(rng.integers(0, 200, n + skew).astype(dtype))
    return flat.to(dev)[skew:].view(shape)


@pytest.mark.cuda
def test_halo_kernel_matches_twin(cuda_device):
    """K16's row form and its earlier form: every edge case of a row (both
    neighbours, each bound alone) and the packed send buffers, element
    sizes 1, 2 and 4; the mesh's real widths and element sizes, planes
    whose segments sit off 16-byte boundaries, and more planes than one
    launch takes (20: two launches)."""
    own, left, right = _halo_planes(80, cuda_device)
    wl, wr = [8, 4, 1, 4], [16, 8, 1, 4]
    rng = np.random.default_rng(81)
    mesh = [[_unaligned(rng, s, t, cuda_device, k * (3 + i))
             for i, (s, t, *_) in enumerate(MESH_HALOS)] for k in range(3)]
    mesh_own = [m[-1] for m in MESH_HALOS]
    many = [_unaligned(rng, (1, 16, 24 + k), (np.uint8, np.int32)[k % 2],
                       cuda_device, k % 5) for k in range(60)]
    many = [many[0:20], many[20:40], many[40:60]]
    mw, mr = [1 + k % 13 for k in range(20)], [1 + k % 7 for k in range(20)]
    counts = {}
    for form, extend, pack in (
            ("halo_rows", halo.halo_extend, halo.halo_pack),
            ("halo", halo.halo_extend_by_element,
             halo.halo_pack_by_element)):
        before = _build.LAUNCHES[form]
        for planes, w_l, w_r in ((own, wl, wr), (many[0], mw, mr)):
            lt_all, rt_all = ((left, right) if planes is own
                              else (many[1], many[2]))
            n = len(planes)
            for lt, rt in ((lt_all, rt_all), ([None] * n, rt_all),
                           (lt_all, [None] * n)):
                got = extend(planes, lt, rt, w_l, w_r)
                want = halo.halo_extend(planes, lt, rt, w_l, w_r, plain=True)
                for a, b in zip(got, want):
                    assert torch.equal(a, b)
            for a, b in zip(pack(planes, w_l, w_r),
                            halo.halo_pack(planes, w_l, w_r, plain=True)):
                assert torch.equal(a, b)
        for keep in (True, False):
            sel = [i for i, o in enumerate(mesh_own) if o == keep]
            planes = [mesh[0][i] for i in sel]
            w_l = [MESH_HALOS[i][2] for i in sel]
            w_r = [MESH_HALOS[i][3] for i in sel]
            for lt, rt in (([mesh[1][i] for i in sel],
                            [mesh[2][i] for i in sel]),
                           ([None] * len(sel), [mesh[2][i] for i in sel])):
                got = extend(planes, lt, rt, w_l, w_r, own=keep)
                want = halo.halo_extend(planes, lt, rt, w_l, w_r, plain=True,
                                        own=keep)
                for a, b in zip(got, want):
                    assert torch.equal(a, b)
        counts[form] = _build.LAUNCHES[form] - before
    # own: 3 extends + a pack; 20 planes: 3 extends + a pack of 40 strips,
    # two launches each but the pack's three; the mesh sets: 4 extends
    assert counts == {"halo_rows": 4 + 9 + 4, "halo": 4 + 9 + 4}


@pytest.mark.cuda
@pytest.mark.parametrize("inter", [False, True])
def test_deblock_window_kernel_matches_twin(cuda_device, inter):
    """K6's tile-column form on a tile extended by 8 columns each side
    (x0 = 56 of a 256-wide picture; and the last tile, whose right edge is
    the picture's), with P strengths from the CU cbf pass."""
    rng = np.random.default_rng(81 + inter)
    h, w = 64, 80
    gh, gw = h // 8, w // 8
    dev = cuda_device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))[None].to(
            dev)

    planes = [t(rng.integers(60, 200, (h >> (c > 0), w >> (c > 0))))
              for c in range(3)]
    # a valid CTU-32 quadtree: each CTU whole (depth 0) or in 16s and 8s
    depth = np.zeros((gh, gw), np.int32)
    for cy in range(0, gh, 4):
        for cx in range(0, gw, 4):
            if rng.random() < 0.7:
                for q in range(4):
                    y0, x0 = cy + 2 * (q // 2), cx + 2 * (q % 2)
                    depth[y0:y0 + 2, x0:x0 + 2] = 1 + (rng.random() < 0.5)
    dm = t(depth)
    kw = {}
    if inter:
        lv = torch.from_numpy((rng.random((h, w)) < 0.02).astype(np.int16)
                              )[None].to(dev)
        cbf = deblock.tu_cbf(lv, dm, 5)
        assert torch.equal(cbf, deblock.tu_cbf(lv, dm, 5, plain=True))
        kw = dict(dir_map=t(rng.integers(0, 4, (gh, gw))),
                  mv_map=t(rng.integers(-9, 9, (gh, gw, 4))), cbf=cbf)
    before = _build.LAUNCHES["deblock_window"]
    for x0 in (56, 184):
        args = (*planes, dm, 35, 34, 34, 5)
        got = deblock.deblock(*args, x0=x0, pic_w=256, **kw)
        want = deblock.deblock(*args, plain=True, x0=x0, pic_w=256, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert _build.LAUNCHES["deblock_window"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("lg", [4, 5, 6])
@pytest.mark.parametrize("l_av,r_av", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_sao_halo_kernel_matches_twin(cuda_device, l_av, r_av, lg):
    """K7's fused halo form (one launch) and its earlier two-launch form
    against the twin, with each side's neighbour column available or
    not."""
    rng = np.random.default_rng(90 + 2 * l_av + r_av + 4 * lg)
    h, w = 48 + 8 * (lg == 6), 2 << lg

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32))[None].to(
            cuda_device)

    src = [rng.integers(0, 256, (h >> (c > 0), w >> (c > 0)))
           for c in range(3)]
    rec = [np.clip(a + rng.integers(-6, 7, a.shape), 0, 255) for a in src]
    cols = [tuple(t(rng.integers(0, 256, h >> (c > 0))) for _ in range(2))
            for c in range(3)]
    kw = dict(halo_y=cols[0], halo_cb=cols[1], halo_cr=cols[2],
              l_avail=l_av, r_avail=r_av)
    before = dict(_build.LAUNCHES)
    planes = [t(a) for a in src + rec]
    got = sao.sao(*planes, lg, **kw)
    assert (_build.LAUNCHES["sao_fused_halo"]
            == before.get("sao_fused_halo", 0) + 1)
    earlier = sao.sao_two_pass(*planes, lg, **kw)
    assert _build.LAUNCHES["sao_halo"] == before.get("sao_halo", 0) + 2
    want = sao.sao(*planes, lg, plain=True, **kw)
    for a, b, c in zip(got, want, earlier):
        assert torch.equal(a, b)
        assert torch.equal(c, b)


def test_mesh_kernels_on_the_cpu_run_the_twins_and_count_no_launch():
    own, left, right = _halo_planes(82, "cpu")
    _build.LAUNCHES.clear()
    ext = halo.halo_extend(own, left, right, 4, 4)
    assert [e.shape[-1] for e in ext] == [p.shape[-1] + 8 for p in own]
    halo.halo_pack(own, 4, 4)
    lv = torch.zeros((1, 32, 32), dtype=torch.int16)
    deblock.tu_cbf(lv, torch.zeros((1, 4, 4), dtype=torch.int32), 5)
    assert sum(_build.LAUNCHES.values()) == 0
