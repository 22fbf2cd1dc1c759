"""The CUDA kernels K1-K8 of fasthevc_tpu_torch against their plain twins.

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

from fasthevc_tpu.utils import synthesize_yuv
from fasthevc_tpu.utils.video import pad_plane
from fasthevc_tpu_torch import _build
from fasthevc_tpu_torch.codec import device_pipeline
from fasthevc_tpu_torch.codec.search import search_intra_maps_batch
from fasthevc_tpu_torch.ops import commit, cost, deblock, intra, sao, transform

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
    res = _residuals(8, 10, seed=2)
    lv, rq = transform.tq_roundtrip(res, 32, 3)
    for a, b in zip(cost.sse_rate(res, rq, lv),
                    cost.sse_rate_plain(res, rq, lv)):
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
        "commit_intra.cu", "deblock.cu", "sao.cu", "checksum.cu",
        "intra_common.cuh", "tq_common.cuh"}


@pytest.mark.cuda
@pytest.mark.parametrize("lg,luma", SIZES)
def test_intra_kernel_matches_twin(cuda_device, lg, luma):
    top, left = (t.to(cuda_device) for t in _refs(lg, 300, seed=20 + lg))
    modes = torch.arange(top.shape[0], device=cuda_device) % 35
    before = _build.LAUNCHES["intra_pred"]
    assert torch.equal(intra.predict_all_modes(top, left, lg, luma),
                       intra.predict_plain(top, left, lg, None, luma))
    assert torch.equal(
        intra.predict_selected(top, left, lg, modes, luma),
        intra.predict_plain(top, left, lg, modes[:, None], luma)[:, 0])
    assert _build.LAUNCHES["intra_pred"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_satd_kernel_matches_twin(cuda_device, n):
    rng = np.random.default_rng(30 + n)
    src = torch.from_numpy(rng.integers(0, 256, (400, n, n)).astype(np.int32))
    preds = torch.from_numpy(rng.integers(0, 256, (400, 35, n, n))
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
    got = sao.sao(*args, 5)
    want = sao.sao(*args, 5, plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_checksum_kernel_matches_twin(cuda_device):
    rng = np.random.default_rng(52)
    planes = torch.from_numpy(rng.integers(0, 256, (3, 300, 520))
                              .astype(np.uint8)).to(cuda_device)
    assert torch.equal(device_pipeline.device_checksum(planes),
                       device_pipeline.device_checksum(planes, plain=True))
