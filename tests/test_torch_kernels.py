"""The CUDA kernels K1-K4 of fasthevc_tpu_torch against their plain twins.

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
from fasthevc_tpu_torch.ops import cost, intra, transform

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


def test_library_is_keyed_by_the_sources():
    path = _build.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert path == _build.library_path()
    assert {os.path.basename(s) for s in _build.sources()} >= {
        "intra_pred.cu", "satd.cu", "tq_roundtrip.cu", "sse_rate.cu"}


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
