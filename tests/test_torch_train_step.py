"""The partition CNN's training step as `train_self_distilled` runs it
(`ops/cnn.py` `train_step`: on the card K13's training mode, then K14 with
K15's Adam step inside its sums; here the twins) against the loop it
replaced: autograd through the conv2d chain, then the Adam twin.

The fused kernel itself is held bit for bit against `cnn_backward` +
`adam_update` on the card (tests/test_torch_kernels.py, `cuda`)."""

import numpy as np
import pytest
import torch

from fasthevc_tpu_torch import _build
from fasthevc_tpu_torch.models import partition_cnn as tcnn
from fasthevc_tpu_torch.ops import cnn
from fasthevc_tpu_torch.utils import synthesize_yuv

# One intra-op thread: the suite runs several test workers at once.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clip64():
    """A 64x64 clip of 3 frames: 12 CTUs of 32 at one qp."""
    return synthesize_yuv(64, 64, 3, seed=5)


def _batches(clip, steps, seed=0):
    x, t, q = tcnn.distillation_targets(clip, (27, 37), 5, "cpu")
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = rng.integers(0, x.shape[0], 64)
        yield (torch.from_numpy(x[idx, ..., 0]), torch.from_numpy(q[idx]),
               torch.from_numpy(t[idx]))


def test_bias_table_holds_every_steps_corrections():
    """Row t - 1 of the uploaded table is `_bias_corrections(t)` in f32,
    bit for bit, for the 400 steps of config 4's recipe."""
    table = cnn.adam_bias_table(400, "cpu")
    assert table.shape == (400, 2) and table.dtype == torch.float32
    want = np.array([cnn._bias_corrections(t) for t in range(1, 401)],
                    np.float32)
    assert np.array_equal(table.numpy().view(np.uint32),
                          want.view(np.uint32))


def test_train_step_equals_the_autograd_loop(clip64):
    """Five steps of `train_step` on the CPU (the twins and the bias
    table) against `cnn_loss_plain` + `torch.autograd.grad` +
    `adam_update_plain`: theta, both moments and the logits bit for bit
    after every step, and no kernel launched."""
    theta = tcnn.init_params(torch.Generator().manual_seed(3), 5,
                             "cpu").flat_params()
    fused = [theta.clone(), torch.zeros_like(theta), torch.zeros_like(theta)]
    loop = [b.clone() for b in fused]
    table = cnn.adam_bias_table(5, "cpu")
    _build.LAUNCHES.clear()
    for step, (x, q, t) in enumerate(_batches(clip64, 5), start=1):
        logits = cnn.train_step(*fused, x, q, t, step, table, 3e-3)
        th = loop[0].clone().requires_grad_(True)
        loss, want = cnn.cnn_loss_plain(th, x, q, t)
        grad, = torch.autograd.grad(loss, th)
        cnn.adam_update_plain(loop[0], grad, loop[1], loop[2], step, 3e-3)
        assert torch.equal(logits, want.detach())
        for a, b in zip(fused, loop):
            assert torch.equal(a, b)
    assert not torch.equal(fused[0], theta)   # the parameters did move
    assert sum(_build.LAUNCHES.values()) == 0


def test_train_self_distilled_equals_the_earlier_loop(clip64):
    """`train_self_distilled` (train_step, the draws uploaded at once, the
    loss only at the logging steps) ends at the parameters of the loop it
    replaced (autograd through `cnn_loss`, then `adam_update`, a draw
    uploaded each step), bit for bit, and logs the same loss and
    accuracy."""
    logs = [], []
    got = tcnn.train_self_distilled(clips=clip64, qps=(27, 37), steps=200,
                                    seed=1, log=logs[0].append, device="cpu")
    x, t, q = tcnn.distillation_targets(clip64, (27, 37), 5, "cpu")
    theta = tcnn.init_params(torch.Generator().manual_seed(1), 5,
                             "cpu").flat_params().clone()
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)
    rng = np.random.default_rng(1)
    bsz = min(64, x.shape[0])
    for i in range(200):
        idx = torch.from_numpy(rng.integers(0, x.shape[0], bsz))
        tb = torch.from_numpy(t)[idx]
        theta.requires_grad_(True)
        loss, logits = cnn.cnn_loss(theta, torch.from_numpy(x[..., 0])[idx],
                                    torch.from_numpy(q)[idx], tb)
        grad, = torch.autograd.grad(loss, theta)
        theta = theta.detach()
        cnn.adam_update(theta, grad, m, v, i + 1, 3e-3)
        if (i + 1) % 100 == 0:
            acc = (torch.argmax(logits, -1) == tb).to(torch.float32).mean()
            logs[1].append(f"  step {i+1}: loss {loss.item():.4f} "
                           f"acc {acc.item():.3f}")
    want = tcnn.params_to_flax(tcnn.PartitionCNN.from_flat(theta, 3))
    for name, layer in want["params"].items():
        for key in ("kernel", "bias"):
            assert np.array_equal(got["params"][name][key], layer[key])
    assert logs[0][1:] == logs[1]



@pytest.mark.parametrize("steps", [0, 3])
def test_train_self_distilled_on_given_targets(clip64, steps):
    """`train_self_distilled` on targets searched beforehand ends where it
    ends when it searches them itself, bit for bit; with steps=0 both
    return the initial parameters."""
    targets = tcnn.distillation_targets(clip64, (27, 37), 5, "cpu")
    got = tcnn.train_self_distilled(qps=(27, 37), steps=steps, seed=2,
                                    log=lambda _: None, device="cpu",
                                    targets=targets)
    want = tcnn.train_self_distilled(clips=clip64, qps=(27, 37),
                                     steps=steps, seed=2,
                                     log=lambda _: None, device="cpu")
    start = tcnn.params_to_flax(tcnn.init_params(
        torch.Generator().manual_seed(2), 5, "cpu"))
    same_as_start = True
    for name, layer in want["params"].items():
        for key in ("kernel", "bias"):
            assert np.array_equal(got["params"][name][key], layer[key])
            same_as_start &= np.array_equal(layer[key],
                                            start["params"][name][key])
    assert same_as_start == (steps == 0)
