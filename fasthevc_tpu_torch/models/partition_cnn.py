"""Partition-map CNN: CTU pixels -> per-8x8-granule CU depth logits.

Counterpart of fasthevc_tpu/models/partition_cnn.py.  The network and its
parameter file are the reference's: a parameter file is a pickled nested
dict of numpy arrays, {'params': {'Conv_i': {'kernel': HWIO, 'bias'}}},
so a file written by either package loads in the other
(`params_from_flax` / `params_to_flax` turn the flax layout into this
package's `PartitionCNN` and back).  Inference (`predict_depth_maps*`)
and training (`train_self_distilled`) run the kernels of `ops/cnn.py`:
K13 (the forward, fused into the searches; its training mode), and K14
with K15's Adam step applied in its sums (`cnn.train_step`); CPU tensors
run their twins.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch
from torch import nn

from ..ops import cnn


class PartitionCNN(nn.Module):
    """Input [B, S, S, 1] normalised luma CTUs and qps [B]; output
    [B, S/8, S/8, n_depths] depth logits (n_depths = log2_ctu - 2), flax's
    layer names and NHWC order.  The parameters are left uninitialised:
    `init_params` or `params_from_flax` fill them."""

    def __init__(self, n_depths: int = 3, device=None) -> None:
        super().__init__()
        self.n_depths = n_depths
        for li, (_, shp) in enumerate(cnn.layout(n_depths)[0::2]):
            conv = nn.Conv2d(shp[1], shp[0], shp[2], device="meta")
            setattr(self, f"Conv_{li}", conv)
        self.to_empty(device=device or "cpu")

    def layers(self) -> list:
        return [(getattr(self, f"Conv_{li}").weight,
                 getattr(self, f"Conv_{li}").bias) for li in range(5)]

    def forward(self, x: torch.Tensor, qp) -> torch.Tensor:
        return cnn.logits_plain(x.permute(0, 3, 1, 2), qp, self.layers())

    def flat_params(self) -> torch.Tensor:
        """The kernels' flat f32 parameter buffer (`ops.cnn.layout`)."""
        return torch.cat([p.detach().reshape(-1) for p in self.parameters()])

    @classmethod
    def from_flat(cls, theta: torch.Tensor, n_depths: int) -> "PartitionCNN":
        model = cls(n_depths, device=theta.device)
        with torch.no_grad():
            for (w, b), (tw, tb) in zip(model.layers(),
                                        cnn.unflatten(theta, n_depths)):
                w.copy_(tw)
                b.copy_(tb)
        return model


def _ctu_batch(y_plane: np.ndarray, ctu: int) -> np.ndarray:
    """[H, W] -> [n_ctus, ctu, ctu, 1] float32, CTU raster order."""
    h, w = y_plane.shape
    gy, gx = h // ctu, w // ctu
    t = (y_plane.reshape(gy, ctu, gx, ctu).transpose(0, 2, 1, 3)
         .reshape(-1, ctu, ctu, 1))
    return (t.astype(np.float32) - 128.0) / 128.0


def init_params(generator: torch.Generator, log2_ctu: int = 5,
                device="cuda") -> PartitionCNN:
    """A network drawn as flax initialises it: lecun_normal kernels
    (a normal truncated to +-2 standard deviations, scaled to variance
    1 / fan_in) and zero biases, from `generator` (a CPU generator; the
    numbers are not jax.random's)."""
    model = PartitionCNN(log2_ctu - 2)
    with torch.no_grad():
        for w, b in model.layers():
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            std = float(np.sqrt(1.0 / fan_in) / .87962566103423978)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            b.zero_()
    return model.to(device)


def params_from_flax(params: dict, device) -> PartitionCNN:
    """The flax parameter tree (kernels HWIO) as a PartitionCNN on
    `device` (kernels OIHW)."""
    tree = params["params"]
    n_depths = int(np.shape(tree["Conv_4"]["kernel"])[-1])
    model = PartitionCNN(n_depths, device=device)
    with torch.no_grad():
        for li, (w, b) in enumerate(model.layers()):
            k = np.asarray(tree[f"Conv_{li}"]["kernel"], np.float32)
            if k.shape != tuple(w.shape[2:]) + (w.shape[1], w.shape[0]):
                raise ValueError(f"Conv_{li} kernel {k.shape} does not fit "
                                 f"the partition CNN")
            w.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
            b.copy_(torch.from_numpy(
                np.array(tree[f"Conv_{li}"]["bias"], np.float32)))
    return model


def params_to_flax(model: PartitionCNN) -> dict:
    """A PartitionCNN as the flax parameter tree of numpy arrays."""
    return {"params": {
        f"Conv_{li}": {
            "kernel": w.detach().cpu().numpy().transpose(2, 3, 1, 0).copy(),
            "bias": b.detach().cpu().numpy().copy()}
        for li, (w, b) in enumerate(model.layers())}}


def as_partition_cnn(params, device, log2_ctu: int | None = None
                     ) -> PartitionCNN:
    """A flax tree or a PartitionCNN as a PartitionCNN on `device` (a copy:
    the caller's network stays where it is); raises ValueError when its
    depth count does not fit CTU 2^log2_ctu."""
    if isinstance(params, PartitionCNN):
        model = PartitionCNN.from_flat(params.flat_params().to(device),
                                       params.n_depths)
    else:
        model = params_from_flax(params, device)
    if log2_ctu is not None and model.n_depths != log2_ctu - 2:
        raise ValueError(f"the partition CNN predicts {model.n_depths} "
                         f"depths; CTU {1 << log2_ctu} needs {log2_ctu - 2}")
    return model


def predict_depth_maps_device(params, y_plane: torch.Tensor, qp,
                              log2_ctu: int = 5) -> torch.Tensor:
    """Granule depth map of a padded luma plane [H, W] (a tensor; H, W
    multiples of the CTU): int16 [H/8, W/8] on its device, through K13 on
    the card."""
    model = as_partition_cnn(params, y_plane.device, log2_ctu)
    return cnn.cnn_depth(y_plane[None], model.flat_params(), qp,
                         log2_ctu)[0]


def predict_depth_maps(params, y_plane: np.ndarray, qp: int,
                       log2_ctu: int = 5, device="cuda") -> np.ndarray:
    """Predict the per-8x8-granule depth map for a padded luma plane.

    Returns int8 [H/8, W/8] (the layout of the decision maps), assembled
    from per-CTU predictions."""
    y = torch.from_numpy(np.asarray(y_plane, np.int32)).to(device)
    depth = predict_depth_maps_device(params, y, qp, log2_ctu)
    return depth.cpu().numpy().astype(np.int8)


def distillation_targets(clips, qps, log2_ctu: int, device) -> tuple:
    """The training set of train_self_distilled: for each qp and frame,
    the CTUs of the CTU-cropped luma (x [N, S, S, 1] f32, normalised),
    the depth of each granule in the full search's decisions there (t
    [N, S/8, S/8] int32: the port's packed maps, whose depth equals
    decisions_to_maps' when nothing is forced to split) and the qp (q [N]
    f32)."""
    from ..codec.search import search_intra_maps_batch

    ctu = 1 << log2_ctu
    g = ctu // 8
    xs, ts, qs = [], [], []
    for qp in qps:
        lam = float(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))
        for y, _, _ in clips:
            h, w = y.shape
            h, w = (h // ctu) * ctu, (w // ctu) * ctu
            yp = y[:h, :w].astype(np.int32)
            packed = search_intra_maps_batch(
                torch.from_numpy(yp)[None].to(device), lam, log2_ctu, 3, w,
                h)
            depth = packed[0, ..., 0].cpu().numpy().astype(np.int8)
            xs.append(_ctu_batch(yp, ctu))
            ts.append(depth.reshape(h // ctu, g, w // ctu, g)
                      .transpose(0, 2, 1, 3).reshape(-1, g, g))
            qs.append(np.full(ts[-1].shape[0], float(qp), np.float32))
    return (np.concatenate(xs), np.concatenate(ts).astype(np.int32),
            np.concatenate(qs))


def train_self_distilled(clips=None, qps=(27, 32, 37), log2_ctu: int = 5,
                         steps: int = 300, seed: int = 0, log=print,
                         device="cuda", targets=None) -> dict:
    """Self-distillation: full-RDO search decisions -> CNN targets.

    clips: list of (y, cb, cr) frames; synthesized when None.  The
    targets are the port's own intra search on each CTU-cropped luma
    plane; batches of 64 CTUs are drawn as the reference draws them
    (np.random.default_rng(seed), all steps' draws uploaded at once), and
    each step is `cnn.train_step`: on the card two launches, K13's
    training mode and K14 with K15's step inside, the bias corrections
    from a table uploaded once (their twins on the CPU).  The loss and
    accuracy, which the reference computes every step but only prints,
    are computed at the logging steps (every 100).  targets: (x, t, q) as
    `distillation_targets` returns them for these clips, qps and CTU size,
    to train on without searching again; None runs the search.  Returns
    the parameters as the flax tree, which `save_params` writes for either
    package."""
    from ..utils.video import synthesize_yuv

    dev = torch.device(device)
    ctu = 1 << log2_ctu
    if targets is None:
        if clips is None:
            clips = synthesize_yuv(8 * ctu, 4 * ctu, 8, seed=seed)
        targets = distillation_targets(clips, qps, log2_ctu, dev)
    x, t, q = targets
    log(f"partition-cnn: {x.shape[0]} CTU samples, "
        f"depth histogram {np.bincount(t.ravel(), minlength=3).tolist()}")

    # ---- train --------------------------------------------------------
    params = init_params(torch.Generator().manual_seed(seed), log2_ctu, dev)
    theta = params.flat_params().clone()
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)
    xd = torch.from_numpy(x[..., 0]).to(dev)
    qd = torch.from_numpy(q).to(dev)
    td = torch.from_numpy(t).to(dev)
    rng = np.random.default_rng(seed)
    bsz = min(64, x.shape[0])
    # one draw a step, as the reference draws them; np.array, not np.stack,
    # so that steps=0 returns the initial parameters
    draws = np.array([rng.integers(0, x.shape[0], bsz)
                      for _ in range(steps)], np.int64).reshape(steps, bsz)
    idx_all = torch.from_numpy(draws).to(dev)
    table = cnn.adam_bias_table(max(steps, 1), dev)
    for i in range(steps):
        idx = idx_all[i]
        tb = td[idx]
        logits = cnn.train_step(theta, m, v, xd[idx], qd[idx], tb, i + 1,
                                table, 3e-3)
        if (i + 1) % 100 == 0:
            loss = cnn._ce(logits, tb)
            acc = (torch.argmax(logits, -1) == tb).to(torch.float32).mean()
            log(f"  step {i+1}: loss {loss.item():.4f} acc {acc.item():.3f}")
    return params_to_flax(PartitionCNN.from_flat(theta, log2_ctu - 2))


def save_params(params, path: str) -> None:
    """Pickle the flax tree (a PartitionCNN is converted first)."""
    if isinstance(params, PartitionCNN):
        params = params_to_flax(params)
    with open(path, "wb") as f:
        pickle.dump(params, f)


def load_params(path: str) -> dict:
    """The flax tree of a parameter file of either package."""
    with open(path, "rb") as f:
        return pickle.load(f)
