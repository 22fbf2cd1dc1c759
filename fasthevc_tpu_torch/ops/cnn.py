"""The partition CNN's kernels: inference, training forward and backward,
and the Adam step.

Counterpart of the jitted programs of fasthevc_tpu/models/partition_cnn.py
(`PartitionCNN.__call__`, `predict_depth_maps_device`, and the
`value_and_grad` + `optax.adam` step of `train_self_distilled`).  The
network: luma CTU (v - 128) / 128 -> conv3x3 s2 (1->16) -> ReLU -> conv3x3
s2 (16->32) -> ReLU -> conv3x3 s2 (32->64) -> ReLU -> concat the qp / 51
plane -> conv3x3 s1 (65->64) -> ReLU -> conv1x1 (64->D) depth logits per
8x8 granule, D = log2_ctu - 2.  Flax's SAME padding of the stride-2 convs
on even sizes is (0, 1), of the stride-1 conv (1, 1).

The parameters travel as one flat f32 buffer `theta`: Conv_0 kernel
(OIHW), Conv_0 bias, ..., Conv_4 kernel, Conv_4 bias (`layout`).

  * `cnn_depth` (K13, csrc/cnn.cu): one CTA per (frame, CTU) over a whole
    batch of padded luma planes, the five layers out of shared memory,
    the argmax straight into the int16 granule depth map;
    `cnn_depth_plain` is its twin, the conv2d chain.
  * `cnn_loss` (K13's training mode + K14): the mean softmax
    cross-entropy of a batch of CTUs, a `torch.autograd.Function` whose
    forward is K13 writing the logits and activations, and whose backward
    is K14 (softmax - onehot, then each layer's input and weight
    gradients, per-CTU partial sums reduced over the batch in a second
    pass); `cnn_loss_plain` is autograd through the conv2d chain.
  * `adam_update` (K15): optax.adam's step, in place over the flat
    parameter, gradient and moment buffers; `adam_update_plain` is
    optax's formula in torch ops.

CUDA tensors launch the kernels (no fallback: a failed build or launch
raises); CPU tensors run the twins.  No f32 product here goes through
tensor cores: TF32 would flip near-tied logits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build

# (out channels, in channels, kernel size, stride) of Conv_0 .. Conv_3;
# Conv_4 is 1x1, 64 -> D
_CONVS = ((16, 1, 3, 2), (32, 16, 3, 2), (64, 32, 3, 2), (64, 65, 3, 1))
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def layout(n_depths: int) -> list:
    """[(name, shape)] of the flat parameter buffer, in order: each layer's
    OIHW kernel, then its bias."""
    shapes = [(o, i, k, k) for o, i, k, _ in _CONVS] + [(n_depths, 64, 1, 1)]
    out = []
    for li, shp in enumerate(shapes):
        out += [(f"Conv_{li}.kernel", shp), (f"Conv_{li}.bias", (shp[0],))]
    return out


def n_params(n_depths: int) -> int:
    return sum(int(np.prod(s)) for _, s in layout(n_depths))


def unflatten(theta: torch.Tensor, n_depths: int) -> list:
    """[(kernel, bias)] views of the flat buffer, one per layer."""
    if theta.dim() != 1 or theta.numel() != n_params(n_depths):
        raise ValueError(f"partition CNN: {theta.numel()} parameters do not "
                         f"make a network of {n_depths} depths "
                         f"({n_params(n_depths)} expected)")
    views, at = [], 0
    for _, shp in layout(n_depths):
        size = int(np.prod(shp))
        views.append(theta[at:at + size].view(shp))
        at += size
    return list(zip(views[0::2], views[1::2]))


def _depths(theta: torch.Tensor, log2_ctu: int) -> int:
    """The depth count of a CTU of 2^log2_ctu; raises ValueError when the
    buffer holds a network of another depth count (flax's apply raises
    on such a tree)."""
    if log2_ctu not in (5, 6):
        raise ValueError("partition CNN: CTU 32 or 64")
    d = log2_ctu - 2
    unflatten(theta, d)
    return d


def qp_feature(qp) -> torch.Tensor:
    """qp / 51 in f32, as the reference divides an f32 qp by 51.  The
    divisor is a tensor on q's device: PyTorch's CUDA division by a host
    scalar multiplies by the reciprocal, which rounds otherwise."""
    q = torch.as_tensor(qp, dtype=torch.float32)
    return q / torch.tensor(51.0, dtype=torch.float32, device=q.device)


def logits_plain(x: torch.Tensor, qp, layers) -> torch.Tensor:
    """The conv2d chain: x [B, 1, S, S] normalised luma, qp [B] (or a
    scalar), layers [(kernel OIHW, bias)] x 5 -> logits [B, S/8, S/8, D]
    (flax's NHWC order)."""
    h = x
    for (w, b), (_, _, _, stride) in zip(layers[:3], _CONVS[:3]):
        h = F.relu(F.conv2d(F.pad(h, (0, 1, 0, 1)), w, b, stride=stride))
    bsz, _, g, _ = h.shape
    q = qp_feature(qp).to(h.device).expand(bsz)
    h = torch.cat([h, q[:, None, None, None].expand(bsz, 1, g, g)], dim=1)
    h = F.relu(F.conv2d(h, *layers[3], padding=1))
    return F.conv2d(h, *layers[4]).permute(0, 2, 3, 1)


def ctu_batch(planes: torch.Tensor, ctu: int) -> torch.Tensor:
    """[F, H, W] luma -> [F * H/ctu * W/ctu, 1, ctu, ctu] f32 normalised
    (v - 128) / 128, in frame, then CTU raster order."""
    f, h, w = planes.shape
    t = (planes.reshape(f, h // ctu, ctu, w // ctu, ctu)
         .permute(0, 1, 3, 2, 4).reshape(-1, 1, ctu, ctu))
    return (t.to(torch.float32) - 128.0) / 128.0


def _granule_map(depth: torch.Tensor, f: int, h: int, w: int,
                 ctu: int) -> torch.Tensor:
    """[F * CTUs, g, g] -> [F, H/8, W/8]."""
    g = ctu // 8
    gy, gx = h // ctu, w // ctu
    return (depth.reshape(f, gy, gx, g, g).permute(0, 1, 3, 2, 4)
            .reshape(f, gy * g, gx * g))


def cnn_depth_plain(planes: torch.Tensor, theta: torch.Tensor, qp,
                    log2_ctu: int) -> torch.Tensor:
    """K13's twin: padded luma [F, H, W] (H, W multiples of the CTU) ->
    int16 [F, H/8, W/8] granule depth map, the first of equal logits
    winning (as jnp.argmax)."""
    d = _depths(theta, log2_ctu)
    ctu = 1 << log2_ctu
    f, h, w = planes.shape
    x = ctu_batch(planes, ctu)
    logits = logits_plain(x, qp, unflatten(theta, d))
    return _granule_map(torch.argmax(logits, dim=-1).to(torch.int16), f, h,
                        w, ctu)


def _plane_dtype(planes: torch.Tensor) -> int:
    """K13's code of a luma plane's type (its training mode takes f32)."""
    codes = {torch.uint8: 0, torch.int32: 1}
    if planes.dtype not in codes:
        raise ValueError(f"partition CNN: luma planes of uint8 or int32, "
                         f"not {planes.dtype}")
    return codes[planes.dtype]


def cnn_depth(planes: torch.Tensor, theta: torch.Tensor, qp, log2_ctu: int,
              plain: bool = False) -> torch.Tensor:
    """Granule depth maps of F padded luma planes [F, H, W] (uint8 or
    int32) at one qp: int16 [F, H/8, W/8].  CUDA tensors go through K13
    unless `plain`: one launch for the whole batch."""
    if plain or not planes.is_cuda:
        return cnn_depth_plain(planes, theta, qp, log2_ctu)
    _depths(theta, log2_ctu)
    planes = planes.contiguous()
    theta = theta.to(torch.float32).contiguous()
    _build.require_cuda("cnn_depth", planes, theta)
    f, h, w = planes.shape
    ctu = 1 << log2_ctu
    if h % ctu or w % ctu:
        raise ValueError("cnn_depth: planes padded to the CTU grid")
    depth = torch.empty((f, h >> 3, w >> 3), dtype=torch.int16,
                        device=planes.device)
    rc = _build.lib().fhv_cnn_fwd(
        planes.data_ptr(), _plane_dtype(planes), None, float(qp),
        theta.data_ptr(), depth.data_ptr(), None, None, f, h, w, log2_ctu,
        _build.stream_handle(planes))
    _build.launched("cnn_depth")
    _build.check(rc, "cnn_depth")
    return depth


def acts_per_ctu(ctu: int) -> int:
    """Floats of one CTU's saved post-ReLU activations (K13's training
    mode): 16 x (S/2)^2 + 32 x (S/4)^2 + 2 x 64 x (S/8)^2 = 8 S^2."""
    return 8 * ctu * ctu


def cnn_train_forward(x: torch.Tensor, q: torch.Tensor,
                      theta: torch.Tensor) -> tuple:
    """K13's training mode: x [B, S, S] normalised CTUs, q [B] qps ->
    (logits [B, S/8, S/8, D], activations [B, 8 S^2]) on the card."""
    bsz, s, _ = x.shape
    d = _depths(theta, s.bit_length() - 1)
    x = x.to(torch.float32).contiguous()
    q = q.to(torch.float32).contiguous()
    theta = theta.detach().to(torch.float32).contiguous()
    _build.require_cuda("cnn_train", x, q, theta)
    g = s >> 3
    logits = torch.empty((bsz, g, g, d), dtype=torch.float32,
                         device=x.device)
    acts = torch.empty((bsz, acts_per_ctu(s)), dtype=torch.float32,
                       device=x.device)
    rc = _build.lib().fhv_cnn_fwd(
        x.data_ptr(), 2, q.data_ptr(), 0.0, theta.data_ptr(), None,
        logits.data_ptr(), acts.data_ptr(), bsz, s, s, s.bit_length() - 1,
        _build.stream_handle(x))
    _build.launched("cnn_train")
    _build.check(rc, "cnn_train")
    return logits, acts


def cnn_backward(x, q, labels, theta, acts, logits) -> torch.Tensor:
    """K14: the gradient of the mean softmax cross-entropy over the B x g x
    g granules with respect to the flat parameters, from K13's saved
    logits and activations: [P] f32."""
    bsz, s, _ = x.shape
    d = _depths(theta, s.bit_length() - 1)
    labels = labels.to(torch.int32).contiguous()
    x, q, theta, acts, logits = (t.detach().to(torch.float32).contiguous()
                                 for t in (x, q, theta, acts, logits))
    _build.require_cuda("cnn_backward", x, q, labels, theta, acts, logits)
    g = s >> 3
    if labels.shape != (bsz, g, g) or logits.shape != (bsz, g, g, d):
        raise ValueError("cnn_backward: labels [B, S/8, S/8], logits "
                         "[B, S/8, S/8, D]")
    partial = torch.empty((bsz, theta.numel()), dtype=torch.float32,
                          device=x.device)
    grad = torch.empty_like(theta)
    inv_n = float(np.float32(1.0) / np.float32(bsz * g * g))
    rc = _build.lib().fhv_cnn_bwd(
        x.data_ptr(), q.data_ptr(), labels.data_ptr(), theta.data_ptr(),
        acts.data_ptr(), logits.data_ptr(), partial.data_ptr(),
        grad.data_ptr(), bsz, s.bit_length() - 1, inv_n,
        _build.stream_handle(x))
    _build.launched("cnn_backward")
    _build.check(rc, "cnn_backward")
    return grad


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels(...).mean()."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None]).mean()


class _CnnLoss(torch.autograd.Function):
    """K13's training mode forward, K14 backward."""

    @staticmethod
    def forward(ctx, theta, x, q, labels):
        logits, acts = cnn_train_forward(x, q, theta)
        ctx.save_for_backward(theta, x, q, labels, acts, logits)
        ctx.mark_non_differentiable(logits)
        return _ce(logits, labels), logits

    @staticmethod
    def backward(ctx, grad_loss, _grad_logits):
        theta, x, q, labels, acts, logits = ctx.saved_tensors
        grad = cnn_backward(x, q, labels, theta, acts, logits)
        return grad * grad_loss, None, None, None


def cnn_loss_plain(theta: torch.Tensor, x: torch.Tensor, q: torch.Tensor,
                   labels: torch.Tensor) -> tuple:
    """The twin of `cnn_loss`: autograd through the conv2d chain."""
    d = _depths(theta, x.shape[-1].bit_length() - 1)
    logits = logits_plain(x[:, None].to(torch.float32), q,
                          unflatten(theta, d))
    return _ce(logits, labels), logits


def cnn_loss(theta: torch.Tensor, x: torch.Tensor, q: torch.Tensor,
             labels: torch.Tensor, plain: bool = False) -> tuple:
    """(mean cross-entropy, logits [B, S/8, S/8, D]) of a batch of CTUs x
    [B, S, S] (normalised), qps q [B] and granule labels [B, S/8, S/8]
    under the flat parameters theta; differentiable in theta.  CUDA
    tensors go through K13's training mode and K14 unless `plain`."""
    if plain or not x.is_cuda:
        return cnn_loss_plain(theta, x, q, labels)
    return _CnnLoss.apply(theta, x, q, labels)


def _bias_corrections(step: int) -> tuple:
    """1 - b1^t and 1 - b2^t in f32, as optax's bias_correction computes
    them (decay ** count in f32)."""
    t = np.float32(step)
    return (float(np.float32(1) - np.float32(ADAM_B1) ** t),
            float(np.float32(1) - np.float32(ADAM_B2) ** t))


def adam_update_plain(theta, grad, m, v, step: int, lr: float) -> None:
    """K15's twin: optax.adam(lr)'s update at count `step` (1-based), in
    place: m = (1 - b1) g + b1 m; v = (1 - b2) g^2 + b2 v; theta +=
    -lr * (m / bc1) / (sqrt(v / bc2) + eps), every constant in f32."""
    # the divisors as tensors on the buffers' device: PyTorch's CUDA
    # division by a host scalar multiplies by its reciprocal instead
    bc1, bc2 = (torch.tensor(b, dtype=torch.float32, device=theta.device)
                for b in _bias_corrections(step))
    f32 = np.float32
    m.mul_(f32(ADAM_B1)).add_(grad * f32(1 - ADAM_B1))
    v.mul_(f32(ADAM_B2)).add_(grad * grad * f32(1 - ADAM_B2))
    upd = (m / bc1) / (torch.sqrt(v / bc2) + f32(ADAM_EPS))
    theta.add_(upd * f32(-lr))


def adam_update(theta, grad, m, v, step: int, lr: float,
                plain: bool = False) -> None:
    """optax.adam(lr)'s step at count `step` over flat f32 buffers, in
    place.  CUDA tensors go through K15 (one launch) unless `plain`."""
    if plain or not theta.is_cuda:
        adam_update_plain(theta, grad, m, v, step, lr)
        return
    _build.require_cuda("adam", theta, grad, m, v, dtype=torch.float32)
    if not theta.shape == grad.shape == m.shape == v.shape:
        raise ValueError("adam: theta, grad, m and v of one shape")
    bc1, bc2 = _bias_corrections(step)
    rc = _build.lib().fhv_adam(
        theta.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(),
        theta.numel(), float(lr), ADAM_B1, float(np.float32(1 - ADAM_B1)),
        ADAM_B2, float(np.float32(1 - ADAM_B2)), ADAM_EPS, bc1, bc2,
        _build.stream_handle(theta))
    _build.launched("adam")
    _build.check(rc, "adam")
