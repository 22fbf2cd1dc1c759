"""Kernels of the port: each public function launches its CUDA kernel for
CUDA tensors and runs its plain PyTorch twin (`*_plain`, same module) for
CPU tensors.  Counterparts of `fasthevc_tpu.ops`, same file names."""

import numpy as np
import torch


def per_frame(v, nf: int) -> list:
    """A scalar or a per-frame sequence (QPs, lambdas) as a list of F
    values: a batch of frames may mix temporal layers."""
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    if isinstance(v, (list, tuple, np.ndarray)):
        if len(v) != nf:
            raise ValueError(f"expected {nf} per-frame values, got {len(v)}")
        return list(v)
    return [v] * nf
