"""fasthevc_tpu_torch: the HEVC encoder of fasthevc_tpu on PyTorch and CUDA.

The JAX package `fasthevc_tpu` is the reference; this package mirrors its
layout (`ops/`, `codec/`) so each function has a counterpart of the same
name.  The dense per-pixel search stages are hand-written CUDA kernels for
Hopper (`csrc/*.cu`, built by `_build.py` at first use); each has a plain
PyTorch twin beside its wrapper, which the wrapper runs only for tensors
that lie on the CPU.

The host layers that never touch JAX are shared, not ported:
`fasthevc_tpu.spec`, `fasthevc_tpu.cabac_cpp`, `fasthevc_tpu.config` and
`fasthevc_tpu.utils`.  This package imports no JAX.

Slice ported so far: the all-intra encode with the intra search on the
GPU and the commit, in-loop filters and CABAC in the shared C++ engine
(`codec.encoder.TorchEncoder`).
"""

import torch

# f32 stands in for nothing integer here, but keep every matmul and
# convolution in full f32 so that no plain twin ever rounds through TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
