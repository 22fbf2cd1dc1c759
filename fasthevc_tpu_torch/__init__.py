"""fasthevc_tpu_torch: the HEVC encoder of fasthevc_tpu on PyTorch and CUDA.

The JAX package `fasthevc_tpu` is the reference; this package mirrors its
layout (`ops/`, `codec/`) so each function has a counterpart of the same
name.  The dense per-pixel stages are hand-written CUDA kernels for Hopper
(`csrc/*.cu`, built by `_build.py` at first use); each has a plain PyTorch
twin beside its wrapper, which the wrapper runs only for tensors that lie
on the CPU.

The host layers that never touched JAX are this package's own verbatim
copies, so that it imports nothing of `fasthevc_tpu` (and no JAX):
  * `spec/` from `fasthevc_tpu/spec/` (the NumPy oracle, `SpecDecoder`,
    the syntax writers, `MotionCtx`, the MC filter taps);
  * `config/` from `fasthevc_tpu/config/`, `utils/` from
    `fasthevc_tpu/utils/`, `codec/gop.py` from `fasthevc_tpu/codec/gop.py`;
  * `cabac_cpp/` from `fasthevc_tpu/cabac_cpp/` (the C++ entropy engine,
    loaded through ctypes), whose only change is where g++ writes its
    library: `build/fasthevc_tpu_torch/`, keyed by a hash of the sources.
A fix to one of these layers is made in both packages.

Slices ported so far (`codec.encoder.TorchEncoder`): the all-intra encode
on both of TpuEncoder's routes, the low-delay P and random-access encodes
on the device route, and the fast-partition path on every one of them
(`models/`: the partition CNN, fused into the searches, and its
self-distilled training).
"""

import torch

# f32 stands in for nothing integer here, but keep every matmul and
# convolution in full f32 so that no plain twin ever rounds through TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
