"""Search kernels of the port: each public function launches its CUDA kernel
for CUDA tensors and runs its plain PyTorch twin (`*_plain`, same module)
for CPU tensors.  Counterparts of `fasthevc_tpu.ops`, same file names."""
