// K8: the Annex D.3.19 picture checksum (hash_type 2) of F uint8 planes.
//
// Replaces fasthevc_tpu/codec/device_pipeline.py _device_checksum (:55):
// per plane, the sum of every sample XOR its position mask
// ((x & 0xff) ^ (y & 0xff) ^ (x >> 8) ^ (y >> 8)), wrapping mod 2^32.
// A grid reduction: each thread sums a strided run of samples in uint32,
// the CTA reduces in shared memory, and one uint32 atomicAdd per CTA adds
// into the frame's sum (wrapping adds commute, so the order is free).
//
// Bound on the H100: device-memory reads, one byte per sample.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;

__global__ void checksum_kernel(const unsigned char* __restrict__ planes,
                                unsigned* __restrict__ out, int H, int W) {
  __shared__ unsigned part[kThreads];
  const int f = blockIdx.y;
  const long long n = (long long)H * W;
  const unsigned char* p = planes + (size_t)f * n;
  unsigned acc = 0;
  const long long start =
      (long long)blockIdx.x * blockDim.x * kPerThread + threadIdx.x;
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = start + (long long)k * blockDim.x;
    if (i >= n) break;
    const unsigned y = (unsigned)(i / W), x = (unsigned)(i % W);
    const unsigned mask = (x & 0xff) ^ (y & 0xff) ^ (x >> 8) ^ (y >> 8);
    acc += (unsigned)p[i] ^ mask;
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) atomicAdd(out + f, part[0]);
}

}  // namespace

// out: F uint32 sums, zeroed by the caller
extern "C" int fhv_checksum(const unsigned char* planes, unsigned* out,
                            int F, int H, int W, cudaStream_t stream) {
  if (F <= 0) return 0;
  const long long n = (long long)H * W;
  const long long per_cta = (long long)kThreads * kPerThread;
  dim3 grid((unsigned)((n + per_cta - 1) / per_cta), F);
  checksum_kernel<<<grid, kThreads, 0, stream>>>(planes, out, H, W);
  return (int)cudaGetLastError();
}
