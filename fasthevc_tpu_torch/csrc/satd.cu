// K2: Hadamard SATD of (src - pred) for B blocks x M predictions.
//
// Replaces fasthevc_tpu/ops/cost.py satd (:26) as the search calls it
// (codec/search.py:163, satd(src[:, None] - preds)).  Per block: the
// residual is cut into hb x hb sub-blocks (hb = 8, or 4 when n == 4), each
// is Hadamard-transformed in both directions, its absolute sum divided by
// hb (floor, HM normalisation), and the sub-block values are summed.
//
// Bound on the H100: device-memory reads of the [B, M, n, n] int32
// predictions (292 MB per 1080p frame); the arithmetic is a few dozen
// integer adds per sample.  Design: one thread per (block, prediction,
// sub-block) keeps its hb x hb residual in registers and runs the
// butterflies there, so the [B, 35, n, n] residual that the JAX package
// materialises is never written; sub-block values of one (block,
// prediction) meet in an integer atomicAdd (exact, order-free).  The
// sub-block transform is shared with K10 through satd_common.cuh.

#include <cuda_runtime.h>

#include "satd_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int HB>
__global__ void satd_kernel(const int* __restrict__ src,
                            const int* __restrict__ pred,
                            int* __restrict__ out, long long total, int M,
                            int n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int nbx = n / HB;
  const int nbs = nbx * nbx;
  const long long bm = idx / nbs;
  const int s = (int)(idx - bm * nbs);
  const long long b = bm / M;
  const int sy = s / nbx, sx = s - sy * nbx;
  const int* sp = src + b * n * n + (sy * HB) * n + sx * HB;
  const int* pp = pred + bm * n * n + (sy * HB) * n + sx * HB;
  int d[HB * HB];
#pragma unroll
  for (int r = 0; r < HB; ++r)
#pragma unroll
    for (int c = 0; c < HB; ++c) d[r * HB + c] = sp[r * n + c] - pp[r * n + c];
  const int v = satd_subblock<HB>(d);
  if (nbs == 1)
    out[bm] = v;
  else
    atomicAdd(out + bm, v);
}

}  // namespace

// out must be zeroed by the caller when n > 8 (sub-blocks accumulate).
extern "C" int fhv_satd(const int* src, const int* pred, int* out, int B,
                        int M, int n, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int hb = n < 8 ? n : 8;
  const long long total = (long long)B * M * (n / hb) * (n / hb);
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  if (hb == 8)
    satd_kernel<8><<<grid, kThreads, 0, stream>>>(src, pred, out, total, M, n);
  else if (hb == 4)
    satd_kernel<4><<<grid, kThreads, 0, stream>>>(src, pred, out, total, M, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
