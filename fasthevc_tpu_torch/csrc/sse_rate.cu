// K4: per-block SSE and the level-rate proxy of the intra search.
//
// Replaces fasthevc_tpu/ops/cost.py sse (:53) and level_rate_proxy (:78)
// as the search calls them on the same blocks (codec/search.py:188-190).
// dist = sum (res - rq)^2, summed exactly in int64 and rounded once to
// f32.  rate = the per-TB-size linear bit model over the level features
// (counts of |l| == 1, == 2, > 2, sum of log2(1 + |l|) over |l| > 2, and
// log2(1 + the largest x + y of a nonzero level)), floored at
// 2 + the nonzero count, and 0 for an all-zero block.
//
// Bound on the H100: device-memory reads, 12 * n^2 bytes per block, with a
// handful of integer ops per sample.  Design: one warp per block; lanes
// stride over the samples and the partial sums meet in warp shuffles, so
// no shared memory and no atomics.  The model's f32 arithmetic uses
// round-to-nearest intrinsics in the reference's order (no contraction
// into fused multiply-adds).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void sse_rate_kernel(const int* __restrict__ res,
                                const int* __restrict__ rq,
                                const int* __restrict__ lv,
                                float* __restrict__ dist,
                                float* __restrict__ rate, int B, int n,
                                int lg, float w0, float w1, float w2, float w3,
                                float w4, float w5) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= B) return;
  const int nn = n * n;
  const size_t base = (size_t)warp * nn;
  long long sse = 0;
  int ones = 0, twos = 0, esc = 0, last = -1;
  float esclog = 0.f;
  for (int i = lane; i < nn; i += 32) {
    const long long d = (long long)res[base + i] - rq[base + i];
    sse += d * d;
    const int a = abs(lv[base + i]);
    ones += a == 1;
    twos += a == 2;
    if (a > 2) {
      ++esc;
      esclog = __fadd_rn(esclog, log2f(__fadd_rn(1.f, (float)a)));
    }
    if (a > 0) last = max(last, (i >> lg) + (i & (n - 1)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sse += __shfl_down_sync(0xffffffffu, sse, off);
    ones += __shfl_down_sync(0xffffffffu, ones, off);
    twos += __shfl_down_sync(0xffffffffu, twos, off);
    esc += __shfl_down_sync(0xffffffffu, esc, off);
    esclog = __fadd_rn(esclog, __shfl_down_sync(0xffffffffu, esclog, off));
    last = max(last, __shfl_down_sync(0xffffffffu, last, off));
  }
  if (lane != 0) return;
  dist[warp] = (float)sse;
  if (last < 0) {
    rate[warp] = 0.f;
    return;
  }
  const float fo = (float)ones, ft = (float)twos, fe = (float)esc;
  float bits = __fmul_rn(w0, fo);
  bits = __fadd_rn(bits, __fmul_rn(w1, ft));
  bits = __fadd_rn(bits, __fmul_rn(w2, fe));
  bits = __fadd_rn(bits, __fmul_rn(w3, esclog));
  bits = __fadd_rn(bits, __fmul_rn(w4, log2f(__fadd_rn(1.f, (float)last))));
  bits = __fadd_rn(bits, w5);
  const float floor_bits = __fadd_rn(__fadd_rn(__fadd_rn(2.f, fo), ft), fe);
  rate[warp] = fmaxf(bits, floor_bits);
}

}  // namespace

extern "C" int fhv_sse_rate(const int* res, const int* rq, const int* lv,
                            float* dist, float* rate, int B, int n, int lg,
                            float w0, float w1, float w2, float w3, float w4,
                            float w5, cudaStream_t stream) {
  if (B <= 0) return 0;
  const long long threads = (long long)B * 32;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  sse_rate_kernel<<<grid, kThreads, 0, stream>>>(res, rq, lv, dist, rate, B,
                                                 n, lg, w0, w1, w2, w3, w4,
                                                 w5);
  return (int)cudaGetLastError();
}
