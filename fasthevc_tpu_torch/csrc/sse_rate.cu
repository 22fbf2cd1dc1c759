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
// no shared memory and no atomics.  The lanes' sums, their reduction and
// the model are rate_common.cuh's, which the costed form of K3 shares.
// No route launches K4 since K3's costed form (`tq_cost`) took its place
// in the search; it stays as the tested counterpart of sse and
// level_rate_proxy.

#include <cuda_runtime.h>

#include "rate_common.cuh"

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
  RateLane r;
  for (int i = lane; i < nn; i += 32) {
    const long long d = (long long)res[base + i] - rq[base + i];
    r.sse += d * d;
    rate_level(r, lv[base + i], i, lg, n);
  }
  const float w[6] = {w0, w1, w2, w3, w4, w5};
  rate_finish(r, lane, w, dist + warp, rate + warp);
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
