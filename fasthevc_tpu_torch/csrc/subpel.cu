// K10: the sub-pel stage of motion estimation.
//
// Replaces fasthevc_tpu/ops/me.py _subpel_core (:343) as subpel_from_state
// (:564), subpel_refine (:320) and search_inter_costs (:688) run it: for
// every (ref, n-block), the 9 half-pel candidates around 4 * mv_int (dy
// outer, dx inner, (0, 0) included), then the 8 quarter-pel candidates
// around the stage-1 winner (dy outer, dx inner).  Each candidate is the
// exact separable 8-tap prediction (spec 8.5.4.2.2: horizontal taps, then
// vertical taps >> 6, then (raw + 32) >> 6 and the clip) costed
//   SATD(src - pred) + lambda_sqrt * XLA_MV_RATE[|mvx| + |mvy|]
// in f32 as one fused multiply-add, which is how XLA evaluates the
// reference's expression; strict < from (inf, 4 * mv_int, zeros) keeps the
// first of equal costs.  The SATD is K2's sub-block transform
// (satd_common.cuh).
//
// The reference takes its windows from the per-tier gathers of me_state
// through one-hot selects (me.py:169-184, 574-578); those hold
// edge-clamped reference samples, so the kernel reads the reference with
// clamping directly.
//
// Bound on the H100: integer operations.  A candidate costs (n + 7) * n * 8
// + n^2 * 8 filter multiply-adds and ~3 n^2 SATD operations; 17 candidates
// over 4 block sizes and 2 refs make about 20 G operations per 1080p frame.
// Design: one CTA per (ref, block) keeps the source block, the clamped
// (n + 8)^2 window, the horizontal filter rows and the best prediction in
// shared memory; candidates run one after another between barriers.  The
// shared layout is sized for blocks up to 32 (23 KB), or for the 64-blocks
// of CTU 64's tier (88 KB, above the 48 KB default, so the launch opts in).

#include <assert.h>
#include <cuda_runtime.h>

#include "satd_common.cuh"

namespace {

constexpr int kThreads = 256;

__constant__ int kLumaTaps[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};

template <int MaxN>
struct Smem {
  int src[MaxN * MaxN];
  int win[(MaxN + 8) * (MaxN + 8)];
  int hbuf[(MaxN + 7) * MaxN];
  int pred[MaxN * MaxN];
  int best_pred[MaxN * MaxN];
  int satd;
  int better;
  float best_cost;
  int best_mx, best_my;
};

template <int MaxN>
__global__ void __launch_bounds__(kThreads)
    subpel_kernel(const int* __restrict__ src, const int* __restrict__ refs,
                  const int* __restrict__ mv_int,
                  const float* __restrict__ rate_tab, int tab_len, float ls,
                  float* __restrict__ out_c, int* __restrict__ out_mv,
                  int* __restrict__ out_p, int H, int W, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MaxN>& S = *reinterpret_cast<Smem<MaxN>*>(smem_raw);
  const int tid = threadIdx.x;
  const int gx = W / n;
  const int B = (H / n) * gx;
  const int b = blockIdx.x, r = blockIdx.y;
  const size_t rb = (size_t)r * B + b;
  const int oy = (b / gx) * n, ox = (b % gx) * n;
  const int mix = mv_int[rb * 2], miy = mv_int[rb * 2 + 1];
  const int nn = n * n, ww = n + 8;
  const int* ref = refs + (size_t)r * H * W;
  for (int i = tid; i < nn; i += blockDim.x)
    S.src[i] = src[(size_t)(oy + i / n) * W + ox + i % n];
  // window origin: block + mv_int - 4
  for (int i = tid; i < ww * ww; i += blockDim.x) {
    const int yy = min(max(oy + miy - 4 + i / ww, 0), H - 1);
    const int xx = min(max(ox + mix - 4 + i % ww, 0), W - 1);
    S.win[i] = ref[(size_t)yy * W + xx];
  }
  if (tid == 0) {
    S.best_cost = __int_as_float(0x7f800000);
    S.best_mx = 4 * mix;
    S.best_my = 4 * miy;
  }
  for (int i = tid; i < nn; i += blockDim.x) S.best_pred[i] = 0;
  __syncthreads();

  int half_x = 0, half_y = 0;
  for (int c = 0; c < 17; ++c) {
    int tx, ty;
    if (c < 9) {
      ty = 2 * (c / 3) - 2;
      tx = 2 * (c % 3) - 2;
    } else {
      if (c == 9) {  // the stage-1 winner, relative to 4 * mv_int
        half_x = S.best_mx - 4 * mix;
        half_y = S.best_my - 4 * miy;
      }
      const int q = c - 9 < 4 ? c - 9 : c - 8;  // skip the centre
      ty = half_y + q / 3 - 1;
      tx = half_x + q % 3 - 1;
    }
    const int fx = tx & 3, fy = ty & 3;
    const int ix = (tx >> 2) + 1, iy = (ty >> 2) + 1;  // window offsets
    // horizontal taps over the n + 7 rows the vertical taps read
    for (int i = tid; i < (n + 7) * n; i += blockDim.x) {
      const int j = i / n, x = i - j * n;
      const int* w = S.win + (j + iy) * ww + x + ix;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += kLumaTaps[fx][k] * w[k];
      S.hbuf[i] = acc;
    }
    if (tid == 0) S.satd = 0;
    __syncthreads();
    for (int i = tid; i < nn; i += blockDim.x) {
      const int y = i / n, x = i - y * n;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += kLumaTaps[fy][k] * S.hbuf[(y + k) * n + x];
      const int raw = acc >> 6;
      S.pred[i] = min(max((raw + 32) >> 6, 0), 255);
    }
    __syncthreads();
    const int nsub = (n / 8) * (n / 8);
    if (tid < nsub) {
      const int sy = tid / (n / 8), sx = tid - sy * (n / 8);
      int d[64];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const int at = (sy * 8 + rr) * n + sx * 8 + cc;
          d[rr * 8 + cc] = S.src[at] - S.pred[at];
        }
      atomicAdd(&S.satd, satd_subblock<8>(d));
    }
    __syncthreads();
    if (tid == 0) {
      const int mx = 4 * mix + tx, my = 4 * miy + ty;
      const int mag = abs(mx) + abs(my);
      assert(mag < tab_len);
      const float cost = __fmaf_rn(ls, rate_tab[mag], (float)S.satd);
      S.better = cost < S.best_cost;
      if (S.better) {
        S.best_cost = cost;
        S.best_mx = mx;
        S.best_my = my;
      }
    }
    __syncthreads();
    if (S.better)
      for (int i = tid; i < nn; i += blockDim.x) S.best_pred[i] = S.pred[i];
    __syncthreads();
  }
  for (int i = tid; i < nn; i += blockDim.x)
    out_p[rb * nn + i] = S.best_pred[i];
  if (tid == 0) {
    out_c[rb] = S.best_cost;
    out_mv[rb * 2] = S.best_mx;
    out_mv[rb * 2 + 1] = S.best_my;
  }
}

template <int MaxN>
int launch(const int* src, const int* refs, const int* mv_int,
           const float* rate_tab, int tab_len, float ls, float* out_c,
           int* out_mv, int* out_p, int R, int B, int H, int W, int n,
           cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<MaxN>);
  cudaError_t err = cudaFuncSetAttribute(
      subpel_kernel<MaxN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, R);
  subpel_kernel<MaxN><<<grid, kThreads, smem, stream>>>(
      src, refs, mv_int, rate_tab, tab_len, ls, out_c, out_mv, out_p, H, W,
      n);
  return (int)cudaGetLastError();
}

}  // namespace

// src [H, W], refs [R, H, W], mv_int [R, B, 2] (x, y) integer pels; out_c
// [R, B] f32, out_mv [R, B, 2] quarter pels, out_p [R, B, n, n]; n in 8,
// 16, 32, 64.
extern "C" int fhv_subpel(const int* src, const int* refs, const int* mv_int,
                          const float* rate_tab, int tab_len, float ls,
                          float* out_c, int* out_mv, int* out_p, int R, int H,
                          int W, int n, cudaStream_t stream) {
  const int B = (H / n) * (W / n);
  if (R <= 0 || B <= 0) return 0;
  if (n < 8 || n > 64 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  if (n <= 32)
    return launch<32>(src, refs, mv_int, rate_tab, tab_len, ls, out_c,
                      out_mv, out_p, R, B, H, W, n, stream);
  return launch<64>(src, refs, mv_int, rate_tab, tab_len, ls, out_c, out_mv,
                    out_p, R, B, H, W, n, stream);
}
