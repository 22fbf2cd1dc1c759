// K10: the sub-pel stage of motion estimation.
//
// Replaces fasthevc_tpu/ops/me.py _subpel_core (:343) as subpel_from_state
// (:564), subpel_refine (:320) and search_inter_costs (:688) run it: for
// every (ref, n-block), the 9 half-pel candidates around 4 * mv_int (dy
// outer, dx inner, (0, 0) included), then the 8 quarter-pel candidates
// around the stage-1 winner (dy outer, dx inner).  Each candidate is the
// exact separable 8-tap prediction (spec 8.5.4.2.2: horizontal taps, then
// vertical taps >> 6, then (raw + 32) >> 6 and the clip to 255 at every bit
// depth, as the reference clips) costed
//   SATD(src - pred) + lambda_sqrt * XLA_MV_RATE[|mvx| + |mvy|]
// in f32 as one fused multiply-add, which is how XLA evaluates the
// reference's expression; strict < from (inf, 4 * mv_int, zeros) in
// candidate order keeps the first of equal costs.  The SATD is K2's
// sub-block transform (satd_common.cuh).
//
// The reference takes its windows from the per-tier gathers of me_state
// through one-hot selects (me.py:169-184, 574-578); those hold
// edge-clamped reference samples, so the kernel reads the reference with
// clamping directly.
//
// Bound on the H100: integer operations.  A candidate costs (n + 7) * n * 8
// + n^2 * 8 filter multiply-adds and ~3 n^2 SATD operations; 17 candidates
// over 4 block sizes and 2 refs make about 20 G operations per 1080p frame.
// Design: a CTA holds P blocks of one reference (P * (n/8)^2 = 16 sub-blocks
// up to n = 32; one 64-block) with each block's source, clamped (n + 8)^2
// window and the four horizontal phases of that window, (n + 8) rows of
// n + 1 columns each, in shared memory: every candidate's horizontal pass
// is one of those (its phase is tx & 3, its integer column offset 0 or 1),
// so the horizontal work is done once per block, not once per candidate.
// A stage's candidates then run concurrently, one thread per (block,
// candidate, 8x8 sub-block): the thread filters its sub-block vertically
// from the shared phase into registers and transforms the residual there.
// Sub-block SATDs meet in a shared integer sum; one thread per block then
// walks the stage's costs in candidate order (the reference's serial
// strict <).  Only the final winner's prediction is computed again and
// written, once.

#include <assert.h>
#include <cuda_runtime.h>

#include "satd_common.cuh"

namespace {

__constant__ int kLumaTaps[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};

constexpr int kCands = 17;  // 9 half-pel, then 8 quarter-pel

// Shared layout of one block, in ints: source n^2, window (n+8)^2, the four
// horizontal phases, the 17 candidate SATDs; the stride is odd so that the
// P blocks of a CTA fall in different banks.
template <int N>
struct Cfg {
  static constexpr int S = (N / 8) * (N / 8);       // 8x8 sub-blocks
  static constexpr int P = N <= 32 ? 16 / S : 1;    // blocks a CTA
  static constexpr int kThreads = N <= 32 ? 9 * P * S : 288;
  static constexpr int WW = N + 8;                  // window side
  static constexpr int HW = N + 1;                  // phase row width
  static constexpr int HSZ = WW * HW;               // one phase
  static constexpr int kWin = N * N;
  static constexpr int kH = kWin + WW * WW;
  static constexpr int kSatd = kH + 4 * HSZ;
  static constexpr int kStride = (kSatd + kCands) | 1;
};

// Candidate c's offset (tx, ty) in quarter pels from 4 * mv_int: the half
// grid for c < 9, the ring around the half winner (hx, hy) after it.
__device__ __forceinline__ void cand_offset(int c, int hx, int hy, int& tx,
                                            int& ty) {
  if (c < 9) {
    ty = 2 * (c / 3) - 2;
    tx = 2 * (c % 3) - 2;
  } else {
    const int q = c - 9 < 4 ? c - 9 : c - 8;  // skip the centre
    ty = hy + q / 3 - 1;
    tx = hx + q % 3 - 1;
  }
}

template <int N>
__global__ void __launch_bounds__(Cfg<N>::kThreads)
    subpel_kernel(const int* __restrict__ src, const int* __restrict__ refs,
                  const int* __restrict__ mv_int,
                  const float* __restrict__ rate_tab, int tab_len, float ls,
                  float* __restrict__ out_c, int* __restrict__ out_mv,
                  int* __restrict__ out_p, int H, int W, int B) {
  using C = Cfg<N>;
  extern __shared__ __align__(16) int sm[];
  __shared__ int taps[32];
  __shared__ int mvi[C::P][2];       // integer MV
  __shared__ int half[C::P][2];      // stage-1 winner's offset
  __shared__ int best_mv[C::P][2];   // quarter pels
  __shared__ int best_k[C::P];       // winning candidate, -1 for none
  __shared__ float best_c[C::P];
  const int tid = threadIdx.x;
  const int r = blockIdx.y;
  const int b0 = blockIdx.x * C::P;
  const int nb = min(C::P, B - b0);
  const int gx = W / N;
  const int* ref = refs + (size_t)r * H * W;

  if (tid < 32) taps[tid] = kLumaTaps[tid / 8][tid % 8];
  if (tid < nb) {
    const size_t rb = (size_t)r * B + b0 + tid;
    mvi[tid][0] = mv_int[rb * 2];
    mvi[tid][1] = mv_int[rb * 2 + 1];
    best_mv[tid][0] = 4 * mvi[tid][0];
    best_mv[tid][1] = 4 * mvi[tid][1];
    half[tid][0] = half[tid][1] = 0;
    best_k[tid] = -1;
    best_c[tid] = __int_as_float(0x7f800000);
  }
  for (int i = tid; i < nb * kCands; i += blockDim.x)
    sm[(i / kCands) * C::kStride + C::kSatd + i % kCands] = 0;
  for (int i = tid; i < nb * N * N; i += blockDim.x) {
    const int j = i / (N * N), p = i - j * (N * N);
    const int b = b0 + j;
    const int oy = (b / gx) * N, ox = (b % gx) * N;
    sm[j * C::kStride + p] = src[(size_t)(oy + p / N) * W + ox + p % N];
  }
  __syncthreads();
  // windows: origin block + mv_int - 4, edge-clamped
  for (int i = tid; i < nb * C::WW * C::WW; i += blockDim.x) {
    const int j = i / (C::WW * C::WW), p = i - j * (C::WW * C::WW);
    const int b = b0 + j;
    const int oy = (b / gx) * N, ox = (b % gx) * N;
    const int yy = min(max(oy + mvi[j][1] - 4 + p / C::WW, 0), H - 1);
    const int xx = min(max(ox + mvi[j][0] - 4 + p % C::WW, 0), W - 1);
    sm[j * C::kStride + C::kWin + p] = ref[(size_t)yy * W + xx];
  }
  __syncthreads();
  // the four horizontal phases over (n + 8) rows and n + 1 columns
  for (int i = tid; i < nb * 4 * C::HSZ; i += blockDim.x) {
    const int j = i / (4 * C::HSZ), q = i - j * (4 * C::HSZ);
    const int fx = q / C::HSZ, e = q - fx * C::HSZ;
    const int row = e / C::HW, col = e - row * C::HW;
    const int* w = sm + j * C::kStride + C::kWin + row * C::WW + col;
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += taps[fx * 8 + k] * w[k];
    sm[j * C::kStride + C::kH + q] = acc;
  }
  __syncthreads();

  // one stage: candidates [c0, c0 + nc) of every block, one thread per
  // (candidate, block, sub-block)
  auto stage = [&](int c0, int nc) {
    for (int u = tid; u < nc * C::P * C::S; u += blockDim.x) {
      const int c = c0 + u / (C::P * C::S);
      const int rest = u % (C::P * C::S);
      const int j = rest / C::S, s = rest % C::S;
      if (j >= nb) continue;
      int tx, ty;
      cand_offset(c, half[j][0], half[j][1], tx, ty);
      const int fx = tx & 3, fy = ty & 3;
      const int ix = (tx >> 2) + 1, iy = (ty >> 2) + 1;  // 0 or 1
      const int sy = s / (N / 8), sx = s % (N / 8);
      const int* blk = sm + j * C::kStride;
      const int* hp = blk + C::kH + fx * C::HSZ + (sy * 8 + iy) * C::HW +
                      sx * 8 + ix;
      const int* sp = blk + sy * 8 * N + sx * 8;
      int t[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = taps[fy * 8 + k];
      int d[64];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        int col[15];
#pragma unroll
        for (int k = 0; k < 15; ++k) col[k] = hp[k * C::HW + x];
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          int acc = 0;
#pragma unroll
          for (int k = 0; k < 8; ++k) acc += t[k] * col[y + k];
          const int raw = acc >> 6;
          d[y * 8 + x] = sp[y * N + x] - min(max((raw + 32) >> 6, 0), 255);
        }
      }
      const int v = satd_subblock<8>(d);
      if (C::S == 1)
        sm[j * C::kStride + C::kSatd + c] = v;
      else
        atomicAdd(sm + j * C::kStride + C::kSatd + c, v);
    }
  };
  // the reference's serial strict < over candidates [c0, c1) of block j
  auto choose = [&](int j, int c0, int c1) {
    const int* satd = sm + j * C::kStride + C::kSatd;
    float bc = best_c[j];
    int bk = best_k[j], bx = best_mv[j][0], by = best_mv[j][1];
    for (int c = c0; c < c1; ++c) {
      int tx, ty;
      cand_offset(c, half[j][0], half[j][1], tx, ty);
      const int mx = 4 * mvi[j][0] + tx, my = 4 * mvi[j][1] + ty;
      const int mag = abs(mx) + abs(my);
      assert(mag < tab_len);
      const float cost = __fmaf_rn(ls, rate_tab[mag], (float)satd[c]);
      if (cost < bc) {
        bc = cost;
        bk = c;
        bx = mx;
        by = my;
      }
    }
    best_c[j] = bc;
    best_k[j] = bk;
    best_mv[j][0] = bx;
    best_mv[j][1] = by;
  };

  stage(0, 9);
  __syncthreads();
  if (tid < nb) {
    choose(tid, 0, 9);
    half[tid][0] = best_mv[tid][0] - 4 * mvi[tid][0];
    half[tid][1] = best_mv[tid][1] - 4 * mvi[tid][1];
  }
  __syncthreads();
  stage(9, kCands - 9);
  __syncthreads();
  if (tid < nb) {
    choose(tid, 9, kCands);
    const size_t rb = (size_t)r * B + b0 + tid;
    out_c[rb] = best_c[tid];
    out_mv[rb * 2] = best_mv[tid][0];
    out_mv[rb * 2 + 1] = best_mv[tid][1];
  }
  __syncthreads();
  // the winner's prediction, computed again and written once (zeros when no
  // candidate beat the initial infinite cost)
  for (int i = tid; i < nb * N * N; i += blockDim.x) {
    const int j = i / (N * N), p = i - j * (N * N);
    const int y = p / N, x = p - y * N;
    int v = 0;
    if (best_k[j] >= 0) {
      int tx, ty;
      cand_offset(best_k[j], half[j][0], half[j][1], tx, ty);
      const int fx = tx & 3, fy = ty & 3;
      const int ix = (tx >> 2) + 1, iy = (ty >> 2) + 1;
      const int* hp = sm + j * C::kStride + C::kH + fx * C::HSZ +
                      (y + iy) * C::HW + x + ix;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += taps[fy * 8 + k] * hp[k * C::HW];
      v = min(max(((acc >> 6) + 32) >> 6, 0), 255);
    }
    out_p[((size_t)r * B + b0) * N * N + i] = v;
  }
}

template <int N>
int launch(const int* src, const int* refs, const int* mv_int,
           const float* rate_tab, int tab_len, float ls, float* out_c,
           int* out_mv, int* out_p, int R, int B, int H, int W,
           cudaStream_t stream) {
  using C = Cfg<N>;
  const int smem = (int)sizeof(int) * C::P * C::kStride;
  // the opt-in above 48 KB belongs to the current device: set it on every
  // launch
  cudaError_t err = cudaFuncSetAttribute(
      subpel_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + C::P - 1) / C::P, R);
  subpel_kernel<N><<<grid, C::kThreads, smem, stream>>>(
      src, refs, mv_int, rate_tab, tab_len, ls, out_c, out_mv, out_p, H, W,
      B);
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
  switch (n) {
    case 8:
      return launch<8>(src, refs, mv_int, rate_tab, tab_len, ls, out_c,
                       out_mv, out_p, R, B, H, W, stream);
    case 16:
      return launch<16>(src, refs, mv_int, rate_tab, tab_len, ls, out_c,
                        out_mv, out_p, R, B, H, W, stream);
    case 32:
      return launch<32>(src, refs, mv_int, rate_tab, tab_len, ls, out_c,
                        out_mv, out_p, R, B, H, W, stream);
    case 64:
      return launch<64>(src, refs, mv_int, rate_tab, tab_len, ls, out_c,
                        out_mv, out_p, R, B, H, W, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
