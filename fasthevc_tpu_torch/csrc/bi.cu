// K12: the bi-prediction cost of the B search.
//
// Replaces the BI candidate of fasthevc_tpu/codec/search.py search_b_frame
// (:476-481): for every n-block, the raw 14-bit predictions of both lists
// at their final quarter-pel MVs (mc_raw_from_state_sel, me.py:671), the
// spec's bi average pbi = clip((raw0 + raw1 + 64) >> 7, 0, 255) (8.5.4.3.5),
// and its cost
//   cbi = SATD(src - pbi) + lambda_sqrt * (r0bits + r1bits)
// in f32, the rate sum rounded first, then one fused multiply-add, which is
// how XLA's CPU backend evaluates the reference's expression.  Each list's
// MV is a sub-pel winner or a merge winner whose window test passed, so
// it lies inside the reference's tier window and the window test is not
// taken: the kernel reads the edge-clamped reference directly.
//
// Bound on the H100: bytes.  The function reads the four reference planes
// and the source once (the blocks' windows overlap), each block's MVs,
// refs and rates, and writes n^2 + 1 values a block; it runs the separable
// 8-tap filter of two lists (2 ((n + 7) n + n^2) 8-tap filters), the
// average and the 8x8 Hadamard: 4.2 int32 operations a byte at n = 8 and
// 3.5 at n = 32 on a 1080p frame, under the card's 10.  Design: one CTA per
// block loads both edge-clamped
// windows and the source block into shared memory; each thread filters its
// samples of both lists with K11's filter (mc_common.cuh, recomputing the
// 8 horizontal rows of a sample, three times the separable work), averages
// them into shared memory, and (n / 8)^2 threads take K2's 8x8 SATD
// (satd_common.cuh) of the sub-blocks.

#include <cuda_runtime.h>

#include "mc_common.cuh"
#include "satd_common.cuh"

namespace {

// The shared layout, sized for blocks up to 32 (20 KB) or for CTU 64's
// 64-blocks (73 KB, above the 48 KB default, so the launch opts in).
template <int MaxN>
struct BiSmem {
  int win[2][(MaxN + 7) * (MaxN + 7)];
  int src[MaxN * MaxN];
  int pred[MaxN * MaxN];
  int satd;
};

template <int MaxN>
__global__ void __launch_bounds__(256)
    bi_cost_kernel(const int* __restrict__ src, const int* __restrict__ refs,
                   const int* __restrict__ mv0, const int* __restrict__ sel0,
                   const int* __restrict__ mv1, const int* __restrict__ sel1,
                   const float* __restrict__ r0bits,
                   const float* __restrict__ r1bits, float ls,
                   int* __restrict__ pbi, float* __restrict__ cbi, int H,
                   int W, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BiSmem<MaxN>& S = *reinterpret_cast<BiSmem<MaxN>*>(smem_raw);
  auto& win = S.win;
  int* s_src = S.src;
  int* s_pred = S.pred;
  int& s_satd = S.satd;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int gx = W / n;
  const int oy = (b / gx) * n, ox = (b % gx) * n;
  const int nn = n * n, ww = n + 7;
  const int mx[2] = {mv0[2 * b], mv1[2 * b]};
  const int my[2] = {mv0[2 * b + 1], mv1[2 * b + 1]};
  const int* ref[2] = {refs + (size_t)sel0[b] * H * W,
                       refs + (size_t)sel1[b] * H * W};
  for (int i = tid; i < nn; i += blockDim.x)
    s_src[i] = src[(size_t)(oy + i / n) * W + ox + i % n];
  // window l: the n + 7 rows and columns the 8 taps read, from block + the
  // MV's integer part - 3, edge-clamped
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int wy = oy + (my[l] >> 2) - 3, wx = ox + (mx[l] >> 2) - 3;
    for (int i = tid; i < ww * ww; i += blockDim.x) {
      const int yy = min(max(wy + i / ww, 0), H - 1);
      const int xx = min(max(wx + i % ww, 0), W - 1);
      win[l][i] = ref[l][(size_t)yy * W + xx];
    }
  }
  if (tid == 0) s_satd = 0;
  __syncthreads();
  // sample (y, x) of list l reads window rows and columns y..y+7, x..x+7:
  // mc_raw at (y + 3, x + 3) with the fractional MV never clamps there
  for (int i = tid; i < nn; i += blockDim.x) {
    const int y = i / n, x = i - y * n;
    const int raw0 = mc_raw<8>(win[0], ww, ww, y + 3, x + 3, mx[0] & 3,
                               my[0] & 3, 2, 0);
    const int raw1 = mc_raw<8>(win[1], ww, ww, y + 3, x + 3, mx[1] & 3,
                               my[1] & 3, 2, 0);
    const int p = min(max((raw0 + raw1 + 64) >> 7, 0), 255);
    s_pred[i] = p;
    pbi[(size_t)b * nn + i] = p;
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
        d[rr * 8 + cc] = s_src[at] - s_pred[at];
      }
    atomicAdd(&s_satd, satd_subblock<8>(d));
  }
  __syncthreads();
  if (tid == 0)
    cbi[b] = __fmaf_rn(ls, __fadd_rn(r0bits[b], r1bits[b]), (float)s_satd);
}

template <int MaxN>
int launch(const int* src, const int* refs, const int* mv0, const int* sel0,
           const int* mv1, const int* sel1, const float* r0bits,
           const float* r1bits, float ls, int* pbi, float* cbi, int B, int H,
           int W, int n, cudaStream_t stream) {
  const int smem = (int)sizeof(BiSmem<MaxN>);
  cudaError_t err = cudaFuncSetAttribute(
      bi_cost_kernel<MaxN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = n * n < 256 ? n * n : 256;
  bi_cost_kernel<MaxN><<<B, threads, smem, stream>>>(
      src, refs, mv0, sel0, mv1, sel1, r0bits, r1bits, ls, pbi, cbi, H, W,
      n);
  return (int)cudaGetLastError();
}

}  // namespace

// src [H, W], refs [R, H, W], mv0/mv1 [B, 2] (x, y) quarter pels, sel0/sel1
// [B] absolute indices into refs, r0bits/r1bits [B] f32; pbi [B, n, n],
// cbi [B] f32.  B = (H / n) * (W / n), n in 8, 16, 32, 64.
extern "C" int fhv_bi_cost(const int* src, const int* refs, const int* mv0,
                           const int* sel0, const int* mv1, const int* sel1,
                           const float* r0bits, const float* r1bits, float ls,
                           int* pbi, float* cbi, int R, int H, int W, int n,
                           cudaStream_t stream) {
  if (n < 8 || n > 64 || (n & (n - 1)) || H % n || W % n)
    return (int)cudaErrorInvalidValue;
  const int B = (H / n) * (W / n);
  if (R <= 0 || B <= 0) return 0;
  if (n <= 32)
    return launch<32>(src, refs, mv0, sel0, mv1, sel1, r0bits, r1bits, ls,
                      pbi, cbi, B, H, W, n, stream);
  return launch<64>(src, refs, mv0, sel0, mv1, sel1, r0bits, r1bits, ls, pbi,
                    cbi, B, H, W, n, stream);
}
