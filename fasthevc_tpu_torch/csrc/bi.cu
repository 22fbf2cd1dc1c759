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
//
// The selected form (fhv_bi_select) replaces the same candidate and
// the direction choice after it (search.py:476-491): with the lists' merge
// winners' costs c0, c1 and predictions p0, p1 it forms pbi and cbi as
// above, takes the first least of (c0, c1, cbi) (jnp.argmin over the
// stack; inf included), and writes the chosen prediction pred_sel, the
// chosen rate (r0bits, r1bits or their f32 sum) and the direction.  It
// took the place of bi_cost, whose pbi went to device memory in full,
// followed by stack, argmin and three torch.where in PyTorch; bi_cost
// stays callable.  Bound on the H100: bytes, bi_cost's plus c0, c1, the
// p0 or p1 samples of the blocks where a list wins, and pred_sel,
// rate_sel and dchoice.  bi_cost ran one CTA a block (64 threads at n = 8),
// recomputed the 8 horizontal rows of every predicted sample, held both
// windows as int32 and left one thread of 64 to run an 8-block's Hadamard
// serially behind two barriers.  Design: a CTA holds P blocks (P = 16, 4,
// 1, 1 for n = 8-64: 128 threads, 512 at n = 64, every lane busy in every
// stage); both lists' edge-clamped windows go to shared memory as 16-bit
// samples (8 loads in flight a thread); the horizontal 8-tap pass runs once
// per (window row, 8-sample segment, list), the phase's taps in registers,
// into shared memory; then 8 lanes take an 8x8 sub-block, a lane a column:
// the vertical pass of both lists into registers, the bi average, the
// residual against the source read from device memory, and the Hadamard
// with the columns in a lane and the rows across the 8 lanes by shuffles
// (satd8_lanes, satd_common.cuh, shared with K11's merge form).  The
// sub-blocks' sums meet in shared memory (exact integer sums in any order);
// after one barrier every lane prices its block, and each writes its
// column of the chosen prediction from its registers (BI) or from p0 / p1,
// which are read only where that list wins.

#include <cuda_runtime.h>

#include "copy_common.cuh"
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


// ---------------------------------------------------------------------------
// The selected form: the BI candidate and the direction

template <int N>
struct SelCfg {
  static constexpr int S = (N / 8) * (N / 8);      // 8x8 sub-blocks
  static constexpr int SEG = N / 8;                // 8-sample row segments
  static constexpr int kThreads = N == 64 ? 512 : 128;
  static constexpr int P = kThreads / (8 * S);     // blocks a CTA
  static constexpr int WW = N + 7;                 // window side
  static constexpr int kWin = WW * WW;             // a list's window (int16)
  static constexpr int kH = WW * N;                // its horizontal pass
  static constexpr int kSmem = P * 2 * (kH * 4 + kWin * 2);
  // 8 lanes a sub-block, one pass: every lane holds its column's pbi in
  // registers across the barrier before the choice
  static_assert(P * S * 8 == kThreads, "one sub-block column a thread");
};

template <int N>
__global__ void __launch_bounds__(SelCfg<N>::kThreads)
    bi_select_kernel(const int* __restrict__ src, const int* __restrict__ refs,
                     const int* __restrict__ mv0, const int* __restrict__ sel0,
                     const int* __restrict__ mv1, const int* __restrict__ sel1,
                     const float* __restrict__ r0bits,
                     const float* __restrict__ r1bits,
                     const float* __restrict__ c0,
                     const float* __restrict__ c1,
                     const int* __restrict__ p0, const int* __restrict__ p1,
                     float ls, int* __restrict__ pred_sel,
                     float* __restrict__ rate_sel, int* __restrict__ dchoice,
                     int B, int H, int W) {
  using C = SelCfg<N>;
  extern __shared__ __align__(16) int ssm[];
  int* hbuf = ssm;                                          // [P, 2, kH]
  short* win = reinterpret_cast<short*>(ssm + C::P * 2 * C::kH);  // [P, 2]
  __shared__ int taps[32];
  __shared__ int s_frac[C::P][2][2];  // the MV's phases (x, y)
  __shared__ int s_org[C::P][2][2];   // its window's origin (y, x)
  __shared__ int s_sel[C::P][2];      // its state reference
  __shared__ int s_satd[C::P];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * C::P;
  const int gx = W / N;
  if (tid < 32) taps[tid] = kLuma[tid / 8][tid % 8];
  if (tid < 2 * C::P) {
    const int j = tid >> 1, l = tid & 1;
    const int b = min(b0 + j, B - 1);  // past the end: a copy, not written
    const int* mv = l ? mv1 : mv0;
    const int mx = mv[2 * b], my = mv[2 * b + 1];
    s_frac[j][l][0] = mx & 3;
    s_frac[j][l][1] = my & 3;
    s_org[j][l][0] = (b / gx) * N + (my >> 2) - 3;
    s_org[j][l][1] = (b % gx) * N + (mx >> 2) - 3;
    s_sel[j][l] = (l ? sel1 : sel0)[b];
    if (l == 0) s_satd[j] = 0;
  }
  __syncthreads();
  // window (j, l): the n + 7 rows and columns the 8 taps read, from the
  // block's origin + the MV's integer part - 3, edge-clamped
  batched_copy<C::kThreads>(
      C::P * 2 * C::kWin, tid,
      [&](int i) {
        const int jl = i / C::kWin, p = i - jl * C::kWin;
        const int j = jl >> 1, l = jl & 1;
        const int row = p / C::WW, col = p - row * C::WW;
        const int yy = min(max(s_org[j][l][0] + row, 0), H - 1);
        const int xx = min(max(s_org[j][l][1] + col, 0), W - 1);
        return refs[(size_t)s_sel[j][l] * H * W + (size_t)yy * W + xx];
      },
      [&](int i, int v) { win[i] = (short)v; });
  __syncthreads();
  // horizontal pass: a thread per (block, list, window row, segment)
  for (int i = tid; i < C::P * 2 * C::WW * C::SEG; i += C::kThreads) {
    const int seg = i % C::SEG;
    const int rest = i / C::SEG;
    const int row = rest % C::WW, jl = rest / C::WW;
    const int fx = s_frac[jl >> 1][jl & 1][0];
    int t[8], wv[15];
#pragma unroll
    for (int q = 0; q < 8; ++q) t[q] = taps[fx * 8 + q];
    const short* w = win + jl * C::kWin + row * C::WW + seg * 8;
#pragma unroll
    for (int q = 0; q < 15; ++q) wv[q] = w[q];
    int* h = hbuf + jl * C::kH + row * N + seg * 8;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      int acc = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) acc += t[q] * wv[x + q];
      h[x] = acc;
    }
  }
  __syncthreads();
  // vertical pass of both lists, the bi average and the SATD: 8 lanes a
  // (block, sub-block), a lane a column
  const int c = tid & 7;
  const int s = (tid >> 3) % C::S, j = (tid >> 3) / C::S;
  const int sy = s / C::SEG, sx = s - sy * C::SEG;
  const int x = sx * 8 + c;
  const int b = min(b0 + j, B - 1);
  const size_t at = (size_t)(b / gx) * N * W + (size_t)(b % gx) * N +
                    (size_t)sy * 8 * W + x;  // the sample (sy * 8, x) in src
  int raw[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int pb[8], d[8];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int fy = s_frac[j][l][1];
    int t[8], col[15];
#pragma unroll
    for (int q = 0; q < 8; ++q) t[q] = taps[fy * 8 + q];
    const int* h = hbuf + (j * 2 + l) * C::kH + sy * 8 * N + x;
#pragma unroll
    for (int q = 0; q < 15; ++q) col[q] = h[q * N];
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      int acc = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) acc += t[q] * col[y + q];
      raw[y] += acc >> 6;
    }
  }
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    pb[y] = min(max((raw[y] + 64) >> 7, 0), 255);
    d[y] = src[at + (size_t)y * W] - pb[y];
  }
  const int v = satd8_lanes(d, c);
  if (c == 0) atomicAdd(&s_satd[j], v);
  __syncthreads();
  // the direction: the first least of (c0, c1, cbi), as argmin over the
  // stack takes it; cbi's rate sum is rounded first, then one fused
  // multiply-add (XLA's evaluation of the reference's expression)
  const float a0 = c0[b], a1 = c1[b], q0 = r0bits[b], q1 = r1bits[b];
  const float rsum = __fadd_rn(q0, q1);
  const float cbi = __fmaf_rn(ls, rsum, __int2float_rn(s_satd[j]));
  int dir = 0;
  float best = a0;
  if (a1 < best) {
    dir = 1;
    best = a1;
  }
  if (cbi < best) dir = 2;
  if (b0 + j >= B) return;
  const size_t o = (size_t)b * N * N + (size_t)sy * 8 * N + x;
  if (dir == 2) {
#pragma unroll
    for (int y = 0; y < 8; ++y) pred_sel[o + (size_t)y * N] = pb[y];
  } else {
    const int* pin = dir ? p1 : p0;
#pragma unroll
    for (int y = 0; y < 8; ++y)
      pred_sel[o + (size_t)y * N] = pin[o + (size_t)y * N];
  }
  if (s == 0 && c == 0) {
    rate_sel[b] = dir == 0 ? q0 : (dir == 1 ? q1 : rsum);
    dchoice[b] = dir;
  }
}

template <int N>
int launch_select(const int* src, const int* refs, const int* mv0,
                  const int* sel0, const int* mv1, const int* sel1,
                  const float* r0bits, const float* r1bits, const float* c0,
                  const float* c1, const int* p0, const int* p1, float ls,
                  int* pred_sel, float* rate_sel, int* dchoice, int B, int H,
                  int W, cudaStream_t stream) {
  using C = SelCfg<N>;
  // the opt-in above 48 KB (n = 64) belongs to the current device: set it
  // on every launch
  cudaError_t err = cudaFuncSetAttribute(
      bi_select_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  bi_select_kernel<N><<<(B + C::P - 1) / C::P, C::kThreads, C::kSmem,
                        stream>>>(src, refs, mv0, sel0, mv1, sel1, r0bits,
                                  r1bits, c0, c1, p0, p1, ls, pred_sel,
                                  rate_sel, dchoice, B, H, W);
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

// As fhv_bi_cost, with c0/c1 [B] f32 and p0/p1 [B, n, n] the lists' costs
// and predictions; pred_sel [B, n, n], rate_sel [B] f32 and dchoice [B]
// (0 list 0, 1 list 1, 2 BI) out.  Samples must fit 16 bits.
extern "C" int fhv_bi_select(const int* src, const int* refs, const int* mv0,
                             const int* sel0, const int* mv1, const int* sel1,
                             const float* r0bits, const float* r1bits,
                             const float* c0, const float* c1, const int* p0,
                             const int* p1, float ls, int* pred_sel,
                             float* rate_sel, int* dchoice, int R, int H,
                             int W, int n, cudaStream_t stream) {
  if (n < 8 || n > 64 || (n & (n - 1)) || H % n || W % n)
    return (int)cudaErrorInvalidValue;
  const int B = (H / n) * (W / n);
  if (R <= 0 || B <= 0) return 0;
  switch (n) {
    case 8:
      return launch_select<8>(src, refs, mv0, sel0, mv1, sel1, r0bits,
                              r1bits, c0, c1, p0, p1, ls, pred_sel, rate_sel,
                              dchoice, B, H, W, stream);
    case 16:
      return launch_select<16>(src, refs, mv0, sel0, mv1, sel1, r0bits,
                               r1bits, c0, c1, p0, p1, ls, pred_sel,
                               rate_sel, dchoice, B, H, W, stream);
    case 32:
      return launch_select<32>(src, refs, mv0, sel0, mv1, sel1, r0bits,
                               r1bits, c0, c1, p0, p1, ls, pred_sel,
                               rate_sel, dchoice, B, H, W, stream);
    default:
      return launch_select<64>(src, refs, mv0, sel0, mv1, sel1, r0bits,
                               r1bits, c0, c1, p0, p1, ls, pred_sel,
                               rate_sel, dchoice, B, H, W, stream);
  }
}
