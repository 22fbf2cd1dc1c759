// K3: exact integer T -> Q -> IQ -> IT for B blocks of n x n residuals, in
// two forms that share one transform core.
//
// Replaces fasthevc_tpu/ops/transform.py tq_roundtrip_fast (:151), the
// search's f32 stand-in for the integer pipeline (a TPU workaround: that
// chip has no native s32 matmul).  This kernel computes the exact form of
// tq_roundtrip (:139): the two-stage forward DCT with the spec shifts, the
// HM dead-zone quantiser (offset dz/512: 171 intra, 85 inter) and flat-list
// dequantiser with 64-bit products, and the normative inverse DCT with its
// clips.  `tq_roundtrip` returns the levels and the reconstructed residual;
// `tq_cost` (the form the search runs) follows them with K4's epilogue
// (rate_common.cuh: the exact SSE and the level-rate proxy, in K4's lane
// order), so per block it writes only (dist, rate) and the levels and the
// recon never reach device memory.  In the search it replaces the pair
// tq_roundtrip_fast + sse / level_rate_proxy (search.py:188-190, :216-217,
// :285-286, :418-419).
//
// Bound on the H100: at n = 8 the bytes (4 B a sample in, 8 B a block
// out for tq_cost), at n = 32 the integer operations of the butterflies.
// The first design (one output sample per thread and stage, an n-long dot
// product over shared memory, runtime n with an integer division per
// sample, one CTA per block at n = 32) ran 8x its bound at n = 8, and K4
// read all its outputs again.  This design:
//   * a template on log2 n: loops, shifts, the CTA's blocks (256 / n) and
//     the shared layout are compile-time; one thread per row (and column)
//     of a block, 256 threads a CTA at every n;
//   * HM's even-odd partial butterflies (partialButterfly4..32 and their
//     inverses) on a row held in registers, the odd-row coefficients in
//     __constant__ memory at compile-time offsets;
//   * shared memory only for the transposes between the 1-D passes, rows
//     padded to n + 1 words so that row and column walks hit 32 banks;
//   * the residual read as int4, the tq_roundtrip form's outputs written
//     as int4 from shared memory (coalesced).
// The butterflies equal the matrix products exactly while no partial sum
// leaves int32.  Every partial sum is bounded by the largest row (forward)
// or column (inverse) L1 norm of T_n times the largest input: 64 n and
// at most 1862.  Forward stage 1 on residuals of |x| <= 1023 (the search
// runs at bit_depth 8 on 10-bit content too): <= 2048 * 1023 < 2^21; after
// the shift of lg - 1, |tmp| <= 130944 at every n, and stage 2 stays below
// 2048 * 130945 < 2^29.  The inverse's inputs are clipped to 16 bits:
// <= 1862 * 32768 < 2^26.  The shifts, clips, quantiser and dequantiser
// are tq_common.cuh's, as K5 computes them.

#include <cuda_runtime.h>

#include "rate_common.cuh"
#include "tq_common.cuh"

namespace {

constexpr int kThreads = 256;

// T32's rows, first 16 columns: T_n[k][j] = T32[k * 32 / n][j] (the even
// rows of T_2n embed T_n), so the odd rows of every size are here
__constant__ short kT32[32][16] = {
    {64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64},
    {90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4},
    {90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90},
    {90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90, -88, -78, -61, -38, -13},
    {89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89},
    {88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38, 73, 90, 85, 61, 22},
    {87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87},
    {85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54, -4, -61, -90, -78, -31},
    {83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83},
    {82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90, -67, 4, 73, 88, 38},
    {80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80},
    {78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31, 90, 54, -38, -90, -46},
    {75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75},
    {73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61, -46, -88, -4, 85, 54},
    {70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70},
    {67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88, -31, 82, 46, -73, -61},
    {64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64},
    {61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22, 85, -38, -78, 54, 67},
    {57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57},
    {54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67, -78, -22, 90, -31, -73},
    {50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50},
    {46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85, 13, 73, -82, 4, 78},
    {43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43},
    {38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13, 61, -90, 54, 22, -82},
    {36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36},
    {31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73, -90, 67, -13, -46, 85},
    {25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25},
    {22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82, 54, -13, -31, 67, -88},
    {18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18},
    {13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4, 22, -46, 67, -82, 90},
    {9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9},
    {4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78, -82, 85, -88, 90, -90},
};

// The n-point core transform of one row in registers: fwd y = T_n x,
// inv y = T_n^T x, by HM's even-odd decomposition (exact integers).
template <int N>
struct Bfly {
  static __device__ __forceinline__ void fwd(const int (&x)[N], int (&y)[N]) {
    int e[N / 2], o[N / 2], ye[N / 2];
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      e[k] = x[k] + x[N - 1 - k];
      o[k] = x[k] - x[N - 1 - k];
    }
    Bfly<N / 2>::fwd(e, ye);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k < N / 2; ++k)
        acc += kT32[(2 * i + 1) * (32 / N)][k] * o[k];
      y[2 * i] = ye[i];
      y[2 * i + 1] = acc;
    }
  }
  static __device__ __forceinline__ void inv(const int (&x)[N], int (&y)[N]) {
    int xe[N / 2], e[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) xe[i] = x[2 * i];
    Bfly<N / 2>::inv(xe, e);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      int o = 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i)
        o += kT32[(2 * i + 1) * (32 / N)][j] * x[2 * i + 1];
      y[j] = e[j] + o;
      y[N - 1 - j] = e[j] - o;
    }
  }
};

template <>
struct Bfly<2> {  // T_2 = [[64, 64], [64, -64]], symmetric
  static __device__ __forceinline__ void fwd(const int (&x)[2], int (&y)[2]) {
    y[0] = 64 * x[0] + 64 * x[1];
    y[1] = 64 * x[0] - 64 * x[1];
  }
  static __device__ __forceinline__ void inv(const int (&x)[2], int (&y)[2]) {
    fwd(x, y);
  }
};

__device__ __forceinline__ int clip16(int v) {
  return min(max(v, -32768), 32767);
}

// the quantiser's and dequantiser's scales by qp % 6 (spec 8.6.3); 32-bit,
// so that the compiler multiplies them into 64 bits in one instruction
__constant__ int kQuantScale[6] = {26214, 23302, 20560, 18396, 16384, 14564};
__constant__ int kInvScale[6] = {40, 45, 51, 57, 64, 72};

// Shared words of a CTA at n = 2^LG: three [256 / n blocks][n rows][n + 1]
// tiles (the residual, the work tile of the transposes, the levels or, in
// the costed form, each level's f32 rate term), then each block's totals
// for the costed form.
template <int LG>
struct TqPlan {
  static constexpr int N = 1 << LG, NN = N * N;
  static constexpr int BPC = kThreads / N;  // blocks a CTA
  static constexpr int RS = N + 1;          // padded row
  static constexpr int BS = N * RS;         // padded block
  static constexpr int TILE = BPC * BS;
  static constexpr size_t BYTES =
      3 * TILE * sizeof(int) + BPC * sizeof(RateLane);
};

// One CTA: 256 / n blocks, thread t on row (and column) t % n of block
// t / n.  COST: write (dist, rate) per block; else levels and recon.
template <int LG, bool COST>
__global__ void __launch_bounds__(kThreads)
    tq_kernel(const int* __restrict__ res, int* __restrict__ levels,
              int* __restrict__ recon, float* __restrict__ dist,
              float* __restrict__ rate, int B, int qp, int bit_depth, int dz,
              float w0, float w1, float w2, float w3, float w4, float w5) {
  using P = TqPlan<LG>;
  constexpr int N = P::N, NN = P::NN, RS = P::RS, BS = P::BS;
  extern __shared__ __align__(16) int smem[];
  int* X = smem;              // residual
  int* W = smem + P::TILE;    // tmp, then d, e, recon (in place)
  int* L = W + P::TILE;       // levels, or (costed) their rate terms
  RateLane* tot = reinterpret_cast<RateLane*>(L + P::TILE);  // per block

  const int b0 = blockIdx.x * P::BPC;
  const int nb = min(P::BPC, B - b0);
  const int shift1 = LG + bit_depth - 9;
  const int shift2 = LG + 6;
  const int qbits = 14 + qp / 6 + (15 - bit_depth - LG);
  const long long scale = kQuantScale[qp % 6];
  const long long f = (long long)dz << (qbits - 9);
  const long long dq = kInvScale[qp % 6] * 16;
  const int qp_per = qp / 6;
  const int bd_shift = bit_depth + LG - 5;
  const int inv_shift2 = 20 - bit_depth;

  // the CTA's blocks are contiguous: int4 loads, 4 samples of one row each
  {
    const int4* src = reinterpret_cast<const int4*>(res + (size_t)b0 * NN);
    const int nv = nb * NN / 4;
    for (int v = threadIdx.x; v < P::BPC * NN / 4; v += kThreads) {
      const int4 q = v < nv ? src[v] : make_int4(0, 0, 0, 0);
      const int i = 4 * v, blk = i / NN, p = i - blk * NN;
      int* d = X + blk * BS + (p >> LG) * RS + (p & (N - 1));
      d[0] = q.x;
      d[1] = q.y;
      d[2] = q.z;
      d[3] = q.w;
    }
  }
  __syncthreads();
  const int r = threadIdx.x & (N - 1);
  const int blk = threadIdx.x >> LG;
  int* Xb = X + blk * BS;
  int* Wb = W + blk * BS;
  int* Lb = L + blk * BS;
  int v[N], t[N];

  // forward stage 1 on column r: tmp[:, r] = T x[:, r], rounded >> shift1
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = Xb[j * RS + r];
  Bfly<N>::fwd(v, t);
#pragma unroll
  for (int k = 0; k < N; ++k)
    Wb[k * RS + r] =
        shift1 > 0 ? (t[k] + (1 << (shift1 - 1))) >> shift1 : t[k];
  __syncthreads();
  // forward stage 2 on row r, quantise, dequantise (the row in place); the
  // costed form keeps the row's level counts and each level's rate term
  // (K4's f32 log2(1 + |l|) where |l| > 2, else 0, which adds exactly
  // nothing to its sum)
#pragma unroll
  for (int m = 0; m < N; ++m) v[m] = Wb[r * RS + m];
  Bfly<N>::fwd(v, t);
  int ones = 0, twos = 0, esc = 0, last = -1;
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const int c = (t[l] + (1 << (shift2 - 1))) >> shift2;
    const int lv = tq_quant(c, scale, f, qbits);
    Wb[r * RS + l] = tq_dequant(lv, dq, qp_per, bd_shift);
    if constexpr (COST) {
      const int a = abs(lv);
      ones += a == 1;
      twos += a == 2;
      esc += a > 2;
      if (a > 0) last = r + l;
      reinterpret_cast<float*>(Lb)[r * RS + l] = a > 2 ? rate_term(a) : 0.f;
    } else {
      Lb[r * RS + l] = lv;
    }
  }
  __syncthreads();
  // inverse stage 1 on column r: e[:, r] = T^T d[:, r], clipped to 16 bits
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = Wb[q * RS + r];
  Bfly<N>::inv(v, t);
#pragma unroll
  for (int k = 0; k < N; ++k) Wb[k * RS + r] = clip16((t[k] + 64) >> 7);
  __syncthreads();
  // inverse stage 2 on row r: the reconstructed residual row
#pragma unroll
  for (int m = 0; m < N; ++m) v[m] = Wb[r * RS + m];
  Bfly<N>::inv(v, t);
  if constexpr (COST) {
    long long sse = 0;
#pragma unroll
    for (int l = 0; l < N; ++l) {
      const int d =
          Xb[r * RS + l] -
          clip16((t[l] + (1 << (inv_shift2 - 1))) >> inv_shift2);
      sse += (unsigned)(d * d);  // |d| < 2^16
    }
    // the block's integer totals meet in its n row threads (n consecutive
    // lanes of one warp), in whatever order
#pragma unroll
    for (int off = N / 2; off > 0; off >>= 1) {
      sse += __shfl_down_sync(0xffffffffu, sse, off, N);
      ones += __shfl_down_sync(0xffffffffu, ones, off, N);
      twos += __shfl_down_sync(0xffffffffu, twos, off, N);
      esc += __shfl_down_sync(0xffffffffu, esc, off, N);
      last = max(last, __shfl_down_sync(0xffffffffu, last, off, N));
    }
    if (r == 0) {
      RateLane& b = tot[blk];
      b.sse = sse;
      b.ones = ones;
      b.twos = twos;
      b.esc = esc;
      b.last = last;
    }
    __syncthreads();
    // the rate terms' f32 sum in K4's order, one warp a block: lane l adds
    // samples l, l + 32, ... in raster order, then K4's shuffle tree
    const int lane = threadIdx.x & 31;
    for (int bi = threadIdx.x >> 5; bi < nb; bi += kThreads / 32) {
      const float* tb = reinterpret_cast<const float*>(L + bi * BS);
      float part = 0.f;
#pragma unroll
      for (int i = lane; i < NN; i += 32)
        part = __fadd_rn(part, tb[(i >> LG) * RS + (i & (N - 1))]);
      part = esclog_tree(part);
      if (lane == 0) tot[bi].esclog = part;
    }
    __syncthreads();
    const float w[6] = {w0, w1, w2, w3, w4, w5};
    for (int bi = threadIdx.x; bi < nb; bi += kThreads)
      rate_model(tot[bi], w, dist + b0 + bi, rate + b0 + bi);
  } else {
#pragma unroll
    for (int l = 0; l < N; ++l)
      Wb[r * RS + l] =
          clip16((t[l] + (1 << (inv_shift2 - 1))) >> inv_shift2);
    __syncthreads();
    int4* lo = reinterpret_cast<int4*>(levels + (size_t)b0 * NN);
    int4* ro = reinterpret_cast<int4*>(recon + (size_t)b0 * NN);
    for (int u = threadIdx.x; u < nb * NN / 4; u += kThreads) {
      const int i = 4 * u, bi = i / NN, p = i - bi * NN;
      const int at = bi * BS + (p >> LG) * RS + (p & (N - 1));
      lo[u] = make_int4(L[at], L[at + 1], L[at + 2], L[at + 3]);
      ro[u] = make_int4(W[at], W[at + 1], W[at + 2], W[at + 3]);
    }
  }
}

template <int LG, bool COST>
int launch(const int* res, int* levels, int* recon, float* dist,
           float* rate, int B, int qp, int bit_depth, int dz, const float* w,
           cudaStream_t stream) {
  auto kernel = tq_kernel<LG, COST>;
  constexpr size_t smem = TqPlan<LG>::BYTES;
  // above 48 KB (n = 16, 32) only after the opt-in, which each device
  // holds apart: set on every launch, on the caller's current device
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (B + TqPlan<LG>::BPC - 1) / TqPlan<LG>::BPC;
  kernel<<<grid, kThreads, smem, stream>>>(res, levels, recon, dist, rate, B,
                                           qp, bit_depth, dz, w[0], w[1],
                                           w[2], w[3], w[4], w[5]);
  return (int)cudaGetLastError();
}

template <bool COST>
int dispatch(const int* res, int* levels, int* recon, float* dist,
             float* rate, int B, int lg, int qp, int bit_depth, int dz,
             const float* w, cudaStream_t stream) {
  if (B <= 0) return 0;
  switch (lg) {
    case 2: return launch<2, COST>(res, levels, recon, dist, rate, B, qp,
                                   bit_depth, dz, w, stream);
    case 3: return launch<3, COST>(res, levels, recon, dist, rate, B, qp,
                                   bit_depth, dz, w, stream);
    case 4: return launch<4, COST>(res, levels, recon, dist, rate, B, qp,
                                   bit_depth, dz, w, stream);
    case 5: return launch<5, COST>(res, levels, recon, dist, rate, B, qp,
                                   bit_depth, dz, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// res, levels, recon: [B][n][n] int32, 16-byte aligned; n = 2^lg, lg 2..5
extern "C" int fhv_tq_roundtrip(const int* res, int* levels, int* recon,
                                int B, int lg, int qp, int bit_depth, int dz,
                                cudaStream_t stream) {
  const float w[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  return dispatch<false>(res, levels, recon, nullptr, nullptr, B, lg, qp,
                         bit_depth, dz, w, stream);
}

// res [B][n][n] int32 (16-byte aligned) -> dist [B], rate [B] f32; w0..w5
// the rate model's weights for n (ops/cost.py _RATE_W)
extern "C" int fhv_tq_cost(const int* res, float* dist, float* rate, int B,
                           int lg, int qp, int bit_depth, int dz, float w0,
                           float w1, float w2, float w3, float w4, float w5,
                           cudaStream_t stream) {
  const float w[6] = {w0, w1, w2, w3, w4, w5};
  return dispatch<true>(res, nullptr, nullptr, dist, rate, B, lg, qp,
                        bit_depth, dz, w, stream);
}
