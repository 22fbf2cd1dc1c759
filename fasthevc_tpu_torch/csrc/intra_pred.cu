// K1: HEVC intra prediction for B blocks x M modes (spec 8.4.4.2).
//
// Replaces fasthevc_tpu/ops/intra.py predict_all_modes (:171) and
// predict_selected (:239).  Planar, DC with the luma edge filters for n<32,
// the 33 angular modes with the inverse-angle reference extension, the
// [1 2 1] reference smoothing chosen per mode (spec.intra.should_filter),
// and the mode 10/26 boundary filters (the per-sample formula is shared
// with K5 through intra_common.cuh).
//
// Bound on the H100: device-memory writes.  The output [B, M, n, n] int32
// is 35 * n^2 * 4 bytes per block (292 MB per 1080p frame at every n)
// from 2 * (2n+1) reference samples read, so the kernel is a store stream.
// Design: one CTA of 256 threads per group of blocks (enough blocks that
// the CTA has >= 256 samples to write); the blocks' references, filtered
// references and DC values live in shared memory, and every thread
// computes its samples with the spec's integer formula, consecutive
// threads writing consecutive samples (coalesced stores).  The JAX
// package's dense f32 reference-to-prediction matrix is a TPU matrix-unit
// workaround and is not carried over.
//
// The fused form (fhv_intra_satd) replaces predict_all_modes followed by
// satd as the intra search composes them (fasthevc_tpu/codec/search.py:
// 163-166, satd(src[:, None] - predict_all_modes(...))): it returns the
// [B, 35] SATDs and no prediction reaches device memory.  Its bound is the
// integer work (about 15 operations a predicted sample); the bytes are the
// references, the source and [B, 35].  Design: a warp holds the 35 modes of
// 32 / S blocks, one lane per (block, hb x hb sub-block), S = (n / hb)^2;
// warp w runs modes w, w + 7, ... so that a mode, and every branch on it,
// is uniform across the warp.  A lane predicts its sub-block into
// registers with the per-row terms of the angular formula hoisted, forms
// the residual against the source in shared memory and runs K2's
// transform (satd_common.cuh) there; the S lanes of a block sum with
// shuffles, and the CTA writes its [P, 35] costs in one coalesced pass.
//
// The rd form (fhv_intra_rd_cands) replaces the intra search's RD
// shortlist (fasthevc_tpu/codec/search.py:170-185: cost_rmd, jax.lax.top_k,
// the one-hot gather of the candidates' predictions and src - cands) and,
// given the modes, the chroma DM residual (predict_selected, ops/intra.py:
// 239, then the subtract, search.py:209-212).  From the fused form's SATDs
// d [B, 35] and the MPM mode bits it ranks the 35 costs fma(ls, bits,
// float(d)) (one rounding, as XLA contracts the reference's expression),
// takes the K least, lower mode first among equal costs (top_k's order),
// and writes each candidate's residual src - prediction [B, K, n, n], its
// mode and bits; no prediction reaches device memory.  It took the place
// of the selected form (fhv_intra_pred with modes), a stable sort, a
// gather and the subtract in PyTorch; the selected form stays callable.
// Bound on the H100: bytes (per block the references, the source, d, the
// bits, the K residuals, modes and bits: 1.46 kB at n = 8, K = 3).  The
// selected form spent a CTA of 256 threads on one block at n = 8 (64 idle),
// every CTA smoothed all four reference arrays and took DC behind two
// barriers, and every sample paid two integer divisions and a global load
// of its mode.  Design: a warp per block (two blocks at n = 4; a warp per
// block rather than per candidate, so that the selection runs once and
// the K candidates share the warp's references), so that a mode, and
// every branch on it, is uniform across the warp, and the kernel
// needs no barrier but the one after the mode table: the warp loads its
// references into its own shared slot, each lane keeps its source samples
// in registers, and the warp selects the K least (cost, mode) keys by
// repeated shuffle minima over its lanes (a lane holds 2-3 of the 35), one
// candidate at a time, predicting each as soon as it is chosen.  The
// smoothed references and DC are made by the warp the first time a chosen
// mode needs them.  A lane's column is fixed (n divides 32), so the
// angular terms of a horizontal mode are hoisted out of its samples; a
// vertical mode's are a multiply and two bit operations a row.  The
// residual rows go out coalesced, 32 consecutive samples a store.

#include <cuda_runtime.h>

#include "intra_common.cuh"
#include "satd_common.cuh"

namespace {

constexpr int kThreads = 256;

// Loads the references of blocks [b0, b0 + nb) into refs (each block
// [t | l | tf | lf | dc], stride 4L + 1), with the [1 2 1] smoothed copies
// and the DC value.  The caller synchronises after it.
__device__ __forceinline__ void load_refs(const int* __restrict__ top,
                                          const int* __restrict__ left,
                                          int* refs, int b0, int nb, int n,
                                          int lg, int stride) {
  const int L = 2 * n + 1;
  for (int i = threadIdx.x; i < nb * L; i += blockDim.x) {
    const int j = i / L, k = i - j * L;
    refs[j * stride + k] = top[(size_t)(b0 + j) * L + k];
    refs[j * stride + L + k] = left[(size_t)(b0 + j) * L + k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * L; i += blockDim.x) {
    const int j = i / L, k = i - j * L;
    const int* t = refs + j * stride;
    const int* l = t + L;
    intra_filter_ref(t, l, k, L, &refs[j * stride + 2 * L + k],
                     &refs[j * stride + 3 * L + k]);
    if (k == 0) refs[j * stride + 4 * L] = intra_dc(t, l, n, lg);
  }
}

// mode_tab: [3][35] int32 = angle, inverse angle, use-filtered-refs flag.
__global__ void intra_pred_kernel(const int* __restrict__ top,
                                  const int* __restrict__ left,
                                  const int* __restrict__ modes,
                                  const int* __restrict__ mode_tab,
                                  int* __restrict__ out, int B, int n, int lg,
                                  int M, int edge, int max_val, int bpc) {
  extern __shared__ int sm[];
  const int L = 2 * n + 1;
  const int stride = 4 * L + 1;  // top, left, top_f, left_f, dc
  int* tab = sm;                 // 3 * 35
  int* refs = sm + 3 * 35;
  const int b0 = blockIdx.x * bpc;
  const int nb = min(bpc, B - b0);

  for (int i = threadIdx.x; i < 3 * 35; i += blockDim.x) tab[i] = mode_tab[i];
  load_refs(top, left, refs, b0, nb, n, lg, stride);
  __syncthreads();

  const int nn = n * n;
  const int per = M * nn;
  for (int i = threadIdx.x; i < nb * per; i += blockDim.x) {
    const int j = i / per;
    const int r = i - j * per;
    const int mi = r / nn;
    const int p = r - mi * nn;
    const int y = p >> lg, x = p & (n - 1);
    const int b = b0 + j;
    const int mode = modes ? modes[(size_t)b * M + mi] : mi;
    const int* t = refs + j * stride;
    const int* l = t + L;
    const bool filt = tab[70 + mode] != 0;
    const int v = intra_sample(mode, x, y, n, lg, t, l, filt ? t + 2 * L : t,
                               filt ? t + 3 * L : l, t[4 * L], tab[mode],
                               tab[35 + mode], edge, max_val);
    out[(size_t)b * per + r] = v;
  }
}

// The angular samples of the HB x HB sub-block at (x0, y0) into d (row
// major): intra_sample's arithmetic with the per-row terms hoisted.  V:
// a vertical mode (>= 18); a horizontal one is its transpose.
template <int HB, bool V>
__device__ __forceinline__ void angular_sub(int x0, int y0, int n,
                                            const int* main_ref,
                                            const int* side_ref, int angle,
                                            int inv, int* d) {
  const int a0 = V ? y0 : x0;  // along the prediction direction
  const int c0 = V ? x0 : y0;  // across it
#pragma unroll
  for (int i = 0; i < HB; ++i) {
    const int pos = (a0 + i + 1) * angle;
    const int idx = pos >> 5, fact = pos & 31;
#pragma unroll
    for (int k = 0; k < HB; ++k) {
      const int ka = c0 + k + idx + 1;
      const int kb = min(ka + 1, 2 * n);
      const int a = ka >= 0 ? main_ref[ka] : side_ref[(ka * inv + 128) >> 8];
      const int c = kb >= 0 ? main_ref[kb] : side_ref[(kb * inv + 128) >> 8];
      const int v = ((32 - fact) * a + fact * c + 16) >> 5;
      if (V)
        d[i * HB + k] = v;
      else
        d[k * HB + i] = v;
    }
  }
}

// The prediction of mode `mode` on the HB x HB sub-block at (x0, y0) into d,
// sample for sample intra_sample's.
template <int HB>
__device__ __forceinline__ void predict_sub(int mode, int x0, int y0, int n,
                                            int lg, const int* t,
                                            const int* l, const int* ft,
                                            const int* fl, int dc, int angle,
                                            int inv, int edge, int max_val,
                                            int* d) {
  if (mode == 0) {
#pragma unroll
    for (int r = 0; r < HB; ++r)
#pragma unroll
      for (int c = 0; c < HB; ++c) {
        const int x = x0 + c, y = y0 + r;
        d[r * HB + c] = ((n - 1 - x) * fl[1 + y] + (x + 1) * ft[n + 1] +
                         (n - 1 - y) * ft[1 + x] + (y + 1) * fl[n + 1] + n) >>
                        (lg + 1);
      }
  } else if (mode == 1) {
#pragma unroll
    for (int r = 0; r < HB; ++r)
#pragma unroll
      for (int c = 0; c < HB; ++c) {
        const int x = x0 + c, y = y0 + r;
        int v = dc;
        if (edge) {
          if (x == 0 && y == 0)
            v = (l[1] + 2 * dc + t[1] + 2) >> 2;
          else if (y == 0)
            v = (t[1 + x] + 3 * dc + 2) >> 2;
          else if (x == 0)
            v = (l[1 + y] + 3 * dc + 2) >> 2;
        }
        d[r * HB + c] = v;
      }
  } else if (mode >= 18) {
    angular_sub<HB, true>(x0, y0, n, ft, fl, angle, inv, d);
    if (edge && mode == 26 && x0 == 0)
#pragma unroll
      for (int r = 0; r < HB; ++r)
        d[r * HB] =
            min(max(t[1] + ((l[1 + y0 + r] - l[0]) >> 1), 0), max_val);
  } else {
    angular_sub<HB, false>(x0, y0, n, fl, ft, angle, inv, d);
    if (edge && mode == 10 && y0 == 0)
#pragma unroll
      for (int c = 0; c < HB; ++c)
        d[c] = min(max(l[1] + ((t[1 + x0 + c] - t[0]) >> 1), 0), max_val);
  }
}

constexpr int kSatdWarps = 7;  // 35 modes = 5 rounds of 7 warps

template <int HB>
__global__ void __launch_bounds__(kSatdWarps * 32)
    intra_satd_kernel(const int* __restrict__ top,
                      const int* __restrict__ left,
                      const int* __restrict__ src,
                      const int* __restrict__ mode_tab, int* __restrict__ out,
                      int B, int n, int lg, int edge, int max_val) {
  extern __shared__ int sm[];
  const int nbx = n / HB, S = nbx * nbx, P = 32 / S;
  const int L = 2 * n + 1;
  const int stride = 4 * L + 1;     // odd: blocks in different banks
  const int sstride = n * n + 1;
  int* tab = sm;                    // 3 * 35
  int* refs = tab + 3 * 35;         // P blocks
  int* srcs = refs + P * stride;    // P blocks, stride sstride
  int* outs = srcs + P * sstride;   // [P, 35]
  const int b0 = blockIdx.x * P;
  const int nb = min(P, B - b0);

  for (int i = threadIdx.x; i < 3 * 35; i += blockDim.x) tab[i] = mode_tab[i];
  // blocks past the end predict zeros from zeros and write nothing
  for (int i = threadIdx.x; i < P * stride; i += blockDim.x) refs[i] = 0;
  for (int i = threadIdx.x; i < P * n * n; i += blockDim.x) {
    const int j = i / (n * n), p = i - j * (n * n);
    srcs[j * sstride + p] = j < nb ? src[(size_t)b0 * n * n + i] : 0;
  }
  __syncthreads();
  load_refs(top, left, refs, b0, nb, n, lg, stride);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = lane / S, s = lane - j * S;
  const int x0 = (s % nbx) * HB, y0 = (s / nbx) * HB;
  const int* t = refs + j * stride;
  const int* l = t + L;
  const int* sp = srcs + j * sstride + y0 * n + x0;
  for (int mode = warp; mode < 35; mode += kSatdWarps) {
    const bool filt = tab[70 + mode] != 0;
    int d[HB * HB];
    predict_sub<HB>(mode, x0, y0, n, lg, t, l, filt ? t + 2 * L : t,
                    filt ? t + 3 * L : l, t[4 * L], tab[mode], tab[35 + mode],
                    edge, max_val, d);
#pragma unroll
    for (int r = 0; r < HB; ++r)
#pragma unroll
      for (int c = 0; c < HB; ++c)
        d[r * HB + c] = sp[r * n + c] - d[r * HB + c];
    int v = satd_subblock<HB>(d);
    for (int o = 1; o < S; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (s == 0) outs[j * 35 + mode] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * 35; i += blockDim.x)
    out[(size_t)b0 * 35 + i] = outs[i];
}


// ---------------------------------------------------------------------------
// The rd form: the RD shortlist's residuals

constexpr int kRdWarps = 8;

template <int PN>
struct RdCfg {
  static constexpr int LG = PN == 4 ? 2 : PN == 8 ? 3 : PN == 16 ? 4 : 5;
  static constexpr int NN = PN * PN;
  static constexpr int WB = NN >= 32 ? 1 : 32 / NN;  // blocks a warp
  static constexpr int SEG = 32 / WB;                 // lanes a block
  static constexpr int SPL = NN >= 32 ? NN / 32 : 1;  // samples a lane
  static constexpr int KPL = (35 + SEG - 1) / SEG;    // modes a lane ranks
  static constexpr int L = 2 * PN + 1;
  static constexpr int STRIDE = 4 * L + 1;  // t, l, tf, lf (odd: banks)
};

// A rank key of a cost and its mode: the costs are fma(ls, bits, satd) >=
// +0 (never -0, never NaN), whose IEEE bits order as unsigned integers,
// and the mode in the low word puts the lower mode first among equal
// costs.
__device__ __forceinline__ unsigned long long rd_key(float cost, int mode) {
  return ((unsigned long long)__float_as_uint(cost) << 32) | (unsigned)mode;
}

__device__ __forceinline__ unsigned long long key_min(unsigned long long a,
                                                      unsigned long long b) {
  return b < a ? b : a;
}

// satd/mode_bits [B, 35] with top_idx/cand_bits [B, K] out (the luma
// shortlist), or modes [B, K] in (satd == nullptr); res [B, K, PN, PN].
template <int PN>
__global__ void __launch_bounds__(kRdWarps * 32)
    intra_rd_cands_kernel(const int* __restrict__ top,
                          const int* __restrict__ left,
                          const int* __restrict__ src,
                          const int* __restrict__ satd,
                          const float* __restrict__ mode_bits,
                          const int* __restrict__ modes,
                          const int* __restrict__ mode_tab,
                          int* __restrict__ top_idx,
                          float* __restrict__ cand_bits,
                          int* __restrict__ res, int B, int K, float ls,
                          int edge, int max_val) {
  using C = RdCfg<PN>;
  constexpr unsigned kFull = 0xffffffffu;
  constexpr unsigned long long kTaken = ~0ull;
  __shared__ int tab[3 * 35];
  __shared__ int refs[kRdWarps][C::WB][C::STRIDE];
  for (int i = threadIdx.x; i < 3 * 35; i += blockDim.x) tab[i] = mode_tab[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = lane / C::SEG, sl = lane - j * C::SEG;
  const int bj = (blockIdx.x * kRdWarps + warp) * C::WB + j;
  const bool live = bj < B;
  const int b = live ? bj : B - 1;  // past the end: computed, not written
  int* t = refs[warp][j];
  int* l = t + C::L;
  int* tf = t + 2 * C::L;
  int* lf = t + 3 * C::L;
  for (int k = sl; k < C::L; k += C::SEG) {
    t[k] = top[(size_t)b * C::L + k];
    l[k] = left[(size_t)b * C::L + k];
  }
  int sv[C::SPL];
#pragma unroll
  for (int i = 0; i < C::SPL; ++i)
    sv[i] = src[(size_t)b * C::NN + sl + i * C::SEG];
  unsigned long long key[C::KPL];
  if (satd != nullptr) {
#pragma unroll
    for (int q = 0; q < C::KPL; ++q) {
      const int m = sl + q * C::SEG;
      key[q] = m < 35 ? rd_key(__fmaf_rn(ls, mode_bits[(size_t)b * 35 + m],
                                         __int2float_rn(satd[(size_t)b * 35 +
                                                             m])),
                               m)
                      : kTaken;
    }
  }
  __syncwarp();
  // a lane's column; its rows are sl / PN + i * (32 / PN)
  const int x = sl & (PN - 1);
  bool have_f = false, have_dc = false;
  int dc = 0;
  for (int c = 0; c < K; ++c) {
    int mode;
    if (satd != nullptr) {
      unsigned long long best = key[0];
#pragma unroll
      for (int q = 1; q < C::KPL; ++q) best = key_min(best, key[q]);
#pragma unroll
      for (int o = C::SEG / 2; o > 0; o >>= 1)
        best = key_min(best, __shfl_xor_sync(kFull, best, o));
#pragma unroll
      for (int q = 0; q < C::KPL; ++q)
        if (key[q] == best) key[q] = kTaken;
      mode = (int)(best & 0xffffffffu);
      if (live && sl == 0) {
        top_idx[(size_t)b * K + c] = mode;
        cand_bits[(size_t)b * K + c] = mode_bits[(size_t)b * 35 + mode];
      }
    } else {
      mode = modes[(size_t)b * K + c];
    }
    const bool filt = tab[70 + mode] != 0;
    if (!have_f && __any_sync(kFull, filt)) {
      for (int k = sl; k < C::L; k += C::SEG)
        intra_filter_ref(t, l, k, C::L, &tf[k], &lf[k]);
      __syncwarp();
      have_f = true;
    }
    if (!have_dc && __any_sync(kFull, mode == 1)) {
      int sum = 0;
      for (int k = sl; k < PN; k += C::SEG) sum += t[1 + k] + l[1 + k];
#pragma unroll
      for (int o = C::SEG / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      dc = (sum + PN) >> (C::LG + 1);
      have_dc = true;
    }
    const int* ft = filt ? tf : t;
    const int* fl = filt ? lf : l;
    const int angle = tab[mode], inv = tab[35 + mode];
    const bool vert = mode >= 18;
    const int* mref = vert ? ft : fl;
    const int* sref = vert ? fl : ft;
    // a horizontal mode's position along the direction is the column
    const int hpos = (x + 1) * angle;
    int* out = res + ((size_t)b * K + c) * C::NN;
#pragma unroll
    for (int i = 0; i < C::SPL; ++i) {
      const int s = sl + i * C::SEG;
      const int y = s >> C::LG;
      int v;
      if (mode == 0) {
        v = ((PN - 1 - x) * fl[1 + y] + (x + 1) * ft[PN + 1] +
             (PN - 1 - y) * ft[1 + x] + (y + 1) * fl[PN + 1] + PN) >>
            (C::LG + 1);
      } else if (mode == 1) {
        v = dc;
        if (edge) {
          if (x == 0 && y == 0)
            v = (l[1] + 2 * dc + t[1] + 2) >> 2;
          else if (y == 0)
            v = (t[1 + x] + 3 * dc + 2) >> 2;
          else if (x == 0)
            v = (l[1 + y] + 3 * dc + 2) >> 2;
        }
      } else {
        const int pos = vert ? (y + 1) * angle : hpos;
        const int idx = pos >> 5, fact = pos & 31;
        const int ka = (vert ? x : y) + idx + 1;
        const int kb = min(ka + 1, 2 * PN);
        const int a = ka >= 0 ? mref[ka] : sref[(ka * inv + 128) >> 8];
        const int e = kb >= 0 ? mref[kb] : sref[(kb * inv + 128) >> 8];
        v = ((32 - fact) * a + fact * e + 16) >> 5;
        if (edge && mode == 26 && x == 0)
          v = min(max(t[1] + ((l[1 + y] - l[0]) >> 1), 0), max_val);
        if (edge && mode == 10 && y == 0)
          v = min(max(l[1] + ((t[1 + x] - t[0]) >> 1), 0), max_val);
      }
      if (live) out[s] = sv[i] - v;
    }
  }
}

template <int PN>
int launch_rd(const int* top, const int* left, const int* src,
              const int* satd, const float* mode_bits, const int* modes,
              const int* mode_tab, int* top_idx, float* cand_bits, int* res,
              int B, int K, float ls, int edge, int max_val,
              cudaStream_t stream) {
  using C = RdCfg<PN>;
  const int warps = (B + C::WB - 1) / C::WB;
  const int grid = (warps + kRdWarps - 1) / kRdWarps;
  intra_rd_cands_kernel<PN><<<grid, kRdWarps * 32, 0, stream>>>(
      top, left, src, satd, mode_bits, modes, mode_tab, top_idx, cand_bits,
      res, B, K, ls, edge, max_val);
  return (int)cudaGetLastError();
}

}  // namespace

// src [B, n, n], top/left [B, 2n + 1], mode_tab [3, 35] (luma); out [B, 35]
// int32 SATD of src - prediction for every mode; n in 4..32.
extern "C" int fhv_intra_satd(const int* top, const int* left, const int* src,
                              const int* mode_tab, int* out, int B, int n,
                              int lg, int edge, int max_val,
                              cudaStream_t stream) {
  if (B <= 0) return 0;
  if (n < 4 || n > 32 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  const int hb = n < 8 ? n : 8;
  const int S = (n / hb) * (n / hb), P = 32 / S;
  const size_t smem =
      sizeof(int) * (3 * 35 + P * (4 * (2 * n + 1) + 1) + P * (n * n + 1) +
                     P * 35);
  const int grid = (B + P - 1) / P;
  if (hb == 8)
    intra_satd_kernel<8><<<grid, kSatdWarps * 32, smem, stream>>>(
        top, left, src, mode_tab, out, B, n, lg, edge, max_val);
  else
    intra_satd_kernel<4><<<grid, kSatdWarps * 32, smem, stream>>>(
        top, left, src, mode_tab, out, B, n, lg, edge, max_val);
  return (int)cudaGetLastError();
}

extern "C" int fhv_intra_pred(const int* top, const int* left,
                              const int* modes, const int* mode_tab, int* out,
                              int B, int n, int lg, int M, int edge,
                              int max_val, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int per = M * n * n;
  const int bpc = per >= kThreads ? 1 : kThreads / per;
  const int grid = (B + bpc - 1) / bpc;
  const size_t smem = sizeof(int) * (3 * 35 + bpc * (4 * (2 * n + 1) + 1));
  intra_pred_kernel<<<grid, kThreads, smem, stream>>>(
      top, left, modes, mode_tab, out, B, n, lg, M, edge, max_val, bpc);
  return (int)cudaGetLastError();
}

// top/left [B, 2n + 1], src [B, n, n], mode_tab [3, 35]; either satd and
// mode_bits [B, 35] (the luma shortlist: top_idx [B, K] int32 and
// cand_bits [B, K] f32 out, the K least fma(ls, bits, float(satd)), lower
// mode first among equal costs) or modes [B, K] (satd, mode_bits, top_idx
// and cand_bits NULL); res [B, K, n, n] int32 src - prediction; n in 4..32,
// K in 1..35.
extern "C" int fhv_intra_rd_cands(const int* top, const int* left,
                                  const int* src, const int* satd,
                                  const float* mode_bits, const int* modes,
                                  const int* mode_tab, int* top_idx,
                                  float* cand_bits, int* res, int B, int n,
                                  int K, int edge, int max_val, float ls,
                                  cudaStream_t stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > 35 || (satd == nullptr) == (modes == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (n) {
    case 4:
      return launch_rd<4>(top, left, src, satd, mode_bits, modes, mode_tab,
                          top_idx, cand_bits, res, B, K, ls, edge, max_val,
                          stream);
    case 8:
      return launch_rd<8>(top, left, src, satd, mode_bits, modes, mode_tab,
                          top_idx, cand_bits, res, B, K, ls, edge, max_val,
                          stream);
    case 16:
      return launch_rd<16>(top, left, src, satd, mode_bits, modes, mode_tab,
                           top_idx, cand_bits, res, B, K, ls, edge, max_val,
                           stream);
    case 32:
      return launch_rd<32>(top, left, src, satd, mode_bits, modes, mode_tab,
                           top_idx, cand_bits, res, B, K, ls, edge, max_val,
                           stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
