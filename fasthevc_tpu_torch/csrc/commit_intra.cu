// K5: the wavefront intra commit — exact reconstruction of F frames.
//
// Replaces fasthevc_tpu/ops/commit.py wavefront_commit_intra (:545) and
// _wavefront_commit_impl (:593), with what they run per CU: _tq_recon
// (:416), _sdh_adjust_scan (:353), rdoq_scan (ops/rdoq.py:230),
// predict_selected_mm (ops/intra.py:300) and the exact fwd_transform,
// quantize_mixed, dequantize and inv_transform (ops/transform.py:44,99,
// 120,64).
//
// One launch per anti-diagonal wave (CTUs with cx + 2*cy == wave, whose
// left, top-left, top and top-right neighbours all finished in earlier
// launches); one CTA of 256 threads per (CTU, frame) of the wave.  The CTA
// walks its CU quadtree in the commit order of ops/commit.py _GROUPS and,
// for each CU (luma, then Cb and Cr), in phases separated by barriers:
//   references from the recon planes (earlier CTUs and this CTU's earlier
//   CUs), decoding-order availability with tile bounds and the spec's
//   substitution; the [1 2 1] filter; the selected prediction
//   (intra_common.cuh, shared with K1); the exact transform
//   (tq_common.cuh, shared with K3); dead-zone quantisation or the
//   parallel RDOQ trellis; sign-data hiding in scan order; dequantisation,
//   inverse transform and clip, written straight into the output planes.
// The trellis runs in f32 with round-to-nearest intrinsics in the
// reference's order (its sums left to right, its cumulative sum as XLA's
// blocked scan, first index on ties), so it matches the PyTorch twin and
// the JAX reference bit for bit.
//
// Bound on the H100: latency.  A wave holds at most ~34 CTUs per frame,
// and each CTA runs a chain of dependent CU steps (up to 16 luma and 32
// chroma blocks, ~20 barriers each) on one SM; the wave count (126 at
// 1080p) is the critical path, and the frame batch fills the card.  This
// first version keeps every intermediate of a CU in shared memory and is
// written for correctness, not for speed.
//
// The JAX package's boundary buffers, one-hot matmuls and reassembly
// (commit.py:16-39, 294-334, 655-698, 779-794) are TPU workarounds and
// are not carried over: the kernel reads its references from the recon
// planes it writes.

#include <cuda_runtime.h>

#include "intra_common.cuh"
#include "tq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCtu = 32;
constexpr int kMaxNN = 1024;
constexpr int kMaxRef = 4 * 32 + 1;
constexpr int kMaxG = kMaxNN / 16;

// per (c_idx, lg) row of the trellis' meta table (ops/commit.py RD_FIELDS)
enum {
  RD_SIG, RD_LAST, RD_G1, RD_G2, RD_CSB, RD_NBR, RD_QBITS, RD_QSCALE,
  RD_ERRSCALE, RD_NSCANS, RD_STEP, RD_NFIELDS
};

// misc slots
enum { M_FIRST, M_DC, M_LAST_INIT, M_OLD_LAST, M_NEW_LAST, M_NMISC };

struct Args {
  const int* src[3];
  int* rec[3];
  short* lv[3];
  const int* depth;
  const int* mode;
  const int* dct;       // n = 4, 8, 16, 32 at offsets 0, 16, 80, 336
  const int* scans;     // [4 (lg 2..5)][3][1024] raster index per scan pos
  const int* mode_tab;  // [5][35]: angle, inverse, filter flag n=8,16,32
  const int* tiles;     // ntx inner column bounds, then nty row bounds
  int ntx, nty;
  const float* ftab;    // trellis tables (f32 blob)
  const int* itab;      // trellis tables (int blob)
  const int* meta;      // [2][6][RD_NFIELDS]
  float lam;
  int ph, pw, coded_w, coded_h, nctux, wave, cy0;
  int qp_y, qp_c, sdh, rdoq, bit_depth;
};

struct Smem {
  int dct[1360];
  int mtab[5 * 35];
  int dm[16], mm[16];
  int raw[kMaxRef];
  int avail[kMaxRef];
  int top[2 * kCtu + 1], left[2 * kCtu + 1];
  int topf[2 * kCtu + 1], leftf[2 * kCtu + 1];
  int misc[M_NMISC];
  int pred[kMaxNN], bufa[kMaxNN], bufb[kMaxNN], coef[kMaxNN], lev[kMaxNN];
  // the trellis, in scan order
  int ld[kMaxNN], m[kMaxNN], lvl[kMaxNN], sched[kMaxNN];
  float d0[kMaxNN], s1[kMaxNN], clv[kMaxNN], incl[kMaxNN];
  int cg_gt1[kMaxG], cg_nz[kMaxG], cg_set[kMaxG], cg_rb[kMaxG];
  float tot1[kMaxG], tot2[4];
  float redv[kThreads];
  int redi[kThreads];
};

__device__ __forceinline__ int zorder(int u, int v) {
  return (u & 1) | ((v & 1) << 1) | ((u & 2) << 1) | ((v & 2) << 2);
}

__device__ __forceinline__ int tile_of(int c, const int* bounds, int nb) {
  int t = 0;
  for (int i = 0; i < nb; ++i) t += c >= bounds[i];
  return t;
}

__device__ __forceinline__ int dct_offset(int lg) {
  return lg == 2 ? 0 : (lg == 3 ? 16 : (lg == 4 ? 80 : 336));
}

// mode-dependent scan (spec.residual.intra_scan_idx): 0 diag, 1 hor, 2 ver
__device__ __forceinline__ int scan_select(int lg, int c_idx, int mode) {
  if (lg == 2 || (lg == 3 && c_idx == 0)) {
    if (mode >= 6 && mode <= 14) return 2;
    if (mode >= 22 && mode <= 30) return 1;
  }
  return 0;
}

// coeff_abs_level_remaining bit count (9.3.3.9)
__device__ __forceinline__ float rem_bits(int v, int rice) {
  v = max(v, 0);
  const int thresh = 3 << rice;
  if (v < thresh) return (float)((v >> rice) + 1 + rice);
  const int u = max(v - thresh, 0);
  const int k = 31 - __clz((u >> rice) + 1);
  return (float)(4 + 2 * k + rice);
}

// the trellis' cost of coding level l > 0 at a position (rdoq.py:336-348)
__device__ __forceinline__ float level_cost(int l, float ldf, float step,
                                            float err_scale, float lam,
                                            int k, int gt2, int rice,
                                            float g1_0, float g1_1,
                                            float g2_0, float g2_1,
                                            float s1) {
  const float e = __fsub_rn(ldf, __fmul_rn((float)l, step));
  const float d = __fmul_rn(__fmul_rn(e, e), err_scale);
  const float rem1 = __fmul_rn(lam, rem_bits(l - 1, rice));
  const float rem2 = __fmul_rn(lam, rem_bits(l - 2, rice));
  const float rem3 = __fmul_rn(lam, rem_bits(l - 3, rice));
  const float r_gt1 = __fadd_rn(
      g1_1, gt2 ? (l > 2 ? __fadd_rn(g2_1, rem3) : g2_0) : rem2);
  const float r_ctx = l > 1 ? r_gt1 : g1_0;
  const float r = __fadd_rn(lam, k < 8 ? r_ctx : rem1);
  return __fadd_rn(__fadd_rn(d, s1), r);
}

// Block-wide first-index argmin of S.redv/S.redi partials (one per thread)
__device__ void argmin_reduce(Smem& S) {
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) {
      const float v = S.redv[threadIdx.x + s];
      const int i = S.redi[threadIdx.x + s];
      if (v < S.redv[threadIdx.x] ||
          (v == S.redv[threadIdx.x] && i < S.redi[threadIdx.x])) {
        S.redv[threadIdx.x] = v;
        S.redi[threadIdx.x] = i;
      }
    }
    __syncthreads();
  }
}

// The parallel trellis (rdoq.py:230) of the coefficients S.coef (raster);
// writes signed levels into S.lev (raster).  scan: raster index per scan
// position of the block's scan.
__device__ void rdoq_block(Smem& S, const Args& a, int c_idx, int lg,
                           int sel, const int* scan) {
  const int tid = threadIdx.x;
  const int nn = 1 << (2 * lg);
  const int g = nn >> 4;
  const int* row = a.meta + (c_idx * 6 + lg) * RD_NFIELDS;
  const int s = row[RD_NSCANS] > 1 ? sel : 0;
  const float* sig = a.ftab + row[RD_SIG];   // [S][2][2][nn][2]
  const float* last = a.ftab + row[RD_LAST] + s * nn;
  const float* g1 = a.ftab + row[RD_G1];     // [set][c1][bin]
  const float* g2 = a.ftab + row[RD_G2];     // [set][bin]
  const float* csb = a.ftab + row[RD_CSB];   // [ctx][bin]
  const float err_scale = a.ftab[row[RD_ERRSCALE]];
  const int* nbr = a.itab + row[RD_NBR] + s * 2 * g;  // [right|below][g]
  const int qbits = row[RD_QBITS];
  const int q_scale = row[RD_QSCALE];
  const int n_sets = c_idx == 0 ? 4 : 2;
  const float lam = a.lam;
  // the reference's quantiser step: XLA's exp2(qbits), not always exact
  const float step = a.ftab[row[RD_STEP]];

  // R1: provisional levels and the zero-level distortion
  if (tid == 0) {
    S.misc[M_LAST_INIT] = -1;
    S.misc[M_OLD_LAST] = -1;
  }
  for (int p = tid; p < nn; p += blockDim.x) {
    const int c = S.coef[scan[p]];
    const int ld = (c < 0 ? -c : c) * q_scale;  // < 2^31
    S.ld[p] = ld;
    S.m[p] = min((ld + (1 << (qbits - 1))) >> qbits, 32767);
    const float ldf = (float)ld;
    S.d0[p] = __fmul_rn(__fmul_rn(ldf, ldf), err_scale);
  }
  __syncthreads();
  // R2: closed-form context schedule per CG, over the positions coded
  // before each slot (higher scan index)
  for (int gi = tid; gi < g; gi += blockDim.x) {
    int n_nz = 0, n_gt1 = 0, n_eq1 = 0, n_gt1k8 = 0, run_max = 0;
    for (int i = 15; i >= 0; --i) {
      const int p = 16 * gi + i;
      const int k = n_nz;
      const int c1 = n_gt1 > 0 ? 0 : min(1 + n_eq1, 3);
      const int gt2 = n_gt1k8 == 0;
      const int rice = min(max(31 - __clz(max(run_max, 1)) - 1, 0), 4);
      S.sched[p] = k | (c1 << 5) | (gt2 << 7) | (rice << 8);
      const int mv = S.m[p];
      n_nz += mv > 0;
      n_gt1 += mv > 1;
      n_eq1 += mv == 1;
      n_gt1k8 += (mv > 1) && (k < 8);
      run_max = max(run_max, mv);
    }
    S.cg_gt1[gi] = n_gt1 > 0;
    S.cg_nz[gi] = n_nz > 0;
  }
  __syncthreads();
  // R3: per-CG context set and csbf neighbours
  for (int gi = tid; gi < g; gi += blockDim.x) {
    const int prev = gi + 1 < g ? S.cg_gt1[gi + 1] : 0;
    int cs = (c_idx == 0 && g > 1) ? 2 * (gi > 0) + prev : prev;
    S.cg_set[gi] = min(max(cs, 0), n_sets - 1);
    const int r = nbr[gi] >= 0 ? S.cg_nz[nbr[gi]] : 0;
    const int b = nbr[g + gi] >= 0 ? S.cg_nz[nbr[g + gi]] : 0;
    S.cg_rb[gi] = r | (b << 1);
  }
  __syncthreads();
  // R4: per-coefficient level choice among {0, m, m-1}
  for (int p = tid; p < nn; p += blockDim.x) {
    const int gi = p >> 4;
    const int cs = S.cg_set[gi];
    const float rf = (S.cg_rb[gi] & 1) ? 1.f : 0.f;
    const float bf = (S.cg_rb[gi] & 2) ? 1.f : 0.f;
    float sc[2];
    for (int bin = 0; bin < 2; ++bin) {
      const float* sg = sig + (size_t)s * 4 * nn * 2 + p * 2 + bin;
      const float t00 = sg[0], t01 = sg[nn * 2];
      const float t10 = sg[2 * nn * 2], t11 = sg[3 * nn * 2];
      float v = __fadd_rn(t00, __fmul_rn(rf, __fsub_rn(t10, t00)));
      v = __fadd_rn(v, __fmul_rn(bf, __fsub_rn(t01, t00)));
      v = __fadd_rn(v, __fmul_rn(__fmul_rn(rf, bf),
                                 __fadd_rn(__fsub_rn(__fsub_rn(t11, t10),
                                                     t01), t00)));
      sc[bin] = v;
    }
    const int sched = S.sched[p];
    const int k = sched & 31, c1 = (sched >> 5) & 3;
    const int gt2 = (sched >> 7) & 1, rice = (sched >> 8) & 7;
    const float g1_0 = g1[(cs * 4 + c1) * 2], g1_1 = g1[(cs * 4 + c1) * 2 + 1];
    const float g2_0 = g2[cs * 2], g2_1 = g2[cs * 2 + 1];
    const int m = S.m[p];
    const float ldf = (float)S.ld[p];
    const float cost0 = __fadd_rn(S.d0[p], sc[0]);
    const float cost_m =
        m > 0 ? level_cost(max(m, 1), ldf, step, err_scale, lam, k, gt2, rice,
                           g1_0, g1_1, g2_0, g2_1, sc[1])
              : __int_as_float(0x7f800000);
    const int m1 = max(m - 1, 1);
    const float cost_m1 =
        m > 1 ? level_cost(m1, ldf, step, err_scale, lam, k, gt2, rice, g1_0,
                           g1_1, g2_0, g2_1, sc[1])
              : __int_as_float(0x7f800000);
    S.lvl[p] = (cost_m <= cost0 && cost_m <= cost_m1)
                   ? m : (cost_m1 <= cost0 ? m1 : 0);
    S.clv[p] = fminf(cost0, fminf(cost_m, cost_m1));
    S.s1[p] = sc[1];
    if (m > 0) atomicMax(&S.misc[M_LAST_INIT], p);
  }
  __syncthreads();
  // R5: nothing after the provisional last position
  const int last_init = S.misc[M_LAST_INIT];
  for (int p = tid; p < nn; p += blockDim.x) {
    if (p > last_init) {
      S.lvl[p] = 0;
      S.clv[p] = 0.f;
    }
  }
  __syncthreads();
  // R6: coding-group zeroing (not DC, not the provisional last CG)
  if (g > 1) {
    const int last_cg = last_init >> 4;
    for (int gi = tid; gi < g; gi += blockDim.x) {
      float keep = S.clv[16 * gi], zero = 16 * gi <= last_init ? S.d0[16 * gi]
                                                               : 0.f;
      for (int i = 1; i < 16; ++i) {
        const int p = 16 * gi + i;
        keep = __fadd_rn(keep, S.clv[p]);
        zero = __fadd_rn(zero, p <= last_init ? S.d0[p] : 0.f);
      }
      const float rf = (S.cg_rb[gi] & 1) ? 1.f : 0.f;
      const float bf = (S.cg_rb[gi] & 2) ? 1.f : 0.f;
      const float cinc = fminf(__fadd_rn(rf, bf), 1.f);
      const float inv = __fsub_rn(1.f, cinc);
      const float b0 = __fadd_rn(__fmul_rn(inv, csb[0]),
                                 __fmul_rn(cinc, csb[2]));
      const float b1 = __fadd_rn(__fmul_rn(inv, csb[1]),
                                 __fmul_rn(cinc, csb[3]));
      if (gi > 0 && gi < last_cg &&
          __fadd_rn(zero, b0) < __fadd_rn(keep, b1)) {
        for (int i = 0; i < 16; ++i) {
          const int p = 16 * gi + i;
          S.lvl[p] = 0;
          S.clv[p] = p <= last_init ? S.d0[p] : 0.f;
        }
      }
    }
    __syncthreads();
  }
  // R7: the last nonzero level
  for (int p = tid; p < nn; p += blockDim.x)
    if (S.lvl[p] > 0) atomicMax(&S.misc[M_OLD_LAST], p);
  __syncthreads();
  const int old_last = S.misc[M_OLD_LAST];
  // R8: gains of zeroing each position, then their blocked prefix sum
  // (XLA's order: sequential inside blocks of 16, block totals scanned by
  // the same rule)
  for (int p = tid; p < nn; p += blockDim.x) {
    const float cz = p <= last_init ? S.d0[p] : 0.f;
    S.incl[p] = p <= old_last ? __fsub_rn(cz, S.clv[p]) : 0.f;
  }
  __syncthreads();
  for (int b = tid; b < g; b += blockDim.x) {
    float acc = S.incl[16 * b];
    for (int i = 1; i < 16; ++i) {
      acc = __fadd_rn(acc, S.incl[16 * b + i]);
      S.incl[16 * b + i] = acc;
    }
  }
  __syncthreads();
  if (g > 1) {
    if (g <= 16) {
      if (tid == 0) {
        float acc = S.incl[15];
        S.tot1[0] = acc;
        for (int b = 1; b < g; ++b) {
          acc = __fadd_rn(acc, S.incl[16 * b + 15]);
          S.tot1[b] = acc;
        }
      }
    } else {  // g == 64: the 64 totals are themselves scanned in blocks
      for (int c = tid; c < g / 16; c += blockDim.x) {
        float acc = S.incl[16 * (16 * c) + 15];
        S.tot1[16 * c] = acc;
        for (int i = 1; i < 16; ++i) {
          acc = __fadd_rn(acc, S.incl[16 * (16 * c + i) + 15]);
          S.tot1[16 * c + i] = acc;
        }
      }
      __syncthreads();
      if (tid == 0) {
        float acc = S.tot1[15];
        S.tot2[0] = acc;
        for (int c = 1; c < g / 16; ++c) {
          acc = __fadd_rn(acc, S.tot1[16 * c + 15]);
          S.tot2[c] = acc;
        }
      }
      __syncthreads();
      for (int b = tid; b < g; b += blockDim.x)
        if (b >= 16) S.tot1[b] = __fadd_rn(S.tot1[b], S.tot2[(b >> 4) - 1]);
    }
    __syncthreads();
    for (int p = tid; p < nn; p += blockDim.x)
      if (p >= 16) S.incl[p] = __fadd_rn(S.incl[p], S.tot1[(p >> 4) - 1]);
    __syncthreads();
  }
  // R9: the best last position (first index on ties)
  {
    float best = __int_as_float(0x7f800000);
    int best_i = nn;
    const float total_sum = S.incl[nn - 1];
    for (int p = tid; p < nn; p += blockDim.x) {
      float v = __int_as_float(0x7f800000);
      if (S.lvl[p] > 0)
        v = __fsub_rn(__fadd_rn(__fsub_rn(total_sum, S.incl[p]), last[p]),
                      S.s1[p]);
      if (v < best || (v == best && p < best_i)) {
        best = v;
        best_i = p;
      }
    }
    S.redv[tid] = best;
    S.redi[tid] = best_i;
  }
  __syncthreads();
  argmin_reduce(S);
  // all-inf: the reference's argmin returns index 0
  const int new_last = S.redi[0] >= nn ? 0 : S.redi[0];
  // R10: signed levels, raster order
  for (int p = tid; p < nn; p += blockDim.x) {
    const int c = S.coef[scan[p]];
    const int lv = (old_last >= 0 && p <= new_last) ? S.lvl[p] : 0;
    S.lev[scan[p]] = c < 0 ? -lv : (c > 0 ? lv : 0);
  }
  __syncthreads();
}

// Sign-data hiding (commit.py:353) of S.lev against S.coef, both raster,
// visited in scan order: per 16-coefficient group, one thread.
__device__ void sdh_adjust(Smem& S, const int* scan, int nn, int qp, int lg,
                           int bit_depth) {
  const int qbits = 14 + qp / 6 + (15 - bit_depth - lg);
  const int qscale[6] = {26214, 23302, 20560, 18396, 16384, 14564};
  const int scale = qscale[qp % 6];
  for (int gi = threadIdx.x; gi < (nn >> 4); gi += blockDim.x) {
    int lv[16];
    int first = -1, last = -1, sum_abs = 0;
    for (int i = 0; i < 16; ++i) {
      lv[i] = S.lev[scan[16 * gi + i]];
      if (lv[i] != 0) {
        if (first < 0) first = i;
        last = i;
      }
      sum_abs += lv[i] < 0 ? -lv[i] : lv[i];
    }
    if (first < 0) continue;
    const int want = lv[first] < 0;
    if (last - first <= 3 || (sum_abs & 1) == want) continue;
    const int big = -2147483647;
    int best = 0, best_r = 0;
    for (int i = 0; i < 16; ++i) {
      const int la = lv[i] < 0 ? -lv[i] : lv[i];
      const int cf = S.coef[scan[16 * gi + i]];
      const int aa = (cf < 0 ? -cf : cf) * scale;  // < 2^31
      // ((aa >> qbits) - la) << qbits | low bits, in int32 wrapping
      const unsigned hi = (unsigned)((aa >> qbits) - la) << qbits;
      int r = (int)(hi + (unsigned)(aa & ((1 << qbits) - 1)));
      if (la >= 32767 || i < first || i > last) r = big;
      if (i == 0 || r > best_r) {
        best = i;
        best_r = r;
      }
    }
    const int cur = lv[best];
    const int cf = S.coef[scan[16 * gi + best]];
    S.lev[scan[16 * gi + best]] =
        cur > 0 ? cur + 1 : (cur < 0 ? cur - 1 : (cf < 0 ? -1 : 1));
  }
}

// Commit one n x n block of plane p (0 luma, 1 Cb, 2 Cr) at local (lx, ly)
// of CTU (cx, cy), frame f.
__device__ void commit_block(Smem& S, const Args& a, int p, int f, int cx,
                             int cy, int lx, int ly, int n, int lg,
                             int mode) {
  const int tid = threadIdx.x;
  const int sub = p ? 1 : 0;
  const int H = a.ph >> sub, W = a.pw >> sub;
  const int x0 = (cx * kCtu >> sub) + lx, y0 = (cy * kCtu >> sub) + ly;
  const size_t base = (size_t)f * H * W;
  int* rec = a.rec[p] + base;
  const int L = 4 * n + 1;
  const int max_val = (1 << a.bit_depth) - 1;
  const int nn = n * n;
  const int c_idx = p ? 1 : 0;
  const int qp = p ? a.qp_c : a.qp_y;
  // luma position of the block (availability is decided in luma units)
  const int cxl = cx * kCtu + (lx << sub), cyl = cy * kCtu + (ly << sub);
  const int ca = cxl >> 3, cb = cyl >> 3;
  const int ctu_c = (cb >> 2) * a.nctux + (ca >> 2);
  const int z_c = zorder(ca & 3, cb & 3);

  // 1. raw references: bottom-most left .. left top, corner, top row
  for (int i = tid; i < L; i += blockDim.x) {
    int x, y;
    if (i < 2 * n) {
      x = x0 - 1;
      y = y0 + 2 * n - 1 - i;
    } else if (i == 2 * n) {
      x = x0 - 1;
      y = y0 - 1;
    } else {
      x = x0 + (i - 2 * n - 1);
      y = y0 - 1;
    }
    const int px = x * (1 << sub), py = y * (1 << sub);
    bool ok = px >= 0 && py >= 0 && px < a.coded_w && py < a.coded_h;
    if (ok) {
      const int pa = px >> 3, pb = py >> 3;
      const int ctu_p = (pb >> 2) * a.nctux + (pa >> 2);
      ok = ctu_p < ctu_c ||
           (ctu_p == ctu_c && zorder(pa & 3, pb & 3) < z_c);
      if (ok && a.ntx)
        ok = tile_of(px, a.tiles, a.ntx) == tile_of(cxl, a.tiles, a.ntx);
      if (ok && a.nty)
        ok = tile_of(py, a.tiles + a.ntx, a.nty) ==
             tile_of(cyl, a.tiles + a.ntx, a.nty);
    }
    S.avail[i] = ok;
    S.raw[i] = ok ? rec[y * W + x] : 0;
  }
  __syncthreads();
  // 2. substitution (spec 8.4.4.2.2)
  if (tid == 0) {
    int first = -1;
    for (int i = 0; i < L; ++i)
      if (S.avail[i]) {
        first = i;
        break;
      }
    S.misc[M_FIRST] = first;
  }
  __syncthreads();
  for (int i = tid; i < L; i += blockDim.x) {
    const int first = S.misc[M_FIRST];
    int v = 1 << (a.bit_depth - 1);
    if (first >= 0) {
      int j = i;
      while (j >= 0 && !S.avail[j]) --j;
      v = S.raw[j >= 0 ? j : first];
    }
    if (i <= 2 * n) S.left[2 * n - i] = v;
    if (i >= 2 * n) S.top[i - 2 * n] = v;
  }
  __syncthreads();
  // 3. filtered references and DC
  const int Lr = 2 * n + 1;
  const int filt = p == 0 ? S.mtab[(2 + lg - 3) * 35 + mode] : 0;
  if (filt)
    for (int k = tid; k < Lr; k += blockDim.x)
      intra_filter_ref(S.top, S.left, k, Lr, &S.topf[k], &S.leftf[k]);
  if (tid == 0) S.misc[M_DC] = intra_dc(S.top, S.left, n, lg);
  __syncthreads();
  // 4. prediction and residual
  const int* src = a.src[p] + base;
  {
    const int dc = S.misc[M_DC];
    const int edge = p == 0 && n < 32;
    const int angle = S.mtab[mode], inv = S.mtab[35 + mode];
    for (int i = tid; i < nn; i += blockDim.x) {
      const int x = i & (n - 1), y = i >> lg;
      const int v = intra_sample(mode, x, y, n, lg, S.top, S.left,
                                 filt ? S.topf : S.top,
                                 filt ? S.leftf : S.left, dc, angle, inv,
                                 edge, max_val);
      S.pred[i] = v;
      S.bufa[i] = src[(y0 + y) * W + x0 + x] - v;
    }
  }
  __syncthreads();
  // 5. forward transform
  const int* T = S.dct + dct_offset(lg);
  for (int i = tid; i < nn; i += blockDim.x)
    S.bufb[i] = tq_fwd1(T, S.bufa, n, i >> lg, i & (n - 1),
                        lg + a.bit_depth - 9);
  __syncthreads();
  for (int i = tid; i < nn; i += blockDim.x)
    S.coef[i] = tq_fwd2(S.bufb, T, n, i >> lg, i & (n - 1), lg + 6);
  __syncthreads();
  // 6. quantisation, then sign-data hiding in scan order
  const int sel = scan_select(lg, c_idx, mode);
  const int* scan = a.scans + ((lg - 2) * 3 + sel) * kMaxNN;
  if (a.rdoq) {
    rdoq_block(S, a, c_idx, lg, sel, scan);
  } else {
    const int qbits = 14 + qp / 6 + (15 - a.bit_depth - lg);
    const long long qscale[6] = {26214, 23302, 20560, 18396, 16384, 14564};
    for (int i = tid; i < nn; i += blockDim.x)
      S.lev[i] = tq_quant(S.coef[i], qscale[qp % 6], 171LL << (qbits - 9),
                          qbits);
    __syncthreads();
  }
  if (a.sdh) {
    sdh_adjust(S, scan, nn, qp, lg, a.bit_depth);
    __syncthreads();
  }
  // 7. dequantisation, inverse transform, clip; write recon and levels
  {
    const long long iscale[6] = {40, 45, 51, 57, 64, 72};
    const int bd_shift = a.bit_depth + lg - 5;
    for (int i = tid; i < nn; i += blockDim.x)
      S.bufa[i] = tq_dequant(S.lev[i], iscale[qp % 6] * 16, qp / 6,
                             bd_shift);
  }
  __syncthreads();
  for (int i = tid; i < nn; i += blockDim.x)
    S.bufb[i] = tq_inv1(T, S.bufa, n, i >> lg, i & (n - 1));
  __syncthreads();
  short* lv = a.lv[p] + base;
  for (int i = tid; i < nn; i += blockDim.x) {
    const int x = i & (n - 1), y = i >> lg;
    const int r = tq_inv2(S.bufb, T, n, i >> lg, i & (n - 1),
                          20 - a.bit_depth);
    rec[(y0 + y) * W + x0 + x] = min(max(S.pred[i] + r, 0), max_val);
    lv[(y0 + y) * W + x0 + x] = (short)S.lev[i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    commit_wave_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int cy = a.cy0 + blockIdx.x;
  const int cx = a.wave - 2 * cy;
  const int f = blockIdx.y;
  const int tid = threadIdx.x;
  for (int i = tid; i < 1360; i += blockDim.x) S.dct[i] = a.dct[i];
  for (int i = tid; i < 5 * 35; i += blockDim.x) S.mtab[i] = a.mode_tab[i];
  if (tid < 16) {
    const int gw = a.pw >> 3;
    const size_t at = ((size_t)f * (a.ph >> 3) + cy * 4 + (tid >> 2)) * gw +
                      cx * 4 + (tid & 3);
    S.dm[tid] = a.depth[at];
    S.mm[tid] = a.mode[at];
  }
  __syncthreads();
  // z-order steps; the commit order of ops/commit.py _GROUPS
  for (int g = 0; g < 16; ++g) {
    const int gx = (g & 1) | ((g >> 1) & 2), gy = ((g >> 1) & 1) | ((g >> 2) & 2);
    const bool inside = cx * kCtu + gx * 8 < a.coded_w &&
                        cy * kCtu + gy * 8 < a.coded_h;
    if (!inside) continue;
    const int d = S.dm[gy * 4 + gx], mode = S.mm[gy * 4 + gx];
    if (d >= 2) {
      commit_block(S, a, 0, f, cx, cy, gx * 8, gy * 8, 8, 3, mode);
      commit_block(S, a, 1, f, cx, cy, gx * 4, gy * 4, 4, 2, mode);
      commit_block(S, a, 2, f, cx, cy, gx * 4, gy * 4, 4, 2, mode);
    }
    if ((g & 3) == 0 && d == 1) {
      commit_block(S, a, 0, f, cx, cy, gx * 8, gy * 8, 16, 4, mode);
      commit_block(S, a, 1, f, cx, cy, gx * 4, gy * 4, 8, 3, mode);
      commit_block(S, a, 2, f, cx, cy, gx * 4, gy * 4, 8, 3, mode);
    }
    if (g == 0 && d == 0) {
      commit_block(S, a, 0, f, cx, cy, 0, 0, 32, 5, mode);
      commit_block(S, a, 1, f, cx, cy, 0, 0, 16, 4, mode);
      commit_block(S, a, 2, f, cx, cy, 0, 0, 16, 4, mode);
    }
  }
}

}  // namespace

extern "C" int fhv_commit_intra(
    const int* src_y, const int* src_cb, const int* src_cr, const int* depth,
    const int* mode, int* rec_y, int* rec_cb, int* rec_cr, short* lv_y,
    short* lv_cb, short* lv_cr, const int* dct, const int* scans,
    const int* mode_tab, const int* tiles, int ntx, int nty,
    const float* ftab, const int* itab, const int* meta, float lam, int F,
    int ph, int pw, int coded_w, int coded_h, int qp_y, int qp_c, int sdh,
    int rdoq, int bit_depth, cudaStream_t stream) {
  if (F <= 0) return 0;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      commit_wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.src[0] = src_y;
  a.src[1] = src_cb;
  a.src[2] = src_cr;
  a.rec[0] = rec_y;
  a.rec[1] = rec_cb;
  a.rec[2] = rec_cr;
  a.lv[0] = lv_y;
  a.lv[1] = lv_cb;
  a.lv[2] = lv_cr;
  a.depth = depth;
  a.mode = mode;
  a.dct = dct;
  a.scans = scans;
  a.mode_tab = mode_tab;
  a.tiles = tiles;
  a.ntx = ntx;
  a.nty = nty;
  a.ftab = ftab;
  a.itab = itab;
  a.meta = meta;
  a.lam = lam;
  a.ph = ph;
  a.pw = pw;
  a.coded_w = coded_w;
  a.coded_h = coded_h;
  a.qp_y = qp_y;
  a.qp_c = qp_c;
  a.sdh = sdh;
  a.rdoq = rdoq && ftab != nullptr;
  a.bit_depth = bit_depth;
  const int nctux = pw / kCtu, nctuy = ph / kCtu;
  a.nctux = nctux;
  const int n_waves = nctux + 2 * (nctuy - 1);
  for (int w = 0; w < n_waves; ++w) {
    // CTUs of the wave: cx = w - 2*cy, 0 <= cx < nctux, 0 <= cy < nctuy
    const int cy_lo = max(0, (w - nctux + 2) / 2);
    const int cy_hi = min(nctuy - 1, w / 2);
    a.wave = w;
    a.cy0 = cy_lo;
    dim3 grid(cy_hi - cy_lo + 1, F);
    commit_wave_kernel<<<grid, kThreads, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
