// K5: the wavefront commit — exact reconstruction of F frames, intra or
// mixed intra/inter.
//
// Replaces fasthevc_tpu/ops/commit.py wavefront_commit_intra (:545),
// wavefront_commit_mixed (:570) and _wavefront_commit_impl (:593), with
// what they run per CU: _tq_recon (:416), _sdh_adjust_scan (:353),
// rdoq_scan (ops/rdoq.py:230), predict_selected_mm (ops/intra.py:300) and
// the exact fwd_transform, quantize_mixed, dequantize and inv_transform
// (ops/transform.py:44,99,120,64).
//
// The mixed form (P/B pictures) takes a direction map and the MC prediction
// planes (K11): a CU whose granule direction is > 0 takes its prediction
// from those planes, the inter dead-zone offset 85/512 and the diagonal
// scan; intra CUs read their references from the recon planes as always,
// inter neighbours included.  QPs, the trellis tables and lambda are per
// frame, so a batch may mix temporal layers.
//
// Per CU block, in phases separated by barriers: references from the
// recon planes (earlier CTUs and this CTU's earlier CUs), decoding-order
// availability with tile bounds and the spec's substitution; the [1 2 1]
// filter; the selected prediction (intra_common.cuh, shared with K1); the
// exact transform (tq_common.cuh, shared with K3); dead-zone quantisation
// or the parallel RDOQ trellis; sign-data hiding in scan order;
// dequantisation, inverse transform and clip, written straight into the
// output planes.  The trellis runs in f32 with round-to-nearest intrinsics
// in the reference's order (its sums left to right, its cumulative sum as
// XLA's blocked scan, first index on ties), so it matches the PyTorch twin
// and the JAX reference bit for bit.
//
// Bound on the H100: latency.  The int32 work of a 1080p frame takes
// about 0.01 ms at the card's peak; what bounds the call is its chain of
// dependent CTU steps: an intra CTU needs its left, top-left, top and
// top-right neighbours, so at 1080p (60 x 34 CTUs) the chain is
// nctux + 2 (nctuy - 1) = 126 CTU steps long, each a chain of CU blocks
// of some 25 barriers.  The first design paid the chain as 126 launches,
// each waiting for its slowest CTU, with the three planes of every CU in
// sequence on one CTA.  This design:
//   * one launch per call: a grid of at most (SMs x resident CTAs)
//     persistent CTAs takes CTU tickets from a counter in wave order
//     (wave = cx + 2 cy, then cy, then frame), so every CTU a ticket
//     waits on was taken by a CTA that already runs: no deadlock.  A CTU
//     publishes its recon with a release store of its flag (after a
//     fence); a CTU with intra CUs waits for the flags of its left,
//     top-left, top and top-right neighbours with acquire loads and reads
//     their recon past L1 (ld.global.cg: L1 is not coherent across SMs);
//   * inter CUs first: a CTU commits its inter CUs (which read only the
//     source and the MC planes) before it waits, and a CTU without intra
//     CUs never waits, so on P/B pictures the chain runs only through
//     CTUs that hold intra CUs (the plain twin commits every inter CU of
//     the call first, proving the order changes no output);
//   * the three planes in parallel: in 4:2:0 a chroma block reads only
//     chroma recon and takes its mode from the known luma mode, so luma
//     (4 warps), Cb and Cr (2 warps each) run their CU chains at once,
//     each warp group with its own named barrier and shared scratch; a
//     block of at most 64 coefficients runs on one warp (__syncwarp);
//   * the reference substitution and DC use warp ballots and reductions.
// The wave order of the tickets is ops/commit.py `ticket_order`;
// tests/test_torch_commit_schedule.py holds it and these waits on the CPU.
//
// The JAX package's boundary buffers, one-hot matmuls and reassembly
// (commit.py:16-39, 294-334, 655-698, 779-794) are TPU workarounds and are
// not carried over: the kernel reads its references from the recon planes
// it writes.

#include <cuda_runtime.h>

#include "intra_common.cuh"
#include "tq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCtu = 32;
constexpr int kMaxNN = 1024;     // a luma 32x32 block
constexpr int kChromaNN = 256;   // a chroma 16x16 block
// only a deadlock waits this long for a neighbour's flag (ns)
constexpr unsigned long long kWaitNs = 10000000000ull;

// per (c_idx, lg) row of the trellis' meta table (ops/commit.py RD_FIELDS)
enum {
  RD_SIG, RD_LAST, RD_G1, RD_G2, RD_CSB, RD_NBR, RD_QBITS, RD_QSCALE,
  RD_ERRSCALE, RD_NSCANS, RD_STEP, RD_NFIELDS
};

// a warp group's misc slots
enum { M_DC, M_LAST_INIT, M_OLD_LAST, M_ARG, M_NMISC = 8 };

struct Args {
  const int* src[3];
  const int* ipred[3];  // MC prediction planes (mixed form) or NULL
  int* rec[3];
  short* lv[3];
  const int* depth;
  const int* mode;
  const int* dir;       // [F][ph/8][pw/8] (mixed form) or NULL
  const int* dct;       // n = 4, 8, 16, 32 at offsets 0, 16, 80, 336
  const int* scans;     // [4 (lg 2..5)][3][1024] raster index per scan pos
  const int* mode_tab;  // [5][35]: angle, inverse, filter flag n=8,16,32
  const int* tiles;     // ntx inner column bounds, then nty row bounds
  int ntx, nty;
  const float* ftab;    // trellis tables (f32 blob)
  const int* itab;      // trellis tables (int blob)
  const int* meta;      // [F][2][6][RD_NFIELDS]
  const float* lams;    // [F] the trellis' lambda
  const int* qps;       // [F][2]: luma QP, chroma QP
  int* flags;           // [F][nctu] CTU done flags, then the ticket counter
  const int* order;     // the CTU (cy * nctux + cx) of each (wave, cy) slot
  int ph, pw, coded_w, coded_h, nctux, nctu, F;
  int sdh, rdoq, bit_depth;
};

// What the three warp groups share: the tables and the CTU in flight.
struct Shared {
  int dct[1360];
  int mtab[5 * 35];
  int dm[16], mm[16], im[16];
  int cus[16];  // the CTU's CUs in commit order: z-step | size << 4 |
                // inter << 6 (size 0: 32x32, 1: 16x16, 2: 8x8)
  int ncu, has_intra, ticket;
};

// One warp group's scratch, carved from dynamic shared memory for blocks
// of up to nn coefficients (n = sqrt(nn)).
struct Scratch {
  int *raw, *avail, *top, *left, *topf, *leftf, *misc;
  int *pred, *bufa, *bufb, *coef, *lev;
  // the trellis, in scan order
  int *ld, *m, *lvl, *sched;
  float *d0, *s1, *clv, *incl;
  int *cg_gt1, *cg_nz, *cg_set, *cg_rb;
  float *tot1, *tot2, *redv;
  int* redi;
};

__host__ __device__ constexpr int isqrt_pow2(int nn) {
  return nn == 1024 ? 32 : (nn == 256 ? 16 : 8);
}

// words of one group's scratch for blocks of up to nn coefficients
__host__ __device__ constexpr int scratch_words(int nn) {
  return 2 * (4 * isqrt_pow2(nn) + 1) + 4 * (2 * isqrt_pow2(nn) + 1) +
         M_NMISC + 13 * nn + 5 * (nn / 16) + 4 + 8 + 8;
}

__host__ __device__ constexpr int smem_bytes() {
  return (int)sizeof(Shared) +
         4 * (scratch_words(kMaxNN) + 2 * scratch_words(kChromaNN));
}

__device__ Scratch carve(int* p, int nn) {
  const int n = isqrt_pow2(nn), L = 4 * n + 1, R = 2 * n + 1, g = nn / 16;
  Scratch s;
  s.raw = p; p += L;
  s.avail = p; p += L;
  s.top = p; p += R;
  s.left = p; p += R;
  s.topf = p; p += R;
  s.leftf = p; p += R;
  s.misc = p; p += M_NMISC;
  s.pred = p; p += nn;
  s.bufa = p; p += nn;
  s.bufb = p; p += nn;
  s.coef = p; p += nn;
  s.lev = p; p += nn;
  s.ld = p; p += nn;
  s.m = p; p += nn;
  s.lvl = p; p += nn;
  s.sched = p; p += nn;
  s.d0 = (float*)p; p += nn;
  s.s1 = (float*)p; p += nn;
  s.clv = (float*)p; p += nn;
  s.incl = (float*)p; p += nn;
  s.cg_gt1 = p; p += g;
  s.cg_nz = p; p += g;
  s.cg_set = p; p += g;
  s.cg_rb = p; p += g;
  s.tot1 = (float*)p; p += g;
  s.tot2 = (float*)p; p += 4;
  s.redv = (float*)p; p += 8;
  s.redi = p;
  return s;
}

// A warp group as one block of a CU sees it: its threads (tid < n), its
// barrier (a named barrier of n threads, or bar == 0 for one warp, which
// synchronises with __syncwarp) and its scratch.
struct Grp {
  int tid, n, bar;
  Scratch S;
  __device__ __forceinline__ void sync() const {
    if (bar)
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(n) : "memory");
    else
      __syncwarp();
  }
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

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

// First-index argmin of (v, i) over the group: each thread passes its
// partial; every thread gets the winner's index.  (v, i) pairs are totally
// ordered, so the tree's shape does not change the result.
__device__ int argmin_group(const Grp& G, float v, int i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, v, o);
    const int i2 = __shfl_down_sync(0xffffffffu, i, o);
    if (v2 < v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
  if ((G.tid & 31) == 0) {
    G.S.redv[G.tid >> 5] = v;
    G.S.redi[G.tid >> 5] = i;
  }
  G.sync();
  if (G.tid == 0) {
    float bv = G.S.redv[0];
    int bi = G.S.redi[0];
    for (int w = 1; w < (G.n >> 5); ++w) {
      const float v2 = G.S.redv[w];
      const int i2 = G.S.redi[w];
      if (v2 < bv || (v2 == bv && i2 < bi)) {
        bv = v2;
        bi = i2;
      }
    }
    G.S.misc[M_ARG] = bi;
  }
  G.sync();
  return G.S.misc[M_ARG];
}

// The parallel trellis (rdoq.py:230) of the coefficients S.coef (raster);
// writes signed levels into S.lev (raster).  scan: raster index per scan
// position of the block's scan.
__device__ void rdoq_block(const Grp& G, const Args& a, int f, int c_idx,
                           int lg, int sel, const int* scan) {
  const int tid = G.tid;
  const Scratch& S = G.S;
  const int nn = 1 << (2 * lg);
  const int g = nn >> 4;
  const int* row = a.meta + ((f * 2 + c_idx) * 6 + lg) * RD_NFIELDS;
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
  const float lam = a.lams[f];
  // the reference's quantiser step: XLA's exp2(qbits), not always exact
  const float step = a.ftab[row[RD_STEP]];

  // R1: provisional levels and the zero-level distortion
  if (tid == 0) {
    S.misc[M_LAST_INIT] = -1;
    S.misc[M_OLD_LAST] = -1;
  }
  for (int p = tid; p < nn; p += G.n) {
    const int c = S.coef[scan[p]];
    const int ld = (c < 0 ? -c : c) * q_scale;  // < 2^31
    S.ld[p] = ld;
    S.m[p] = min((ld + (1 << (qbits - 1))) >> qbits, 32767);
    const float ldf = (float)ld;
    S.d0[p] = __fmul_rn(__fmul_rn(ldf, ldf), err_scale);
  }
  G.sync();
  // R2: closed-form context schedule per CG, over the positions coded
  // before each slot (higher scan index)
  for (int gi = tid; gi < g; gi += G.n) {
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
  G.sync();
  // R3: per-CG context set and csbf neighbours
  for (int gi = tid; gi < g; gi += G.n) {
    const int prev = gi + 1 < g ? S.cg_gt1[gi + 1] : 0;
    int cs = (c_idx == 0 && g > 1) ? 2 * (gi > 0) + prev : prev;
    S.cg_set[gi] = min(max(cs, 0), n_sets - 1);
    const int r = nbr[gi] >= 0 ? S.cg_nz[nbr[gi]] : 0;
    const int b = nbr[g + gi] >= 0 ? S.cg_nz[nbr[g + gi]] : 0;
    S.cg_rb[gi] = r | (b << 1);
  }
  G.sync();
  // R4: per-coefficient level choice among {0, m, m-1}
  for (int p = tid; p < nn; p += G.n) {
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
  G.sync();
  // R5: nothing after the provisional last position
  const int last_init = S.misc[M_LAST_INIT];
  for (int p = tid; p < nn; p += G.n) {
    if (p > last_init) {
      S.lvl[p] = 0;
      S.clv[p] = 0.f;
    }
  }
  G.sync();
  // R6: coding-group zeroing (not DC, not the provisional last CG)
  if (g > 1) {
    const int last_cg = last_init >> 4;
    for (int gi = tid; gi < g; gi += G.n) {
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
    G.sync();
  }
  // R7: the last nonzero level
  for (int p = tid; p < nn; p += G.n)
    if (S.lvl[p] > 0) atomicMax(&S.misc[M_OLD_LAST], p);
  G.sync();
  const int old_last = S.misc[M_OLD_LAST];
  // R8: gains of zeroing each position, then their blocked prefix sum
  // (XLA's order: sequential inside blocks of 16, block totals scanned by
  // the same rule)
  for (int p = tid; p < nn; p += G.n) {
    const float cz = p <= last_init ? S.d0[p] : 0.f;
    S.incl[p] = p <= old_last ? __fsub_rn(cz, S.clv[p]) : 0.f;
  }
  G.sync();
  for (int b = tid; b < g; b += G.n) {
    float acc = S.incl[16 * b];
    for (int i = 1; i < 16; ++i) {
      acc = __fadd_rn(acc, S.incl[16 * b + i]);
      S.incl[16 * b + i] = acc;
    }
  }
  G.sync();
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
      for (int c = tid; c < g / 16; c += G.n) {
        float acc = S.incl[16 * (16 * c) + 15];
        S.tot1[16 * c] = acc;
        for (int i = 1; i < 16; ++i) {
          acc = __fadd_rn(acc, S.incl[16 * (16 * c + i) + 15]);
          S.tot1[16 * c + i] = acc;
        }
      }
      G.sync();
      if (tid == 0) {
        float acc = S.tot1[15];
        S.tot2[0] = acc;
        for (int c = 1; c < g / 16; ++c) {
          acc = __fadd_rn(acc, S.tot1[16 * c + 15]);
          S.tot2[c] = acc;
        }
      }
      G.sync();
      for (int b = tid; b < g; b += G.n)
        if (b >= 16) S.tot1[b] = __fadd_rn(S.tot1[b], S.tot2[(b >> 4) - 1]);
    }
    G.sync();
    for (int p = tid; p < nn; p += G.n)
      if (p >= 16) S.incl[p] = __fadd_rn(S.incl[p], S.tot1[(p >> 4) - 1]);
    G.sync();
  }
  // R9: the best last position (first index on ties)
  int new_last;
  {
    float best = __int_as_float(0x7f800000);
    int best_i = nn;
    const float total_sum = S.incl[nn - 1];
    for (int p = tid; p < nn; p += G.n) {
      float v = __int_as_float(0x7f800000);
      if (S.lvl[p] > 0)
        v = __fsub_rn(__fadd_rn(__fsub_rn(total_sum, S.incl[p]), last[p]),
                      S.s1[p]);
      if (v < best || (v == best && p < best_i)) {
        best = v;
        best_i = p;
      }
    }
    new_last = argmin_group(G, best, best_i);
  }
  // all-inf: the reference's argmin returns index 0
  if (new_last >= nn) new_last = 0;
  // R10: signed levels, raster order
  for (int p = tid; p < nn; p += G.n) {
    const int c = S.coef[scan[p]];
    const int lv = (old_last >= 0 && p <= new_last) ? S.lvl[p] : 0;
    S.lev[scan[p]] = c < 0 ? -lv : (c > 0 ? lv : 0);
  }
  G.sync();
}

// Sign-data hiding (commit.py:353) of S.lev against S.coef, both raster,
// visited in scan order: per 16-coefficient group, one thread.
__device__ void sdh_adjust(const Grp& G, const int* scan, int nn, int qp,
                           int lg, int bit_depth) {
  const Scratch& S = G.S;
  const int qbits = 14 + qp / 6 + (15 - bit_depth - lg);
  const int qscale[6] = {26214, 23302, 20560, 18396, 16384, 14564};
  const int scale = qscale[qp % 6];
  for (int gi = G.tid; gi < (nn >> 4); gi += G.n) {
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

// Steps 1-4 of an intra block: references, substitution, filtering, the
// selected prediction into S.pred and the residual into S.bufa.
__device__ void intra_residual(const Grp& G, const Shared& Sh, const Args& a,
                               int p, int f, int cx, int cy, int lx, int ly,
                               int n, int lg, int mode) {
  const int tid = G.tid;
  const Scratch& S = G.S;
  const int sub = p ? 1 : 0;
  const int H = a.ph >> sub, W = a.pw >> sub;
  const int x0 = (cx * kCtu >> sub) + lx, y0 = (cy * kCtu >> sub) + ly;
  const size_t base = (size_t)f * H * W;
  const int* rec = a.rec[p] + base;
  const int* src = a.src[p] + base;
  const int L = 4 * n + 1;
  const int max_val = (1 << a.bit_depth) - 1;
  const int nn = n * n;
  // luma position of the block (availability is decided in luma units)
  const int cxl = cx * kCtu + (lx << sub), cyl = cy * kCtu + (ly << sub);
  const int ca = cxl >> 3, cb = cyl >> 3;
  const int ctu_c = (cb >> 2) * a.nctux + (ca >> 2);
  const int z_c = zorder(ca & 3, cb & 3);

  // 1. raw references: bottom-most left .. left top, corner, top row; the
  // neighbours' recon read past L1 (another SM wrote it)
  for (int i = tid; i < L; i += G.n) {
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
    S.raw[i] = ok ? __ldcg(rec + y * W + x) : 0;
  }
  G.sync();
  // 2. substitution (spec 8.4.4.2.2) on the group's first warp: the first
  // available reference, then for each the nearest available one at or
  // below it, by ballots over chunks of 32
  if (tid < 32) {
    int first = -1;
    for (int b = 0; b < L && first < 0; b += 32) {
      const unsigned m = __ballot_sync(0xffffffffu, b + tid < L &&
                                                        S.avail[b + tid]);
      if (m) first = b + __ffs(m) - 1;
    }
    int carry = -1;
    for (int b = 0; b < L; b += 32) {
      const int i = b + tid;
      const unsigned m = __ballot_sync(0xffffffffu, i < L && S.avail[i]);
      const unsigned upto = m & (0xffffffffu >> (31 - tid));
      const int j = upto ? b + 31 - __clz(upto) : carry;
      if (m) carry = b + 31 - __clz(m);
      if (i < L) {
        int v = 1 << (a.bit_depth - 1);
        if (first >= 0) v = S.raw[j >= 0 ? j : first];
        if (i <= 2 * n) S.left[2 * n - i] = v;
        if (i >= 2 * n) S.top[i - 2 * n] = v;
      }
    }
  }
  G.sync();
  // 3. filtered references and DC (intra_dc, as a warp sum)
  const int Lr = 2 * n + 1;
  const int filt = p == 0 ? Sh.mtab[(2 + lg - 3) * 35 + mode] : 0;
  if (filt)
    for (int k = tid; k < Lr; k += G.n)
      intra_filter_ref(S.top, S.left, k, Lr, &S.topf[k], &S.leftf[k]);
  if (tid < 32) {
    int s = 0;
    for (int q = 1 + tid; q <= n; q += 32) s += S.top[q] + S.left[q];
    s = __reduce_add_sync(0xffffffffu, s);
    if (tid == 0) S.misc[M_DC] = (n + s) >> (lg + 1);
  }
  G.sync();
  // 4. prediction and residual
  {
    const int dc = S.misc[M_DC];
    const int edge = p == 0 && n < 32;
    const int angle = Sh.mtab[mode], inv = Sh.mtab[35 + mode];
    for (int i = tid; i < nn; i += G.n) {
      const int x = i & (n - 1), y = i >> lg;
      const int v = intra_sample(mode, x, y, n, lg, S.top, S.left,
                                 filt ? S.topf : S.top,
                                 filt ? S.leftf : S.left, dc, angle, inv,
                                 edge, max_val);
      S.pred[i] = v;
      S.bufa[i] = src[(y0 + y) * W + x0 + x] - v;
    }
  }
  G.sync();
}

// Commit one n x n block of plane p (0 luma, 1 Cb, 2 Cr) at local (lx, ly)
// of CTU (cx, cy), frame f, on group G; an inter block takes its
// prediction from the MC planes.
__device__ void commit_block(const Grp& G, const Shared& Sh, const Args& a,
                             int p, int f, int cx, int cy, int lx, int ly,
                             int n, int lg, int mode, bool inter) {
  const int tid = G.tid;
  const Scratch& S = G.S;
  const int sub = p ? 1 : 0;
  const int H = a.ph >> sub, W = a.pw >> sub;
  const int x0 = (cx * kCtu >> sub) + lx, y0 = (cy * kCtu >> sub) + ly;
  const size_t base = (size_t)f * H * W;
  int* rec = a.rec[p] + base;
  const int max_val = (1 << a.bit_depth) - 1;
  const int nn = n * n;
  const int c_idx = p ? 1 : 0;
  const int qp = a.qps[2 * f + (p ? 1 : 0)];
  const int* src = a.src[p] + base;
  // the group's previous block may have run on its first warp alone
  G.sync();
  if (inter) {
    const int* ip = a.ipred[p] + base;
    for (int i = tid; i < nn; i += G.n) {
      const int at = (y0 + (i >> lg)) * W + x0 + (i & (n - 1));
      S.pred[i] = ip[at];
      S.bufa[i] = src[at] - ip[at];
    }
    G.sync();
  } else {
    intra_residual(G, Sh, a, p, f, cx, cy, lx, ly, n, lg, mode);
  }
  // 5. forward transform
  const int* T = Sh.dct + dct_offset(lg);
  for (int i = tid; i < nn; i += G.n)
    S.bufb[i] = tq_fwd1(T, S.bufa, n, i >> lg, i & (n - 1),
                        lg + a.bit_depth - 9);
  G.sync();
  for (int i = tid; i < nn; i += G.n)
    S.coef[i] = tq_fwd2(S.bufb, T, n, i >> lg, i & (n - 1), lg + 6);
  G.sync();
  // 6. quantisation, then sign-data hiding in scan order
  const int sel = inter ? 0 : scan_select(lg, c_idx, mode);
  const int* scan = a.scans + ((lg - 2) * 3 + sel) * kMaxNN;
  if (a.rdoq) {
    rdoq_block(G, a, f, c_idx, lg, sel, scan);
  } else {
    const int qbits = 14 + qp / 6 + (15 - a.bit_depth - lg);
    const long long qscale[6] = {26214, 23302, 20560, 18396, 16384, 14564};
    for (int i = tid; i < nn; i += G.n)
      S.lev[i] = tq_quant(S.coef[i], qscale[qp % 6],
                          (inter ? 85LL : 171LL) << (qbits - 9), qbits);
    G.sync();
  }
  if (a.sdh) {
    sdh_adjust(G, scan, nn, qp, lg, a.bit_depth);
    G.sync();
  }
  // 7. dequantisation, inverse transform, clip; write recon and levels
  {
    const long long iscale[6] = {40, 45, 51, 57, 64, 72};
    const int bd_shift = a.bit_depth + lg - 5;
    for (int i = tid; i < nn; i += G.n)
      S.bufa[i] = tq_dequant(S.lev[i], iscale[qp % 6] * 16, qp / 6,
                             bd_shift);
  }
  G.sync();
  for (int i = tid; i < nn; i += G.n)
    S.bufb[i] = tq_inv1(T, S.bufa, n, i >> lg, i & (n - 1));
  G.sync();
  short* lv = a.lv[p] + base;
  for (int i = tid; i < nn; i += G.n) {
    const int x = i & (n - 1), y = i >> lg;
    const int r = tq_inv2(S.bufb, T, n, i >> lg, i & (n - 1),
                          20 - a.bit_depth);
    rec[(y0 + y) * W + x0 + x] = min(max(S.pred[i] + r, 0), max_val);
    lv[(y0 + y) * W + x0 + x] = (short)S.lev[i];
  }
  G.sync();
}

// Plane p's blocks of the CTU's CUs whose inter flag is `inter`, in commit
// order, on the plane's warp group (full: all its warps; warp: its first
// warp alone, for blocks of at most 64 coefficients).
__device__ void commit_plane(const Grp& full, const Grp& warp,
                             const Shared& Sh, const Args& a, int p, int f,
                             int cx, int cy, bool inter) {
  for (int k = 0; k < Sh.ncu; ++k) {
    const int e = Sh.cus[k];
    if (((e >> 6) & 1) != (int)inter) continue;
    const int g = e & 15, size = (e >> 4) & 3;
    const int gx = (g & 1) | ((g >> 1) & 2);
    const int gy = ((g >> 1) & 1) | ((g >> 2) & 2);
    const int mode = Sh.mm[gy * 4 + gx];
    const int lg = 5 - size - (p ? 1 : 0), n = 1 << lg;
    const int lx = p ? gx * 4 : gx * 8, ly = p ? gy * 4 : gy * 8;
    if (n * n <= 64) {
      if (full.tid < 32)
        commit_block(warp, Sh, a, p, f, cx, cy, lx, ly, n, lg, mode, inter);
    } else {
      commit_block(full, Sh, a, p, f, cx, cy, lx, ly, n, lg, mode, inter);
    }
  }
}

__device__ void wait_flag(const int* flag) {
  if (ld_acquire(flag)) return;
  const unsigned long long t0 = globaltimer();
  while (!ld_acquire(flag)) {
    __nanosleep(64);
    if (globaltimer() - t0 > kWaitNs) __trap();  // a deadlock: fail loudly
  }
}

__global__ void __launch_bounds__(kThreads, 2) commit_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& Sh = *reinterpret_cast<Shared*>(smem_raw);
  int* words = reinterpret_cast<int*>(smem_raw + sizeof(Shared));
  const int tid = threadIdx.x;
  // the warp groups: luma threads 0-127, Cb 128-191, Cr 192-255
  const int p = tid < 128 ? 0 : (tid < 192 ? 1 : 2);
  const int lo = p == 0 ? 0 : (p == 1 ? 128 : 192);
  const int nn = p ? kChromaNN : kMaxNN;
  const Scratch S = carve(
      words + (p == 0 ? 0
                      : scratch_words(kMaxNN) +
                            (p - 1) * scratch_words(kChromaNN)),
      nn);
  const Grp full{tid - lo, p ? 64 : 128, p + 1, S};
  const Grp warp{tid - lo, 32, 0, S};
  for (int i = tid; i < 1360; i += blockDim.x) Sh.dct[i] = a.dct[i];
  for (int i = tid; i < 5 * 35; i += blockDim.x) Sh.mtab[i] = a.mode_tab[i];
  int* counter = a.flags + (size_t)a.F * a.nctu;
  const int total = a.F * a.nctu;
  for (;;) {
    if (tid == 0) Sh.ticket = atomicAdd(counter, 1);
    __syncthreads();
    const int tk = Sh.ticket;
    if (tk >= total) break;
    const int f = tk % a.F, ctu = a.order[tk / a.F];
    const int cy = ctu / a.nctux, cx = ctu - cy * a.nctux;
    if (tid < 16) {
      const int gw = a.pw >> 3;
      const size_t at = ((size_t)f * (a.ph >> 3) + cy * 4 + (tid >> 2)) * gw +
                        cx * 4 + (tid & 3);
      Sh.dm[tid] = a.depth[at];
      Sh.mm[tid] = a.mode[at];
      Sh.im[tid] = a.dir != nullptr ? a.dir[at] : 0;
    }
    __syncthreads();
    if (tid == 0) {
      // z-order steps; the commit order of ops/commit.py _GROUPS
      int ncu = 0, has_intra = 0;
      for (int g = 0; g < 16; ++g) {
        const int gx = (g & 1) | ((g >> 1) & 2);
        const int gy = ((g >> 1) & 1) | ((g >> 2) & 2);
        if (cx * kCtu + gx * 8 >= a.coded_w || cy * kCtu + gy * 8 >= a.coded_h)
          continue;
        const int d = Sh.dm[gy * 4 + gx];
        const int size = d >= 2 ? 2 : ((g & 3) == 0 && d == 1 ? 1
                                       : (g == 0 && d == 0 ? 0 : -1));
        if (size < 0) continue;
        const int inter = Sh.im[gy * 4 + gx] > 0;
        Sh.cus[ncu++] = g | (size << 4) | (inter << 6);
        has_intra |= !inter;
      }
      Sh.ncu = ncu;
      Sh.has_intra = has_intra;
    }
    __syncthreads();
    // inter CUs first: they read only the source and the MC planes
    if (a.dir != nullptr) commit_plane(full, warp, Sh, a, p, f, cx, cy, true);
    if (Sh.has_intra) {
      if (tid == 0) {
        const int* fl = a.flags + (size_t)f * a.nctu;
        const int at = cy * a.nctux + cx;
        if (cx > 0) wait_flag(fl + at - 1);
        if (cy > 0) {
          if (cx > 0) wait_flag(fl + at - a.nctux - 1);
          wait_flag(fl + at - a.nctux);
          if (cx + 1 < a.nctux) wait_flag(fl + at - a.nctux + 1);
        }
      }
      __syncthreads();
      commit_plane(full, warp, Sh, a, p, f, cx, cy, false);
    }
    // publish the CTU's recon: every thread's writes, then the flag
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(a.flags + (size_t)f * a.nctu + ctu, 1);
  }
}

}  // namespace

// dir and ipred_* are NULL for intra pictures; meta [F][2][6][RD_NFIELDS],
// lams [F] and qps [F][2] are per frame.  flags: F x CTUs + 1 ints, zero
// (the CTU flags and the ticket counter); order: the CTU of each (wave,
// cy) slot (ops/commit.py ticket_order).  One launch.
extern "C" int fhv_commit(
    const int* src_y, const int* src_cb, const int* src_cr, const int* depth,
    const int* mode, const int* dir, const int* ipred_y,
    const int* ipred_cb, const int* ipred_cr, int* rec_y, int* rec_cb,
    int* rec_cr, short* lv_y, short* lv_cb, short* lv_cr, const int* dct,
    const int* scans, const int* mode_tab, const int* tiles, int ntx,
    int nty, const float* ftab, const int* itab, const int* meta,
    const float* lams, const int* qps, int* flags, const int* order, int F,
    int ph, int pw, int coded_w, int coded_h, int sdh, int rdoq,
    int bit_depth, cudaStream_t stream) {
  if (F <= 0) return 0;
  const int smem = smem_bytes();
  // the opt-in above 48 KB and the CTAs that fit at once belong to the
  // caller's current device (ranks of a mesh may sit on different cards):
  // set and read on every launch
  cudaError_t err = cudaFuncSetAttribute(
      commit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, commit_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int resident = sms * per_sm;
  Args a;
  a.src[0] = src_y;
  a.src[1] = src_cb;
  a.src[2] = src_cr;
  a.ipred[0] = ipred_y;
  a.ipred[1] = ipred_cb;
  a.ipred[2] = ipred_cr;
  a.dir = dir;
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
  a.lams = lams;
  a.qps = qps;
  a.flags = flags;
  a.order = order;
  a.ph = ph;
  a.pw = pw;
  a.coded_w = coded_w;
  a.coded_h = coded_h;
  a.nctux = pw / kCtu;
  a.nctu = a.nctux * (ph / kCtu);
  a.F = F;
  a.sdh = sdh;
  a.rdoq = rdoq && ftab != nullptr;
  a.bit_depth = bit_depth;
  const int total = F * a.nctu;
  const int grid = total < resident ? total : resident;
  commit_kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
