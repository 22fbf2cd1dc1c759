// K11: exact motion compensation.
//
// Replaces fasthevc_tpu/ops/me.py _mc_raw_blocks (:447) and what runs on it:
// mc_blocks (:435), inter_pred_planes (:508), and the tier-window MC of the
// merge candidates, _tier_view (:613), _mc_raw_windows (:630) and
// mc_raw_from_state(_sel) (:656, :671), with the merge fold that the
// searches run on them (fasthevc_tpu/codec/search.py:318-334 for P,
// :438-460 `with_merge_cands` for B).  Every sample is the spec's separable
// interpolation on the edge-clamped reference (8.5.4.2.2: horizontal taps
// >> (bit_depth - 8), vertical taps >> 6; the zero-phase tap row
// reproduces the copy and one-direction cases exactly).  Entry points:
//   * fhv_mc_merge: the merge candidates of one block size, folded.  For
//     each list and n-block, the left and then the top same-size
//     neighbour's (MV, ref) from the ME winners' field (zero at the
//     picture's edge, and at a shard's picture edge for the left one) is
//     predicted from the state reference its ref picks, priced SATD + 2
//     lambda_sqrt (inf where its integer MV leaves the tier window around
//     that reference's base, me.py:642-645) and taken by strict < against
//     the running (cost, MV, ref, prediction, rate bits = 2).
//   * fhv_mc_sel: the earlier merge-candidate form, the raw 14-bit luma
//     prediction of every n-block of refs[sel[b]] at its quarter-pel MV
//     and `valid`, one thread per sample; the SATD (K2) and the fold ran
//     apart.  No route launches it; it stays as mc_merge's yardstick.
//   * fhv_inter_pred: the commit's prediction planes of one component for
//     per-granule motion (8x8 luma granules, 4x4 chroma with the 4-tap
//     eighth-pel filter): uni-prediction (raw + 32) >> 6 from list 0 or
//     list 1 by the direction map, or the bi average (raw0 + raw1 + 64) >>
//     7, clipped; ref_map picks each list's reference per granule.
//
// The reference gathers windows from a +-80 edge-padded plane through
// one-hot selects (TPU workarounds); MVs stay within +-(4 * 64 + 3)
// quarter pels, so those windows hold edge-clamped samples.
//
// Bound on the H100: bytes.  inter_pred: ~50 MB per 1080p frame for the
// three planes; its separable filter needs (n + 7) * n + n * n 8-tap
// filters per luma n-block, about 0.1 G operations per frame.  mc_merge
// reads the source, the ME winners' predictions and the reference area and
// writes the winners' predictions: ~34 MB per (1080p picture, n, list),
// against two candidates x 2.1 M samples x ~32 operations.
// Design:
//   * mc_merge: a CTA holds P blocks of one list (P = 8, 4, 1, 1 for n =
//     8-64).  Each candidate's (n + 7)^2 edge-clamped window goes to shared
//     memory; the horizontal pass writes (n + 7) x n to shared memory, a
//     thread an 8-sample row segment with its phase's taps in registers;
//     the vertical pass runs 8 lanes to an 8x8 sub-block, a lane a column,
//     into registers, where the residual's Hadamard runs: the columns in
//     each lane, the rows across the 8 lanes by shuffles (satd8_lanes,
//     satd_common.cuh: K2's transform in another order of the same exact
//     sums).  The prediction goes back over the spent window, and only
//     the winner's prediction is written.
//   * mc_sel and inter_pred: one thread per sample recomputes its 8
//     horizontal rows (72 multiply-adds a luma sample, three times the
//     separable work), reading through L1/L2.

#include <cuda_runtime.h>

#include "copy_common.cuh"
#include "mc_common.cuh"
#include "satd_common.cuh"

namespace {

__global__ void mc_sel_kernel(const int* __restrict__ refs,
                              const int* __restrict__ base,
                              const int* __restrict__ mvq,
                              const int* __restrict__ sel,
                              int* __restrict__ raw, int* __restrict__ valid,
                              long long total, int H, int W, int n, int tier,
                              int tier_w) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int nn = n * n;
  const int b = (int)(idx / nn), s = (int)(idx - (long long)b * nn);
  const int gx = W / n;
  const int oy = (b / gx) * n, ox = (b % gx) * n;
  const int r = sel[b];
  const int mx = mvq[2 * b], my = mvq[2 * b + 1];
  raw[idx] = mc_raw<8>(refs + (size_t)r * H * W, H, W, oy + s / n,
                       ox + s % n, mx, my, 2, 0);
  if (s == 0) {
    const int bt = (H / tier) * (W / tier);
    const int parent = (oy / tier) * (W / tier) + ox / tier;
    const int bx = base[((size_t)r * bt + parent) * 2];
    const int by = base[((size_t)r * bt + parent) * 2 + 1];
    const int rs = (my >> 2) - by + oy % tier + 4;
    const int cs = (mx >> 2) - bx + ox % tier + 4;
    const int lim = tier_w - (n + 7);
    valid[b] = rs >= 0 && rs <= lim && cs >= 0 && cs <= lim;
  }
}

__global__ void inter_pred_kernel(const int* __restrict__ ref0,
                                  const int* __restrict__ ref1,
                                  const int* __restrict__ dir,
                                  const int* __restrict__ mv,
                                  const int* __restrict__ rmap,
                                  int* __restrict__ out, long long total,
                                  int R0, int R1, int H, int W, int chroma,
                                  int bit_depth) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long hw = (long long)H * W;
  const int f = (int)(idx / hw);
  const int rem = (int)(idx - (long long)f * hw);
  const int y = rem / W, x = rem - y * W;
  const int g = chroma ? 4 : 8;
  const int gw = W / g, gh = H / g;
  const size_t gi = ((size_t)f * gh + y / g) * gw + x / g;
  const int d = dir[gi];
  const int shift1 = bit_depth - 8;
  const int fb = chroma ? 3 : 2;
  const int r0 = rmap != nullptr && R0 > 1 ? rmap[gi * 2] : 0;
  const int* p0 = ref0 + ((size_t)f * R0 + r0) * hw;
  int raw0, raw1;
  if (chroma)
    raw0 = mc_raw<4>(p0, H, W, y, x, mv[gi * 4], mv[gi * 4 + 1], fb, shift1);
  else
    raw0 = mc_raw<8>(p0, H, W, y, x, mv[gi * 4], mv[gi * 4 + 1], fb, shift1);
  raw1 = raw0;
  if (ref1 != nullptr && (d == 2 || d == 3)) {
    const int r1 = rmap != nullptr && R1 > 1 ? rmap[gi * 2 + 1] : 0;
    const int* p1 = ref1 + ((size_t)f * R1 + r1) * hw;
    if (chroma)
      raw1 = mc_raw<4>(p1, H, W, y, x, mv[gi * 4 + 2], mv[gi * 4 + 3], fb,
                       shift1);
    else
      raw1 = mc_raw<8>(p1, H, W, y, x, mv[gi * 4 + 2], mv[gi * 4 + 3], fb,
                       shift1);
  }
  const int shift = 14 - bit_depth;
  int pred;
  if (d == 3)
    pred = (raw0 + raw1 + (1 << shift)) >> (shift + 1);
  else
    pred = ((d == 2 ? raw1 : raw0) + (1 << (shift - 1))) >> shift;
  out[idx] = min(max(pred, 0), (1 << bit_depth) - 1);
}


// ---------------------------------------------------------------------------
// mc_merge

// One list's inputs: the ME winners' [B, 2] MVs, [B] list-relative ref
// indices, [B, n, n] predictions, [B] f32 costs and rate bits, and the two
// state references (ia, ib) that ref 0 and ref > 0 pick.
struct MergeList {
  const int* mv;
  const int* ridx;
  const int* pred;
  const float* cost;
  const float* rate;
  int ia, ib;
};

// The outputs, [L, B, ...] in list order.
struct MergeOut {
  int* mv;
  int* ridx;
  int* pred;
  float* cost;
  float* rate;
};

template <int N>
struct MergeCfg {
  static constexpr int S = (N / 8) * (N / 8);      // 8x8 sub-blocks
  static constexpr int SEG = N / 8;                // 8-sample row segments
  static constexpr int P = N == 8 ? 8 : (N == 16 ? 4 : 1);   // blocks a CTA
  static constexpr int kThreads = N == 8 ? 128 : 256;
  static constexpr int WW = N + 7;                 // window side
  static constexpr int kWin = WW * WW;   // the window, then the prediction
  static constexpr int kCand = kWin + WW * N;      // + the horizontal pass
  static constexpr int kBlock = N * N + 2 * kCand; // source, 2 candidates
  // the SATD stage runs every lane on every pass
  static_assert((P * 2 * S * 8) % kThreads == 0, "whole passes");
};

template <int N>
__global__ void __launch_bounds__(MergeCfg<N>::kThreads)
    mc_merge_kernel(const int* __restrict__ src, const int* __restrict__ refs,
                    const int* __restrict__ base, MergeList l0, MergeList l1,
                    MergeOut out, int B, int H, int W, int tier, int tier_w,
                    int edge_col, float ls2) {
  using C = MergeCfg<N>;
  extern __shared__ __align__(16) int msm[];
  __shared__ int taps[32];
  __shared__ int c_mv[C::P][2][2];   // candidate MV (x, y), quarter pels
  __shared__ int c_org[C::P][2][2];  // its window's origin (y, x), unclamped
  __shared__ int c_ref[C::P][2];     // its list-relative ref index
  __shared__ int c_sel[C::P][2];     // the state reference it picks
  __shared__ int c_valid[C::P][2];
  __shared__ int c_satd[C::P][2];
  __shared__ int b_org[C::P][2];     // the block's origin (y, x)
  __shared__ int winner[C::P];       // 0 the ME winner, 1 left, 2 top
  const int tid = threadIdx.x;
  const int l = blockIdx.y;
  const MergeList L = l == 0 ? l0 : l1;
  const int b0 = blockIdx.x * C::P;
  const int nb = min(C::P, B - b0);
  const int gx = W / N;

  // the fold's inputs, read while the candidates are computed
  float me_cost = 0.0f, me_rate = 0.0f;
  int me_x = 0, me_y = 0, me_ref = 0;
  if (tid < nb) {
    const int b = b0 + tid;
    me_cost = L.cost[b];
    me_rate = L.rate[b];
    me_x = L.mv[2 * b];
    me_y = L.mv[2 * b + 1];
    me_ref = L.ridx[b];
  }
  if (tid < 32) taps[tid] = kLuma[tid / 8][tid % 8];
  if (tid < 2 * C::P) {
    const int j = tid >> 1, k = tid & 1;
    const int b = min(b0 + j, B - 1);   // past the end: a copy, not written
    const int by = b / gx, bx = b - by * gx;
    int nbr = -1;                       // the neighbour, -1 for none
    if (k == 0) {
      if (bx > 0 && bx != edge_col) nbr = b - 1;
    } else if (by > 0) {
      nbr = b - gx;
    }
    const int mx = nbr >= 0 ? L.mv[2 * nbr] : 0;
    const int my = nbr >= 0 ? L.mv[2 * nbr + 1] : 0;
    const int cref = nbr >= 0 ? L.ridx[nbr] : 0;
    const int sel = cref > 0 ? L.ib : L.ia;
    const int oy = by * N, ox = bx * N;
    const int bt = (H / tier) * (W / tier);
    const int parent = (oy / tier) * (W / tier) + ox / tier;
    const int tbx = base[((size_t)sel * bt + parent) * 2];
    const int tby = base[((size_t)sel * bt + parent) * 2 + 1];
    const int rs = (my >> 2) - tby + oy % tier + 4;
    const int cs = (mx >> 2) - tbx + ox % tier + 4;
    const int lim = tier_w - (N + 7);
    c_mv[j][k][0] = mx;
    c_mv[j][k][1] = my;
    c_org[j][k][0] = oy + (my >> 2) - 3;
    c_org[j][k][1] = ox + (mx >> 2) - 3;
    c_ref[j][k] = cref;
    c_sel[j][k] = sel;
    c_valid[j][k] = rs >= 0 && rs <= lim && cs >= 0 && cs <= lim;
    c_satd[j][k] = 0;
    if (k == 0) {
      b_org[j][0] = oy;
      b_org[j][1] = ox;
    }
  }
  __syncthreads();
  batched_copy<C::kThreads>(
      C::P * N * N, tid,
      [&](int i) {
        const int j = i / (N * N), p = i - j * (N * N);
        return src[(size_t)(b_org[j][0] + p / N) * W + b_org[j][1] + p % N];
      },
      [&](int i, int v) {
        const int j = i / (N * N);
        msm[j * C::kBlock + i - j * (N * N)] = v;
      });
  // each candidate's window: the block's origin + the integer MV - 3
  batched_copy<C::kThreads>(
      C::P * 2 * C::kWin, tid,
      [&](int i) {
        const int jk = i / C::kWin, p = i - jk * C::kWin;
        const int j = jk >> 1, k = jk & 1;
        const int row = p / C::WW, col = p - row * C::WW;
        const int yy = min(max(c_org[j][k][0] + row, 0), H - 1);
        const int xx = min(max(c_org[j][k][1] + col, 0), W - 1);
        return refs[(size_t)c_sel[j][k] * H * W + (size_t)yy * W + xx];
      },
      [&](int i, int v) {
        const int jk = i / C::kWin;
        msm[(jk >> 1) * C::kBlock + N * N + (jk & 1) * C::kCand + i -
            jk * C::kWin] = v;
      });
  __syncthreads();
  // horizontal pass: a thread per (block, candidate, row, 8-sample segment)
  for (int i = tid; i < C::P * 2 * C::WW * C::SEG; i += blockDim.x) {
    const int seg = i % C::SEG;
    int rest = i / C::SEG;
    const int row = rest % C::WW;
    rest /= C::WW;
    const int k = rest & 1, j = rest >> 1;
    int* cand = msm + j * C::kBlock + N * N + k * C::kCand;
    const int fx = c_mv[j][k][0] & 3;
    int t[8], wv[15];
#pragma unroll
    for (int q = 0; q < 8; ++q) t[q] = taps[fx * 8 + q];
    const int* w = cand + row * C::WW + seg * 8;
#pragma unroll
    for (int q = 0; q < 15; ++q) wv[q] = w[q];
    int* h = cand + C::kWin + row * N + seg * 8;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      int acc = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) acc += t[q] * wv[x + q];
      h[x] = acc;
    }
  }
  __syncthreads();
  // vertical pass and SATD: 8 lanes per (block, candidate, sub-block), a
  // lane a column
  for (int i = tid; i < C::P * 2 * C::S * 8; i += blockDim.x) {
    const int c = i & 7;
    int rest = i >> 3;
    const int s = rest % C::S;
    rest /= C::S;
    const int k = rest & 1, j = rest >> 1;
    int* cand = msm + j * C::kBlock + N * N + k * C::kCand;
    const int fy = c_mv[j][k][1] & 3;
    int t[8], col[15], d[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) t[q] = taps[fy * 8 + q];
    const int sy = s / C::SEG, sx = s - sy * C::SEG;
    const int x = sx * 8 + c;
    const int* h = cand + C::kWin + sy * 8 * N + x;
#pragma unroll
    for (int q = 0; q < 15; ++q) col[q] = h[q * N];
    const int* sp = msm + j * C::kBlock + sy * 8 * N + x;
    int* pp = cand + sy * 8 * N + x;   // over the spent window
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      int acc = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) acc += t[q] * col[y + q];
      const int pred = min(max(((acc >> 6) + 32) >> 6, 0), 255);
      pp[y * N] = pred;
      d[y] = sp[y * N] - pred;
    }
    const int v = satd8_lanes(d, c);
    if (c == 0) atomicAdd(&c_satd[j][k], v);
  }
  __syncthreads();
  // the fold: left, then top, by strict <
  if (tid < nb) {
    const int j = tid;
    const size_t o = (size_t)l * B + b0 + j;
    float cost = me_cost, rate = me_rate;
    int mx = me_x, my = me_y, rid = me_ref, win = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float ck = c_valid[j][k]
                           ? __fadd_rn(__int2float_rn(c_satd[j][k]), ls2)
                           : __int_as_float(0x7f800000);
      if (ck < cost) {
        cost = ck;
        mx = c_mv[j][k][0];
        my = c_mv[j][k][1];
        rid = c_ref[j][k];
        rate = 2.0f;
        win = k + 1;
      }
    }
    out.cost[o] = cost;
    out.rate[o] = rate;
    out.mv[2 * o] = mx;
    out.mv[2 * o + 1] = my;
    out.ridx[o] = rid;
    winner[j] = win;
  }
  __syncthreads();
  int* pout = out.pred + ((size_t)l * B + b0) * N * N;
  const int* pin = L.pred + (size_t)b0 * N * N;
  batched_copy<C::kThreads>(
      nb * N * N, tid,
      [&](int i) {
        const int j = i / (N * N), w = winner[j];
        return w == 0 ? pin[i]
                      : msm[j * C::kBlock + N * N + (w - 1) * C::kCand + i -
                            j * (N * N)];
      },
      [&](int i, int v) { pout[i] = v; });
}

template <int N>
int launch_merge(const int* src, const int* refs, const int* base,
                 const MergeList& l0, const MergeList& l1, const MergeOut& out,
                 int L, int H, int W, int tier, int tier_w, int edge_col,
                 float ls2, cudaStream_t stream) {
  using C = MergeCfg<N>;
  const int smem = (int)sizeof(int) * C::P * C::kBlock;
  // the opt-in above 48 KB belongs to the current device: set it on every
  // launch
  cudaError_t err = cudaFuncSetAttribute(
      mc_merge_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int B = (H / N) * (W / N);
  dim3 grid((B + C::P - 1) / C::P, L);
  mc_merge_kernel<N><<<grid, C::kThreads, smem, stream>>>(
      src, refs, base, l0, l1, out, B, H, W, tier, tier_w, edge_col, ls2);
  return (int)cudaGetLastError();
}

}  // namespace

// refs [R, H, W], base [R, Bt, 2] (x, y) tier bases, mvq [B, 2] quarter
// pels, sel [B] ref index; raw [B, n, n], valid [B] (0/1).
extern "C" int fhv_mc_sel(const int* refs, const int* base, const int* mvq,
                          const int* sel, int* raw, int* valid, int R, int H,
                          int W, int n, int tier, int tier_w,
                          cudaStream_t stream) {
  const long long total = (long long)(H / n) * (W / n) * n * n;
  if (R <= 0 || total <= 0) return 0;
  const unsigned grid = (unsigned)((total + 255) / 256);
  mc_sel_kernel<<<grid, 256, 0, stream>>>(refs, base, mvq, sel, raw, valid,
                                          total, H, W, n, tier, tier_w);
  return (int)cudaGetLastError();
}

// ref0 [F, R0, H, W], ref1 [F, R1, H, W] or NULL, dir [F, gh, gw], mv [F,
// gh, gw, 4], rmap [F, gh, gw, 2] or NULL; out [F, H, W].
extern "C" int fhv_inter_pred(const int* ref0, const int* ref1,
                              const int* dir, const int* mv, const int* rmap,
                              int* out, int F, int R0, int R1, int H, int W,
                              int chroma, int bit_depth,
                              cudaStream_t stream) {
  const long long total = (long long)F * H * W;
  if (total <= 0) return 0;
  const unsigned grid = (unsigned)((total + 255) / 256);
  inter_pred_kernel<<<grid, 256, 0, stream>>>(ref0, ref1, dir, mv, rmap, out,
                                              total, R0, R1, H, W, chroma,
                                              bit_depth);
  return (int)cudaGetLastError();
}

// src [H, W], refs [R, H, W], base [R, Bt, 2] (x, y) the tier's bases; per
// list l (l = 0, and 1 when L == 2, else NULL): mv [B, 2], ridx [B], pred
// [B, n, n], cost and rate [B] f32 of the ME winners, state refs ia, ib;
// out_* [L, B, ...] the folded (mv, ridx, pred, cost, rate).  edge_col:
// the block column whose left neighbour is the picture's edge inside a
// shard, or -1; ls2 = 2 * lambda_sqrt in f32.
extern "C" int fhv_mc_merge(
    const int* src, const int* refs, const int* base, const int* mv0,
    const int* ridx0, const int* pred0, const float* cost0,
    const float* rate0, const int* mv1, const int* ridx1, const int* pred1,
    const float* cost1, const float* rate1, int* out_mv, int* out_ridx,
    int* out_pred, float* out_cost, float* out_rate, int L, int ia0, int ib0,
    int ia1, int ib1, int H, int W, int n, int tier, int tier_w,
    int edge_col, float ls2, cudaStream_t stream) {
  if (L <= 0 || H < n || W < n) return 0;
  const MergeList l0{mv0, ridx0, pred0, cost0, rate0, ia0, ib0};
  const MergeList l1 = L > 1 ? MergeList{mv1, ridx1, pred1, cost1, rate1,
                                         ia1, ib1}
                             : l0;
  const MergeOut out{out_mv, out_ridx, out_pred, out_cost, out_rate};
  switch (n) {
    case 8:
      return launch_merge<8>(src, refs, base, l0, l1, out, L, H, W, tier,
                             tier_w, edge_col, ls2, stream);
    case 16:
      return launch_merge<16>(src, refs, base, l0, l1, out, L, H, W, tier,
                              tier_w, edge_col, ls2, stream);
    case 32:
      return launch_merge<32>(src, refs, base, l0, l1, out, L, H, W, tier,
                              tier_w, edge_col, ls2, stream);
    case 64:
      return launch_merge<64>(src, refs, base, l0, l1, out, L, H, W, tier,
                              tier_w, edge_col, ls2, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
