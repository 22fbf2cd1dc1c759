// K11: exact motion compensation.
//
// Replaces fasthevc_tpu/ops/me.py _mc_raw_blocks (:447) and what runs on it:
// mc_blocks (:435), inter_pred_planes (:508), and the tier-window MC of the
// merge candidates, _tier_view (:613), _mc_raw_windows (:630) and
// mc_raw_from_state(_sel) (:656, :671).  Two entry points, one thread per
// output sample, each sample the spec's separable interpolation on the
// edge-clamped reference (8.5.4.2.2: horizontal taps >> (bit_depth - 8),
// vertical taps >> 6; the zero-phase tap row reproduces the copy and
// one-direction cases exactly):
//   * fhv_mc_sel: the raw 14-bit luma prediction of every n-block of
//     refs[sel[b]] at its quarter-pel MV, and `valid`, the reference's
//     window test (me.py:642-645): the MV's integer part lies within the
//     tier window gathered around that ref's base for the block's tier.
//     Invalid candidates are priced out by the caller.
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
// Bound on the H100: bytes (~50 MB per 1080p frame for the three planes).
// The separable filter needs (n + 7) * n + n * n 8-tap filters per luma
// n-block (23 multiply-adds a sample at n = 8; 11 a chroma sample at 4x4),
// about 0.1 G operations per frame.  Design: one thread per sample
// recomputes its 8 horizontal rows (72 multiply-adds a luma sample, three
// times the separable work), reading through L1/L2.

#include <cuda_runtime.h>

#include "mc_common.cuh"

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
