// K6: in-loop deblocking of intra pictures (spec 8.7.2), one direction.
//
// Replaces fasthevc_tpu/ops/deblock.py deblock_device (:236) for the
// all-intra case, with edge_masks_device (:25), _filter_vert_luma (:49)
// and _filter_vert_chroma (:133).  Called twice per frame batch: all
// vertical edges, then all horizontal edges (the spec's order; the
// reference does the horizontal pass through a transpose).  One thread
// per 4-sample edge segment, luma and both chroma planes in one launch:
// the segment's CU/TU edge flag comes from the depth map (every CU/TU edge
// of an intra picture has BS 2; chroma edges lie on the 16-luma grid), the
// decisions and filters are the spec's integer formulas, and the thread
// writes the samples it changes into `out`, which the caller initialises
// with a copy of `in` — so each pass reads exactly what the reference's
// pass reads.  Same-direction edges are 8 luma samples apart, so no two
// segments touch the same samples.
//
// Bound on the H100: device-memory traffic, about 8 samples read per 6
// written per segment over a ~66 MB int32 luma plane per 8 1080p frames.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// CU/TU edge on the left (vertical) or top (horizontal) of granule
// coordinate g (8-sample units), CU size `size`, max TU 32
__device__ __forceinline__ bool tu_edge(int g, int size) {
  const int max_tu = 32;
  const int pos = g * 8;
  return (pos % size) == 0 ||
         ((pos % min(size, max_tu)) == 0 && size > max_tu);
}

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return min(max(v, lo), hi);
}

// One 4-line luma segment: q0 of line i sits at base + i*ls, its k-th
// neighbour across the edge at base + i*ls + k*ns (k = -4..3).
__device__ void luma_segment(const int* in, int* out, size_t base, int ls,
                             int ns, int beta, int tc, int max_val) {
  int P[4][4], Q[4][4];
  for (int i = 0; i < 4; ++i)
    for (int k = 0; k < 4; ++k) {
      P[i][k] = in[base + (long long)i * ls - (long long)(k + 1) * ns];
      Q[i][k] = in[base + (long long)i * ls + (long long)k * ns];
    }
  int dp[4], dq[4];
  for (int i = 0; i < 4; ++i) {
    dp[i] = abs(P[i][2] - 2 * P[i][1] + P[i][0]);
    dq[i] = abs(Q[i][2] - 2 * Q[i][1] + Q[i][0]);
  }
  const int d = (dp[0] + dq[0]) + (dp[3] + dq[3]);
  if (d >= beta) return;
  bool strong = true;
  for (int i = 0; i < 4; i += 3)
    strong = strong && 2 * (dp[i] + dq[i]) < (beta >> 2) &&
             abs(P[i][3] - P[i][0]) + abs(Q[i][0] - Q[i][3]) < (beta >> 3) &&
             abs(P[i][0] - Q[i][0]) < ((5 * tc + 1) >> 1);
  const int side = (beta + (beta >> 1)) >> 3;
  const bool dEp = (dp[0] + dp[3]) < side, dEq = (dq[0] + dq[3]) < side;
  const int tc2 = tc >> 1;
  for (int i = 0; i < 4; ++i) {
    const int p0 = P[i][0], p1 = P[i][1], p2 = P[i][2], p3 = P[i][3];
    const int q0 = Q[i][0], q1 = Q[i][1], q2 = Q[i][2], q3 = Q[i][3];
    int np0 = p0, np1 = p1, np2 = p2, nq0 = q0, nq1 = q1, nq2 = q2;
    if (strong) {
      np0 = clip3(0, max_val, clip3(p0 - 2 * tc, p0 + 2 * tc,
                  (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3));
      np1 = clip3(0, max_val, clip3(p1 - 2 * tc, p1 + 2 * tc,
                  (p2 + p1 + p0 + q0 + 2) >> 2));
      np2 = clip3(0, max_val, clip3(p2 - 2 * tc, p2 + 2 * tc,
                  (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3));
      nq0 = clip3(0, max_val, clip3(q0 - 2 * tc, q0 + 2 * tc,
                  (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3));
      nq1 = clip3(0, max_val, clip3(q1 - 2 * tc, q1 + 2 * tc,
                  (q2 + q1 + q0 + p0 + 2) >> 2));
      nq2 = clip3(0, max_val, clip3(q2 - 2 * tc, q2 + 2 * tc,
                  (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3));
    } else {
      const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (abs(delta) < 10 * tc) {
        const int dlt = clip3(-tc, tc, delta);
        np0 = clip3(0, max_val, p0 + dlt);
        nq0 = clip3(0, max_val, q0 - dlt);
        if (dEp)
          np1 = clip3(0, max_val,
                      p1 + clip3(-tc2, tc2,
                                 (((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1));
        if (dEq)
          nq1 = clip3(0, max_val,
                      q1 + clip3(-tc2, tc2,
                                 (((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1));
      }
    }
    const size_t at = base + (long long)i * ls;
    out[at - 3LL * ns] = np2;
    out[at - 2LL * ns] = np1;
    out[at - 1LL * ns] = np0;
    out[at] = nq0;
    out[at + 1LL * ns] = nq1;
    out[at + 2LL * ns] = nq2;
  }
}

__device__ void chroma_segment(const int* in, int* out, size_t base, int ls,
                               int ns, int tc, int max_val) {
  for (int i = 0; i < 4; ++i) {
    const size_t at = base + (long long)i * ls;
    const int p1 = in[at - 2LL * ns], p0 = in[at - 1LL * ns];
    const int q0 = in[at], q1 = in[at + 1LL * ns];
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + p1 - q1 + 4) >> 3);
    out[at - 1LL * ns] = clip3(0, max_val, p0 + delta);
    out[at] = clip3(0, max_val, q0 - delta);
  }
}

__global__ void deblock_kernel(const int* __restrict__ in_y,
                               const int* __restrict__ in_cb,
                               const int* __restrict__ in_cr,
                               int* __restrict__ out_y,
                               int* __restrict__ out_cb,
                               int* __restrict__ out_cr,
                               const int* __restrict__ depth,
                               const int* __restrict__ beta_tab,
                               const int* __restrict__ tc_tab, int F, int H,
                               int W, int log2_ctu, int qp, int qp_cb,
                               int qp_cr, int bit_depth, int dir) {
  const int gh = H >> 3, gw = W >> 3;
  const int hc = H >> 1, wc = W >> 1;
  // segments per frame: luma (4-line segments x edge positions), chroma
  const long long n_luma = dir == 0 ? (long long)(H >> 2) * gw
                                    : (long long)(W >> 2) * gh;
  const long long n_chroma = (long long)gh * gw;  // 4-line chroma segments
  const long long per_frame = n_luma + 2 * n_chroma;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per_frame * F) return;
  const int f = (int)(idx / per_frame);
  long long j = idx - (long long)f * per_frame;
  const int max_val = (1 << bit_depth) - 1;
  const int* dm = depth + (size_t)f * gh * gw;
  if (j < n_luma) {
    // segment r of 4 lines along the edge, edge c (8-sample units)
    const int n_edges = dir == 0 ? gw : gh;
    const int r = (int)(j / n_edges), c = (int)(j - (long long)r * n_edges);
    if (c == 0) return;  // picture boundary
    const int gy = dir == 0 ? r >> 1 : c, gx = dir == 0 ? c : r >> 1;
    const int size = (1 << log2_ctu) >> dm[gy * gw + gx];
    if (!tu_edge(c, size)) return;
    const int beta = beta_tab[min(max(qp, 0), 51)];
    const int tc = tc_tab[min(max(qp + 2, 0), 53)];
    const size_t fb = (size_t)f * H * W;
    if (dir == 0)
      luma_segment(in_y + fb, out_y + fb, (size_t)(4 * r) * W + 8 * c, W, 1,
                   beta, tc, max_val);
    else
      luma_segment(in_y + fb, out_y + fb, (size_t)(8 * c) * W + 4 * r, 1, W,
                   beta, tc, max_val);
    return;
  }
  j -= n_luma;
  const int plane = j < n_chroma ? 1 : 2;
  if (plane == 2) j -= n_chroma;
  // chroma segment: 4 chroma lines, edge every 4 chroma samples (8 luma),
  // filtered on the 16-luma grid only
  const int n_edges = dir == 0 ? gw : gh;
  const int r = (int)(j / n_edges), c = (int)(j - (long long)r * n_edges);
  if (c == 0 || (c & 1)) return;
  const int gy = dir == 0 ? r : c, gx = dir == 0 ? c : r;
  const int size = (1 << log2_ctu) >> dm[gy * gw + gx];
  if (!tu_edge(c, size)) return;
  const int qpc = plane == 1 ? qp_cb : qp_cr;
  const int tc = tc_tab[min(max(qpc + 2, 0), 53)];
  const size_t fb = (size_t)f * hc * wc;
  const int* in = (plane == 1 ? in_cb : in_cr) + fb;
  int* out = (plane == 1 ? out_cb : out_cr) + fb;
  if (dir == 0)
    chroma_segment(in, out, (size_t)(4 * r) * wc + 4 * c, wc, 1, tc,
                   max_val);
  else
    chroma_segment(in, out, (size_t)(4 * c) * wc + 4 * r, 1, wc, tc,
                   max_val);
}

}  // namespace

extern "C" int fhv_deblock(const int* in_y, const int* in_cb,
                           const int* in_cr, int* out_y, int* out_cb,
                           int* out_cr, const int* depth, const int* beta_tab,
                           const int* tc_tab, int F, int H, int W,
                           int log2_ctu, int qp, int qp_cb, int qp_cr,
                           int bit_depth, int dir, cudaStream_t stream) {
  if (F <= 0) return 0;
  const long long gh = H >> 3, gw = W >> 3;
  const long long n_luma = dir == 0 ? (H >> 2) * gw : (W >> 2) * gh;
  const long long total = (n_luma + 2 * gh * gw) * F;
  const long long grid = (total + kThreads - 1) / kThreads;
  deblock_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
      in_y, in_cb, in_cr, out_y, out_cb, out_cr, depth, beta_tab, tc_tab, F,
      H, W, log2_ctu, qp, qp_cb, qp_cr, bit_depth, dir);
  return (int)cudaGetLastError();
}
