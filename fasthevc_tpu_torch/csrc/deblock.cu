// K6: in-loop deblocking (spec 8.7.2).
//
// Replaces fasthevc_tpu/ops/deblock.py deblock_device (:236), with
// edge_masks_device (:25), _filter_vert_luma (:49), _filter_vert_chroma
// (:133) and, for P/B pictures, tu_cbf_map (:154) and inter_bs_maps
// (:177).  Two forms: the one-launch form (fhv_deblock_fused, with its
// own note below), which the routes launch, and the earlier form
// described here, one direction a launch.  The earlier form is called
// twice per frame batch: all vertical edges, then all
// horizontal edges (the spec's order; the reference does the horizontal
// pass through a transpose).  One thread per 4-sample edge segment, luma
// and both chroma planes in one launch: the segment's CU/TU edge flag
// comes from the depth map (chroma edges lie on the 16-luma grid), its
// boundary strength is 2 on intra pictures and, on P/B pictures, worked
// out from the granule maps of its two sides: 2 if either is intra, else 1
// if either CU has a nonzero luma level, the sides' per-list reference
// vectors differ (-1 for an unused list) or an MV component differs by a
// whole sample (MVs of unused lists zeroed), else 0.  A chroma edge is
// filtered only where the luma strength is 2.  The decisions and filters
// are the spec's integer formulas, and the thread writes the samples it
// changes into `out`, which the caller initialises with a copy of `in` —
// so each pass reads exactly what the reference's pass reads.
// Same-direction edges are 8 luma samples apart, so no two segments touch
// the same samples.  fhv_deblock_cbf, launched once before the two passes
// of a P/B batch, marks each 8x8 granule with its CU's luma cbf
// (tu_cbf_map, :154), which the strengths read.
//
// The tile-column form (fasthevc_tpu/parallel/sharded.py
// _deblock_sharded_cols, :67) runs the same kernel on a tile's planes
// extended by 8 luma columns of each neighbour (K16), with the maps
// extended by one granule column: x0 is the global luma column of the
// plane's first column and pic_w the picture's coded width, so a vertical
// edge is filtered iff its global column gx is inside (0, pic_w), on the
// CU/TU grid and, for chroma, on the 16-luma grid (:94-101, :115).  The
// caller keeps the tile's own columns.
//
// Bound on the H100: device-memory traffic, about 8 samples read per 6
// written per segment over a ~66 MB int32 luma plane per 8 1080p frames.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// CU/TU edge at luma position pos (a multiple of 8) on the left
// (vertical) or top (horizontal) of a granule, CU size `size`, max TU 32
__device__ __forceinline__ bool tu_edge(int pos, int size) {
  const int max_tu = 32;
  return (pos % size) == 0 ||
         ((pos % min(size, max_tu)) == 0 && size > max_tu);
}

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return min(max(v, lo), hi);
}

// The P/B picture's granule maps (any may be NULL on an intra picture).
struct Maps {
  const int* dir;   // [F][gh][gw]
  const int* mv;    // [F][gh][gw][4]
  const int* ref;   // [F][gh][gw][2] or NULL (index 0)
  const int* cbf;   // [F][gh][gw] the granule's CU's luma cbf
};

// Boundary strength between granules p and q (spec 8.7.2.4, as the
// reference's inter_bs_maps); m's pointers are offset to the frame.
__device__ int seg_bs(const Maps& m, int gw, int py, int px, int qy,
                      int qx) {
  if (m.dir == nullptr) return 2;
  const int gp = py * gw + px, gq = qy * gw + qx;
  const int dp = m.dir[gp], dq = m.dir[gq];
  if (dp == 0 || dq == 0) return 2;
  if (m.cbf[gp] || m.cbf[gq]) return 1;
  for (int l = 0; l < 2; ++l) {
    const int use_p = (dp >> l) & 1, use_q = (dq >> l) & 1;
    const int rp = use_p ? (m.ref ? m.ref[gp * 2 + l] : 0) : -1;
    const int rq = use_q ? (m.ref ? m.ref[gq * 2 + l] : 0) : -1;
    if (rp != rq) return 1;
    for (int c = 0; c < 2; ++c) {
      const int vp = use_p ? m.mv[gp * 4 + 2 * l + c] : 0;
      const int vq = use_q ? m.mv[gq * 4 + 2 * l + c] : 0;
      if (abs(vp - vq) >= 4) return 1;
    }
  }
  return 0;
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

template <typename T>
__device__ void chroma_segment(const T* in, T* out, size_t base, int ls,
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

// Luma cbf of each granule: any nonzero level in its CU; a CU that
// overflows the granule grid reads 0, as the reference's pooling does.
__global__ void cbf_kernel(const short* __restrict__ lv,
                           const int* __restrict__ depth,
                           int* __restrict__ cbf, long long total, int H,
                           int W, int log2_ctu) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int gh = H >> 3, gw = W >> 3;
  const long long f = idx / ((long long)gh * gw);
  const int rem = (int)(idx - f * gh * gw);
  const int gy = rem / gw, gx = rem - gy * gw;
  const int r = ((1 << log2_ctu) >> depth[idx]) >> 3;
  const int y0 = gy / r * r, x0 = gx / r * r;
  if (y0 + r > gh || x0 + r > gw) {
    cbf[idx] = 0;
    return;
  }
  const short* p = lv + (size_t)f * H * W + (size_t)(8 * y0) * W + 8 * x0;
  int any = 0;
  for (int y = 0; y < 8 * r; ++y)
    for (int x = 0; x < 8 * r; ++x) any |= p[y * W + x];
  cbf[idx] = any != 0;
}

__global__ void deblock_kernel(const int* __restrict__ in_y,
                               const int* __restrict__ in_cb,
                               const int* __restrict__ in_cr,
                               int* __restrict__ out_y,
                               int* __restrict__ out_cb,
                               int* __restrict__ out_cr,
                               const int* __restrict__ depth, Maps maps,
                               const int* __restrict__ beta_tab,
                               const int* __restrict__ tc_tab,
                               const int* __restrict__ qps, int F, int H,
                               int W, int log2_ctu, int bit_depth, int dir,
                               int x0, int pic_w) {
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
  const size_t fg = (size_t)f * gh * gw;
  Maps m = maps;
  if (m.dir != nullptr) {
    m.dir += fg;
    m.mv += fg * 4;
    if (m.ref != nullptr) m.ref += fg * 2;
    m.cbf += fg;
  }
  const int qp = qps[3 * f], qp_cb = qps[3 * f + 1], qp_cr = qps[3 * f + 2];
  if (j < n_luma) {
    // segment r of 4 lines along the edge, edge c (8-sample units)
    const int n_edges = dir == 0 ? gw : gh;
    const int r = (int)(j / n_edges), c = (int)(j - (long long)r * n_edges);
    if (c == 0) return;  // the plane's first column or row
    // the edge's global luma position: inside the picture, on the CU/TU grid
    const int pos = dir == 0 ? x0 + 8 * c : 8 * c;
    if (dir == 0 && (pos <= 0 || pos >= pic_w)) return;
    const int gy = dir == 0 ? r >> 1 : c, gx = dir == 0 ? c : r >> 1;
    const int size = (1 << log2_ctu) >> dm[gy * gw + gx];
    if (!tu_edge(pos, size)) return;
    const int bs = dir == 0 ? seg_bs(m, gw, gy, gx - 1, gy, gx)
                            : seg_bs(m, gw, gy - 1, gx, gy, gx);
    if (bs == 0) return;
    const int beta = beta_tab[min(max(qp, 0), 51)];
    const int tc = tc_tab[min(max(qp + 2 * (bs - 1), 0), 53)];
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
  if (c == 0) return;
  const int pos = dir == 0 ? x0 + 8 * c : 8 * c;
  if ((pos & 15) || (dir == 0 && (pos <= 0 || pos >= pic_w))) return;
  const int gy = dir == 0 ? r : c, gx = dir == 0 ? c : r;
  const int size = (1 << log2_ctu) >> dm[gy * gw + gx];
  if (!tu_edge(pos, size)) return;
  if (m.dir != nullptr &&
      (dir == 0 ? seg_bs(m, gw, gy, gx - 1, gy, gx)
                : seg_bs(m, gw, gy - 1, gx, gy, gx)) != 2)
    return;
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


// ---- The one-launch form (fhv_deblock_fused) and its CU cbf pass ----
//
// The picture is cut into 32x32 luma tiles (cores), each with the two
// 16x16 chroma tiles under it.  A tile is filtered from a shared-memory
// copy of its core with a halo of 4 samples on each side, 40x40 luma and
// 24x24 chroma: every vertical edge that writes into the core (the luma
// edges at the core's columns 0, 8, .., 32, on all 40 rows; the chroma
// edges at its columns 0, 4, .., 16 that lie on the 16-luma grid, on all
// 24 rows), then, after a barrier, every horizontal edge that writes into
// the core (rows 0, 8, .., 32, on the core's columns only), and the core
// is written once into a fresh output.  Why that equals the spec's order
// (every vertical edge of the picture, then every horizontal one):
//  - a luma filter reads 4 samples each side of its edge and writes 3,
//    edges of one direction are 8 apart, and the 4-line segments are
//    4-aligned, so the vertical filters are independent of each other and
//    the ones above are exactly those that change a sample of the 40 rows
//    in the core's columns;
//  - the horizontal pass over the core's columns reads rows -4 .. 35 of
//    the tile, all of which have been filtered vertically, in whole
//    segments, and only the horizontal edges at rows 0 .. 32 write into
//    the core;
//  - chroma reads 2 and writes 1 each side of edges 4 apart (its 16-luma
//    grid is a subset of those), so the 4-sample halo is more than enough;
//  - two neighbouring tiles both compute the edge between them, from the
//    same samples, and each writes only its own side.
// Rows and columns outside the plane load as 0 and are never read by an
// edge that is filtered: the plane's first row and column carry no edge,
// and no edge lies at or beyond its last.  Cores that overhang the plane
// (1080 rows are 33.75 tiles) are clipped at the write.
//
// A CTA takes one tile.  Its pixels and the 6x6 granule window of its
// maps (the depths and, on P/B pictures, the directions, CU cbf, reference
// indices and MVs) come into shared memory by cp.async (16-byte copies,
// zero-filled outside the plane, no registers held), so 10 CTAs fit on an
// SM and keep its loads in flight while others filter (at 12, 40
// registers spill and it runs slower); the halos of neighbouring tiles
// come from L2.  The tile's edge flags and boundary
// strengths (one per granule pair: a chroma edge needs luma BS 2) are
// worked out from the window, so the filter passes read no device memory.
// A luma segment moves between shared memory and registers as 16-byte
// rows; the rows are padded by 4 samples and the horizontal pass gives a
// warp's lanes neighbouring columns, which keeps those accesses free of
// bank conflicts.  (A persistent form that prefetched the next tile into a
// second buffer was no faster, and 32x32 to 128x16 tiles copy the planes
// at the same rate: PERF.md §6.)
//
// The tile-column form uses the same kernel: the tiles are laid on the
// extended plane's own columns and the edge tests run on global columns,
// as in deblock_kernel.  The per-frame QPs of up to 8 frames travel in a
// by-value argument (the host entry launches once a group of 8 frames),
// so a call copies nothing to the card.  The input planes may be row
// crops of padded ones (a row pitch and a frame stride each, both
// multiples of 4 samples), as the commit leaves them.
//
// Bound on the H100: device-memory traffic, the planes read once and
// written once (int32, 8 bytes a sample); the halo rereads (1.79x of the
// core's samples) mostly hit L2.  The filter arithmetic is ~120 int
// operations a segment, far under the int32 peak.

constexpr int kTile = 32;                  // luma core
constexpr int kHalo = 4;
constexpr int kLT = kTile + 2 * kHalo;     // 40: the luma tile's side
constexpr int kCT = kTile / 2 + 2 * kHalo;  // 24: the chroma tile's side
constexpr int kWin = kTile / 8 + 2;        // 6: the granule window's side
constexpr int kLP = kLT + 4, kCP = kCT + 4;  // padded row pitches
constexpr int kFusedThreads = 128;
constexpr int kFusedPerSM = 10;            // CTAs an SM (48 registers)
constexpr int kQpFrames = 8;               // frames a launch
constexpr int kCbfThreads = 128;

struct QpTab {
  int v[3 * kQpFrames];  // [frame][deblocking QP, Cb QP, Cr QP]
};

// The input planes' layout: row pitch and frame stride (samples).
struct PlaneLayout {
  long long fs[3];
  int pitch[3];
};

// One tile's shared-memory copy: the pixels and the granule window
// (granule rows and columns -1 .. 4 of the tile).
struct TileBuf {
  int y[kLT][kLP];
  int c[2][kCT][kCP];
  int depth[kWin][kWin];
  int dir[kWin][kWin];
  int cbf[kWin][kWin];
  int2 ref[kWin][kWin];
  int4 mv[kWin][kWin];
};

// cp.async of 16, 8 or 4 bytes into shared memory; `bytes` 0 zero-fills
// the destination without reading `src`.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// One 4-line luma segment in registers: P[i][k], Q[i][k] is line i's
// k-th sample from the edge on the p (q) side; filters it in place when
// the segment's decision says so (spec 8.7.2.5.3/.6-.7, the arithmetic
// of luma_segment).  Returns false when the segment is left unfiltered.
__device__ __forceinline__ bool luma_lines(int (&P)[4][4], int (&Q)[4][4],
                                           int beta, int tc, int max_val) {
  int dp[4], dq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dp[i] = abs(P[i][2] - 2 * P[i][1] + P[i][0]);
    dq[i] = abs(Q[i][2] - 2 * Q[i][1] + Q[i][0]);
  }
  if ((dp[0] + dq[0]) + (dp[3] + dq[3]) >= beta) return false;
  const bool strong =
      2 * (dp[0] + dq[0]) < (beta >> 2) &&
      abs(P[0][3] - P[0][0]) + abs(Q[0][0] - Q[0][3]) < (beta >> 3) &&
      abs(P[0][0] - Q[0][0]) < ((5 * tc + 1) >> 1) &&
      2 * (dp[3] + dq[3]) < (beta >> 2) &&
      abs(P[3][3] - P[3][0]) + abs(Q[3][0] - Q[3][3]) < (beta >> 3) &&
      abs(P[3][0] - Q[3][0]) < ((5 * tc + 1) >> 1);
  const int side = (beta + (beta >> 1)) >> 3;
  const bool dEp = (dp[0] + dp[3]) < side, dEq = (dq[0] + dq[3]) < side;
  const int tc2 = tc >> 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p0 = P[i][0], p1 = P[i][1], p2 = P[i][2], p3 = P[i][3];
    const int q0 = Q[i][0], q1 = Q[i][1], q2 = Q[i][2], q3 = Q[i][3];
    if (strong) {
      P[i][0] = clip3(0, max_val, clip3(p0 - 2 * tc, p0 + 2 * tc,
                      (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3));
      P[i][1] = clip3(0, max_val, clip3(p1 - 2 * tc, p1 + 2 * tc,
                      (p2 + p1 + p0 + q0 + 2) >> 2));
      P[i][2] = clip3(0, max_val, clip3(p2 - 2 * tc, p2 + 2 * tc,
                      (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3));
      Q[i][0] = clip3(0, max_val, clip3(q0 - 2 * tc, q0 + 2 * tc,
                      (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3));
      Q[i][1] = clip3(0, max_val, clip3(q1 - 2 * tc, q1 + 2 * tc,
                      (q2 + q1 + q0 + p0 + 2) >> 2));
      Q[i][2] = clip3(0, max_val, clip3(q2 - 2 * tc, q2 + 2 * tc,
                      (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3));
    } else {
      const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (abs(delta) < 10 * tc) {
        const int dlt = clip3(-tc, tc, delta);
        P[i][0] = clip3(0, max_val, p0 + dlt);
        Q[i][0] = clip3(0, max_val, q0 - dlt);
        if (dEp)
          P[i][1] = clip3(0, max_val,
                          p1 + clip3(-tc2, tc2,
                                     (((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1));
        if (dEq)
          Q[i][1] = clip3(0, max_val,
                          q1 + clip3(-tc2, tc2,
                                     (((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1));
      }
    }
  }
  return true;
}

// A vertical luma edge segment: 4 rows of the tile, each 8 samples p3 ..
// q3 (two 16-byte aligned vectors) from row0 on.
__device__ void luma_vert(int* row0, int beta, int tc, int max_val) {
  int P[4][4], Q[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 a = *reinterpret_cast<const int4*>(row0 + i * kLP);
    const int4 b = *reinterpret_cast<const int4*>(row0 + i * kLP + 4);
    P[i][3] = a.x, P[i][2] = a.y, P[i][1] = a.z, P[i][0] = a.w;
    Q[i][0] = b.x, Q[i][1] = b.y, Q[i][2] = b.z, Q[i][3] = b.w;
  }
  if (!luma_lines(P, Q, beta, tc, max_val)) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<int4*>(row0 + i * kLP) =
        make_int4(P[i][3], P[i][2], P[i][1], P[i][0]);
    *reinterpret_cast<int4*>(row0 + i * kLP + 4) =
        make_int4(Q[i][0], Q[i][1], Q[i][2], Q[i][3]);
  }
}

// A horizontal luma edge segment: 4 columns of the tile (its lines), the
// 8 rows p3 .. q3 each a 16-byte aligned vector, from row0 on.
__device__ void luma_horz(int* row0, int beta, int tc, int max_val) {
  int P[4][4], Q[4][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int4 v = *reinterpret_cast<const int4*>(row0 + r * kLP);
    const int s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r < 4)
        P[i][3 - r] = s[i];
      else
        Q[i][r - 4] = s[i];
    }
  }
  if (!luma_lines(P, Q, beta, tc, max_val)) return;
#pragma unroll
  for (int r = 1; r < 7; ++r) {
    int s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = r < 4 ? P[i][3 - r] : Q[i][r - 4];
    *reinterpret_cast<int4*>(row0 + r * kLP) =
        make_int4(s[0], s[1], s[2], s[3]);
  }
}

// Boundary strength between window granules p and q (spec 8.7.2.4, as
// seg_bs), 2 on intra pictures (no maps).
__device__ int window_bs(const TileBuf& b, bool maps, int py, int px, int qy,
                         int qx) {
  if (!maps) return 2;
  const int dp = b.dir[py][px], dq = b.dir[qy][qx];
  if (dp == 0 || dq == 0) return 2;
  if (b.cbf[py][px] || b.cbf[qy][qx]) return 1;
  const int2 rp = b.ref[py][px], rq = b.ref[qy][qx];
  const int4 mp = b.mv[py][px], mq = b.mv[qy][qx];
  if (((dp & 1) ? rp.x : -1) != ((dq & 1) ? rq.x : -1) ||
      ((dp & 2) ? rp.y : -1) != ((dq & 2) ? rq.y : -1))
    return 1;
  const int4 vp = make_int4((dp & 1) ? mp.x : 0, (dp & 1) ? mp.y : 0,
                            (dp & 2) ? mp.z : 0, (dp & 2) ? mp.w : 0);
  const int4 vq = make_int4((dq & 1) ? mq.x : 0, (dq & 1) ? mq.y : 0,
                            (dq & 2) ? mq.z : 0, (dq & 2) ? mq.w : 0);
  return (abs(vp.x - vq.x) >= 4 || abs(vp.y - vq.y) >= 4 ||
          abs(vp.z - vq.z) >= 4 || abs(vp.w - vq.w) >= 4)
             ? 1
             : 0;
}

struct FusedArgs {
  const int* in[3];
  PlaneLayout lay;
  int* out[3];
  const int* depth;
  Maps maps;
  QpTab tab;
  const int* beta_tab;
  const int* tc_tab;
  int H, W, log2_ctu, bit_depth, x0, pic_w;
};

// Starts the copies of frame f's tile at (X0, Y0) into b.
__device__ void fetch_tile(const FusedArgs& a, int f, int X0, int Y0,
                           TileBuf& b) {
  const int H = a.H, W = a.W, hc = H >> 1, wc = W >> 1;
  const int gh = H >> 3, gw = W >> 3;
  constexpr int kLumaVecs = kLT * (kLT / 4), kChromaVecs = kCT * (kCT / 4);
  for (int i = threadIdx.x; i < kLumaVecs + 2 * kChromaVecs;
       i += blockDim.x) {
    if (i < kLumaVecs) {
      const int r = i / (kLT / 4), v = i - r * (kLT / 4);
      const int py = Y0 - kHalo + r, px = X0 - kHalo + 4 * v;
      const bool in = py >= 0 && py < H && px >= 0 && px < W;
      cp_async16(&b.y[r][4 * v],
                 in ? a.in[0] + f * a.lay.fs[0] +
                          (size_t)py * a.lay.pitch[0] + px
                    : a.in[0],
                 in ? 16 : 0);
    } else {
      const int j = i - kLumaVecs;
      const int p = j / kChromaVecs, q = j - p * kChromaVecs;
      const int r = q / (kCT / 4), v = q - r * (kCT / 4);
      const int py = (Y0 >> 1) - kHalo + r, px = (X0 >> 1) - kHalo + 4 * v;
      const bool in = py >= 0 && py < hc && px >= 0 && px < wc;
      const int* base = a.in[1 + p];
      cp_async16(&b.c[p][r][4 * v],
                 in ? base + f * a.lay.fs[1 + p] +
                          (size_t)py * a.lay.pitch[1 + p] + px
                    : base,
                 in ? 16 : 0);
    }
  }
  const bool maps = a.maps.dir != nullptr;
  const size_t fg = (size_t)f * gh * gw;
  for (int i = threadIdx.x; i < kWin * kWin * (maps ? 5 : 1);
       i += blockDim.x) {
    const int field = i / (kWin * kWin), g = i - field * (kWin * kWin);
    const int wy = g / kWin, wx = g - wy * kWin;
    const int gy = (Y0 >> 3) - 1 + wy, gx = (X0 >> 3) - 1 + wx;
    const bool in = gy >= 0 && gy < gh && gx >= 0 && gx < gw;
    const size_t at = fg + (size_t)(in ? gy : 0) * gw + (in ? gx : 0);
    switch (field) {
      case 0:
        cp_async4(&b.depth[wy][wx], a.depth + at, in ? 4 : 0);
        break;
      case 1:
        cp_async4(&b.dir[wy][wx], a.maps.dir + at, in ? 4 : 0);
        break;
      case 2:
        cp_async4(&b.cbf[wy][wx], a.maps.cbf + at, in ? 4 : 0);
        break;
      case 3:
        cp_async8(&b.ref[wy][wx], a.maps.ref ? a.maps.ref + 2 * at
                                             : a.maps.dir,
                  in && a.maps.ref ? 8 : 0);
        break;
      default:
        cp_async16(&b.mv[wy][wx], a.maps.mv + 4 * at, in ? 16 : 0);
    }
  }
}

__global__ void __launch_bounds__(kFusedThreads, kFusedPerSM)
    deblock_fused_kernel(const __grid_constant__ FusedArgs a) {
  __shared__ __align__(16) TileBuf b;
  // strengths (0: no edge): vertical edges [granule row -1 .. 4][edge
  // 0 .. 4], horizontal [edge 0 .. 4][granule column 0 .. 3]
  __shared__ unsigned char bsv[6][5], bsh[5][4];
  const int f = blockIdx.z;
  const int X0 = blockIdx.x * kTile, Y0 = blockIdx.y * kTile;
  fetch_tile(a, f, X0, Y0, b);
  cp_async_commit();
  const int H = a.H, W = a.W, hc = H >> 1, wc = W >> 1;
  const int gh = H >> 3, gw = W >> 3;
  const int C0 = X0 >> 1, CY0 = Y0 >> 1;
  const int gy0 = Y0 >> 3, gx0 = X0 >> 3;
  const int max_val = (1 << a.bit_depth) - 1;
  const bool maps = a.maps.dir != nullptr;
  int qp = 0, qpcb = 0, qpcr = 0;
#pragma unroll
  for (int i = 0; i < kQpFrames; ++i)
    if (i == f) {
      qp = a.tab.v[3 * i];
      qpcb = a.tab.v[3 * i + 1];
      qpcr = a.tab.v[3 * i + 2];
    }
  const int beta = __ldg(a.beta_tab + min(max(qp, 0), 51));
  const int tc1 = __ldg(a.tc_tab + min(max(qp, 0), 53));
  const int tc2 = __ldg(a.tc_tab + min(max(qp + 2, 0), 53));
  const int tcc[2] = {__ldg(a.tc_tab + min(max(qpcb + 2, 0), 53)),
                      __ldg(a.tc_tab + min(max(qpcr + 2, 0), 53))};
  cp_async_wait_all();
  __syncthreads();

  // the edge flags and strengths of the tile, from its window
  for (int s = threadIdx.x; s < 50; s += blockDim.x) {
    if (s < 30) {
      const int r = s / 5, e = s - r * 5;
      const int gy = gy0 - 1 + r, px = X0 + 8 * e, pos = a.x0 + px;
      int bs = 0;
      if (gy >= 0 && gy < gh && px > 0 && px < W && pos > 0 &&
          pos < a.pic_w &&
          tu_edge(pos, (1 << a.log2_ctu) >> b.depth[r][e + 1]))
        bs = window_bs(b, maps, r, e, r, e + 1);
      bsv[r][e] = bs;
    } else {
      const int e = (s - 30) >> 2, c = (s - 30) & 3;
      const int py = Y0 + 8 * e;
      int bs = 0;
      if (py > 0 && py < H && gx0 + c < gw &&
          tu_edge(py, (1 << a.log2_ctu) >> b.depth[e + 1][c + 1]))
        bs = window_bs(b, maps, e, c + 1, e + 1, c + 1);
      bsh[e][c] = bs;
    }
  }
  __syncthreads();

  // vertical edges: luma 10 row segments x 5 edges, then per chroma plane
  // 6 row segments x 5 edge positions
  constexpr int kLumaV = (kLT / 4) * 5, kChromaV = (kCT / 4) * 5;
  for (int s = threadIdx.x; s < kLumaV + 2 * kChromaV; s += blockDim.x) {
    if (s < kLumaV) {
      const int rs = s / 5, e = s - rs * 5;
      const int bs = bsv[(rs + 1) >> 1][e];
      if (bs == 0) continue;
      luma_vert(&b.y[4 * rs][8 * e], beta, bs == 2 ? tc2 : tc1, max_val);
    } else {
      const int j = s - kLumaV, p = j / kChromaV, q = j - p * kChromaV;
      const int rs = q / 5, e = q - rs * 5;
      if (bsv[rs][e] != 2 || ((a.x0 + X0 + 8 * e) & 15)) continue;
      chroma_segment(&b.c[p][0][0], &b.c[p][0][0],
                     (size_t)(4 * rs) * kCP + kHalo + 4 * e, kCP, 1, tcc[p],
                     max_val);
    }
  }
  __syncthreads();

  // horizontal edges on the core's columns: luma 5 edges x 8 column
  // segments (a warp's lanes on neighbouring columns), then per chroma
  // plane 4 column segments x 5 edge positions
  constexpr int kLumaH = (kTile / 4) * 5, kChromaH = (kTile / 8) * 5;
  for (int s = threadIdx.x; s < kLumaH + 2 * kChromaH; s += blockDim.x) {
    if (s < kLumaH) {
      const int e = s >> 3, cs = s & 7;
      const int bs = bsh[e][cs >> 1];
      if (bs == 0) continue;
      luma_horz(&b.y[8 * e][kHalo + 4 * cs], beta, bs == 2 ? tc2 : tc1,
                max_val);
    } else {
      const int j = s - kLumaH, p = j / kChromaH, q = j - p * kChromaH;
      const int cs = q / 5, e = q - cs * 5;
      if (bsh[e][cs] != 2 || ((Y0 + 8 * e) & 15)) continue;
      chroma_segment(&b.c[p][0][0], &b.c[p][0][0],
                     (size_t)(kHalo + 4 * e) * kCP + kHalo + 4 * cs, 1, kCP,
                     tcc[p], max_val);
    }
  }
  __syncthreads();

  // the core, once: 32 rows x 8 luma vectors, 16 rows x 4 per chroma plane
  const size_t fo = (size_t)f * H * W, foc = (size_t)f * hc * wc;
  for (int i = threadIdx.x;
       i < kTile * (kTile / 4) + 2 * (kTile / 2) * (kTile / 8);
       i += blockDim.x) {
    const int* src;
    int* dst;
    if (i < kTile * (kTile / 4)) {
      const int r = i / (kTile / 4), v = i - r * (kTile / 4);
      const int py = Y0 + r, px = X0 + 4 * v;
      if (py >= H || px >= W) continue;
      src = &b.y[kHalo + r][kHalo + 4 * v];
      dst = a.out[0] + fo + (size_t)py * W + px;
    } else {
      const int j = i - kTile * (kTile / 4);
      const int p = j / ((kTile / 2) * (kTile / 8));
      const int q = j - p * ((kTile / 2) * (kTile / 8));
      const int r = q / (kTile / 8), v = q - r * (kTile / 8);
      const int py = CY0 + r, px = C0 + 4 * v;
      if (py >= hc || px >= wc) continue;
      src = &b.c[p][kHalo + r][kHalo + 4 * v];
      dst = a.out[1 + p] + foc + (size_t)py * wc + px;
    }
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
  }
}

// K6's CU cbf pass, a CTA a (frame, CTU): each granule row of the CTU's
// levels is one 16-byte load, marking its 8x8 granule when any level is
// nonzero; then each granule takes the OR over its CU (0 for a CU that
// overflows the granule grid, as the reference's pooling does).  Every
// level is read once.
__global__ void __launch_bounds__(kCbfThreads)
    cbf_ctu_kernel(const short* __restrict__ lv,
                   const int* __restrict__ depth, int* __restrict__ cbf,
                   int H, int W, int log2_ctu) {
  __shared__ int nz[64];  // the CTU's granules, up to 8 x 8
  const int f = blockIdx.z;
  const int lg = log2_ctu - 3, gc = 1 << lg;  // granules a CTU side
  const int gy0 = blockIdx.y << lg, gx0 = blockIdx.x << lg;
  const int gh = H >> 3, gw = W >> 3;
  for (int i = threadIdx.x; i < gc * gc; i += blockDim.x) nz[i] = 0;
  __syncthreads();
  const short* base = lv + (size_t)f * H * W;
  for (int i = threadIdx.x; i < (8 << lg) << lg; i += blockDim.x) {
    const int r = i >> lg, v = i & (gc - 1);
    const int py = 8 * gy0 + r, gx = gx0 + v;
    if (py >= H || gx >= gw) continue;
    const int4 q = __ldg(
        reinterpret_cast<const int4*>(base + (size_t)py * W + 8 * gx));
    if (q.x | q.y | q.z | q.w) nz[(r >> 3) * gc + v] = 1;
  }
  __syncthreads();
  const int* dm = depth + (size_t)f * gh * gw;
  for (int i = threadIdx.x; i < gc * gc; i += blockDim.x) {
    const int gy = gy0 + (i >> lg), gx = gx0 + (i & (gc - 1));
    if (gy >= gh || gx >= gw) continue;
    const int r = ((1 << log2_ctu) >> dm[gy * gw + gx]) >> 3;
    const int cy = gy / r * r, cx = gx / r * r;
    int any = 0;
    if (cy + r <= gh && cx + r <= gw)
      for (int a = 0; a < r; ++a)
        for (int b = 0; b < r; ++b)
          any |= nz[(cy - gy0 + a) * gc + cx - gx0 + b];
    cbf[(size_t)f * gh * gw + gy * gw + gx] = any;
  }
}

}  // namespace

// lv [F, H, W] int16 luma levels, depth [F, H/8, W/8] -> cbf [F, H/8,
// W/8]: the luma cbf of each granule's CU.
extern "C" int fhv_deblock_cbf(const short* lv, const int* depth, int* cbf,
                               int F, int H, int W, int log2_ctu,
                               cudaStream_t stream) {
  const long long total = (long long)F * (H >> 3) * (W >> 3);
  if (total <= 0) return 0;
  cbf_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
               stream>>>(lv, depth, cbf, total, H, W, log2_ctu);
  return (int)cudaGetLastError();
}

// dir_map/mv/ref/cbf: the P/B maps, all NULL on intra pictures (ref may be
// NULL alone), cbf from fhv_deblock_cbf; qps [F][3]: deblocking
// QP, Cb QP, Cr QP; x0: global luma column of the planes' first column,
// pic_w: the picture's coded width (0 and W for a whole picture).
extern "C" int fhv_deblock(const int* in_y, const int* in_cb,
                           const int* in_cr, int* out_y, int* out_cb,
                           int* out_cr, const int* depth, const int* dir_map,
                           const int* mv, const int* ref, const int* cbf,
                           const int* beta_tab, const int* tc_tab,
                           const int* qps, int F, int H, int W, int log2_ctu,
                           int bit_depth, int dir, int x0, int pic_w,
                           cudaStream_t stream) {
  if (F <= 0) return 0;
  const long long gh = H >> 3, gw = W >> 3;
  const long long n_luma = dir == 0 ? (H >> 2) * gw : (W >> 2) * gh;
  const long long total = (n_luma + 2 * gh * gw) * F;
  const long long grid = (total + kThreads - 1) / kThreads;
  Maps maps{dir_map, mv, ref, cbf};
  deblock_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
      in_y, in_cb, in_cr, out_y, out_cb, out_cr, depth, maps, beta_tab,
      tc_tab, qps, F, H, W, log2_ctu, bit_depth, dir, x0, pic_w);
  return (int)cudaGetLastError();
}

// The one-launch form: deblock_kernel's arguments, both directions in one
// launch a group of up to 8 frames; qps [F][3] on the host; the input
// planes' row pitches and frame strides (samples, multiples of 4; the
// outputs are contiguous).
extern "C" int fhv_deblock_fused(const int* in_y, const int* in_cb,
                                 const int* in_cr, int pitch_y, int pitch_c,
                                 long long fs_y, long long fs_c, int* out_y,
                                 int* out_cb, int* out_cr, const int* depth,
                                 const int* dir_map, const int* mv,
                                 const int* ref, const int* cbf,
                                 const int* beta_tab, const int* tc_tab,
                                 const int* qps, int F, int H, int W,
                                 int log2_ctu, int bit_depth, int x0,
                                 int pic_w, cudaStream_t stream) {
  const size_t n = (size_t)H * W, nc = n / 4, ng = n / 64;
  FusedArgs a{};
  a.lay = PlaneLayout{{fs_y, fs_c, fs_c}, {pitch_y, pitch_c, pitch_c}};
  a.beta_tab = beta_tab;
  a.tc_tab = tc_tab;
  a.H = H, a.W = W, a.log2_ctu = log2_ctu, a.bit_depth = bit_depth;
  a.x0 = x0, a.pic_w = pic_w;
  for (int f0 = 0; f0 < F; f0 += kQpFrames) {
    const int nf = min(kQpFrames, F - f0);
    for (int i = 0; i < 3 * nf; ++i) a.tab.v[i] = qps[3 * f0 + i];
    a.in[0] = in_y + f0 * fs_y, a.in[1] = in_cb + f0 * fs_c;
    a.in[2] = in_cr + f0 * fs_c;
    a.out[0] = out_y + f0 * n, a.out[1] = out_cb + f0 * nc;
    a.out[2] = out_cr + f0 * nc;
    a.depth = depth + f0 * ng;
    a.maps = Maps{dir_map ? dir_map + f0 * ng : nullptr,
                  mv ? mv + f0 * ng * 4 : nullptr,
                  ref ? ref + f0 * ng * 2 : nullptr,
                  cbf ? cbf + f0 * ng : nullptr};
    const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, nf);
    deblock_fused_kernel<<<grid, kFusedThreads, 0, stream>>>(a);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

// lv [F, H, W] int16 luma levels, depth [F, H/8, W/8] -> cbf [F, H/8,
// W/8], a CTA a (frame, CTU) (log2_ctu 3-6).
extern "C" int fhv_deblock_cbf_ctu(const short* lv, const int* depth,
                                   int* cbf, int F, int H, int W,
                                   int log2_ctu, cudaStream_t stream) {
  if (F <= 0) return 0;
  const int ctu = 1 << log2_ctu;
  const dim3 grid((W + ctu - 1) / ctu, (H + ctu - 1) / ctu, F);
  cbf_ctu_kernel<<<grid, kCbfThreads, 0, stream>>>(lv, depth, cbf, H, W,
                                                   log2_ctu);
  return (int)cudaGetLastError();
}
