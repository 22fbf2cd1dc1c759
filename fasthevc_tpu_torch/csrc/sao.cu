// K7: sample-adaptive offset (spec 8.7.3): per-CTB estimation, then the
// decoder-exact apply.
//
// Replaces fasthevc_tpu/ops/sao.py sao_device (:264), with _edge_cats
// (:33), _estimate_plane (:109) and _apply_plane (:199).
//
// fhv_sao_fused, the routes' form: one launch a picture batch.  One CTA
// per (frame, CTB) holds the luma CTB and its Cb and Cr CTBs (the apply
// reads the deblocked planes, never SAO's output, so a CTB depends on no
// other CTA).  Warps 0-7 take the luma CTB, 8-9 Cb and 10-11 Cr, in 4-sample
// quads.  The CTB's deblocked samples are read once from device memory
// into a shared-memory int16 tile with a one-sample border (the neighbour
// CTBs' samples, zeros beyond the coded picture, the halo columns), its
// source samples beside them into registers (16-byte loads, both in
// flight together); every sample's 4 edge classes and band come from that
// tile.  The statistics are bit-sliced across the warp, with no
// atomics and no per-sample counters: a lane owns a band bin and (lanes
// 0-15) a (class, category) bin; for each sample slot the warp ballots the
// bands', categories' and biased differences' bits, a lane ANDs the
// ballots that match its bin and adds the popcounts (integer sums are
// exact in any order).  The decision runs a warp a component, a lane a band
// (offsets, gains, the 29 runs by shuffles, the first best run) and a lane
// a (class, category), with the f32 round_div of the reference; Cr takes
// Cb's type and class.  The apply reads the same tile and writes each
// quad with one 16-byte store where the row allows.
//
// The two classification rules stay apart: the estimate classifies on the
// CTB-padded plane (zeros beyond the coded picture, the boundary rule at
// the padded bounds), the apply against the coded bounds.  The tile serves
// both: the apply never reads a sample beyond the coded picture.
//
// fhv_sao_stats + fhv_sao_apply, the earlier form (no route launches it):
// one CTA per (frame, luma CTB) and one per (frame, chroma CTB) that does
// Cb, then Cr; each thread classifies its samples from device memory and
// adds counts and sums into shared-memory int32 counters with atomics, and
// thread 0 derives the parameters.  fhv_sao_apply: one thread per sample;
// classifies against the coded bounds and writes a new plane.
//
// The halo form (sao_device(has_halo=True), :264-300, of the sharded
// pipelines): the launches also take each plane's deblocked neighbour
// columns, one to the left and one to the right of a tile ([F, H] each),
// and l_avail / r_avail.  Where a side is available, a sample in the edge
// column classifies against the neighbour column instead of being
// category 0 (_edge_cats, :47-79).  The columns read as the reference pads
// them: zeros below the coded height in the estimate's CTB-padded plane
// (:126-129).
//
// Bound on the H100: bytes (src and rec read once, the planes written
// once).  The earlier stats pass was bound by shared-memory atomics on a
// few dozen counters per CTB and a one-thread decision; the fused form
// removes both and the apply's second read of the planes.  It is still
// far from its bound: clock64 stamps put a 1080p CTA's life at about 25K
// cycles, a third waiting on its tile's loads and 40% issuing the
// statistics' ballots and popcounts (3 CTAs an SM at 56 registers).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
// EO class -> (y0, x0, y1, x1) neighbour offsets (spec table 8-9 order)
__constant__ int kEo[4][4] = {
    {0, -1, 0, 1}, {-1, 0, 1, 0}, {-1, -1, 1, 1}, {1, -1, -1, 1}};

struct Stats {
  int cnt_e[4][4], sum_e[4][4];
  int cnt_b[32], sum_b[32];
};

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

// A plane's neighbour columns (frame-offset, NULL without the halo form)
// and whether each side is available.
struct Halo {
  const int* l;
  const int* r;
  int la, ra;
};

// sample (ya, xa) of the plane as the classification reads it: rows at or
// beyond hv read 0, columns -1 and wb the neighbour columns (padded to hb
// rows with zeros, their end rows repeated)
__device__ __forceinline__ int sample_at(const int* rec, int W, int ya,
                                         int xa, int hb, int wb, int hv,
                                         int wv, const Halo& h) {
  if (xa < 0 || xa >= wb) {
    const int* col = xa < 0 ? h.l : h.r;
    const int yc = min(max(ya, 0), hb - 1);
    return yc < hv ? col[yc] : 0;
  }
  return (ya < hv && xa < wv) ? rec[ya * W + xa] : 0;
}

// category 0..4 of sample (y, x) for EO class c; a neighbour outside
// [0, hb) x [0, wb) gives 0 unless it is an available neighbour column;
// samples at or beyond (hv, wv) read as 0
__device__ __forceinline__ int edge_cat(const int* rec, int W, int y, int x,
                                        int c, int hb, int wb, int hv,
                                        int wv, const Halo& h) {
  const int y0 = kEo[c][0], x0 = kEo[c][1], y1 = kEo[c][2], x1 = kEo[c][3];
  const int ty = max(0, max(-y0, -y1)), by = max(0, max(y0, y1));
  const int lx = max(0, max(-x0, -x1)), rx = max(0, max(x0, x1));
  if (y < ty || y >= hb - by) return 0;
  if (x < lx && !(x == 0 && h.l != nullptr && h.la)) return 0;
  if (x >= wb - rx && !(x == wb - 1 && h.r != nullptr && h.ra)) return 0;
  const int ya = y + y0, xa = x + x0, yb = y + y1, xb = x + x1;
  const int v = rec[y * W + x];
  const int a = sample_at(rec, W, ya, xa, hb, wb, hv, wv, h);
  const int b = sample_at(rec, W, yb, xb, hb, wb, hv, wv, h);
  const int raw = 2 + sgn(v - a) + sgn(v - b);
  return raw == 2 ? 0 : (raw < 2 ? raw + 1 : raw);
}

__device__ void gather_stats(Stats& st, const int* src, const int* rec,
                             int H, int W, int ctb, int by, int bx,
                             int bit_depth, const Halo& h) {
  const int hb = (H + ctb - 1) / ctb * ctb, wb = (W + ctb - 1) / ctb * ctb;
  for (int i = threadIdx.x; i < ctb * ctb; i += blockDim.x) {
    const int y = by * ctb + i / ctb, x = bx * ctb + i % ctb;
    if (y >= H || x >= W) continue;
    const int diff = src[y * W + x] - rec[y * W + x];
    for (int c = 0; c < 4; ++c) {
      const int cat = edge_cat(rec, W, y, x, c, hb, wb, H, W, h);
      if (cat > 0) {
        atomicAdd(&st.cnt_e[c][cat - 1], 1);
        atomicAdd(&st.sum_e[c][cat - 1], diff);
      }
    }
    const int band = rec[y * W + x] >> (bit_depth - 5);
    atomicAdd(&st.cnt_b[band], 1);
    atomicAdd(&st.sum_b[band], diff);
  }
}

// clip(round-half-away(s / n), +-7) in f32; 0 where n == 0 (sao.py:91)
__device__ __forceinline__ int round_div(int s, int n) {
  if (n <= 0) return 0;
  const float q = __fdiv_rn(fabsf((float)s), fmaxf((float)n, 1.f));
  const int o = (int)floorf(__fadd_rn(q, 0.5f));
  const int v = s < 0 ? -o : (s > 0 ? o : 0);
  return min(max(v, -7), 7);
}

// The CTB's parameters (type, eo_class, band_pos, off0..3) from its
// statistics; inherit >= 0 gives the (type, class) to take (the Cr plane).
__device__ void decide(const Stats& st, int* params, int inherit_type,
                       int inherit_class) {
  int off_e[4][4], gain_e[4];
  for (int c = 0; c < 4; ++c) {
    gain_e[c] = 0;
    for (int k = 0; k < 4; ++k) {
      int o = round_div(st.sum_e[c][k], st.cnt_e[c][k]);
      o = k < 2 ? max(o, 0) : min(o, 0);
      off_e[c][k] = o;
      gain_e[c] += 2 * o * st.sum_e[c][k] - o * o * st.cnt_e[c][k];
    }
  }
  int off_b[32], gain_b[32];
  for (int b = 0; b < 32; ++b) {
    off_b[b] = round_div(st.sum_b[b], st.cnt_b[b]);
    gain_b[b] = 2 * off_b[b] * st.sum_b[b] - off_b[b] * off_b[b] * st.cnt_b[b];
  }
  int band_pos = 0, band_gain = 0;
  for (int p = 0; p < 29; ++p) {
    const int run = gain_b[p] + gain_b[p + 1] + gain_b[p + 2] + gain_b[p + 3];
    if (p == 0 || run > band_gain) {
      band_gain = run;
      band_pos = p;
    }
  }
  int type, cls;
  if (inherit_type < 0) {
    int eo_cls = 0, eo_gain = gain_e[0];
    for (int c = 1; c < 4; ++c)
      if (gain_e[c] > eo_gain) {
        eo_gain = gain_e[c];
        eo_cls = c;
      }
    const bool use_band = band_gain > max(eo_gain, 0);
    const bool use_edge = !use_band && eo_gain > 0;
    type = use_band ? 1 : (use_edge ? 2 : 0);
    cls = use_edge ? eo_cls : 0;
  } else {
    type = inherit_type;
    cls = inherit_class;
  }
  params[0] = type;
  params[1] = type == 2 ? cls : 0;
  params[2] = type == 1 ? band_pos : 0;
  for (int i = 0; i < 4; ++i)
    params[3 + i] = type == 1 ? off_b[band_pos + i]
                              : (type == 2 ? off_e[cls][i] : 0);
}

// the halo columns of frame f, each of h rows
__device__ __forceinline__ Halo frame_halo(const Halo& h, int f, int rows) {
  Halo o = h;
  if (o.l != nullptr) o.l += (size_t)f * rows;
  if (o.r != nullptr) o.r += (size_t)f * rows;
  return o;
}

__device__ void clear_stats(Stats* st, int n) {
  int* p = reinterpret_cast<int*>(st);
  for (int i = threadIdx.x; i < n * (int)(sizeof(Stats) / sizeof(int));
       i += blockDim.x)
    p[i] = 0;
}

// grid: (ny * nx, F, 2) — z = 0 luma CTB, z = 1 the chroma CTB pair
__global__ void sao_stats_kernel(const int* __restrict__ src_y,
                                 const int* __restrict__ src_cb,
                                 const int* __restrict__ src_cr,
                                 const int* __restrict__ rec_y,
                                 const int* __restrict__ rec_cb,
                                 const int* __restrict__ rec_cr,
                                 const Halo hy, const Halo hcb,
                                 const Halo hcr,
                                 int* __restrict__ params, int H, int W,
                                 int log2_ctu, int bit_depth) {
  __shared__ Stats st[2];
  const int ctb = 1 << log2_ctu;
  const int nx = (W + ctb - 1) / ctb;
  const int ny = (H + ctb - 1) / ctb;
  const int by = blockIdx.x / nx, bx = blockIdx.x % nx;
  const int f = blockIdx.y;
  int* out = params + ((size_t)(f * ny + by) * nx + bx) * 21;
  clear_stats(st, 2);
  __syncthreads();
  if (blockIdx.z == 0) {
    const size_t fb = (size_t)f * H * W;
    gather_stats(st[0], src_y + fb, rec_y + fb, H, W, ctb, by, bx,
                 bit_depth, frame_halo(hy, f, H));
    __syncthreads();
    if (threadIdx.x == 0) decide(st[0], out, -1, 0);
  } else {
    const int hc = H >> 1, wc = W >> 1;
    const size_t fb = (size_t)f * hc * wc;
    gather_stats(st[0], src_cb + fb, rec_cb + fb, hc, wc, ctb >> 1, by, bx,
                 bit_depth, frame_halo(hcb, f, hc));
    gather_stats(st[1], src_cr + fb, rec_cr + fb, hc, wc, ctb >> 1, by, bx,
                 bit_depth, frame_halo(hcr, f, hc));
    __syncthreads();
    if (threadIdx.x == 0) {
      decide(st[0], out + 7, -1, 0);
      decide(st[1], out + 14, out[7], out[8]);
    }
  }
}

__global__ void sao_apply_kernel(const int* __restrict__ rec_y,
                                 const int* __restrict__ rec_cb,
                                 const int* __restrict__ rec_cr,
                                 int* __restrict__ out_y,
                                 int* __restrict__ out_cb,
                                 int* __restrict__ out_cr,
                                 const Halo hy, const Halo hcb,
                                 const Halo hcr,
                                 const int* __restrict__ params, int F, int H,
                                 int W, int log2_ctu, int bit_depth) {
  const long long luma = (long long)H * W, chroma = luma >> 2;
  const long long per_frame = luma + 2 * chroma;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per_frame * F) return;
  const int f = (int)(idx / per_frame);
  long long j = idx - (long long)f * per_frame;
  int plane = 0;
  if (j >= luma) {
    j -= luma;
    plane = 1;
    if (j >= chroma) {
      j -= chroma;
      plane = 2;
    }
  }
  const int h = plane ? H >> 1 : H, w = plane ? W >> 1 : W;
  const int ctb = (1 << log2_ctu) >> (plane ? 1 : 0);
  const int ctb_full = 1 << log2_ctu;
  const int nx = (W + ctb_full - 1) / ctb_full;
  const int ny = (H + ctb_full - 1) / ctb_full;
  const int y = (int)(j / w), x = (int)(j % w);
  const size_t fb = (size_t)f * h * w;
  const int* rec = (plane == 0 ? rec_y : (plane == 1 ? rec_cb : rec_cr)) + fb;
  int* out = (plane == 0 ? out_y : (plane == 1 ? out_cb : out_cr)) + fb;
  const int* pr = params +
                  (((size_t)(f * ny + y / ctb) * nx + x / ctb) * 3 + plane) * 7;
  const int v = rec[y * w + x];
  int add = 0;
  if (pr[0] == 2) {
    const Halo hh = frame_halo(plane == 0 ? hy : (plane == 1 ? hcb : hcr), f,
                               h);
    const int cat = edge_cat(rec, w, y, x, pr[1], h, w, h, w, hh);
    if (cat > 0) add = pr[2 + cat];
  } else if (pr[0] == 1) {
    const int band = v >> (bit_depth - 5);
    for (int i = 0; i < 4; ++i)
      if (band == (pr[2] + i) % 32) add += pr[3 + i];
  }
  out[y * w + x] = min(max(v + add, 0), (1 << bit_depth) - 1);
}


// ---------------------------------------------------------------------------
// sao_fused

// warps 0-7 luma, 8-9 Cb, 10-11 Cr
constexpr int kLumaWarps = 8;
constexpr int kWarps = kLumaWarps * 3 / 2;
constexpr int kFusedThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// a component's statistics: 16 edge counts, 16 edge sums ((class,
// category) = 4 c + k - 1), 32 band counts, 32 band sums
constexpr int kStat = 96;

template <int LG>
struct FusedCfg {
  static constexpr int CTB = 1 << LG;
  static constexpr int TY = CTB + 2;           // luma tile side
  static constexpr int TC = CTB / 2 + 2;       // chroma tile side
  static constexpr int QY = CTB * CTB / 4;     // luma quads
  static constexpr int QC = QY / 4;            // quads of a chroma CTB
  static constexpr int NY = 32 * kLumaWarps;   // luma threads
  static constexpr int IT = (QY + NY - 1) / NY;  // quads a thread
  static_assert(IT == (QC + NY / 4 - 1) / (NY / 4),
                "luma and chroma take equal turns");
};

// one component's decision inputs, a warp's output
struct Decision {
  int band_pos, band_gain, eo_cls, eo_gain;
  int off_b[32];
  int off_e[16];
};

// (value, index) of the warp's largest value, the first index on ties
__device__ __forceinline__ void argmax_first(int& v, int& i) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const int ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// a warp's decision inputs from one component's totals t[kStat]: a lane a
// band, lanes 0-15 a (class, category); as decide() above
__device__ void warp_decide(const int* t, Decision& d, int lane) {
  const int nb = t[32 + lane], sb = t[64 + lane];
  const int ob = round_div(sb, nb);
  const int gb = 2 * ob * sb - ob * ob * nb;
  d.off_b[lane] = ob;
  const int run = gb + __shfl_down_sync(kFull, gb, 1) +
                  __shfl_down_sync(kFull, gb, 2) +
                  __shfl_down_sync(kFull, gb, 3);
  int bv = lane < 29 ? run : INT_MIN, bi = lane;
  argmax_first(bv, bi);
  int te = 0;
  if (lane < 16) {
    const int ne = t[lane], se = t[16 + lane];
    int o = round_div(se, ne);
    o = (lane & 3) < 2 ? max(o, 0) : min(o, 0);
    te = 2 * o * se - o * o * ne;
    d.off_e[lane] = o;
  }
  int ge = te + __shfl_xor_sync(kFull, te, 1);
  ge += __shfl_xor_sync(kFull, ge, 2);
  int ev = (lane < 16 && (lane & 3) == 0) ? ge : INT_MIN, ei = lane >> 2;
  argmax_first(ev, ei);
  if (lane == 0) {
    d.band_pos = bi;
    d.band_gain = bv;
    d.eo_cls = ei;
    d.eo_gain = ev;
  }
}

// category 0..4 of the sample at tile (ty, tx), plane (y, x), value v, for
// EO class C, with the boundary rule at (hb, wb); la / ra: an available
// neighbour column on that side
template <int C>
__device__ __forceinline__ int tile_cat(const short* tl, int ts, int ty,
                                        int tx, int v, int y, int x, int hb,
                                        int wb, bool la, bool ra) {
  constexpr int y0 = C == 0 ? 0 : (C == 3 ? 1 : -1), x0 = C == 1 ? 0 : -1;
  if (C != 0 && (y < 1 || y >= hb - 1)) return 0;
  if (C != 1 && ((x == 0 && !la) || (x == wb - 1 && !ra))) return 0;
  const int a = tl[(ty + y0) * ts + tx + x0];
  const int b = tl[(ty - y0) * ts + tx - x0];
  const int raw = 2 + sgn(v - a) + sgn(v - b);
  return raw == 2 ? 0 : (raw < 2 ? raw + 1 : raw);
}

__device__ __forceinline__ int tile_cat_of(int c, const short* tl, int ts,
                                           int ty, int tx, int v, int y,
                                           int x, int hb, int wb, bool la,
                                           bool ra) {
  switch (c) {
    case 0: return tile_cat<0>(tl, ts, ty, tx, v, y, x, hb, wb, la, ra);
    case 1: return tile_cat<1>(tl, ts, ty, tx, v, y, x, hb, wb, la, ra);
    case 2: return tile_cat<2>(tl, ts, ty, tx, v, y, x, hb, wb, la, ra);
    default: return tile_cat<3>(tl, ts, ty, tx, v, y, x, hb, wb, la, ra);
  }
}

// sample (yy, xx) of a plane as the tile holds it: zeros beyond the coded
// picture, columns -1 and w the halo columns (zeros below the coded height)
__device__ __forceinline__ int tile_src(const int* rec, int h, int w, int yy,
                                        int xx, const Halo& hl) {
  if (yy < 0 || yy >= h) return 0;
  if (xx < 0) return hl.l != nullptr ? hl.l[yy] : 0;
  if (xx >= w) return (hl.r != nullptr && xx == w) ? hl.r[yy] : 0;
  return rec[yy * w + xx];
}

// grid: (ny * nx, F), kFusedThreads threads
template <int LG>
__global__ void __launch_bounds__(kFusedThreads, 3)
    sao_fused_kernel(const int* __restrict__ src_y,
                     const int* __restrict__ src_cb,
                     const int* __restrict__ src_cr,
                     const int* __restrict__ rec_y,
                     const int* __restrict__ rec_cb,
                     const int* __restrict__ rec_cr, int* __restrict__ out_y,
                     int* __restrict__ out_cb, int* __restrict__ out_cr,
                     const Halo hy, const Halo hcb, const Halo hcr,
                     int* __restrict__ params, int H, int W, int bit_depth) {
  using C = FusedCfg<LG>;
  __shared__ short tile_y[C::TY * C::TY];
  __shared__ short tile_c[2][C::TC * C::TC];
  __shared__ int part[kWarps][kStat];
  __shared__ int tot[3][kStat];
  __shared__ Decision dec[3];
  __shared__ int prm[3][7];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kCw = kLumaWarps / 4;          // warps a chroma plane
  const int comp = warp < kLumaWarps ? 0 : (warp < kLumaWarps + kCw ? 1 : 2);
  const int w0 = comp == 0 ? 0 : kLumaWarps + (comp - 1) * kCw;
  const int t = tid - 32 * w0;
  const int nthr = comp == 0 ? C::NY : C::NY / 4;
  const int nx = (W + C::CTB - 1) >> LG, ny = (H + C::CTB - 1) >> LG;
  const int by = blockIdx.x / nx, bx = blockIdx.x % nx;
  const int f = blockIdx.y;
  // this thread's component: its CTB (y0, x0, side cb), plane and tile
  const int cb = comp ? C::CTB / 2 : C::CTB;
  const int h = comp ? H >> 1 : H, w = comp ? W >> 1 : W;
  const int hb = ny * cb, wb = nx * cb;      // the CTB-padded plane
  const int y0 = by * cb, x0 = bx * cb;
  const size_t fb = (size_t)f * h * w;
  const int* src = (comp == 0 ? src_y : (comp == 1 ? src_cb : src_cr)) + fb;
  const int* rec = (comp == 0 ? rec_y : (comp == 1 ? rec_cb : rec_cr)) + fb;
  int* out = (comp == 0 ? out_y : (comp == 1 ? out_cb : out_cr)) + fb;
  const Halo hl = frame_halo(comp == 0 ? hy : (comp == 1 ? hcb : hcr), f, h);
  const bool la = hl.l != nullptr && hl.la, ra = hl.r != nullptr && hl.ra;
  short* tl = comp == 0 ? tile_y : tile_c[comp - 1];
  const int ts = cb + 2;
  const int qrow = cb >> 2;                    // quads a CTB row
  const int nq = cb * qrow;
  const bool vec = (w & 3) == 0 &&
                   ((reinterpret_cast<size_t>(src) |
                     reinterpret_cast<size_t>(rec) |
                     reinterpret_cast<size_t>(out)) & 15) == 0;

  // 1. the tile: the CTB's samples (a quad at a time), then its border;
  // the quads' source samples are loaded beside them
  int s[C::IT][4];
#pragma unroll
  for (int k = 0; k < C::IT; ++k) {
    const int q = t + k * nthr;
    const int r = q / qrow, cx = (q % qrow) * 4;
    const int y = y0 + r, x = x0 + cx;
    int v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 4; ++j) s[k][j] = 0;
    if (q >= nq) continue;
    if (y < h) {
      if (vec && x + 3 < w) {
        const int4 p = *reinterpret_cast<const int4*>(rec + y * w + x);
        const int4 o = *reinterpret_cast<const int4*>(src + y * w + x);
        v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
        s[k][0] = o.x; s[k][1] = o.y; s[k][2] = o.z; s[k][3] = o.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (x + j < w) {
            v[j] = rec[y * w + x + j];
            s[k][j] = src[y * w + x + j];
          }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) tl[(r + 1) * ts + cx + 1 + j] = (short)v[j];
  }
  for (int i = t; i < 4 * cb + 4; i += nthr) {
    int ty, tx;
    if (i < 2 * ts) {
      ty = i < ts ? 0 : cb + 1;
      tx = i < ts ? i : i - ts;
    } else {
      const int e = i - 2 * ts;
      ty = (e % cb) + 1;
      tx = e < cb ? 0 : cb + 1;
    }
    tl[ty * ts + tx] =
        (short)tile_src(rec, h, w, y0 + ty - 1, x0 + tx - 1, hl);
  }
  __syncthreads();

  // 2. the estimate, bit-sliced across the warp: a lane owns band bin
  // `lane` and (lanes 0-15) edge bin (class lane / 4, category lane % 4 +
  // 1).  For each sample slot the warp ballots the samples' validity, band
  // bits, categories' bits and biased differences' bits; a lane's bin is
  // the AND of the matching ballots, and its sum the popcounts of the
  // difference bits inside it, weighted by 2^bit.
  const int bshift = bit_depth - 5;
  const int bias = 1 << bit_depth, nbits = bit_depth + 1;
  const int my_c = (lane >> 2) & 3, my_k = (lane & 3) + 1;
  int band_n = 0, band_s = 0, edge_n = 0, edge_s = 0;
#pragma unroll
  for (int k = 0; k < C::IT; ++k) {
    const int q = t + k * nthr;
    const int r = q / qrow, cx = (q % qrow) * 4;
    const int y = y0 + r, x = x0 + cx;
    const bool qv = q < nq && y < h;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = qv && x + j < w;
      const int ty = r + 1, tx = cx + 1 + j;
      int band = 0, dd = 0, cat[4] = {0, 0, 0, 0};
      if (valid) {
        const int v = tl[ty * ts + tx];
        dd = s[k][j] - v + bias;
        band = v >> bshift;
        cat[0] = tile_cat<0>(tl, ts, ty, tx, v, y, x + j, hb, wb, la, ra);
        cat[1] = tile_cat<1>(tl, ts, ty, tx, v, y, x + j, hb, wb, la, ra);
        cat[2] = tile_cat<2>(tl, ts, ty, tx, v, y, x + j, hb, wb, la, ra);
        cat[3] = tile_cat<3>(tl, ts, ty, tx, v, y, x + j, hb, wb, la, ra);
      }
      const unsigned vm = __ballot_sync(kFull, valid);
      unsigned mb = vm, me = 0;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const unsigned bi = __ballot_sync(kFull, (band >> i) & 1);
        mb &= (lane >> i) & 1 ? bi : ~bi;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        unsigned mc = vm;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const unsigned ci = __ballot_sync(kFull, (cat[c] >> i) & 1);
          mc &= (my_k >> i) & 1 ? ci : ~ci;
        }
        if (c == my_c) me = mc;
      }
      band_n += __popc(mb);
      edge_n += __popc(me);
      for (int i = 0; i < nbits; ++i) {
        const unsigned di = __ballot_sync(kFull, (dd >> i) & 1);
        band_s += __popc(di & mb) << i;
        edge_s += __popc(di & me) << i;
      }
    }
  }
  if (lane < 16) {
    part[warp][lane] = edge_n;
    part[warp][16 + lane] = edge_s - bias * edge_n;
  }
  part[warp][32 + lane] = band_n;
  part[warp][64 + lane] = band_s - bias * band_n;
  __syncthreads();
  for (int e = tid; e < 3 * kStat; e += kFusedThreads) {
    const int c = e / kStat, i = e % kStat;
    const int w_lo = c == 0 ? 0 : kLumaWarps + (c - 1) * kCw;
    const int w_hi = c == 0 ? kLumaWarps : w_lo + kCw;
    int acc = 0;
    for (int ww = w_lo; ww < w_hi; ++ww) acc += part[ww][i];
    tot[c][i] = acc;
  }
  __syncthreads();

  // 3. the decision: a warp a component, then a thread a component's
  // parameters (Cr takes Cb's type and class)
  if (warp < 3) warp_decide(tot[warp], dec[warp], lane);
  __syncthreads();
  if (tid < 3) {
    const Decision& dt = dec[tid == 2 ? 1 : tid];
    const bool use_band = dt.band_gain > max(dt.eo_gain, 0);
    const bool use_edge = !use_band && dt.eo_gain > 0;
    const int type = use_band ? 1 : (use_edge ? 2 : 0);
    const int cls = use_edge ? dt.eo_cls : 0;
    const Decision& d = dec[tid];
    int* pg = params + ((size_t)(f * ny + by) * nx + bx) * 21 + tid * 7;
    int p[7];
    p[0] = type;
    p[1] = type == 2 ? cls : 0;
    p[2] = type == 1 ? d.band_pos : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[3 + i] = type == 1 ? d.off_b[d.band_pos + i]
                           : (type == 2 ? d.off_e[4 * cls + i] : 0);
#pragma unroll
    for (int i = 0; i < 7; ++i) prm[tid][i] = pg[i] = p[i];
  }
  __syncthreads();

  // 4. the apply, from the tile, against the coded bounds
  const int type = prm[comp][0], cls = prm[comp][1], bpos = prm[comp][2];
  const int o0 = prm[comp][3], o1 = prm[comp][4], o2 = prm[comp][5],
            o3 = prm[comp][6];
  const int maxv = (1 << bit_depth) - 1;
#pragma unroll
  for (int k = 0; k < C::IT; ++k) {
    const int q = t + k * nthr;
    if (q >= nq) continue;
    const int r = q / qrow, cx = (q % qrow) * 4;
    const int y = y0 + r, x = x0 + cx;
    if (y >= h) continue;
    int o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ty = r + 1, tx = cx + 1 + j;
      const int v = tl[ty * ts + tx];
      int add = 0;
      if (type == 2 && x + j < w) {
        const int cat =
            tile_cat_of(cls, tl, ts, ty, tx, v, y, x + j, h, w, la, ra);
        add = cat == 1 ? o0 : (cat == 2 ? o1 : (cat == 3 ? o2
                                                          : (cat == 4 ? o3
                                                                      : 0)));
      } else if (type == 1) {
        const int band = v >> bshift;
        add = (band == bpos % 32 ? o0 : 0) + (band == (bpos + 1) % 32 ? o1
                                                                      : 0) +
              (band == (bpos + 2) % 32 ? o2 : 0) +
              (band == (bpos + 3) % 32 ? o3 : 0);
      }
      o[j] = min(max(v + add, 0), maxv);
    }
    if (vec && x + 3 < w) {
      *reinterpret_cast<int4*>(out + y * w + x) = make_int4(o[0], o[1], o[2],
                                                            o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j < w) out[y * w + x + j] = o[j];
    }
  }
}

template <int LG>
int launch_fused(const int* const* src, const int* const* rec,
                 int* const* out, const Halo* halo, int* params, int F,
                 int H, int W, int bit_depth, cudaStream_t stream) {
  const int ctb = 1 << LG;
  const int nx = (W + ctb - 1) / ctb, ny = (H + ctb - 1) / ctb;
  dim3 grid(ny * nx, F);
  sao_fused_kernel<LG><<<grid, kFusedThreads, 0, stream>>>(
      src[0], src[1], src[2], rec[0], rec[1], rec[2], out[0], out[1], out[2],
      halo[0], halo[1], halo[2], params, H, W, bit_depth);
  return (int)cudaGetLastError();
}

}  // namespace

// halo: the left and right neighbour columns of luma [F, H], Cb and Cr
// [F, H/2], all NULL without the halo form; l_avail, r_avail: whether each
// side classifies against them.
extern "C" int fhv_sao_stats(const int* src_y, const int* src_cb,
                             const int* src_cr, const int* rec_y,
                             const int* rec_cb, const int* rec_cr,
                             const int* hl_y, const int* hr_y,
                             const int* hl_cb, const int* hr_cb,
                             const int* hl_cr, const int* hr_cr,
                             int* params, int F, int H, int W, int log2_ctu,
                             int bit_depth, int l_avail, int r_avail,
                             cudaStream_t stream) {
  if (F <= 0) return 0;
  const int ctb = 1 << log2_ctu;
  const int nx = (W + ctb - 1) / ctb, ny = (H + ctb - 1) / ctb;
  dim3 grid(ny * nx, F, 2);
  sao_stats_kernel<<<grid, kThreads, 0, stream>>>(
      src_y, src_cb, src_cr, rec_y, rec_cb, rec_cr,
      Halo{hl_y, hr_y, l_avail, r_avail}, Halo{hl_cb, hr_cb, l_avail, r_avail},
      Halo{hl_cr, hr_cr, l_avail, r_avail}, params, H, W, log2_ctu,
      bit_depth);
  return (int)cudaGetLastError();
}

extern "C" int fhv_sao_apply(const int* rec_y, const int* rec_cb,
                             const int* rec_cr, int* out_y, int* out_cb,
                             int* out_cr, const int* hl_y, const int* hr_y,
                             const int* hl_cb, const int* hr_cb,
                             const int* hl_cr, const int* hr_cr,
                             const int* params, int F, int H, int W,
                             int log2_ctu, int bit_depth, int l_avail,
                             int r_avail, cudaStream_t stream) {
  if (F <= 0) return 0;
  const long long total = ((long long)H * W + 2 * ((long long)H * W >> 2)) * F;
  const long long grid = (total + kThreads - 1) / kThreads;
  sao_apply_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
      rec_y, rec_cb, rec_cr, out_y, out_cb, out_cr,
      Halo{hl_y, hr_y, l_avail, r_avail}, Halo{hl_cb, hr_cb, l_avail, r_avail},
      Halo{hl_cr, hr_cr, l_avail, r_avail}, params, F, H, W, log2_ctu,
      bit_depth);
  return (int)cudaGetLastError();
}

// The fused form, one launch: src, rec and out planes luma [F, H, W],
// chroma [F, H/2, W/2]; halo and l_avail, r_avail as fhv_sao_stats; params
// [F, ny, nx, 3, 7].  CTB sizes 16, 32 and 64 (log2_ctu 4-6).
extern "C" int fhv_sao_fused(const int* src_y, const int* src_cb,
                             const int* src_cr, const int* rec_y,
                             const int* rec_cb, const int* rec_cr,
                             int* out_y, int* out_cb, int* out_cr,
                             const int* hl_y, const int* hr_y,
                             const int* hl_cb, const int* hr_cb,
                             const int* hl_cr, const int* hr_cr,
                             int* params, int F, int H, int W, int log2_ctu,
                             int bit_depth, int l_avail, int r_avail,
                             cudaStream_t stream) {
  if (F <= 0 || H <= 0 || W <= 0) return 0;
  const int* src[3] = {src_y, src_cb, src_cr};
  const int* rec[3] = {rec_y, rec_cb, rec_cr};
  int* out[3] = {out_y, out_cb, out_cr};
  const Halo halo[3] = {Halo{hl_y, hr_y, l_avail, r_avail},
                        Halo{hl_cb, hr_cb, l_avail, r_avail},
                        Halo{hl_cr, hr_cr, l_avail, r_avail}};
  switch (log2_ctu) {
    case 4:
      return launch_fused<4>(src, rec, out, halo, params, F, H, W, bit_depth,
                             stream);
    case 5:
      return launch_fused<5>(src, rec, out, halo, params, F, H, W, bit_depth,
                             stream);
    case 6:
      return launch_fused<6>(src, rec, out, halo, params, F, H, W, bit_depth,
                             stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
