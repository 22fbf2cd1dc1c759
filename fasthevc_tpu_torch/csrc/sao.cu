// K7: sample-adaptive offset (spec 8.7.3): per-CTB estimation, then the
// decoder-exact apply.
//
// Replaces fasthevc_tpu/ops/sao.py sao_device (:264), with _edge_cats
// (:33), _estimate_plane (:109) and _apply_plane (:199).
//
// fhv_sao_stats: one CTA per (frame, luma CTB), and one per (frame,
// chroma CTB) that does Cb, then Cr with Cb's type and class (:293).  Each
// thread classifies its samples for the 4 edge classes (on the CTB-padded
// plane, zeros beyond the coded picture and the boundary rule at the
// padded bounds, as the reference estimates) and its band, and adds
// counts and src - rec sums into shared-memory int32 counters with atomics
// (exact, so their order does not matter; the reference's f32 sums are
// exact below 2^24).  Thread 0 then derives the offsets as the reference
// does (f32 round(|s|/n), clipped to +-7, EO sign constraints), the int32
// gains, the best band run and the type, first index on ties.
// fhv_sao_apply: one thread per sample; classifies against the coded
// bounds and writes a new plane.
//
// Bound on the H100: the stats pass is bound by shared-memory atomics on
// a few dozen counters per CTB; the apply pass by device-memory traffic.

#include <cuda_runtime.h>

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

// category 0..4 of sample (y, x) for EO class c; a neighbour outside
// [0, hb) x [0, wb) gives 0; samples at or beyond (hv, wv) read as 0
__device__ __forceinline__ int edge_cat(const int* rec, int W, int y, int x,
                                        int c, int hb, int wb, int hv,
                                        int wv) {
  const int y0 = kEo[c][0], x0 = kEo[c][1], y1 = kEo[c][2], x1 = kEo[c][3];
  const int ty = max(0, max(-y0, -y1)), by = max(0, max(y0, y1));
  const int lx = max(0, max(-x0, -x1)), rx = max(0, max(x0, x1));
  if (y < ty || y >= hb - by || x < lx || x >= wb - rx) return 0;
  const int ya = y + y0, xa = x + x0, yb = y + y1, xb = x + x1;
  const int v = rec[y * W + x];
  const int a = (ya < hv && xa < wv) ? rec[ya * W + xa] : 0;
  const int b = (yb < hv && xb < wv) ? rec[yb * W + xb] : 0;
  const int raw = 2 + sgn(v - a) + sgn(v - b);
  return raw == 2 ? 0 : (raw < 2 ? raw + 1 : raw);
}

__device__ void gather_stats(Stats& st, const int* src, const int* rec,
                             int H, int W, int ctb, int by, int bx,
                             int bit_depth) {
  const int hb = (H + ctb - 1) / ctb * ctb, wb = (W + ctb - 1) / ctb * ctb;
  for (int i = threadIdx.x; i < ctb * ctb; i += blockDim.x) {
    const int y = by * ctb + i / ctb, x = bx * ctb + i % ctb;
    if (y >= H || x >= W) continue;
    const int diff = src[y * W + x] - rec[y * W + x];
    for (int c = 0; c < 4; ++c) {
      const int cat = edge_cat(rec, W, y, x, c, hb, wb, H, W);
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
                 bit_depth);
    __syncthreads();
    if (threadIdx.x == 0) decide(st[0], out, -1, 0);
  } else {
    const int hc = H >> 1, wc = W >> 1;
    const size_t fb = (size_t)f * hc * wc;
    gather_stats(st[0], src_cb + fb, rec_cb + fb, hc, wc, ctb >> 1, by, bx,
                 bit_depth);
    gather_stats(st[1], src_cr + fb, rec_cr + fb, hc, wc, ctb >> 1, by, bx,
                 bit_depth);
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
    const int cat = edge_cat(rec, w, y, x, pr[1], h, w, h, w);
    if (cat > 0) add = pr[2 + cat];
  } else if (pr[0] == 1) {
    const int band = v >> (bit_depth - 5);
    for (int i = 0; i < 4; ++i)
      if (band == (pr[2] + i) % 32) add += pr[3 + i];
  }
  out[y * w + x] = min(max(v + add, 0), (1 << bit_depth) - 1);
}

}  // namespace

extern "C" int fhv_sao_stats(const int* src_y, const int* src_cb,
                             const int* src_cr, const int* rec_y,
                             const int* rec_cb, const int* rec_cr,
                             int* params, int F, int H, int W, int log2_ctu,
                             int bit_depth, cudaStream_t stream) {
  if (F <= 0) return 0;
  const int ctb = 1 << log2_ctu;
  const int nx = (W + ctb - 1) / ctb, ny = (H + ctb - 1) / ctb;
  dim3 grid(ny * nx, F, 2);
  sao_stats_kernel<<<grid, kThreads, 0, stream>>>(
      src_y, src_cb, src_cr, rec_y, rec_cb, rec_cr, params, H, W, log2_ctu,
      bit_depth);
  return (int)cudaGetLastError();
}

extern "C" int fhv_sao_apply(const int* rec_y, const int* rec_cb,
                             const int* rec_cr, int* out_y, int* out_cb,
                             int* out_cr, const int* params, int F, int H,
                             int W, int log2_ctu, int bit_depth,
                             cudaStream_t stream) {
  if (F <= 0) return 0;
  const long long total = ((long long)H * W + 2 * ((long long)H * W >> 2)) * F;
  const long long grid = (total + kThreads - 1) / kThreads;
  sao_apply_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
      rec_y, rec_cb, rec_cr, out_y, out_cb, out_cr, params, F, H, W, log2_ctu,
      bit_depth);
  return (int)cudaGetLastError();
}
