// K9: the integer stage of motion estimation.
//
// Replaces fasthevc_tpu/ops/me.py _downsample4 (:129), _full_search_int
// (:42), full_search (:82) and the integer refinements of me_state
// (:220-307; hier_int_search :310 is a wrapper over it).  Two entry points:
//   * fhv_downsample4: the 4x decimation of the coarse search, one thread
//     per output sample, (sum of the 4x4 + 8) >> 4;
//   * fhv_sad_search: for every (ref, n-block), the SAD-best integer offset
//     d in [-rng, rng]^2 around the block's centre (zero for the full
//     search; the base of its base_n-parent for the +-3 refinements of the
//     tiers and of the 8-blocks inside their 16-parent), on the
//     edge-clamped reference; returns clip((centre + d) * scale, -clip,
//     clip).  Ties keep the first offset in dy-major order, which is what
//     the reference's argmin over dx inside a row and strict < across rows
//     (or its dy-major strict-< refinement loop) keep.
//
// The reference gathers per-tier windows from a +-80 edge-padded plane
// (me.py:100-184); bases are clipped to +-64, so every window sample is an
// edge-clamped reference sample and the kernel reads the reference with
// clamping directly.
//
// Bound on the H100: integer operations.  At 1080p, SR 64 and 2 refs the
// refinements cost 49 offsets x n^2 absolute differences per block (about
// 0.2 G per ref and tier) and the coarse search 33^2 offsets on the 1/4
// planes; the bytes are a few MB.  Design: one CTA per (ref, block) holds
// the source block and the clamped search window in shared memory; each
// thread takes whole offsets and sums their SAD, and a block-wide
// first-index argmin picks the winner.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void downsample4_kernel(const int* __restrict__ in,
                                   int* __restrict__ out, long long total,
                                   int H, int W) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int w4 = W >> 2, h4 = H >> 2;
  const long long plane = idx / ((long long)h4 * w4);
  const int rem = (int)(idx - plane * h4 * w4);
  const int y = rem / w4, x = rem - y * w4;
  const int* p = in + plane * H * W + (size_t)(4 * y) * W + 4 * x;
  int s = 0;
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) s += p[r * W + c];
  out[idx] = (s + 8) >> 4;
}

__global__ void __launch_bounds__(kThreads)
    sad_search_kernel(const int* __restrict__ src,
                      const int* __restrict__ refs,
                      const int* __restrict__ center, int* __restrict__ out,
                      int H, int W, int n, int rng, int base_n, int scale,
                      int clip) {
  extern __shared__ int sm[];
  const int gx = W / n;
  const int B = (H / n) * gx;
  const int b = blockIdx.x, r = blockIdx.y;
  const int oy = (b / gx) * n, ox = (b % gx) * n;
  int cx = 0, cy = 0;
  if (center != nullptr) {
    const int parent = (oy / base_n) * (W / base_n) + ox / base_n;
    const int nb = (H / base_n) * (W / base_n);
    cx = center[((size_t)r * nb + parent) * 2];
    cy = center[((size_t)r * nb + parent) * 2 + 1];
  }
  const int size = n + 2 * rng;
  int* s_src = sm;               // [n][n]
  int* s_win = sm + n * n;       // [size][size]
  __shared__ int red_v[kThreads];
  __shared__ int red_i[kThreads];
  const int* ref = refs + (size_t)r * H * W;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x)
    s_src[i] = src[(size_t)(oy + i / n) * W + ox + i % n];
  const int wy0 = oy + cy - rng, wx0 = ox + cx - rng;
  for (int i = threadIdx.x; i < size * size; i += blockDim.x) {
    const int yy = min(max(wy0 + i / size, 0), H - 1);
    const int xx = min(max(wx0 + i % size, 0), W - 1);
    s_win[i] = ref[(size_t)yy * W + xx];
  }
  __syncthreads();
  const int n_off = 2 * rng + 1;
  int best = 0x7fffffff, best_i = n_off * n_off;
  for (int o = threadIdx.x; o < n_off * n_off; o += blockDim.x) {
    const int dy = o / n_off, dx = o - dy * n_off;
    int sad = 0;
    for (int y = 0; y < n; ++y) {
      const int* wrow = s_win + (dy + y) * size + dx;
      const int* srow = s_src + y * n;
      for (int x = 0; x < n; ++x) sad += abs(srow[x] - wrow[x]);
    }
    if (sad < best) {  // o grows within a thread: the first minimum stays
      best = sad;
      best_i = o;
    }
  }
  red_v[threadIdx.x] = best;
  red_i[threadIdx.x] = best_i;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) {
      const int v = red_v[threadIdx.x + s], i = red_i[threadIdx.x + s];
      if (v < red_v[threadIdx.x] ||
          (v == red_v[threadIdx.x] && i < red_i[threadIdx.x])) {
        red_v[threadIdx.x] = v;
        red_i[threadIdx.x] = i;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int o = red_i[0];
    const int dx = o % n_off - rng, dy = o / n_off - rng;
    const int mx = min(max((cx + dx) * scale, -clip), clip);
    const int my = min(max((cy + dy) * scale, -clip), clip);
    out[((size_t)r * B + b) * 2] = mx;
    out[((size_t)r * B + b) * 2 + 1] = my;
  }
}

}  // namespace

extern "C" int fhv_downsample4(const int* in, int* out, int N, int H, int W,
                               cudaStream_t stream) {
  const long long total = (long long)N * (H >> 2) * (W >> 2);
  if (total <= 0) return 0;
  const unsigned grid = (unsigned)((total + 255) / 256);
  downsample4_kernel<<<grid, 256, 0, stream>>>(in, out, total, H, W);
  return (int)cudaGetLastError();
}

// center: [R, Bc, 2] (x, y) per base_n-block, or NULL for a zero centre;
// out: [R, B, 2] (x, y).
extern "C" int fhv_sad_search(const int* src, const int* refs,
                              const int* center, int* out, int R, int H,
                              int W, int n, int rng, int base_n, int scale,
                              int clip, cudaStream_t stream) {
  const int B = (H / n) * (W / n);
  if (R <= 0 || B <= 0) return 0;
  const int size = n + 2 * rng;
  const size_t smem = sizeof(int) * ((size_t)n * n + (size_t)size * size);
  dim3 grid(B, R);
  sad_search_kernel<<<grid, kThreads, smem, stream>>>(
      src, refs, center, out, H, W, n, rng, base_n, scale, clip);
  return (int)cudaGetLastError();
}
