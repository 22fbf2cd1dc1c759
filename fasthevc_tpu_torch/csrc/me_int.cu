// K9: the integer stage of motion estimation.
//
// Replaces fasthevc_tpu/ops/me.py _downsample4 (:129), _full_search_int
// (:42), full_search (:82) and the integer refinements of me_state
// (:220-307; hier_int_search :310 is a wrapper over it).  Entry points:
//   * fhv_downsample4: the 4x decimation of the coarse search, one thread
//     per output sample, (sum of the 4x4 + 8) >> 4;
//   * fhv_me_coarse: every tier's full search at a zero centre (me.py:
//     233-248) in one launch a picture;
//   * fhv_me_fine: every +-3 refinement (me.py:265-306: each tier around
//     its base, the 8-blocks around their 16-parent's) in one launch a
//     picture;
//   * fhv_sad_search: the earlier form, one search a launch: for every
//     (ref, n-block), the SAD-best integer offset d in [-rng, rng]^2
//     around the block's centre (zero for the full search; the base of its
//     base_n-parent for the refinements), on the edge-clamped reference;
//     returns clip((centre + d) * scale, -clip, clip).  No route launches
//     it; it stays as the yardstick of the two above.
// Ties keep the first offset in dy-major order, which is what the
// reference's argmin over dx inside a row and strict < across rows (or its
// dy-major strict-< refinement loop) keep.
//
// The reference gathers per-tier windows from a +-80 edge-padded plane
// (me.py:100-184); bases are clipped to +-64, so every window sample is an
// edge-clamped reference sample and the kernels read the reference with
// clamping directly.
//
// Bound on the H100: integer operations (an absolute difference counted as
// three: the difference, its absolute value, the sum).  The searches repeat
// each other exactly: both coarse tiers search the same range at the same
// zero centre, so at every offset a tier-32 (tier-64) block's SAD is the
// sum of its 4 (16) tier-16 children's; tier 16 refines around the same
// base as its four 8-children, so its SAD at every offset is their sum.
// Counted once that way, 1080p at SR 64 costs about 1.05 G operations a
// reference (31 us), against 1.77 G for the five separate searches.
// Design:
//   * me_coarse: one CTA per (ref, tile of the largest tier), the tile's
//     source and its clamped window shared by every child in shared memory
//     as 16-bit samples (any HEVC bit depth fits); a thread per offset
//     evaluates the smallest blocks (the 4-blocks of tier 16 on the 1/4
//     planes above SR 8) and forms the larger tiers' SADs as their sums;
//     each thread keeps its first minimum per block, warps reduce (SAD,
//     offset) pairs by shuffles, the lower offset winning a tie, and one
//     thread a block walks the warps' winners in order;
//   * me_fine: a warp per task: a pair of 16-blocks with their 8-children
//     (a lane a row: 16 lanes a 16-block), a 32-block (a lane a row) or a
//     64-block (a lane two rows).  A lane holds its source row and, for
//     each dy, its window row in registers and sums the 7 dx offsets; the
//     rows meet by shuffles, so every lane works on every offset and the
//     16-block's SAD is its children's sum.  Row strides are odd in 32-bit
//     words, so the lanes' rows fall in different banks.
//   * sad_search (the earlier form): one CTA per (ref, block), a thread per
//     offset, a block-wide first-index argmin tree.

#include <cuda_runtime.h>

#include "copy_common.cuh"

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


// ---------------------------------------------------------------------------
// me_coarse

constexpr int kCoarseThreads = 256;
constexpr int kIntMax = 0x7fffffff;

// The better of two (SAD, offset) pairs: the lower SAD, then the lower
// offset (the first in dy-major order).
__device__ __forceinline__ void keep_first_min(int& s, int& i, int s2,
                                               int i2) {
  if (s2 < s || (s2 == s && i2 < i)) {
    s = s2;
    i = i2;
  }
}

// One CTA per (ref, tile): the tile holds K x K child blocks of side C on
// the search planes (the tier-16 blocks: 4-blocks on the 1/4 planes, or
// 16-blocks at full resolution), so K = 2 for a largest tier of 32, 4 for
// 64.  out16 / out32 / out64: [R, B_tier, 2] (x, y) per tier.
template <int C, int K>
__global__ void __launch_bounds__(kCoarseThreads)
    me_coarse_kernel(const int* __restrict__ src,
                     const int* __restrict__ refs, int* __restrict__ out16,
                     int* __restrict__ out32, int* __restrict__ out64, int H,
                     int W, int rng, int scale, int clip) {
  constexpr int TS = C * K;                      // tile side
  constexpr int NC = K * K;                      // tier-16 children
  constexpr int N32 = K == 4 ? 4 : (K == 2 ? 1 : 0);
  constexpr int N64 = K == 4 ? 1 : 0;
  constexpr int NV = NC + N32 + N64;             // blocks of the tile
  constexpr int kWarps = kCoarseThreads / 32;
  extern __shared__ unsigned short cs[];
  __shared__ int red_s[kWarps][NV];
  __shared__ int red_i[kWarps][NV];
  const int ws = TS + 2 * rng;                   // window side
  unsigned short* s_src = cs;                    // [TS][TS]
  unsigned short* s_win = cs + TS * TS;          // [ws][ws]
  const int tiles_x = W / TS;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int r = blockIdx.y;
  const int oy = ty * TS, ox = tx * TS;
  const int* ref = refs + (size_t)r * H * W;
  batched_copy<kCoarseThreads>(
      TS * TS, threadIdx.x,
      [&](int i) { return src[(size_t)(oy + i / TS) * W + ox + i % TS]; },
      [&](int i, int v) { s_src[i] = (unsigned short)v; });
  batched_copy<kCoarseThreads>(
      ws * ws, threadIdx.x,
      [&](int i) {
        const int yy = min(max(oy - rng + i / ws, 0), H - 1);
        const int xx = min(max(ox - rng + i % ws, 0), W - 1);
        return ref[(size_t)yy * W + xx];
      },
      [&](int i, int v) { s_win[i] = (unsigned short)v; });
  __syncthreads();

  const int n_off = 2 * rng + 1, n_all = n_off * n_off;
  int best_s[NV], best_i[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    best_s[v] = kIntMax;
    best_i[v] = n_all;
  }
  // o grows within a thread: strict < keeps each thread's first minimum
  for (int o = threadIdx.x; o < n_all; o += blockDim.x) {
    const int dy = o / n_off, dx = o - dy * n_off;
    unsigned int sad[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) sad[c] = 0;
#pragma unroll
    for (int cy = 0; cy < K; ++cy) {
#pragma unroll 4
      for (int y = 0; y < C; ++y) {
        const unsigned short* w = s_win + (dy + cy * C + y) * ws + dx;
        const unsigned short* sp = s_src + (cy * C + y) * TS;
#pragma unroll
        for (int cx = 0; cx < K; ++cx) {
          unsigned int acc = sad[cy * K + cx];
#pragma unroll
          for (int x = 0; x < C; ++x)
            acc = __sad((int)sp[cx * C + x], (int)w[cx * C + x], acc);
          sad[cy * K + cx] = acc;
        }
      }
    }
    int val[NV];
#pragma unroll
    for (int c = 0; c < NC; ++c) val[c] = (int)sad[c];
    if constexpr (K == 2) val[NC] = val[0] + val[1] + val[2] + val[3];
    if constexpr (K == 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c0 = (q / 2) * 8 + (q % 2) * 2;   // child (2qy, 2qx)
        val[NC + q] = val[c0] + val[c0 + 1] + val[c0 + 4] + val[c0 + 5];
      }
      val[NC + 4] = val[NC] + val[NC + 1] + val[NC + 2] + val[NC + 3];
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (val[v] < best_s[v]) {
        best_s[v] = val[v];
        best_i[v] = o;
      }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    int s = best_s[v], i = best_i[v];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      keep_first_min(s, i, __shfl_xor_sync(0xffffffffu, s, m),
                     __shfl_xor_sync(0xffffffffu, i, m));
    if (lane == 0) {
      red_s[warp][v] = s;
      red_i[warp][v] = i;
    }
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    const int v = threadIdx.x;
    int s = red_s[0][v], i = red_i[0][v];
    for (int w = 1; w < kWarps; ++w)
      keep_first_min(s, i, red_s[w][v], red_i[w][v]);
    const int mx = min(max((i % n_off - rng) * scale, -clip), clip);
    const int my = min(max((i / n_off - rng) * scale, -clip), clip);
    int* out;
    int gx, by, bx;
    if (v < NC) {                // a tier-16 child
      out = out16;
      gx = W / C;
      by = ty * K + v / K;
      bx = tx * K + v % K;
    } else if (v < NC + N32 && K == 4) {   // a tier-32 quarter of the tile
      out = out32;
      gx = W / (2 * C);
      by = ty * 2 + (v - NC) / 2;
      bx = tx * 2 + (v - NC) % 2;
    } else {                     // the tile: tier 32 (K = 2) or 64 (K = 4)
      out = K == 4 ? out64 : out32;
      gx = tiles_x;
      by = ty;
      bx = tx;
    }
    const int nb = (H / (W / gx)) * gx;   // blocks of the tier
    const size_t o = ((size_t)r * nb + (size_t)by * gx + bx) * 2;
    out[o] = mx;
    out[o + 1] = my;
  }
}

// ---------------------------------------------------------------------------
// me_fine

constexpr int kFineWarps = 4;
// A warp's shared region, in 16-bit samples.  A 16-pair: two 22 x 22
// windows, the second at 544 (a bank offset of 16 words, so the two halves'
// rows fall in disjoint banks), then two 16 x 18 sources.  A 32- or
// 64-block: its (n + 6)^2 window, then its n x (n + 2) source.
constexpr int kPairWin1 = 544, kPairSrc = 1088, kPairRegion = 1088 + 2 * 288;
__host__ __device__ constexpr int fine_region(int T) {
  return T == 64 ? 70 * 70 + 64 * 66
                 : (T == 32 ? 38 * 38 + 32 * 34 : kPairRegion);
}

// One n-block (n = 32 or 64) around its base: a lane a row (two rows at
// 64); out[b] = clip(base + d).
template <int NB>
__device__ void fine_block(const int* __restrict__ y,
                           const int* __restrict__ ref,
                           const int* __restrict__ base, int* __restrict__ out,
                           int b, int H, int W, int clip,
                           unsigned short* reg, int lane) {
  constexpr int WS = NB + 6, SS = NB + 2;
  unsigned short* win = reg;
  unsigned short* s = reg + WS * WS;
  const int gx = W / NB;
  const int oy = (b / gx) * NB, ox = (b % gx) * NB;
  const int bx = base[2 * b], by = base[2 * b + 1];
  batched_copy<32>(
      WS * WS, lane,
      [&](int i) {
        const int yy = min(max(oy + by - 3 + i / WS, 0), H - 1);
        const int xx = min(max(ox + bx - 3 + i % WS, 0), W - 1);
        return ref[(size_t)yy * W + xx];
      },
      [&](int i, int v) { win[i] = (unsigned short)v; });
  batched_copy<32>(
      NB * NB, lane,
      [&](int i) { return y[(size_t)(oy + i / NB) * W + ox + i % NB]; },
      [&](int i, int v) { s[(i / NB) * SS + i % NB] = (unsigned short)v; });
  __syncwarp();
  int best = kIntMax, best_i = 49;
  for (int dyi = 0; dyi < 7; ++dyi) {
    unsigned int p[7];
#pragma unroll
    for (int dx = 0; dx < 7; ++dx) p[dx] = 0;
    for (int rr = lane; rr < NB; rr += 32) {
      const unsigned short* wrow = win + (rr + dyi) * WS;
      const unsigned short* srow = s + rr * SS;
#pragma unroll 1
      for (int c0 = 0; c0 < NB; c0 += 16) {
        int sv[16], wv[22];
#pragma unroll
        for (int k = 0; k < 16; ++k) sv[k] = srow[c0 + k];
#pragma unroll
        for (int k = 0; k < 22; ++k) wv[k] = wrow[c0 + k];
#pragma unroll
        for (int dx = 0; dx < 7; ++dx)
#pragma unroll
          for (int k = 0; k < 16; ++k) p[dx] = __sad(sv[k], wv[k + dx], p[dx]);
      }
    }
#pragma unroll
    for (int dx = 0; dx < 7; ++dx) {
#pragma unroll
      for (int m = 1; m < 32; m <<= 1)
        p[dx] += __shfl_xor_sync(0xffffffffu, p[dx], m);
      if ((int)p[dx] < best) {
        best = (int)p[dx];
        best_i = dyi * 7 + dx;
      }
    }
  }
  if (lane == 0) {
    out[2 * b] = min(max(bx + best_i % 7 - 3, -clip), clip);
    out[2 * b + 1] = min(max(by + best_i / 7 - 3, -clip), clip);
  }
  __syncwarp();
}

// Two 16-blocks (2p, 2p + 1 in raster order) and their 8-children around
// the 16-block's base: lanes 0-15 the first block's rows, 16-31 the
// second's.  A lane sums the left and right 8 columns of its row apart; the
// 8 rows of a child meet by shuffles, and the 16-block's SAD is the sum of
// its children's.
__device__ void fine_pair16(const int* __restrict__ y,
                            const int* __restrict__ ref,
                            const int* __restrict__ base,
                            int* __restrict__ out8, int* __restrict__ out16,
                            int p, int B16, int H, int W, int clip,
                            unsigned short* reg, int lane) {
  const int half = lane >> 4, r = lane & 15;
  const bool live = 2 * p + half < B16;
  const int b = min(2 * p + half, B16 - 1);
  const int gx = W / 16;
  const int oy = (b / gx) * 16, ox = (b % gx) * 16;
  const int bx = base[2 * b], by = base[2 * b + 1];
  unsigned short* win = reg + half * kPairWin1;             // [22][22]
  unsigned short* s = reg + kPairSrc + half * 288;          // [16][18]
  batched_copy<16>(
      22 * 22, r,
      [&](int i) {
        const int yy = min(max(oy + by - 3 + i / 22, 0), H - 1);
        const int xx = min(max(ox + bx - 3 + i % 22, 0), W - 1);
        return ref[(size_t)yy * W + xx];
      },
      [&](int i, int v) { win[i] = (unsigned short)v; });
  batched_copy<16>(
      256, r,
      [&](int i) { return y[(size_t)(oy + i / 16) * W + ox + i % 16]; },
      [&](int i, int v) { s[(i / 16) * 18 + i % 16] = (unsigned short)v; });
  __syncwarp();
  int sv[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) sv[k] = s[r * 18 + k];
  int bl = kIntMax, il = 49, br = kIntMax, ir = 49, bs = kIntMax, is = 49;
  for (int dyi = 0; dyi < 7; ++dyi) {
    int wv[22];
#pragma unroll
    for (int k = 0; k < 22; ++k) wv[k] = win[(r + dyi) * 22 + k];
#pragma unroll
    for (int dx = 0; dx < 7; ++dx) {
      unsigned int L = 0, R = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        L = __sad(sv[k], wv[k + dx], L);
        R = __sad(sv[k + 8], wv[k + 8 + dx], R);
      }
#pragma unroll
      for (int m = 1; m < 8; m <<= 1) {
        L += __shfl_xor_sync(0xffffffffu, L, m);
        R += __shfl_xor_sync(0xffffffffu, R, m);
      }
      const unsigned int T = L + R;
      const int S = (int)(T + __shfl_xor_sync(0xffffffffu, T, 8));
      const int o = dyi * 7 + dx;
      if ((int)L < bl) {
        bl = (int)L;
        il = o;
      }
      if ((int)R < br) {
        br = (int)R;
        ir = o;
      }
      if (S < bs) {
        bs = S;
        is = o;
      }
    }
  }
  if (live && (r & 7) == 0) {
    const int gx8 = W / 8;
    const size_t c = (size_t)(oy / 8 + (r >> 3)) * gx8 + ox / 8;
    out8[2 * c] = min(max(bx + il % 7 - 3, -clip), clip);
    out8[2 * c + 1] = min(max(by + il / 7 - 3, -clip), clip);
    out8[2 * c + 2] = min(max(bx + ir % 7 - 3, -clip), clip);
    out8[2 * c + 3] = min(max(by + ir / 7 - 3, -clip), clip);
  }
  if (live && r == 0) {
    out16[2 * b] = min(max(bx + is % 7 - 3, -clip), clip);
    out16[2 * b + 1] = min(max(by + is / 7 - 3, -clip), clip);
  }
  __syncwarp();
}

// A warp a task; the tasks of a reference: its 64-blocks, its 32-blocks,
// then its pairs of 16-blocks (the longest first).  T: the largest tier.
template <int T>
__global__ void __launch_bounds__(kFineWarps * 32)
    me_fine_kernel(const int* __restrict__ y, const int* __restrict__ refs,
                   const int* __restrict__ base16,
                   const int* __restrict__ base32,
                   const int* __restrict__ base64, int* __restrict__ out8,
                   int* __restrict__ out16, int* __restrict__ out32,
                   int* __restrict__ out64, int H, int W, int clip) {
  extern __shared__ unsigned short fsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned short* reg = fsm + warp * fine_region(T);
  const int r = blockIdx.y;
  const int* ref = refs + (size_t)r * H * W;
  const int B8 = (H / 8) * (W / 8), B16 = (H / 16) * (W / 16);
  const int B32 = T >= 32 ? (H / 32) * (W / 32) : 0;
  const int B64 = T >= 64 ? (H / 64) * (W / 64) : 0;
  int task = blockIdx.x * kFineWarps + warp;
  if (T >= 64 && task < B64) {
    fine_block<64>(y, ref, base64 + (size_t)r * B64 * 2,
                   out64 + (size_t)r * B64 * 2, task, H, W, clip, reg, lane);
    return;
  }
  task -= B64;
  if (T >= 32 && task < B32) {
    fine_block<32>(y, ref, base32 + (size_t)r * B32 * 2,
                   out32 + (size_t)r * B32 * 2, task, H, W, clip, reg, lane);
    return;
  }
  task -= B32;
  if (task < (B16 + 1) / 2)
    fine_pair16(y, ref, base16 + (size_t)r * B16 * 2,
                out8 + (size_t)r * B8 * 2, out16 + (size_t)r * B16 * 2, task,
                B16, H, W, clip, reg, lane);
}

template <int C, int K>
int launch_coarse(const int* src, const int* refs, int* out16, int* out32,
                  int* out64, int R, int H, int W, int rng, int scale,
                  int clip, cudaStream_t stream) {
  constexpr int TS = C * K;
  const int ws = TS + 2 * rng;
  const size_t smem = sizeof(unsigned short) * (TS * TS + ws * ws);
  dim3 grid((H / TS) * (W / TS), R);
  me_coarse_kernel<C, K><<<grid, kCoarseThreads, smem, stream>>>(
      src, refs, out16, out32, out64, H, W, rng, scale, clip);
  return (int)cudaGetLastError();
}

template <int T>
int launch_fine(const int* y, const int* refs, const int* base16,
                const int* base32, const int* base64, int* out8, int* out16,
                int* out32, int* out64, int R, int H, int W, int clip,
                cudaStream_t stream) {
  const int smem = (int)sizeof(unsigned short) * kFineWarps * fine_region(T);
  // the opt-in above 48 KB belongs to the current device: set it on every
  // launch
  cudaError_t err = cudaFuncSetAttribute(
      me_fine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int B16 = (H / 16) * (W / 16);
  const int tasks = (T >= 64 ? (H / 64) * (W / 64) : 0) +
                    (T >= 32 ? (H / 32) * (W / 32) : 0) + (B16 + 1) / 2;
  dim3 grid((tasks + kFineWarps - 1) / kFineWarps, R);
  me_fine_kernel<T><<<grid, kFineWarps * 32, smem, stream>>>(
      y, refs, base16, base32, base64, out8, out16, out32, out64, H, W, clip);
  return (int)cudaGetLastError();
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

// src [H, W], refs [R, H, W] on the search planes (the 1/4 planes above SR
// 8); c: the tier-16 block's side there (4 or 16), k: the tile's children a
// side (1, 2 or 4 for a largest tier of 16, 32 or 64); out16 / out32 /
// out64 [R, B_tier, 2] (x, y) = clip(d * scale, -clip, clip), out32 and
// out64 NULL where the tier is not searched.
extern "C" int fhv_me_coarse(const int* src, const int* refs, int* out16,
                             int* out32, int* out64, int R, int H, int W,
                             int c, int k, int rng, int scale, int clip,
                             cudaStream_t stream) {
  if (R <= 0 || H <= 0 || W <= 0) return 0;
#define FHV_COARSE(CC, KK)                                                   \
  if (c == CC && k == KK)                                                    \
    return launch_coarse<CC, KK>(src, refs, out16, out32, out64, R, H, W,    \
                                 rng, scale, clip, stream);
  FHV_COARSE(4, 1)
  FHV_COARSE(4, 2)
  FHV_COARSE(4, 4)
  FHV_COARSE(16, 1)
  FHV_COARSE(16, 2)
  FHV_COARSE(16, 4)
#undef FHV_COARSE
  return (int)cudaErrorInvalidValue;
}

// y [H, W], refs [R, H, W]; base16/32/64 [R, B_tier, 2] the coarse bases
// (NULL above the largest tier t); out8/16/32/64 [R, B_n, 2] (x, y) the
// refined integer MVs.
extern "C" int fhv_me_fine(const int* y, const int* refs, const int* base16,
                           const int* base32, const int* base64, int* out8,
                           int* out16, int* out32, int* out64, int R, int H,
                           int W, int t, int clip, cudaStream_t stream) {
  if (R <= 0 || H <= 0 || W <= 0) return 0;
  switch (t) {
    case 16:
      return launch_fine<16>(y, refs, base16, base32, base64, out8, out16,
                             out32, out64, R, H, W, clip, stream);
    case 32:
      return launch_fine<32>(y, refs, base16, base32, base64, out8, out16,
                             out32, out64, R, H, W, clip, stream);
    case 64:
      return launch_fine<64>(y, refs, base16, base32, base64, out8, out16,
                             out32, out64, R, H, W, clip, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
