// The per-block SSE and level-rate proxy of the intra search: K4
// (sse_rate.cu) over levels and residuals in device memory, and the costed
// form of K3 (tq_roundtrip.cu `tq_cost`) over its own shared-memory tiles.
// The f32 sum of the log2 terms is the one order-sensitive part: lane l of
// a warp takes samples l, l + 32, ... of the block in raster order, then
// the partial sums meet in a __shfl_down_sync tree of offsets 16 ... 1
// (`esclog_tree`).  The model's f32 arithmetic uses round-to-nearest
// intrinsics in the reference's order (no contraction into fused
// multiply-adds).  Both kernels run this code, so their rates agree bit
// for bit.
#pragma once

struct RateLane {
  long long sse = 0;
  int ones = 0, twos = 0, esc = 0, last = -1;
  float esclog = 0.f;
};

// K4's f32 term of a level: log2(1 + |l|) where |l| > 2 (else no term)
__device__ __forceinline__ float rate_term(int a) {
  return log2f(__fadd_rn(1.f, (float)a));
}

// sample i (raster order) of an n x n block, n = 2^lg: its level
__device__ __forceinline__ void rate_level(RateLane& r, int lv, int i,
                                           int lg, int n) {
  const int a = abs(lv);
  r.ones += a == 1;
  r.twos += a == 2;
  if (a > 2) {
    ++r.esc;
    r.esclog = __fadd_rn(r.esclog, rate_term(a));
  }
  if (a > 0) r.last = max(r.last, (i >> lg) + (i & (n - 1)));
}

// the lanes' f32 partial sums meet in lane 0, in K4's order
__device__ __forceinline__ float esclog_tree(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// The linear bit model (weights w[6]) over a block's totals: dist (the
// exact SSE rounded once to f32) and rate.
__device__ __forceinline__ void rate_model(const RateLane& r, const float* w,
                                           float* dist, float* rate) {
  *dist = (float)r.sse;
  if (r.last < 0) {
    *rate = 0.f;
    return;
  }
  const float fo = (float)r.ones, ft = (float)r.twos, fe = (float)r.esc;
  float bits = __fmul_rn(w[0], fo);
  bits = __fadd_rn(bits, __fmul_rn(w[1], ft));
  bits = __fadd_rn(bits, __fmul_rn(w[2], fe));
  bits = __fadd_rn(bits, __fmul_rn(w[3], r.esclog));
  bits = __fadd_rn(bits, __fmul_rn(w[4], log2f(__fadd_rn(1.f, (float)r.last))));
  bits = __fadd_rn(bits, w[5]);
  const float floor_bits = __fadd_rn(__fadd_rn(__fadd_rn(2.f, fo), ft), fe);
  *rate = fmaxf(bits, floor_bits);
}

// The warp's reduction of its lanes' sums, then lane 0 writes the model.
__device__ __forceinline__ void rate_finish(RateLane r, int lane,
                                            const float* w, float* dist,
                                            float* rate) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r.sse += __shfl_down_sync(0xffffffffu, r.sse, off);
    r.ones += __shfl_down_sync(0xffffffffu, r.ones, off);
    r.twos += __shfl_down_sync(0xffffffffu, r.twos, off);
    r.esc += __shfl_down_sync(0xffffffffu, r.esc, off);
    r.last = max(r.last, __shfl_down_sync(0xffffffffu, r.last, off));
  }
  r.esclog = esclog_tree(r.esclog);
  if (lane == 0) rate_model(r, w, dist, rate);
}
