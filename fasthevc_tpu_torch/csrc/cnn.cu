// K13, K14, K15: the partition CNN of the fast-partition path.
//
// K13 replaces the forward of fasthevc_tpu/models/partition_cnn.py
// (`PartitionCNN.__call__` :30, `predict_depth_maps_device` :82, traced
// into the searches at codec/search.py:622-624, :700-702, :729-731): for
// every CTU of a batch of padded luma planes, x = (v - 128) / 128 ->
// conv3x3 s2 (1->16) -> ReLU -> conv3x3 s2 (16->32) -> ReLU -> conv3x3 s2
// (32->64) -> ReLU -> concat a qp / 51 plane -> conv3x3 s1 (65->64) -> ReLU
// -> conv1x1 (64->D) -> argmax per 8x8 granule (the first of equal logits,
// as jnp.argmax), written straight into the int16 [F, PH/8, PW/8] depth
// map.  Flax pads its stride-2 SAME convs (0, 1), the stride-1 conv (1, 1).
// Its training mode (x given as normalised f32 CTUs, one qp per CTU)
// writes the logits and the post-ReLU activations instead, for K14.
//
// K14 replaces `jax.value_and_grad` of the step of `train_self_distilled`
// (:158): from K13's logits, the gradient of the mean softmax cross-entropy
// (softmax - onehot) / (B g g), then, layer by layer, each layer's weight
// and bias gradients and the gradient of its input through the ReLU.
//
// K15 replaces `optax.adam(3e-3)`'s update of the same step: each
// operation rounded as optax rounds it (no contraction into FMAs), so it
// equals its twin bit for bit.  Its first form is one elementwise launch
// over the flat parameter, gradient and moment buffers (`fhv_adam`,
// counter `adam`, which the training no longer launches).  The training
// runs it inside K14's cooperative launch (`fhv_cnn_bwd_adam`, counter
// `cnn_backward_adam`): the thread that finishes a gradient element (the
// in-order sum of its slices, `reduce_layer`) applies the step to that
// parameter and its moments in place, with the bias corrections read from
// a [steps, 2] table uploaded once a training; the gradient itself is
// written only when the caller asks.  A step moves 1.7 MB of parameters,
// moments and gradient, half a microsecond at the card's rate; alone it
// paid a launch of 239 CTAs and a host wrapper, and K14's gradient made a
// round trip through device memory.  No barrier is added.
//
// Bound on the H100: K13 and K14 by f32 operations (about 2.46 MFLOP a
// 32-CTU for the forward: 1.23 M multiply-adds, 1,200 a byte of luma read;
// about twice that for the backward), over the CUDA cores' 67 TFLOP/s: no
// tensor core, since TF32 would flip near-tied logits.  K15 by bytes (four
// buffers read, three written).
//
// K13's first design (one CTA of 256 threads per CTU, one scalar FMA
// chain per output, every weight read through __ldg for every output)
// ran 15x its bound at the 1080p group: the 60,995 weights (244 KB) went
// through L2 again for each of the 16,320 CTAs (about 4 GB), two loads
// fed each FMA, and Conv_3 (half the multiply-adds, 150 KB of weights)
// served 16 positions a CTU.  This design runs each conv as an implicit
// GEMM: M = the output positions of T CTUs, N = the output channels, K =
// cin x 9 in (ic, ky, kx) order.  The weights stream through two shared
// stages in K-chunks (cp.async, the next chunk in flight while the
// current one is multiplied), so each chunk is read once per CTA; each
// thread keeps a register tile of up to 4 positions x 4 channels (a
// float4 of weights and 4 activations feed 16 FMAs); activations stay in
// shared memory, zero-padded, so a padded tap adds an exact 0 and every
// output's FMA chain runs in the first design's order.  Conv_0 and Conv_1
// run two CTUs at a time (one at CTU 64), Conv_2 and Conv_3 over all T
// CTUs of the CTA (at T = 4, Conv_3's 150 KB of weights serve 64
// positions).  The wrapper picks T from the batch: the largest T that
// still gives every SM its CTAs, T = 1 for a small batch (a training batch
// of 64 CTUs: 64 CTAs).
//
// K14's first design (one CTA of 256 threads per CTU, every gradient one
// thread's serial FMA chain over __ldg loads at strides no warp coalesces,
// each CTA writing a partial copy of all 60,995 gradients that a second
// launch summed over the batch) ran at 0.5% of its bound: a training batch
// of 64 CTUs filled 64 of the 132 SMs.  This design runs every gradient as
// tiled GEMMs over the whole batch, in one cooperative launch whose grid
// (the device's occupancy, at most two CTAs an SM) walks each stage's
// tiles, with a grid-wide barrier between dependent stages (dz3 -> dz2 ->
// dz1 -> dz0).  A weight gradient is M = cout x N = cin x 9 (+ the bias as
// a column of ones) over K = the batch's output positions, cut into slices
// of a fixed number of CTUs whose partial sums a later stage adds in
// order; an input gradient is M = the batch's input positions x N = cin
// over K = cout x the taps (a stride-2 layer's positions go by parity
// class, so no tap is idle), masked by the activation's sign.  Operands
// are gathered (im2col on the fly) into shared K-chunks; each thread keeps
// a register tile of up to 4 x 4 outputs, each one's FMA chain in K order.
// No float atomics: every sum's order depends on B and the CTU size alone,
// so the same inputs give the same bits on any grid.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// offsets into the flat parameter buffer (ops/cnn.py `layout`): each
// layer's OIHW kernel, then its bias
struct Layout {
  int w0, b0, w1, b1, w2, b2, w3, b3, w4, b4, total;
};

__host__ __device__ inline Layout layout_of(int D) {
  Layout o;
  o.w0 = 0;
  o.b0 = o.w0 + 16 * 1 * 9;
  o.w1 = o.b0 + 16;
  o.b1 = o.w1 + 32 * 16 * 9;
  o.w2 = o.b1 + 32;
  o.b2 = o.w2 + 64 * 32 * 9;
  o.w3 = o.b2 + 64;
  o.b3 = o.w3 + 64 * 65 * 9;
  o.w4 = o.b3 + 64;
  o.b4 = o.w4 + D * 64;
  o.total = o.b4 + D;
  return o;
}

// ---------------------------------------------------------------------------
// K13: the forward as tiled implicit GEMMs
// ---------------------------------------------------------------------------

constexpr int kChunk = 2304;  // floats of one weight stage: 36 K x 64 N

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The shared-memory plan (floats) of a CTA of T CTUs of 2^LG.  Every
// activation plane is kept zero-padded as its consumer reads it: the
// input and the stride-2 outputs one row and column past the end (flax's
// (0, 1) padding), Conv_2's output one sample all round (the stride-1
// conv's (1, 1)), with the qp / 51 plane as its 65th channel.  R1 holds
// the inputs and Conv_0's outputs of the TA CTUs in flight (two at a time
// at CTU 32, which costs no more room than Conv_2's outputs there), then
// Conv_2's output of the T CTUs; R2 the T Conv_1 outputs, then the T
// Conv_3 outputs.  ops/cnn.py `cnn_smem_bytes` mirrors this.
template <int LG, int T>
struct Plan {
  static constexpr int S = 1 << LG, H1 = S / 2, H2 = S / 4, G = S / 8;
  static constexpr int D = LG - 2;
  static constexpr int IN = (S + 1) * (S + 1);
  static constexpr int P0 = (H1 + 1) * (H1 + 1);
  static constexpr int P1 = (H2 + 1) * (H2 + 1);
  static constexpr int P2 = (G + 2) * (G + 2);
  static constexpr int P3 = G * G;
  static constexpr int A0 = 16 * P0, A1 = 32 * P1, A2 = 65 * P2;
  static constexpr int A3 = 64 * P3;
  static constexpr int TA = LG == 5 && T >= 2 ? 2 : 1;
  static constexpr int R1 = cmax(TA * (IN + A0), T * A2);
  static constexpr int R2 = cmax(T * A1, T * A3);
  static constexpr int BIAS = 2 * kChunk;  // the two weight stages first
  static constexpr int R1_AT = BIAS + 192;
  static constexpr int R2_AT = R1_AT + R1;
  static constexpr int LOG_AT = R2_AT + R2;
  static constexpr int TOTAL = LOG_AT + T * P3 * D;
};

// The register tile of a layer of M output positions and NS output
// channels: (PM positions along a row) x (PN channels), the largest that
// still gives every thread a tile (the tiles T of ops/cnn.py CNN_TILES all
// reach one).
__host__ __device__ constexpr int tile_kind(int m, int ns) {
  return (m / 4) * (ns / 4) >= kThreads   ? 0
         : (m / 2) * (ns / 4) >= kThreads ? 1
         : m * (ns / 4) >= kThreads       ? 2
                                          : 3;
}
__host__ __device__ constexpr int tile_pm(int k) {
  return k == 0 ? 4 : (k == 1 ? 2 : 1);
}
__host__ __device__ constexpr int tile_pn(int k) { return k <= 2 ? 4 : 2; }

// Conv_l's weights (OIHW) in the flat buffer: offset, K = cin * 9, input
// channels per K-chunk, input channels
struct LayerW {
  int w, K, icc, cin, cout;
};
__device__ __forceinline__ LayerW layer_w(const Layout& L, int l) {
  switch (l) {
    case 0: return {L.w0, 9, 1, 1, 16};
    case 1: return {L.w1, 144, 8, 16, 32};
    case 2: return {L.w2, 288, 4, 32, 64};
    default: return {L.w3, 585, 4, 65, 64};
  }
}

// Start the cp.async copy of weight chunk i of the CTA's sequence (for each
// of its na steps of Conv_0 and Conv_1, Conv_0's one chunk and Conv_1's
// two, then Conv_2's 8 and Conv_3's 17) into stage i & 1, laid out [k][n].
__device__ void issue_chunk(float* wst, const float* __restrict__ theta,
                            const Layout& L, int i, int na) {
  if (i >= 3 * na + 25) return;
  int l, c;
  if (i < 3 * na) {
    const int r = i % 3;
    l = r ? 1 : 0;
    c = r ? r - 1 : 0;
  } else {
    const int j = i - 3 * na;
    l = j < 8 ? 2 : 3;
    c = j < 8 ? j : j - 8;
  }
  const LayerW lw = layer_w(L, l);
  const int ns = lw.cout;
  const int kc = min(lw.icc, lw.cin - c * lw.icc) * 9;
  float* dst = wst + (i & 1) * kChunk;
  const float* src = theta + lw.w + c * lw.icc * 9;
  for (int e = threadIdx.x; e < kc * ns; e += blockDim.x) {
    const int n = e / kc, kk = e - n * kc;
    cp_async4(dst + kk * ns + n, src + (size_t)n * lw.K + kk);
  }
  cp_async_commit();
}

// One 3x3 conv as an implicit GEMM over CT CTUs: M = CT WO^2 output
// positions, N = NS channels, K = CIN * 9 walked as (ic, ky,
// kx) in chunks of ICC input channels that stream through the two weight
// stages (ci counts the CTA's chunks).  Each output's FMA chain runs in
// that order over the zero-padded input, so a padded tap adds an exact 0.
// Epilogue: relu(acc + bias) into the padded output planes and, where
// gact is given, into the saved activations (CTUs t < tv).  na: the CTA's
// steps of Conv_0 and Conv_1 (issue_chunk's sequence).
template <int CIN, int STRIDE, int WO, int CT, int NS, int ICC>
__device__ void conv_layer(float* wst, const float* __restrict__ theta,
                           const Layout& L, int& ci, int na, int tv,
                           const float* in, int in_ctu, int in_plane,
                           int in_rw, float* out, int out_ctu, int out_plane,
                           int out_rw, int opad, const float* bias,
                           float* gact, int gact_ctu) {
  constexpr int M = CT * WO * WO;
  constexpr int KIND = tile_kind(M, NS);
  constexpr int PM = tile_pm(KIND), PN = tile_pn(KIND);
  constexpr int NT = NS / PN;
  constexpr int TILES = (M / PM) * NT;
  constexpr int TPT = (TILES + kThreads - 1) / kThreads;
  float acc[TPT][PM][PN];
  int base[TPT], nof[TPT];
#pragma unroll
  for (int j = 0; j < TPT; ++j) {
    int tile = threadIdx.x + j * kThreads;
    if (tile >= TILES) tile = 0;  // computes a spare tile, never stored
    const int m0 = (tile / NT) * PM;
    const int t = m0 / (WO * WO), p = m0 - t * WO * WO;
    const int oy = p / WO, ox = p - oy * WO;
    base[j] = t * in_ctu + STRIDE * (oy * in_rw + ox);
    nof[j] = (tile % NT) * PN;
#pragma unroll
    for (int a = 0; a < PM; ++a)
#pragma unroll
      for (int b = 0; b < PN; ++b) acc[j][a][b] = 0.f;
  }
  constexpr int NCH = (CIN + ICC - 1) / ICC;
  for (int c = 0; c < NCH; ++c, ++ci) {
    cp_async_wait_all();
    __syncthreads();  // chunk ci landed; every thread is done with ci - 1
    issue_chunk(wst, theta, L, ci + 1, na);
    const float* w = wst + (ci & 1) * kChunk;
    const int icn = min(ICC, CIN - c * ICC);
    for (int icl = 0; icl < icn; ++icl) {
      const float* src = in + (c * ICC + icl) * in_plane;
      const float* wk = w + icl * 9 * NS;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* s = src + ky * in_rw + kx;
          const float* wr = wk + (ky * 3 + kx) * NS;
#pragma unroll
          for (int j = 0; j < TPT; ++j) {
            float wv[PN], av[PM];
            if constexpr (PN == 4) {
              const float4 w4 = *reinterpret_cast<const float4*>(wr + nof[j]);
              wv[0] = w4.x;
              wv[1] = w4.y;
              wv[2] = w4.z;
              wv[3] = w4.w;
            } else {
#pragma unroll
              for (int b = 0; b < PN; ++b) wv[b] = wr[nof[j] + b];
            }
#pragma unroll
            for (int a = 0; a < PM; ++a) av[a] = s[base[j] + STRIDE * a];
#pragma unroll
            for (int a = 0; a < PM; ++a)
#pragma unroll
              for (int b = 0; b < PN; ++b)
                acc[j][a][b] = __fmaf_rn(wv[b], av[a], acc[j][a][b]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < TPT; ++j) {
    const int tile = threadIdx.x + j * kThreads;
    if (tile >= TILES) continue;
    const int m0 = (tile / NT) * PM;
    const int t = m0 / (WO * WO), p = m0 - t * WO * WO;
    const int oy = p / WO, ox = p - oy * WO;
#pragma unroll
    for (int b = 0; b < PN; ++b) {
      const int n = nof[j] + b;
#pragma unroll
      for (int a = 0; a < PM; ++a) {
        const float v = fmaxf(__fadd_rn(acc[j][a][b], bias[n]), 0.f);
        out[t * out_ctu + n * out_plane + (oy + opad) * out_rw + ox + a +
            opad] = v;
        if (gact && t < tv)
          gact[(size_t)t * gact_ctu + n * WO * WO + oy * WO + ox + a] = v;
      }
    }
  }
}

// K13.  grid: ceil(CTUs / T) CTAs, CTUs in frame, then raster order.  plane [F][PH][PW] of dtype 0 uint8 or 1
// int32 (luma, normalised here) or 2 f32 (training CTUs, PH = PW = S).
// qv: one qp per frame, or null for the scalar qp.  depth (inference) or
// logits [CTUs][g][g][D] and acts [CTUs][8 S^2] (training) may be null.
template <int LG, int T>
__global__ void __launch_bounds__(kThreads)
    cnn_fwd_kernel(const void* __restrict__ plane, int dtype,
                   const float* __restrict__ qv, float qp,
                   const float* __restrict__ theta,
                   int16_t* __restrict__ depth, float* __restrict__ logits,
                   float* __restrict__ acts, int F, int PH, int PW) {
  using P = Plan<LG, T>;
  constexpr int S = P::S, G = P::G, GG = G * G, D = P::D;
  extern __shared__ __align__(16) float smem[];
  const int nx = PW >> LG, ny = PH >> LG, per_frame = nx * ny;
  const int b0 = (int)blockIdx.x * T;
  const int ta = min(T, F * per_frame - b0);
  const Layout L = layout_of(D);
  float* wst = smem;
  float* bias = smem + P::BIAS;
  constexpr int TA = P::TA;
  const int na = (ta + TA - 1) / TA;
  float* in = smem + P::R1_AT;  // TA inputs, then TA Conv_0 outputs
  float* a0 = in + TA * P::IN;
  float* a2 = smem + P::R1_AT;
  float* a1 = smem + P::R2_AT;
  float* a3 = smem + P::R2_AT;
  float* lgt = smem + P::LOG_AT;
  float* act = acts ? acts + (size_t)b0 * 8 * S * S : nullptr;
  int ci = 0;
  issue_chunk(wst, theta, L, 0, na);
  const int boff[5] = {L.b0, L.b1, L.b2, L.b3, L.b4};
  const int bat[6] = {0, 16, 48, 112, 176, 176 + D};
  for (int i = threadIdx.x; i < bat[5]; i += blockDim.x) {
    int l = 0;
    while (i >= bat[l + 1]) ++l;
    bias[i] = theta[boff[l] + i - bat[l]];
  }
  for (int i = threadIdx.x; i < TA * P::A0; i += blockDim.x) a0[i] = 0.f;
  for (int i = threadIdx.x; i < T * P::A1; i += blockDim.x) a1[i] = 0.f;
  for (int st = 0; st < na; ++st) {
    const int t0 = st * TA, tv = min(TA, ta - t0);
    for (int i = threadIdx.x; i < TA * P::IN; i += blockDim.x) {
      const int u = i / P::IN, r = i - u * P::IN;
      const int y = r / (S + 1), x = r - y * (S + 1);
      float v = 0.f;
      if (u < tv && y < S && x < S) {
        const int b = b0 + t0 + u, f = b / per_frame, c = b - f * per_frame;
        const int cy = c / nx, cx = c - cy * nx;
        const size_t k = ((size_t)f * PH + (size_t)cy * S + y) * PW +
                         (size_t)cx * S + x;
        if (dtype == 2) {
          v = ((const float*)plane)[k];
        } else {
          v = dtype ? (float)((const int32_t*)plane)[k]
                    : (float)((const uint8_t*)plane)[k];
          // (v - 128) / 128, exact in f32
          v = __fmul_rn(__fsub_rn(v, 128.f), 0.0078125f);
        }
      }
      in[i] = v;
    }
    float* g = act ? act + (size_t)t0 * 8 * S * S : nullptr;
    conv_layer<1, 2, S / 2, TA, 16, 1>(wst, theta, L, ci, na, tv, in, P::IN,
                                       0, S + 1, a0, P::A0, P::P0, S / 2 + 1,
                                       0, bias, g, 8 * S * S);
    conv_layer<16, 2, S / 4, TA, 32, 8>(
        wst, theta, L, ci, na, tv, a0, P::A0, P::P0, S / 2 + 1,
        a1 + t0 * P::A1, P::A1, P::P1, S / 4 + 1, 0, bias + 16,
        g ? g + 4 * S * S : nullptr, 8 * S * S);
  }
  __syncthreads();  // Conv_1 done: R1 becomes Conv_2's output
  // Conv_2's output padding and the qp / 51 planes, per CTU
  for (int i = threadIdx.x; i < T * P::A2; i += blockDim.x) {
    const int t = i / P::A2, r = i - t * P::A2;
    const int ch = r / P::P2, pos = r - ch * P::P2;
    const int y = pos / (G + 2), x = pos - y * (G + 2);
    const bool inside = y >= 1 && y <= G && x >= 1 && x <= G;
    if (ch < 64) {
      if (!inside) a2[i] = 0.f;
    } else {
      const int f = min(b0 + t, F * per_frame - 1) / per_frame;
      a2[i] = inside ? __fdiv_rn(qv ? qv[f] : qp, 51.f) : 0.f;
    }
  }
  conv_layer<32, 2, G, T, 64, 4>(wst, theta, L, ci, na, ta, a1, P::A1, P::P1,
                                 S / 4 + 1, a2, P::A2, P::P2, G + 2, 1,
                                 bias + 48, act ? act + 6 * S * S : nullptr,
                                 8 * S * S);
  conv_layer<65, 1, G, T, 64, 4>(wst, theta, L, ci, na, ta, a2, P::A2, P::P2,
                                 G + 2, a3, P::A3, P::P3, G, 0, bias + 112,
                                 act ? act + 7 * S * S : nullptr, 8 * S * S);
  __syncthreads();
  // Conv_4 (1x1, 64 -> D), channel order as the conv2d chain's
  for (int o = threadIdx.x; o < T * GG * D; o += blockDim.x) {
    const int t = o / (GG * D), r = o - t * GG * D;
    const int p = r / D, d = r - p * D;
    const float* wk = theta + L.w4 + d * 64;
    const float* a = a3 + t * P::A3 + p;
    float acc = 0.f;
    for (int ch = 0; ch < 64; ++ch)
      acc = __fmaf_rn(__ldg(wk + ch), a[ch * GG], acc);
    const float v = __fadd_rn(acc, bias[176 + d]);
    lgt[o] = v;
    if (logits && t < ta) logits[(size_t)(b0 + t) * GG * D + r] = v;
  }
  __syncthreads();
  if (depth) {
    for (int o = threadIdx.x; o < ta * GG; o += blockDim.x) {
      const int t = o / GG, p = o - t * GG;
      int best = 0;
      for (int d = 1; d < D; ++d)
        if (lgt[o * D + d] > lgt[o * D + best]) best = d;
      const int b = b0 + t, f = b / per_frame, c = b - f * per_frame;
      const int cy = c / nx, cx = c - cy * nx;
      const int gy = p / G, gx = p - gy * G;
      depth[((size_t)f * (PH >> 3) + cy * G + gy) * (PW >> 3) + cx * G +
            gx] = (int16_t)best;
    }
  }
}

// ---------------------------------------------------------------------------
// K14: the backward as tiled GEMMs over the batch, in one cooperative launch
// ---------------------------------------------------------------------------

// The backward's plan at CTU 2^LG for a batch of B: the layers' GEMM shapes,
// the K-slices of the weight gradients and the scratch buffer's layout.
// Layer l's weight gradient (with its bias as one more column of ones) is
// the GEMM [cout] x [NK + 1] over K = the layer's output positions of the
// batch, cut into slices of KC CTUs: each slice's partial sums go to
// scratch, and a later stage sums the slices in order.  So every sum runs
// in an order fixed by B and the CTU size alone.
struct BwdPlan {
  int cout[5], nk[5], kc[5], ns[5], pl[5];
  long long qs, dl, dz3, dz2, dz1, dz0, part[5], total;
};

constexpr int kStages = 6;  // five grid-wide barriers

__host__ __device__ inline BwdPlan bwd_plan(int lg, int B) {
  const int S = 1 << lg, H1 = S / 2, H2 = S / 4, GG = (S / 8) * (S / 8);
  const int D = lg - 2;
  const int cout[5] = {16, 32, 64, 64, D};
  const int nk[5] = {9, 16 * 9, 32 * 9, 65 * 9, 64};
  const int kc[5] = {1, 2, 4, 4, 4};  // CTUs a K-slice
  BwdPlan p;
  long long at = 0;
  p.qs = at;
  at += B;
  p.dl = at;
  at += (long long)B * GG * D;
  p.dz3 = at;
  at += (long long)B * 64 * GG;
  p.dz2 = at;
  at += (long long)B * 64 * GG;
  p.dz1 = at;
  at += (long long)B * 32 * H2 * H2;
  p.dz0 = at;
  at += (long long)B * 16 * H1 * H1;
  for (int l = 0; l < 5; ++l) {
    p.cout[l] = cout[l];
    p.nk[l] = nk[l];
    p.kc[l] = kc[l];
    p.ns[l] = (B + kc[l] - 1) / kc[l];
    p.pl[l] = cout[l] * (nk[l] + 1);
    p.part[l] = at;
    at += (long long)p.ns[l] * p.pl[l];
  }
  p.total = at;
  return p;
}

constexpr int kTK = 16;  // K-chunk of the GEMM tiles

// One output tile of a GEMM C[m][n] = sum_k A[m][k] B[k][n], m < TM, n < TN
// (tile-local), k < K.  fa(m, k) and fb(k, n) gather the operands (0 off
// the tile's edge); K-chunks of kTK are staged in shared memory, rows
// padded to TM + 1 and TN + 1 words, the next chunk's gathers in registers
// while the current one is multiplied (chunks of 64 measured slower:
// their gathers' registers spill).  A thread holds RM x RN outputs (rows
// tm + i TM/RM, columns tn + j TN/RN) and runs each one's FMA chain over
// k in order.  AM: A's gathers walk m fastest (else k); BN: B's walk n
// fastest.  fo(m, n, v) stores.  Every thread of the CTA calls it.
template <int TM, int TN, int RM, int RN, bool AM, bool BN, class FA,
          class FB, class FO>
__device__ void tile_gemm(float* sm, int K, FA fa, FB fb, FO fo) {
  constexpr int TK = kTK;
  constexpr int TMR = TM / RM, TNR = TN / RN;
  static_assert(TMR * TNR == kThreads, "one register tile a thread");
  constexpr int LA = TK * TM / kThreads, LB = TK * TN / kThreads;
  static_assert(LA * kThreads == TK * TM && LB * kThreads == TK * TN,
                "whole chunks");
  float* As = sm;                    // [TK][TM + 1]
  float* Bs = sm + TK * (TM + 1);    // [TK][TN + 1]
  const int tid = threadIdx.x;
  const int tm = tid % TMR, tn = tid / TMR;
  float ra[LA], rb[LB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = tid + i * kThreads;
      const int m = AM ? e % TM : e / TK, kk = AM ? e / TM : e % TK;
      ra[i] = k0 + kk < K ? fa(m, k0 + kk) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + i * kThreads;
      const int n = BN ? e % TN : e / TK, kk = BN ? e / TN : e % TK;
      rb[i] = k0 + kk < K ? fb(k0 + kk, n) : 0.f;
    }
  };
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = tid + i * kThreads;
      const int m = AM ? e % TM : e / TK, kk = AM ? e / TM : e % TK;
      As[kk * (TM + 1) + m] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + i * kThreads;
      const int n = BN ? e % TN : e / TK, kk = BN ? e / TN : e % TK;
      Bs[kk * (TN + 1) + n] = rb[i];
    }
    __syncthreads();
    if (k0 + TK < K) fetch(k0 + TK);
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[kk * (TM + 1) + tm + i * TMR];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = Bs[kk * (TN + 1) + tn + j * TNR];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) fo(tm + i * TMR, tn + j * TNR, acc[i][j]);
}

struct BwdArgs {
  const float* x;       // [B][S][S] normalised CTUs
  const float* qv;      // [B] qps
  const int* labels;    // [B][g][g]
  const float* theta;   // flat parameters
  const float* acts;    // [B][8 S^2] K13's saved post-ReLU activations
  const float* logits;  // [B][g][g][D]
  float* scr;           // bwd_plan's scratch
  float* grad;          // [P] (with ADAM: NULL unless the caller asks)
  int B;
  float inv_n;          // 1 / (B g g)
};

// K15's state and constants, for the form of K14 that applies the step
struct AdamArgs {
  float* theta;         // = BwdArgs::theta, updated in place
  float* m;
  float* v;
  const float* bc;      // [steps][2] f32: 1 - b1^t, 1 - b2^t at t = row + 1
  int row;
  float lr, b1, omb1, b2, omb2, eps;
};

// optax.adam's update of one parameter th and its moments m, v at one
// count, from its gradient g
__device__ __forceinline__ void adam_step(float& th, float& m, float& v,
                                          float g, float lr, float b1,
                                          float omb1, float b2, float omb2,
                                          float eps, float bc1, float bc2) {
  m = __fadd_rn(__fmul_rn(m, b1), __fmul_rn(g, omb1));
  v = __fadd_rn(__fmul_rn(v, b2), __fmul_rn(__fmul_rn(g, g), omb2));
  const float u = __fdiv_rn(__fdiv_rn(m, bc1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps));
  th = __fadd_rn(th, __fmul_rn(u, -lr));
}

// Layer l's weight-gradient items: slice s of its K, N-tile nt of TN
// columns.  A[oc][k] = dz[b][oc][p] (k = (b - s KC) KPC + p), B[k][n] = the
// input tap n of position p (n = ic * 9 + ky * 3 + kx; n == nk: 1), via
// in_tap(b, p, n).  The partial sums go to the slice's row of part[l].
// KPC: the layer's output positions a CTU, compile-time so that the
// gathers divide by a constant.
template <int TM, int TN, int RM, int RN, int KPC, class FI>
__device__ void wgrad_item(float* sm, const BwdPlan& P, const BwdArgs& a,
                           int l, const float* dz, int item, FI in_tap) {
  const int nt = (P.nk[l] + 1 + TN - 1) / TN;
  const int s = item / nt, n0 = (item - s * nt) * TN;
  const int cout = P.cout[l], ncol = P.nk[l] + 1;
  const int b0 = s * P.kc[l];
  const int K = min(P.kc[l], a.B - b0) * KPC;
  float* out = a.scr + P.part[l] + (long long)s * P.pl[l];
  tile_gemm<TM, TN, RM, RN, false, false>(
      sm, K,
      [&](int m, int k) {
        const int b = b0 + k / KPC, p = k % KPC;
        return m < cout ? dz[((long long)b * cout + m) * KPC + p] : 0.f;
      },
      [&](int k, int n) {
        const int b = b0 + k / KPC, p = k % KPC;
        const int gn = n0 + n;
        return gn < P.nk[l] ? in_tap(b, p, gn) : (gn == P.nk[l] ? 1.f : 0.f);
      },
      [&](int m, int n, float v) {
        if (m < cout && n0 + n < ncol) out[m * ncol + n0 + n] = v;
      });
}

// The input gradient of a stride-2 layer (Conv_2 or Conv_1) for one parity
// class (py, px) of its input positions (iy, ix) = (2 ty + py, 2 tx + px):
// the taps that reach them are ky in {0, 2} (py = 0) or {1}, and kx alike,
// so K = cout x those taps, walked (oc, ky, kx), with no idle tap.
// dzin[b][ic][iy][ix] = [ain > 0] sum W[oc][ic][ky][kx] dz[b][oc][oy][ox],
// oy = ty - ky / 2.  Items: M-tiles of TM positions of the class.  HO:
// the layer's output size, compile-time so that the gathers divide by a
// constant.
template <int TM, int TN, int RM, int RN, int HO>
__device__ void igrad_s2_item(float* sm, const BwdArgs& a, int cls,
                              int mtile, int cout, int cin,
                              const float* dz, const float* w,
                              const float* ain, long long ain_ctu,
                              float* dzin) {
  constexpr int ho = HO, hin = 2 * HO, pc = HO * HO;
  const int py = cls >> 1, px = cls & 1;
  const int lnx = px ? 0 : 1, lnt = (py ? 0 : 1) + lnx;
  const int m0 = mtile * TM;
  const int M = a.B * pc;
  auto pos = [&](int m, int& b, int& ty, int& tx) {
    b = m / pc;
    const int q = m - b * pc;
    ty = q / ho;
    tx = q - ty * ho;
  };
  auto tap = [&](int t, int& ky, int& kx) {
    ky = py ? 1 : 2 * (t >> lnx);
    kx = px ? 1 : 2 * (t & ((1 << lnx) - 1));
  };
  tile_gemm<TM, TN, RM, RN, true, false>(
      sm, cout << lnt,
      [&](int m, int k) {
        const int gm = m0 + m;
        if (gm >= M) return 0.f;
        int b, ty, tx, ky, kx;
        pos(gm, b, ty, tx);
        const int oc = k >> lnt;
        tap(k & ((1 << lnt) - 1), ky, kx);
        const int oy = ty - (ky >> 1), ox = tx - (kx >> 1);
        return oy >= 0 && ox >= 0
                   ? dz[((long long)b * cout + oc) * pc + oy * ho + ox]
                   : 0.f;
      },
      [&](int k, int n) {
        if (n >= cin) return 0.f;
        int ky, kx;
        tap(k & ((1 << lnt) - 1), ky, kx);
        return w[((k >> lnt) * cin + n) * 9 + ky * 3 + kx];
      },
      [&](int m, int n, float v) {
        const int gm = m0 + m;
        if (gm >= M || n >= cin) return;
        int b, ty, tx;
        pos(gm, b, ty, tx);
        const int o = (2 * ty + py) * hin + 2 * tx + px;
        const float act = ain[b * ain_ctu + (long long)n * hin * hin + o];
        dzin[((long long)b * cin + n) * hin * hin + o] = act > 0.f ? v : 0.f;
      });
}

// grad[j] of layer l = the sum of its slices' partials, in slice order.
// With ADAM the same thread then applies K15's step to parameter j and its
// moments, in place.  That is race-free because every layer's weights are
// last read before the grid barrier that precedes its reduce: W4 in stage
// A, W3 in stage B (dz2), W2 in stage C (dz1) and W1 in stage D (dz0),
// each reduced a stage later (C, C, D, E); W0 and the biases are never
// read by the backward.  A reordering of the stages that breaks this must
// write the new parameters to a second buffer instead.
template <bool ADAM>
__device__ void reduce_layer(const BwdPlan& P, const BwdArgs& a,
                             const AdamArgs& o, const Layout& L, int l) {
  const int wo[5] = {L.w0, L.w1, L.w2, L.w3, L.w4};
  const int bo[5] = {L.b0, L.b1, L.b2, L.b3, L.b4};
  const int ncol = P.nk[l] + 1;
  const float* part = a.scr + P.part[l];
  float bc1 = 0.f, bc2 = 0.f;
  if (ADAM) {
    bc1 = o.bc[2 * o.row];
    bc2 = o.bc[2 * o.row + 1];
  }
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < P.pl[l];
       j += gridDim.x * kThreads) {
    const int oc = j / ncol, n = j - oc * ncol;
    const int at = n < P.nk[l] ? wo[l] + oc * P.nk[l] + n : bo[l] + oc;
    // the step's operands, loaded before the sum so that their latency
    // overlaps the partials'
    float th = 0.f, m = 0.f, v = 0.f;
    if (ADAM) {
      th = o.theta[at];
      m = o.m[at];
      v = o.v[at];
    }
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < P.ns[l]; ++s)
      acc = __fadd_rn(acc, part[(long long)s * P.pl[l] + j]);
    if (!ADAM || a.grad != nullptr) a.grad[at] = acc;
    if (ADAM) {
      adam_step(th, m, v, acc, o.lr, o.b1, o.omb1, o.b2, o.omb2, o.eps, bc1,
                bc2);
      o.theta[at] = th;
      o.m[at] = m;
      o.v[at] = v;
    }
  }
}

// K14.  Stages, a grid-wide barrier between each: A the logits' gradient
// (softmax - onehot) / (B g g) and dz3 = [a3 > 0] W4^T dl; B Conv_4's and
// Conv_3's weight-gradient slices and dz2 (Conv_3's input gradient, over
// a2 > 0); C the sums of B's slices, Conv_2's slices and dz1; D Conv_2's
// sums, Conv_1's slices and dz0; E Conv_1's sums and Conv_0's slices; F
// Conv_0's sums.  Each stage's items (GEMM tiles) go round the grid.  With
// ADAM each sum stage also applies K15's step (`reduce_layer`).
template <int LG, bool ADAM>
__global__ void __launch_bounds__(kThreads, 2)
    cnn_bwd_kernel(BwdArgs a, AdamArgs o) {
  namespace cg = cooperative_groups;
  constexpr int S = 1 << LG, S2 = S * S, H1 = S / 2, H2 = S / 4, G = S / 8;
  constexpr int GG = G * G, D = LG - 2;
  constexpr long long ACT = 8LL * S2;  // a CTU's saved activations
  __shared__ float sm[kTK * (64 + 1) * 2];
  cg::grid_group grid = cg::this_grid();
  const BwdPlan P = bwd_plan(LG, a.B);
  const Layout L = layout_of(D);
  const int B = a.B;
  float* dl = a.scr + P.dl;
  float* dz3 = a.scr + P.dz3;
  float* dz2 = a.scr + P.dz2;
  float* dz1 = a.scr + P.dz1;
  float* dz0 = a.scr + P.dz0;
  float* qs = a.scr + P.qs;
  const float* th = a.theta;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int gthreads = gridDim.x * kThreads;

  // A: one thread per (b, channel, granule), the granule fastest; the
  // channel-0 thread of each granule writes its logits' gradient
  for (int e = gtid; e < B * 64 * GG; e += gthreads) {
    const int b = e / (64 * GG), ch = (e / GG) & 63, p = e % GG;
    if (ch == 0 && p == 0) qs[b] = __fdiv_rn(a.qv[b], 51.f);
    const float* lg = a.logits + ((long long)b * GG + p) * D;
    float m = lg[0];
#pragma unroll
    for (int d = 1; d < D; ++d) m = fmaxf(m, lg[d]);
    float ex[D], g[D], s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ex[d] = expf(__fsub_rn(lg[d], m));
      s = __fadd_rn(s, ex[d]);
    }
    const int t = a.labels[(long long)b * GG + p];
#pragma unroll
    for (int d = 0; d < D; ++d)
      g[d] = __fmul_rn(__fsub_rn(__fdiv_rn(ex[d], s), d == t ? 1.f : 0.f),
                       a.inv_n);
    if (ch == 0)
#pragma unroll
      for (int d = 0; d < D; ++d) dl[((long long)b * GG + p) * D + d] = g[d];
    float acc = 0.f;
    if (a.acts[b * ACT + 7 * S2 + ch * GG + p] > 0.f)
#pragma unroll
      for (int d = 0; d < D; ++d)
        acc = __fmaf_rn(th[L.w4 + d * 64 + ch], g[d], acc);
    dz3[e] = acc;
  }
  grid.sync();

  // B: dz2 (M-tiles of 32 positions x 2 N-tiles of 32 channels), Conv_3's
  // slices (10 N-tiles of 64), Conv_4's slices (one thread an output)
  {
    const int n_dz2 = (B * GG + 31) / 32 * 2;
    const int n_w3 = P.ns[3] * ((P.nk[3] + 64) / 64);
    for (int it = blockIdx.x; it < n_dz2 + n_w3 + P.ns[4];
         it += gridDim.x) {
      if (it < n_dz2) {
        const int m0 = (it >> 1) * 32, n0 = (it & 1) * 32;
        tile_gemm<32, 32, 2, 2, true, false>(
            sm, 64 * 9,
            [&](int m, int k) {
              const int gm = m0 + m;
              if (gm >= B * GG) return 0.f;
              const int b = gm / GG, p = gm - b * GG;
              const int oc = k / 9, t = k - oc * 9;
              const int oy = p / G - t / 3 + 1, ox = p % G - t % 3 + 1;
              return oy >= 0 && oy < G && ox >= 0 && ox < G
                         ? dz3[((long long)b * 64 + oc) * GG + oy * G + ox]
                         : 0.f;
            },
            [&](int k, int n) {
              const int oc = k / 9, t = k - oc * 9;
              return th[L.w3 + (oc * 65 + n0 + n) * 9 + t];
            },
            [&](int m, int n, float v) {
              const int gm = m0 + m;
              if (gm >= B * GG) return;
              const int b = gm / GG, p = gm - b * GG, ic = n0 + n;
              const float act = a.acts[b * ACT + 6 * S2 + ic * GG + p];
              dz2[((long long)b * 64 + ic) * GG + p] = act > 0.f ? v : 0.f;
            });
      } else if (it < n_dz2 + n_w3) {
        wgrad_item<64, 64, 4, 4, GG>(
            sm, P, a, 3, dz3, it - n_dz2, [&](int b, int p, int n) {
              const int ic = n / 9, t = n - ic * 9;
              const int iy = p / G + t / 3 - 1, ix = p % G + t % 3 - 1;
              if (iy < 0 || iy >= G || ix < 0 || ix >= G) return 0.f;
              return ic < 64 ? a.acts[b * ACT + 6 * S2 + ic * GG + iy * G + ix]
                             : qs[b];
            });
      } else {
        // Conv_4 (1x1): [D] x [65] over a slice's granules
        const int s = it - n_dz2 - n_w3, b0 = s * P.kc[4];
        const int K = min(P.kc[4], B - b0) * GG;
        for (int o = threadIdx.x; o < P.pl[4]; o += kThreads) {
          const int d = o / 65, n = o - d * 65;
          float acc = 0.f;
#pragma unroll 8
          for (int k = 0; k < K; ++k) {
            const int b = b0 + k / GG, p = k % GG;
            const float v =
                n < 64 ? a.acts[b * ACT + 7 * S2 + n * GG + p] : 1.f;
            acc = __fmaf_rn(dl[((long long)b * GG + p) * D + d], v, acc);
          }
          a.scr[P.part[4] + (long long)s * P.pl[4] + o] = acc;
        }
      }
    }
  }
  grid.sync();

  // C: Conv_4's and Conv_3's sums; dz1 (4 parity classes x M-tiles of 32),
  // Conv_2's slices (5 N-tiles of 64)
  reduce_layer<ADAM>(P, a, o, L, 4);
  reduce_layer<ADAM>(P, a, o, L, 3);
  {
    const int mt = (B * GG + 31) / 32;
    const int n_w2 = P.ns[2] * ((P.nk[2] + 64) / 64);
    for (int it = blockIdx.x; it < 4 * mt + n_w2; it += gridDim.x) {
      if (it < 4 * mt)
        igrad_s2_item<32, 32, 2, 2, G>(sm, a, it / mt, it % mt, 64, 32, dz2,
                                       th + L.w2, a.acts + 4 * S2, ACT, dz1);
      else
        wgrad_item<64, 64, 4, 4, GG>(
            sm, P, a, 2, dz2, it - 4 * mt, [&](int b, int p, int n) {
              const int ic = n / 9, t = n - ic * 9;
              const int iy = 2 * (p / G) + t / 3, ix = 2 * (p % G) + t % 3;
              return iy < H2 && ix < H2
                         ? a.acts[b * ACT + 4 * S2 + (ic * H2 + iy) * H2 + ix]
                         : 0.f;
            });
    }
  }
  grid.sync();

  // D: Conv_2's sums; dz0 (4 classes x M-tiles of 64), Conv_1's slices
  // (3 N-tiles of 64)
  reduce_layer<ADAM>(P, a, o, L, 2);
  {
    const int mt = (B * H2 * H2 + 63) / 64;
    const int n_w1 = P.ns[1] * ((P.nk[1] + 64) / 64);
    for (int it = blockIdx.x; it < 4 * mt + n_w1; it += gridDim.x) {
      if (it < 4 * mt)
        igrad_s2_item<64, 16, 4, 1, H2>(sm, a, it / mt, it % mt, 32, 16,
                                        dz1, th + L.w1, a.acts, ACT, dz0);
      else
        wgrad_item<32, 64, 2, 4, H2 * H2>(
            sm, P, a, 1, dz1, it - 4 * mt, [&](int b, int p, int n) {
              const int ic = n / 9, t = n - ic * 9;
              const int iy = 2 * (p / H2) + t / 3, ix = 2 * (p % H2) + t % 3;
              return iy < H1 && ix < H1
                         ? a.acts[b * ACT + (ic * H1 + iy) * H1 + ix]
                         : 0.f;
            });
    }
  }
  grid.sync();

  // E: Conv_1's sums; Conv_0's slices (one CTU each)
  reduce_layer<ADAM>(P, a, o, L, 1);
  for (int it = blockIdx.x; it < P.ns[0]; it += gridDim.x)
    wgrad_item<16, 16, 1, 1, H1 * H1>(sm, P, a, 0, dz0, it,
                                      [&](int b, int p, int n) {
      const int iy = 2 * (p / H1) + n / 3, ix = 2 * (p % H1) + n % 3;
      return iy < S && ix < S ? a.x[(long long)b * S2 + iy * S + ix] : 0.f;
    });
  grid.sync();

  // F: Conv_0's sums
  reduce_layer<ADAM>(P, a, o, L, 0);
}

// K15's first form: optax.adam's update at one count, in place
__global__ void adam_kernel(float* __restrict__ theta,
                            const float* __restrict__ grad,
                            float* __restrict__ m, float* __restrict__ v,
                            int P, float lr, float b1, float omb1, float b2,
                            float omb2, float eps, float bc1, float bc2) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  float th = theta[j], mj = m[j], vj = v[j];
  adam_step(th, mj, vj, grad[j], lr, b1, omb1, b2, omb2, eps, bc1, bc2);
  m[j] = mj;
  v[j] = vj;
  theta[j] = th;
}

template <int LG, int T>
int launch_fwd(const void* plane, int dtype, const float* qv, float qp,
               const float* theta, int16_t* depth, float* logits,
               float* acts, int F, int PH, int PW, int smem_bytes,
               cudaStream_t stream) {
  constexpr int kSmem = Plan<LG, T>::TOTAL * (int)sizeof(float);
  // the wrapper computes the same plan (ops/cnn.py cnn_smem_bytes)
  if (smem_bytes != kSmem) return (int)cudaErrorInvalidValue;
  auto kernel = cnn_fwd_kernel<LG, T>;
  // above 48 KB only after the opt-in, which each device holds apart:
  // set on every launch, on the caller's current device
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const int ctus = F * (PH >> LG) * (PW >> LG);
  kernel<<<(ctus + T - 1) / T, kThreads, kSmem, stream>>>(
      plane, dtype, qv, qp, theta, depth, logits, acts, F, PH, PW);
  return (int)cudaGetLastError();
}

// The backward's grid on the current device: its occupancy (at most two
// CTAs an SM) times its SMs, read on every call (a mesh's ranks may sit on
// different cards).  0 if the kernel cannot run there.
template <int LG, bool ADAM>
int bwd_grid() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cnn_bwd_kernel<LG, ADAM>, kThreads, 0) != cudaSuccess)
    return 0;
  return (per_sm < 2 ? per_sm : 2) * sms;
}

template <bool ADAM>
int launch_bwd(const BwdArgs& a, const AdamArgs& o, int log2_ctu,
               cudaStream_t stream) {
  const int grid = log2_ctu == 5 ? bwd_grid<5, ADAM>() : bwd_grid<6, ADAM>();
  if (grid <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  BwdArgs ca = a;
  AdamArgs co = o;
  void* args[] = {&ca, &co};
  const void* kernel = log2_ctu == 5 ? (const void*)cnn_bwd_kernel<5, ADAM>
                                     : (const void*)cnn_bwd_kernel<6, ADAM>;
  return (int)cudaLaunchCooperativeKernel(kernel, grid, kThreads, args, 0,
                                          stream);
}

}  // namespace

// plane dtype: 0 uint8, 1 int32 (luma, normalised here), 2 f32 (training
// CTUs, PH = PW = the CTU size).  T: CTUs a CTA (ops/cnn.py `cnn_tile` and
// its CNN_TILES); smem_bytes: the wrapper's plan of the shared memory,
// checked against the kernel's.
extern "C" int fhv_cnn_fwd(const void* plane, int dtype, const float* qv,
                           float qp, const float* theta, int16_t* depth,
                           float* logits, float* acts, int F, int PH, int PW,
                           int log2_ctu, int T, int smem_bytes,
                           cudaStream_t stream) {
  if (F <= 0 || PH <= 0 || PW <= 0) return 0;
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
#define FHV_CNN_TILE(lg, t)                                                \
  if (log2_ctu == lg && T == t)                                            \
    return launch_fwd<lg, t>(plane, dtype, qv, qp, theta, depth, logits,   \
                             acts, F, PH, PW, smem_bytes, stream);
  FHV_CNN_TILE(5, 1)
  FHV_CNN_TILE(5, 4)
  FHV_CNN_TILE(6, 1)
  FHV_CNN_TILE(6, 2)
#undef FHV_CNN_TILE
  return (int)cudaErrorInvalidValue;
}

// K14's plan for a batch of B at CTU 2^log2_ctu: out[0] the scratch floats
// the caller allocates, out[1] the grid on the current device, out[2] the
// stages (one grid-wide barrier between each)
extern "C" int fhv_cnn_bwd_plan(int B, int log2_ctu, long long* out) {
  if (B <= 0 || (log2_ctu != 5 && log2_ctu != 6))
    return (int)cudaErrorInvalidValue;
  out[0] = bwd_plan(log2_ctu, B).total;
  out[1] = log2_ctu == 5 ? bwd_grid<5, false>() : bwd_grid<6, false>();
  out[2] = kStages;
  return 0;
}

extern "C" int fhv_cnn_bwd(const float* x, const float* qv, const int* labels,
                           const float* theta, const float* acts,
                           const float* logits, float* scratch, float* grad,
                           int B, int log2_ctu, float inv_n,
                           cudaStream_t stream) {
  if (B <= 0) return 0;
  if (log2_ctu != 5 && log2_ctu != 6) return (int)cudaErrorInvalidValue;
  BwdArgs a{x, qv, labels, theta, acts, logits, scratch, grad, B, inv_n};
  return launch_bwd<false>(a, AdamArgs{}, log2_ctu, stream);
}

// K14 with K15's step at row `row` of the bias-correction table bc
// ([steps][2] f32) applied in its sums: theta, m and v updated in place;
// grad (NULL: not written) receives the gradient when the caller asks
extern "C" int fhv_cnn_bwd_adam(const float* x, const float* qv,
                                const int* labels, float* theta,
                                const float* acts, const float* logits,
                                float* scratch, float* grad, float* m,
                                float* v, const float* bc, int row, int B,
                                int log2_ctu, float inv_n, float lr, float b1,
                                float omb1, float b2, float omb2, float eps,
                                cudaStream_t stream) {
  if (B <= 0) return 0;
  if ((log2_ctu != 5 && log2_ctu != 6) || row < 0)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{x, qv, labels, theta, acts, logits, scratch, grad, B, inv_n};
  AdamArgs o{theta, m, v, bc, row, lr, b1, omb1, b2, omb2, eps};
  return launch_bwd<true>(a, o, log2_ctu, stream);
}

extern "C" int fhv_adam(float* theta, const float* grad, float* m, float* v,
                        int P, float lr, float b1, float omb1, float b2,
                        float omb2, float eps, float bc1, float bc2,
                        cudaStream_t stream) {
  if (P <= 0) return 0;
  adam_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      theta, grad, m, v, P, lr, b1, omb1, b2, omb2, eps, bc1, bc2);
  return (int)cudaGetLastError();
}
