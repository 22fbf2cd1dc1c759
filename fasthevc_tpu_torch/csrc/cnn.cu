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
// and bias gradients and the gradient of its input through the ReLU.  One
// CTA per CTU writes its partial sums of every parameter gradient; a second
// launch sums them over the batch in CTU order (deterministic, no float
// atomics).
//
// K15 replaces `optax.adam(3e-3)`'s update of the same step: one
// elementwise pass over the flat parameter, gradient and moment buffers,
// each operation rounded as optax rounds it (no contraction into FMAs),
// so it equals its twin bit for bit.
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
// The backward keeps the gradient planes in two shared buffers of 2 S^2
// and 4 S^2 floats and reads the saved activations from global memory.

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

// shared floats for a CTU of S: buffers of 2 S^2 and 4 S^2, then the
// logits or their gradient (at most 64 granules x 4 depths)
__host__ __device__ inline int smem_floats(int S) { return 6 * S * S + 256; }

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

// the sum over positions of each output channel's gradient: the bias
// gradient of one CTU
__device__ void bias_grad(const float* dz, int cout, int hw, float* gb) {
  for (int oc = threadIdx.x; oc < cout; oc += blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < hw; ++p) acc = __fadd_rn(acc, dz[oc * hw + p]);
    gb[oc] = acc;
  }
}

// The gradients of one stride-2 layer of one CTU: dz [cout][ho][ho] the
// gradient of its pre-ReLU output (shared), in [cin][hin][hin] its input
// (global: the previous layer's saved post-ReLU activations, or x).
// Writes the weight and bias gradients to gw, gb and, when dzin is given,
// the gradient of the previous layer's pre-ReLU output: the transposed
// convolution of dz, zero where that layer's output was not positive.
__device__ void conv_s2_grads(const float* dz, int cout, int ho,
                              const float* __restrict__ in, int cin, int hin,
                              const float* __restrict__ w, float* gw,
                              float* gb, float* dzin) {
  const int hw = ho * ho;
  for (int o = threadIdx.x; o < cout * cin * 9; o += blockDim.x) {
    const int oc = o / (cin * 9);
    int r = o - oc * cin * 9;
    const int ic = r / 9;
    r -= ic * 9;
    const int ky = r / 3, kx = r - ky * 3;
    const float* src = in + ic * hin * hin;
    const float* d = dz + oc * hw;
    float acc = 0.f;
    for (int oy = 0; oy < ho; ++oy) {
      const int iy = 2 * oy + ky;
      if (iy >= hin) continue;
      for (int ox = 0; ox < ho; ++ox) {
        const int ix = 2 * ox + kx;
        if (ix >= hin) continue;
        acc = __fmaf_rn(d[oy * ho + ox], __ldg(src + iy * hin + ix), acc);
      }
    }
    gw[o] = acc;
  }
  bias_grad(dz, cout, hw, gb);
  if (!dzin) return;
  const int h2 = hin * hin;
  for (int o = threadIdx.x; o < cin * h2; o += blockDim.x) {
    const int ic = o / h2, p = o - ic * h2;
    const int iy = p / hin, ix = p - iy * hin;
    float acc = 0.f;
    if (__ldg(in + o) > 0.f) {
      for (int oc = 0; oc < cout; ++oc) {
        const float* wk = w + (oc * cin + ic) * 9;
        for (int ky = iy & 1; ky < 3; ky += 2) {
          const int oy = (iy - ky) >> 1;
          if (oy < 0 || oy >= ho) continue;
          for (int kx = ix & 1; kx < 3; kx += 2) {
            const int ox = (ix - kx) >> 1;
            if (ox < 0 || ox >= ho) continue;
            acc = __fmaf_rn(__ldg(wk + ky * 3 + kx),
                            dz[oc * hw + oy * ho + ox], acc);
          }
        }
      }
    }
    dzin[o] = acc;
  }
}

// K14, first launch: one CTA per CTU writes its partial parameter
// gradients, partial [B][P].
__global__ void __launch_bounds__(kThreads)
    cnn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ qv,
                   const int* __restrict__ labels,
                   const float* __restrict__ theta,
                   const float* __restrict__ acts,
                   const float* __restrict__ logits,
                   float* __restrict__ partial, int lg, float inv_n) {
  extern __shared__ float smem[];
  const int S = 1 << lg, S2 = S * S, g = S >> 3, gg = g * g, D = lg - 2;
  const int b = blockIdx.x;
  const Layout L = layout_of(D);
  float* bufA = smem;
  float* bufB = smem + 2 * S2;
  float* dl = smem + 6 * S2;
  const float* a0 = acts + (size_t)b * 8 * S2;  // [16][S/2][S/2]
  const float* a1 = a0 + 4 * S2;                // [32][S/4][S/4]
  const float* a2 = a0 + 6 * S2;                // [64][g][g]
  const float* a3 = a0 + 7 * S2;                // [64][g][g]
  float* pg = partial + (size_t)b * L.total;
  const float q = __fdiv_rn(qv[b], 51.f);

  // the logits' gradient: (softmax - onehot) / (B g g)
  for (int p = threadIdx.x; p < gg; p += blockDim.x) {
    const float* l = logits + ((size_t)b * gg + p) * D;
    float m = l[0];
    for (int d = 1; d < D; ++d) m = fmaxf(m, l[d]);
    float e[4], s = 0.f;
    for (int d = 0; d < D; ++d) {
      e[d] = expf(__fsub_rn(l[d], m));
      s = __fadd_rn(s, e[d]);
    }
    const int t = labels[(size_t)b * gg + p];
    for (int d = 0; d < D; ++d)
      dl[p * D + d] =
          __fmul_rn(__fsub_rn(__fdiv_rn(e[d], s), d == t ? 1.f : 0.f), inv_n);
  }
  __syncthreads();

  // Conv_4 (1x1, 64 -> D): its gradients, and dz3 = [a3 > 0] W4^T dl
  for (int o = threadIdx.x; o < D * 64; o += blockDim.x) {
    const int d = o >> 6, ch = o & 63;
    float acc = 0.f;
    for (int p = 0; p < gg; ++p)
      acc = __fmaf_rn(dl[p * D + d], __ldg(a3 + ch * gg + p), acc);
    pg[L.w4 + o] = acc;
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < gg; ++p) acc = __fadd_rn(acc, dl[p * D + d]);
    pg[L.b4 + d] = acc;
  }
  for (int o = threadIdx.x; o < 64 * gg; o += blockDim.x) {
    const int ch = o / gg, p = o - ch * gg;
    float acc = 0.f;
    if (__ldg(a3 + o) > 0.f)
      for (int d = 0; d < D; ++d)
        acc = __fmaf_rn(__ldg(theta + L.w4 + d * 64 + ch), dl[p * D + d],
                        acc);
    bufA[o] = acc;
  }
  __syncthreads();

  // Conv_3 (3x3 s1, 65 -> 64): its gradients over a2 and the qp plane,
  // and dz2 = [a2 > 0] (the transposed convolution of dz3)
  for (int o = threadIdx.x; o < 64 * 65 * 9; o += blockDim.x) {
    const int oc = o / 585;
    int r = o - oc * 585;
    const int ic = r / 9;
    r -= ic * 9;
    const int ky = r / 3, kx = r - ky * 3;
    float acc = 0.f;
    for (int oy = 0; oy < g; ++oy) {
      const int iy = oy + ky - 1;
      if (iy < 0 || iy >= g) continue;
      for (int ox = 0; ox < g; ++ox) {
        const int ix = ox + kx - 1;
        if (ix < 0 || ix >= g) continue;
        const float v = ic < 64 ? __ldg(a2 + ic * gg + iy * g + ix) : q;
        acc = __fmaf_rn(bufA[oc * gg + oy * g + ox], v, acc);
      }
    }
    pg[L.w3 + o] = acc;
  }
  bias_grad(bufA, 64, gg, pg + L.b3);
  for (int o = threadIdx.x; o < 64 * gg; o += blockDim.x) {
    const int ic = o / gg, p = o - ic * gg;
    const int iy = p / g, ix = p - iy * g;
    float acc = 0.f;
    if (__ldg(a2 + o) > 0.f) {
      for (int oc = 0; oc < 64; ++oc) {
        const float* wk = theta + L.w3 + (oc * 65 + ic) * 9;
        for (int ky = 0; ky < 3; ++ky) {
          const int oy = iy - ky + 1;
          if (oy < 0 || oy >= g) continue;
          for (int kx = 0; kx < 3; ++kx) {
            const int ox = ix - kx + 1;
            if (ox < 0 || ox >= g) continue;
            acc = __fmaf_rn(__ldg(wk + ky * 3 + kx),
                            bufA[oc * gg + oy * g + ox], acc);
          }
        }
      }
    }
    bufB[o] = acc;
  }
  __syncthreads();

  // Conv_2 (32 -> 64 over a1), Conv_1 (16 -> 32 over a0), Conv_0 (1 -> 16
  // over x, no input gradient)
  conv_s2_grads(bufB, 64, g, a1, 32, S >> 2, theta + L.w2, pg + L.w2,
                pg + L.b2, bufA);
  __syncthreads();
  conv_s2_grads(bufA, 32, S >> 2, a0, 16, S >> 1, theta + L.w1, pg + L.w1,
                pg + L.b1, bufB);
  __syncthreads();
  conv_s2_grads(bufB, 16, S >> 1, x + (size_t)b * S2, 1, S, theta + L.w0,
                pg + L.w0, pg + L.b0, nullptr);
}

// K14, second launch: grad[j] = sum over the batch of partial[b][j], in
// CTU order
__global__ void grad_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ grad, int B, int P) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc = __fadd_rn(acc, partial[(size_t)b * P + j]);
  grad[j] = acc;
}

// K15: optax.adam's update at one count, in place
__global__ void adam_kernel(float* __restrict__ theta,
                            const float* __restrict__ grad,
                            float* __restrict__ m, float* __restrict__ v,
                            int P, float lr, float b1, float omb1, float b2,
                            float omb2, float eps, float bc1, float bc2) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  const float gj = grad[j];
  const float mj = __fadd_rn(__fmul_rn(m[j], b1), __fmul_rn(gj, omb1));
  const float vj =
      __fadd_rn(__fmul_rn(v[j], b2), __fmul_rn(__fmul_rn(gj, gj), omb2));
  const float u = __fdiv_rn(__fdiv_rn(mj, bc1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(vj, bc2)), eps));
  m[j] = mj;
  v[j] = vj;
  theta[j] = __fadd_rn(theta[j], __fmul_rn(u, -lr));
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

extern "C" int fhv_cnn_bwd(const float* x, const float* qv, const int* labels,
                           const float* theta, const float* acts,
                           const float* logits, float* partial, float* grad,
                           int B, int log2_ctu, float inv_n,
                           cudaStream_t stream) {
  if (B <= 0) return 0;
  // the opt-in above 48 KB is per device: set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      cnn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(64) * (int)sizeof(float));
  if (e != cudaSuccess) return (int)e;
  cnn_bwd_kernel<<<B, kThreads, smem_floats(1 << log2_ctu) * sizeof(float),
                   stream>>>(x, qv, labels, theta, acts, logits, partial,
                             log2_ctu, inv_n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int P = layout_of(log2_ctu - 2).total;
  grad_reduce_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, grad, B, P);
  return (int)cudaGetLastError();
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
