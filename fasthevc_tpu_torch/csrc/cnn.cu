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
// buffers read, three written).  Design: one CTA of 256 threads per
// CTU (per (frame, CTU) over the whole batch, one launch per search call);
// the activations ping-pong between two shared buffers of 2 S^2 and 4 S^2
// floats (24 KB at CTU 32, 96 KB at CTU 64, which needs the dynamic shared
// memory opt-in, set once at the first launch); each thread computes
// outputs in a block-stride loop, reading the 60,995 weights (244 KB, too
// many for shared memory) from global memory through the read-only cache.
// The backward keeps the gradient planes in the same two shared buffers
// and reads the saved activations from global memory.

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

// conv3x3 stride 2, padding (0, 1): out[oc][oy][ox] = relu(b[oc] +
// sum_{ic,ky,kx} w[oc][ic][ky][kx] in[ic][2oy+ky][2ox+kx]), the row and
// column past the input reading 0; stored in shared memory and, when gout
// is given, in global memory too (K13's training mode)
__device__ void conv_s2(const float* in, int cin, int hin, float* out,
                        int cout, const float* __restrict__ w,
                        const float* __restrict__ b, float* gout) {
  const int ho = hin >> 1, hw = ho * ho;
  for (int o = threadIdx.x; o < cout * hw; o += blockDim.x) {
    const int oc = o / hw, p = o - oc * hw;
    const int oy = p / ho, ox = p - oy * ho;
    float acc = 0.f;
    for (int ic = 0; ic < cin; ++ic) {
      const float* src = in + ic * hin * hin;
      const float* wk = w + (oc * cin + ic) * 9;
      for (int ky = 0; ky < 3; ++ky) {
        const int iy = 2 * oy + ky;
        if (iy >= hin) continue;
        for (int kx = 0; kx < 3; ++kx) {
          const int ix = 2 * ox + kx;
          if (ix >= hin) continue;
          acc = __fmaf_rn(__ldg(wk + ky * 3 + kx), src[iy * hin + ix], acc);
        }
      }
    }
    const float v = fmaxf(__fadd_rn(acc, __ldg(b + oc)), 0.f);
    out[o] = v;
    if (gout) gout[o] = v;
  }
}

// conv3x3 stride 1, padding (1, 1), over the 64 channels of in [64][g][g]
// and a 65th channel that holds q inside the picture and 0 in the padding
__device__ void conv_s1q(const float* in, int g, float q, float* out,
                         const float* __restrict__ w,
                         const float* __restrict__ b, float* gout) {
  const int gg = g * g;
  for (int o = threadIdx.x; o < 64 * gg; o += blockDim.x) {
    const int oc = o / gg, p = o - oc * gg;
    const int oy = p / g, ox = p - oy * g;
    float acc = 0.f;
    for (int ic = 0; ic < 65; ++ic) {
      const float* wk = w + (oc * 65 + ic) * 9;
      for (int ky = 0; ky < 3; ++ky) {
        const int iy = oy + ky - 1;
        if (iy < 0 || iy >= g) continue;
        for (int kx = 0; kx < 3; ++kx) {
          const int ix = ox + kx - 1;
          if (ix < 0 || ix >= g) continue;
          const float v = ic < 64 ? in[ic * gg + iy * g + ix] : q;
          acc = __fmaf_rn(__ldg(wk + ky * 3 + kx), v, acc);
        }
      }
    }
    const float v = fmaxf(__fadd_rn(acc, __ldg(b + oc)), 0.f);
    out[o] = v;
    if (gout) gout[o] = v;
  }
}

// K13.  grid (CTUs of a frame, F).  plane [F][PH][PW] of T (inference:
// uint8 or int32 luma, normalised here; training: f32 CTUs with PH = PW =
// S, taken as they are).  qv: one qp per frame, or null for the scalar qp.
// depth (inference) or logits [F][g][g][D] and acts [F][8 S^2] (training)
// may be null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cnn_fwd_kernel(const T* __restrict__ plane, int normalise,
                   const float* __restrict__ qv, float qp,
                   const float* __restrict__ theta,
                   int16_t* __restrict__ depth, float* __restrict__ logits,
                   float* __restrict__ acts, int PH, int PW, int lg) {
  extern __shared__ float smem[];
  const int S = 1 << lg, S2 = S * S, g = S >> 3, gg = g * g, D = lg - 2;
  const int nx = PW >> lg, ny = PH >> lg;
  const int f = blockIdx.y, c = blockIdx.x;
  const int cy = c / nx, cx = c - cy * nx;
  const size_t ctu = (size_t)f * ny * nx + c;
  const Layout L = layout_of(D);
  float* bufA = smem;
  float* bufB = smem + 2 * S2;
  float* lgt = smem + 6 * S2;
  const T* src = plane + ((size_t)f * PH + (size_t)cy * S) * PW
                 + (size_t)cx * S;
  for (int i = threadIdx.x; i < S2; i += blockDim.x) {
    const float v = (float)src[(size_t)(i >> lg) * PW + (i & (S - 1))];
    // (v - 128) / 128, exact in f32
    bufA[i] = normalise ? __fmul_rn(__fsub_rn(v, 128.f), 0.0078125f) : v;
  }
  __syncthreads();
  float* act = acts ? acts + ctu * 8 * S2 : nullptr;
  conv_s2(bufA, 1, S, bufB, 16, theta + L.w0, theta + L.b0, act);
  __syncthreads();
  conv_s2(bufB, 16, S >> 1, bufA, 32, theta + L.w1, theta + L.b1,
          act ? act + 4 * S2 : nullptr);
  __syncthreads();
  conv_s2(bufA, 32, S >> 2, bufB, 64, theta + L.w2, theta + L.b2,
          act ? act + 6 * S2 : nullptr);
  __syncthreads();
  const float q = __fdiv_rn(qv ? qv[f] : qp, 51.f);
  conv_s1q(bufB, g, q, bufA, theta + L.w3, theta + L.b3,
           act ? act + 7 * S2 : nullptr);
  __syncthreads();
  for (int o = threadIdx.x; o < gg * D; o += blockDim.x) {
    const int p = o / D, d = o - p * D;
    const float* wk = theta + L.w4 + d * 64;
    float acc = 0.f;
    for (int ch = 0; ch < 64; ++ch)
      acc = __fmaf_rn(__ldg(wk + ch), bufA[ch * gg + p], acc);
    const float v = __fadd_rn(acc, __ldg(theta + L.b4 + d));
    lgt[o] = v;
    if (logits) logits[ctu * gg * D + o] = v;
  }
  __syncthreads();
  if (!depth) return;
  for (int p = threadIdx.x; p < gg; p += blockDim.x) {
    int best = 0;
    for (int d = 1; d < D; ++d)
      if (lgt[p * D + d] > lgt[p * D + best]) best = d;
    const int gy = p / g, gx = p - gy * g;
    depth[((size_t)f * (PH >> 3) + cy * g + gy) * (PW >> 3) + cx * g + gx] =
        (int16_t)best;
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

template <typename T>
int launch_fwd(const void* plane, int normalise, const float* qv, float qp,
               const float* theta, int16_t* depth, float* logits,
               float* acts, int F, int PH, int PW, int lg,
               cudaStream_t stream) {
  // above 48 KB (CTU 64) only after the opt-in, set once per instantiation
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        cnn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats(64) * (int)sizeof(float));
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const dim3 grid((PH >> lg) * (PW >> lg), F);
  cnn_fwd_kernel<T><<<grid, kThreads, smem_floats(1 << lg) * sizeof(float),
                      stream>>>((const T*)plane, normalise, qv, qp, theta,
                                depth, logits, acts, PH, PW, lg);
  return (int)cudaGetLastError();
}

}  // namespace

// plane dtype: 0 uint8, 1 int32 (luma, normalised here), 2 f32 (training
// CTUs, PH = PW = the CTU size)
extern "C" int fhv_cnn_fwd(const void* plane, int dtype, const float* qv,
                           float qp, const float* theta, int16_t* depth,
                           float* logits, float* acts, int F, int PH, int PW,
                           int log2_ctu, cudaStream_t stream) {
  if (F <= 0 || PH <= 0 || PW <= 0) return 0;
  switch (dtype) {
    case 0:
      return launch_fwd<uint8_t>(plane, 1, qv, qp, theta, depth, logits,
                                 acts, F, PH, PW, log2_ctu, stream);
    case 1:
      return launch_fwd<int32_t>(plane, 1, qv, qp, theta, depth, logits,
                                 acts, F, PH, PW, log2_ctu, stream);
    case 2:
      return launch_fwd<float>(plane, 0, qv, qp, theta, depth, logits, acts,
                               F, PH, PW, log2_ctu, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fhv_cnn_bwd(const float* x, const float* qv, const int* labels,
                           const float* theta, const float* acts,
                           const float* logits, float* partial, float* grad,
                           int B, int log2_ctu, float inv_n,
                           cudaStream_t stream) {
  if (B <= 0) return 0;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        cnn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats(64) * (int)sizeof(float));
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  cnn_bwd_kernel<<<B, kThreads, smem_floats(1 << log2_ctu) * sizeof(float),
                   stream>>>(x, qv, labels, theta, acts, logits, partial,
                             log2_ctu, inv_n);
  cudaError_t e = cudaGetLastError();
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
