// K1: HEVC intra prediction for B blocks x M modes (spec 8.4.4.2).
//
// Replaces fasthevc_tpu/ops/intra.py predict_all_modes (:171) and
// predict_selected (:239).  Planar, DC with the luma edge filters for n<32,
// the 33 angular modes with the inverse-angle reference extension, the
// [1 2 1] reference smoothing chosen per mode (spec.intra.should_filter),
// and the mode 10/26 boundary filters (the per-sample formula is shared
// with K5 through intra_common.cuh).
//
// Bound on the H100: device-memory writes.  The output [B, M, n, n] int32
// is 35 * n^2 * 4 bytes per block (292 MB per 1080p frame at every n)
// from 2 * (2n+1) reference samples read, so the kernel is a store stream.
// Design: one CTA of 256 threads per group of blocks (enough blocks that
// the CTA has >= 256 samples to write); the blocks' references, filtered
// references and DC values live in shared memory, and every thread
// computes its samples with the spec's integer formula, consecutive
// threads writing consecutive samples (coalesced stores).  The JAX
// package's dense f32 reference-to-prediction matrix is a TPU matrix-unit
// workaround and is not carried over.

#include <cuda_runtime.h>

#include "intra_common.cuh"

namespace {

constexpr int kThreads = 256;

// mode_tab: [3][35] int32 = angle, inverse angle, use-filtered-refs flag.
__global__ void intra_pred_kernel(const int* __restrict__ top,
                                  const int* __restrict__ left,
                                  const int* __restrict__ modes,
                                  const int* __restrict__ mode_tab,
                                  int* __restrict__ out, int B, int n, int lg,
                                  int M, int edge, int max_val, int bpc) {
  extern __shared__ int sm[];
  const int L = 2 * n + 1;
  const int stride = 4 * L + 1;  // top, left, top_f, left_f, dc
  int* tab = sm;                 // 3 * 35
  int* refs = sm + 3 * 35;
  const int b0 = blockIdx.x * bpc;
  const int nb = min(bpc, B - b0);

  for (int i = threadIdx.x; i < 3 * 35; i += blockDim.x) tab[i] = mode_tab[i];
  for (int i = threadIdx.x; i < nb * L; i += blockDim.x) {
    const int j = i / L, k = i - j * L;
    refs[j * stride + k] = top[(size_t)(b0 + j) * L + k];
    refs[j * stride + L + k] = left[(size_t)(b0 + j) * L + k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * L; i += blockDim.x) {
    const int j = i / L, k = i - j * L;
    const int* t = refs + j * stride;
    const int* l = t + L;
    intra_filter_ref(t, l, k, L, &refs[j * stride + 2 * L + k],
                     &refs[j * stride + 3 * L + k]);
    if (k == 0) refs[j * stride + 4 * L] = intra_dc(t, l, n, lg);
  }
  __syncthreads();

  const int nn = n * n;
  const int per = M * nn;
  for (int i = threadIdx.x; i < nb * per; i += blockDim.x) {
    const int j = i / per;
    const int r = i - j * per;
    const int mi = r / nn;
    const int p = r - mi * nn;
    const int y = p >> lg, x = p & (n - 1);
    const int b = b0 + j;
    const int mode = modes ? modes[(size_t)b * M + mi] : mi;
    const int* t = refs + j * stride;
    const int* l = t + L;
    const bool filt = tab[70 + mode] != 0;
    const int v = intra_sample(mode, x, y, n, lg, t, l, filt ? t + 2 * L : t,
                               filt ? t + 3 * L : l, t[4 * L], tab[mode],
                               tab[35 + mode], edge, max_val);
    out[(size_t)b * per + r] = v;
  }
}

}  // namespace

extern "C" int fhv_intra_pred(const int* top, const int* left,
                              const int* modes, const int* mode_tab, int* out,
                              int B, int n, int lg, int M, int edge,
                              int max_val, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int per = M * n * n;
  const int bpc = per >= kThreads ? 1 : kThreads / per;
  const int grid = (B + bpc - 1) / bpc;
  const size_t smem = sizeof(int) * (3 * 35 + bpc * (4 * (2 * n + 1) + 1));
  intra_pred_kernel<<<grid, kThreads, smem, stream>>>(
      top, left, modes, mode_tab, out, B, n, lg, M, edge, max_val, bpc);
  return (int)cudaGetLastError();
}
