// K1: HEVC intra prediction for B blocks x M modes (spec 8.4.4.2).
//
// Replaces fasthevc_tpu/ops/intra.py predict_all_modes (:171) and
// predict_selected (:239).  Planar, DC with the luma edge filters for n<32,
// the 33 angular modes with the inverse-angle reference extension, the
// [1 2 1] reference smoothing chosen per mode (spec.intra.should_filter),
// and the mode 10/26 boundary filters.
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
    int tf, lf;
    if (k == 0) {
      tf = lf = (l[1] + 2 * t[0] + t[1] + 2) >> 2;
    } else if (k == L - 1) {
      tf = t[k];
      lf = l[k];
    } else {
      tf = (t[k - 1] + 2 * t[k] + t[k + 1] + 2) >> 2;
      lf = (l[k - 1] + 2 * l[k] + l[k + 1] + 2) >> 2;
    }
    refs[j * stride + 2 * L + k] = tf;
    refs[j * stride + 3 * L + k] = lf;
    if (k == 0) {
      int dc = n;
      for (int q = 1; q <= n; ++q) dc += t[q] + l[q];
      refs[j * stride + 4 * L] = dc >> (lg + 1);
    }
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
    const int* ft = filt ? t + 2 * L : t;
    const int* fl = filt ? t + 3 * L : l;
    int v;
    if (mode == 0) {  // planar
      v = ((n - 1 - x) * fl[1 + y] + (x + 1) * ft[n + 1] +
           (n - 1 - y) * ft[1 + x] + (y + 1) * fl[n + 1] + n) >> (lg + 1);
    } else if (mode == 1) {  // DC
      const int dc = t[4 * L];
      v = dc;
      if (edge) {
        if (x == 0 && y == 0)
          v = (l[1] + 2 * dc + t[1] + 2) >> 2;
        else if (y == 0)
          v = (t[1 + x] + 3 * dc + 2) >> 2;
        else if (x == 0)
          v = (l[1 + y] + 3 * dc + 2) >> 2;
      }
    } else {  // angular 2..34; modes < 18 are the transpose of vertical
      const int angle = tab[mode];
      const int inv = tab[35 + mode];
      const bool vert = mode >= 18;
      const int* main_ref = vert ? ft : fl;
      const int* side_ref = vert ? fl : ft;
      const int yy = vert ? y : x;
      const int xx = vert ? x : y;
      const int pos = (yy + 1) * angle;
      const int idx = pos >> 5, fact = pos & 31;
      const int ka = xx + idx + 1;
      const int kb = min(xx + idx + 2, 2 * n);
      const int a = ka >= 0 ? main_ref[ka] : side_ref[(ka * inv + 128) >> 8];
      const int c = kb >= 0 ? main_ref[kb] : side_ref[(kb * inv + 128) >> 8];
      v = ((32 - fact) * a + fact * c + 16) >> 5;
      if (edge && mode == 26 && x == 0)
        v = min(max(t[1] + ((l[1 + y] - l[0]) >> 1), 0), max_val);
      if (edge && mode == 10 && y == 0)
        v = min(max(l[1] + ((t[1 + x] - t[0]) >> 1), 0), max_val);
    }
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
