// K3: exact integer T -> Q -> IQ -> IT for B blocks of n x n residuals.
//
// Replaces fasthevc_tpu/ops/transform.py tq_roundtrip_fast (:151), the
// search's f32 stand-in for the integer pipeline (a TPU workaround: that
// chip has no native s32 matmul).  This kernel computes the exact form of
// tq_roundtrip (:139): the two-stage forward DCT with the spec shifts, the
// HM dead-zone quantiser (intra offset 171/512) and flat-list
// dequantiser with 64-bit products, and the normative inverse DCT with its
// clips.  Returns the levels and the reconstructed residual.
//
// Bound on the H100: integer multiply-adds, 4 * n^3 per block (131 k at
// n = 32); the data in and out is 12 * n^2 bytes.  Design: one CTA of 256
// threads per group of blocks (256 / n^2 blocks when n <= 16, one block at
// n = 32); the DCT matrix and two n x n int32 work tiles per block live in
// shared memory; each thread computes whole output samples of each
// matrix stage, with a barrier between stages.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void tq_kernel(const int* __restrict__ res,
                          const int* __restrict__ mat,
                          int* __restrict__ levels, int* __restrict__ recon,
                          int B, int n, int lg, int qp, int bit_depth,
                          int bpc) {
  extern __shared__ int sm[];
  const int nn = n * n;
  int* T = sm;              // [n][n], T[k][j]
  int* A = sm + nn;         // per block: work tile A, then tile Bt
  const int b0 = blockIdx.x * bpc;
  const int nb = min(bpc, B - b0);
  const int tot = nb * nn;

  const int shift1 = lg + bit_depth - 9;
  const int shift2 = lg + 6;
  const int qbits = 14 + qp / 6 + (15 - bit_depth - lg);
  const long long qscale[6] = {26214, 23302, 20560, 18396, 16384, 14564};
  const long long iscale[6] = {40, 45, 51, 57, 64, 72};
  const long long scale = qscale[qp % 6];
  const long long f = 171LL << (qbits - 9);
  const long long dq = iscale[qp % 6] * 16;
  const int bd_shift = bit_depth + lg - 5;
  const int inv_shift2 = 20 - bit_depth;

  for (int i = threadIdx.x; i < nn; i += blockDim.x) T[i] = mat[i];
  for (int i = threadIdx.x; i < tot; i += blockDim.x) {
    const int j = i / nn, p = i - j * nn;
    A[j * 2 * nn + p] = res[(size_t)(b0 + j) * nn + p];
  }
  __syncthreads();
  // forward stage 1: tmp[k][m] = sum_j T[k][j] x[j][m]
  for (int i = threadIdx.x; i < tot; i += blockDim.x) {
    const int j = i / nn, p = i - j * nn, k = p >> lg, m = p & (n - 1);
    const int* x = A + j * 2 * nn;
    int acc = 0;
    for (int q = 0; q < n; ++q) acc += T[k * n + q] * x[q * n + m];
    if (shift1 > 0) acc = (acc + (1 << (shift1 - 1))) >> shift1;
    A[j * 2 * nn + nn + p] = acc;
  }
  __syncthreads();
  // forward stage 2 + quantise + dequantise:
  // coef[k][l] = sum_m tmp[k][m] T[l][m]
  for (int i = threadIdx.x; i < tot; i += blockDim.x) {
    const int j = i / nn, p = i - j * nn, k = p >> lg, l = p & (n - 1);
    const int* tmp = A + j * 2 * nn + nn;
    int acc = 0;
    for (int q = 0; q < n; ++q) acc += tmp[k * n + q] * T[l * n + q];
    const long long c = (acc + (1 << (shift2 - 1))) >> shift2;
    long long lv = ((c < 0 ? -c : c) * scale + f) >> qbits;
    lv = lv > 32767 ? 32767 : lv;
    lv = c < 0 ? -lv : (c > 0 ? lv : 0);
    levels[(size_t)(b0 + j) * nn + p] = (int)lv;
    long long d = ((lv * dq) << (qp / 6)) + (1LL << (bd_shift - 1));
    d >>= bd_shift;
    d = d < -32768 ? -32768 : (d > 32767 ? 32767 : d);
    A[j * 2 * nn + p] = (int)d;
  }
  __syncthreads();
  // inverse stage 1: e[k][m] = sum_q T[q][k] deq[q][m], clipped to 16 bits
  for (int i = threadIdx.x; i < tot; i += blockDim.x) {
    const int j = i / nn, p = i - j * nn, k = p >> lg, m = p & (n - 1);
    const int* dqt = A + j * 2 * nn;
    int acc = 0;
    for (int q = 0; q < n; ++q) acc += T[q * n + k] * dqt[q * n + m];
    acc = (acc + 64) >> 7;
    A[j * 2 * nn + nn + p] = min(max(acc, -32768), 32767);
  }
  __syncthreads();
  // inverse stage 2: r[k][l] = sum_m e[k][m] T[m][l]
  for (int i = threadIdx.x; i < tot; i += blockDim.x) {
    const int j = i / nn, p = i - j * nn, k = p >> lg, l = p & (n - 1);
    const int* e = A + j * 2 * nn + nn;
    int acc = 0;
    for (int q = 0; q < n; ++q) acc += e[k * n + q] * T[q * n + l];
    acc = (acc + (1 << (inv_shift2 - 1))) >> inv_shift2;
    recon[(size_t)(b0 + j) * nn + p] = min(max(acc, -32768), 32767);
  }
}

}  // namespace

extern "C" int fhv_tq_roundtrip(const int* res, const int* mat, int* levels,
                                int* recon, int B, int n, int lg, int qp,
                                int bit_depth, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int nn = n * n;
  const int bpc = nn >= kThreads ? 1 : kThreads / nn;
  const int grid = (B + bpc - 1) / bpc;
  const size_t smem = sizeof(int) * (nn + 2 * bpc * nn);
  tq_kernel<<<grid, kThreads, smem, stream>>>(res, mat, levels, recon, B, n,
                                              lg, qp, bit_depth, bpc);
  return (int)cudaGetLastError();
}
