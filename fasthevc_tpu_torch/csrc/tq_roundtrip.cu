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
// matrix stage, with a barrier between stages.  The stages are shared with
// K5 through tq_common.cuh.

#include <cuda_runtime.h>

#include "tq_common.cuh"

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
  for (int i = threadIdx.x; i < tot; i += blockDim.x) {
    const int j = i / nn, p = i - j * nn;
    A[j * 2 * nn + nn + p] =
        tq_fwd1(T, A + j * 2 * nn, n, p >> lg, p & (n - 1), shift1);
  }
  __syncthreads();
  // forward stage 2, quantise, dequantise
  for (int i = threadIdx.x; i < tot; i += blockDim.x) {
    const int j = i / nn, p = i - j * nn;
    const int c = tq_fwd2(A + j * 2 * nn + nn, T, n, p >> lg, p & (n - 1),
                          shift2);
    const int lv = tq_quant(c, scale, f, qbits);
    levels[(size_t)(b0 + j) * nn + p] = lv;
    A[j * 2 * nn + p] = tq_dequant(lv, dq, qp / 6, bd_shift);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tot; i += blockDim.x) {
    const int j = i / nn, p = i - j * nn;
    A[j * 2 * nn + nn + p] = tq_inv1(T, A + j * 2 * nn, n, p >> lg,
                                     p & (n - 1));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tot; i += blockDim.x) {
    const int j = i / nn, p = i - j * nn;
    recon[(size_t)(b0 + j) * nn + p] =
        tq_inv2(A + j * 2 * nn + nn, T, n, p >> lg, p & (n - 1), inv_shift2);
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
