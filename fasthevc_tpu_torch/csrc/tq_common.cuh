// The exact integer T -> Q -> IQ -> IT stages, one output sample each, of
// K5 (commit.cu, the commit); K3 (tq_roundtrip.cu, the search) shares the
// quantiser and dequantiser.  Matrices and tiles are n x n int32,
// row-major, T[k][j] the core transform (DCT, or DST for 4x4 luma).
#pragma once

// forward stage 1: tmp[k][m] = sum_j T[k][j] x[j][m], rounded >> shift1
__device__ __forceinline__ int tq_fwd1(const int* T, const int* x, int n,
                                       int k, int m, int shift1) {
  int acc = 0;
  for (int q = 0; q < n; ++q) acc += T[k * n + q] * x[q * n + m];
  if (shift1 > 0) acc = (acc + (1 << (shift1 - 1))) >> shift1;
  return acc;
}

// forward stage 2: coef[k][l] = sum_m tmp[k][m] T[l][m], rounded >> shift2
__device__ __forceinline__ int tq_fwd2(const int* tmp, const int* T, int n,
                                       int k, int l, int shift2) {
  int acc = 0;
  for (int q = 0; q < n; ++q) acc += tmp[k * n + q] * T[l * n + q];
  return (acc + (1 << (shift2 - 1))) >> shift2;
}

// HM dead-zone quantiser: sign(c) * min((|c| * scale + f) >> qbits, 32767)
__device__ __forceinline__ int tq_quant(long long c, long long scale,
                                        long long f, int qbits) {
  long long lv = ((c < 0 ? -c : c) * scale + f) >> qbits;
  lv = lv > 32767 ? 32767 : lv;
  return (int)(c < 0 ? -lv : (c > 0 ? lv : 0));
}

// flat-list dequantiser (spec 8.6.3) with 64-bit products; dq = levScale*16
__device__ __forceinline__ int tq_dequant(long long lv, long long dq,
                                          int qp_per, int bd_shift) {
  long long d = ((lv * dq) << qp_per) + (1LL << (bd_shift - 1));
  d >>= bd_shift;
  return (int)(d < -32768 ? -32768 : (d > 32767 ? 32767 : d));
}

// inverse stage 1: e[k][m] = sum_q T[q][k] d[q][m], clipped to 16 bits
__device__ __forceinline__ int tq_inv1(const int* T, const int* d, int n,
                                       int k, int m) {
  int acc = 0;
  for (int q = 0; q < n; ++q) acc += T[q * n + k] * d[q * n + m];
  acc = (acc + 64) >> 7;
  return min(max(acc, -32768), 32767);
}

// inverse stage 2: r[k][l] = sum_m e[k][m] T[m][l], clipped to 16 bits
__device__ __forceinline__ int tq_inv2(const int* e, const int* T, int n,
                                       int k, int l, int shift2) {
  int acc = 0;
  for (int q = 0; q < n; ++q) acc += e[k * n + q] * T[q * n + l];
  acc = (acc + (1 << (shift2 - 1))) >> shift2;
  return min(max(acc, -32768), 32767);
}
