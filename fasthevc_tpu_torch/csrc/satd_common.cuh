// The Hadamard SATD of one HB x HB residual sub-block, shared by K2
// (satd.cu, the merge candidates), K1's fused form (intra_pred.cu, the
// intra search's 35 modes) and K10 (subpel.cu, the sub-pel search):
// in-place Walsh-Hadamard butterflies over the rows, then the columns, and
// the absolute sum divided by HB (floor, HM normalisation).
#pragma once

template <int HB>
__device__ __forceinline__ int satd_subblock(int* d) {
#pragma unroll
  for (int r = 0; r < HB; ++r)
#pragma unroll
    for (int h = 1; h < HB; h <<= 1)
#pragma unroll
      for (int c = 0; c < HB; ++c)
        if ((c & h) == 0) {
          const int a = d[r * HB + c], e = d[r * HB + c + h];
          d[r * HB + c] = a + e;
          d[r * HB + c + h] = a - e;
        }
#pragma unroll
  for (int c = 0; c < HB; ++c)
#pragma unroll
    for (int h = 1; h < HB; h <<= 1)
#pragma unroll
      for (int r = 0; r < HB; ++r)
        if ((r & h) == 0) {
          const int a = d[r * HB + c], e = d[(r + h) * HB + c];
          d[r * HB + c] = a + e;
          d[(r + h) * HB + c] = a - e;
        }
  int sum = 0;
#pragma unroll
  for (int i = 0; i < HB * HB; ++i) sum += abs(d[i]);
  return sum / HB;
}
