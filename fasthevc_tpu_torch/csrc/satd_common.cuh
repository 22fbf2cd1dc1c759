// The Hadamard SATD of one HB x HB residual sub-block, shared by K2
// (satd.cu, the merge candidates), K1's fused form (intra_pred.cu, the
// intra search's 35 modes) and K10 (subpel.cu, the sub-pel search):
// in-place Walsh-Hadamard butterflies over the rows, then the columns, and
// the absolute sum divided by HB (floor, HM normalisation).  satd8_lanes is
// the same 8x8 transform held by 8 lanes, shared by K11's merge form (mc.cu)
// and K12's selected form (bi.cu).
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

// The SATD of one 8x8 residual held by an aligned group of 8 lanes, lane c
// the column c (d[y] its 8 rows): the columns' butterflies in each lane,
// the rows' across the 8 lanes by shuffles, then the absolute sum over the
// group divided by 8.  satd_subblock<8>'s exact integer sums in another
// order; every lane of the group returns it.  Every lane of the warp calls
// it (full-mask shuffles).
__device__ __forceinline__ int satd8_lanes(int* d, int c) {
#pragma unroll
  for (int hh = 1; hh < 8; hh <<= 1)
#pragma unroll
    for (int y = 0; y < 8; ++y)
      if ((y & hh) == 0) {
        const int a = d[y], e = d[y + hh];
        d[y] = a + e;
        d[y + hh] = a - e;
      }
#pragma unroll
  for (int hh = 1; hh < 8; hh <<= 1)
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const int o = __shfl_xor_sync(0xffffffffu, d[y], hh);
      d[y] = (c & hh) ? o - d[y] : d[y] + o;
    }
  int sum = 0;
#pragma unroll
  for (int y = 0; y < 8; ++y) sum += abs(d[y]);
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  return sum / 8;
}
