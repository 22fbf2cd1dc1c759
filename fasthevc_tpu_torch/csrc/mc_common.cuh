// The spec's luma (8-tap, quarter-pel) and chroma (4-tap, eighth-pel)
// interpolation on an edge-clamped plane, shared by K11 (mc.cu, exact MC)
// and K12 (bi.cu, the B search's bi-prediction cost).  Each translation
// unit gets its own copy of the tap tables.
#pragma once

namespace {

__constant__ int kLuma[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                                {-1, 4, -10, 58, 17, -5, 1, 0},
                                {-1, 4, -11, 40, 40, -11, 4, -1},
                                {0, 1, -5, 17, 58, -10, 4, -1}};
__constant__ int kChroma[8][4] = {{0, 64, 0, 0},    {-2, 58, 10, -2},
                                  {-4, 54, 16, -2}, {-6, 46, 28, -4},
                                  {-4, 36, 36, -4}, {-4, 28, 46, -6},
                                  {-2, 16, 54, -4}, {-2, 10, 58, -2}};

// The raw prediction of sample (y, x) of plane `ref` [H, W] for MV (mx, my)
// in 1 / 2^frac_bits units; TAPS taps per phase.
template <int TAPS>
__device__ __forceinline__ int mc_raw(const int* __restrict__ ref, int H,
                                      int W, int y, int x, int mx, int my,
                                      int frac_bits, int shift1) {
  const int fx = mx & ((1 << frac_bits) - 1), fy = my & ((1 << frac_bits) - 1);
  const int x0 = x + (mx >> frac_bits) - (TAPS / 2 - 1);
  const int y0 = y + (my >> frac_bits) - (TAPS / 2 - 1);
  int acc = 0;
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    const int yy = min(max(y0 + k, 0), H - 1);
    const int* row = ref + (size_t)yy * W;
    int h = 0;
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const int xx = min(max(x0 + j, 0), W - 1);
      h += (TAPS == 8 ? kLuma[fx][j] : kChroma[fx][j]) * row[xx];
    }
    acc += (TAPS == 8 ? kLuma[fy][k] : kChroma[fy][k]) * (h >> shift1);
  }
  return acc >> 6;
}

}  // namespace
