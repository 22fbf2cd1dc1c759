// Intra prediction of one sample (spec 8.4.4.2), shared by K1
// (intra_pred.cu, the search's all-mode prediction) and K5
// (commit_intra.cu, the commit's selected mode).
//
// References are corner-first: t = [p[-1][-1], p[0][-1] .. p[2n-1][-1]],
// l = [p[-1][-1], p[-1][0] .. p[-1][2n-1]], both of length 2n + 1.
#pragma once

// [1 2 1] smoothing of reference k (spec 8.4.4.2.3; strong smoothing not
// used): the far ends stay, the corner mixes both sides.
__device__ __forceinline__ void intra_filter_ref(const int* t, const int* l,
                                                 int k, int L, int* tf,
                                                 int* lf) {
  if (k == 0) {
    *tf = *lf = (l[1] + 2 * t[0] + t[1] + 2) >> 2;
  } else if (k == L - 1) {
    *tf = t[k];
    *lf = l[k];
  } else {
    *tf = (t[k - 1] + 2 * t[k] + t[k + 1] + 2) >> 2;
    *lf = (l[k - 1] + 2 * l[k] + l[k + 1] + 2) >> 2;
  }
}

__device__ __forceinline__ int intra_dc(const int* t, const int* l, int n,
                                        int lg) {
  int dc = n;
  for (int q = 1; q <= n; ++q) dc += t[q] + l[q];
  return dc >> (lg + 1);
}

// Sample (x, y) of mode `mode`.  t/l: unfiltered references; ft/fl: the
// references the mode reads (filtered or not); dc: intra_dc of t/l;
// angle/inv: the mode's angle and inverse angle; edge: the luma n < 32
// boundary filters of DC and modes 10/26.
__device__ __forceinline__ int intra_sample(int mode, int x, int y, int n,
                                            int lg, const int* t,
                                            const int* l, const int* ft,
                                            const int* fl, int dc, int angle,
                                            int inv, int edge, int max_val) {
  if (mode == 0) {  // planar
    return ((n - 1 - x) * fl[1 + y] + (x + 1) * ft[n + 1] +
            (n - 1 - y) * ft[1 + x] + (y + 1) * fl[n + 1] + n) >> (lg + 1);
  }
  if (mode == 1) {  // DC
    if (edge) {
      if (x == 0 && y == 0) return (l[1] + 2 * dc + t[1] + 2) >> 2;
      if (y == 0) return (t[1 + x] + 3 * dc + 2) >> 2;
      if (x == 0) return (l[1 + y] + 3 * dc + 2) >> 2;
    }
    return dc;
  }
  // angular 2..34; modes < 18 are the transpose of vertical
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
  int v = ((32 - fact) * a + fact * c + 16) >> 5;
  if (edge && mode == 26 && x == 0)
    v = min(max(t[1] + ((l[1 + y] - l[0]) >> 1), 0), max_val);
  if (edge && mode == 10 && y == 0)
    v = min(max(l[1] + ((t[1 + x] - t[0]) >> 1), 0), max_val);
  return v;
}
