// Native slice engine: exact commit (intra predict + TQ + recon) and CTU
// syntax serialization for a decided frame, in one C++ pass.
//
// Reference parity: the commit half of HM's TEncCu/TEncSearch plus
// TEncSbac CU syntax (SURVEY.md E6/E7/C3/C5/C6) — reimplemented from the
// H.265 spec to be byte-identical to the Python path
// (spec/ctu.py + spec/encoder commit), enforced by tests/test_slice_engine.py.
//
// The TPU does the *search* (which modes/partitions); this engine does the
// sequential, bit-exact reconstruction + entropy emission the TPU cannot
// batch (z-order recon feedback + CABAC).
//
// Decisions arrive as two per-8x8-granule maps over the padded frame:
//   depth_map: CU depth d at every granule (CU size = ctu_size >> d)
//   mode_map:  luma intra mode of the covering CU
// Forced boundary splits are re-derived from the coded dims (spec rule).

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <mutex>
#include <vector>
#include <thread>

#include "cabac.cpp"  // engine + residual coding (single-TU compile unit)

namespace {

// ---- transforms (spec 8.6.4), same construction as spec/tables.py --------
int32_t g_dct[6][32 * 32];  // [log2-1] -> matrix (2..5 used)
int32_t g_dst4[16] = {29, 55, 74, 84, 74, 74, 0, -74,
                      84, -29, -74, 55, 55, -84, 74, -29};
bool g_tr_init = false;

void build_dct(int size, int32_t *out) {
  if (size == 1) {
    out[0] = 64;
    return;
  }
  std::vector<int32_t> half((size / 2) * (size / 2));
  build_dct(size / 2, half.data());
  static const int c2[] = {64};
  static const int c4[] = {83, 36};
  static const int c8[] = {89, 75, 50, 18};
  static const int c16[] = {90, 87, 80, 70, 57, 43, 25, 9};
  static const int c32[] = {90, 90, 88, 85, 82, 78, 73, 67,
                            61, 54, 46, 38, 31, 22, 13, 4};
  const int *c = size == 2 ? c2 : size == 4 ? c4 : size == 8 ? c8
                 : size == 16 ? c16 : c32;
  for (int k = 0; k < size / 2; k++)
    for (int n = 0; n < size / 2; n++) {
      out[2 * k * size + n] = half[k * (size / 2) + n];
      out[2 * k * size + size - 1 - n] = half[k * (size / 2) + n];
    }
  int period = 4 * size;
  for (int k = 0; k < size / 2; k++) {
    int m = 2 * k + 1;
    for (int n = 0; n < size; n++) {
      int u = (m * (2 * n + 1)) % period;
      if (u > 2 * size) u = period - u;
      out[m * size + n] = (u < size) ? c[(u - 1) / 2]
                                     : -c[(2 * size - u - 1) / 2];
    }
  }
}

void init_transforms() {
  if (g_tr_init) return;
  for (int lg = 1; lg <= 5; lg++) build_dct(1 << lg, g_dct[lg - 1]);
  g_tr_init = true;
}

const int32_t kQuantScales[6] = {26214, 23302, 20560, 18396, 16384, 14564};
const int32_t kInvQuantScales[6] = {40, 45, 51, 57, 64, 72};

// tmp buffers sized for 32x32
struct TrBuf {
  int32_t t1[32 * 32];
  int32_t coeff[32 * 32];
  int32_t deq[32 * 32];
  int32_t res[32 * 32];
};

const int32_t *mat(int lg, bool dst) {
  return dst ? g_dst4 : g_dct[lg - 1];
}

// forward transform: res[n*n] -> coeff[n*n] (HM convention).
// int32 accumulation is exact for 8-bit content (the engine's src is u8):
// stage-1 sums <= 32*90*255 < 2^20, stage-2 <= 32*90*46k < 2^28 — and the
// narrower type lets the compiler vectorize the inner products.
void fwd_transform(const int32_t *res, int lg, bool dst, int bit_depth,
                   int32_t *coeff, TrBuf *b) {
  int n = 1 << lg;
  const int32_t *t = mat(lg, dst);
  int s1 = lg + bit_depth - 9, s2 = lg + 6;
  int32_t add1 = s1 > 0 ? (1 << (s1 - 1)) : 0;
  int32_t add2 = 1 << (s2 - 1);
  // stage1: tmp = (T @ X) >> s1  (accumulate over rows of X, row-contiguous)
  for (int k = 0; k < n; k++) {
    int32_t *dst_row = b->t1 + k * n;
    for (int m = 0; m < n; m++) dst_row[m] = add1;
    for (int j = 0; j < n; j++) {
      int32_t tk = t[k * n + j];
      const int32_t *src_row = res + j * n;
      for (int m = 0; m < n; m++) dst_row[m] += tk * src_row[m];
    }
    for (int m = 0; m < n; m++) dst_row[m] >>= s1;
  }
  // stage2: out = (tmp @ T^T) >> s2
  for (int k = 0; k < n; k++)
    for (int l = 0; l < n; l++) {
      int32_t acc = add2;
      const int32_t *a = b->t1 + k * n;
      const int32_t *tr = t + l * n;
      for (int m = 0; m < n; m++) acc += a[m] * tr[m];
      coeff[k * n + l] = acc >> s2;
    }
}

// normative inverse transform (same int32 bounds: inputs clipped to
// +-32767, stage sums <= 32*90*32767 < 2^27)
void inv_transform(const int32_t *coeff, int lg, bool dst, int bit_depth,
                   int32_t *res, TrBuf *b) {
  int n = 1 << lg;
  const int32_t *t = mat(lg, dst);
  int s1 = 7, s2 = 20 - bit_depth;
  for (int k = 0; k < n; k++) {
    int32_t *dst_row = b->t1 + k * n;
    for (int m = 0; m < n; m++) dst_row[m] = 64;
    for (int j = 0; j < n; j++) {
      int32_t tk = t[j * n + k];
      const int32_t *src_row = coeff + j * n;
      for (int m = 0; m < n; m++) dst_row[m] += tk * src_row[m];
    }
    for (int m = 0; m < n; m++) {
      int32_t v = dst_row[m] >> s1;
      dst_row[m] = v < -32768 ? -32768 : v > 32767 ? 32767 : v;
    }
  }
  int32_t add2 = 1 << (s2 - 1);
  for (int k = 0; k < n; k++)
    for (int l = 0; l < n; l++) {
      int32_t acc = add2;
      const int32_t *a = b->t1 + k * n;
      for (int m = 0; m < n; m++) acc += a[m] * t[m * n + l];
      int32_t v = acc >> s2;
      res[k * n + l] = v < -32768 ? -32768 : v > 32767 ? 32767 : v;
    }
}

// returns true if any nonzero level
bool quantize(const int32_t *coeff, int lg, int qp, int bit_depth,
              int32_t *levels) {
  int n = 1 << lg;
  int tshift = 15 - bit_depth - lg;
  int qbits = 14 + qp / 6 + tshift;
  int64_t scale = kQuantScales[qp % 6];
  int64_t f = (int64_t)171 << (qbits - 9);
  bool any = false;
  for (int i = 0; i < n * n; i++) {
    int64_t c = coeff[i];
    int64_t a = c < 0 ? -c : c;
    int64_t lv = (a * scale + f) >> qbits;
    if (lv > 32767) lv = 32767;
    levels[i] = (int32_t)(c < 0 ? -lv : lv);
    any |= lv != 0;
  }
  return any;
}

// Sign-data-hiding parity fix (encoder side of spec 7.4.9.11 / HM
// xSignBitHidingHDQ essence): per 4x4 sub-block whose significant-coeff
// scan span exceeds 3, force (sum of abs levels) & 1 == sign of the
// lowest-scan-pos coefficient. Parity is flipped by bumping |level| +1 at
// the in-span position with the largest quantizer residue — +1 never
// moves the span extrema, so the hidden-sign condition stays valid and
// the serializer (encode_residual sdh path) recomputes the same span.
void sdh_adjust(int32_t *levels, const int32_t *coeff, int lg, int qp,
                int bit_depth, int scan_idx) {
  const Scan &sc = g_scans[lg - 2][scan_idx];
  int size = 1 << lg;
  int tshift = 15 - bit_depth - lg;
  int qbits = 14 + qp / 6 + tshift;
  int64_t scale = kQuantScales[qp % 6];
  for (int base = 0; base < size * size; base += 16) {
    int first = -1, last = -1;
    int64_t sum = 0;
    for (int k = 0; k < 16; k++) {
      int32_t v = levels[sc.y[base + k] * size + sc.x[base + k]];
      if (v) {
        if (first < 0) first = k;
        last = k;
        sum += v < 0 ? -v : v;
      }
    }
    if (first < 0 || last - first <= 3) continue;
    int want = levels[sc.y[base + first] * size + sc.x[base + first]] < 0;
    if ((int)(sum & 1) == want) continue;
    int bestk = first;
    int64_t bestr = INT64_MIN;
    for (int k = first; k <= last; k++) {
      int idx = sc.y[base + k] * size + sc.x[base + k];
      int64_t a = coeff[idx] < 0 ? -(int64_t)coeff[idx] : coeff[idx];
      int64_t la = levels[idx] < 0 ? -(int64_t)levels[idx] : levels[idx];
      if (la >= 32767) continue;
      int64_t r = a * scale - (la << qbits);  // distance to next level up
      if (r > bestr) { bestr = r; bestk = k; }
    }
    int idx = sc.y[base + bestk] * size + sc.x[base + bestk];
    if (levels[idx] > 0) levels[idx]++;
    else if (levels[idx] < 0) levels[idx]--;
    else levels[idx] = coeff[idx] < 0 ? -1 : 1;
  }
}

void dequantize(const int32_t *levels, int lg, int qp, int bit_depth,
                int32_t *out) {
  int n = 1 << lg;
  int bd_shift = bit_depth + lg - 5;
  int64_t scale = (int64_t)kInvQuantScales[qp % 6] * 16;
  int up = qp / 6;
  for (int i = 0; i < n * n; i++) {
    int64_t d = (((int64_t)levels[i] * scale) << up) + (1ll << (bd_shift - 1));
    d >>= bd_shift;
    if (d < -32768) d = -32768;
    if (d > 32767) d = 32767;
    out[i] = (int32_t)d;
  }
}

// ---- transform skip (4x4 TBs, spec 8.6.4.2) ------------------------------
// twins of spec/transform.py forward_transform_skip / inverse_transform_skip
inline void fwd_transform_skip(const int32_t *res, int bit_depth,
                               int32_t *coeff) {
  int sh = 15 - bit_depth - 2;
  for (int i = 0; i < 16; i++) coeff[i] = res[i] << sh;
}

inline void inv_transform_skip(const int32_t *deq, int bit_depth,
                               int32_t *out) {
  int bd_shift = 20 - bit_depth;
  for (int i = 0; i < 16; i++) {
    int64_t r = (int64_t)deq[i] << 7;
    int64_t v = (r + (1ll << (bd_shift - 1))) >> bd_shift;
    out[i] = v < -32768 ? -32768 : v > 32767 ? 32767 : (int32_t)v;
  }
}

// inter dead-zone quantizer (85/512 offset; the intra one is `quantize`)
inline bool quantize_inter(const int32_t *coeff, int lg, int qp,
                           int bit_depth, int32_t *levels) {
  int n = 1 << lg;
  int tshift = 15 - bit_depth - lg;
  int qbits = 14 + qp / 6 + tshift;
  int64_t scale = kQuantScales[qp % 6];
  int64_t f = (int64_t)85 << (qbits - 9);
  bool any = false;
  for (int i = 0; i < n * n; i++) {
    int64_t c = coeff[i];
    int64_t a = c < 0 ? -c : c;
    int64_t lv = (a * scale + f) >> qbits;
    if (lv > 32767) lv = 32767;
    levels[i] = (int32_t)(c < 0 ? -lv : lv);
    any |= lv != 0;
  }
  return any;
}

// Integer-exact level-bits estimate shared with the Python fallback
// (codec/encoder.py _ts_bits_est): sum over nonzero levels of
// (2 + 2*bit_length(|level|)).  Deliberately integer so the C++ engine
// and the Python commit path make byte-identical transform-skip choices
// (no cross-runtime float-log reproducibility hazard).
inline int64_t ts_bits_est(const int32_t *levels, int n) {
  int64_t bits = 0;
  for (int i = 0; i < n * n; i++) {
    int32_t v = levels[i];
    uint32_t a = v < 0 ? (uint32_t)(-(int64_t)v) : (uint32_t)v;
    if (a) bits += 2 + 2 * (32 - __builtin_clz(a));
  }
  return bits;
}

inline int64_t sse_blk(const int32_t *a, const int32_t *b, int n) {
  int64_t s = 0;
  for (int i = 0; i < n * n; i++) {
    int64_t d = (int64_t)a[i] - b[i];
    s += d * d;
  }
  return s;
}

// ---- intra prediction (spec 8.4.4.2) -------------------------------------
const int kAngles[35] = {0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9,
                         -13, -17, -21, -26, -32, -26, -21, -17, -13, -9, -5,
                         -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
const int kInvAngles[35] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -4096, -1638,
                            -910, -630, -482, -390, -315, -256, -315, -390,
                            -482, -630, -910, -1638, -4096, 0, 0, 0, 0, 0, 0,
                            0, 0, 0};

int z_order(int x4, int y4) {
  int z = 0;
  for (int b = 0; b < 8; b++) {
    z |= ((x4 >> b) & 1) << (2 * b);
    z |= ((y4 >> b) & 1) << (2 * b + 1);
  }
  return z;
}

struct Frame {
  int coded_w, coded_h;   // luma coded dims
  int log2_ctu;
  int bit_depth;
  // recon planes: external (caller-owned, zero-initialized) buffers so the
  // recon is produced in place with no final copy
  int32_t *y = nullptr, *cb = nullptr, *cr = nullptr;
  // 4x4 granule maps
  int gw, gh;
  std::vector<int8_t> gdepth, gmode;
  std::vector<uint8_t> gcoded, gskip, ginter, gcbf;
  std::vector<int32_t> gmv;   // [g][4]: l0x,l0y,l1x,l1y
  std::vector<int32_t> gref;  // [g][2]: ref idx per list (-1 unused)

  int32_t *plane(int c) { return c == 0 ? y : c == 1 ? cb : cr; }
  int pw(int c) const { return c == 0 ? coded_w : coded_w / 2; }
  int ph(int c) const { return c == 0 ? coded_h : coded_h / 2; }

  bool avail(int xn, int yn, int xc, int yc, int tx0, int ty0, int tx1,
             int ty1) const {
    if (xn < 0 || yn < 0 || xn >= coded_w || yn >= coded_h) return false;
    if (xn < tx0 || yn < ty0 || xn >= tx1 || yn >= ty1) return false;
    int cs = 1 << log2_ctu;
    int per_row = (coded_w + cs - 1) >> log2_ctu;
    int cn = (yn >> log2_ctu) * per_row + (xn >> log2_ctu);
    int cc = (yc >> log2_ctu) * per_row + (xc >> log2_ctu);
    if (cn != cc) return cn < cc;
    int m = cs - 1;
    return z_order((xn & m) >> 2, (yn & m) >> 2) <
           z_order((xc & m) >> 2, (yc & m) >> 2);
  }
};

// Fetch + substitute refs. top/left are length 2n+1, corner-first.
void get_refs(Frame *f, int c_idx, int x0, int y0, int n, int32_t *top,
              int32_t *left, int tx0, int ty0, int tx1, int ty1) {
  int sub = c_idx == 0 ? 0 : 1;
  const int32_t *pl = f->plane(c_idx);
  int w = f->pw(c_idx), h = f->ph(c_idx);
  int xl = x0 << sub, yl = y0 << sub;
  int total = 4 * n + 1;
  std::vector<int32_t> vals(total);
  std::vector<uint8_t> av(total, 0);
  // order: bottom-left up, corner, top row l->r
  int i = 0;
  for (int yy = 2 * n - 1; yy >= 0; yy--, i++) {
    int xs = x0 - 1, ys = y0 + yy;
    if (f->avail(xs << sub, ys << sub, xl, yl, tx0, ty0, tx1, ty1)) {
      vals[i] = pl[(ys < h ? ys : h - 1) * w + xs];
      av[i] = 1;
    }
  }
  {
    int xs = x0 - 1, ys = y0 - 1;
    if (f->avail(xs << sub, ys << sub, xl, yl, tx0, ty0, tx1, ty1)) {
      vals[i] = pl[ys * w + xs];
      av[i] = 1;
    }
    i++;
  }
  for (int xx = 0; xx < 2 * n; xx++, i++) {
    int xs = x0 + xx, ys = y0 - 1;
    if (f->avail(xs << sub, ys << sub, xl, yl, tx0, ty0, tx1, ty1)) {
      vals[i] = pl[ys * w + (xs < w ? xs : w - 1)];
      av[i] = 1;
    }
  }
  bool none = true;
  for (int k = 0; k < total; k++) none &= !av[k];
  if (none) {
    int32_t fill = 1 << (f->bit_depth - 1);
    for (int k = 0; k < total; k++) vals[k] = fill;
  } else {
    if (!av[0]) {
      int k = 0;
      while (!av[k]) k++;
      vals[0] = vals[k];
      av[0] = 1;
    }
    for (int k = 1; k < total; k++)
      if (!av[k]) vals[k] = vals[k - 1];
  }
  left[0] = vals[2 * n];
  for (int k = 0; k < 2 * n; k++) left[1 + k] = vals[2 * n - 1 - k];
  top[0] = vals[2 * n];
  for (int k = 0; k < 2 * n; k++) top[1 + k] = vals[2 * n + 1 + k];
}

const int kFilterThresh[6] = {0, 0, 10, 7, 1, 0};  // index log2(n)

bool should_filter(int mode, int n, bool luma) {
  if (!luma || mode == 1 || n == 4) return false;
  int d26 = mode - 26 < 0 ? 26 - mode : mode - 26;
  int d10 = mode - 10 < 0 ? 10 - mode : mode - 10;
  int md = d26 < d10 ? d26 : d10;
  int lg = 0;
  for (int t = n; t > 1; t >>= 1) lg++;
  return md > kFilterThresh[lg];
}

void filter_refs(const int32_t *top, const int32_t *left, int n,
                 int32_t *ftop, int32_t *fleft) {
  int n2 = 2 * n;
  std::vector<int32_t> seq(2 * n2 + 1);
  for (int k = 0; k < n2; k++) seq[k] = left[n2 - k];
  seq[n2] = left[0];
  for (int k = 0; k < n2; k++) seq[n2 + 1 + k] = top[1 + k];
  std::vector<int32_t> fs(seq);
  for (int k = 1; k < 2 * n2; k++)
    fs[k] = (seq[k - 1] + 2 * seq[k] + seq[k + 1] + 2) >> 2;
  fleft[0] = fs[n2];
  for (int k = 0; k < n2; k++) fleft[1 + k] = fs[n2 - 1 - k];
  ftop[0] = fs[n2];
  for (int k = 0; k < n2; k++) ftop[1 + k] = fs[n2 + 1 + k];
}

// predict one block, mode in [0,34]; out[n*n]
void predict(int mode, const int32_t *top, const int32_t *left, int n,
             bool luma, int bit_depth, int32_t *out) {
  int lg = 0;
  for (int t = n; t > 1; t >>= 1) lg++;
  int maxv = (1 << bit_depth) - 1;
  if (mode == 0) {  // planar
    int32_t tr = top[n + 1], bl = left[n + 1];
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++)
        out[y * n + x] =
            ((n - 1 - x) * left[1 + y] + (x + 1) * tr +
             (n - 1 - y) * top[1 + x] + (y + 1) * bl + n) >> (lg + 1);
    return;
  }
  if (mode == 1) {  // DC
    int32_t sum = 0;
    for (int k = 1; k <= n; k++) sum += top[k] + left[k];
    int32_t dc = (sum + n) >> (lg + 1);
    for (int i = 0; i < n * n; i++) out[i] = dc;
    if (luma && n < 32) {
      out[0] = (left[1] + 2 * dc + top[1] + 2) >> 2;
      for (int x = 1; x < n; x++) out[x] = (top[1 + x] + 3 * dc + 2) >> 2;
      for (int y = 1; y < n; y++) out[y * n] = (left[1 + y] + 3 * dc + 2) >> 2;
    }
    return;
  }
  int angle = kAngles[mode];
  bool vertical = mode >= 18;
  const int32_t *main_r = vertical ? top : left;
  const int32_t *side_r = vertical ? left : top;
  // ext[k], k in [-n, 2n], offset n
  std::vector<int32_t> ext(3 * n + 1);
  int off = n;
  ext[off] = main_r[0];
  for (int j = 1; j <= 2 * n; j++) ext[off + j] = main_r[j];
  if (angle < 0) {
    int inv = kInvAngles[mode];
    int lowest = ((n * angle) >> 5) + 1;
    for (int k = -1; k >= lowest; k--) {
      int idx = (k * inv + 128) >> 8;
      ext[off + k] = side_r[idx];
    }
  }
  for (int y = 0; y < n; y++) {
    int i_idx = ((y + 1) * angle) >> 5;
    int i_fact = ((y + 1) * angle) & 31;
    for (int x = 0; x < n; x++) {
      int base = off + i_idx + 1 + x;
      int32_t v;
      if (i_fact == 0)
        v = ext[base];
      else
        v = ((32 - i_fact) * ext[base] + i_fact * ext[base + 1] + 16) >> 5;
      if (vertical)
        out[y * n + x] = v;
      else
        out[x * n + y] = v;
    }
  }
  if (luma && n < 32) {
    if (mode == 26) {
      for (int y = 0; y < n; y++) {
        int32_t v = top[1] + ((left[1 + y] - left[0]) >> 1);
        out[y * n] = v < 0 ? 0 : v > maxv ? maxv : v;
      }
    } else if (mode == 10) {
      for (int x = 0; x < n; x++) {
        int32_t v = left[1] + ((top[1 + x] - top[0]) >> 1);
        out[x] = v < 0 ? 0 : v > maxv ? maxv : v;
      }
    }
  }
}

// ---- CU syntax + commit ---------------------------------------------------
// ---- motion compensation (spec 8.5.4) -------------------------------------
const int kLumaF[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},   {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1}, {0, 1, -5, 17, 58, -10, 4, -1}};
const int kChromaF[8][4] = {
    {0, 64, 0, 0},   {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

// 14-bit intermediate MC (raw); taps = 8 (luma) or 4 (chroma)
void mc_raw(const int32_t *ref, int rw, int rh, int x, int y, int w, int h,
            int mvx, int mvy, bool luma, int64_t *out) {
  int ix, iy, fx, fy, taps, center;
  if (luma) {
    ix = x + (mvx >> 2); iy = y + (mvy >> 2);
    fx = mvx & 3; fy = mvy & 3; taps = 8; center = 3;
  } else {
    ix = x + (mvx >> 3); iy = y + (mvy >> 3);
    fx = mvx & 7; fy = mvy & 7; taps = 4; center = 1;
  }
  const int *fhx = luma ? kLumaF[fx] : kChromaF[fx];
  const int *fvy = luma ? kLumaF[fy] : kChromaF[fy];
  if (fx == 0 && fy == 0) {
    for (int yy = 0; yy < h; yy++)
      for (int xx = 0; xx < w; xx++) {
        int sy = clampi(iy + yy, 0, rh - 1), sx = clampi(ix + xx, 0, rw - 1);
        out[yy * w + xx] = (int64_t)ref[sy * rw + sx] << 6;
      }
    return;
  }
  if (fy == 0) {
    for (int yy = 0; yy < h; yy++)
      for (int xx = 0; xx < w; xx++) {
        int sy = clampi(iy + yy, 0, rh - 1);
        int64_t acc = 0;
        for (int k = 0; k < taps; k++)
          acc += (int64_t)fhx[k] *
                 ref[sy * rw + clampi(ix + xx - center + k, 0, rw - 1)];
        out[yy * w + xx] = acc;
      }
    return;
  }
  if (fx == 0) {
    for (int yy = 0; yy < h; yy++)
      for (int xx = 0; xx < w; xx++) {
        int sx = clampi(ix + xx, 0, rw - 1);
        int64_t acc = 0;
        for (int k = 0; k < taps; k++)
          acc += (int64_t)fvy[k] *
                 ref[clampi(iy + yy - center + k, 0, rh - 1) * rw + sx];
        out[yy * w + xx] = acc;
      }
    return;
  }
  // separable: horizontal into tmp (h + taps - 1 rows), then vertical >> 6
  std::vector<int64_t> tmp((h + taps) * w);
  for (int yy = 0; yy < h + taps - 1; yy++)
    for (int xx = 0; xx < w; xx++) {
      int sy = clampi(iy + yy - center, 0, rh - 1);
      int64_t acc = 0;
      for (int k = 0; k < taps; k++)
        acc += (int64_t)fhx[k] *
               ref[sy * rw + clampi(ix + xx - center + k, 0, rw - 1)];
      tmp[yy * w + xx] = acc;
    }
  for (int yy = 0; yy < h; yy++)
    for (int xx = 0; xx < w; xx++) {
      int64_t acc = 0;
      for (int k = 0; k < taps; k++) acc += (int64_t)fvy[k] * tmp[(yy + k) * w + xx];
      out[yy * w + xx] = acc >> 6;
    }
}

struct MotionCu {
  int dir = 0;               // 0 intra, 1 L0, 2 L1, 3 BI
  int mv0x = 0, mv0y = 0, mv1x = 0, mv1y = 0;
  int r0 = -1, r1 = -1;      // per-list reference index (-1 = unused)
  // unused-list MVs are zeroed / refs -1 by construction, so full
  // comparison matches the Python Motion dataclass equality exactly
  bool operator==(const MotionCu &o) const {
    return dir == o.dir && mv0x == o.mv0x && mv0y == o.mv0y &&
           mv1x == o.mv1x && mv1y == o.mv1y && r0 == o.r0 && r1 == o.r1;
  }
  void normalize() {
    if (!(dir & 1)) { mv0x = 0; mv0y = 0; r0 = -1; }
    if (!(dir & 2)) { mv1x = 0; mv1y = 0; r1 = -1; }
  }
};

// Per-frame decision store filled by the commit pass (phase 1) and read by
// the entropy pass (phase 2). Levels live at their plane positions; cbf and
// per-CU syntax decisions live on the 8x8 granule grid (CU/TU origin).
struct Stored {
  int w = 0, h = 0, gw8 = 0, gh8 = 0;
  std::vector<int32_t> lv_y, lv_cb, lv_cr;
  std::vector<uint8_t> cbf_y, cbf_cb, cbf_cr;
  std::vector<uint8_t> skip, merge_flag, rqt_root;
  std::vector<int8_t> merge_idx, mvp0, mvp1, ref0, ref1;
  std::vector<int16_t> mvd0x, mvd0y, mvd1x, mvd1y;
  // transform_skip_flag per 8x8 CU granule (4x4 chroma TBs of 8x8 CUs —
  // the only TS-eligible TBs while TU==CU and min luma CU is 8x8)
  std::vector<uint8_t> ts_cb, ts_cr;
  // depth-1 RQT split_transform_flag per 8x8 granule of the covering CU
  std::vector<uint8_t> tusplit;
  void init(int w_, int h_) {
    w = w_; h = h_; gw8 = w_ >> 3; gh8 = h_ >> 3;
    lv_y.assign(w * h, 0);
    lv_cb.assign(w * h / 4, 0);
    lv_cr.assign(w * h / 4, 0);
    int g = gw8 * gh8;
    cbf_y.assign(g, 0); cbf_cb.assign(g, 0); cbf_cr.assign(g, 0);
    skip.assign(g, 0); merge_flag.assign(g, 0); rqt_root.assign(g, 0);
    merge_idx.assign(g, 0); mvp0.assign(g, 0); mvp1.assign(g, 0);
    ref0.assign(g, 0); ref1.assign(g, 0);
    mvd0x.assign(g, 0); mvd0y.assign(g, 0);
    mvd1x.assign(g, 0); mvd1y.assign(g, 0);
    ts_cb.assign(g, 0); ts_cr.assign(g, 0);
    tusplit.assign(g, 0);
  }
  void store_block(std::vector<int32_t> &store, int stride, int x, int y,
                   int n, const int32_t *lv) {
    for (int yy = 0; yy < n; yy++)
      std::memcpy(store.data() + (y + yy) * stride + x, lv + yy * n,
                  sizeof(int32_t) * n);
  }
  void load_block(const std::vector<int32_t> &store, int stride, int x,
                  int y, int n, int32_t *lv) const {
    for (int yy = 0; yy < n; yy++)
      std::memcpy(lv + yy * n, store.data() + (y + yy) * stride + x,
                  sizeof(int32_t) * n);
  }
  void set_cbf(std::vector<uint8_t> &c, int lx, int ly, int ln, bool v) {
    for (int gy = ly >> 3; gy < (ly + ln) >> 3; gy++)
      for (int gx = lx >> 3; gx < (lx + ln) >> 3; gx++)
        c[gy * gw8 + gx] = v;
  }
};

// Per-CTB SAO parameters (spec 7.3.8.3), one per component
struct SaoP {
  int type = 0;       // 0 off, 1 band, 2 edge
  int eo_class = 0;
  int band_pos = 0;
  int off[4] = {0, 0, 0, 0};
};

struct SliceEnc {
  Frame *f;
  Encoder *e;
  Stored *st = nullptr;
  int tx0 = 0, ty0 = 0, tx1 = 1 << 20, ty1 = 1 << 20;  // tile rect (luma)
  int qp_y, qp_cb, qp_cr;
  bool lossless, bypass_enabled;
  bool rdoq = false;
  bool sdh = false;  // sign-data hiding (PPS sign_data_hiding_enabled_flag)
  bool ts_enabled = false;  // PPS transform_skip_enabled_flag
  int off_ts = -1;          // transform_skip_flag ctx offset (luma, +1 chroma)
  bool rqt_enabled = false;  // SPS max_transform_hierarchy_depth_inter > 0
  int off_split_tu = -1;     // split_transform_flag ctx offset
  int log2_min_cu = 3, log2_max_tu = 5;
  const uint8_t *src_y, *src_cb, *src_cr;
  const int8_t *depth_map, *mode_map;
  int dm_w;  // granule (8x8) map width
  // inter (P/B): 0 -> I slice
  int slice_type = 2;  // 2=I, 1=P, 0=B
  const int32_t *ref0_y = nullptr, *ref0_cb = nullptr, *ref0_cr = nullptr;
  const int32_t *ref1_y = nullptr, *ref1_cb = nullptr, *ref1_cr = nullptr;
  // second active reference per list (multi-ref; nullable)
  const int32_t *ref0b_y = nullptr, *ref0b_cb = nullptr,
                *ref0b_cr = nullptr;
  const int32_t *ref1b_y = nullptr, *ref1b_cb = nullptr,
                *ref1b_cr = nullptr;
  const int8_t *dir_map = nullptr;     // per-8x8 granule: 0..3
  const int16_t *mv_map = nullptr;     // per-8x8 granule: mv0x,mv0y,mv1x,mv1y
  const int8_t *ref_map = nullptr;     // per-8x8 granule: (ref0, ref1)
  // explicit weighted prediction (spec 8.5.3.3.4.3, mirrors spec/wp.py):
  // [0]=log2_denom_y, [1]=log2_denom_c, then per (list, ref) in order
  // (0,0),(0,1),(1,0),(1,1): {w_y,o_y,w_cb,o_cb,w_cr,o_cr}. null = off.
  const int32_t *wp = nullptr;
  // motion context (mirror of spec/inter.py MotionCtx): active-list POCs
  // + collocated-picture arrays for TMVP; defaults = single-ref, no TMVP
  int cur_poc = 0, n_l0 = 1, n_l1 = 1;
  int l0_pocs[2] = {0, 0}, l1_pocs[2] = {0, 0};
  bool tmvp = false, col_from_l0 = true, no_backward = true;
  int col_poc = 0;
  const int8_t *col_dir = nullptr;       // [gh8][gw8]
  const int16_t *col_mv = nullptr;       // [gh8][gw8][4]
  const int32_t *col_refpoc = nullptr;   // [gh8][gw8][2]
  int off_skip, off_pred_mode, off_merge_flag, off_merge_idx,
      off_inter_idc, off_mvd, off_mvp, off_rqt_root, off_ref_idx;
  // extra ctx family offsets
  int off_split, off_bypassflag, off_part, off_prev_intra, off_chroma_mode,
      off_cbf_luma, off_cbf_chroma;
  int off_sao_merge = -1, off_sao_type = -1;
  // SAO emission state (phase 2)
  bool sao_on = false;
  const SaoP *sao_y = nullptr, *sao_cb = nullptr, *sao_cr = nullptr;
  int sao_nx = 0;
  TrBuf trbuf;
};

// ---- trellis RDOQ (HM TComTrQuant::xRateDistOptQuant class) --------------
// Port of fasthevc_tpu/spec/rdoq.py (see its module docstring for the
// distortion/Parseval derivation and the deliberate differences from HM:
// slice-start context states for the rate model, exact encode_residual
// context schedule evaluated greedily in coding order).
//
// Byte-identity contract with the spec tier: the rate model must read the
// SAME context states ContextSet(0 if cu_is_intra else 2, tb_qp) the
// Python oracle builds — freshly initialized per (initType, TB qp), NOT
// the live drifting coder state — and the SAME frame-level lambda
// (lambda_mode = 0.57*2^((slice_qp_y-12)/3)) for every TB including
// chroma.  The residual-context init values below mirror
// spec/tables.py CTX_INIT rows for initType 0 and 2 (spec 9.3.2.2).
struct FracBits {
  int32_t t[64][2];
  FracBits() {
    double alpha = std::pow(0.01875 / 0.5, 1.0 / 63.0);
    for (int st = 0; st < 64; st++) {
      double pl = 0.5 * std::pow(alpha, st);
      t[st][0] = (int32_t)std::llround(-std::log2(1.0 - pl) * 32768.0);
      t[st][1] = (int32_t)std::llround(-std::log2(pl) * 32768.0);
    }
  }
};

// family offsets within the 94-entry RDOQ context snapshot
enum {
  kRdoqLastPrefix = 0,   // 18
  kRdoqCsbf = 18,        // 4
  kRdoqSig = 22,         // 42
  kRdoqGt1 = 64,         // 24
  kRdoqGt2 = 88,         // 6
  kRdoqNCtx = 94,
};

// initType 0 (intra CU) / initType 2 (inter CU) init values, concatenated
// last_prefix | csbf | sig | gt1 | gt2 (spec/tables.py CTX_INIT).
static const uint8_t kRdoqInit[2][kRdoqNCtx] = {
    {110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
     79,  108, 123, 63,
     91,  171, 134, 141,
     111, 111, 125, 110, 110, 94,  124, 108, 124, 107, 125, 141, 179, 153,
     125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140,
     139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111,
     140, 92,  137, 138, 140, 152, 138, 139, 153, 74,  149, 92,  139, 107,
     122, 152, 140, 179, 166, 182, 140, 227, 122, 197,
     138, 153, 136, 167, 152, 152},
    {125, 110, 124, 110, 95,  94,  125, 111, 111, 79,  125, 126, 111, 111,
     79,  108, 123, 93,
     121, 140, 61,  154,
     170, 154, 139, 153, 139, 123, 123, 63,  124, 166, 183, 140, 136, 153,
     154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170,
     153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140,
     154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
     136, 122, 169, 208, 166, 167, 154, 152, 167, 182,
     107, 167, 91,  107, 107, 167},
};

struct RdoqCtx {
  uint8_t state[kRdoqNCtx];
  uint8_t mps[kRdoqNCtx];
};

// all (initType in {0,2}) x (qp 0..51) snapshots, built once (thread-safe
// magic static; tiles call this concurrently)
struct RdoqCtxAll {
  RdoqCtx c[2][52];
  RdoqCtxAll() {
    for (int t = 0; t < 2; t++)
      for (int qp = 0; qp < 52; qp++)
        for (int i = 0; i < kRdoqNCtx; i++) {
          int iv = kRdoqInit[t][i];
          int slope = (iv >> 4) * 5 - 45;
          int offset = ((iv & 15) << 3) - 16;
          int pre = ((slope * qp) >> 4) + offset;
          if (pre < 1) pre = 1;
          if (pre > 126) pre = 126;
          if (pre <= 63) {
            c[t][qp].state[i] = (uint8_t)(63 - pre);
            c[t][qp].mps[i] = 0;
          } else {
            c[t][qp].state[i] = (uint8_t)(pre - 64);
            c[t][qp].mps[i] = 1;
          }
        }
  }
};

inline const RdoqCtx *rdoq_ctx_for(int cu_intra, int qp) {
  static const RdoqCtxAll all;
  if (qp < 0) qp = 0;
  if (qp > 51) qp = 51;
  return &all.c[cu_intra ? 0 : 1][qp];
}

inline int32_t rdoq_ctx_bits(const RdoqCtx *rc, int lin_idx, int b) {
  static const FracBits fb;
  int st = rc->state[lin_idx];
  int mps = rc->mps[lin_idx];
  return fb.t[st][b != mps ? 1 : 0];
}

inline int32_t rdoq_rem_bits(int value, int rice) {
  if (value < (3 << rice)) return ((value >> rice) + 1 + rice) * 32768;
  int length = rice;
  int v = value - (3 << rice);
  while (v >= (1 << length)) { v -= 1 << length; length++; }
  return ((3 + length + 1 - rice) + length) * 32768;
}

inline void rdoq_last_prefix(int pos, int *prefix, int *suffix_len) {
  if (pos <= 3) { *prefix = pos; *suffix_len = 0; return; }
  int sl = 0;
  { int p = pos; while (p >> (sl + 2)) sl++; }  // bit_length-2
  *suffix_len = sl;
  *prefix = 2 + sl * 2 + ((pos >> sl) & 1);
}

inline int32_t rdoq_last_bits(const RdoqCtx *rc, int px_, int py_, int lg,
                              int c_idx) {
  int g_max = (lg << 1) - 1;
  int offset, shift;
  last_ctx_params(lg, c_idx, &offset, &shift);
  int32_t total = 0;
  int pos[2] = {px_, py_};
  for (int t = 0; t < 2; t++) {
    int p, sl;
    rdoq_last_prefix(pos[t], &p, &sl);
    for (int i = 0; i < p; i++)
      total += rdoq_ctx_bits(rc, kRdoqLastPrefix + offset + (i >> shift),
                             1);
    if (p < g_max)
      total += rdoq_ctx_bits(rc, kRdoqLastPrefix + offset + (p >> shift),
                             0);
    if (p > 3) total += sl * 32768;
  }
  return total;
}

inline int32_t rdoq_level_bits(const RdoqCtx *rc, int lvl, int k, int c1,
                               int ctx_set, bool gt2_open, int rice,
                               int c_idx) {
  int32_t total = 32768;  // sign (bypass)
  if (k < 8) {
    int base = (c_idx ? 16 : 0) + 4 * ctx_set + c1;
    if (lvl > 1) {
      total += rdoq_ctx_bits(rc, kRdoqGt1 + base, 1);
      if (gt2_open) {
        int ctx2 = (c_idx ? 4 : 0) + ctx_set;
        total += rdoq_ctx_bits(rc, kRdoqGt2 + ctx2, lvl > 2 ? 1 : 0);
        if (lvl > 2) total += rdoq_rem_bits(lvl - 3, rice);
      } else {
        total += rdoq_rem_bits(lvl - 2, rice);
      }
    } else {
      total += rdoq_ctx_bits(rc, kRdoqGt1 + base, 0);
    }
  } else {
    total += rdoq_rem_bits(lvl - 1, rice);
  }
  return total;
}

// Returns true if any level nonzero. coeff/levels: [n*n] raster.
// cu_intra selects the rate-model initType (0 intra / 2 inter) exactly as
// spec/encoder.py _quantize_tb does; lambda is the frame-level
// lambda_mode derived from the slice luma QP for every component.
bool quantize_rdoq(int slice_qp_y, const int32_t *coeff, int lg, int qp,
                   int bit_depth, int c_idx, int scan_idx, int cu_intra,
                   int32_t *levels_out) {
  const RdoqCtx *rc = rdoq_ctx_for(cu_intra, qp);
  const Scan &sc = g_scans[lg - 2][scan_idx];
  int size = 1 << lg;
  int n_coeffs = size * size;
  int tshift = 15 - bit_depth - lg;
  int qbits = 14 + qp / 6 + tshift;
  int64_t q_scale = kQuantScales[qp % 6];
  double err_scale =
      1.0 / ((double)q_scale * (double)q_scale * (double)(1ll << (2 * tshift)));
  double lam = 0.57 * std::pow(2.0, (slice_qp_y - 12) / 3.0);
  double lam_frac = lam / 32768.0;

  static thread_local std::vector<int64_t> ld_v;
  static thread_local std::vector<int> m_v, lv_v, sgn_v;
  static thread_local std::vector<double> cost_lv, cost_zero, sig1_v;
  ld_v.assign(n_coeffs, 0);
  m_v.assign(n_coeffs, 0);
  lv_v.assign(n_coeffs, 0);
  sgn_v.assign(n_coeffs, 0);
  cost_lv.assign(n_coeffs, 0.0);
  cost_zero.assign(n_coeffs, 0.0);
  sig1_v.assign(n_coeffs, 0.0);
  int last_init = -1;
  for (int i = 0; i < n_coeffs; i++) {
    int32_t cc = coeff[sc.y[i] * size + sc.x[i]];
    sgn_v[i] = cc < 0 ? -1 : 1;
    int64_t a = cc < 0 ? -(int64_t)cc : (int64_t)cc;
    ld_v[i] = a * q_scale;
    int64_t mm = (ld_v[i] + (1ll << (qbits - 1))) >> qbits;
    if (mm > 32767) mm = 32767;
    m_v[i] = (int)mm;
    if (mm) last_init = i;
  }
  std::memset(levels_out, 0, sizeof(int32_t) * n_coeffs);
  if (last_init < 0) return false;

  int n_cgs = (last_init >> 4) + 1;
  int nsb = size / 4 > 0 ? size / 4 : 1;
  static thread_local std::vector<int> csbf;
  csbf.assign(nsb * nsb, 0);
  int c1 = 1;
  for (int ci = n_cgs - 1; ci >= 0; ci--) {
    int sx = sc.x[ci * 16] >> 2, sy = sc.y[ci * 16] >> 2;
    int right = sx + 1 < nsb ? csbf[sy * nsb + sx + 1] : 0;
    int below = sy + 1 < nsb ? csbf[(sy + 1) * nsb + sx] : 0;
    bool is_last_cg = ci == n_cgs - 1;
    int ctx_set = ((ci > 0 && c_idx == 0) ? 2 : 0) + (c1 ? 0 : 1);
    c1 = 1;
    int k = 0;
    bool gt2_open = true;
    int rice = 0;
    double cg_keep = 0.0, cg_zero = 0.0;
    int start = last_init - ci * 16;
    if (start > 15) start = 15;
    for (int n = start; n >= 0; n--) {
      int p = ci * 16 + n;
      int x = sc.x[p], y = sc.y[p];
      double d0 = (double)ld_v[p] * (double)ld_v[p] * err_scale;
      cost_zero[p] = d0;
      int sctx = sig_ctx_inc(lg, c_idx, x, y, scan_idx, right, below);
      int32_t s0 = rdoq_ctx_bits(rc, kRdoqSig + sctx, 0);
      int32_t s1 = rdoq_ctx_bits(rc, kRdoqSig + sctx, 1);
      double best_cost = d0 + lam_frac * s0;
      int best_lvl = 0;
      if (m_v[p] > 0) {
        int lo = m_v[p] - 1 >= 1 ? m_v[p] - 1 : 1;
        for (int lvl = m_v[p]; lvl >= lo; lvl--) {
          double eq = (double)(ld_v[p] - ((int64_t)lvl << qbits));
          double d = eq * eq * err_scale;
          double r = s1 + rdoq_level_bits(rc, lvl, k, c1, ctx_set,
                                          gt2_open, rice, c_idx);
          double cst = d + lam_frac * r;
          if (cst < best_cost) { best_cost = cst; best_lvl = lvl; }
        }
      }
      lv_v[p] = best_lvl;
      cost_lv[p] = best_cost;
      sig1_v[p] = lam_frac * s1;
      cg_keep += best_cost;
      cg_zero += d0;
      if (best_lvl) {
        if (k < 8) {
          if (best_lvl > 1) {
            gt2_open = false;
            c1 = 0;
          } else if (c1 > 0 && c1 < 3) {
            c1++;
          }
        }
        if (best_lvl > (3 << rice) && rice < 4) rice++;
        k++;
      }
    }
    bool cg_nz = false;
    for (int n = 0; n <= start; n++) cg_nz |= lv_v[ci * 16 + n] != 0;
    if (!is_last_cg && ci > 0) {
      int cctx = (right + below > 0 ? 1 : 0) + (c_idx ? 2 : 0);
      double b0 = lam_frac * rdoq_ctx_bits(rc, kRdoqCsbf + cctx, 0);
      double b1 = lam_frac * rdoq_ctx_bits(rc, kRdoqCsbf + cctx, 1);
      if (!cg_nz || cg_zero + b0 < cg_keep + b1) {
        for (int n = 0; n < 16; n++) lv_v[ci * 16 + n] = 0;
        cg_nz = false;
      }
    }
    csbf[sy * nsb + sx] = cg_nz ? 1 : 0;
  }

  // last-position optimization
  static thread_local std::vector<int> nzp;
  nzp.clear();
  for (int i = 0; i < n_coeffs; i++)
    if (lv_v[i]) nzp.push_back(i);
  if (nzp.empty()) return false;
  double best_total = 0.0;
  int best_j = (int)nzp.size() - 1;
  bool have_best = false;
  double drop = 0.0;
  for (int j = (int)nzp.size() - 1; j >= 0; j--) {
    int p = nzp[j];
    int lx = sc.x[p], ly = sc.y[p];
    if (scan_idx == 2) { int t = lx; lx = ly; ly = t; }
    double total = drop + lam_frac * rdoq_last_bits(rc, lx, ly, lg, c_idx) -
                   sig1_v[p];
    if (!have_best || total < best_total) {
      best_total = total;
      best_j = j;
      have_best = true;
    }
    drop += cost_zero[p] - cost_lv[p];
    int lo = j > 0 ? nzp[j - 1] + 1 : 0;
    for (int q = lo; q < p; q++) drop -= cost_lv[q] - cost_zero[q];
  }
  int new_last = nzp[best_j];
  for (int i = new_last + 1; i < n_coeffs; i++) lv_v[i] = 0;

  bool any = false;
  for (int i = 0; i < n_coeffs; i++) {
    levels_out[sc.y[i] * size + sc.x[i]] = (int32_t)(lv_v[i] * sgn_v[i]);
    any |= lv_v[i] != 0;
  }
  return any;
}

// Context/MPM neighbor checks use coding-order availability (f.avail) so
// they are valid BOTH during the single-pass flow and in the two-phase
// emit pass, where every granule map is already fully populated: avail()
// is exactly "this neighbor was coded before the current CU" — the same
// predicate the gcoded bitmap used to encode incrementally.
int split_ctx(SliceEnc *s, int x, int y, int depth) {
  int ctx = 0;
  Frame &f = *s->f;
  if (x > s->tx0 && f.avail(x - 1, y, x, y, s->tx0, s->ty0, s->tx1, s->ty1)
      && f.gdepth[(y >> 2) * f.gw + ((x - 1) >> 2)] > depth)
    ctx++;
  if (y > s->ty0 && f.avail(x, y - 1, x, y, s->tx0, s->ty0, s->tx1, s->ty1)
      && f.gdepth[((y - 1) >> 2) * f.gw + (x >> 2)] > depth)
    ctx++;
  return ctx;
}

void mpm_candidates(SliceEnc *s, int x, int y, int cands[3]) {
  Frame &f = *s->f;
  int a = 1, b = 1;  // DC default
  if (x > s->tx0 &&
      f.avail(x - 1, y, x, y, s->tx0, s->ty0, s->tx1, s->ty1)) {
    int m = f.gmode[(y >> 2) * f.gw + ((x - 1) >> 2)];
    if (m >= 0) a = m;
  }
  bool above_in_ctu = (y & ((1 << f.log2_ctu) - 1)) != 0;
  if (y > s->ty0 && above_in_ctu &&
      f.avail(x, y - 1, x, y, s->tx0, s->ty0, s->tx1, s->ty1)) {
    int m = f.gmode[((y - 1) >> 2) * f.gw + (x >> 2)];
    if (m >= 0) b = m;
  }
  if (a == b) {
    if (a < 2) {
      cands[0] = 0; cands[1] = 1; cands[2] = 26;
    } else {
      cands[0] = a;
      cands[1] = 2 + ((a + 29) % 32);
      cands[2] = 2 + ((a - 2 + 1) % 32);
    }
  } else {
    cands[0] = a;
    cands[1] = b;
    if (a != 0 && b != 0) cands[2] = 0;
    else if (a != 1 && b != 1) cands[2] = 1;
    else cands[2] = 26;
  }
}

void set_cu(SliceEnc *s, int x, int y, int size, int depth, int mode) {
  Frame &f = *s->f;
  for (int gy = y >> 2; gy < (y + size) >> 2; gy++)
    for (int gx = x >> 2; gx < (x + size) >> 2; gx++) {
      f.gdepth[gy * f.gw + gx] = (int8_t)depth;
      f.gmode[gy * f.gw + gx] = (int8_t)mode;
      f.gcoded[gy * f.gw + gx] = 1;
    }
}

// ---- inter helpers ---------------------------------------------------------
void set_motion_cu(SliceEnc *s, int x, int y, int size, const MotionCu &m,
                   bool skip, bool cbf_y) {
  Frame &f = *s->f;
  for (int gy = y >> 2; gy < (y + size) >> 2; gy++)
    for (int gx = x >> 2; gx < (x + size) >> 2; gx++) {
      int g = gy * f.gw + gx;
      f.ginter[g] = 1;
      f.gskip[g] = skip;
      f.gcbf[g] = cbf_y;
      f.gmv[g * 4 + 0] = (m.dir & 1) ? m.mv0x : 0;
      f.gmv[g * 4 + 1] = (m.dir & 1) ? m.mv0y : 0;
      f.gmv[g * 4 + 2] = (m.dir & 2) ? m.mv1x : 0;
      f.gmv[g * 4 + 3] = (m.dir & 2) ? m.mv1y : 0;
      f.gref[g * 2 + 0] = (m.dir & 1) ? m.r0 : -1;
      f.gref[g * 2 + 1] = (m.dir & 2) ? m.r1 : -1;
    }
}

void set_intra_motion(SliceEnc *s, int x, int y, int size, bool cbf_y) {
  Frame &f = *s->f;
  for (int gy = y >> 2; gy < (y + size) >> 2; gy++)
    for (int gx = x >> 2; gx < (x + size) >> 2; gx++) {
      int g = gy * f.gw + gx;
      f.ginter[g] = 0;
      f.gskip[g] = 0;
      f.gcbf[g] = cbf_y;
      f.gref[g * 2 + 0] = -1;
      f.gref[g * 2 + 1] = -1;
    }
}

// motion of PU covering (xn, yn), available + inter; returns dir 0 if not
MotionCu motion_at(SliceEnc *s, int xn, int yn, int xc, int yc) {
  MotionCu m;
  Frame &f = *s->f;
  if (!f.avail(xn, yn, xc, yc, s->tx0, s->ty0, s->tx1, s->ty1)) return m;
  int g = (yn >> 2) * f.gw + (xn >> 2);
  if (!f.ginter[g]) return m;
  int r0 = f.gref[g * 2], r1 = f.gref[g * 2 + 1];
  m.dir = (r0 >= 0 ? 1 : 0) | (r1 >= 0 ? 2 : 0);
  m.mv0x = f.gmv[g * 4 + 0];
  m.mv0y = f.gmv[g * 4 + 1];
  m.mv1x = f.gmv[g * 4 + 2];
  m.mv1y = f.gmv[g * 4 + 3];
  m.r0 = r0;
  m.r1 = r1;
  m.normalize();
  return m;
}

// ---- TMVP + MV scaling (mirror of spec/inter.py) ---------------------------

inline int clip3i(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// POC-distance MV scaling (spec 8.5.3.2.8); C division truncates like the
// spec's tx = (16384 + |td|/2) / td
inline void mv_scale_cpp(int mvx, int mvy, int tb, int td, int *ox,
                         int *oy) {
  td = clip3i(-128, 127, td);
  tb = clip3i(-128, 127, tb);
  int tx = (16384 + (std::abs(td) >> 1)) / td;
  int dsf = clip3i(-4096, 4095, (tb * tx + 32) >> 6);
  auto s = [&](int c) {
    int64_t v = (int64_t)dsf * c;
    int64_t m = (std::llabs(v) + 127) >> 8;
    return (int)clip3i(-32768, 32767, (int)(v < 0 ? -m : m));
  };
  *ox = s(mvx);
  *oy = s(mvy);
}

// collocated MV for target list X (spec 8.5.3.2.8); returns false if the
// sampled col block is intra/absent
bool derive_col_mv(SliceEnc *s, int xc, int yc, int x_list,
                   int target_refpoc, int *ox, int *oy) {
  if (!s->col_dir) return false;
  int gx = (((xc >> 4) << 4) >> 3), gy = (((yc >> 4) << 4) >> 3);
  Stored &st = *s->st;
  if (gy >= st.gh8 || gx >= st.gw8) return false;
  int g = gy * st.gw8 + gx;
  int d = s->col_dir[g];
  if (d == 0) return false;
  int list_col;
  if (!(d & 1)) list_col = 1;
  else if (!(d & 2)) list_col = 0;
  else if (s->no_backward) list_col = x_list;
  else list_col = s->col_from_l0 ? 1 : 0;
  int mvx = s->col_mv[g * 4 + 2 * list_col];
  int mvy = s->col_mv[g * 4 + 2 * list_col + 1];
  int col_refpoc = s->col_refpoc[g * 2 + list_col];
  int td = s->col_poc - col_refpoc;
  int tb = s->cur_poc - target_refpoc;
  if (td == tb) { *ox = mvx; *oy = mvy; return true; }
  mv_scale_cpp(mvx, mvy, tb, td, ox, oy);
  return true;
}

// TMVP for (list X, ref_idx) (spec 8.5.3.2.7): C0 bottom-right when in
// picture and same CTU row, else C1 center
bool temporal_candidate_cpp(SliceEnc *s, int x, int y, int size,
                            int x_list, int ref_idx, int *ox, int *oy) {
  if (!s->tmvp || !s->col_dir) return false;
  int n_ref = x_list == 0 ? s->n_l0 : s->n_l1;
  if (ref_idx >= n_ref) return false;
  int target = x_list == 0 ? s->l0_pocs[ref_idx] : s->l1_pocs[ref_idx];
  Frame &f = *s->f;
  int ctb = 1 << f.log2_ctu;
  int xbr = x + size, ybr = y + size;
  if ((y / ctb == ybr / ctb) && ybr < f.coded_h && xbr < f.coded_w &&
      derive_col_mv(s, xbr, ybr, x_list, target, ox, oy))
    return true;
  return derive_col_mv(s, x + size / 2, y + size / 2, x_list, target, ox,
                       oy);
}

// merge candidate list (matches spec/inter.py merge_candidates):
// spatial + temporal + combined-bi (B) + zero candidates w/ ref cycling
int merge_list(SliceEnc *s, int x, int y, int size, MotionCu out[5]) {
  bool is_b = s->slice_type == 0;
  MotionCu a1 = motion_at(s, x - 1, y + size - 1, x, y);
  MotionCu b1 = motion_at(s, x + size - 1, y - 1, x, y);
  MotionCu b0 = motion_at(s, x + size, y - 1, x, y);
  MotionCu a0 = motion_at(s, x - 1, y + size, x, y);
  MotionCu b2 = motion_at(s, x - 1, y - 1, x, y);
  int n = 0;
  if (a1.dir) out[n++] = a1;
  if (b1.dir && !(a1.dir && b1 == a1)) out[n++] = b1;
  if (b0.dir && !(b1.dir && b0 == b1)) out[n++] = b0;
  if (a0.dir && !(a1.dir && a0 == a1)) out[n++] = a0;
  int n4 = (a0.dir != 0) + (a1.dir != 0) + (b0.dir != 0) + (b1.dir != 0);
  if (n < 4 && n4 < 4 && b2.dir && !(a1.dir && b2 == a1) &&
      !(b1.dir && b2 == b1))
    out[n++] = b2;
  // temporal candidate, refIdx 0 per list (spec 8.5.3.2.3 step 4)
  if (s->tmvp && n < 5) {
    int mx0, my0, mx1, my1;
    bool h0 = temporal_candidate_cpp(s, x, y, size, 0, 0, &mx0, &my0);
    bool h1 = is_b &&
              temporal_candidate_cpp(s, x, y, size, 1, 0, &mx1, &my1);
    if (h0 || h1) {
      MotionCu t;
      t.dir = (h0 ? 1 : 0) | (h1 ? 2 : 0);
      if (h0) { t.mv0x = mx0; t.mv0y = my0; t.r0 = 0; }
      if (h1) { t.mv1x = mx1; t.mv1y = my1; t.r1 = 0; }
      out[n++] = t;
    }
  }
  // combined bi-predictive candidates (spec 8.5.3.2.4)
  int n_orig = n;
  if (is_b && n_orig > 1 && n < 5) {
    static const int L0C[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
    static const int L1C[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
    int kmax = n_orig * (n_orig - 1);
    if (kmax > 12) kmax = 12;
    for (int k = 0; k < kmax && n < 5; k++) {
      const MotionCu &c0 = out[L0C[k]];
      const MotionCu &c1 = out[L1C[k]];
      if (!((c0.dir & 1) && (c1.dir & 2))) continue;
      int p0 = c0.r0 < s->n_l0 ? s->l0_pocs[c0.r0] : 0;
      int p1 = c1.r1 < s->n_l1 ? s->l1_pocs[c1.r1] : 0;
      if (p0 != p1 || c0.mv0x != c1.mv1x || c0.mv0y != c1.mv1y) {
        MotionCu c;
        c.dir = 3;
        c.mv0x = c0.mv0x; c.mv0y = c0.mv0y; c.r0 = c0.r0;
        c.mv1x = c1.mv1x; c.mv1y = c1.mv1y; c.r1 = c1.r1;
        out[n++] = c;
      }
    }
  }
  // zero candidates with reference cycling (spec 8.5.3.2.5)
  int n_ref = is_b ? (s->n_l0 < s->n_l1 ? s->n_l0 : s->n_l1) : s->n_l0;
  if (n_ref < 1) n_ref = 1;
  int zero_idx = 0;
  while (n < 5) {
    int r = zero_idx < n_ref ? zero_idx : 0;
    MotionCu zero;
    zero.dir = is_b ? 3 : 1;
    zero.r0 = r;
    if (is_b) zero.r1 = r;
    out[n++] = zero;
    zero_idx++;
  }
  return 5;
}

// AMVP list for (list, ref_idx) (matches spec/inter.py amvp_candidates):
// spatial A (A0/A1 same-POC then scaled) and B (B0/B1/B2 same-POC;
// scaled only when no left neighbor exists), dedup, TMVP, zero fill
void amvp_list(SliceEnc *s, int x, int y, int size, int list_idx,
               int ref_idx, int out[2][2]) {
  int target_poc = 0;
  if (list_idx == 0)
    target_poc = ref_idx < s->n_l0 ? s->l0_pocs[ref_idx] : 0;
  else
    target_poc = ref_idx < s->n_l1 ? s->l1_pocs[ref_idx] : 0;
  MotionCu cands[5] = {motion_at(s, x - 1, y + size, x, y),
                       motion_at(s, x - 1, y + size - 1, x, y),
                       motion_at(s, x + size, y - 1, x, y),
                       motion_at(s, x + size - 1, y - 1, x, y),
                       motion_at(s, x - 1, y - 1, x, y)};
  auto ref_poc_of = [&](const MotionCu &m, int li) {
    int r = li == 0 ? m.r0 : m.r1;
    if (li == 0) return (r >= 0 && r < s->n_l0) ? s->l0_pocs[r] : 0;
    return (r >= 0 && r < s->n_l1) ? s->l1_pocs[r] : 0;
  };
  auto mv_same_poc = [&](const MotionCu &m, int *ox, int *oy) {
    if (!m.dir) return false;
    for (int t = 0; t < 2; t++) {
      int li = t == 0 ? list_idx : 1 - list_idx;
      if (m.dir & (1 << li)) {
        if (ref_poc_of(m, li) == target_poc) {
          *ox = li ? m.mv1x : m.mv0x;
          *oy = li ? m.mv1y : m.mv0y;
          return true;
        }
      }
    }
    return false;
  };
  auto mv_scaled = [&](const MotionCu &m, int *ox, int *oy) {
    if (!m.dir) return false;
    for (int t = 0; t < 2; t++) {
      int li = t == 0 ? list_idx : 1 - list_idx;
      if (m.dir & (1 << li)) {
        int mvx = li ? m.mv1x : m.mv0x;
        int mvy = li ? m.mv1y : m.mv0y;
        int npoc = ref_poc_of(m, li);
        int td = s->cur_poc - npoc;
        int tb = s->cur_poc - target_poc;
        if (td == tb) { *ox = mvx; *oy = mvy; return true; }
        mv_scale_cpp(mvx, mvy, tb, td, ox, oy);
        return true;
      }
    }
    return false;
  };
  bool is_scaled = cands[0].dir || cands[1].dir;
  int ax = 0, ay = 0, bx = 0, by = 0;
  bool have_a = false, have_b = false;
  for (int i = 0; i < 2 && !have_a; i++)
    have_a = mv_same_poc(cands[i], &ax, &ay);
  if (!have_a)
    for (int i = 0; i < 2 && !have_a; i++)
      have_a = mv_scaled(cands[i], &ax, &ay);
  for (int i = 2; i < 5 && !have_b; i++)
    have_b = mv_same_poc(cands[i], &bx, &by);
  if (!have_b && !is_scaled)
    for (int i = 2; i < 5 && !have_b; i++)
      have_b = mv_scaled(cands[i], &bx, &by);
  int n = 0;
  int lst[2][2] = {{0, 0}, {0, 0}};
  if (have_a) { lst[n][0] = ax; lst[n][1] = ay; n++; }
  if (have_b && (!have_a || bx != ax || by != ay)) {
    lst[n][0] = bx; lst[n][1] = by; n++;
  }
  if (n < 2 && s->tmvp) {
    int tx, ty;
    if (temporal_candidate_cpp(s, x, y, size, list_idx, ref_idx, &tx,
                               &ty)) {
      lst[n][0] = tx; lst[n][1] = ty; n++;
    }
  }
  for (int i = 0; i < 2; i++) {
    out[i][0] = i < n ? lst[i][0] : 0;
    out[i][1] = i < n ? lst[i][1] : 0;
  }
}

// mvd coding (matches spec/inter.py encode_mvd)
void encode_mvd_cpp(SliceEnc *s, int mx, int my) {
  Encoder *e = s->e;
  int g0x = mx != 0, g0y = my != 0;
  e->encode_bin(s->off_mvd + 0, g0x);
  e->encode_bin(s->off_mvd + 0, g0y);
  int g1x = (mx > 1 || mx < -1), g1y = (my > 1 || my < -1);
  if (g0x) e->encode_bin(s->off_mvd + 1, g1x);
  if (g0y) e->encode_bin(s->off_mvd + 1, g1y);
  int vals[2] = {mx, my};
  int g0s[2] = {g0x, g0y}, g1s[2] = {g1x, g1y};
  for (int i = 0; i < 2; i++) {
    if (!g0s[i]) continue;
    int v = vals[i] < 0 ? -vals[i] : vals[i];
    if (g1s[i]) {
      // EG1 of v-2
      uint32_t value = v - 2;
      int k = 1;
      while (value >= (1u << k)) {
        e->encode_bypass(1);
        value -= 1u << k;
        k++;
      }
      e->encode_bypass(0);
      e->encode_bypass_bits(value, k);
    }
    e->encode_bypass(vals[i] < 0 ? 1 : 0);
  }
}

// ref_idx_lX (matches spec/inter.py encode_ref_idx): TR cMax =
// num_active-1, bins 0/1 context-coded, rest bypass
void encode_ref_idx_cpp(SliceEnc *s, int idx, int num_active) {
  if (num_active <= 1) return;
  Encoder *e = s->e;
  int cmax = num_active - 1;
  for (int k = 0; k < idx; k++) {
    if (k < 2) e->encode_bin(s->off_ref_idx + k, 1);
    else e->encode_bypass(1);
  }
  if (idx < cmax) {
    if (idx < 2) e->encode_bin(s->off_ref_idx + idx, 0);
    else e->encode_bypass(0);
  }
}

void encode_merge_idx_cpp(SliceEnc *s, int idx) {
  Encoder *e = s->e;
  e->encode_bin(s->off_merge_idx, idx > 0);
  if (idx > 0) {
    for (int k = 1; k < idx; k++) e->encode_bypass(1);
    if (idx < 4) e->encode_bypass(0);
  }
}

// one transform block: predict, residual, TQ, recon; returns cbf
int scan_for(int lg, int c_idx, int mode);

bool commit_tb(SliceEnc *s, int c_idx, int x, int y, int lg, int mode,
               int32_t *levels_out, int *ts_out = nullptr) {
  Frame &f = *s->f;
  int n = 1 << lg;
  int w = f.pw(c_idx);
  int32_t top[65], left[65], ftop[65], fleft[65];
  get_refs(&f, c_idx, x, y, n, top, left, s->tx0, s->ty0,
           s->tx1, s->ty1);
  const int32_t *ut = top, *ul = left;
  if (c_idx == 0 && should_filter(mode, n, true)) {
    filter_refs(top, left, n, ftop, fleft);
    ut = ftop;
    ul = fleft;
  }
  int32_t pred[32 * 32];
  predict(mode, ut, ul, n, c_idx == 0, f.bit_depth, pred);
  const uint8_t *src = c_idx == 0 ? s->src_y : c_idx == 1 ? s->src_cb
                                                          : s->src_cr;
  int32_t res[32 * 32];
  for (int yy = 0; yy < n; yy++)
    for (int xx = 0; xx < n; xx++)
      res[yy * n + xx] =
          (int32_t)src[(y + yy) * w + (x + xx)] - pred[yy * n + xx];
  bool cbf;
  int32_t rq[32 * 32];
  if (s->lossless) {
    cbf = false;
    if (ts_out) *ts_out = 0;
    for (int i = 0; i < n * n; i++) {
      levels_out[i] = res[i];
      cbf |= res[i] != 0;
      rq[i] = res[i];
    }
  } else {
    bool dst = (c_idx == 0 && lg == 2);
    int qp = c_idx == 0 ? s->qp_y : c_idx == 1 ? s->qp_cb : s->qp_cr;
    int scan = scan_for(lg, c_idx, mode);
    int32_t coeff[32 * 32];
    fwd_transform(res, lg, dst, f.bit_depth, coeff, &s->trbuf);
    cbf = s->rdoq ? quantize_rdoq(s->qp_y, coeff, lg, qp, f.bit_depth, c_idx,
                                  scan, 1, levels_out)
                  : quantize(coeff, lg, qp, f.bit_depth, levels_out);
    if (cbf && s->sdh)
      sdh_adjust(levels_out, coeff, lg, qp, f.bit_depth, scan);
    if (cbf) {
      int32_t deq[32 * 32];
      dequantize(levels_out, lg, qp, f.bit_depth, deq);
      inv_transform(deq, lg, dst, f.bit_depth, rq, &s->trbuf);
    } else {
      std::memset(rq, 0, sizeof(int32_t) * n * n);
    }
    // transform-skip variant for 4x4 TBs (PPS flag on): RD choice with
    // the integer-exact cost shared with codec/encoder.py _commit_tu
    if (ts_out && s->ts_enabled && lg == 2) {
      double lam = 0.57 * std::pow(2.0, (s->qp_y - 12) / 3.0);
      // rq is the DCT-variant recon (zeros when !cbf; levels_out too)
      double cost_dct = (double)sse_blk(res, rq, 4)
                        + lam * (double)ts_bits_est(levels_out, 4);
      int32_t cts[16], lts[16], deq_ts[16], rq_ts[16];
      fwd_transform_skip(res, f.bit_depth, cts);
      bool cbf_ts = quantize(cts, 2, qp, f.bit_depth, lts);
      if (cbf_ts && s->sdh)
        sdh_adjust(lts, cts, 2, qp, f.bit_depth, scan);
      if (cbf_ts) {
        dequantize(lts, 2, qp, f.bit_depth, deq_ts);
        inv_transform_skip(deq_ts, f.bit_depth, rq_ts);
      } else {
        std::memset(rq_ts, 0, sizeof(rq_ts));
      }
      double cost_ts = (double)sse_blk(res, rq_ts, 4)
                       + lam * (double)ts_bits_est(lts, 4);
      if (cost_ts < cost_dct) {
        cbf = cbf_ts;
        std::memcpy(levels_out, lts, sizeof(lts));
        std::memcpy(rq, rq_ts, sizeof(rq_ts));
        *ts_out = cbf_ts ? 1 : 0;
      } else {
        *ts_out = 0;
      }
    } else if (ts_out) {
      *ts_out = 0;
    }
  }
  int maxv = (1 << f.bit_depth) - 1;
  int32_t *plane = f.plane(c_idx);
  for (int yy = 0; yy < n; yy++)
    for (int xx = 0; xx < n; xx++) {
      int32_t v = pred[yy * n + xx] + (cbf ? rq[yy * n + xx] : 0);
      plane[(y + yy) * w + (x + xx)] = v < 0 ? 0 : v > maxv ? maxv : v;
    }
  return cbf;
}

int scan_for(int lg, int c_idx, int mode) {
  if (lg == 2 || (lg == 3 && c_idx == 0)) {
    if (mode >= 6 && mode <= 14) return 2;
    if (mode >= 22 && mode <= 30) return 1;
  }
  return 0;
}

int skip_ctx(SliceEnc *s, int x, int y) {
  Frame &f = *s->f;
  int ctx = 0;
  if (x > s->tx0 && f.avail(x - 1, y, x, y, s->tx0, s->ty0, s->tx1, s->ty1)
      && f.gskip[(y >> 2) * f.gw + ((x - 1) >> 2)])
    ctx++;
  if (y > s->ty0 && f.avail(x, y - 1, x, y, s->tx0, s->ty0, s->tx1, s->ty1)
      && f.gskip[((y - 1) >> 2) * f.gw + (x >> 2)])
    ctx++;
  return ctx;
}

void store_inter_syntax(SliceEnc *s, int x, int y, int lg, int depth,
                        const MotionCu &m, bool cbf_any, bool cbf_y_any);

// Commit one inter CU (P/B, 2Nx2N, one ref per list): MC + TQ + recon +
// merge/AMVP decisions into the store; no bits are emitted (phase 1).
void commit_inter_cu(SliceEnc *s, int x, int y, int lg, int depth,
                     const MotionCu &m) {
  Frame &f = *s->f;
  int n = 1 << lg;
  int cn = n >> 1;

  // ---- motion compensation (14-bit raw, then uni/bi rounding) ----------
  static thread_local std::vector<int64_t> r0, r1;
  r0.assign(n * n, 0);
  r1.assign(n * n, 0);
  std::vector<int32_t> pred_y(n * n), pred_cb(cn * cn), pred_cr(cn * cn);
  int maxv = (1 << f.bit_depth) - 1;
  auto blend = [&](const int64_t *a, const int64_t *b, int cnt,
                   int32_t *out, int ci) {
    if (s->wp) {
      // explicit weighted sample prediction — bit-for-bit mirror of
      // spec/mc.py _uni_w/_bi_w (spec 8.5.3.3.4.3)
      int denom = ci == 0 ? s->wp[0] : s->wp[1];
      int log2wd = denom + (14 - f.bit_depth);
      auto ent = [&](int li, int ri, int *w_out, int *o_out) {
        const int32_t *e =
            s->wp + 2 + (li * 2 + (ri > 0 ? 1 : 0)) * 6 + ci * 2;
        *w_out = e[0];
        *o_out = e[1];
      };
      if (m.dir == 3) {
        int w0, o0, w1, o1;
        ent(0, m.r0, &w0, &o0);
        ent(1, m.r1, &w1, &o1);
        int64_t rnd = (int64_t)(o0 + o1 + 1) << log2wd;
        for (int i = 0; i < cnt; i++)
          out[i] = clampi(
              (int)((a[i] * w0 + b[i] * w1 + rnd) >> (log2wd + 1)), 0,
              maxv);
      } else {
        const int64_t *src = (m.dir == 1) ? a : b;
        int w0, o0;
        if (m.dir == 1) ent(0, m.r0, &w0, &o0);
        else ent(1, m.r1, &w0, &o0);
        int64_t half = (int64_t)1 << (log2wd - 1);
        for (int i = 0; i < cnt; i++)
          out[i] = clampi((int)(((src[i] * w0 + half) >> log2wd) + o0),
                          0, maxv);
      }
      return;
    }
    if (m.dir == 3) {
      for (int i = 0; i < cnt; i++)
        out[i] = clampi((int)((a[i] + b[i] + 64) >> 7), 0, maxv);
    } else {
      const int64_t *src = (m.dir == 1) ? a : b;
      for (int i = 0; i < cnt; i++)
        out[i] = clampi((int)((src[i] + 32) >> 6), 0, maxv);
    }
  };
  int w = f.coded_w, h = f.coded_h;
  // multi-ref: pick the reference plane per list by the PU's ref idx
  bool b0 = m.r0 == 1 && s->ref0b_y;
  bool b1 = m.r1 == 1 && s->ref1b_y;
  const int32_t *l0y = b0 ? s->ref0b_y : s->ref0_y;
  const int32_t *l0cb = b0 ? s->ref0b_cb : s->ref0_cb;
  const int32_t *l0cr = b0 ? s->ref0b_cr : s->ref0_cr;
  const int32_t *l1y = b1 ? s->ref1b_y : s->ref1_y;
  const int32_t *l1cb = b1 ? s->ref1b_cb : s->ref1_cb;
  const int32_t *l1cr = b1 ? s->ref1b_cr : s->ref1_cr;
  if (m.dir & 1) mc_raw(l0y, w, h, x, y, n, n, m.mv0x, m.mv0y, true,
                        r0.data());
  if (m.dir & 2) mc_raw(l1y, w, h, x, y, n, n, m.mv1x, m.mv1y, true,
                        r1.data());
  blend(r0.data(), r1.data(), n * n, pred_y.data(), 0);
  if (m.dir & 1) mc_raw(l0cb, w / 2, h / 2, x >> 1, y >> 1, cn, cn,
                        m.mv0x, m.mv0y, false, r0.data());
  if (m.dir & 2) mc_raw(l1cb, w / 2, h / 2, x >> 1, y >> 1, cn, cn,
                        m.mv1x, m.mv1y, false, r1.data());
  blend(r0.data(), r1.data(), cn * cn, pred_cb.data(), 1);
  if (m.dir & 1) mc_raw(l0cr, w / 2, h / 2, x >> 1, y >> 1, cn, cn,
                        m.mv0x, m.mv0y, false, r0.data());
  if (m.dir & 2) mc_raw(l1cr, w / 2, h / 2, x >> 1, y >> 1, cn, cn,
                        m.mv1x, m.mv1y, false, r1.data());
  blend(r0.data(), r1.data(), cn * cn, pred_cr.data(), 2);

  // ---- residual TQ: TU == CU, 64 -> 4x32 forced split, or depth-1 RQT
  // (split_transform_flag) — the RD choice is mirrored bit-for-bit by
  // codec/encoder.py _commit_inter build_variant (integer-exact cost)
  bool forced = lg > s->log2_max_tu;
  static thread_local std::vector<int32_t> lv_y, lv_cb, lv_cr, res, coeff,
      deq, rq, lvs_y, lvs_cb, lvs_cr, recu_y, recu_cb, recu_cr, recs_y,
      recs_cb, recs_cr;
  res.assign(32 * 32, 0);
  coeff.assign(32 * 32, 0);
  deq.assign(32 * 32, 0);
  rq.assign(32 * 32, 0);
  bool cbf_y[4] = {}, cbf_cb[4] = {}, cbf_cr[4] = {};
  int ts_cb_f[4] = {0, 0, 0, 0}, ts_cr_f[4] = {0, 0, 0, 0};

  auto do_tb = [&](int nt, int t_lg, int ci, int ti, int32_t *levels,
                   bool *cbf, int *ts_out, int32_t *rec, int64_t *sse_acc,
                   int64_t *bits_acc) {
    int t_n = 1 << t_lg;
    int bs = ci == 0 ? t_n : t_n / 2;
    int blg = ci == 0 ? t_lg : t_lg - 1;
    int hf = n >> 1;
    int ox = (nt == 1 ? 0 : (ti & 1) * hf) >> (ci ? 1 : 0);
    int oy = (nt == 1 ? 0 : (ti >> 1) * hf) >> (ci ? 1 : 0);
    int bx = (ci == 0 ? x : x >> 1) + ox, by = (ci == 0 ? y : y >> 1) + oy;
    int pw = ci == 0 ? n : cn;
    const int32_t *pred = ci == 0 ? pred_y.data()
                          : ci == 1 ? pred_cb.data() : pred_cr.data();
    const uint8_t *src = ci == 0 ? s->src_y : ci == 1 ? s->src_cb
                                                      : s->src_cr;
    int sw = ci == 0 ? w : w / 2;
    int qp = ci == 0 ? s->qp_y : ci == 1 ? s->qp_cb : s->qp_cr;
    for (int yy = 0; yy < bs; yy++)
      for (int xx = 0; xx < bs; xx++)
        res[yy * bs + xx] = (int32_t)src[(by + yy) * sw + (bx + xx)] -
                            pred[(oy + yy) * pw + (ox + xx)];
    bool any;
    if (s->lossless) {
      any = false;
      for (int i = 0; i < bs * bs; i++) {
        levels[i] = res[i];
        any |= res[i] != 0;
        rq[i] = res[i];
      }
    } else {
      fwd_transform(res.data(), blg, false, f.bit_depth, coeff.data(),
                    &s->trbuf);
      if (s->rdoq) {
        any = quantize_rdoq(s->qp_y, coeff.data(), blg, qp, f.bit_depth, ci, 0, 0,
                            levels);
      } else {
        // inter dead-zone offset (85/512)
        int nn = 1 << blg;
        int tshift = 15 - f.bit_depth - blg;
        int qbits = 14 + qp / 6 + tshift;
        int64_t scale = kQuantScales[qp % 6];
        int64_t off = (int64_t)85 << (qbits - 9);
        any = false;
        for (int i = 0; i < nn * nn; i++) {
          int64_t c = coeff[i];
          int64_t a = c < 0 ? -c : c;
          int64_t lvv = (a * scale + off) >> qbits;
          if (lvv > 32767) lvv = 32767;
          levels[i] = (int32_t)(c < 0 ? -lvv : lvv);
          any |= lvv != 0;
        }
      }
      if (any && s->sdh)
        sdh_adjust(levels, coeff.data(), blg, qp, f.bit_depth, 0);
      if (any) {
        dequantize(levels, blg, qp, f.bit_depth, deq.data());
        inv_transform(deq.data(), blg, false, f.bit_depth, rq.data(),
                      &s->trbuf);
      } else {
        std::memset(rq.data(), 0, sizeof(int32_t) * bs * bs);
      }
      // transform-skip variant for 4x4 TBs (inter twin of commit_tb's;
      // integer-exact cost shared with codec/encoder.py _commit_inter)
      if (ts_out && s->ts_enabled && blg == 2) {
        double lam = 0.57 * std::pow(2.0, (s->qp_y - 12) / 3.0);
        double cost_dct = (double)sse_blk(res.data(), rq.data(), 4)
                          + lam * (double)ts_bits_est(levels, 4);
        int32_t cts[16], lts[16], deq_ts[16], rq_ts[16];
        fwd_transform_skip(res.data(), f.bit_depth, cts);
        bool cbf_ts = quantize_inter(cts, 2, qp, f.bit_depth, lts);
        if (cbf_ts && s->sdh)
          sdh_adjust(lts, cts, 2, qp, f.bit_depth, 0);
        if (cbf_ts) {
          dequantize(lts, 2, qp, f.bit_depth, deq_ts);
          inv_transform_skip(deq_ts, f.bit_depth, rq_ts);
        } else {
          std::memset(rq_ts, 0, sizeof(rq_ts));
        }
        double cost_ts = (double)sse_blk(res.data(), rq_ts, 4)
                         + lam * (double)ts_bits_est(lts, 4);
        if (cost_ts < cost_dct) {
          any = cbf_ts;
          std::memcpy(levels, lts, sizeof(lts));
          std::memcpy(rq.data(), rq_ts, sizeof(rq_ts));
          *ts_out = cbf_ts ? 1 : 0;
        } else {
          *ts_out = 0;
        }
      } else if (ts_out) {
        *ts_out = 0;
      }
    }
    *cbf = any;
    // reconstruct into the CU-local buffer (stride pw) + accumulate cost
    for (int yy = 0; yy < bs; yy++)
      for (int xx = 0; xx < bs; xx++) {
        int32_t v = pred[(oy + yy) * pw + (ox + xx)] +
                    (any ? rq[yy * bs + xx] : 0);
        v = clampi(v, 0, maxv);
        rec[(oy + yy) * pw + (ox + xx)] = v;
        int32_t d = (int32_t)src[(by + yy) * sw + (bx + xx)] - v;
        *sse_acc += (int64_t)d * d;
      }
    *bits_acc += ts_bits_est(levels, bs);
  };

  auto run_variant = [&](bool split, std::vector<int32_t> &vy,
                         std::vector<int32_t> &vcb,
                         std::vector<int32_t> &vcr, int32_t *ry,
                         int32_t *rcb, int32_t *rcr, bool cy[4],
                         bool ccb[4], bool ccr[4], int tscb[4],
                         int tscr[4], int64_t *sse_t, int64_t *bits_t) {
    int nt = split ? 4 : 1;
    int t_lg = split ? lg - 1 : lg;
    int t_n = 1 << t_lg;
    vy.assign(nt * t_n * t_n, 0);
    vcb.assign(nt * (t_n / 2) * (t_n / 2), 0);
    vcr.assign(nt * (t_n / 2) * (t_n / 2), 0);
    *sse_t = 0;
    *bits_t = 0;
    for (int ti = 0; ti < nt; ti++) {
      do_tb(nt, t_lg, 0, ti, vy.data() + ti * t_n * t_n, &cy[ti], nullptr,
            ry, sse_t, bits_t);
      do_tb(nt, t_lg, 1, ti, vcb.data() + ti * (t_n / 2) * (t_n / 2),
            &ccb[ti], &tscb[ti], rcb, sse_t, bits_t);
      do_tb(nt, t_lg, 2, ti, vcr.data() + ti * (t_n / 2) * (t_n / 2),
            &ccr[ti], &tscr[ti], rcr, sse_t, bits_t);
    }
  };

  recu_y.assign(n * n, 0);
  recu_cb.assign(cn * cn, 0);
  recu_cr.assign(cn * cn, 0);
  int64_t sse_u = 0, bits_u = 0;
  bool tu_split = false;
  run_variant(forced, lv_y, lv_cb, lv_cr, recu_y.data(), recu_cb.data(),
              recu_cr.data(), cbf_y, cbf_cb, cbf_cr, ts_cb_f, ts_cr_f,
              &sse_u, &bits_u);
  if (!forced && !s->lossless && s->rqt_enabled && lg > 3) {
    bool cys[4] = {}, ccbs[4] = {}, ccrs[4] = {};
    int tscbs[4] = {0, 0, 0, 0}, tscrs[4] = {0, 0, 0, 0};
    int64_t sse_s = 0, bits_s = 0;
    recs_y.assign(n * n, 0);
    recs_cb.assign(cn * cn, 0);
    recs_cr.assign(cn * cn, 0);
    run_variant(true, lvs_y, lvs_cb, lvs_cr, recs_y.data(),
                recs_cb.data(), recs_cr.data(), cys, ccbs, ccrs, tscbs,
                tscrs, &sse_s, &bits_s);
    double lam = 0.57 * std::pow(2.0, (s->qp_y - 12) / 3.0);
    double cost_u = (double)sse_u + lam * (double)(bits_u + 4);
    double cost_s = (double)sse_s + lam * (double)(bits_s + 13);
    if (cost_s < cost_u) {
      tu_split = true;
      lv_y.swap(lvs_y);
      lv_cb.swap(lvs_cb);
      lv_cr.swap(lvs_cr);
      recu_y.swap(recs_y);
      recu_cb.swap(recs_cb);
      recu_cr.swap(recs_cr);
      std::memcpy(cbf_y, cys, sizeof(cys));
      std::memcpy(cbf_cb, ccbs, sizeof(ccbs));
      std::memcpy(cbf_cr, ccrs, sizeof(ccrs));
      std::memcpy(ts_cb_f, tscbs, sizeof(tscbs));
      std::memcpy(ts_cr_f, tscrs, sizeof(tscrs));
    }
  }
  int n_tus = (forced || tu_split) ? 4 : 1;
  int tlg = (forced || tu_split) ? lg - 1 : lg;
  int tn = 1 << tlg;
  int half = n >> 1;
  // blit the chosen reconstruction into the frame planes
  for (int yy = 0; yy < n; yy++)
    std::memcpy(f.plane(0) + (y + yy) * w + x, recu_y.data() + yy * n,
                sizeof(int32_t) * n);
  for (int yy = 0; yy < cn; yy++) {
    std::memcpy(f.plane(1) + ((y >> 1) + yy) * (w / 2) + (x >> 1),
                recu_cb.data() + yy * cn, sizeof(int32_t) * cn);
    std::memcpy(f.plane(2) + ((y >> 1) + yy) * (w / 2) + (x >> 1),
                recu_cr.data() + yy * cn, sizeof(int32_t) * cn);
  }
  bool cbf_any = false, cbf_y_any = false;
  for (int ti = 0; ti < n_tus; ti++) {
    cbf_any |= cbf_y[ti] | cbf_cb[ti] | cbf_cr[ti];
    cbf_y_any |= cbf_y[ti];
  }

  // ---- store levels + cbf at TU origins --------------------------------
  Stored &st = *s->st;
  for (int ti = 0; ti < n_tus; ti++) {
    int tx = n_tus == 1 ? x : x + (ti & 1) * half;
    int ty = n_tus == 1 ? y : y + (ti >> 1) * half;
    st.store_block(st.lv_y, f.coded_w, tx, ty, tn,
                   lv_y.data() + ti * tn * tn);
    st.store_block(st.lv_cb, f.coded_w / 2, tx >> 1, ty >> 1, tn / 2,
                   lv_cb.data() + ti * (tn / 2) * (tn / 2));
    st.store_block(st.lv_cr, f.coded_w / 2, tx >> 1, ty >> 1, tn / 2,
                   lv_cr.data() + ti * (tn / 2) * (tn / 2));
    st.set_cbf(st.cbf_y, tx, ty, tn, cbf_y[ti]);
    st.set_cbf(st.cbf_cb, tx, ty, tn, cbf_cb[ti]);
    st.set_cbf(st.cbf_cr, tx, ty, tn, cbf_cr[ti]);
    if (tlg - 1 == 2) {
      int tg8 = (ty >> 3) * st.gw8 + (tx >> 3);
      st.ts_cb[tg8] = (uint8_t)ts_cb_f[ti];
      st.ts_cr[tg8] = (uint8_t)ts_cr_f[ti];
    }
  }
  for (int gy2 = y >> 3; gy2 < (y + n) >> 3; gy2++)
    for (int gx2 = x >> 3; gx2 < (x + n) >> 3; gx2++)
      st.tusplit[gy2 * st.gw8 + gx2] = tu_split ? 1 : 0;

  // ---- merge/AMVP decision (mirror of the Python commit) ---------------
  store_inter_syntax(s, x, y, lg, depth, m, cbf_any, cbf_y_any);
  // per-TU luma cbf for deblock BS (spec 8.7.2.4: the ADJACENT TB's cbf,
  // not the CU's) — mirror of spec/ctu.py apply_tu_cbf
  if (n_tus == 4)
    for (int ti = 0; ti < 4; ti++) {
      int tx = x + (ti & 1) * half, ty = y + (ti >> 1) * half;
      uint8_t cv = cbf_y[ti] ? 1 : 0;
      for (int gy2 = ty >> 2; gy2 < (ty + half) >> 2; gy2++)
        for (int gx2 = tx >> 2; gx2 < (tx + half) >> 2; gx2++)
          f.gcbf[gy2 * f.gw + gx2] = cv;
    }
}

// Merge/AMVP syntax decisions + motion-field bookkeeping for one inter CU
// (the non-pixel tail of commit_inter_cu) — shared with the entropy-only
// path, where levels/recon were already committed ON DEVICE and only the
// syntax derivation must replay in decode order.
void store_inter_syntax(SliceEnc *s, int x, int y, int lg, int depth,
                        const MotionCu &m, bool cbf_any, bool cbf_y_any) {
  Frame &f = *s->f;
  Stored &st = *s->st;
  int n = 1 << lg;
  static const bool dbg = std::getenv("FASTHEVC_DBG_INTER") != nullptr;
  if (dbg)
    fprintf(stderr, "SIS xy=%d,%d n=%d dir=%d mv0=%d,%d mv1=%d,%d cbf=%d/%d\n",
            x, y, n, m.dir, m.mv0x, m.mv0y, m.mv1x, m.mv1y,
            (int)cbf_any, (int)cbf_y_any);
  MotionCu cands[5];
  merge_list(s, x, y, n, cands);
  int merge_idx = -1;
  for (int i = 0; i < 5 && merge_idx < 0; i++)
    if (cands[i] == m) merge_idx = i;
  bool merge = merge_idx >= 0;
  bool skip = merge && !cbf_any;
  int g8 = (y >> 3) * st.gw8 + (x >> 3);
  st.skip[g8] = skip;
  st.merge_flag[g8] = merge;
  st.merge_idx[g8] = (int8_t)(merge ? merge_idx : 0);
  st.rqt_root[g8] = cbf_any;
  if (!merge) {
    if (m.dir & 1) {
      int amvp[2][2];
      amvp_list(s, x, y, n, 0, m.r0 < 0 ? 0 : m.r0, amvp);
      int c0 = std::abs(m.mv0x - amvp[0][0]) + std::abs(m.mv0y - amvp[0][1]);
      int c1 = std::abs(m.mv0x - amvp[1][0]) + std::abs(m.mv0y - amvp[1][1]);
      int mvp = c0 <= c1 ? 0 : 1;
      st.mvp0[g8] = (int8_t)mvp;
      st.ref0[g8] = (int8_t)(m.r0 < 0 ? 0 : m.r0);
      st.mvd0x[g8] = (int16_t)(m.mv0x - amvp[mvp][0]);
      st.mvd0y[g8] = (int16_t)(m.mv0y - amvp[mvp][1]);
    }
    if (m.dir & 2) {
      int amvp[2][2];
      amvp_list(s, x, y, n, 1, m.r1 < 0 ? 0 : m.r1, amvp);
      int c0 = std::abs(m.mv1x - amvp[0][0]) + std::abs(m.mv1y - amvp[0][1]);
      int c1 = std::abs(m.mv1x - amvp[1][0]) + std::abs(m.mv1y - amvp[1][1]);
      int mvp = c0 <= c1 ? 0 : 1;
      st.mvp1[g8] = (int8_t)mvp;
      st.ref1[g8] = (int8_t)(m.r1 < 0 ? 0 : m.r1);
      st.mvd1x[g8] = (int16_t)(m.mv1x - amvp[mvp][0]);
      st.mvd1y[g8] = (int16_t)(m.mv1y - amvp[mvp][1]);
    }
  }
  if (skip) {
    for (int gy = y >> 2; gy < (y + n) >> 2; gy++)
      for (int gx = x >> 2; gx < (x + n) >> 2; gx++) {
        f.gdepth[gy * f.gw + gx] = (int8_t)depth;
        f.gmode[gy * f.gw + gx] = -1;
        f.gcoded[gy * f.gw + gx] = 1;
      }
    set_motion_cu(s, x, y, n, m, true, false);
    return;
  }
  for (int gy = y >> 2; gy < (y + n) >> 2; gy++)
    for (int gx = x >> 2; gx < (x + n) >> 2; gx++) {
      f.gdepth[gy * f.gw + gx] = (int8_t)depth;
      f.gmode[gy * f.gw + gx] = -1;
      f.gcoded[gy * f.gw + gx] = 1;
    }
  set_motion_cu(s, x, y, n, m, false, cbf_y_any);
}

// Emit the syntax of one committed inter CU (phase 2)
void emit_inter_cu(SliceEnc *s, int x, int y, int lg, int depth,
                   const MotionCu &m) {
  Frame &f = *s->f;
  Encoder *e = s->e;
  Stored &st = *s->st;
  int n = 1 << lg;
  int g8 = (y >> 3) * st.gw8 + (x >> 3);
  bool skip = st.skip[g8];
  bool merge = st.merge_flag[g8];
  e->encode_bin(s->off_skip + skip_ctx(s, x, y), skip);
  if (skip) {
    encode_merge_idx_cpp(s, st.merge_idx[g8]);
    return;
  }
  if (s->bypass_enabled) e->encode_bin(s->off_bypassflag, s->lossless);
  e->encode_bin(s->off_pred_mode, 0);  // inter
  e->encode_bin(s->off_part, 1);       // 2Nx2N
  e->encode_bin(s->off_merge_flag, merge);
  if (merge) {
    encode_merge_idx_cpp(s, st.merge_idx[g8]);
  } else {
    if (s->slice_type == 0) {
      e->encode_bin(s->off_inter_idc + depth, m.dir == 3 ? 1 : 0);
      if (m.dir != 3)
        e->encode_bin(s->off_inter_idc + 4, m.dir == 2 ? 1 : 0);
    }
    if (m.dir & 1) {
      encode_ref_idx_cpp(s, st.ref0[g8], s->n_l0);
      encode_mvd_cpp(s, st.mvd0x[g8], st.mvd0y[g8]);
      e->encode_bin(s->off_mvp, st.mvp0[g8]);
    }
    if (m.dir & 2) {
      encode_ref_idx_cpp(s, st.ref1[g8], s->n_l1);
      encode_mvd_cpp(s, st.mvd1x[g8], st.mvd1y[g8]);
      e->encode_bin(s->off_mvp, st.mvp1[g8]);
    }
  }
  bool cbf_any = st.rqt_root[g8];
  if (!merge) e->encode_bin(s->off_rqt_root, cbf_any);
  if (cbf_any || merge) {
    bool forced = lg > s->log2_max_tu;
    bool tu_split = st.tusplit[g8] != 0;
    // split_transform_flag (spec 7.3.8.8): mirror of the Python
    // _encode_transform_tree presence rule for inter CUs
    if (s->rqt_enabled && lg > 2 && lg <= s->log2_max_tu)
      e->encode_bin(s->off_split_tu + (5 - lg), tu_split ? 1 : 0);
    int n_tus = (forced || tu_split) ? 4 : 1;
    int tlg = (forced || tu_split) ? lg - 1 : lg;
    int tn = 1 << tlg;
    int half = n >> 1;
    bool cbf_y[4], cbf_cb[4], cbf_cr[4];
    for (int ti = 0; ti < n_tus; ti++) {
      int tx = n_tus == 1 ? x : x + (ti & 1) * half;
      int ty = n_tus == 1 ? y : y + (ti >> 1) * half;
      int tg = (ty >> 3) * st.gw8 + (tx >> 3);
      cbf_y[ti] = st.cbf_y[tg];
      cbf_cb[ti] = st.cbf_cb[tg];
      cbf_cr[ti] = st.cbf_cr[tg];
    }
    bool cb0 = false, cr0 = false;
    for (int ti = 0; ti < n_tus; ti++) {
      cb0 |= cbf_cb[ti];
      cr0 |= cbf_cr[ti];
    }
    e->encode_bin(s->off_cbf_chroma + 0, cb0);
    e->encode_bin(s->off_cbf_chroma + 0, cr0);
    static thread_local std::vector<int32_t> lv;
    lv.resize(32 * 32);
    for (int ti = 0; ti < n_tus; ti++) {
      int tx = n_tus == 1 ? x : x + (ti & 1) * half;
      int ty = n_tus == 1 ? y : y + (ti >> 1) * half;
      int trafo_depth = n_tus == 1 ? 0 : 1;
      if (n_tus > 1) {
        if (cb0) e->encode_bin(s->off_cbf_chroma + 1, cbf_cb[ti]);
        if (cr0) e->encode_bin(s->off_cbf_chroma + 1, cbf_cr[ti]);
      }
      bool present = trafo_depth != 0 || cbf_cb[ti] || cbf_cr[ti];
      if (present)
        e->encode_bin(s->off_cbf_luma + (trafo_depth == 0 ? 1 : 0),
                      cbf_y[ti]);
      bool ts_ok = s->ts_enabled && !s->lossless;
      int tg8 = (ty >> 3) * st.gw8 + (tx >> 3);
      if (cbf_y[ti]) {
        st.load_block(st.lv_y, f.coded_w, tx, ty, tn, lv.data());
        encode_residual(e, lv.data(), tlg, 0, 0, s->sdh);
      }
      if (cbf_cb[ti]) {
        if (ts_ok && tlg - 1 == 2)
          e->encode_bin(s->off_ts + 1, st.ts_cb[tg8]);
        st.load_block(st.lv_cb, f.coded_w / 2, tx >> 1, ty >> 1, tn / 2,
                      lv.data());
        encode_residual(e, lv.data(), tlg - 1, 1, 0, s->sdh);
      }
      if (cbf_cr[ti]) {
        if (ts_ok && tlg - 1 == 2)
          e->encode_bin(s->off_ts + 1, st.ts_cr[tg8]);
        st.load_block(st.lv_cr, f.coded_w / 2, tx >> 1, ty >> 1, tn / 2,
                      lv.data());
        encode_residual(e, lv.data(), tlg - 1, 2, 0, s->sdh);
      }
    }
  }
}

// Commit one intra CU (phase 1): predict + TQ + recon into the store
void commit_intra_cu(SliceEnc *s, int x, int y, int lg, int depth) {
  Frame &f = *s->f;
  Stored &st = *s->st;
  int mode = s->mode_map[(y >> 3) * s->dm_w + (x >> 3)];
  int n_tus = (lg > s->log2_max_tu) ? 4 : 1;
  int tlg = (lg > s->log2_max_tu) ? lg - 1 : lg;
  int tn = 1 << tlg;
  int32_t lv[32 * 32];
  int half = 1 << (lg - 1);
  for (int i = 0; i < n_tus; i++) {
    int tx = n_tus == 1 ? x : x + (i & 1) * half;
    int ty = n_tus == 1 ? y : y + (i >> 1) * half;
    int g8 = (ty >> 3) * st.gw8 + (tx >> 3);
    int ts = 0;
    bool cy = commit_tb(s, 0, tx, ty, tlg, mode, lv);
    st.store_block(st.lv_y, f.coded_w, tx, ty, tn, lv);
    st.set_cbf(st.cbf_y, tx, ty, tn, cy);
    bool ccb = commit_tb(s, 1, tx >> 1, ty >> 1, tlg - 1, mode, lv, &ts);
    st.store_block(st.lv_cb, f.coded_w / 2, tx >> 1, ty >> 1, tn / 2, lv);
    st.set_cbf(st.cbf_cb, tx, ty, tn, ccb);
    if (tlg - 1 == 2) st.ts_cb[g8] = (uint8_t)ts;
    bool ccr = commit_tb(s, 2, tx >> 1, ty >> 1, tlg - 1, mode, lv, &ts);
    st.store_block(st.lv_cr, f.coded_w / 2, tx >> 1, ty >> 1, tn / 2, lv);
    st.set_cbf(st.cbf_cr, tx, ty, tn, ccr);
    if (tlg - 1 == 2) st.ts_cr[g8] = (uint8_t)ts;
  }
  set_cu(s, x, y, 1 << lg, depth, mode);
  set_intra_motion(s, x, y, 1 << lg, false);
}

// Emit the syntax of one committed intra CU (phase 2)
void emit_intra_cu(SliceEnc *s, int x, int y, int lg, int depth) {
  Frame &f = *s->f;
  Encoder *e = s->e;
  Stored &st = *s->st;
  int mode = s->mode_map[(y >> 3) * s->dm_w + (x >> 3)];
  if (s->bypass_enabled) e->encode_bin(s->off_bypassflag, s->lossless);
  if (s->slice_type != 2) e->encode_bin(s->off_pred_mode, 1);  // intra
  if (lg == s->log2_min_cu) e->encode_bin(s->off_part, 1);  // 2Nx2N
  int cands[3];
  mpm_candidates(s, x, y, cands);
  int mpm_idx = -1;
  for (int i = 0; i < 3; i++)
    if (cands[i] == mode) mpm_idx = i;
  if (mpm_idx >= 0) {
    e->encode_bin(s->off_prev_intra, 1);
    e->encode_bypass(mpm_idx == 0 ? 0 : 1);
    if (mpm_idx > 0) e->encode_bypass(mpm_idx - 1);
  } else {
    e->encode_bin(s->off_prev_intra, 0);
    int rem = mode;
    // subtract candidates smaller than mode
    for (int i = 0; i < 3; i++)
      if (mode > cands[i]) rem--;
    e->encode_bypass_bits(rem, 5);
  }
  e->encode_bin(s->off_chroma_mode, 0);  // DM

  int n_tus = (lg > s->log2_max_tu) ? 4 : 1;
  int tlg = (lg > s->log2_max_tu) ? lg - 1 : lg;
  int tn = 1 << tlg;
  int half = 1 << (lg - 1);
  bool cbf_y[4], cbf_cb[4], cbf_cr[4];
  for (int i = 0; i < n_tus; i++) {
    int tx = n_tus == 1 ? x : x + (i & 1) * half;
    int ty = n_tus == 1 ? y : y + (i >> 1) * half;
    int tg = (ty >> 3) * st.gw8 + (tx >> 3);
    cbf_y[i] = st.cbf_y[tg];
    cbf_cb[i] = st.cbf_cb[tg];
    cbf_cr[i] = st.cbf_cr[tg];
  }
  bool cb0 = false, cr0 = false;
  for (int i = 0; i < n_tus; i++) {
    cb0 |= cbf_cb[i];
    cr0 |= cbf_cr[i];
  }
  e->encode_bin(s->off_cbf_chroma + 0, cb0);
  e->encode_bin(s->off_cbf_chroma + 0, cr0);
  static thread_local std::vector<int32_t> lv;
  lv.resize(32 * 32);
  for (int i = 0; i < n_tus; i++) {
    int tx = n_tus == 1 ? x : x + (i & 1) * half;
    int ty = n_tus == 1 ? y : y + (i >> 1) * half;
    int trafo_depth = n_tus == 1 ? 0 : 1;
    if (n_tus > 1) {
      if (cb0) e->encode_bin(s->off_cbf_chroma + 1, cbf_cb[i]);
      if (cr0) e->encode_bin(s->off_cbf_chroma + 1, cbf_cr[i]);
    }
    e->encode_bin(s->off_cbf_luma + (trafo_depth == 0 ? 1 : 0), cbf_y[i]);
    bool ts_ok = s->ts_enabled && !s->lossless;
    int tg8 = (ty >> 3) * st.gw8 + (tx >> 3);
    if (cbf_y[i]) {
      st.load_block(st.lv_y, f.coded_w, tx, ty, tn, lv.data());
      encode_residual(e, lv.data(), tlg, 0, scan_for(tlg, 0, mode), s->sdh);
    }
    if (cbf_cb[i]) {
      if (ts_ok && tlg - 1 == 2)
        e->encode_bin(s->off_ts + 1, st.ts_cb[tg8]);
      st.load_block(st.lv_cb, f.coded_w / 2, tx >> 1, ty >> 1, tn / 2,
                    lv.data());
      encode_residual(e, lv.data(), tlg - 1, 1, scan_for(tlg - 1, 1, mode), s->sdh);
    }
    if (cbf_cr[i]) {
      if (ts_ok && tlg - 1 == 2)
        e->encode_bin(s->off_ts + 1, st.ts_cr[tg8]);
      st.load_block(st.lv_cr, f.coded_w / 2, tx >> 1, ty >> 1, tn / 2,
                    lv.data());
      encode_residual(e, lv.data(), tlg - 1, 2, scan_for(tlg - 1, 2, mode), s->sdh);
    }
  }
}

MotionCu cu_motion_from_maps(SliceEnc *s, int x, int y, int *dir_out) {
  int g8 = (y >> 3) * s->dm_w + (x >> 3);
  int dir = s->dir_map ? s->dir_map[g8] : 0;
  *dir_out = dir;
  MotionCu m;
  if (dir > 0) {
    m.dir = dir;
    m.mv0x = s->mv_map[g8 * 4 + 0];
    m.mv0y = s->mv_map[g8 * 4 + 1];
    m.mv1x = s->mv_map[g8 * 4 + 2];
    m.mv1y = s->mv_map[g8 * 4 + 3];
    m.r0 = (dir & 1) ? (s->ref_map ? s->ref_map[g8 * 2 + 0] : 0) : -1;
    m.r1 = (dir & 2) ? (s->ref_map ? s->ref_map[g8 * 2 + 1] : 0) : -1;
    m.normalize();
  }
  return m;
}

// Phase-1 quadtree walk: commit only, no bits
void commit_cq(SliceEnc *s, int x, int y, int lg, int depth) {
  Frame &f = *s->f;
  int size = 1 << lg;
  bool inside = (x + size <= f.coded_w) && (y + size <= f.coded_h);
  bool split = !inside || (lg > s->log2_min_cu &&
                           s->depth_map[(y >> 3) * s->dm_w + (x >> 3)] >
                               depth);
  if (split) {
    int half = size >> 1;
    for (int i = 0; i < 4; i++) {
      int cx = x + (i & 1) * half, cy = y + (i >> 1) * half;
      if (cx < f.coded_w && cy < f.coded_h)
        commit_cq(s, cx, cy, lg - 1, depth + 1);
    }
    return;
  }
  if (s->slice_type != 2) {
    int dir;
    MotionCu m = cu_motion_from_maps(s, x, y, &dir);
    if (dir > 0) {
      commit_inter_cu(s, x, y, lg, depth, m);
      return;
    }
  }
  commit_intra_cu(s, x, y, lg, depth);
}

// Phase-2 quadtree walk: bits only
void emit_cq(SliceEnc *s, int x, int y, int lg, int depth) {
  Frame &f = *s->f;
  Encoder *e = s->e;
  int size = 1 << lg;
  bool inside = (x + size <= f.coded_w) && (y + size <= f.coded_h);
  bool split;
  if (inside && lg > s->log2_min_cu) {
    int d = s->depth_map[(y >> 3) * s->dm_w + (x >> 3)];
    split = d > depth;
    e->encode_bin(s->off_split + split_ctx(s, x, y, depth), split);
  } else {
    split = !inside;
  }
  if (split) {
    int half = size >> 1;
    for (int i = 0; i < 4; i++) {
      int cx = x + (i & 1) * half, cy = y + (i >> 1) * half;
      if (cx < f.coded_w && cy < f.coded_h)
        emit_cq(s, cx, cy, lg - 1, depth + 1);
    }
    return;
  }
  if (s->slice_type != 2) {
    int dir;
    MotionCu m = cu_motion_from_maps(s, x, y, &dir);
    if (dir > 0) {
      emit_inter_cu(s, x, y, lg, depth, m);
      return;
    }
    e->encode_bin(s->off_skip + skip_ctx(s, x, y), 0);
  }
  emit_intra_cu(s, x, y, lg, depth);
}


// ---- deblocking filter (spec 8.7.2) ---------------------------------------
// Mirror of spec/deblock.py (the Python oracle), byte-exact — enforced by
// tests/test_deblock.py::test_cpp_deblock_matches_oracle. Sequential
// in-place filtering is equivalent to the oracle's vectorized pass because
// same-direction segments never overlap (8-pel edge spacing, <=4-pel reach).

const int32_t kBetaTab[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
    13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
    44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
const int32_t kTcTab[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11,
    13, 14, 16, 18, 20, 22, 24};

struct DeblockCtx {
  int w, h, gw, gh;        // luma dims + 8x8 granule grid
  int gw4, gh4;            // 4x4 granule grid (motion field)
  int bit_depth, maxv;
  const int8_t *depth;     // [gh][gw]
  int log2_ctu, log2_max_tu;
  bool has_motion;
  const int32_t *mf_mv;    // [gh4][gw4][2][2]
  const int32_t *mf_ref;   // [gh4][gw4][2]
  const uint8_t *mf_cbf;   // [gh4][gw4]
  const uint8_t *tusplit;  // [gh][gw] (8x8 grid), nullable: depth-1 RQT
};

// boundary strength of one 4-sample segment (spec 8.7.2.4); y4 = along-edge
// 4x4 index, g8 = across-edge 8-grid index (edge at luma coord g8*8)
int seg_bs(const DeblockCtx &c, bool vert, int y4, int g8) {
  if (!c.has_motion) return 2;
  int py, px, qy, qx;
  if (vert) { py = y4; px = g8 * 2 - 1; qy = y4; qx = g8 * 2; }
  else      { py = g8 * 2 - 1; px = y4; qy = g8 * 2; qx = y4; }
  int p = py * c.gw4 + px, q = qy * c.gw4 + qx;
  bool intra_p = c.mf_ref[p * 2] < 0 && c.mf_ref[p * 2 + 1] < 0;
  bool intra_q = c.mf_ref[q * 2] < 0 && c.mf_ref[q * 2 + 1] < 0;
  if (intra_p || intra_q) return 2;
  bool cbf = c.mf_cbf[p] || c.mf_cbf[q];
  bool dref = c.mf_ref[p * 2] != c.mf_ref[q * 2] ||
              c.mf_ref[p * 2 + 1] != c.mf_ref[q * 2 + 1];
  bool dmv = false;
  for (int k = 0; k < 4; k++) {
    int dv = c.mf_mv[p * 4 + k] - c.mf_mv[q * 4 + k];
    if (dv >= 4 || dv <= -4) dmv = true;
  }
  return (cbf || dref || dmv) ? 1 : 0;
}

// does the 8x8 granule (gy,gx) start a deblockable edge in direction dir?
bool has_edge(const DeblockCtx &c, bool vert, int gy, int gx) {
  if (vert ? gx == 0 : gy == 0) return false;
  int size = (1 << c.log2_ctu) >> c.depth[gy * c.gw + gx];
  int coord = (vert ? gx : gy) * 8;
  if (coord % size == 0) return true;
  int max_tu = 1 << c.log2_max_tu;
  int tu = size < max_tu ? size : max_tu;
  if ((size > max_tu) && (coord % tu == 0)) return true;
  // depth-1 RQT: the split CU's interior half-offset TU edge (8.7.1)
  if (c.tusplit && c.tusplit[gy * c.gw + gx]) {
    int hf = size >> 1;
    if (hf >= 8 && coord % hf == 0) return true;
  }
  return false;
}

// filter one 4-line luma segment; vert: lines = rows sy..sy+3, edge col sx
void luma_seg(int32_t *pl, int stride, bool vert, int sy, int sx, int beta,
              int tc, int maxv) {
  int32_t P[4][8];  // [line][p3 p2 p1 p0 q0 q1 q2 q3]
  for (int i = 0; i < 4; i++)
    for (int k = 0; k < 8; k++)
      P[i][k] = vert ? pl[(sy + i) * stride + sx - 4 + k]
                     : pl[(sy - 4 + k) * stride + sx + i];
  int dp[4], dq[4];
  for (int i = 0; i < 4; i++) {
    dp[i] = std::abs(P[i][1] - 2 * P[i][2] + P[i][3]);
    dq[i] = std::abs(P[i][6] - 2 * P[i][5] + P[i][4]);
  }
  int d = dp[0] + dq[0] + dp[3] + dq[3];
  if (d >= beta) return;
  auto strong_line = [&](int i) {
    return 2 * (dp[i] + dq[i]) < (beta >> 2) &&
           std::abs(P[i][0] - P[i][3]) + std::abs(P[i][4] - P[i][7]) <
               (beta >> 3) &&
           std::abs(P[i][3] - P[i][4]) < ((5 * tc + 1) >> 1);
  };
  bool strong = strong_line(0) && strong_line(3);
  int32_t O[4][8];
  std::memcpy(O, P, sizeof(P));
  auto clip3 = [](int v, int lo, int hi) {
    return v < lo ? lo : v > hi ? hi : v;
  };
  if (strong) {
    for (int i = 0; i < 4; i++) {
      int p3 = P[i][0], p2 = P[i][1], p1 = P[i][2], p0 = P[i][3];
      int q0 = P[i][4], q1 = P[i][5], q2 = P[i][6], q3 = P[i][7];
      O[i][1] = clip3(clip3((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                            p2 - 2 * tc, p2 + 2 * tc), 0, maxv);
      O[i][2] = clip3(clip3((p2 + p1 + p0 + q0 + 2) >> 2,
                            p1 - 2 * tc, p1 + 2 * tc), 0, maxv);
      O[i][3] = clip3(clip3((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                            p0 - 2 * tc, p0 + 2 * tc), 0, maxv);
      O[i][4] = clip3(clip3((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                            q0 - 2 * tc, q0 + 2 * tc), 0, maxv);
      O[i][5] = clip3(clip3((q2 + q1 + q0 + p0 + 2) >> 2,
                            q1 - 2 * tc, q1 + 2 * tc), 0, maxv);
      O[i][6] = clip3(clip3((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
                            q2 - 2 * tc, q2 + 2 * tc), 0, maxv);
    }
  } else {
    int side_thresh = (beta + (beta >> 1)) >> 3;
    bool dEp = (dp[0] + dp[3]) < side_thresh;
    bool dEq = (dq[0] + dq[3]) < side_thresh;
    int tc2 = tc >> 1;
    for (int i = 0; i < 4; i++) {
      int p2 = P[i][1], p1 = P[i][2], p0 = P[i][3];
      int q0 = P[i][4], q1 = P[i][5], q2 = P[i][6];
      int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (std::abs(delta) >= 10 * tc) continue;
      int dlt = clip3(delta, -tc, tc);
      O[i][3] = clip3(p0 + dlt, 0, maxv);
      O[i][4] = clip3(q0 - dlt, 0, maxv);
      if (dEp) {
        int dp1 = clip3((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tc2, tc2);
        O[i][2] = clip3(p1 + dp1, 0, maxv);
      }
      if (dEq) {
        int dq1 = clip3((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tc2, tc2);
        O[i][5] = clip3(q1 + dq1, 0, maxv);
      }
    }
  }
  for (int i = 0; i < 4; i++)
    for (int k = 0; k < 8; k++) {
      if (vert) pl[(sy + i) * stride + sx - 4 + k] = O[i][k];
      else pl[(sy - 4 + k) * stride + sx + i] = O[i][k];
    }
}

// filter one 4-line chroma segment at (sy, sx) in chroma coords
void chroma_seg(int32_t *pl, int stride, bool vert, int sy, int sx, int tc,
                int maxv) {
  auto clip3 = [](int v, int lo, int hi) {
    return v < lo ? lo : v > hi ? hi : v;
  };
  for (int i = 0; i < 4; i++) {
    int32_t *p1, *p0, *q0, *q1;
    if (vert) {
      int32_t *row = pl + (sy + i) * stride;
      p1 = row + sx - 2; p0 = row + sx - 1; q0 = row + sx; q1 = row + sx + 1;
    } else {
      p1 = pl + (sy - 2) * stride + sx + i;
      p0 = pl + (sy - 1) * stride + sx + i;
      q0 = pl + sy * stride + sx + i;
      q1 = pl + (sy + 1) * stride + sx + i;
    }
    int delta = clip3(((*q0 - *p0) * 4 + *p1 - *q1 + 4) >> 3, -tc, tc);
    *p0 = clip3(*p0 + delta, 0, maxv);
    *q0 = clip3(*q0 - delta, 0, maxv);
  }
}

// one direction of the luma pass over a row range (threading granularity:
// segments of different granule rows never touch the same samples)
void luma_pass(const DeblockCtx &c, int32_t *y_pl, bool vert, int beta,
               int tc_base, int g_lo, int g_hi) {
  for (int gy = g_lo; gy < g_hi; gy++)
    for (int gx = 0; gx < c.gw; gx++) {
      if (!has_edge(c, vert, gy, gx)) continue;
      // two 4-line segments per 8x8 granule edge
      for (int half = 0; half < 2; half++) {
        int a4 = (vert ? gy : gx) * 2 + half;
        int g8 = vert ? gx : gy;
        int bs = seg_bs(c, vert, a4, g8);
        if (bs == 0) continue;
        int qi = tc_base + 2 * (bs - 1);
        int tc = kTcTab[qi < 0 ? 0 : qi > 53 ? 53 : qi];
        if (vert) luma_seg(y_pl, c.w, true, a4 * 4, g8 * 8, beta, tc, c.maxv);
        else luma_seg(y_pl, c.w, false, g8 * 8, a4 * 4, beta, tc, c.maxv);
      }
    }
}

void chroma_pass(const DeblockCtx &c, int32_t *pl, bool vert, int tc,
                 int g_lo, int g_hi) {
  for (int gy = g_lo; gy < g_hi; gy++)
    for (int gx = 0; gx < c.gw; gx++) {
      // chroma filters edges on the 16-luma grid only, BS==2 segments
      if ((vert ? gx : gy) % 2 != 0) continue;
      if (!has_edge(c, vert, gy, gx)) continue;
      int a4 = (vert ? gy : gx) * 2;  // first luma 4x4 unit of the segment
      int g8 = vert ? gx : gy;
      if (seg_bs(c, vert, a4, g8) != 2) continue;
      if (vert) chroma_seg(pl, c.w / 2, true, gy * 4, gx * 4, tc, c.maxv);
      else chroma_seg(pl, c.w / 2, false, gy * 4, gx * 4, tc, c.maxv);
    }
}

// ---- SAO (spec 8.7.3): estimation + application ---------------------------
// Mirror of spec/sao.py (estimate_ctb / estimate_ctb_given / apply_sao):
// estimation classifies within the CTB (conservative, affects parameter
// choice only); application classifies on the full pre-SAO plane (normative,
// matches the decoder).

const int kEoN[4][2][2] = {  // class -> ((dy0,dx0),(dy1,dx1))
    {{0, -1}, {0, 1}}, {{-1, 0}, {1, 0}}, {{-1, -1}, {1, 1}},
    {{1, -1}, {-1, 1}}};

inline int sgn(int v) { return v > 0 ? 1 : v < 0 ? -1 : 0; }

// Python round() = banker's rounding = nearbyint in the default FP mode
inline int sao_offset_for(long long cnt, long long sum) {
  if (cnt == 0) return 0;
  int o = (int)std::nearbyint((double)sum / (double)cnt);
  return o < -7 ? -7 : o > 7 ? 7 : o;
}

// Edge-offset stats for one class over a region (in-region neighbors only;
// region-boundary samples are category 0, exactly like the oracle's
// _edge_categories on the cropped CTB)
void sao_eo_stats(const int32_t *rec, int rstride, const uint8_t *src,
                  int sstride, int w, int h, int cls, long long cnt[5],
                  long long sum[5]) {
  int dy0 = kEoN[cls][0][0], dx0 = kEoN[cls][0][1];
  int dy1 = kEoN[cls][1][0], dx1 = kEoN[cls][1][1];
  int ty = std::max({0, -dy0, -dy1}), by = std::max({0, dy0, dy1});
  int lx = std::max({0, -dx0, -dx1}), rx = std::max({0, dx0, dx1});
  static const int remap[5] = {1, 2, 0, 3, 4};
  for (int yy = ty; yy < h - by; yy++)
    for (int xx = lx; xx < w - rx; xx++) {
      int c = rec[yy * rstride + xx];
      int raw = 2 + sgn(c - rec[(yy + dy0) * rstride + xx + dx0]) +
                sgn(c - rec[(yy + dy1) * rstride + xx + dx1]);
      int cat = remap[raw];
      if (cat) {
        cnt[cat]++;
        sum[cat] += (int)src[yy * sstride + xx] - c;
      }
    }
}

SaoP sao_estimate_ctb(const uint8_t *src, int sstride, const int32_t *rec,
                      int rstride, int w, int h, int bit_depth) {
  double best_g = 0.0;
  SaoP best;  // OFF
  for (int cls = 0; cls < 4; cls++) {
    long long cnt[5] = {0}, sum[5] = {0};
    sao_eo_stats(rec, rstride, src, sstride, w, h, cls, cnt, sum);
    int offs[4];
    for (int c = 1; c <= 4; c++) offs[c - 1] = sao_offset_for(cnt[c], sum[c]);
    offs[0] = std::max(0, offs[0]);
    offs[1] = std::max(0, offs[1]);
    offs[2] = std::min(0, offs[2]);
    offs[3] = std::min(0, offs[3]);
    double g = 0;
    for (int i = 0; i < 4; i++)
      g += 2.0 * offs[i] * sum[i + 1] - (double)offs[i] * offs[i] * cnt[i + 1];
    if (g > best_g) {
      best_g = g;
      best.type = 2;
      best.eo_class = cls;
      best.band_pos = 0;
      for (int i = 0; i < 4; i++) best.off[i] = offs[i];
    }
  }
  long long bcnt[32] = {0}, bsum[32] = {0};
  int shift = bit_depth - 5;
  for (int yy = 0; yy < h; yy++)
    for (int xx = 0; xx < w; xx++) {
      int b = rec[yy * rstride + xx] >> shift;
      bcnt[b]++;
      bsum[b] += (int)src[yy * sstride + xx] - rec[yy * rstride + xx];
    }
  int boffs[32];
  double bgain[32];
  for (int b = 0; b < 32; b++) {
    boffs[b] = sao_offset_for(bcnt[b], bsum[b]);
    bgain[b] = 2.0 * boffs[b] * bsum[b] - (double)boffs[b] * boffs[b] * bcnt[b];
  }
  int best_pos = 0;
  double best_run = -1e18;
  for (int pos = 0; pos < 29; pos++) {
    double g = bgain[pos] + bgain[pos + 1] + bgain[pos + 2] + bgain[pos + 3];
    if (g > best_run) {
      best_run = g;
      best_pos = pos;
    }
  }
  if (best_run > best_g) {
    best.type = 1;
    best.eo_class = 0;
    best.band_pos = best_pos;
    for (int i = 0; i < 4; i++) best.off[i] = boffs[best_pos + i];
  }
  return best;
}

// Cr shares Cb's type/eo_class (spec); offsets/band_pos re-estimated
SaoP sao_estimate_ctb_given(const uint8_t *src, int sstride,
                            const int32_t *rec, int rstride, int w, int h,
                            int type, int eo_class, int bit_depth) {
  SaoP p;
  p.type = type;
  p.eo_class = eo_class;
  if (type == 0) return p;
  if (type == 2) {
    long long cnt[5] = {0}, sum[5] = {0};
    sao_eo_stats(rec, rstride, src, sstride, w, h, eo_class, cnt, sum);
    for (int c = 1; c <= 4; c++) p.off[c - 1] = sao_offset_for(cnt[c], sum[c]);
    p.off[0] = std::max(0, p.off[0]);
    p.off[1] = std::max(0, p.off[1]);
    p.off[2] = std::min(0, p.off[2]);
    p.off[3] = std::min(0, p.off[3]);
    return p;
  }
  long long bcnt[32] = {0}, bsum[32] = {0};
  int shift = bit_depth - 5;
  for (int yy = 0; yy < h; yy++)
    for (int xx = 0; xx < w; xx++) {
      int b = rec[yy * rstride + xx] >> shift;
      bcnt[b]++;
      bsum[b] += (int)src[yy * sstride + xx] - rec[yy * rstride + xx];
    }
  int boffs[32];
  double bgain[32];
  for (int b = 0; b < 32; b++) {
    boffs[b] = sao_offset_for(bcnt[b], bsum[b]);
    bgain[b] = 2.0 * boffs[b] * bsum[b] - (double)boffs[b] * boffs[b] * bcnt[b];
  }
  int best_pos = 0;
  double best_run = -1e18;
  for (int pos = 0; pos < 29; pos++) {
    double g = bgain[pos] + bgain[pos + 1] + bgain[pos + 2] + bgain[pos + 3];
    if (g > best_run) {
      best_run = g;
      best_pos = pos;
    }
  }
  p.band_pos = best_pos;
  for (int i = 0; i < 4; i++) p.off[i] = boffs[best_pos + i];
  return p;
}

// Apply SAO to one plane in place. Classification reads the pre-SAO copy
// (full-plane neighbors; plane-boundary samples category 0) — normative.
void sao_apply_plane(int32_t *plane, int w, int h, int ctb,
                     const SaoP *params, int nx, int ny, int bit_depth) {
  std::vector<int32_t> pre(plane, plane + (size_t)w * h);
  int maxv = (1 << bit_depth) - 1;
  int shift = bit_depth - 5;
  for (int by = 0; by < ny; by++)
    for (int bx = 0; bx < nx; bx++) {
      const SaoP &p = params[by * nx + bx];
      if (p.type == 0) continue;
      int y0 = by * ctb, y1 = std::min((by + 1) * ctb, h);
      int x0 = bx * ctb, x1 = std::min((bx + 1) * ctb, w);
      if (p.type == 2) {
        int dy0 = kEoN[p.eo_class][0][0], dx0 = kEoN[p.eo_class][0][1];
        int dy1 = kEoN[p.eo_class][1][0], dx1 = kEoN[p.eo_class][1][1];
        static const int remap[5] = {1, 2, 0, 3, 4};
        int lut[5] = {0, p.off[0], p.off[1], p.off[2], p.off[3]};
        for (int yy = y0; yy < y1; yy++)
          for (int xx = x0; xx < x1; xx++) {
            int ny0 = yy + dy0, nx0 = xx + dx0;
            int ny1 = yy + dy1, nx1 = xx + dx1;
            if (ny0 < 0 || ny1 < 0 || nx0 < 0 || nx1 < 0 || ny0 >= h ||
                ny1 >= h || nx0 >= w || nx1 >= w)
              continue;  // plane-boundary samples: category 0
            int c = pre[yy * w + xx];
            int raw = 2 + sgn(c - pre[ny0 * w + nx0]) +
                      sgn(c - pre[ny1 * w + nx1]);
            int v = c + lut[remap[raw]];
            plane[yy * w + xx] = v < 0 ? 0 : v > maxv ? maxv : v;
          }
      } else {
        int lut[32] = {0};
        for (int i = 0; i < 4; i++) lut[(p.band_pos + i) & 31] = p.off[i];
        for (int yy = y0; yy < y1; yy++)
          for (int xx = x0; xx < x1; xx++) {
            int c = pre[yy * w + xx];
            int v = c + lut[c >> shift];
            plane[yy * w + xx] = v < 0 ? 0 : v > maxv ? maxv : v;
          }
      }
    }
}

// ---- SAO syntax (7.3.8.3), mirror of spec/sao.py encode_sao_ctu ----------
void emit_sao_type_offsets(SliceEnc *s, const SaoP &p, bool write_class) {
  Encoder *e = s->e;
  e->encode_bin(s->off_sao_type, p.type ? 1 : 0);
  if (!p.type) return;
  e->encode_bypass(p.type == 2 ? 1 : 0);
  for (int i = 0; i < 4; i++) {
    int a = std::abs(p.off[i]);
    for (int k = 0; k < a; k++) e->encode_bypass(1);
    if (a < 7) e->encode_bypass(0);
  }
  if (p.type == 1) {
    for (int i = 0; i < 4; i++)
      if (p.off[i] != 0) e->encode_bypass(p.off[i] < 0 ? 1 : 0);
    e->encode_bypass_bits(p.band_pos, 5);
  } else if (write_class) {
    e->encode_bypass_bits(p.eo_class, 2);
  }
}

void emit_sao_offsets_only(SliceEnc *s, const SaoP &p) {
  Encoder *e = s->e;
  if (!p.type) return;
  for (int i = 0; i < 4; i++) {
    int a = std::abs(p.off[i]);
    for (int k = 0; k < a; k++) e->encode_bypass(1);
    if (a < 7) e->encode_bypass(0);
  }
  if (p.type == 1) {
    for (int i = 0; i < 4; i++)
      if (p.off[i] != 0) e->encode_bypass(p.off[i] < 0 ? 1 : 0);
    e->encode_bypass_bits(p.band_pos, 5);
  }
}

void emit_sao_ctu(SliceEnc *s, int cx, int cy, int rx, int ry) {
  // merge flags always 0 (explicit params); present only when the
  // neighbor CTB is in the same tile (spec 7.3.8.3)
  if (rx > 0 && cx > s->tx0) s->e->encode_bin(s->off_sao_merge, 0);
  if (ry > 0 && cy > s->ty0) s->e->encode_bin(s->off_sao_merge, 0);
  int i = ry * s->sao_nx + rx;
  emit_sao_type_offsets(s, s->sao_y[i], true);
  emit_sao_type_offsets(s, s->sao_cb[i], true);
  emit_sao_offsets_only(s, s->sao_cr[i]);
}

// apply the marshalled motion context (mirror of spec/inter.py MotionCtx)
// to a tile's SliceEnc; scalars layout: [cur_poc, n_l0, l0_poc0, l0_poc1,
// n_l1, l1_poc0, l1_poc1, tmvp, col_from_l0, col_poc, no_backward]
void apply_mctx(SliceEnc &se, const int32_t *m, const int8_t *col_dir,
                const int16_t *col_mv, const int32_t *col_refpoc,
                const int8_t *ref_map) {
  se.ref_map = ref_map;
  if (!m) return;
  se.cur_poc = m[0];
  se.n_l0 = m[1]; se.l0_pocs[0] = m[2]; se.l0_pocs[1] = m[3];
  se.n_l1 = m[4]; se.l1_pocs[0] = m[5]; se.l1_pocs[1] = m[6];
  se.tmvp = m[7] != 0;
  se.col_from_l0 = m[8] != 0;
  se.col_poc = m[9];
  se.no_backward = m[10] != 0;
  se.col_dir = col_dir;
  se.col_mv = col_mv;
  se.col_refpoc = col_refpoc;
}

}  // namespace

extern "C" {

// direct RDOQ TB entry (unit-test parity vs spec/rdoq.py)
int hevc_rdoq_tb(const int32_t *coeff, int lg, int qp, int slice_qp_y,
                 int bit_depth, int c_idx, int scan_idx, int cu_intra,
                 int32_t *levels_out) {
  init_scans();
  return quantize_rdoq(slice_qp_y, coeff, lg, qp, bit_depth, c_idx,
                       scan_idx, cu_intra, levels_out) ? 1 : 0;
}

// Deblock a reconstructed picture in place (luma+chroma, both directions).
// depth_map: int8 [coded_h/8][coded_w/8]; motion field arrays may be null
// (all-intra picture => BS=2 everywhere). Mirrors spec/deblock.py exactly.
void hevc_deblock_picture(int32_t *rec_y, int32_t *rec_cb, int32_t *rec_cr,
                          int coded_w, int coded_h, int log2_ctu,
                          int log2_max_tu, int bit_depth, int slice_qp,
                          int qp_cb, int qp_cr, const int8_t *depth_map,
                          const int32_t *mf_mv, const int32_t *mf_ref,
                          const uint8_t *mf_cbf,
                          const uint8_t *tusplit) {
  DeblockCtx c;
  c.w = coded_w; c.h = coded_h;
  c.gw = coded_w >> 3; c.gh = coded_h >> 3;
  c.gw4 = coded_w >> 2; c.gh4 = coded_h >> 2;
  c.bit_depth = bit_depth;
  c.maxv = (1 << bit_depth) - 1;
  c.depth = depth_map;
  c.log2_ctu = log2_ctu;
  c.log2_max_tu = log2_max_tu;
  c.has_motion = mf_ref != nullptr;
  c.mf_mv = mf_mv; c.mf_ref = mf_ref; c.mf_cbf = mf_cbf;
  c.tusplit = tusplit;
  int qpc = slice_qp < 0 ? 0 : slice_qp > 51 ? 51 : slice_qp;
  int beta = kBetaTab[qpc];
  // vertical then horizontal (spec order); each direction is conflict-free
  // across granule rows, so thread by row chunks for large pictures
  int n_thr = c.gh >= 64 ? 4 : 1;
  auto run_dir = [&](bool vert) {
    if (beta == 0) return;
    if (n_thr == 1) {
      luma_pass(c, rec_y, vert, beta, slice_qp, 0, c.gh);
      return;
    }
    std::vector<std::thread> ts;
    int chunk = (c.gh + n_thr - 1) / n_thr;
    for (int t = 0; t < n_thr; t++) {
      int lo = t * chunk, hi = std::min(c.gh, lo + chunk);
      if (lo < hi)
        ts.emplace_back([&, lo, hi, vert] {
          luma_pass(c, rec_y, vert, beta, slice_qp, lo, hi);
        });
    }
    for (auto &t : ts) t.join();
  };
  run_dir(true);
  run_dir(false);
  for (int pi = 0; pi < 2; pi++) {
    int32_t *pl = pi == 0 ? rec_cb : rec_cr;
    int qpcc = pi == 0 ? qp_cb : qp_cr;
    int qi = qpcc + 2;
    int tc = kTcTab[qi < 0 ? 0 : qi > 53 ? 53 : qi];
    if (tc == 0) continue;
    chroma_pass(c, pl, true, tc, 0, c.gh);
    chroma_pass(c, pl, false, tc, 0, c.gh);
  }
}

// Encode a full decided slice (I/P/B) in TWO PHASES: (1) commit — predict
// + TQ + recon into a per-frame decision store, per tile on parallel
// threads; then in-loop filters (deblock, SAO estimate+apply) on the full
// recon; (2) entropy — SAO params + CU syntax + residuals from the store,
// per tile on parallel threads. The split is what lets SAO parameters
// (slice syntax that depends on the post-deblock picture) be coded at CTU
// starts, mirroring HM's compressSlice -> loopFilterPic -> encodeSlice
// order (SURVEY.md §3.1).
//
// tile_col_bounds: [n_tile_cols+1] CTU-column bounds; tile_row_bounds:
// [n_tile_rows+1]. tile_sizes (out): per-tile substream byte size; the
// payload buffer receives the byte-aligned substreams back to back.
int hevc_encode_slice_tiled(
    const uint8_t *src_y, const uint8_t *src_cb, const uint8_t *src_cr,
    int coded_w, int coded_h, int log2_ctu, int bit_depth, int qp_y,
    int qp_cb, int qp_cr, int lossless, int bypass_enabled,
    const int8_t *depth_map, const int8_t *mode_map, int dm_w,
    const uint8_t *ctx_states, const uint8_t *ctx_mps, int n_ctx,
    const int32_t *ctx_offsets,  // [20]: last,csbf,sig,gt1,gt2,split,bypass,
                                 //  part,prev_intra,chroma,cbf_luma,
                                 //  cbf_chroma,skip,pred_mode,merge_flag,
                                 //  merge_idx,inter_idc,mvd,mvp,rqt_root
    int n_tile_cols, int n_tile_rows, const int32_t *tile_col_bounds,
    const int32_t *tile_row_bounds,
    // in-loop filters (phase 1.5)
    int deblock_enabled, int sao_enabled,
    // quantizer flags: bit0 = RDOQ-lite, bit1 = sign-data hiding
    int quant_flags,
    // inter (P/B); pass slice_type=2 and nulls for I slices
    int slice_type, const int8_t *dir_map, const int16_t *mv_map,
    const int32_t *ref0_y, const int32_t *ref0_cb, const int32_t *ref0_cr,
    const int32_t *ref1_y, const int32_t *ref1_cb, const int32_t *ref1_cr,
    // exported 4x4 motion field (for host-side deblock BS): may be null
    int32_t *mf_mv, int32_t *mf_ref, uint8_t *mf_cbf, uint8_t *mf_inter,
    int32_t *rec_y, int32_t *rec_cb, int32_t *rec_cr, uint8_t *payload,
    int32_t *tile_sizes,
    // motion context for merge/AMVP derivation (nullable -> single-ref)
    const int32_t *mctx_scalars, const int8_t *col_dir,
    const int16_t *col_mv, const int32_t *col_refpoc,
    const int8_t *ref_map,
    // second active reference per list (nullable)
    const int32_t *ref0b_y, const int32_t *ref0b_cb,
    const int32_t *ref0b_cr, const int32_t *ref1b_y,
    const int32_t *ref1b_cb, const int32_t *ref1b_cr,
    // explicit weighted prediction table (nullable; see SliceEnc::wp)
    const int32_t *wp_table) {
  // concurrent frame commits (the encoder pipelines frames onto a thread
  // pool) must not race the one-time table builds
  static std::once_flag init_once;
  std::call_once(init_once, [] { init_transforms(); init_scans(); });
  Frame f;
  f.coded_w = coded_w;
  f.coded_h = coded_h;
  f.log2_ctu = log2_ctu;
  f.bit_depth = bit_depth;
  f.y = rec_y;
  f.cb = rec_cb;
  f.cr = rec_cr;
  f.gw = coded_w >> 2;
  f.gh = coded_h >> 2;
  f.gdepth.assign(f.gw * f.gh, -1);
  f.gmode.assign(f.gw * f.gh, -1);
  f.gcoded.assign(f.gw * f.gh, 0);
  f.gskip.assign(f.gw * f.gh, 0);
  f.ginter.assign(f.gw * f.gh, 0);
  f.gcbf.assign(f.gw * f.gh, 0);
  f.gmv.assign(f.gw * f.gh * 4, 0);
  f.gref.assign(f.gw * f.gh * 2, -1);

  const int cs = 1 << log2_ctu;
  const int n_tiles = n_tile_cols * n_tile_rows;
  const bool tiled = n_tiles > 1;
  std::vector<Encoder> encs(n_tiles);
  std::vector<SliceEnc> ses(n_tiles);
  Stored st;
  st.init(coded_w, coded_h);
  // SAO parameter grids (per CTB)
  int sao_nx = (coded_w + cs - 1) / cs, sao_ny = (coded_h + cs - 1) / cs;
  std::vector<SaoP> sao_y(sao_nx * sao_ny), sao_cb(sao_nx * sao_ny),
      sao_cr(sao_nx * sao_ny);

  auto run_tile = [&](int t) {
    int tc = t % n_tile_cols, tr = t / n_tile_cols;
    SliceEnc &se = ses[t];
    Encoder &enc = encs[t];
    enc.state.assign(ctx_states, ctx_states + n_ctx);
    enc.mps.assign(ctx_mps, ctx_mps + n_ctx);
    enc.off = {ctx_offsets[0], ctx_offsets[1], ctx_offsets[2],
               ctx_offsets[3], ctx_offsets[4]};
    enc.out.reserve(1 << 16);
    se.f = &f;
    se.e = &enc;
    se.st = &st;
    se.qp_y = qp_y;
    se.qp_cb = qp_cb;
    se.qp_cr = qp_cr;
    se.lossless = lossless;
    se.bypass_enabled = bypass_enabled;
    se.rdoq = (quant_flags & 1) != 0;
    se.sdh = !lossless && (quant_flags & 2) != 0;
    se.ts_enabled = !lossless && (quant_flags & 4) != 0;
    se.off_ts = ctx_offsets[23];
    se.rqt_enabled = (quant_flags & 8) != 0;
    se.off_split_tu = ctx_offsets[24];
    se.src_y = src_y;
    se.src_cb = src_cb;
    se.src_cr = src_cr;
    se.depth_map = depth_map;
    se.mode_map = mode_map;
    se.dm_w = dm_w;
    se.off_split = ctx_offsets[5];
    se.off_bypassflag = ctx_offsets[6];
    se.off_part = ctx_offsets[7];
    se.off_prev_intra = ctx_offsets[8];
    se.off_chroma_mode = ctx_offsets[9];
    se.off_cbf_luma = ctx_offsets[10];
    se.off_cbf_chroma = ctx_offsets[11];
    se.off_skip = ctx_offsets[12];
    se.off_pred_mode = ctx_offsets[13];
    se.off_merge_flag = ctx_offsets[14];
    se.off_merge_idx = ctx_offsets[15];
    se.off_inter_idc = ctx_offsets[16];
    se.off_mvd = ctx_offsets[17];
    se.off_mvp = ctx_offsets[18];
    se.off_rqt_root = ctx_offsets[19];
    se.off_ref_idx = ctx_offsets[22];
    se.slice_type = slice_type;
    se.dir_map = dir_map;
    se.mv_map = mv_map;
    se.ref0_y = ref0_y; se.ref0_cb = ref0_cb; se.ref0_cr = ref0_cr;
    se.ref1_y = ref1_y; se.ref1_cb = ref1_cb; se.ref1_cr = ref1_cr;
    se.ref0b_y = ref0b_y; se.ref0b_cb = ref0b_cb; se.ref0b_cr = ref0b_cr;
    se.ref1b_y = ref1b_y; se.ref1b_cb = ref1b_cb; se.ref1b_cr = ref1b_cr;
    se.wp = wp_table;
    apply_mctx(se, mctx_scalars, col_dir, col_mv, col_refpoc, ref_map);
    if (tiled) {
      se.tx0 = tile_col_bounds[tc] * cs;
      se.ty0 = tile_row_bounds[tr] * cs;
      se.tx1 = tile_col_bounds[tc + 1] * cs;
      if (se.tx1 > coded_w) se.tx1 = coded_w;
      se.ty1 = tile_row_bounds[tr + 1] * cs;
      if (se.ty1 > coded_h) se.ty1 = coded_h;
    } else {
      se.tx0 = 0; se.ty0 = 0; se.tx1 = coded_w; se.ty1 = coded_h;
    }
    se.sao_on = sao_enabled;
    se.off_sao_merge = ctx_offsets[20];
    se.off_sao_type = ctx_offsets[21];
    se.sao_y = sao_y.data();
    se.sao_cb = sao_cb.data();
    se.sao_cr = sao_cr.data();
    se.sao_nx = sao_nx;
  };

  auto tile_ctu_loop = [&](int t, bool commit) {
    int tc = t % n_tile_cols, tr = t / n_tile_cols;
    SliceEnc &se = ses[t];
    Encoder &enc = encs[t];
    int first_cx = tile_col_bounds[tc] * cs;
    int last_cx = tile_col_bounds[tc + 1] * cs;
    int first_cy = tile_row_bounds[tr] * cs;
    int last_cy = tile_row_bounds[tr + 1] * cs;
    bool is_last_tile = (t == n_tiles - 1);
    for (int cy = first_cy; cy < last_cy && cy < coded_h; cy += cs)
      for (int cx = first_cx; cx < last_cx && cx < coded_w; cx += cs) {
        if (commit) {
          commit_cq(&se, cx, cy, log2_ctu, 0);
          continue;
        }
        if (se.sao_on)
          emit_sao_ctu(&se, cx, cy, cx >> log2_ctu, cy >> log2_ctu);
        emit_cq(&se, cx, cy, log2_ctu, 0);
        bool last_ctu = (cy + cs >= last_cy || cy + cs >= coded_h) &&
                        (cx + cs >= last_cx || cx + cs >= coded_w);
        bool last_of_slice = is_last_tile && last_ctu;
        enc.encode_terminate(last_of_slice ? 1 : 0);
        if (last_ctu && !last_of_slice)
          enc.encode_terminate(1);  // end_of_subset_one_bit
      }
    if (!commit) enc.finish_aligned();
  };

  auto run_phase = [&](bool commit) {
    if (tiled) {
      std::vector<std::thread> threads;
      for (int t = 0; t < n_tiles; t++)
        threads.emplace_back(tile_ctu_loop, t, commit);
      for (auto &th : threads) th.join();
    } else {
      tile_ctu_loop(0, commit);
    }
  };

  // FASTHEVC_TIMING=1: print per-phase wall ms to stderr (profiling aid)
  static const bool timing = std::getenv("FASTHEVC_TIMING") != nullptr;
  auto now_ms = [] {
    return std::chrono::duration<double, std::milli>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  double t0 = timing ? now_ms() : 0.0;

  for (int t = 0; t < n_tiles; t++) run_tile(t);  // set up contexts
  run_phase(true);  // ---- phase 1: commit --------------------------------
  double t_commit = timing ? now_ms() : 0.0;

  // ---- phase 1.5: in-loop filters on the full recon ---------------------
  if (deblock_enabled) {
    bool has_motion = slice_type != 2;
    hevc_deblock_picture(f.y, f.cb, f.cr, coded_w, coded_h, log2_ctu,
                         5 /*log2_max_tu*/, bit_depth, qp_y, qp_cb, qp_cr,
                         depth_map,
                         has_motion ? f.gmv.data() : nullptr,
                         has_motion ? f.gref.data() : nullptr,
                         has_motion ? f.gcbf.data() : nullptr,
                         has_motion ? st.tusplit.data() : nullptr);
  }
  if (sao_enabled) {
    // estimate per CTB (luma on CTB grid, chroma on CTB/2 regions), then
    // apply; rows are independent -> two worker threads
    auto est_rows = [&](int r0, int r1) {
      for (int ry = r0; ry < r1; ry++)
        for (int rx = 0; rx < sao_nx; rx++) {
          int y0 = ry * cs, x0 = rx * cs;
          int hh = std::min(cs, coded_h - y0), ww = std::min(cs, coded_w - x0);
          int i = ry * sao_nx + rx;
          sao_y[i] = sao_estimate_ctb(src_y + y0 * coded_w + x0, coded_w,
                                      f.y + y0 * coded_w + x0, coded_w, ww,
                                      hh, bit_depth);
          int half = cs / 2, cw2 = coded_w / 2, ch2 = coded_h / 2;
          int cy0 = ry * half, cx0 = rx * half;
          int chh = std::min(half, ch2 - cy0), cww = std::min(half, cw2 - cx0);
          sao_cb[i] = sao_estimate_ctb(src_cb + cy0 * cw2 + cx0, cw2,
                                       f.cb + cy0 * cw2 + cx0, cw2, cww, chh,
                                       bit_depth);
          sao_cr[i] = sao_estimate_ctb_given(
              src_cr + cy0 * cw2 + cx0, cw2, f.cr + cy0 * cw2 + cx0, cw2,
              cww, chh, sao_cb[i].type, sao_cb[i].eo_class, bit_depth);
        }
    };
    if (sao_ny >= 8) {
      int mid = sao_ny / 2;
      std::thread th(est_rows, 0, mid);
      est_rows(mid, sao_ny);
      th.join();
    } else {
      est_rows(0, sao_ny);
    }
    sao_apply_plane(f.y, coded_w, coded_h, cs, sao_y.data(), sao_nx,
                    sao_ny, bit_depth);
    sao_apply_plane(f.cb, coded_w / 2, coded_h / 2, cs / 2, sao_cb.data(),
                    sao_nx, sao_ny, bit_depth);
    sao_apply_plane(f.cr, coded_w / 2, coded_h / 2, cs / 2, sao_cr.data(),
                    sao_nx, sao_ny, bit_depth);
  }

  double t_filters = timing ? now_ms() : 0.0;
  run_phase(false);  // ---- phase 2: entropy ------------------------------
  if (timing) {
    double t_end = now_ms();
    fprintf(stderr,
            "[slice_engine] %dx%d tiles=%d commit=%.1fms filters=%.1fms "
            "entropy=%.1fms\n",
            coded_w, coded_h, n_tiles, t_commit - t0, t_filters - t_commit,
            t_end - t_filters);
  }

  size_t off = 0;
  for (int t = 0; t < n_tiles; t++) {
    std::memcpy(payload + off, encs[t].out.data(), encs[t].out.size());
    tile_sizes[t] = (int32_t)encs[t].out.size();
    off += encs[t].out.size();
  }
  if (mf_mv) std::memcpy(mf_mv, f.gmv.data(),
                         sizeof(int32_t) * f.gw * f.gh * 4);
  if (mf_ref) std::memcpy(mf_ref, f.gref.data(),
                          sizeof(int32_t) * f.gw * f.gh * 2);
  if (mf_cbf) std::memcpy(mf_cbf, f.gcbf.data(), f.gw * f.gh);
  if (mf_inter) std::memcpy(mf_inter, f.ginter.data(), f.gw * f.gh);
  return (int)off;
}

// Entropy-only slice emission for the DEVICE-COMMIT path (SURVEY.md
// §2.5): the TPU wavefront kernel (ops/commit.py) has already produced
// the exact reconstruction and quantized levels; this entry fills the
// decision store + frame maps from those levels and runs phase 2 only.
// Intra slices, TU == CU. lv planes: int16 at plane positions. sao_params:
// int32 [sao_ny][sao_nx][3][7] = (type, eo_class, band_pos, off0..3) per
// component, or null when SAO is off.
int hevc_entropy_slice_tiled(
    int coded_w, int coded_h, int log2_ctu, int bit_depth, int qp_y,
    int qp_cb, int qp_cr, int lossless, int bypass_enabled,
    const int8_t *depth_map, const int8_t *mode_map, int dm_w,
    int slice_type, const int8_t *dir_map, const int16_t *mv_map,
    const int16_t *lv_y, const int16_t *lv_cb, const int16_t *lv_cr,
    const uint8_t *ctx_states, const uint8_t *ctx_mps, int n_ctx,
    const int32_t *ctx_offsets, int n_tile_cols, int n_tile_rows,
    const int32_t *tile_col_bounds, const int32_t *tile_row_bounds,
    int sao_enabled, const int32_t *sao_params, int sdh_flags,
    uint8_t *payload, int32_t *tile_sizes,
    // motion context for merge/AMVP derivation (nullable -> single-ref)
    const int32_t *mctx_scalars, const int8_t *col_dir,
    const int16_t *col_mv, const int32_t *col_refpoc,
    const int8_t *ref_map) {
  static std::once_flag init_once2;
  std::call_once(init_once2, [] { init_transforms(); init_scans(); });
  Frame f;
  f.coded_w = coded_w;
  f.coded_h = coded_h;
  f.log2_ctu = log2_ctu;
  f.bit_depth = bit_depth;
  f.y = nullptr;
  f.cb = nullptr;
  f.cr = nullptr;
  f.gw = coded_w >> 2;
  f.gh = coded_h >> 2;
  f.gdepth.assign(f.gw * f.gh, -1);
  f.gmode.assign(f.gw * f.gh, -1);
  f.gcoded.assign(f.gw * f.gh, 0);
  f.gskip.assign(f.gw * f.gh, 0);
  f.ginter.assign(f.gw * f.gh, 0);
  f.gcbf.assign(f.gw * f.gh, 0);
  f.gmv.assign(f.gw * f.gh * 4, 0);
  f.gref.assign(f.gw * f.gh * 2, -1);

  const int cs = 1 << log2_ctu;
  const int n_tiles = n_tile_cols * n_tile_rows;
  std::vector<Encoder> encs(n_tiles);
  std::vector<SliceEnc> ses(n_tiles);
  Stored st;
  st.init(coded_w, coded_h);
  int sao_nx = (coded_w + cs - 1) / cs, sao_ny = (coded_h + cs - 1) / cs;
  std::vector<SaoP> sao_y(sao_nx * sao_ny), sao_cb(sao_nx * sao_ny),
      sao_cr(sao_nx * sao_ny);
  if (sao_enabled && sao_params) {
    for (int i = 0; i < sao_nx * sao_ny; i++)
      for (int ci = 0; ci < 3; ci++) {
        const int32_t *p = sao_params + (i * 3 + ci) * 7;
        SaoP &sp = ci == 0 ? sao_y[i] : (ci == 1 ? sao_cb[i] : sao_cr[i]);
        sp.type = p[0];
        sp.eo_class = p[1];
        sp.band_pos = p[2];
        for (int k = 0; k < 4; k++) sp.off[k] = p[3 + k];
      }
  }

  // ---- fill the store + frame maps from the device-committed levels ----
  struct Filler {
    SliceEnc *s;
    const int16_t *lv_y, *lv_cb, *lv_cr;
    void cu(int x, int y, int lg, int depth) {
      Frame &f = *s->f;
      Stored &st = *s->st;
      int size = 1 << lg;
      bool inside = (x + size <= f.coded_w) && (y + size <= f.coded_h);
      bool split =
          !inside || (lg > s->log2_min_cu &&
                      s->depth_map[(y >> 3) * s->dm_w + (x >> 3)] > depth);
      if (split) {
        int half = size >> 1;
        for (int i = 0; i < 4; i++) {
          int cx = x + (i & 1) * half, cy = y + (i >> 1) * half;
          if (cx < f.coded_w && cy < f.coded_h) cu(cx, cy, lg - 1, depth + 1);
        }
        return;
      }
      int mode = s->mode_map[(y >> 3) * s->dm_w + (x >> 3)];
      int n_tus = (lg > s->log2_max_tu) ? 4 : 1;
      int tlg = (lg > s->log2_max_tu) ? lg - 1 : lg;
      int tn = 1 << tlg;
      int half = 1 << (lg - 1);
      bool cbf_any = false, cbf_y_any = false;
      for (int i = 0; i < n_tus; i++) {
        int tx = n_tus == 1 ? x : x + (i & 1) * half;
        int ty = n_tus == 1 ? y : y + (i >> 1) * half;
        bool cy_f = copy_tb(st.lv_y, f.coded_w, lv_y, tx, ty, tn);
        st.set_cbf(st.cbf_y, tx, ty, tn, cy_f);
        bool ccb = copy_tb(st.lv_cb, f.coded_w / 2, lv_cb, tx >> 1,
                           ty >> 1, tn / 2);
        st.set_cbf(st.cbf_cb, tx, ty, tn, ccb);
        bool ccr = copy_tb(st.lv_cr, f.coded_w / 2, lv_cr, tx >> 1,
                           ty >> 1, tn / 2);
        st.set_cbf(st.cbf_cr, tx, ty, tn, ccr);
        cbf_any |= cy_f | ccb | ccr;
        cbf_y_any |= cy_f;
      }
      if (s->slice_type != 2) {
        int dir;
        MotionCu m = cu_motion_from_maps(s, x, y, &dir);
        if (dir > 0) {
          store_inter_syntax(s, x, y, lg, depth, m, cbf_any, cbf_y_any);
          return;
        }
      }
      set_cu(s, x, y, size, depth, mode);
      set_intra_motion(s, x, y, size, false);
    }
    static bool copy_tb(std::vector<int32_t> &dst, int stride,
                        const int16_t *src, int x, int y, int n) {
      bool any = false;
      for (int yy = 0; yy < n; yy++)
        for (int xx = 0; xx < n; xx++) {
          int32_t v = src[(y + yy) * stride + (x + xx)];
          dst[(y + yy) * stride + (x + xx)] = v;
          any |= v != 0;
        }
      return any;
    }
  };

  auto setup_tile = [&](int t) {
    int tc = t % n_tile_cols, tr = t / n_tile_cols;
    SliceEnc &se = ses[t];
    Encoder &enc = encs[t];
    enc.state.assign(ctx_states, ctx_states + n_ctx);
    enc.mps.assign(ctx_mps, ctx_mps + n_ctx);
    enc.off = {ctx_offsets[0], ctx_offsets[1], ctx_offsets[2],
               ctx_offsets[3], ctx_offsets[4]};
    enc.out.reserve(1 << 16);
    se.f = &f;
    se.e = &enc;
    se.st = &st;
    se.qp_y = qp_y;
    se.qp_cb = qp_cb;
    se.qp_cr = qp_cr;
    se.lossless = lossless;
    se.bypass_enabled = bypass_enabled;
    se.sdh = !lossless && (sdh_flags & 1);
    se.ts_enabled = !lossless && (sdh_flags & 2);
    se.off_ts = ctx_offsets[23];
    se.rqt_enabled = (sdh_flags & 4) != 0;
    se.off_split_tu = ctx_offsets[24];
    se.depth_map = depth_map;
    se.mode_map = mode_map;
    se.dm_w = dm_w;
    se.off_split = ctx_offsets[5];
    se.off_bypassflag = ctx_offsets[6];
    se.off_part = ctx_offsets[7];
    se.off_prev_intra = ctx_offsets[8];
    se.off_chroma_mode = ctx_offsets[9];
    se.off_cbf_luma = ctx_offsets[10];
    se.off_cbf_chroma = ctx_offsets[11];
    se.off_skip = ctx_offsets[12];
    se.off_pred_mode = ctx_offsets[13];
    se.off_merge_flag = ctx_offsets[14];
    se.off_merge_idx = ctx_offsets[15];
    se.off_inter_idc = ctx_offsets[16];
    se.off_mvd = ctx_offsets[17];
    se.off_mvp = ctx_offsets[18];
    se.off_rqt_root = ctx_offsets[19];
    se.off_ref_idx = ctx_offsets[22];
    se.slice_type = slice_type;
    se.dir_map = dir_map;
    se.mv_map = mv_map;
    apply_mctx(se, mctx_scalars, col_dir, col_mv, col_refpoc, ref_map);
    if (n_tiles > 1) {
      se.tx0 = tile_col_bounds[tc] * cs;
      se.ty0 = tile_row_bounds[tr] * cs;
      se.tx1 = std::min(tile_col_bounds[tc + 1] * cs, coded_w);
      se.ty1 = std::min(tile_row_bounds[tr + 1] * cs, coded_h);
    } else {
      se.tx0 = 0; se.ty0 = 0; se.tx1 = coded_w; se.ty1 = coded_h;
    }
    se.sao_on = sao_enabled != 0;
    se.off_sao_merge = ctx_offsets[20];
    se.off_sao_type = ctx_offsets[21];
    se.sao_y = sao_y.data();
    se.sao_cb = sao_cb.data();
    se.sao_cr = sao_cr.data();
    se.sao_nx = sao_nx;
  };

  for (int t = 0; t < n_tiles; t++) setup_tile(t);
  {  // fill pass (cheap, single thread) — TILE-MAJOR decode order with
     // each tile's own availability rect: the inter merge/AMVP replay is
     // order- and tile-availability-dependent (spec 6.4.1)
    for (int t = 0; t < n_tiles; t++) {
      Filler fill{&ses[t], lv_y, lv_cb, lv_cr};
      for (int cy = ses[t].ty0; cy < ses[t].ty1; cy += cs)
        for (int cx = ses[t].tx0; cx < ses[t].tx1; cx += cs)
          fill.cu(cx, cy, log2_ctu, 0);
    }
  }

  auto tile_emit = [&](int t) {
    SliceEnc &se = ses[t];
    Encoder &enc = encs[t];
    bool is_last_tile = (t == n_tiles - 1);
    for (int cy = se.ty0; cy < se.ty1; cy += cs)
      for (int cx = se.tx0; cx < se.tx1; cx += cs) {
        if (se.sao_on)
          emit_sao_ctu(&se, cx, cy, cx >> log2_ctu, cy >> log2_ctu);
        emit_cq(&se, cx, cy, log2_ctu, 0);
        bool last_ctu = (cy + cs >= se.ty1) && (cx + cs >= se.tx1);
        bool last_of_slice = is_last_tile && last_ctu;
        enc.encode_terminate(last_of_slice ? 1 : 0);
        if (last_ctu && !last_of_slice) enc.encode_terminate(1);
      }
    enc.finish_aligned();
  };
  if (n_tiles > 1) {
    std::vector<std::thread> threads;
    for (int t = 0; t < n_tiles; t++) threads.emplace_back(tile_emit, t);
    for (auto &th : threads) th.join();
  } else {
    tile_emit(0);
  }

  size_t off = 0;
  for (int t = 0; t < n_tiles; t++) {
    std::memcpy(payload + off, encs[t].out.data(), encs[t].out.size());
    tile_sizes[t] = (int32_t)encs[t].out.size();
    off += encs[t].out.size();
  }
  return (int)off;
}

}  // extern "C"