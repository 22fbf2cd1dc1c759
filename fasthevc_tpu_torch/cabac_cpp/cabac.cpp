// C++ host CABAC engine + residual-coding serializer.
//
// Reference parity: HM TEncBinCoderCABAC + TEncSbac::codeCoeffNxN
// (SURVEY.md C6, E9) — written from H.265 spec 9.3 to be bit-identical to
// the Python oracle in fasthevc_tpu/spec/cabac.py + residual.py (enforced
// by tests/test_cabac_cpp.py). The sequential bit-twiddling half of the
// codec lives here; the TPU side only ever *estimates* rate.
//
// C ABI for ctypes. Context state is a caller-provided linearized array
// (state index 0..63 + mps flag per context); family offsets for the
// residual syntax are passed at construction.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---- engine tables (spec 9.3.4.3) ----------------------------------------
const uint8_t kRangeTabLps[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216},
    {123, 150, 178, 205}, {116, 142, 169, 195}, {111, 135, 160, 185},
    {105, 128, 152, 175}, {100, 122, 144, 166}, {95, 116, 137, 158},
    {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},
    {66, 80, 95, 110},    {62, 76, 90, 104},    {59, 72, 86, 99},
    {56, 69, 81, 94},     {53, 65, 77, 89},     {51, 62, 73, 85},
    {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},
    {35, 43, 51, 59},     {33, 41, 48, 56},     {32, 39, 46, 53},
    {30, 37, 43, 50},     {28, 35, 41, 48},     {27, 33, 39, 45},
    {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},
    {19, 23, 27, 31},     {18, 22, 26, 30},     {17, 21, 25, 28},
    {16, 20, 23, 27},     {15, 19, 22, 25},     {14, 18, 21, 24},
    {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},
    {10, 12, 15, 17},     {10, 12, 14, 16},     {9, 11, 13, 15},
    {9, 11, 12, 14},      {8, 10, 12, 14},      {8, 9, 11, 13},
    {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},
    {2, 2, 2, 2}};

const uint8_t kTransIdxLps[64] = {
    0,  0,  1,  2,  2,  4,  4,  5,  6,  7,  8,  9,  9,  11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 23, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63};

const uint8_t kRenorm[32] = {6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

const int kSigCtxMap4x4[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                               6, 6, 8, 8, 7, 7, 8, 8};

// ---- scan orders (spec 6.5.3) --------------------------------------------
struct Scan {
  // positions (x, y) in scan order for each (log2_size 2..5, scan 0..2)
  std::vector<int> x, y;
};

Scan g_scans[4][3];
bool g_scans_init = false;

void diag4(int out[16][2]) {
  int i = 0;
  for (int s = 0; s <= 6; s++)
    for (int x = (s > 3 ? s - 3 : 0); x <= (s < 3 ? s : 3); x++) {
      int yy = s - x;
      if (yy <= 3) { out[i][0] = x; out[i][1] = yy; i++; }
    }
}

void init_scans() {
  if (g_scans_init) return;
  int d4[16][2];
  diag4(d4);
  for (int lg = 2; lg <= 5; lg++) {
    int size = 1 << lg;
    int nsb = size / 4;
    for (int scan = 0; scan < 3; scan++) {
      Scan &s = g_scans[lg - 2][scan];
      s.x.resize(size * size);
      s.y.resize(size * size);
      // in-subblock pattern
      int sub[16][2];
      if (scan == 1) {  // horizontal
        for (int i = 0; i < 16; i++) { sub[i][0] = i % 4; sub[i][1] = i / 4; }
      } else if (scan == 2) {  // vertical
        for (int i = 0; i < 16; i++) { sub[i][0] = i / 4; sub[i][1] = i % 4; }
      } else {
        std::memcpy(sub, d4, sizeof(sub));
      }
      // subblock order
      std::vector<int> sbx, sby;
      if (scan == 1) {
        for (int yy = 0; yy < nsb; yy++)
          for (int xx = 0; xx < nsb; xx++) { sbx.push_back(xx); sby.push_back(yy); }
      } else if (scan == 2) {
        for (int xx = 0; xx < nsb; xx++)
          for (int yy = 0; yy < nsb; yy++) { sbx.push_back(xx); sby.push_back(yy); }
      } else {
        for (int ss = 0; ss <= 2 * (nsb - 1); ss++)
          for (int xx = (ss > nsb - 1 ? ss - (nsb - 1) : 0);
               xx <= (ss < nsb - 1 ? ss : nsb - 1); xx++) {
            int yy = ss - xx;
            if (yy <= nsb - 1) { sbx.push_back(xx); sby.push_back(yy); }
          }
      }
      int i = 0;
      for (size_t b = 0; b < sbx.size(); b++)
        for (int k = 0; k < 16; k++, i++) {
          s.x[i] = sub[k][0] + 4 * sbx[b];
          s.y[i] = sub[k][1] + 4 * sby[b];
        }
    }
  }
  g_scans_init = true;
}

// ---- encoder --------------------------------------------------------------
struct CtxOffsets {
  int last_prefix;   // last_sig_coeff_prefix
  int csbf;          // coded_sub_block_flag
  int sig;           // sig_coeff_flag
  int gt1;           // coeff_abs_level_greater1_flag
  int gt2;           // coeff_abs_level_greater2_flag
};

struct Encoder {
  std::vector<uint8_t> state;  // per linear ctx
  std::vector<uint8_t> mps;
  CtxOffsets off;
  uint64_t low = 0;
  uint32_t range = 510;
  int bits_left = 23;
  int num_buffered = 0;
  uint32_t buffered_byte = 0xFF;
  std::vector<uint8_t> out;

  void write_out() {
    uint32_t lead = (uint32_t)(low >> (24 - bits_left));
    bits_left += 8;
    low &= 0xFFFFFFFFull >> bits_left;
    if (lead == 0xFF) {
      num_buffered++;
    } else if (num_buffered > 0) {
      uint32_t carry = lead >> 8;
      out.push_back((uint8_t)(buffered_byte + carry));
      for (int i = 0; i < num_buffered - 1; i++)
        out.push_back((uint8_t)(0xFF + carry));
      num_buffered = 1;
      buffered_byte = lead & 0xFF;
    } else {
      num_buffered = 1;
      buffered_byte = lead;
    }
  }
  inline void test_write_out() { if (bits_left < 12) write_out(); }

  void encode_bin(int ctx, int bin) {
    int st = state[ctx];
    int mp = mps[ctx];
    uint32_t lps = kRangeTabLps[st][(range >> 6) & 3];
    range -= lps;
    if (bin != mp) {
      int nb = kRenorm[lps >> 3];
      low = (low + range) << nb;
      range = lps << nb;
      if (st == 0) mps[ctx] = 1 - mp;
      state[ctx] = kTransIdxLps[st];
      bits_left -= nb;
    } else {
      state[ctx] = (st == 63) ? 63 : (st + 1 > 62 ? 62 : st + 1);
      if (range >= 256) return;
      low <<= 1;
      range <<= 1;
      bits_left -= 1;
    }
    test_write_out();
  }

  void encode_bypass(int bin) {
    low <<= 1;
    if (bin) low += range;
    bits_left -= 1;
    test_write_out();
  }

  void encode_bypass_bits(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) encode_bypass((v >> i) & 1);
  }

  void encode_terminate(int bin) {
    range -= 2;
    if (bin) {
      low += range;
      low <<= 7;
      range = 2 << 7;
      bits_left -= 7;
    } else if (range >= 256) {
      return;
    } else {
      low <<= 1;
      range <<= 1;
      bits_left -= 1;
    }
    test_write_out();
  }

  // finish + byte_alignment(): append all trailing bits and the stop bit
  // so `out` is the complete byte-aligned substream.
  void finish_aligned() {
    uint32_t trail;
    int nbits = finish(&trail);
    out.push_back((uint8_t)((trail << (8 - nbits)) | (0x80u >> nbits)));
  }

  // returns trailing bit count; trailing bits value in *trail
  int finish(uint32_t *trail) {
    if ((low >> (32 - bits_left)) != 0) {
      out.push_back((uint8_t)(buffered_byte + 1));
      for (int i = 0; i < num_buffered - 1; i++) out.push_back(0x00);
      low -= 1ull << (32 - bits_left);
    } else {
      if (num_buffered > 0) out.push_back((uint8_t)buffered_byte);
      for (int i = 0; i < num_buffered - 1; i++) out.push_back(0xFF);
    }
    int nbits = 24 - bits_left;
    uint32_t val = (uint32_t)(low >> 8) & ((nbits >= 32) ? 0xFFFFFFFFu
                                                         : ((1u << nbits) - 1));
    while (nbits >= 8) {
      out.push_back((uint8_t)(val >> (nbits - 8)));
      nbits -= 8;
      val &= (1u << nbits) - 1;
    }
    *trail = val;
    return nbits;
  }
};

// ---- residual coding (spec 7.3.8.11) --------------------------------------
void last_ctx_params(int lg, int c_idx, int *offset, int *shift) {
  if (c_idx == 0) {
    *offset = 3 * (lg - 2) + ((lg - 1) >> 2);
    *shift = (lg + 1) >> 2;
  } else {
    *offset = 15;
    *shift = lg - 2;
  }
}

int sig_ctx_inc(int lg, int c_idx, int x, int y, int scan_idx, int csbf_r,
                int csbf_b) {
  int sig;
  if (lg == 2) {
    sig = kSigCtxMap4x4[(y << 2) + x];
  } else if (x == 0 && y == 0) {
    sig = 0;
  } else {
    int xp = x & 3, yp = y & 3;
    int prev = csbf_r + 2 * csbf_b;
    if (prev == 0)
      sig = (xp + yp == 0) ? 2 : (xp + yp < 3) ? 1 : 0;
    else if (prev == 1)
      sig = (yp == 0) ? 2 : (yp == 1) ? 1 : 0;
    else if (prev == 2)
      sig = (xp == 0) ? 2 : (xp == 1) ? 1 : 0;
    else
      sig = 2;
    if (c_idx == 0) {
      if ((x >> 2) + (y >> 2) > 0) sig += 3;
      sig += (lg == 3) ? (scan_idx == 0 ? 9 : 15) : 21;
    } else {
      sig += (lg == 3) ? 9 : 12;
    }
  }
  return sig + (c_idx ? 27 : 0);
}

void write_remaining(Encoder *e, uint32_t value, int rice) {
  if (value < (uint32_t)(3 << rice)) {
    uint32_t length = value >> rice;
    e->encode_bypass_bits((1u << (length + 1)) - 2, length + 1);
    if (rice) e->encode_bypass_bits(value & ((1u << rice) - 1), rice);
  } else {
    int length = rice;
    uint32_t v = value - (3u << rice);
    while (v >= (1u << length)) {
      v -= 1u << length;
      length++;
    }
    int np = 3 + length + 1 - rice;
    e->encode_bypass_bits((1u << np) - 2, np);
    if (length) e->encode_bypass_bits(v, length);
  }
}

void last_prefix_suffix(int pos, int *prefix, int *suffix, int *slen) {
  if (pos <= 3) {
    *prefix = pos;
    *suffix = 0;
    *slen = 0;
    return;
  }
  int bl = 0;
  for (int t = pos; t; t >>= 1) bl++;
  int sl = bl - 2;
  int p = 2 + sl * 2 + ((pos >> sl) & 1);
  *prefix = p;
  *suffix = pos - ((2 + (p & 1)) << sl);
  *slen = sl;
}

void encode_residual(Encoder *e, const int32_t *levels, int lg, int c_idx,
                     int scan_idx, int sdh = 0) {
  init_scans();
  const Scan &sc = g_scans[lg - 2][scan_idx];
  int size = 1 << lg;
  int n_coeffs = size * size;

  // scan-ordered values, find last
  std::vector<int32_t> vals(n_coeffs);
  int last_pos = -1;
  for (int i = 0; i < n_coeffs; i++) {
    vals[i] = levels[sc.y[i] * size + sc.x[i]];
    if (vals[i]) last_pos = i;
  }

  int lx = sc.x[last_pos], ly = sc.y[last_pos];
  if (scan_idx == 2) { int t = lx; lx = ly; ly = t; }
  int g_max = (lg << 1) - 1, offc, shiftc;
  last_ctx_params(lg, c_idx, &offc, &shiftc);
  int px, sx, slx, py, sy, sly;
  last_prefix_suffix(lx, &px, &sx, &slx);
  last_prefix_suffix(ly, &py, &sy, &sly);
  for (int i = 0; i < px; i++)
    e->encode_bin(e->off.last_prefix + offc + (i >> shiftc), 1);
  if (px < g_max) e->encode_bin(e->off.last_prefix + offc + (px >> shiftc), 0);
  for (int i = 0; i < py; i++)
    e->encode_bin(e->off.last_prefix + offc + (i >> shiftc), 1);
  if (py < g_max) e->encode_bin(e->off.last_prefix + offc + (py >> shiftc), 0);
  if (px > 3) e->encode_bypass_bits(sx, slx);
  if (py > 3) e->encode_bypass_bits(sy, sly);

  int nsb = size / 4 > 0 ? size / 4 : 1;
  int num_subsets = (last_pos >> 4) + 1;
  std::vector<int> csbf(nsb * nsb, 0);
  for (int i = 0; i < num_subsets; i++) {
    int any = 0;
    for (int k = i * 16; k < (i + 1) * 16; k++) any |= (vals[k] != 0);
    int sxx = sc.x[i * 16] >> 2, syy = sc.y[i * 16] >> 2;
    csbf[syy * nsb + sxx] = any;
  }

  int c1 = 1;
  for (int i = num_subsets - 1; i >= 0; i--) {
    const int base = i * 16;
    int sxx = sc.x[base] >> 2, syy = sc.y[base] >> 2;
    bool is_last_sub = (i == num_subsets - 1);
    bool infer_dc = false;
    int sb_coded;
    int right = (sxx + 1 < nsb) ? csbf[syy * nsb + sxx + 1] : 0;
    int below = (syy + 1 < nsb) ? csbf[(syy + 1) * nsb + sxx] : 0;
    if (is_last_sub || i == 0) {
      sb_coded = 1;
    } else {
      sb_coded = csbf[syy * nsb + sxx];
      int ctx = (right + below > 0 ? 1 : 0) + (c_idx ? 2 : 0);
      e->encode_bin(e->off.csbf + ctx, sb_coded);
      infer_dc = sb_coded;
    }
    if (!sb_coded) continue;

    int start = is_last_sub ? (last_pos - base) - 1 : 15;
    int coded_pos[16];
    int n_sig = 0;
    if (is_last_sub) coded_pos[n_sig++] = last_pos - base;
    bool any_above_dc = false;
    for (int k = 1; k < 16; k++)
      if (k <= start && vals[base + k]) any_above_dc = true;
    if (is_last_sub && last_pos - base > 0) any_above_dc = true;
    for (int n = start; n >= 0; n--) {
      int xx = sc.x[base + n], yy = sc.y[base + n];
      int s = vals[base + n] != 0;
      if (n == 0 && infer_dc && !any_above_dc) {
        coded_pos[n_sig++] = 0;
        continue;
      }
      int ctx = sig_ctx_inc(lg, c_idx, xx, yy, scan_idx, right, below);
      e->encode_bin(e->off.sig + ctx, s);
      if (s) coded_pos[n_sig++] = n;
    }

    int abs_vals[16], signs[16];
    for (int k = 0; k < n_sig; k++) {
      int32_t v = vals[base + coded_pos[k]];
      abs_vals[k] = v < 0 ? -v : v;
      signs[k] = v < 0;
    }

    int ctx_set = (i > 0 && c_idx == 0) ? 2 : 0;
    if (c1 == 0) ctx_set++;
    c1 = 1;
    int gt1_flags[8];
    int first_gt1 = -1;
    int ngt1 = n_sig < 8 ? n_sig : 8;
    for (int k = 0; k < ngt1; k++) {
      int g = abs_vals[k] > 1;
      e->encode_bin(e->off.gt1 + (c_idx ? 16 : 0) + 4 * ctx_set + c1, g);
      gt1_flags[k] = g;
      if (g) {
        if (first_gt1 < 0) first_gt1 = k;
        c1 = 0;
      } else if (c1 > 0 && c1 < 3) {
        c1++;
      }
    }
    if (first_gt1 >= 0) {
      int g2 = abs_vals[first_gt1] > 2;
      e->encode_bin(e->off.gt2 + (c_idx ? 4 : 0) + ctx_set, g2);
    }

    // sign-data hiding (spec 7.4.9.11): when enabled and the sub-block's
    // sig span is > 3, the sign of the lowest-scan-pos coefficient
    // (coded_pos[n_sig-1], the last one here) is inferred from the parity
    // of the sum of abs levels — the quantizer guarantees it (sdh_adjust)
    int hidden = sdh && n_sig > 0 &&
                 (coded_pos[0] - coded_pos[n_sig - 1] > 3);
    for (int k = 0; k < n_sig - hidden; k++) e->encode_bypass(signs[k]);

    int rice = 0;
    for (int k = 0; k < n_sig; k++) {
      int base_level;
      if (k < 8) {
        if (!gt1_flags[k]) continue;  // |level| == 1 exactly
        if (k == first_gt1) {
          if (abs_vals[k] <= 2) continue;  // gt2 == 0 -> level 2 exactly
          base_level = 3;
        } else {
          base_level = 2;
        }
      } else {
        base_level = 1;
      }
      write_remaining(e, abs_vals[k] - base_level, rice);
      if (abs_vals[k] > (3 << rice) && rice < 4) rice++;
    }
  }
}

}  // namespace

// ---- C ABI ----------------------------------------------------------------
extern "C" {

void *cabac_enc_new(const uint8_t *states, const uint8_t *mps, int n_ctx,
                    int off_last, int off_csbf, int off_sig, int off_gt1,
                    int off_gt2) {
  Encoder *e = new Encoder();
  e->state.assign(states, states + n_ctx);
  e->mps.assign(mps, mps + n_ctx);
  e->off = {off_last, off_csbf, off_sig, off_gt1, off_gt2};
  e->out.reserve(1 << 16);
  return e;
}

void cabac_enc_free(void *h) { delete (Encoder *)h; }

void cabac_enc_bin(void *h, int ctx, int bin) {
  ((Encoder *)h)->encode_bin(ctx, bin);
}
void cabac_enc_bypass(void *h, int bin) { ((Encoder *)h)->encode_bypass(bin); }
void cabac_enc_bypass_bits(void *h, uint32_t v, int n) {
  ((Encoder *)h)->encode_bypass_bits(v, n);
}
void cabac_enc_terminate(void *h, int bin) {
  ((Encoder *)h)->encode_terminate(bin);
}
int cabac_enc_finish(void *h, uint32_t *trail) {
  return ((Encoder *)h)->finish(trail);
}
void cabac_enc_residual(void *h, const int32_t *levels, int lg, int c_idx,
                        int scan_idx, int sdh) {
  encode_residual((Encoder *)h, levels, lg, c_idx, scan_idx, sdh);
}
int cabac_enc_size(void *h) { return (int)((Encoder *)h)->out.size(); }
void cabac_enc_copy(void *h, uint8_t *dst) {
  Encoder *e = (Encoder *)h;
  std::memcpy(dst, e->out.data(), e->out.size());
}

}  // extern "C"
