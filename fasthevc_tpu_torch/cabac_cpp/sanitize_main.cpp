// Sanitizer self-test driver for the native engine (SURVEY.md §5.2).
//
// Built with -fsanitize=address,undefined by cabac_cpp.build_sanitized()
// and run as a subprocess from tests/test_aux.py: exercises the CABAC bin
// engine, the residual-coding writer across every TU size/component/scan,
// and the deblocking filter on random pictures. Any heap overflow, OOB
// read, or UB in the hot paths aborts the process with a sanitizer report.
//
// The reference (single-threaded HM-derived C++) has no sanitizer harness;
// standard practice is flag injection into its CMake build — this is the
// equivalent for our engine.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
void *cabac_enc_new(const uint8_t *states, const uint8_t *mps, int n_ctx,
                    int off_last, int off_csbf, int off_sig, int off_gt1,
                    int off_gt2);
void cabac_enc_free(void *h);
void cabac_enc_bin(void *h, int ctx, int bin);
void cabac_enc_bypass(void *h, int bin);
void cabac_enc_bypass_bits(void *h, uint32_t v, int n);
void cabac_enc_terminate(void *h, int bin);
int cabac_enc_finish(void *h, uint32_t *trail);
void cabac_enc_residual(void *h, const int32_t *levels, int lg, int c_idx,
                        int scan_idx, int sdh);
int cabac_enc_size(void *h);
void cabac_enc_copy(void *h, uint8_t *dst);
void hevc_deblock_picture(int32_t *rec_y, int32_t *rec_cb, int32_t *rec_cr,
                          int coded_w, int coded_h, int log2_ctu,
                          int log2_max_tu, int bit_depth, int slice_qp,
                          int qp_cb, int qp_cr, const int8_t *depth_map,
                          const int32_t *mf_mv, const int32_t *mf_ref,
                          const uint8_t *mf_cbf);
}

static uint32_t rng_state = 12345;
static uint32_t rnd() {  // xorshift32 — deterministic across runs
  uint32_t x = rng_state;
  x ^= x << 13; x ^= x >> 17; x ^= x << 5;
  return rng_state = x;
}

int main(int argc, char **argv) {
  int n_ctx = argc > 1 ? atoi(argv[1]) : 200;
  std::vector<uint8_t> states(n_ctx), mps(n_ctx);
  for (int i = 0; i < n_ctx; i++) {
    states[i] = rnd() % 63;
    mps[i] = rnd() & 1;
  }
  // offsets into the ctx array for the residual coder's families; keep
  // them in-range for the largest family (last_sig needs 18 per cmp)
  int off_last = 0, off_csbf = 40, off_gt1 = 50, off_gt2 = 80,
      off_sig = 90;

  // 1) random bin streams through the arithmetic engine
  for (int trial = 0; trial < 50; trial++) {
    void *h = cabac_enc_new(states.data(), mps.data(), n_ctx, off_last,
                            off_csbf, off_sig, off_gt1, off_gt2);
    int n = 100 + (int)(rnd() % 4000);
    for (int i = 0; i < n; i++) {
      switch (rnd() % 4) {
        case 0: cabac_enc_bin(h, (int)(rnd() % n_ctx), rnd() & 1); break;
        case 1: cabac_enc_bypass(h, rnd() & 1); break;
        case 2: cabac_enc_bypass_bits(h, rnd(), 1 + (int)(rnd() % 31)); break;
        default: cabac_enc_terminate(h, 0); break;
      }
    }
    cabac_enc_terminate(h, 1);
    uint32_t trail = 0;
    cabac_enc_finish(h, &trail);
    std::vector<uint8_t> out(cabac_enc_size(h));
    if (!out.empty()) cabac_enc_copy(h, out.data());
    cabac_enc_free(h);
  }

  // 2) residual coding: every TU size x component x scan, random levels
  //    (sparse and dense, extreme magnitudes to hit the EG escape paths)
  for (int lg = 2; lg <= 5; lg++) {
    int n = 1 << lg, nn = n * n;
    std::vector<int32_t> levels(nn);
    for (int c_idx = 0; c_idx < 3; c_idx++) {
      for (int scan = 0; scan < 3; scan++) {
        if (lg > 3 && scan != 0) continue;  // h/v scans are 4x4/8x8 only
        for (int sdh = 0; sdh <= 1; sdh++) {
          for (int density = 0; density < 3; density++) {
            void *h = cabac_enc_new(states.data(), mps.data(), n_ctx,
                                    off_last, off_csbf, off_sig, off_gt1,
                                    off_gt2);
            bool any = false;
            for (int i = 0; i < nn; i++) {
              bool on = (rnd() % 100) < (density == 0 ? 5 : density == 1 ? 50 : 100);
              int32_t mag = density == 2 ? (int32_t)(rnd() % 32767)
                                         : (int32_t)(rnd() % 20);
              levels[i] = on && mag ? ((rnd() & 1) ? mag : -mag) : 0;
              any |= levels[i] != 0;
            }
            if (!any) levels[0] = 1;
            cabac_enc_residual(h, levels.data(), lg, c_idx, scan, sdh);
            uint32_t trail = 0;
            cabac_enc_terminate(h, 1);
            cabac_enc_finish(h, &trail);
            cabac_enc_free(h);
          }
        }
      }
    }
  }

  // 3) deblocking on random pictures (odd CTU counts, both CTU sizes)
  for (int cfgi = 0; cfgi < 4; cfgi++) {
    int log2_ctu = (cfgi & 1) ? 6 : 5;
    int w = (cfgi & 2) ? 96 : 160, h = 64;
    std::vector<int32_t> y(w * h), cb(w * h / 4), cr(w * h / 4);
    for (auto &v : y) v = rnd() % 256;
    for (auto &v : cb) v = rnd() % 256;
    for (auto &v : cr) v = rnd() % 256;
    std::vector<int8_t> depth((w >> 3) * (h >> 3));
    for (auto &v : depth) v = (int8_t)(rnd() % 3);
    hevc_deblock_picture(y.data(), cb.data(), cr.data(), w, h, log2_ctu, 5,
                         8, 32, 33, 33, depth.data(), nullptr, nullptr,
                         nullptr);
  }

  printf("sanitize_main OK\n");
  return 0;
}
