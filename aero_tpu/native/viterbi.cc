// Host-side soft-decision Viterbi for the Aero-L convolutional code.
//
// Native replacement for the reference's libcorrect dependency
// (ref: decode/jconvolutionalcodec.cpp:10-16 — K=7, rate 1/2, polys
// {109, 79}).  Used by the per-VFO host deframers for single-frame decodes
// where a JAX dispatch would dominate; batched device decodes use the
// lax.scan decoder (aero_tpu/protocol/batch_framing.py) instead.
//
// Convention matches aero_tpu.protocol.viterbi: shift register takes the
// newest bit at the LSB, output bit i = parity(reg & poly[i]), soft bytes
// 0..255 with 255 = strong one; uniform initial metrics; traceback from the
// best end state.
//
// Build: g++ -O3 -shared -fPIC -o libaeroviterbi.so viterbi.cc

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kStates = 64;
constexpr uint32_t kPoly0 = 109;
constexpr uint32_t kPoly1 = 79;

inline int parity(uint32_t x) { return __builtin_parity(x); }

struct Tables {
  // for next-state ns: predecessors (ns>>1) and (ns>>1)+32; expected output
  // pair per (pred, input-bit ns&1)
  uint8_t pattern[kStates][2];
  Tables() {
    for (int ns = 0; ns < kStates; ns++) {
      int b = ns & 1;
      int preds[2] = {ns >> 1, (ns >> 1) | 0x20};
      for (int j = 0; j < 2; j++) {
        uint32_t reg = ((preds[j] << 1) | b) & 0x7F;
        pattern[ns][j] =
            static_cast<uint8_t>(parity(reg & kPoly0) * 2 + parity(reg & kPoly1));
      }
    }
  }
};

const Tables kTables;

}  // namespace

extern "C" {

// soft: n_soft bytes (n_soft even); bits_out: n_soft/2 bytes (0/1).
// Returns the number of decoded bits.
int aero_viterbi_decode_soft(const uint8_t* soft, int n_soft,
                             uint8_t* bits_out) {
  const int T = n_soft / 2;
  if (T <= 0) return 0;

  std::vector<float> pm(kStates, 0.0f), pm_new(kStates);
  std::vector<uint8_t> surv(static_cast<size_t>(T) * kStates);

  for (int t = 0; t < T; t++) {
    const float s0 = soft[2 * t];
    const float s1 = soft[2 * t + 1];
    // branch metric per expected dibit: |s - e*255| L1
    const float bm[4] = {s0 + s1, s0 + (255.0f - s1), (255.0f - s0) + s1,
                         (255.0f - s0) + (255.0f - s1)};
    float best = 1e30f;
    uint8_t* sv = &surv[static_cast<size_t>(t) * kStates];
    for (int ns = 0; ns < kStates; ns++) {
      const int p0 = ns >> 1;
      const int p1 = p0 | 0x20;
      const float c0 = pm[p0] + bm[kTables.pattern[ns][0]];
      const float c1 = pm[p1] + bm[kTables.pattern[ns][1]];
      const bool take1 = c1 < c0;
      const float v = take1 ? c1 : c0;
      pm_new[ns] = v;
      sv[ns] = take1 ? 1 : 0;
      if (v < best) best = v;
    }
    for (int ns = 0; ns < kStates; ns++) pm[ns] = pm_new[ns] - best;
  }

  int state = 0;
  float best = pm[0];
  for (int ns = 1; ns < kStates; ns++)
    if (pm[ns] < best) { best = pm[ns]; state = ns; }

  for (int t = T - 1; t >= 0; t--) {
    bits_out[t] = static_cast<uint8_t>(state & 1);
    const int j = surv[static_cast<size_t>(t) * kStates + state];
    state = (state >> 1) | (j ? 0x20 : 0);
  }
  return T;
}

// Batched variant: n_streams rows of n_soft bytes each.
int aero_viterbi_decode_soft_batch(const uint8_t* soft, int n_streams,
                                   int n_soft, uint8_t* bits_out) {
  for (int b = 0; b < n_streams; b++) {
    aero_viterbi_decode_soft(soft + static_cast<size_t>(b) * n_soft, n_soft,
                             bits_out + static_cast<size_t>(b) * (n_soft / 2));
  }
  return n_streams;
}

}  // extern "C"
