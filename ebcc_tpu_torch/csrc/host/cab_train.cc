/* ebcc_tpu_torch: the port's copy of ebcc_tpu/native/cab_train.cc, unchanged below
 * this line; its profile shapes only the coder's speed. */
/* PGO trainer for the CAB coders: exercises both profiles' hot paths
 * (skip tiers, run mode, significance clusters, refinement, signs) on
 * synthetic wavelet-like payloads across density regimes.  Run between
 * the -fprofile-generate and -fprofile-use build passes (see
 * native/__init__.py build()); measured ~10% on the real ERA5 payloads.
 */

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
size_t etpu_cab_compress(const uint8_t *, size_t, int, int, int, int, int,
                         uint8_t **);
size_t etpu_cab_decompress(const uint8_t *, size_t, int, int, int, int, int,
                           uint8_t *, size_t);
size_t etpu_cab2_compress(const uint8_t *, size_t, int, int, int, int, int,
                          uint8_t **);
size_t etpu_cab2_decompress(const uint8_t *, size_t, int, int, int, int, int,
                            uint8_t *, size_t);
}

namespace {

uint32_t g_state = 0x1234567u;
inline uint32_t rnd() {
  g_state = g_state * 1664525u + 1013904223u;
  return g_state;
}

/* Wavelet-flavored payload: clustered magnitudes whose density grows
 * toward fine subbands, like a real residual layer. */
std::vector<uint8_t> make_payload(int kept, int d0, int hp, int wp,
                                  int permille) {
  const int wb = wp / 8;
  const size_t plane_bytes = (size_t)d0 * hp * wb;
  std::vector<uint8_t> payload((size_t)(kept + 1) * plane_bytes, 0);
  std::vector<int> mag((size_t)d0 * hp * wp, 0);
  for (int f = 0; f < d0; ++f)
    for (int r = 0; r < hp; ++r)
      for (int c = 0; c < wp; ++c) {
        /* density ramps with position (coarse bands sparser) */
        const int local = permille * (1 + (r * 2) / hp + (c * 2) / wp);
        if ((int)(rnd() % 4000) < local) {
          const size_t i = (size_t)f * hp * wp + (size_t)r * wp + c;
          mag[i] = 1 + (int)(rnd() % ((1u << (kept - 1)) - 1));
          /* cluster: drag a neighbor along half the time */
          if ((rnd() & 1) && c + 1 < wp) mag[i + 1] = 1 + (int)(rnd() % 7);
        }
      }
  for (int s = 0; s < kept; ++s) {
    const int bit = kept - 1 - s;
    for (size_t i = 0; i < mag.size(); ++i)
      if ((mag[i] >> bit) & 1)
        payload[(size_t)s * plane_bytes + i / 8] |=
            (uint8_t)(1u << (7 - (i % 8)));
  }
  for (size_t i = 0; i < mag.size(); ++i)
    if (mag[i] && (rnd() & 1))
      payload[(size_t)kept * plane_bytes + i / 8] |=
          (uint8_t)(1u << (7 - (i % 8)));
  return payload;
}

}  // namespace

int main() {
  const int kept = 13, levels = 5;
  long total = 0;
  for (int reg = 0; reg < 3; ++reg) {
    const int d0 = reg == 2 ? 2 : 1;
    const int hp = reg == 0 ? 736 : 256;
    const int wp = reg == 0 ? 1440 : 512;
    const int permille = reg == 0 ? 25 : (reg == 1 ? 5 : 120);
    std::vector<uint8_t> payload = make_payload(kept, d0, hp, wp, permille);
    for (int prof = 0; prof < 2; ++prof) {
      auto C = prof ? etpu_cab2_compress : etpu_cab_compress;
      auto D = prof ? etpu_cab2_decompress : etpu_cab_decompress;
      uint8_t *out = nullptr;
      const size_t n = C(payload.data(), payload.size(), kept, d0, hp, wp,
                         levels, &out);
      if (n == 0) return 1;
      std::vector<uint8_t> back(payload.size());
      if (D(out, n, kept, d0, hp, wp, levels, back.data(), back.size()) !=
          payload.size())
        return 1;
      if (std::memcmp(back.data(), payload.data(), payload.size())) return 1;
      total += (long)n;
      std::free(out);
    }
  }
  std::printf("%ld\n", total);
  return 0;
}
