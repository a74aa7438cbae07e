/* ebcc_tpu_torch: the port's copy of ebcc_tpu/native/rice_decode.cc, unchanged below
 * this line; the exchange's words must stay the original's. */
/* Host-side decoder for the device-packed Rice value exchange
 * (ebcc_tpu/core/transfer.py::rice_pack).  Layout: words[0] = total payload
 * bits, words[1] = rice parameter k, then an LSB-first bit stream of
 * zigzag-coded values: min(q, ESC) one-bits, then either (q < ESC) a zero
 * terminator + k remainder bits, or (escape) 32 raw bits of z.
 *
 * This runs in the encode fetch path (~0.5-2M values per batch), so it is a
 * branch-light sequential loop reading a 64-bit window.
 */

#include <cstdint>
#include <cstring>

namespace {
constexpr int kEsc = 20;
constexpr int kHeaderWords = 2;

struct BitReader {
  const uint32_t *words;
  size_t n_words;
  size_t word_pos = kHeaderWords;
  uint64_t window = 0;
  int bits = 0;

  void fill() {
    while (bits <= 32 && word_pos < n_words) {
      window |= (uint64_t)words[word_pos++] << bits;
      bits += 32;
    }
  }
  inline uint32_t take(int n) {
    if (bits < n) fill();
    const uint32_t v = (uint32_t)(window & ((n == 32) ? 0xFFFFFFFFull
                                                      : ((1ull << n) - 1)));
    window >>= n;
    bits -= n;
    return v;
  }
  inline int count_ones_then_zero(int cap) {
    int q = 0;
    while (q < cap) {
      if (bits == 0) fill();
      if (bits == 0) return -1; /* exhausted */
      if (window & 1) {
        window >>= 1;
        bits -= 1;
        ++q;
      } else {
        if (q < cap) { /* consume the zero terminator */
          window >>= 1;
          bits -= 1;
        }
        return q;
      }
    }
    return q; /* hit cap: escape, no terminator */
  }
};
}  // namespace

extern "C" {

/* -> nnz on success, 0 on error. out must hold nnz int32. */
size_t etpu_rice_decode(const uint32_t *words, size_t n_words, size_t nnz,
                        int32_t *out) {
  if (n_words < kHeaderWords) return 0;
  const uint32_t k = words[1];
  if (k > 15) return 0;
  BitReader br{words, n_words};
  for (size_t i = 0; i < nnz; ++i) {
    const int q = br.count_ones_then_zero(kEsc);
    if (q < 0) return 0;
    uint32_t z;
    if (q >= kEsc) {
      z = br.take(32);
    } else {
      const uint32_t rem = k ? br.take((int)k) : 0;
      z = ((uint32_t)q << k) | rem;
    }
    out[i] = (int32_t)(z >> 1) ^ -(int32_t)(z & 1); /* un-zigzag */
  }
  return nnz;
}

/* Classed variant: per-element Rice parameter ks[cls[i]] (the value stream
 * of the pair exchange codes each coefficient with its subband class's k —
 * wavelet magnitudes vary by orders of magnitude across levels, so a
 * global k wastes ~4 bits/value on ERA5 data).  Header word 1 is ignored;
 * the caller passes the unpacked k table.  -> nnz on success, 0 on error. */
size_t etpu_rice_decode_classed(const uint32_t *words, size_t n_words,
                                size_t nnz, const uint8_t *cls,
                                const uint8_t *ks, int32_t *out) {
  if (n_words < kHeaderWords) return 0;
  BitReader br{words, n_words};
  for (size_t i = 0; i < nnz; ++i) {
    const uint32_t k = ks[cls[i] & 7];
    if (k > 15) return 0;
    const int q = br.count_ones_then_zero(kEsc);
    if (q < 0) return 0;
    uint32_t z;
    if (q >= kEsc) {
      z = br.take(32);
    } else {
      const uint32_t rem = k ? br.take((int)k) : 0;
      z = ((uint32_t)q << k) | rem;
    }
    out[i] = (int32_t)(z >> 1) ^ -(int32_t)(z & 1); /* un-zigzag */
  }
  return nnz;
}

/* Gap stream with PREVIOUS-position subband classing: gap i is coded with
 * ks[class(pos_{i-1})] (class(0) for i = 0), where class = clip(min(
 * floor_log2(hp/(r+1)), floor_log2(wp/(c+1))), 0, 7) on the padded grid —
 * the identical integer-exact formula the device packer and
 * transfer.coeff_class use.  Returns POSITIONS (cumulative), not gaps.
 * -> nnz on success, 0 on error. */
size_t etpu_rice_decode_gaps_classed(const uint32_t *words, size_t n_words,
                                     size_t nnz, int hp, int wp,
                                     const uint8_t *ks, int32_t *out_pos) {
  if (n_words < kHeaderWords || hp <= 0 || wp <= 0) return 0;
  BitReader br{words, n_words};
  int64_t pos = -1;
  for (size_t i = 0; i < nnz; ++i) {
    const int64_t ref = pos < 0 ? 0 : pos;
    const int r = (int)((ref / wp) % hp);
    const int c = (int)(ref % wp);
    const int lr = 31 - __builtin_clz((uint32_t)(hp / (r + 1)));
    const int lc = 31 - __builtin_clz((uint32_t)(wp / (c + 1)));
    int cls = lr < lc ? lr : lc;
    if (cls > 7) cls = 7;
    const uint32_t k = ks[cls];
    if (k > 15) return 0;
    const int q = br.count_ones_then_zero(kEsc);
    if (q < 0) return 0;
    uint32_t z;
    if (q >= kEsc) {
      z = br.take(32);
    } else {
      const uint32_t rem = k ? br.take((int)k) : 0;
      z = ((uint32_t)q << k) | rem;
    }
    const int32_t gap = (int32_t)(z >> 1) ^ -(int32_t)(z & 1);
    pos += (int64_t)gap + 1;
    if (pos < 0 || pos > 0x7FFFFFFF) return 0;
    out_pos[i] = (int32_t)pos;
  }
  return nnz;
}

}  /* extern "C" */
