/* ebcc_tpu_torch: the port's copy of ebcc_tpu/native/rice_block_pack.cc, unchanged below
 * this line; the exchange's words must stay the original's. */
/* Host-side packer for the blocked-Rice decode-direction upload
 * (ebcc_tpu/core/transfer.py::rice_block_pack_host is the numpy reference
 * implementation; this is the production path — the numpy version holds
 * the GIL across ~30 vector temporaries and degrades ~17x under the
 * pipeline's thread contention on small hosts).
 *
 * Layout contract (must match transfer.rice_block_unpack):
 *   - elements are split into blocks of `block` entries; lanes [0, nb)
 *     carry position GAPS coded RAW (non-negative), lanes [nb, 2nb) carry
 *     ZIGZAG values;
 *   - per lane one Rice parameter k (gap k low nibble of k_packed[b],
 *     value k high nibble), chosen as clip(floor(log2(mean+1)), 0, 11);
 *   - codes: q = z >> k unary ones; if q < 20: zero terminator then k
 *     remainder bits; else exactly 20 ones then 32 raw bits of z;
 *   - one continuous LSB-first bit stream: all gap blocks back-to-back
 *     from bit 0, value blocks immediately after (no alignment) — the
 *     device derives lane offsets by cumsum of the u16 block bit lengths;
 *   - base_pos[b] = position preceding gap block b (-1 for block 0).
 */

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kEsc = 20;

struct BitWriter {
  uint32_t *words;
  uint64_t acc = 0;
  int bits = 0;
  size_t word_pos = 0;

  inline void put_le32(uint64_t code, int len) {
    /* code < 2^32 and bits < 32, so code << bits fits 64 bits */
    acc |= code << bits;
    bits += len;
    while (bits >= 32) {
      words[word_pos++] = (uint32_t)acc;
      acc >>= 32;
      bits -= 32;
    }
  }
  inline void put(uint64_t code, int len) {
    if (len > 32) {
      put_le32(code & 0xFFFFFFFFull, 32);
      put_le32(code >> 32, len - 32);
    } else {
      put_le32(code & 0xFFFFFFFFull, len);
    }
  }
  inline void flush() {
    if (bits > 0) {
      words[word_pos++] = (uint32_t)acc;
      acc = 0;
      bits = 0;
    }
  }
};

inline uint32_t pick_k(const uint64_t *z, size_t n) {
  if (n == 0) return 0;
  uint64_t sum = 0;
  for (size_t i = 0; i < n; ++i) sum += z[i];
  const double mean = (double)sum / (double)n;
  double k = std::floor(std::log2(mean + 1.0));
  if (k < 0) k = 0;
  if (k > 31 - kEsc) k = 31 - kEsc;
  return (uint32_t)k;
}

inline void write_block(BitWriter &bw, const uint64_t *z, size_t n,
                        uint32_t k, uint64_t *bits_out) {
  const uint64_t start = bw.word_pos * 32ull + (uint64_t)bw.bits;
  for (size_t i = 0; i < n; ++i) {
    const uint64_t q = z[i] >> k;
    if (q >= (uint64_t)kEsc) {
      /* 20 ones then 32 raw bits (52 <= 64: single put) */
      bw.put(((z[i] & 0xFFFFFFFFull) << kEsc) | ((1ull << kEsc) - 1),
             kEsc + 32);
    } else {
      const uint64_t rem = z[i] & ((1ull << k) - 1);
      bw.put((rem << (q + 1)) | ((1ull << q) - 1), (int)(q + 1 + k));
    }
  }
  *bits_out = bw.word_pos * 32ull + (uint64_t)bw.bits - start;
}

}  // namespace

extern "C" {

/* words must hold >= (104*n)/32 + 4 entries (52-bit worst case per code,
 * two streams).  Returns words used (>= 1), or 0 on error (block length
 * overflowing u16, which cannot happen for block <= 1024). */
size_t etpu_rice_block_pack(const int64_t *idx, const int32_t *vals,
                            size_t n, int block, uint32_t *words,
                            uint16_t *lens_g, uint16_t *lens_v,
                            uint8_t *k_packed, int32_t *base_pos) {
  if (block <= 0 || block > 1024) return 0;
  const size_t nb = n ? (n + block - 1) / block : 1;
  /* per-block scratch (block <= 1024) */
  uint64_t zg[1024], zv[1024];
  uint32_t kg_all[4096];
  uint32_t *kg_heap = nullptr;
  uint32_t *kg = kg_all;
  if (nb > 4096) {
    kg_heap = new uint32_t[nb];
    kg = kg_heap;
  }

  BitWriter bw{words};
  /* gap stream first */
  int64_t prev = -1;
  for (size_t b = 0; b < nb; ++b) {
    const size_t lo = b * block;
    const size_t hi = lo + (size_t)block < n ? lo + block : n;
    base_pos[b] = (int32_t)prev;
    for (size_t i = lo; i < hi; ++i) {
      zg[i - lo] = (uint64_t)(idx[i] - prev - 1);
      prev = idx[i];
    }
    const uint32_t k = pick_k(zg, hi - lo);
    kg[b] = k;
    uint64_t bits = 0;
    write_block(bw, zg, hi - lo, k, &bits);
    if (bits > 0xFFFF) { delete[] kg_heap; return 0; }
    lens_g[b] = (uint16_t)bits;
  }
  /* value stream immediately after (no alignment) */
  for (size_t b = 0; b < nb; ++b) {
    const size_t lo = b * block;
    const size_t hi = lo + (size_t)block < n ? lo + block : n;
    for (size_t i = lo; i < hi; ++i) {
      const int32_t v = vals[i];
      zv[i - lo] = ((uint32_t)v << 1) ^ (uint32_t)(v >> 31);
    }
    const uint32_t k = pick_k(zv, hi - lo);
    k_packed[b] = (uint8_t)(kg[b] | (k << 4));
    uint64_t bits = 0;
    write_block(bw, zv, hi - lo, k, &bits);
    if (bits > 0xFFFF) { delete[] kg_heap; return 0; }
    lens_v[b] = (uint16_t)bits;
  }
  bw.flush();
  delete[] kg_heap;
  if (bw.word_pos == 0) {
    words[0] = 0; /* n == 0: hand back a defined (zero) word, not
                     whatever the caller's np.empty held */
    return 1;
  }
  return bw.word_pos;
}

}  /* extern "C" */
