/* ebcc_tpu_torch: the port's copy of ebcc_tpu/native/sparse_unpack.cc, unchanged below
 * this line; CAB bytes and stream bytes must stay the original's. */
/* Host-side planes -> sparse (index, value) extraction for the decode
 * direction of the exchange (ebcc_tpu/core/codec.py::_decode_streams_device).
 *
 * The stream payload is a dense bitplane stack, but its information is
 * sparse: only coefficients significant at the stream cut carry bits.  The
 * numpy unpack (per-plane unpackbits + shift accumulate over the dense
 * grid) costs dense-size work per batch; this routine walks the planes
 * byte-column-wise, ORs the kept rows to skip all-zero byte columns (the
 * common case at typical bounds), and emits compacted (position, signed
 * magnitude-at-cut) pairs directly — element work scales with the
 * significant count, byte work with the grid/8.
 *
 * Layout contract (mirrors core/stream.py + FLAG_BASE_PARTIAL): raw =
 * [kept-1 full plane rows][partial row: pb bytes][sign plane row], with
 * pb == plane_bytes for ordinary payloads.
 */

#include <cstddef>
#include <cstdint>

extern "C" {

/* -> number of pairs written.  idx_out/val_out must hold d0*hp*wp entries.
 * Returns (size_t)-1 on malformed sizes. */
size_t etpu_planes_to_sparse(const uint8_t *raw, size_t raw_len, int kept,
                             size_t pb, int d0, int hp, int wp,
                             int32_t *idx_out, int32_t *val_out) {
  if (kept <= 0 || wp % 8 != 0) return (size_t)-1;
  const size_t plane_bytes = (size_t)d0 * hp * (wp / 8);
  const int full = kept - 1;
  if (pb > plane_bytes) return (size_t)-1;
  if (raw_len != (size_t)full * plane_bytes + pb + plane_bytes)
    return (size_t)-1;
  const uint8_t *signs = raw + (size_t)full * plane_bytes + pb;
  const uint8_t *last = raw + (size_t)full * plane_bytes;

  size_t k = 0;
  for (size_t byte = 0; byte < plane_bytes; ++byte) {
    uint8_t any = byte < pb ? last[byte] : 0;
    for (int s = 0; s < full; ++s) any |= raw[(size_t)s * plane_bytes + byte];
    if (!any) continue;
    const uint8_t lastb = byte < pb ? last[byte] : 0;
    const uint8_t signb = signs[byte];
    for (int bit = 0; bit < 8; ++bit) {
      const uint8_t mask = (uint8_t)(1u << (7 - bit));
      if (!(any & mask)) continue;
      uint32_t mag = 0;
      for (int s = 0; s < full; ++s)
        mag = (mag << 1) | ((raw[(size_t)s * plane_bytes + byte] & mask)
                                ? 1u : 0u);
      mag = (mag << 1) | ((lastb & mask) ? 1u : 0u);
      /* any==1 guarantees mag != 0 */
      idx_out[k] = (int32_t)(byte * 8 + bit);
      val_out[k] = (signb & mask) ? -(int32_t)mag : (int32_t)mag;
      ++k;
    }
  }
  return k;
}

/* Inverse direction: sparse (position, signed value) pairs -> the dense
 * packed bitplane payload (the exact layout build_layer_payload in
 * core/codec.py emits: msb full magnitude rows MSB-first, then the sign
 * plane masked to nonzero magnitudes).  The numpy path materializes the
 * dense int32 grid and runs packbits per plane (~dense-size work per
 * candidate); element work here scales with the significant count — the
 * grid only pays one memset.
 *
 * pos: flat coefficient positions in [0, d0*hp*wp); val: signed values at
 * stored_cut; shift = cut - stored_cut >= 0; msb = bit length of
 * max(|val| >> shift) (computed by the caller, numpy max is cheap).
 * payload_out must hold (msb + 1) * (d0*hp*wp/8) bytes.  Returns 0 on
 * success, -1 on bad geometry. */
int etpu_sparse_to_planes(const int32_t *pos, const int32_t *val, size_t n,
                          int shift, int msb, int d0, int hp, int wp,
                          uint8_t *payload_out) {
  if (wp % 8 != 0 || msb <= 0 || shift < 0 || shift > 30) return -1;
  const size_t plane_bytes = (size_t)d0 * hp * (wp / 8);
  const size_t total = (size_t)(msb + 1) * plane_bytes;
  for (size_t i = 0; i < total; ++i) payload_out[i] = 0;
  uint8_t *signs = payload_out + (size_t)msb * plane_bytes;
  for (size_t i = 0; i < n; ++i) {
    const int32_t v = val[i];
    uint32_t mag = (uint32_t)(v < 0 ? -(int64_t)v : v) >> shift;
    if (!mag) continue;
    const uint32_t p = (uint32_t)pos[i];
    const size_t byte = p >> 3;
    const uint8_t mask = (uint8_t)(1u << (7 - (p & 7u)));
    /* plane row r holds bit (msb - 1 - r) of the magnitude */
    while (mag) {
      const int s = 31 - __builtin_clz(mag);
      payload_out[(size_t)(msb - 1 - s) * plane_bytes + byte] |= mask;
      mag &= ~(1u << s);
    }
    if (v < 0) signs[byte] |= mask;
  }
  return 0;
}

} /* extern "C" */
