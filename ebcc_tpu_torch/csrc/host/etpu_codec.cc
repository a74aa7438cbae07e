/* ebcc_tpu_torch: the port's copy of ebcc_tpu/native/etpu_codec.cc, unchanged below
 * this line but for zstd_decls.h in place of <zstd.h>; same bytes. */
/* Portable C++ ETPU/ETPK codec — see etpu_codec.h for the role statement.
 *
 * Algorithm parity with the JAX encoder (ebcc_tpu/core/kernels.py), itself
 * a re-expression of the reference pipeline (reference src/ebcc_codec.c:
 * ebcc_encode 607-918): two-layer base+residual coding with monotone
 * cut scans instead of re-encode bisections, quantile-relaxed base layer,
 * centered (post-mean-adjustment) feasibility, pure-base fallback
 * comparison, const-field shortcut, residual drop rule.
 * This implementation is serial per chunk, like the reference codec.
 */

#include "etpu_codec.h"

#include "zstd_decls.h"

extern "C" size_t etpu_cab2_compress(const uint8_t *, size_t, int, int, int,
                                     int, int, uint8_t **);
extern "C" size_t etpu_cab2_decompress(const uint8_t *, size_t, int, int, int,
                                       int, int, uint8_t *, size_t);
extern "C" size_t etpu_cab_compress(const uint8_t *, size_t, int, int, int,
                                    int, int, uint8_t **);
extern "C" size_t etpu_cab_decompress(const uint8_t *, size_t, int, int, int,
                                      int, int, uint8_t *, size_t);

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <limits>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

constexpr int kBaseNumPlanes = 22;
constexpr int kResNumPlanes = 12;
constexpr int kBaseLevels = 5;
constexpr int kResLevels = 3;
constexpr float kBaseScale = 65535.0f;
constexpr float kResScale = 255.0f;
/* Normative inter-decoder divergence allowance (docs/FORMAT.md "Decoder
 * conformance"; JAX mirror: core/kernels.py DECODER_EPS_REL): feasibility
 * is verified at target minus this fraction of the chunk range so the
 * shipped bound holds for every conforming decoder pairing. */
constexpr float kDecoderEpsRel = 4e-6f;
constexpr int kMinDim = 32;
constexpr int kMaxDim = 2047;
constexpr size_t kHeaderSize = 72;
constexpr uint8_t kFlagConst = 0x01;
constexpr uint8_t kFlagResidual = 0x02;
constexpr uint8_t kFlagMeanAdjusted = 0x04;
/* Rate-mode byte-granular rate control: the base payload's LAST plane is a
 * prefix of the next-finer plane (length implied by the decompressed
 * size); header base_cut is the finer cut.  See core/stream.py. */
constexpr uint8_t kFlagBasePartial = 0x08;
/* Temporal (closed-loop predictive) chunk: base/res layers describe frame
 * 0 only; a delta section (16-byte records + payloads) follows the res
 * payload.  See core/stream.py and docs/FORMAT.md. */
constexpr uint8_t kFlagTemporal = 0x10;
/* Masked chunk (allow_nan): NaN input samples were replaced by a per-frame
 * fill before encoding; the stream's LAST section (after the delta section
 * when temporal) is an entropy-coded packbits bitmap (MSB-first) of the
 * invalid positions — decode restores NaN there.  Beyond reference (which
 * hard-exits on NaN, check_nan_inf ebcc_codec.c:598-605). */
constexpr uint8_t kFlagMasked = 0x20;
/* Log-domain chunk (pointwise-relative mode 3): payloads encode log(x)
 * under a max-error bound of log1p(eps) - kLogMargin; decode applies
 * exp() as the final arithmetic step, guaranteeing |x̂-x| <= eps*|x| on
 * every sample.  Beyond reference (its enum stops at range-relative). */
constexpr uint8_t kFlagLogDomain = 0x40;
/* Lossless chunk (mode 4): base payload = order-preserving-mapped f32
 * bits, 1-D wrapping-delta coded, entropy-coded; bit-exact round trip
 * (NaN/Inf included).  Beyond reference. */
constexpr uint8_t kFlagLossless = 0x80;
/* Mirrors codec.py _LOG_MARGIN: f32 log/exp rounding on both sides, the
 * log leg scaling with |log x| <= 89 for any finite positive float. */
constexpr float kLogMargin = 1.3e-7f * (89.0f + 2.0f);
constexpr size_t kDeltaRecordSize = 16;
constexpr int kBackendStore = 0;
constexpr int kBackendZstd = 1;
constexpr int kBackendCab = 2;
constexpr int kBackendCab2 = 4; /* relaxed-eligibility profile */
constexpr size_t kResidualDropBytes = 16;

/* CDF 9/7 lifting constants (shared with ebcc_tpu/ops/dwt.py). */
constexpr float kAlpha = -1.586134342f;
constexpr float kBeta = -0.05298011854f;
constexpr float kGamma = 0.8829110762f;
constexpr float kDelta = 0.44355068522f;
constexpr float kXi = 1.149604398f;

void log_err(const char *msg) { std::fprintf(stderr, "[etpu] %s\n", msg); }

/* ------------------------------------------------------------------ */
/* 1-D lifting along a strided axis, matching ops/dwt.py exactly:     */
/*   predict: o[i] += c*(e[i] + e[i+1])   (e end-replicated)          */
/*   update:  e[i] += c*(o[i-1] + o[i])   (o front-replicated)        */
/* forward output layout: [lowpass*XI | highpass/XI] halves.          */
/* ------------------------------------------------------------------ */

void dwt1d(float *x, int n, int stride, float *tmp) {
  const int h = n / 2;
  for (int i = 0; i < h; ++i) {
    tmp[i] = x[(2 * i) * stride];      /* even */
    tmp[h + i] = x[(2 * i + 1) * stride]; /* odd */
  }
  float *e = tmp, *o = tmp + h;
  for (int i = 0; i < h; ++i) {
    const float en = e[std::min(i + 1, h - 1)];
    o[i] += kAlpha * (e[i] + en);
  }
  for (int i = 0; i < h; ++i) {
    const float op = o[std::max(i - 1, 0)];
    e[i] += kBeta * (op + o[i]);
  }
  for (int i = 0; i < h; ++i) {
    const float en = e[std::min(i + 1, h - 1)];
    o[i] += kGamma * (e[i] + en);
  }
  for (int i = 0; i < h; ++i) {
    const float op = o[std::max(i - 1, 0)];
    e[i] += kDelta * (op + o[i]);
  }
  for (int i = 0; i < h; ++i) x[i * stride] = e[i] * kXi;
  for (int i = 0; i < h; ++i) x[(h + i) * stride] = o[i] * (1.0f / kXi);
}

void idwt1d(float *x, int n, int stride, float *tmp) {
  const int h = n / 2;
  float *e = tmp, *o = tmp + h;
  for (int i = 0; i < h; ++i) e[i] = x[i * stride] * (1.0f / kXi);
  for (int i = 0; i < h; ++i) o[i] = x[(h + i) * stride] * kXi;
  for (int i = 0; i < h; ++i) {
    const float op = o[std::max(i - 1, 0)];
    e[i] += -kDelta * (op + o[i]);
  }
  for (int i = 0; i < h; ++i) {
    const float en = e[std::min(i + 1, h - 1)];
    o[i] += -kGamma * (e[i] + en);
  }
  for (int i = 0; i < h; ++i) {
    const float op = o[std::max(i - 1, 0)];
    e[i] += -kBeta * (op + o[i]);
  }
  for (int i = 0; i < h; ++i) {
    const float en = e[std::min(i + 1, h - 1)];
    o[i] += -kAlpha * (e[i] + en);
  }
  for (int i = 0; i < h; ++i) {
    x[(2 * i) * stride] = e[i];
    x[(2 * i + 1) * stride] = o[i];
  }
}

/* Column lifting over a block of `bw` adjacent columns with row-major
 * walks (one strided pass per lifting step instead of one cache-hostile
 * strided walk PER COLUMN).  The per-column operation order is identical
 * to dwt1d/idwt1d, so results are bit-identical; columns are independent
 * and the inner j-loops autovectorize. */
constexpr int kColBlock = 64;

void dwt1d_col_block(float *x, int n, int stride, int bw, float *tmp) {
  const int h = n / 2;
  float *e = tmp, *o = tmp + (size_t)h * bw;
  for (int i = 0; i < h; ++i)
    for (int j = 0; j < bw; ++j) {
      e[(size_t)i * bw + j] = x[(size_t)(2 * i) * stride + j];
      o[(size_t)i * bw + j] = x[(size_t)(2 * i + 1) * stride + j];
    }
  for (int i = 0; i < h; ++i) {
    const float *ei = e + (size_t)i * bw;
    const float *en = e + (size_t)std::min(i + 1, h - 1) * bw;
    float *oi = o + (size_t)i * bw;
    for (int j = 0; j < bw; ++j) oi[j] += kAlpha * (ei[j] + en[j]);
  }
  for (int i = 0; i < h; ++i) {
    const float *op = o + (size_t)std::max(i - 1, 0) * bw;
    const float *oi = o + (size_t)i * bw;
    float *ei = e + (size_t)i * bw;
    for (int j = 0; j < bw; ++j) ei[j] += kBeta * (op[j] + oi[j]);
  }
  for (int i = 0; i < h; ++i) {
    const float *ei = e + (size_t)i * bw;
    const float *en = e + (size_t)std::min(i + 1, h - 1) * bw;
    float *oi = o + (size_t)i * bw;
    for (int j = 0; j < bw; ++j) oi[j] += kGamma * (ei[j] + en[j]);
  }
  for (int i = 0; i < h; ++i) {
    const float *op = o + (size_t)std::max(i - 1, 0) * bw;
    const float *oi = o + (size_t)i * bw;
    float *ei = e + (size_t)i * bw;
    for (int j = 0; j < bw; ++j) ei[j] += kDelta * (op[j] + oi[j]);
  }
  for (int i = 0; i < h; ++i)
    for (int j = 0; j < bw; ++j) {
      x[(size_t)i * stride + j] = e[(size_t)i * bw + j] * kXi;
      x[(size_t)(h + i) * stride + j] =
          o[(size_t)i * bw + j] * (1.0f / kXi);
    }
}

void idwt1d_col_block(float *x, int n, int stride, int bw, float *tmp) {
  const int h = n / 2;
  float *e = tmp, *o = tmp + (size_t)h * bw;
  for (int i = 0; i < h; ++i)
    for (int j = 0; j < bw; ++j) {
      e[(size_t)i * bw + j] = x[(size_t)i * stride + j] * (1.0f / kXi);
      o[(size_t)i * bw + j] = x[(size_t)(h + i) * stride + j] * kXi;
    }
  for (int i = 0; i < h; ++i) {
    const float *op = o + (size_t)std::max(i - 1, 0) * bw;
    const float *oi = o + (size_t)i * bw;
    float *ei = e + (size_t)i * bw;
    for (int j = 0; j < bw; ++j) ei[j] += -kDelta * (op[j] + oi[j]);
  }
  for (int i = 0; i < h; ++i) {
    const float *ei = e + (size_t)i * bw;
    const float *en = e + (size_t)std::min(i + 1, h - 1) * bw;
    float *oi = o + (size_t)i * bw;
    for (int j = 0; j < bw; ++j) oi[j] += -kGamma * (ei[j] + en[j]);
  }
  for (int i = 0; i < h; ++i) {
    const float *op = o + (size_t)std::max(i - 1, 0) * bw;
    const float *oi = o + (size_t)i * bw;
    float *ei = e + (size_t)i * bw;
    for (int j = 0; j < bw; ++j) ei[j] += -kBeta * (op[j] + oi[j]);
  }
  for (int i = 0; i < h; ++i) {
    const float *ei = e + (size_t)i * bw;
    const float *en = e + (size_t)std::min(i + 1, h - 1) * bw;
    float *oi = o + (size_t)i * bw;
    for (int j = 0; j < bw; ++j) oi[j] += -kAlpha * (ei[j] + en[j]);
  }
  for (int i = 0; i < h; ++i)
    for (int j = 0; j < bw; ++j) {
      x[(size_t)(2 * i) * stride + j] = e[(size_t)i * bw + j];
      x[(size_t)(2 * i + 1) * stride + j] = o[(size_t)i * bw + j];
    }
}

/* In-place Mallat pyramid on a (hp x wp) row-major buffer.  Matches
 * dwt2d/idwt2d in ops/dwt.py: forward does rows then cols per level. */
void dwt2d(float *a, int hp, int wp, int levels) {
  std::vector<float> tmp(std::max<size_t>(std::max(hp, wp),
                                          (size_t)hp * kColBlock));
  for (int l = 0; l < levels; ++l) {
    const int hl = hp >> l, wl = wp >> l;
    for (int r = 0; r < hl; ++r) dwt1d(a + (size_t)r * wp, wl, 1, tmp.data());
    for (int c = 0; c < wl; c += kColBlock)
      dwt1d_col_block(a + c, hl, wp, std::min(kColBlock, wl - c),
                      tmp.data());
  }
}

void idwt2d(float *a, int hp, int wp, int levels) {
  std::vector<float> tmp(std::max<size_t>(std::max(hp, wp),
                                          (size_t)hp * kColBlock));
  for (int l = levels - 1; l >= 0; --l) {
    const int hl = hp >> l, wl = wp >> l;
    for (int c = 0; c < wl; c += kColBlock)
      idwt1d_col_block(a + c, hl, wp, std::min(kColBlock, wl - c),
                       tmp.data());
    for (int r = 0; r < hl; ++r) idwt1d(a + (size_t)r * wp, wl, 1, tmp.data());
  }
}

/* ------------------------------------------------------------------ */
/* little-endian header IO (layout: ebcc_tpu/core/stream.py)           */
/* ------------------------------------------------------------------ */

struct FrameHeader {
  uint8_t flags = 0, entropy = kBackendZstd;
  uint8_t res_entropy = 0; /* 0 => same as entropy */
  uint32_t n_frames = 1, height = 0, width = 0;
  float minval = 0, maxval = 0, rmin = 0, rmax = 0;
  uint8_t base_levels = kBaseLevels, res_levels = kResLevels;
  uint8_t base_nplanes = kBaseNumPlanes, base_cut = 0, base_top = 0;
  uint8_t res_nplanes = kResNumPlanes, res_cut = 0, res_top = 0;
  uint64_t base_comp = 0, res_comp = 0;
};

template <typename T>
void put(std::vector<uint8_t> &b, T v) {
  const size_t n = b.size();
  b.resize(n + sizeof(T));
  std::memcpy(b.data() + n, &v, sizeof(T));
}

template <typename T>
bool get(const uint8_t *&p, const uint8_t *end, T *v) {
  if ((size_t)(end - p) < sizeof(T)) return false;
  std::memcpy(v, p, sizeof(T));
  p += sizeof(T);
  return true;
}

void pack_header(const FrameHeader &h, std::vector<uint8_t> &out) {
  out.reserve(out.size() + kHeaderSize);
  out.insert(out.end(), {'E', 'T', 'P', 'U'});
  put<uint8_t>(out, 2);  /* version (2: round-2 CAB bitstream) */
  put<uint8_t>(out, h.flags);
  put<uint8_t>(out, h.entropy);
  put<uint8_t>(out, 0);
  put<uint32_t>(out, h.n_frames);
  put<uint32_t>(out, h.height);
  put<uint32_t>(out, h.width);
  put<uint32_t>(out, 0);
  put<float>(out, h.minval);
  put<float>(out, h.maxval);
  put<float>(out, h.rmin);
  put<float>(out, h.rmax);
  put<uint8_t>(out, h.base_levels);
  put<uint8_t>(out, h.res_levels);
  put<uint8_t>(out, h.base_nplanes);
  put<uint8_t>(out, h.base_cut);
  put<uint8_t>(out, h.base_top);
  put<uint8_t>(out, h.res_nplanes);
  put<uint8_t>(out, h.res_cut);
  put<uint8_t>(out, h.res_top);
  put<uint64_t>(out, h.base_comp);
  put<uint64_t>(out, h.res_comp);
  put<uint64_t>(out, 0);
}

bool parse_header(const uint8_t *data, size_t size, FrameHeader *h) {
  if (size < kHeaderSize || std::memcmp(data, "ETPU", 4) != 0) return false;
  const uint8_t *p = data + 4;
  const uint8_t *end = data + kHeaderSize;
  uint8_t version;
  uint32_t r1;
  uint64_t r2;
  if (!get(p, end, &version) || (version != 2 && version != 1))
    return false;
  get(p, end, &h->flags);
  get(p, end, &h->entropy);
  get(p, end, &h->res_entropy);
  /* Version 1 differs only in the CAB (backend 2) bitstream; zstd/store
   * streams are byte-compatible and stay readable. */
  if (version == 1 &&
      (h->entropy == 2 || (h->res_entropy ? h->res_entropy : h->entropy) == 2))
    return false;
  get(p, end, &h->n_frames);
  get(p, end, &h->height);
  get(p, end, &h->width);
  get(p, end, &r1);
  get(p, end, &h->minval);
  get(p, end, &h->maxval);
  get(p, end, &h->rmin);
  get(p, end, &h->rmax);
  get(p, end, &h->base_levels);
  get(p, end, &h->res_levels);
  get(p, end, &h->base_nplanes);
  get(p, end, &h->base_cut);
  get(p, end, &h->base_top);
  get(p, end, &h->res_nplanes);
  get(p, end, &h->res_cut);
  get(p, end, &h->res_top);
  get(p, end, &h->base_comp);
  get(p, end, &h->res_comp);
  if (!get(p, end, &r2)) return false;
  /* Sanity caps mirroring the Python decoder's _parse_streams posture
   * (core/codec.py): reject implausible headers BEFORE any allocation or
   * shift sized from them.  Untrusted bytes reach this via the HDF5 filter
   * plugin, so every field used in arithmetic must be bounded here. */
  if (h->n_frames == 0 || h->height == 0 || h->width == 0) return false;
  if (h->n_frames > (1u << 20) || h->height > 4 * 2047 || h->width > 4 * 2047)
    return false;
  if (h->base_levels > 10 || h->res_levels > 10) return false;
  if (h->base_nplanes > 32 || h->res_nplanes > 32) return false;
  if ((int)h->base_cut + (int)h->base_top > (int)h->base_nplanes) return false;
  if ((int)h->res_cut + (int)h->res_top > (int)h->res_nplanes) return false;
  /* Payload extents: check each leg against the remaining bytes without
   * forming a wrapping sum. */
  if (h->base_comp > size - kHeaderSize) return false;
  if (h->res_comp > size - kHeaderSize - h->base_comp) return false;
  return true;
}

/* ------------------------------------------------------------------ */
/* zstd backend (entropy id 1; id 0 = store)                           */
/* ------------------------------------------------------------------ */

bool zstd_pack(const uint8_t *src, size_t n, int level,
               std::vector<uint8_t> *out) {
  ZSTD_CCtx *c = ZSTD_createCCtx();
  ZSTD_CCtx_setParameter(c, ZSTD_c_compressionLevel, level);
  ZSTD_CCtx_setParameter(c, ZSTD_c_checksumFlag, 1);
  out->resize(ZSTD_compressBound(n));
  const size_t r = ZSTD_compress2(c, out->data(), out->size(), src, n);
  ZSTD_freeCCtx(c);
  if (ZSTD_isError(r)) return false;
  out->resize(r);
  return true;
}

bool zstd_unpack(const uint8_t *src, size_t n, uint8_t *dst, size_t dst_n) {
  const size_t r = ZSTD_decompress(dst, dst_n, src, n);
  return !ZSTD_isError(r) && r == dst_n;
}

/* ------------------------------------------------------------------ */
/* shared helpers                                                      */
/* ------------------------------------------------------------------ */

int padded(int v, int mult) { return (v + mult - 1) / mult * mult; }

/* Warm-start hints for the cut searches: the previous chunk's verified
 * cuts, valid only for the same shape/target/quantile.  Thread-local —
 * each pool worker warms up independently; correctness never depends on
 * the hint (it is always verified). */
struct CutHints {
  int d0 = 0, hh = 0, ww = 0;
  float target = 0;
  double quantile = 0;
  int bc = -1, pc = -1, rc = -1;
};
thread_local CutHints g_cut_hints;

/* Symmetric (edge-inclusive mirror) pad of (d0, h, w) frames into
 * (d0, hp, wp); matches jnp.pad mode='symmetric'. */
void pad_frames(const float *x, int d0, int h, int w, int hp, int wp,
                float *out) {
  for (int f = 0; f < d0; ++f) {
    const float *src = x + (size_t)f * h * w;
    float *dst = out + (size_t)f * hp * wp;
    for (int r = 0; r < hp; ++r) {
      const int sr = r < h ? r : (2 * h - 1 - r);
      const float *row = src + (size_t)std::max(0, sr) * w;
      float *drow = dst + (size_t)r * wp;
      std::memcpy(drow, row, sizeof(float) * w);
      for (int c = w; c < wp; ++c) drow[c] = row[2 * w - 1 - c < 0 ? 0 : 2 * w - 1 - c];
    }
  }
}

struct Layer {
  /* quantized coefficients, (d0, hp, wp) row-major */
  std::vector<int32_t> q;
  int d0 = 1, hp = 0, wp = 0;
};

float recon_mag(int32_t mag_kept, int cut) {
  if (mag_kept == 0) return 0.0f;
  if (cut == 0) return (float)mag_kept + 0.5f;
  return (float)(((int64_t)mag_kept << cut) + ((int64_t)1 << (cut - 1)));
}

/* Dequantize |q|>>cut values at a cut and inverse-transform; spatial is
 * (d0, hp, wp).  q holds FULL quantized coefficients. */
void reconstruct(const Layer &L, int cut, int levels, float *spatial) {
  const size_t n = (size_t)L.d0 * L.hp * L.wp;
  for (size_t i = 0; i < n; ++i) {
    const int32_t qv = L.q[i];
    const int32_t mag = (std::abs(qv)) >> cut;
    const float m = recon_mag(mag, cut);
    spatial[i] = qv < 0 ? -m : m;
  }
  for (int f = 0; f < L.d0; ++f)
    idwt2d(spatial + (size_t)f * L.hp * L.wp, L.hp, L.wp, levels);
}

struct Metrics {
  float max_centered = 0;
  float max_raw = 0;
  double mean = 0;
  size_t over_target = 0;
};

/* err = x - recon over the valid (h, w) region; recon = base + opt_extra. */
Metrics error_metrics(const float *x, const float *recon_padded,
                      const float *extra_padded, int d0, int h, int w,
                      int hp, int wp, float scale, float off, float escale,
                      float eoff, float target) {
  Metrics m;
  double sum = 0;
  const size_t nvalid = (size_t)d0 * h * w;
  std::vector<float> err((size_t)d0 * h * w);
  size_t k = 0;
  for (int f = 0; f < d0; ++f) {
    const float *rp = recon_padded + (size_t)f * hp * wp;
    const float *ep = extra_padded ? extra_padded + (size_t)f * hp * wp : nullptr;
    const float *xp = x + (size_t)f * h * w;
    for (int r = 0; r < h; ++r) {
      for (int c = 0; c < w; ++c) {
        float rec = rp[(size_t)r * wp + c] * scale + off;
        if (ep) rec += ep[(size_t)r * wp + c] * escale + eoff;
        const float e = xp[(size_t)r * w + c] - rec;
        err[k++] = e;
        sum += e;
      }
    }
  }
  m.mean = sum / (double)nvalid;
  for (size_t i = 0; i < nvalid; ++i) {
    const float ae = std::fabs(err[i]);
    const float ac = std::fabs(err[i] - (float)m.mean);
    if (ae > m.max_raw) m.max_raw = ae;
    if (ac > m.max_centered) m.max_centered = ac;
    if (ae > target) m.over_target++;
  }
  return m;
}

/* Dense bitplane payload (magnitude rows MSB-first + masked sign plane),
 * matching build_layer_payload in core/codec.py. */
void build_payload(const Layer &L, int cut, int num_planes,
                   std::vector<uint8_t> *payload, int *top, int *kept) {
  const size_t n = (size_t)L.d0 * L.hp * L.wp;
  int32_t mx = 0;
  for (size_t i = 0; i < n; ++i)
    mx = std::max(mx, std::abs(L.q[i]) >> cut);
  if (mx == 0) {
    payload->clear();
    *top = std::min(num_planes - cut, 255);
    *kept = 0;
    return;
  }
  int msb = 0;
  while ((1 << msb) <= mx) msb++;
  *kept = msb;
  *top = num_planes - cut - msb;
  const size_t wb = (size_t)L.wp / 8;
  const size_t plane_bytes = (size_t)L.d0 * L.hp * wb;
  payload->assign(plane_bytes * (msb + 1), 0);
  for (size_t i = 0; i < n; ++i) {
    const int32_t qv = L.q[i];
    const int32_t mag = std::abs(qv) >> cut;
    if (mag == 0 && qv >= 0) continue;
    const size_t byte = i / 8;
    const uint8_t bit = (uint8_t)(1u << (7 - (i % 8)));
    for (int s = 0; s < msb; ++s) {
      if ((mag >> (msb - 1 - s)) & 1)
        (*payload)[(size_t)s * plane_bytes + byte] |= bit;
    }
    if (qv < 0 && mag > 0)
      (*payload)[(size_t)msb * plane_bytes + byte] |= bit;
  }
}

/* Geometry the CAB coder needs to model a layer payload. */
struct LayerGeom {
  int kept, d0, hp, wp, levels;
};

bool cab_pack(const std::vector<uint8_t> &payload, const LayerGeom &g,
              std::vector<uint8_t> *out, bool relaxed = false) {
  uint8_t *buf = nullptr;
  const size_t n = (relaxed ? etpu_cab2_compress : etpu_cab_compress)(
      payload.data(), payload.size(), g.kept, g.d0, g.hp, g.wp, g.levels,
      &buf);
  if (n == 0) return false;
  out->assign(buf, buf + n);
  std::free(buf);
  return true;
}

/* Compress one layer payload with the configured backend (1 zstd, 2 CAB,
 * 3 auto = best-of, parity: core/entropy.py compress_best); *used gets the
 * backend id that actually produced *out (written into the header so the
 * decoder dispatches correctly). */
bool entropy_encode(const std::vector<uint8_t> &payload, int level,
                    int backend, const LayerGeom &g,
                    std::vector<uint8_t> *out, uint8_t *used) {
  *used = kBackendZstd;
  if (payload.empty()) {
    out->clear();
    return true;
  }
  const bool want_cab = (backend == 2 || backend == 3) && g.kept > 0;
  if (backend == 2 && want_cab) {
    if (!cab_pack(payload, g, out)) return false;
    *used = kBackendCab;
    return true;
  }
  if (backend == kBackendCab2 && g.kept > 0) {
    if (!cab_pack(payload, g, out, /*relaxed=*/true)) return false;
    *used = kBackendCab2;
    return true;
  }
  if (backend == kBackendCab2) backend = kBackendZstd; /* empty geom */
  if (!zstd_pack(payload.data(), payload.size(), level > 0 ? level : 9, out))
    return false;
  if (want_cab) {
    std::vector<uint8_t> alt;
    if (cab_pack(payload, g, &alt) && alt.size() < out->size()) {
      *out = std::move(alt);
      *used = kBackendCab;
    }
  }
  return true;
}

struct EncodeEnv {
  double quantile = 1e-6;
  bool no_fallback = false;
  bool no_mean_adjust = false;
};

EncodeEnv read_env() {
  EncodeEnv e;
  if (const char *q = std::getenv("EBCC_INIT_BASE_ERROR_QUANTILE"))
    e.quantile = std::atof(q);
  if (std::getenv("EBCC_DISABLE_PURE_BASE_COMPRESSION_FALLBACK"))
    e.no_fallback = true;
  if (std::getenv("EBCC_DISABLE_MEAN_ADJUSTMENT"))
    e.no_mean_adjust = true;
  return e;
}

}  // namespace

/* ------------------------------------------------------------------ */
/* decode                                                              */
/* ------------------------------------------------------------------ */

namespace {

bool decode_layer_values_g(int num_planes, int cut, int top, uint8_t backend,
                           bool partial, int levels, const uint8_t *payload,
                           size_t comp_size, int d0, int hp, int wp,
                           Layer *L) {
  const int kept = num_planes - cut - top;
  L->d0 = d0;
  L->hp = hp;
  L->wp = wp;
  L->q.assign((size_t)d0 * hp * wp, 0);
  if (kept <= 0 || comp_size == 0) return true;
  const size_t wb = (size_t)wp / 8;
  const size_t plane_bytes = (size_t)d0 * hp * wb;
  /* partial: last plane is a prefix of length pb implied by the raw size
   * (mirror of core/codec.py::_payload_to_values). */
  size_t raw_size = plane_bytes * (kept + 1);
  size_t pb = plane_bytes;  /* full last plane unless partial */
  if (partial) {
    unsigned long long content;
    if (backend == kBackendZstd) {
      content = ZSTD_getFrameContentSize(payload, comp_size);
      if (content == ZSTD_CONTENTSIZE_ERROR ||
          content == ZSTD_CONTENTSIZE_UNKNOWN)
        return false;
    } else if (backend == kBackendStore) {
      content = comp_size;
    } else {
      log_err("partial-plane payloads require a zstd/store entropy layer");
      return false;
    }
    if (content < plane_bytes * kept || content > raw_size) return false;
    pb = (size_t)content - plane_bytes * kept;
    raw_size = (size_t)content;
  }
  std::vector<uint8_t> raw(raw_size);
  if (backend == kBackendZstd) {
    if (!zstd_unpack(payload, comp_size, raw.data(), raw_size)) {
      log_err("corrupt entropy payload");
      return false;
    }
  } else if (backend == kBackendCab || backend == kBackendCab2) {
    const auto fn = backend == kBackendCab2 ? etpu_cab2_decompress
                                            : etpu_cab_decompress;
    if (!fn(payload, comp_size, kept, d0, hp, wp, levels, raw.data(),
            raw_size)) {
      log_err("corrupt CAB payload");
      return false;
    }
  } else if (backend == kBackendStore) {
    if (comp_size != raw_size) return false;
    std::memcpy(raw.data(), payload, raw_size);
  } else {
    log_err("unknown entropy backend");
    return false;
  }
  const int full = partial ? kept - 1 : kept;
  const size_t sign_off = (size_t)full * plane_bytes + (partial ? pb : 0);
  const size_t n = (size_t)d0 * hp * wp;
  for (size_t i = 0; i < n; ++i) {
    const size_t byte = i / 8;
    const uint8_t bit = (uint8_t)(1u << (7 - (i % 8)));
    uint32_t mag = 0; /* unsigned: shifts are defined for all header values */
    for (int s = 0; s < full; ++s)
      mag = (mag << 1) | ((raw[(size_t)s * plane_bytes + byte] & bit) ? 1u : 0u);
    if (partial) {
      const uint8_t pbyte =
          byte < pb ? raw[(size_t)full * plane_bytes + byte] : 0;
      mag = (mag << 1) | ((pbyte & bit) ? 1u : 0u);
    }
    /* store FULL-scale q (kept values << cut); cut <= 31 is guaranteed by
     * parse_header (cut + top <= nplanes <= 32 and kept >= 1 here) and by
     * the delta-record validation in decode_frame. */
    const int32_t sq = (int32_t)(mag << cut);
    L->q[i] = (raw[sign_off + byte] & bit) ? -sq : sq;
  }
  return true;
}

bool decode_layer_values(const FrameHeader &h, const uint8_t *payload,
                         size_t comp_size, bool base, int d0, int hp, int wp,
                         Layer *L) {
  return decode_layer_values_g(
      base ? h.base_nplanes : h.res_nplanes, base ? h.base_cut : h.res_cut,
      base ? h.base_top : h.res_top,
      base ? h.entropy : (h.res_entropy ? h.res_entropy : h.entropy),
      base && (h.flags & kFlagBasePartial),
      base ? h.base_levels : h.res_levels, payload, comp_size, d0, hp, wp,
      L);
}

/* One parsed temporal delta record (docs/FORMAT.md "delta section"). */
struct DeltaRecord {
  float rmin, rmax;
  uint8_t cut, top, entropy;
  uint32_t comp_size;
  const uint8_t *payload;
};

/* Validate + locate the delta section of a temporal stream; *end_out
 * receives the section's end offset (a mask section may follow). */
bool parse_delta_section(const FrameHeader &h, const uint8_t *data,
                         size_t size, std::vector<DeltaRecord> *recs,
                         size_t *end_out) {
  if (h.n_frames < 2) return false;
  const size_t nt = (size_t)h.n_frames - 1;
  const size_t start = kHeaderSize + h.base_comp + h.res_comp;
  if (start > size || nt > (size - start) / kDeltaRecordSize) return false;
  size_t pay = start + nt * kDeltaRecordSize;
  recs->resize(nt);
  for (size_t t = 0; t < nt; ++t) {
    const uint8_t *p = data + start + t * kDeltaRecordSize;
    const uint8_t *end = p + kDeltaRecordSize;
    DeltaRecord &r = (*recs)[t];
    uint8_t reserved;
    if (!get(p, end, &r.rmin) || !get(p, end, &r.rmax) ||
        !get(p, end, &r.cut) || !get(p, end, &r.top) ||
        !get(p, end, &r.entropy) || !get(p, end, &reserved) ||
        !get(p, end, &r.comp_size))
      return false;
    /* Delta geometry is measured against base_nplanes (<= 32 per
     * parse_header), which bounds the shift in decode_layer_values_g. */
    if ((int)r.cut + (int)r.top > (int)h.base_nplanes) return false;
    if (r.comp_size > size - pay) return false;  /* no wrapping sum */
    r.payload = data + pay;
    pay += r.comp_size;
  }
  *end_out = pay;
  return true;
}

/* Validate + locate the mask section (kFlagMasked): 8-byte header
 * (entropy id, 3 reserved, u32 comp size) + payload, starting at *end
 * (the end of the preceding sections); *end advances past it. */
bool parse_mask_section(const uint8_t *data, size_t size, size_t *end,
                        uint8_t *ent, const uint8_t **payload,
                        size_t *comp_size) {
  if (*end > size || size - *end < 8) return false;
  const uint8_t *p = data + *end;
  *ent = p[0];
  uint32_t csz;
  std::memcpy(&csz, p + 4, 4);
  if (csz > size - *end - 8) return false; /* no wrapping sum */
  *payload = p + 8;
  *comp_size = csz;
  *end += 8 + (size_t)csz;
  return true;
}

size_t decode_frame(const uint8_t *data, size_t size, float **out) {
  FrameHeader h;
  if (!parse_header(data, size, &h)) {
    log_err("invalid ETPU stream");
    return 0;
  }
  const size_t tot = (size_t)h.n_frames * h.height * h.width;
  const bool temporal = (h.flags & kFlagTemporal) != 0;
  const bool masked = (h.flags & kFlagMasked) != 0;
  std::vector<DeltaRecord> recs;
  /* parse_header guarantees base_comp + res_comp <= size - kHeaderSize
   * without wrapping; every section must account for every trailing byte
   * (temporal delta section, then the mask section when present). */
  size_t sect_end = kHeaderSize + h.base_comp + h.res_comp;
  if (temporal && !parse_delta_section(h, data, size, &recs, &sect_end)) {
    log_err("payload size mismatch");
    return 0;
  }
  uint8_t mask_ent = 0;
  const uint8_t *mask_payload = nullptr;
  size_t mask_csz = 0;
  if (masked && !parse_mask_section(data, size, &sect_end, &mask_ent,
                                    &mask_payload, &mask_csz)) {
    log_err("truncated mask section");
    return 0;
  }
  if (sect_end != size) {
    log_err("payload size mismatch");
    return 0;
  }
  *out = (float *)std::malloc(tot * sizeof(float));
  if (!*out) return 0;
  if (h.flags & kFlagLossless) {
    /* Bit-exact decode: entropy-decode the Lorenzo residuals, invert the
     * predictor, inverse order-preserving map.  Returns directly
     * (lossless never combines with the other flags). */
    std::vector<uint32_t> raw32(tot);
    uint8_t *rawp = reinterpret_cast<uint8_t *>(raw32.data());
    bool ok;
    if (h.entropy == kBackendZstd) {
      ok = zstd_unpack(data + kHeaderSize, h.base_comp, rawp, tot * 4);
    } else if (h.entropy == 0) {
      ok = h.base_comp == tot * 4;
      if (ok) std::memcpy(rawp, data + kHeaderSize, tot * 4);
    } else {
      ok = false;
    }
    if (!ok) {
      log_err("corrupt lossless payload");
      std::free(*out);
      *out = nullptr;
      return 0;
    }
    /* Inverse Lorenzo per frame: wrapping cumsum along each row, then
     * along each column; an optional frame-axis cumsum (base_levels == 1,
     * the adaptive frame-diff candidate); then the inverse map. */
    if (h.base_levels != 2 && h.base_levels != 3) {
      log_err("unsupported lossless predictor id");
      std::free(*out);
      *out = nullptr;
      return 0;
    }
    const size_t fsz = (size_t)h.height * h.width;
    const int hh2 = (int)h.height, ww2 = (int)h.width;
    uint32_t *u = raw32.data();
    for (uint32_t f = 0; f < h.n_frames; ++f) {
      uint32_t *fr = u + (size_t)f * fsz;
      for (int r = 0; r < hh2; ++r) {
        uint32_t *row = fr + (size_t)r * ww2;
        for (int c = 1; c < ww2; ++c) row[c] += row[c - 1];
      }
      for (int r = 1; r < hh2; ++r)
        for (int c = 0; c < ww2; ++c)
          fr[(size_t)r * ww2 + c] += fr[(size_t)(r - 1) * ww2 + c];
    }
    if (h.base_levels == 3)
      for (size_t i = fsz; i < tot; ++i) u[i] += u[i - fsz];
    for (size_t i = 0; i < tot; ++i) {
      const uint32_t a = u[i];
      const uint32_t b = (a & 0x80000000u) ? (a & 0x7FFFFFFFu) : ~a;
      std::memcpy(*out + i, &b, 4);
    }
    return tot;
  }
  const int mult = 1 << std::max(h.base_levels, h.res_levels);
  const int hp = padded(h.height, mult), wp = padded(h.width, mult);
  /* Temporal: the base/res layers cover FRAME 0 ONLY. */
  const int d0 = temporal ? 1 : (int)h.n_frames;
  const int hh = h.height, ww = h.width;

  if (h.flags & kFlagConst) {
    /* const frame 0 (possibly inside a temporal chunk whose later frames
     * carry deltas): fill everything, then let the accumulation below
     * overwrite frames 1+ (the mask restore at the end still applies). */
    for (size_t i = 0; i < tot; ++i) (*out)[i] = h.minval;
  } else {
    Layer base;
    if (!decode_layer_values(h, data + kHeaderSize, h.base_comp, true, d0,
                             hp, wp, &base)) {
      std::free(*out);
      *out = nullptr;
      return 0;
    }
    std::vector<float> spatial((size_t)d0 * hp * wp);
    reconstruct(base, h.base_cut, h.base_levels, spatial.data());
    const float rng = h.maxval > h.minval ? h.maxval - h.minval : 1.0f;
    for (int f = 0; f < d0; ++f)
      for (int r = 0; r < hh; ++r)
        for (int c = 0; c < ww; ++c)
          (*out)[((size_t)f * hh + r) * ww + c] =
              spatial[((size_t)f * hp + r) * wp + c] * (rng / kBaseScale) +
              h.minval;

    if (h.flags & kFlagResidual) {
      Layer res;
      if (!decode_layer_values(h, data + kHeaderSize + h.base_comp,
                               h.res_comp, false, d0, hp, wp, &res)) {
        std::free(*out);
        *out = nullptr;
        return 0;
      }
      std::vector<float> rsp((size_t)d0 * hp * wp);
      reconstruct(res, h.res_cut, h.res_levels, rsp.data());
      const float rrng = h.rmax > h.rmin ? h.rmax - h.rmin : 1.0f;
      for (int f = 0; f < d0; ++f)
        for (int r = 0; r < hh; ++r)
          for (int c = 0; c < ww; ++c)
            (*out)[((size_t)f * hh + r) * ww + c] +=
                rsp[((size_t)f * hp + r) * wp + c] * (rrng / kResScale) +
                h.rmin;
    }
  }

  if (temporal) {
    /* Closed-loop accumulation: frame t = frame t-1 + decoded delta, in
     * sequential float32 order (normative — the encoder verified each
     * frame's bound against exactly this arithmetic; see FORMAT.md). */
    const size_t fsz = (size_t)hh * ww;
    std::vector<float> rsp((size_t)hp * wp);
    for (size_t t = 0; t < recs.size(); ++t) {
      const DeltaRecord &r = recs[t];
      Layer dl;
      if (!decode_layer_values_g(h.base_nplanes, r.cut, r.top, r.entropy,
                                 false, h.res_levels, r.payload,
                                 r.comp_size, 1, hp, wp, &dl)) {
        std::free(*out);
        *out = nullptr;
        return 0;
      }
      reconstruct(dl, r.cut, h.res_levels, rsp.data());
      const float drng = r.rmax > r.rmin ? r.rmax - r.rmin : 1.0f;
      const float *prev = *out + t * fsz;
      float *cur = *out + (t + 1) * fsz;
      for (int rr = 0; rr < hh; ++rr)
        for (int cc = 0; cc < ww; ++cc)
          cur[(size_t)rr * ww + cc] =
              prev[(size_t)rr * ww + cc] +
              (rsp[(size_t)rr * wp + cc] * (drng / kResScale) + r.rmin);
    }
  }
  if (h.flags & kFlagLogDomain) {
    /* Pointwise-relative streams: exp() is the decoder's final arithmetic
     * step (before the NaN restore, whose positions are exp-invariant). */
    for (size_t i = 0; i < tot; ++i) (*out)[i] = std::exp((*out)[i]);
  }
  if (masked) {
    /* Restore NaN at the masked positions (np.packbits MSB-first order). */
    const size_t nbytes = (tot + 7) / 8;
    std::vector<uint8_t> bm(nbytes);
    bool ok;
    if (mask_ent == kBackendZstd) {
      ok = zstd_unpack(mask_payload, mask_csz, bm.data(), nbytes);
    } else if (mask_ent == 0) {
      ok = mask_csz == nbytes;
      if (ok) std::memcpy(bm.data(), mask_payload, nbytes);
    } else {
      ok = false;
    }
    if (!ok) {
      log_err("corrupt mask section");
      std::free(*out);
      *out = nullptr;
      return 0;
    }
    const float qnan = std::numeric_limits<float>::quiet_NaN();
    for (size_t i = 0; i < tot; ++i)
      if (bm[i >> 3] & (uint8_t)(0x80u >> (i & 7))) (*out)[i] = qnan;
  }
  return tot;
}

}  // namespace

size_t etpu_decode(const uint8_t *data, size_t size, float **out) {
  /* C ABI boundary: a hostile-but-capped header can still request a very
   * large allocation; turn bad_alloc into a decode error, not terminate(). */
  try {
    if (size >= 4 && std::memcmp(data, "ETPK", 4) == 0)
      return etpu_decode_chunked(data, size, out);
    return decode_frame(data, size, out);
  } catch (const std::bad_alloc &) {
    log_err("allocation failure during decode");
    *out = nullptr;
    return 0;
  }
}

/* ------------------------------------------------------------------ */
/* encode                                                              */
/* ------------------------------------------------------------------ */

namespace {

size_t encode_frame(const float *x, int d0, int hh, int ww,
                    const etpu_config_t *config, uint8_t **out) {
  const EncodeEnv env = read_env();
  const double quantile_target = 1.0 - env.quantile;
  const int level = config->zstd_level > 0 ? config->zstd_level : 9;
  const int ebackend = config->entropy_backend;
  const size_t tot = (size_t)d0 * hh * ww;

  float minv = x[0], maxv = x[0];
  for (size_t i = 0; i < tot; ++i) {
    if (std::isnan(x[i]) || std::isinf(x[i])) {
      log_err("NaN or Inf found in data");
      return 0;
    }
    minv = std::min(minv, x[i]);
    maxv = std::max(maxv, x[i]);
  }
  FrameHeader h;
  h.n_frames = d0;
  h.height = hh;
  h.width = ww;
  h.minval = minv;
  h.maxval = maxv;

  std::vector<uint8_t> blob;
  if (minv == maxv) { /* const field shortcut */
    h.flags = kFlagConst;
    pack_header(h, blob);
    *out = (uint8_t *)std::malloc(blob.size());
    std::memcpy(*out, blob.data(), blob.size());
    return blob.size();
  }

  const int mult = 1 << std::max(kBaseLevels, kResLevels);
  const int hp = padded(hh, mult), wp = padded(ww, mult);
  const float rng = maxv - minv;

  /* base layer transform + quantize */
  std::vector<float> u(tot);
  for (size_t i = 0; i < tot; ++i)
    u[i] = (x[i] - minv) / rng * kBaseScale;
  std::vector<float> up((size_t)d0 * hp * wp);
  pad_frames(u.data(), d0, hh, ww, hp, wp, up.data());
  for (int f = 0; f < d0; ++f)
    dwt2d(up.data() + (size_t)f * hp * wp, hp, wp, kBaseLevels);
  Layer base;
  base.d0 = d0;
  base.hp = hp;
  base.wp = wp;
  base.q.resize(up.size());
  for (size_t i = 0; i < up.size(); ++i)
    base.q[i] = (int32_t)std::trunc(up[i]);

  const float bscale = rng / kBaseScale;
  const bool rate_mode = config->residual_mode == 0;
  std::vector<float> spatial(up.size());

  if (rate_mode) {
    /* host-style rate search: finest cut whose ACTUAL compressed size fits
     * the base_cr byte budget (monotone in cut). */
    const size_t budget =
        (size_t)std::max<int64_t>(0, (int64_t)(tot * 4 / config->base_cr) -
                                          (int64_t)kHeaderSize);
    int cut = kBaseNumPlanes;
    std::vector<uint8_t> comp, payload;
    int top = 0, kept = 0;
    uint8_t used = kBackendZstd;
    for (int c = kBaseNumPlanes - 1; c >= 0; --c) {
      std::vector<uint8_t> trial_payload, trial_comp;
      int t_top, t_kept;
      uint8_t t_used;
      build_payload(base, c, kBaseNumPlanes, &trial_payload, &t_top, &t_kept);
      if (!entropy_encode(trial_payload, level, ebackend,
                          {t_kept, d0, hp, wp, kBaseLevels}, &trial_comp,
                          &t_used))
        return 0;
      if (trial_comp.size() <= budget) {
        cut = c;
        comp = std::move(trial_comp);
        top = t_top;
        kept = t_kept;
        used = t_used;
      } else {
        break;
      }
    }
    if (cut == kBaseNumPlanes) { /* nothing fits: ship empty base */
      comp.clear();
      top = 0;
      cut = kBaseNumPlanes - 1;
      top = kBaseNumPlanes - cut;
    }
    h.base_cut = (uint8_t)cut;
    h.base_top = (uint8_t)top;
    h.base_comp = comp.size();
    h.entropy = used;
    pack_header(h, blob);
    blob.insert(blob.end(), comp.begin(), comp.end());
    *out = (uint8_t *)std::malloc(blob.size());
    std::memcpy(*out, blob.data(), blob.size());
    return blob.size();
  }

  /* error-bounded modes */
  float target = config->error;
  if (config->residual_mode == 2) target *= rng; /* REL -> ABS */
  /* cross-decoder allowance; ultra-tight targets (allowance > half the
   * target) degrade to own-decoder verification — see docs/FORMAT.md */
  if (target - kDecoderEpsRel * rng >= 0.5f * target)
    target -= kDecoderEpsRel * rng;
  const bool centered = !env.no_mean_adjust;

  /* Both cut criteria are monotone in the cut (finer cut => smaller
   * error), so binary search replaces the linear coarsest-down walk:
   * <=2*ceil(log2 P) reconstruct+metrics evaluations instead of up to P
   * (the worst case at tight targets).  Evaluations are cached so the two
   * criteria share them, and a thread-local warm start from the previous
   * same-shaped/same-target chunk verifies the remembered answer with <=2
   * evaluations (reconstruct dominates encode time; an archive's chunks
   * usually land on the same cuts).  Under the monotone-feasibility
   * design assumption the whole codebase shares (the bisection here and
   * the device coarse-to-fine scans in core/kernels.py rely on it), the
   * boundary the verification checks is unique, so the result is
   * identical to the full search and streams stay byte-identical. */
  std::vector<char> m_have(kBaseNumPlanes, 0);
  std::vector<Metrics> m_cache(kBaseNumPlanes);
  auto eval_base = [&](int c) -> const Metrics & {
    if (!m_have[c]) {
      reconstruct(base, c, kBaseLevels, spatial.data());
      m_cache[c] = error_metrics(x, spatial.data(), nullptr, d0, hh, ww, hp,
                                 wp, bscale, minv, 0, 0, target);
      m_have[c] = 1;
    }
    return m_cache[c];
  };
  /* largest c in [0, P) with feasible(metrics(c)), or -1 if none */
  auto search_cut = [&](auto feasible, int hint) -> int {
    if (hint >= 0 && hint < kBaseNumPlanes && feasible(eval_base(hint)) &&
        (hint == kBaseNumPlanes - 1 || !feasible(eval_base(hint + 1))))
      return hint;
    if (!feasible(eval_base(0))) return -1;
    int lo = 0, hi = kBaseNumPlanes - 1;
    if (feasible(eval_base(hi))) return hi;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (feasible(eval_base(mid)))
        lo = mid;
      else
        hi = mid;
    }
    return lo;
  };
  auto quant_ok = [&](const Metrics &m) {
    return 1.0 - (double)m.over_target / (double)tot >= quantile_target;
  };
  auto bound_ok = [&](const Metrics &m) {
    return (centered ? m.max_centered : m.max_raw) <= target;
  };
  const bool hints_match =
      g_cut_hints.d0 == d0 && g_cut_hints.hh == hh && g_cut_hints.ww == ww &&
      g_cut_hints.target == target &&
      g_cut_hints.quantile == quantile_target;
  const int bc = search_cut(quant_ok, hints_match ? g_cut_hints.bc : -1);
  const int pc = search_cut(bound_ok, hints_match ? g_cut_hints.pc : -1);
  const bool base_found = bc >= 0;
  const bool pure_feasible = pc >= 0;
  int base_cut = bc >= 0 ? bc : 0;
  int pure_cut = pc >= 0 ? pc : 0;
  Metrics base_m = eval_base(base_cut);
  Metrics pure_m = eval_base(pure_cut);

  /* base reconstruction at base_cut + residual layer */
  reconstruct(base, base_cut, kBaseLevels, spatial.data());
  const bool skip_residual = base_m.max_raw <= target && base_found;

  /* residual on r = x - base_recon */
  std::vector<float> resid(tot);
  float rminv = 0, rmaxv = 0;
  {
    size_t k = 0;
    for (int f = 0; f < d0; ++f)
      for (int r = 0; r < hh; ++r)
        for (int c = 0; c < ww; ++c) {
          const float rec =
              spatial[((size_t)f * hp + r) * wp + c] * bscale + minv;
          resid[k] = x[((size_t)f * hh + r) * ww + c] - rec;
          ++k;
        }
    rminv = rmaxv = resid[0];
    for (size_t i = 0; i < tot; ++i) {
      rminv = std::min(rminv, resid[i]);
      rmaxv = std::max(rmaxv, resid[i]);
    }
  }
  const float rrng = rmaxv > rminv ? rmaxv - rminv : 1.0f;
  std::vector<float> rn(tot);
  for (size_t i = 0; i < tot; ++i)
    rn[i] = (resid[i] - rminv) / rrng * kResScale;
  std::vector<float> rnp((size_t)d0 * hp * wp);
  pad_frames(rn.data(), d0, hh, ww, hp, wp, rnp.data());
  for (int f = 0; f < d0; ++f)
    dwt2d(rnp.data() + (size_t)f * hp * wp, hp, wp, kResLevels);
  Layer res;
  res.d0 = d0;
  res.hp = hp;
  res.wp = wp;
  res.q.resize(rnp.size());
  for (size_t i = 0; i < rnp.size(); ++i)
    res.q[i] = (int32_t)std::trunc(rnp[i]);

  /* Same monotone binary search for the residual cut. */
  int res_cut = 0;
  bool res_feasible = false;
  Metrics res_m;
  std::vector<float> rsp(rnp.size());
  {
    std::vector<char> r_have(kResNumPlanes, 0);
    std::vector<Metrics> r_cache(kResNumPlanes);
    auto eval_res = [&](int c) -> const Metrics & {
      if (!r_have[c]) {
        reconstruct(res, c, kResLevels, rsp.data());
        r_cache[c] = error_metrics(x, spatial.data(), rsp.data(), d0, hh, ww,
                                   hp, wp, bscale, minv, rrng / kResScale,
                                   rminv, target);
        r_have[c] = 1;
      }
      return r_cache[c];
    };
    auto bound_ok_r = [&](const Metrics &m) {
      return (centered ? m.max_centered : m.max_raw) <= target;
    };
    const int rhint = hints_match ? g_cut_hints.rc : -1;
    if (rhint >= 0 && rhint < kResNumPlanes &&
        bound_ok_r(eval_res(rhint)) &&
        (rhint == kResNumPlanes - 1 || !bound_ok_r(eval_res(rhint + 1)))) {
      res_cut = rhint;
      res_feasible = true;
      res_m = eval_res(rhint);
    } else if (bound_ok_r(eval_res(0))) {
      int lo = 0, hi = kResNumPlanes - 1;
      if (bound_ok_r(eval_res(hi))) {
        lo = hi;
      } else {
        while (hi - lo > 1) {
          const int mid = (lo + hi) / 2;
          if (bound_ok_r(eval_res(mid)))
            lo = mid;
          else
            hi = mid;
        }
      }
      res_cut = lo;
      res_feasible = true;
      res_m = eval_res(lo);
    }
  }
  g_cut_hints = {d0, hh, ww, target, quantile_target, bc, pc,
                 res_feasible ? res_cut : -1};

  /* ---- post-search scale refinement (bound utilization; mirrors the
   * round-5 kernels.py refinement): the shipped candidate's power-of-two
   * cut granularity strands the max error near 75% of the target.  Bisect
   * a fractional coarsening of the shipped layer's quantization grid,
   * folded into the STORED maxval/rmax floats (decoders compute dequant
   * scales from those, so the stream format is untouched); every adopted
   * candidate is verified with the decoder's exact arithmetic, so the
   * bound stays exact.  Quality parity with the JAX encoder — streams are
   * cross-decodable, not byte-identical. */
  const bool ship_base_only = skip_residual || !res_feasible;
  if (ship_base_only) {
    const int cut_ship = skip_residual ? base_cut : pure_cut;
    const std::vector<int32_t> q0 = base.q;
    Layer trial = base;
    float g_lo = 1.0f, g_hi = 2.0f;
    for (int it = 0; it < 5; ++it) {
      const float g = 0.5f * (g_lo + g_hi);
      /* Requantize the CUT values (what the payload ships), re-expanded to
       * the cut grid — the same semantics as kernels.py: decoders
       * reconstruct a nonzero kept magnitude v as (v + 0.5) << cut
       * (recon_mag), so the nearest refined magnitude is
       * floor((v + 0.5) / g), via the same reciprocal-multiply
       * arithmetic. */
      const float ig = 1.0f / g;
      for (size_t i = 0; i < q0.size(); ++i) {
        const int32_t m = q0[i] < 0 ? -q0[i] : q0[i];
        const int32_t vg =
            (int32_t)std::floor(((float)(m >> cut_ship) + 0.5f) * ig);
        const int32_t qe = vg << cut_ship;
        trial.q[i] = q0[i] < 0 ? -qe : qe;
      }
      const float maxval_g = minv + rng * g;
      const float bscale_g = (maxval_g - minv) / kBaseScale;
      reconstruct(trial, cut_ship, kBaseLevels, spatial.data());
      const Metrics m_g = error_metrics(x, spatial.data(), nullptr, d0, hh,
                                        ww, hp, wp, bscale_g, minv, 0, 0,
                                        target);
      const bool feas =
          skip_residual
              ? m_g.max_raw <= target
              : (centered ? m_g.max_centered : m_g.max_raw) <= target;
      if (feas) {
        g_lo = g;
        base.q = trial.q;
        h.maxval = maxval_g;
        if (skip_residual)
          base_m = m_g;
        else
          pure_m = m_g;
      } else {
        g_hi = g;
      }
    }
  } else if (res_feasible) {
    /* residual-carrying candidate: same bisection on the residual grid,
     * folded into the stored rmax (the JAX path additionally sweeps
     * fractional scales before refining; the bisection alone closes the
     * same utilization gap here). */
    const std::vector<int32_t> q0 = res.q;
    Layer trial = res;
    reconstruct(base, base_cut, kBaseLevels, spatial.data());
    float r_lo = 1.0f, r_hi = 2.0f;
    for (int it = 0; it < 5; ++it) {
      const float r = 0.5f * (r_lo + r_hi);
      for (size_t i = 0; i < q0.size(); ++i)
        trial.q[i] = (int32_t)std::trunc((float)q0[i] / r);
      const float rmax_r = rminv + rrng * r;
      const float escale_r = (rmax_r - rminv) / kResScale;
      reconstruct(trial, res_cut, kResLevels, rsp.data());
      const Metrics m_r =
          error_metrics(x, spatial.data(), rsp.data(), d0, hh, ww, hp, wp,
                        bscale, minv, escale_r, rminv, target);
      const bool feas =
          (centered ? m_r.max_centered : m_r.max_raw) <= target;
      if (feas) {
        r_lo = r;
        res.q = trial.q;
        rmaxv = rmax_r;
        res_m = m_r;
      } else {
        r_hi = r;
      }
    }
  }

  /* candidate assembly + selection (mirror of _assemble_error_mode_stream) */
  std::vector<uint8_t> base_payload, base_comp;
  int base_top, base_kept;
  uint8_t base_used = kBackendZstd, res_used = kBackendZstd;
  uint8_t pure_used = kBackendZstd;
  build_payload(base, base_cut, kBaseNumPlanes, &base_payload, &base_top,
                &base_kept);
  if (!entropy_encode(base_payload, level, ebackend,
                      {base_kept, d0, hp, wp, kBaseLevels}, &base_comp,
                      &base_used))
    return 0;

  bool use_residual = !skip_residual && res_feasible;
  std::vector<uint8_t> res_comp;
  int res_top = 0, res_kept = 0;
  if (use_residual) {
    std::vector<uint8_t> res_payload;
    build_payload(res, res_cut, kResNumPlanes, &res_payload, &res_top,
                  &res_kept);
    if (!entropy_encode(res_payload, level, ebackend,
                        {res_kept, d0, hp, wp, kResLevels}, &res_comp,
                        &res_used))
      return 0;
    if (res_comp.size() <= kResidualDropBytes) {
      /* Drop only if the base alone still meets the bound in a shippable
       * form (centered-with-adjustment or raw); the reference drops
       * unconditionally (c:811) and tolerates overshoot — we don't. */
      if (base_m.max_centered <= target || base_m.max_raw <= target) {
        res_comp.clear();
        use_residual = false;
      }
    }
  }

  bool choose_pure = false;
  std::vector<uint8_t> pure_comp;
  int pure_top = 0;
  if (!skip_residual && !res_feasible) {
    if (!pure_feasible)
      log_err("could not reach error target; shipping best effort");
    choose_pure = true;
  } else if (use_residual && pure_feasible && !env.no_fallback) {
    /* pure_feasible gate (mirror of core/codec.py): an infeasible pure cut
     * must not win the size comparison over a feasible base+residual. */
    std::vector<uint8_t> pure_payload;
    int k;
    build_payload(base, pure_cut, kBaseNumPlanes, &pure_payload, &pure_top,
                  &k);
    if (!entropy_encode(pure_payload, level, ebackend,
                        {k, d0, hp, wp, kBaseLevels}, &pure_comp, &pure_used))
      return 0;
    if (pure_comp.size() < base_comp.size() + res_comp.size())
      choose_pure = true;
  }

  double mean;
  if (choose_pure) {
    if (pure_comp.empty()) {
      std::vector<uint8_t> pure_payload;
      int k;
      build_payload(base, pure_cut, kBaseNumPlanes, &pure_payload, &pure_top,
                    &k);
      if (!entropy_encode(pure_payload, level, ebackend,
                          {k, d0, hp, wp, kBaseLevels}, &pure_comp,
                          &pure_used))
        return 0;
    }
    base_comp = std::move(pure_comp);
    base_used = pure_used;
    base_cut = pure_cut;
    base_top = pure_top;
    use_residual = false;
    res_comp.clear();
    mean = pure_m.mean;
  } else if (use_residual) {
    mean = res_m.mean;
  } else {
    mean = base_m.mean;
  }

  h.flags = 0;
  if (use_residual) h.flags |= kFlagResidual;
  /* Pure/residual candidates were verified CENTERED, so adjustment keeps
   * the bound; the skip/dropped-residual path was verified RAW (ref c:737)
   * and may only be shifted when the centered error is also in bound. */
  bool adjust_ok = true;
  if (!choose_pure && !use_residual)
    adjust_ok = base_m.max_centered <= target;
  if (!env.no_mean_adjust && std::fabs(mean) > 1e-18 && adjust_ok) {
    h.minval += (float)mean;
    h.maxval += (float)mean;
    h.flags |= kFlagMeanAdjusted;
  }
  h.base_cut = (uint8_t)base_cut;
  h.base_top = (uint8_t)std::max(0, base_top);
  h.base_comp = base_comp.size();
  h.entropy = base_used;
  if (use_residual) {
    h.rmin = rminv;
    h.rmax = rmaxv;
    h.res_cut = (uint8_t)res_cut;
    h.res_top = (uint8_t)std::max(0, res_top);
    h.res_comp = res_comp.size();
    h.res_entropy = res_used;
  }
  pack_header(h, blob);
  blob.insert(blob.end(), base_comp.begin(), base_comp.end());
  blob.insert(blob.end(), res_comp.begin(), res_comp.end());
  *out = (uint8_t *)std::malloc(blob.size());
  std::memcpy(*out, blob.data(), blob.size());
  return blob.size();
}

/* Temporal (closed-loop predictive) encode.  Frame 0 is intra-coded by
 * encode_frame itself and then DECODED BACK through this library's own
 * decoder to seed the prediction chain — consistency between the carried
 * reconstruction and what a decoder will compute is guaranteed by
 * construction (whatever candidate/adjustment encode_frame picked).
 * Every later frame is an error-bounded delta verified with exactly the
 * decoder's accumulation arithmetic (decode_frame temporal loop).
 * Mirrors kernels.encode_batch_temporal; see docs/FORMAT.md. */
size_t encode_frame_temporal(const float *x, int T, int hh, int ww,
                             const etpu_config_t *config, uint8_t **out) {
  const int level = config->zstd_level > 0 ? config->zstd_level : 9;
  const int ebackend = config->entropy_backend;
  const size_t fsz = (size_t)hh * ww;
  const size_t tot = (size_t)T * fsz;

  float gmin = x[0], gmax = x[0];
  for (size_t i = 0; i < tot; ++i) {
    if (std::isnan(x[i]) || std::isinf(x[i])) {
      log_err("NaN or Inf found in data");
      return 0;
    }
    gmin = std::min(gmin, x[i]);
    gmax = std::max(gmax, x[i]);
  }
  if (gmin == gmax) { /* whole-chunk const: plain CONST stream */
    FrameHeader h;
    h.n_frames = T;
    h.height = hh;
    h.width = ww;
    h.minval = gmin;
    h.maxval = gmax;
    h.flags = kFlagConst;
    std::vector<uint8_t> blob;
    pack_header(h, blob);
    *out = (uint8_t *)std::malloc(blob.size());
    if (!*out) return 0;
    std::memcpy(*out, blob.data(), blob.size());
    return blob.size();
  }

  /* REL -> ABS against the CHUNK-global range (the per-frame sub-encode
   * below would otherwise use frame 0's range). */
  float target = config->error;
  etpu_config_t sub = *config;
  sub.dims[0] = 1;
  sub.dims[1] = (uint64_t)hh;
  sub.dims[2] = (uint64_t)ww;
  sub.temporal = 0;
  if (config->residual_mode == 2) {
    target *= (gmax - gmin);
    sub.residual_mode = 1;
  }
  /* Temporal chains accumulate per-frame decoder divergence into the
   * carried reconstruction: budget 2*T allowances (JAX mirror in
   * kernels.encode_temporal). */
  {
    const float eps_t = 2.0f * (float)T * kDecoderEpsRel * (gmax - gmin);
    if (target - eps_t >= 0.5f * target) target -= eps_t;
  }
  sub.error = target; /* frame 0 seeds the chain: full allowance */

  /* ---- frame 0: intra encode + decode-back for the prediction seed ---- */
  uint8_t *f0 = nullptr;
  const size_t f0_size = encode_frame(x, 1, hh, ww, &sub, &f0);
  if (!f0_size) return 0;
  float *recon = nullptr;
  if (decode_frame(f0, f0_size, &recon) != fsz) {
    std::free(f0);
    std::free(recon);
    log_err("temporal seed decode failed");
    return 0;
  }
  FrameHeader h;
  if (!parse_header(f0, f0_size, &h)) {
    std::free(f0);
    std::free(recon);
    return 0;
  }
  h.n_frames = T;
  h.flags |= kFlagTemporal;

  const int mult = 1 << std::max(kBaseLevels, kResLevels);
  const int hp = padded(hh, mult), wp = padded(ww, mult);
  const size_t psz = (size_t)hp * wp;

  /* ---- delta frames ---- */
  std::vector<uint8_t> records;
  std::vector<uint8_t> dpayloads;
  std::vector<float> r(fsz), rn(fsz), rnp(psz), rsp(psz);
  bool warned = false;
  for (int t = 1; t < T; ++t) {
    const float *xt = x + (size_t)t * fsz;
    float maxr = 0, rminv = xt[0] - recon[0], rmaxv = rminv;
    for (size_t i = 0; i < fsz; ++i) {
      r[i] = xt[i] - recon[i];
      maxr = std::max(maxr, std::fabs(r[i]));
      rminv = std::min(rminv, r[i]);
      rmaxv = std::max(rmaxv, r[i]);
    }
    if (maxr <= target) { /* skip frame: exact zero delta */
      put<float>(records, 0.0f);
      put<float>(records, 0.0f);
      put<uint8_t>(records, 0);
      put<uint8_t>(records, (uint8_t)kBaseNumPlanes); /* kept = 0 */
      put<uint8_t>(records, kBackendZstd);
      put<uint8_t>(records, 0);
      put<uint32_t>(records, 0);
      continue;
    }
    const float rrng = rmaxv > rminv ? rmaxv - rminv : 1.0f;
    /* Adaptive quantization scale (see kernels.encode_batch_temporal):
     * the delta range can dwarf the target; scale the [0,255] grid so
     * the finest step resolves the bound with ~4x synthesis headroom. */
    const float f_dyn = std::min(
        800.0f,
        std::max(1.0f, 4.0f * rrng /
                           (kResScale * std::max(target, 1e-30f))));
    const float rmax_adj = rminv + rrng / f_dyn;
    const float drng = rmax_adj > rminv ? rmax_adj - rminv : 1.0f;
    const float s = drng / kResScale;
    for (size_t i = 0; i < fsz; ++i)
      rn[i] = (r[i] - rminv) / rrng * (kResScale * f_dyn);
    pad_frames(rn.data(), 1, hh, ww, hp, wp, rnp.data());
    dwt2d(rnp.data(), hp, wp, kResLevels);
    Layer dl;
    dl.d0 = 1;
    dl.hp = hp;
    dl.wp = wp;
    dl.q.resize(psz);
    for (size_t i = 0; i < psz; ++i) dl.q[i] = (int32_t)std::trunc(rnp[i]);

    /* coarsest feasible cut: verify with the DECODER's accumulation
     * arithmetic (prev + (rsp*s + rmin)). */
    auto feasible = [&](int c) {
      reconstruct(dl, c, kResLevels, rsp.data());
      for (int rr = 0; rr < hh; ++rr)
        for (int cc = 0; cc < ww; ++cc) {
          const size_t i = (size_t)rr * ww + cc;
          const float cur =
              recon[i] + (rsp[(size_t)rr * wp + cc] * s + rminv);
          if (std::fabs(xt[i] - cur) > target) return false;
        }
      return true;
    };
    int cut = 0;
    if (!feasible(0)) {
      if (!warned) {
        log_err("could not reach error target on a delta frame; shipping "
                "best effort");
        warned = true;
      }
    } else {
      int lo = 0, hi = kBaseNumPlanes - 1;
      if (feasible(hi)) {
        lo = hi;
      } else {
        while (hi - lo > 1) {
          const int mid = (lo + hi) / 2;
          if (feasible(mid))
            lo = mid;
          else
            hi = mid;
        }
      }
      cut = lo;
    }

    std::vector<uint8_t> payload, comp;
    int top = 0, kept = 0;
    uint8_t used = kBackendZstd;
    build_payload(dl, cut, kBaseNumPlanes, &payload, &top, &kept);
    if (!entropy_encode(payload, level, ebackend, {kept, 1, hp, wp,
                                                   kResLevels},
                        &comp, &used)) {
      std::free(f0);
      std::free(recon);
      return 0;
    }
    put<float>(records, rminv);
    put<float>(records, rmax_adj);
    put<uint8_t>(records, (uint8_t)cut);
    put<uint8_t>(records, (uint8_t)std::max(0, top));
    put<uint8_t>(records, used);
    put<uint8_t>(records, 0);
    put<uint32_t>(records, (uint32_t)comp.size());
    dpayloads.insert(dpayloads.end(), comp.begin(), comp.end());

    /* carry the reconstruction forward (decoder arithmetic, sequential) */
    reconstruct(dl, cut, kResLevels, rsp.data());
    for (int rr = 0; rr < hh; ++rr)
      for (int cc = 0; cc < ww; ++cc) {
        const size_t i = (size_t)rr * ww + cc;
        recon[i] = recon[i] + (rsp[(size_t)rr * wp + cc] * s + rminv);
      }
  }
  std::free(recon);

  std::vector<uint8_t> blob;
  pack_header(h, blob);
  blob.insert(blob.end(), f0 + kHeaderSize, f0 + f0_size);
  std::free(f0);
  blob.insert(blob.end(), records.begin(), records.end());
  blob.insert(blob.end(), dpayloads.begin(), dpayloads.end());
  *out = (uint8_t *)std::malloc(blob.size());
  if (!*out) return 0;
  std::memcpy(*out, blob.data(), blob.size());
  return blob.size();
}

bool layout(const uint64_t dims[3], int *d0, int *hh, int *ww) {
  const int64_t a = (int64_t)dims[0], b = (int64_t)dims[1],
                c = (int64_t)dims[2];
  if (c < kMinDim || c > kMaxDim) return false;
  if (b >= kMinDim && b <= kMaxDim) {
    *d0 = (int)a;
    *hh = (int)b;
    *ww = (int)c;
    return true;
  }
  const int64_t flat = a * b;
  if (flat < kMinDim || flat > kMaxDim) return false;
  *d0 = 1;
  *hh = (int)flat;
  *ww = (int)c;
  return true;
}

size_t encode_dispatch(const float *data, int d0, int hh, int ww,
                       const etpu_config_t *config, uint8_t **out);

/* Pointwise-relative (mode 3) wrapper: encode log(x) as MAX_ERROR at
 * log1p(eps) - kLogMargin and set kFlagLogDomain (mirrors codec.py
 * _log_transform_check).  Requires strictly positive finite data. */
size_t encode_log_domain(const float *data, int d0, int hh, int ww,
                         const etpu_config_t *config, uint8_t **out) {
  const size_t tot = (size_t)d0 * hh * ww;
  std::vector<float> y(tot);
  for (size_t i = 0; i < tot; ++i) {
    if (!(data[i] > 0.0f) || !std::isfinite(data[i])) {
      log_err("pointwise-relative mode requires strictly positive data");
      return 0;
    }
    y[i] = std::log(data[i]);
  }
  etpu_config_t sub = *config;
  sub.residual_mode = 1;
  sub.error = std::log1p(config->error) - kLogMargin;
  if (!(sub.error > 0.0f)) {
    log_err("pointwise-relative error too small to guarantee in float32");
    return 0;
  }
  const size_t isz = encode_dispatch(y.data(), d0, hh, ww, &sub, out);
  if (isz) (*out)[5] |= kFlagLogDomain;
  return isz;
}

/* Bit-exact lossless coder (mode 4; mirrors codec._lossless_encode_frames):
 * order-preserving f32->u32 map, per-frame 2-D Lorenzo predictor
 * residuals (u - left - up + upleft, wrapping; u[-1][*] == 0), zstd. */
void lorenzo_fwd_frames(std::vector<uint32_t> *d, int d0, int hh, int ww) {
  const size_t fsz = (size_t)hh * ww;
  for (int f = 0; f < d0; ++f) {
    uint32_t *u = d->data() + (size_t)f * fsz;
    /* vertical diff bottom-up, then horizontal diff right-to-left — both
     * in place (reverse order keeps the untouched predecessors live). */
    for (int r = hh - 1; r >= 1; --r)
      for (int c = 0; c < ww; ++c)
        u[(size_t)r * ww + c] -= u[(size_t)(r - 1) * ww + c];
    for (int r = 0; r < hh; ++r) {
      uint32_t *row = u + (size_t)r * ww;
      for (int c = ww - 1; c >= 1; --c) row[c] -= row[c - 1];
    }
  }
}

size_t encode_lossless(const float *data, int d0, int hh, int ww,
                       const etpu_config_t *config, uint8_t **out) {
  const size_t tot = (size_t)d0 * hh * ww;
  const size_t fsz = (size_t)hh * ww;
  std::vector<uint32_t> u(tot);
  for (size_t i = 0; i < tot; ++i) {
    uint32_t b;
    std::memcpy(&b, data + i, 4);
    u[i] = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  const int level = config->zstd_level > 0 ? config->zstd_level : 9;
  /* Candidate 0: per-frame 2-D Lorenzo; candidate 1 (multi-frame): a
   * frame-axis wrapping diff first (wins on correlated stacks) — pick by
   * compressed size, record in the otherwise-zero base_levels field. */
  /* Predictor ids: 2 = per-frame 2-D Lorenzo, 3 = frame-axis diff first
   * (ids 0/1 were interim pre-release coders, rejected on decode). */
  std::vector<uint8_t> comp;
  uint8_t ent = (uint8_t)kBackendZstd;
  uint8_t tdiff = 2;
  for (int cand = 0; cand < (d0 > 1 ? 2 : 1); ++cand) {
    std::vector<uint32_t> d = u;
    if (cand == 1)
      for (size_t i = tot; i-- > fsz;) d[i] -= d[i - fsz];
    lorenzo_fwd_frames(&d, d0, hh, ww);
    const uint8_t *raw = reinterpret_cast<const uint8_t *>(d.data());
    std::vector<uint8_t> c;
    uint8_t e = (uint8_t)kBackendZstd;
    if (!zstd_pack(raw, tot * 4, level, &c) || c.size() >= tot * 4) {
      c.assign(raw, raw + tot * 4);
      e = 0; /* store */
    }
    if (cand == 0 || c.size() < comp.size()) {
      comp = std::move(c);
      ent = e;
      tdiff = (uint8_t)(cand + 2);
    }
  }
  FrameHeader h;
  h.flags = kFlagLossless;
  h.entropy = ent;
  h.n_frames = (uint32_t)d0;
  h.height = (uint32_t)hh;
  h.width = (uint32_t)ww;
  h.base_levels = tdiff;
  h.res_levels = 0;
  h.base_nplanes = h.res_nplanes = 0;
  h.base_comp = comp.size();
  std::vector<uint8_t> blob;
  pack_header(h, blob);
  blob.insert(blob.end(), comp.begin(), comp.end());
  *out = (uint8_t *)std::malloc(blob.size());
  if (!*out) return 0;
  std::memcpy(*out, blob.data(), blob.size());
  return blob.size();
}

/* Dispatch one chunk to the lossless, log-domain, temporal, or intra
 * encoder. */
size_t encode_dispatch(const float *data, int d0, int hh, int ww,
                       const etpu_config_t *config, uint8_t **out) {
  if (config->residual_mode == 4)
    return encode_lossless(data, d0, hh, ww, config, out);
  if (config->residual_mode == 3)
    return encode_log_domain(data, d0, hh, ww, config, out);
  if (config->temporal && d0 > 1 && config->residual_mode != 0)
    return encode_frame_temporal(data, d0, hh, ww, config, out);
  return encode_frame(data, d0, hh, ww, config, out);
}

/* allow_nan wrapper (mirrors codec._mask_fill_check/_append_mask_sections):
 * fill NaNs with their frame's valid-sample mean (double accumulation,
 * like the Python side), encode the filled chunk, then set kFlagMasked and
 * append the entropy-coded invalid bitmap as the stream's last section.
 * Valid samples are untouched, so the bound holds on them unchanged.
 * Caller guarantees the chunk contains at least one NaN. */
size_t encode_masked(const float *data, int d0, int hh, int ww,
                     const etpu_config_t *config, uint8_t **out) {
  const size_t fsz = (size_t)hh * ww;
  const size_t tot = (size_t)d0 * fsz;
  std::vector<float> filled(data, data + tot);
  std::vector<uint8_t> bitmap((tot + 7) / 8, 0);
  /* One scan builds the per-frame sums; the chunk totals derive from
   * them (same per-frame-then-chunk accumulation order as the Python
   * side).  The chunk-level valid mean is the fallback fill for fully
   * masked frames — a 0.0 fill would inflate the relative range and
   * break the pointwise mode's positivity. */
  std::vector<double> fs(d0, 0.0);
  std::vector<size_t> fcnt(d0, 0);
  for (int f = 0; f < d0; ++f) {
    const float *src = data + (size_t)f * fsz;
    for (size_t i = 0; i < fsz; ++i)
      if (!std::isnan(src[i])) {
        fs[f] += src[i];
        ++fcnt[f];
      }
  }
  double cs = 0;
  size_t ccnt = 0;
  for (int f = 0; f < d0; ++f) {
    cs += fs[f];
    ccnt += fcnt[f];
  }
  const float chunk_fill = ccnt ? (float)(cs / (double)ccnt) : 1.0f;
  for (int f = 0; f < d0; ++f) {
    const float fill =
        fcnt[f] ? (float)(fs[f] / (double)fcnt[f]) : chunk_fill;
    const float *src = data + (size_t)f * fsz;
    float *dst = filled.data() + (size_t)f * fsz;
    for (size_t i = 0; i < fsz; ++i)
      if (std::isnan(src[i])) {
        dst[i] = fill;
        const size_t gi = (size_t)f * fsz + i;
        bitmap[gi >> 3] |= (uint8_t)(0x80u >> (gi & 7));
      }
  }
  /* Inf survives the fill and is rejected by the inner encoder's
   * check_nan_inf-parity scan (it is junk, not a mask). */
  uint8_t *inner = nullptr;
  const size_t isz = encode_dispatch(filled.data(), d0, hh, ww, config,
                                     &inner);
  if (!isz) return 0;
  std::vector<uint8_t> comp;
  uint8_t ent = (uint8_t)kBackendZstd;
  const int level = config->zstd_level > 0 ? config->zstd_level : 9;
  if (!zstd_pack(bitmap.data(), bitmap.size(), level, &comp) ||
      comp.size() >= bitmap.size()) {
    comp.assign(bitmap.begin(), bitmap.end());
    ent = 0; /* store */
  }
  std::vector<uint8_t> blob(inner, inner + isz);
  std::free(inner);
  blob[5] |= kFlagMasked;
  put<uint8_t>(blob, ent);
  put<uint8_t>(blob, 0);
  put<uint8_t>(blob, 0);
  put<uint8_t>(blob, 0);
  put<uint32_t>(blob, (uint32_t)comp.size());
  blob.insert(blob.end(), comp.begin(), comp.end());
  *out = (uint8_t *)std::malloc(blob.size());
  if (!*out) return 0;
  std::memcpy(*out, blob.data(), blob.size());
  return blob.size();
}

}  // namespace

/* Capability sentinels for ebcc_tpu.native.load()'s staleness check: the
 * NEWEST one's presence means this build understands every current stream
 * feature.  Bump/add a sentinel when the ABI/format grows again. */
extern "C" int etpu_has_temporal(void) { return 1; }
extern "C" int etpu_has_mask(void) { return 1; }
extern "C" int etpu_has_logdomain(void) { return 1; }
extern "C" int etpu_has_lossless(void) { return 1; }

size_t etpu_encode(const float *data, const etpu_config_t *config,
                   uint8_t **out) {
  int d0, hh, ww;
  if (!layout(config->dims, &d0, &hh, &ww)) {
    log_err("invalid dims");
    return 0;
  }
  /* Lossless round-trips every bit pattern (NaN included) — the masked
   * wrapper must not fill them. */
  if (config->allow_nan && config->residual_mode != 4) {
    const size_t tot = (size_t)d0 * hh * ww;
    for (size_t i = 0; i < tot; ++i)
      if (std::isnan(data[i]))
        return encode_masked(data, d0, hh, ww, config, out);
  }
  return encode_dispatch(data, d0, hh, ww, config, out);
}

/* ------------------------------------------------------------------ */
/* chunked container (parity: ebcc_encode_chunking / decode_chunking)  */
/* ------------------------------------------------------------------ */

size_t etpu_encode_chunked(const float *data, const etpu_config_t *config,
                           uint8_t **out) {
  uint64_t cd[3];
  bool all_zero = true;
  for (int i = 0; i < 3; ++i) {
    cd[i] = config->chunk_dims[i];
    if (cd[i]) all_zero = false;
  }
  if (all_zero)
    for (int i = 0; i < 3; ++i) cd[i] = config->dims[i];
  int td0, thh, tww;
  if (!layout(cd, &td0, &thh, &tww)) {
    log_err("invalid chunk dims");
    return 0;
  }
  uint64_t counts[3];
  for (int i = 0; i < 3; ++i) {
    if (!config->dims[i] || !cd[i]) {
      log_err("dims and chunk_dims must be non-zero");
      return 0;
    }
    counts[i] = (config->dims[i] + cd[i] - 1) / cd[i];
  }
  const uint64_t num_chunks = counts[0] * counts[1] * counts[2];
  const uint64_t chunk_size = cd[0] * cd[1] * cd[2];

  std::vector<uint8_t> blob;
  blob.insert(blob.end(), {'E', 'T', 'P', 'K'});
  put<uint32_t>(blob, 1);
  put<uint32_t>(blob, 3);
  put<uint32_t>(blob, 0);
  for (int i = 0; i < 3; ++i) put<uint64_t>(blob, config->dims[i]);
  for (int i = 0; i < 3; ++i) put<uint64_t>(blob, cd[i]);
  put<uint64_t>(blob, num_chunks);
  put<uint64_t>(blob, chunk_size);

  etpu_config_t chunk_cfg = *config;
  for (int i = 0; i < 3; ++i) {
    chunk_cfg.dims[i] = cd[i];
    chunk_cfg.chunk_dims[i] = 0;
  }
  std::vector<float> buf(chunk_size);
  for (uint64_t lin = 0; lin < num_chunks; ++lin) {
    uint64_t origin[3], rem = lin;
    for (int d = 2; d >= 0; --d) {
      origin[d] = (rem % counts[d]) * cd[d];
      rem /= counts[d];
    }
    /* gather with edge replication (parity: copy_chunk_from_data_padded) */
    size_t k = 0;
    for (uint64_t i0 = 0; i0 < cd[0]; ++i0)
      for (uint64_t i1 = 0; i1 < cd[1]; ++i1)
        for (uint64_t i2 = 0; i2 < cd[2]; ++i2) {
          const uint64_t a =
              std::min(origin[0] + i0, config->dims[0] - 1);
          const uint64_t b =
              std::min(origin[1] + i1, config->dims[1] - 1);
          const uint64_t c =
              std::min(origin[2] + i2, config->dims[2] - 1);
          buf[k++] = data[(a * config->dims[1] + b) * config->dims[2] + c];
        }
    uint8_t *cstream = nullptr;
    const size_t csize = etpu_encode(buf.data(), &chunk_cfg, &cstream);
    if (!csize) {
      etpu_free(cstream);
      return 0;
    }
    put<uint64_t>(blob, csize);
    blob.insert(blob.end(), cstream, cstream + csize);
    etpu_free(cstream);
  }
  *out = (uint8_t *)std::malloc(blob.size());
  std::memcpy(*out, blob.data(), blob.size());
  return blob.size();
}

static size_t decode_chunked_impl(const uint8_t *data, size_t size,
                                  float **out);

size_t etpu_decode_chunked(const uint8_t *data, size_t size, float **out) {
  try {
    return decode_chunked_impl(data, size, out);
  } catch (const std::bad_alloc &) {
    log_err("allocation failure during decode");
    *out = nullptr;
    return 0;
  }
}

static size_t decode_chunked_impl(const uint8_t *data, size_t size,
                                  float **out) {
  if (size < 80 || std::memcmp(data, "ETPK", 4) != 0)
    return decode_frame(data, size, out);
  const uint8_t *p = data + 4;
  const uint8_t *end = data + size;
  uint32_t version, ndims, res;
  uint64_t dims[3], cd[3], num_chunks, chunk_size;
  if (!get(p, end, &version) || version != 1) return 0;
  if (!get(p, end, &ndims) || ndims != 3) return 0;
  get(p, end, &res);
  for (int i = 0; i < 3; ++i) get(p, end, &dims[i]);
  for (int i = 0; i < 3; ++i) get(p, end, &cd[i]);
  get(p, end, &num_chunks);
  if (!get(p, end, &chunk_size)) return 0;
  uint64_t counts[3];
  for (int i = 0; i < 3; ++i) {
    /* Sanity caps: container dims are untrusted; bound them before any
     * product so total / counts arithmetic below cannot wrap. */
    if (!dims[i] || !cd[i] || dims[i] > (1ull << 31) || cd[i] > dims[i])
      return 0;
    counts[i] = (dims[i] + cd[i] - 1) / cd[i];
  }
  /* Stepwise so no product can wrap: each dim <= 2^31, cumulative <= 2^42. */
  const uint64_t kMaxTotal = 1ull << 42;
  if (dims[0] * dims[1] > kMaxTotal ||
      dims[2] > kMaxTotal / (dims[0] * dims[1])) {
    log_err("implausible container dimensions");
    return 0;
  }
  if (counts[0] * counts[1] * counts[2] != num_chunks) {
    log_err("inconsistent chunk metadata");
    return 0;
  }
  const uint64_t total = dims[0] * dims[1] * dims[2];
  *out = (float *)std::malloc(total * sizeof(float));
  if (!*out) return 0;

  for (uint64_t lin = 0; lin < num_chunks; ++lin) {
    uint64_t csize_u;
    if (!get(p, end, &csize_u) || (size_t)(end - p) < csize_u) {
      log_err("truncated chunk payload");
      std::free(*out);
      *out = nullptr;
      return 0;
    }
    float *chunk = nullptr;
    const size_t got = decode_frame(p, (size_t)csize_u, &chunk);
    p += csize_u;
    if (got != cd[0] * cd[1] * cd[2]) {
      log_err("decoded chunk size mismatch");
      etpu_free(chunk);
      std::free(*out);
      *out = nullptr;
      return 0;
    }
    uint64_t origin[3], rem = lin;
    for (int d = 2; d >= 0; --d) {
      origin[d] = (rem % counts[d]) * cd[d];
      rem /= counts[d];
    }
    size_t k = 0;
    for (uint64_t i0 = 0; i0 < cd[0]; ++i0)
      for (uint64_t i1 = 0; i1 < cd[1]; ++i1)
        for (uint64_t i2 = 0; i2 < cd[2]; ++i2) {
          const uint64_t a = origin[0] + i0, b = origin[1] + i1,
                         c = origin[2] + i2;
          if (a < dims[0] && b < dims[1] && c < dims[2])
            (*out)[(a * dims[1] + b) * dims[2] + c] = chunk[k];
          ++k;
        }
    etpu_free(chunk);
  }
  if (p != end) {
    log_err("trailing payload bytes");
    std::free(*out);
    *out = nullptr;
    return 0;
  }
  return total;
}

void etpu_free(void *ptr) {
  if (ptr) std::free(ptr);
}

const char *etpu_version(void) { return "ebcc-tpu-native 0.1.0"; }
