/* ebcc_tpu_torch: the port's copy of ebcc_tpu/native/spiht_coder.cc, unchanged below
 * this line; legacy residual bytes must stay the original's. */
// SPIHT "IMS" residual coder — legacy EBCC v1 interop.
//
// Format-compatibility mirror of the reference residual coder
// (reference src/spiht/spiht_re.c, dwt.h, bitio.h, ml.h), written fresh in
// C++.  This exists so the TPU-native framework can read (and write)
// bitstreams produced by the original EBCC codec; it is NOT on the ETPU hot
// path (the ETPU format uses the batched bitplane coder in core/kernels.py
// / etpu_codec.cc instead).
//
// Bitstream contract mirrored exactly (cited into the reference):
//   - IMS header: 'I''M''S', 6b stages, 12b size_x, 12b size_y, 10b extra_x,
//     10b extra_y, 1b is_color, 29b bits0, 8b DC (spiht_re.c:415-434) and an
//     8b quantization step written by the coder init (spiht_re.c:63).
//   - Bit budget: bits0 = trunc_bits + 128 (or 1<<28 when unlimited); the
//     sorting/refinement machine stops after the budget-exceeding bit on
//     both sides (spiht_re.c: the "++bit_cnt > bits" checks).
//   - List semantics: LIP/LSP/LIS visited in push order; entries pushed
//     DURING a pass are processed within the same pass; removals are
//     tombstoned and compacted after the pass (ml.h ml_consolidate keeps
//     survivor order).
//   - CDF 9/7 lifting in float32 with the reference's exact pass order and
//     boundary formulas (dwt.h:87-272), x255 image scaling (MAXELEM,
//     spiht_re.h:12), floored-mean DC removal (dwt.h:319-336), and
//     truncate-toward-zero coefficient quantization (dwt.h:355-368).
//   - Reads past the end of a truncated stream yield 0 bits
//     (bitio.h:61-63) — truncated decode degrades gracefully.
//
// Reconstruction note: decode mirrors the bit-level state machine exactly,
// so coefficient integers match any conforming decoder bit-for-bit; the
// float inverse-DWT then agrees with the reference implementation to f32
// rounding (same formulas, same order).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr float kScale = 255.0f;      // MAXELEM, spiht_re.h:12
constexpr int kBudgetOffset = 128;    // header metadata allowance, spiht_re.c:436
constexpr int kMaxStep = 32;          // MAXSTEPS, spiht_re.h:13

// Lifting constants (public-domain CDF 9/7; reference dwt.h:3-7).
constexpr float A = -1.586134342f;
constexpr float B = -0.05298011854f;
constexpr float G = 0.8829110762f;
constexpr float D = 0.44355068522f;
constexpr float X = 1.149604398f;

// ---------------------------------------------------------------------------
// MSB-first bit IO
// ---------------------------------------------------------------------------

class BitSink {
 public:
  void put(uint8_t bit) {
    acc_ = static_cast<uint8_t>((acc_ << 1) | (bit & 1));
    if (++nbits_ == 8) {
      bytes_.push_back(acc_);
      acc_ = 0;
      nbits_ = 0;
    }
  }
  void put_many(uint64_t v, int n) {
    for (int i = n - 1; i >= 0; --i) put(static_cast<uint8_t>((v >> i) & 1));
  }
  // Pad the trailing partial byte with zeros (bitio_flush).
  std::vector<uint8_t> finish() {
    if (nbits_ > 0) {
      bytes_.push_back(static_cast<uint8_t>(acc_ << (8 - nbits_)));
      acc_ = 0;
      nbits_ = 0;
    }
    return std::move(bytes_);
  }

 private:
  std::vector<uint8_t> bytes_;
  uint8_t acc_ = 0;
  int nbits_ = 0;
};

class BitSource {
 public:
  BitSource(const uint8_t* data, size_t size) : data_(data), size_(size) {}
  uint8_t get() {
    if (avail_ == 0) {
      if (pos_ >= size_) return 0;  // past-the-end reads yield 0 bits
      cur_ = data_[pos_++];
      avail_ = 8;
    }
    return (cur_ >> --avail_) & 1;
  }
  uint64_t get_many(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | get();
    return v;
  }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  uint8_t cur_ = 0;
  int avail_ = 0;
};

// ---------------------------------------------------------------------------
// Padded plane + CDF 9/7 lifting (float32, reference pass order)
// ---------------------------------------------------------------------------

struct Plane {
  size_t size_x = 0, size_y = 0;    // payload dims
  size_t extra_x = 0, extra_y = 0;  // symmetric-extension padding
  size_t stride = 0;
  size_t stages = 0;
  std::vector<float> a;  // primary
  std::vector<float> t;  // scratch

  size_t px() const { return size_x + extra_x; }
  size_t py() const { return size_y + extra_y; }
};

// Forward row pass: a -> t, packed (low | high) halves.  dwt.h:87-113.
static void fwd_row(Plane& p, size_t row, size_t n) {
  float* a = p.a.data() + row * p.stride;
  float* t = p.t.data() + row * p.stride;
  const size_t h = n / 2;
  for (size_t x = 0; x + 1 < h; ++x)
    t[h + x] = a[2 * x + 1] + A * (a[2 * x] + a[2 * x + 2]);
  t[n - 1] = a[n - 1] + 2 * A * a[n - 2];
  t[0] = a[0] + B * (t[h] + t[h + 1]);
  for (size_t x = 1; x < h; ++x)
    t[x] = a[2 * x] + B * (t[h + x] + t[h + x - 1]);
  for (size_t x = 0; x + 1 < h; ++x) t[h + x] += G * (t[x] + t[x + 1]);
  t[n - 1] += G * (t[h - 1] + t[h - 2]);
  t[0] += D * (t[h] + t[h + 1]);
  for (size_t x = 1; x < h; ++x) t[x] += D * (t[h + x] + t[h + x - 1]);
  for (size_t x = 0; x < h; ++x) {
    t[x] *= X;
    t[h + x] /= X;
  }
}

// Forward column pass: t -> a.  dwt.h:147-173.
static void fwd_col(Plane& p, size_t col, size_t n) {
  const size_t s = p.stride, h = n / 2;
  float* a = p.a.data() + col;
  float* t = p.t.data() + col;
  for (size_t y = 0; y + 1 < h; ++y)
    a[(h + y) * s] = t[(2 * y + 1) * s] + A * (t[2 * y * s] + t[(2 * y + 2) * s]);
  a[(n - 1) * s] = t[(n - 1) * s] + 2 * A * t[(n - 2) * s];
  a[0] = t[0] + B * (a[h * s] + a[(h + 1) * s]);
  for (size_t y = 1; y < h; ++y)
    a[y * s] = t[2 * y * s] + B * (a[(h + y) * s] + a[(h + y - 1) * s]);
  for (size_t y = 0; y + 1 < h; ++y)
    a[(h + y) * s] += G * (a[y * s] + a[(y + 1) * s]);
  a[(n - 1) * s] += G * (a[(h - 1) * s] + a[(h - 2) * s]);
  a[0] += D * (a[h * s] + a[(h + 1) * s]);
  for (size_t y = 1; y < h; ++y)
    a[y * s] += D * (a[(h + y) * s] + a[(h + y - 1) * s]);
  for (size_t y = 0; y < h; ++y) {
    a[y * s] *= X;
    a[(h + y) * s] /= X;
  }
}

// Inverse column pass: a (in place) -> t, interleaved rows.  dwt.h:175-194.
static void inv_col(Plane& p, size_t col, size_t n) {
  const size_t s = p.stride, h = n / 2;
  float* a = p.a.data() + col;
  float* t = p.t.data() + col;
  for (size_t y = 0; y < h; ++y) {
    a[y * s] /= X;
    a[(h + y) * s] *= X;
  }
  for (size_t y = 1; y < h; ++y)
    a[y * s] -= D * (a[(h + y) * s] + a[(h + y - 1) * s]);
  a[0] -= D * (a[h * s] + a[(h + 1) * s]);
  a[(n - 1) * s] -= G * (a[(h - 1) * s] + a[(h - 2) * s]);
  for (size_t y = 0; y + 1 < h; ++y)
    a[(h + y) * s] -= G * (a[y * s] + a[(y + 1) * s]);
  for (size_t y = 1; y < h; ++y)
    t[2 * y * s] = a[y * s] - B * (a[(h + y) * s] + a[(h + y - 1) * s]);
  t[0] = a[0] - B * (a[h * s] + a[(h + 1) * s]);
  t[(n - 1) * s] = a[(n - 1) * s] - 2 * A * t[(n - 2) * s];
  for (size_t y = 0; y + 1 < h; ++y)
    t[(2 * y + 1) * s] = a[(h + y) * s] - A * (t[2 * y * s] + t[(2 * y + 2) * s]);
}

// Inverse row pass: t (in place) -> a, interleaved columns.  dwt.h:115-145.
static void inv_row(Plane& p, size_t row, size_t n) {
  float* a = p.a.data() + row * p.stride;
  float* t = p.t.data() + row * p.stride;
  const size_t h = n / 2;
  for (size_t x = 0; x < h; ++x) {
    t[x] /= X;
    t[h + x] *= X;
  }
  for (size_t x = 1; x < h; ++x) t[x] -= D * (t[h + x] + t[h + x - 1]);
  t[0] -= D * (t[h] + t[h + 1]);
  t[n - 1] -= G * (t[h - 1] + t[h - 2]);
  for (size_t x = 0; x + 1 < h; ++x) t[h + x] -= G * (t[x] + t[x + 1]);
  for (size_t x = 1; x < h; ++x)
    a[2 * x] = t[x] - B * (t[h + x] + t[h + x - 1]);
  a[0] = t[0] - B * (t[h] + t[h + 1]);
  a[n - 1] = t[n - 1] - 2 * A * a[n - 2];
  for (size_t x = 0; x + 1 < h; ++x)
    a[2 * x + 1] = t[h + x] - A * (a[2 * x] + a[2 * x + 2]);
}

// Mallat pyramid drivers (dwt.h:293-317): forward shrinks, inverse grows.
static void fwd_multi(Plane& p) {
  size_t nx = p.px(), ny = p.py();
  for (size_t st = 0; st < p.stages; ++st) {
    for (size_t y = 0; y < ny; ++y) fwd_row(p, y, nx);
    for (size_t x = 0; x < nx; ++x) fwd_col(p, x, ny);
    nx /= 2;
    ny /= 2;
  }
}

static void inv_multi(Plane& p) {
  size_t nx = p.px() >> (p.stages - 1), ny = p.py() >> (p.stages - 1);
  for (size_t st = 0; st < p.stages; ++st) {
    for (size_t x = 0; x < nx; ++x) inv_col(p, x, ny);
    for (size_t y = 0; y < ny; ++y) inv_row(p, y, nx);
    nx *= 2;
    ny *= 2;
  }
}

// ---------------------------------------------------------------------------
// SPIHT state machine
// ---------------------------------------------------------------------------

// Append-order list with tombstoned removals compacted after each pass
// (semantics of ml.h: entries pushed mid-pass are visited in the same pass,
// survivor order is preserved).
struct PassList {
  std::vector<int64_t> items;
  std::vector<char> dead;

  void push(int64_t v) {
    items.push_back(v);
    dead.push_back(0);
  }
  void compact() {
    size_t j = 0;
    for (size_t i = 0; i < items.size(); ++i)
      if (!dead[i]) items[j++] = items[i];
    items.resize(j);
    dead.assign(j, 0);
  }
};

static inline bool sig_pixel(int step, float v) {
  // spiht_re.c:119-125: truncate-toward-zero then magnitude test.  The
  // reference shifts a plain int (`1 << step`); coefficients here are
  // bounded far below 2^31 so a 64-bit shift is equivalent and defined.
  return std::llabs(static_cast<int64_t>(v)) >= (int64_t{1} << step);
}

// Spatial-orientation-tree child locator (spiht_re.c:127-158): inside the
// first-stage band, odd coordinates map across the band; elsewhere (x,y) ->
// (2x,2y).  Returns false when there are no descendants.
static inline bool successor(int64_t x, int64_t y, const Plane& p,
                             int64_t* sx, int64_t* sy) {
  const int64_t pxw = static_cast<int64_t>(p.px());
  const int64_t pyh = static_cast<int64_t>(p.py());
  const int64_t lx = pxw >> p.stages, ly = pyh >> p.stages;
  if (x < lx && y < ly) {
    int64_t nx = (x % 2 == 1) ? x + lx - 1 : x;
    int64_t ny = (y % 2 == 1) ? y + ly - 1 : y;
    if (nx == x && ny == y) return false;
    *sx = nx;
    *sy = ny;
    return true;
  }
  int64_t nx = 2 * x, ny = 2 * y;
  if (nx >= pxw || ny >= pyh) return false;
  *sx = nx;
  *sy = ny;
  return true;
}

// Recursive descendant-significance tests (spiht_re.c:160-206).  Type A
// covers all descendants (depth>1); type B excludes the direct children
// (depth>2).
static bool sig_descendants(int step, const Plane& p, int64_t pix, int depth,
                            int skip_below) {
  if (depth > skip_below && sig_pixel(step, p.a[pix])) return true;
  const int64_t s = static_cast<int64_t>(p.stride);
  int64_t sx, sy;
  if (!successor(pix % s, pix / s, p, &sx, &sy)) return false;
  return sig_descendants(step, p, sx + sy * s, depth + 1, skip_below) ||
         sig_descendants(step, p, sx + 1 + sy * s, depth + 1, skip_below) ||
         sig_descendants(step, p, sx + (sy + 1) * s, depth + 1, skip_below) ||
         sig_descendants(step, p, sx + 1 + (sy + 1) * s, depth + 1, skip_below);
}

struct Machine {
  PassList lip, lsp, lis;  // LIS items: +(pix+1)=type A, -(pix+1)=type B
  int step = 0;

  void seed(const Plane& p) {
    const size_t fx = p.px() >> p.stages, fy = p.py() >> p.stages;
    for (size_t y = 0; y < fy; ++y)
      for (size_t x = 0; x < fx; ++x) {
        const int64_t pix = static_cast<int64_t>(x + y * p.stride);
        lip.push(pix);
        if (x % 2 != 0 || y % 2 != 0) lis.push(pix + 1);
      }
  }
};

// Shared budget: the reference emits/consumes a bit FIRST and only then
// checks the count, so exactly one over-budget bit terminates each side.
struct Budget {
  size_t used = 0;
  size_t limit;
  explicit Budget(size_t l) : limit(l) {}
  bool spent() { return ++used > limit; }
};

static void encode_passes(const Plane& p, Machine& m, BitSink& out, Budget& b) {
  const int64_t stride = static_cast<int64_t>(p.stride);
  for (int step = m.step; step >= 0; --step) {
    // Sorting: insignificant pixels.
    for (size_t i = 0; i < m.lip.items.size(); ++i) {
      const int64_t pix = m.lip.items[i];
      const float v = p.a[pix];
      const bool sig = sig_pixel(step, v);
      out.put(sig);
      if (b.spent()) return;
      if (sig) {
        m.lsp.push(pix);
        out.put(v > 0 ? 0 : 1);
        if (b.spent()) return;
        m.lip.dead[i] = 1;
      }
    }
    m.lip.compact();

    // Sorting: insignificant sets (grows during the pass).
    for (size_t i = 0; i < m.lis.items.size(); ++i) {
      const int64_t entry = m.lis.items[i];
      if (entry > 0) {  // type A
        const int64_t pix = entry - 1;
        const int64_t x = pix % stride, y = pix / stride;
        const bool sig = sig_descendants(step, p, pix, 1, 1);
        out.put(sig);
        if (b.spent()) return;
        if (sig) {
          int64_t sx, sy;
          successor(x, y, p, &sx, &sy);
          for (int64_t dy = 0; dy < 2; ++dy)
            for (int64_t dx = 0; dx < 2; ++dx) {
              const int64_t child = sx + dx + (sy + dy) * stride;
              const float cv = p.a[child];
              const bool csig = sig_pixel(step, cv);
              out.put(csig);
              if (b.spent()) return;
              if (csig) {
                m.lsp.push(child);
                out.put(cv > 0 ? 0 : 1);
                if (b.spent()) return;
              } else {
                m.lip.push(child);
              }
            }
          int64_t gx, gy;
          if (successor(sx, sy, p, &gx, &gy)) m.lis.push(-(x + y * stride + 1));
          m.lis.dead[i] = 1;
        }
      } else {  // type B
        const int64_t pix = -entry - 1;
        const bool sig = sig_descendants(step, p, pix, 1, 2);
        out.put(sig);
        if (b.spent()) return;
        if (sig) {
          int64_t sx, sy;
          successor(pix % stride, pix / stride, p, &sx, &sy);
          m.lis.push(sx + sy * stride + 1);
          m.lis.push(sx + 1 + sy * stride + 1);
          m.lis.push(sx + (sy + 1) * stride + 1);
          m.lis.push(sx + 1 + (sy + 1) * stride + 1);
          m.lis.dead[i] = 1;
        }
      }
    }
    m.lis.compact();

    // Refinement: pixels significant before this step emit magnitude bit
    // `step` (entries added this step fail the step+1 test and are skipped).
    for (size_t i = 0; i < m.lsp.items.size(); ++i) {
      const float v = p.a[m.lsp.items[i]];
      if (sig_pixel(step + 1, v)) {
        out.put(static_cast<uint8_t>(
            (std::llabs(static_cast<int64_t>(v)) >> step) & 1));
        if (b.spent()) return;
      }
    }
  }
}

static void decode_passes(Plane& p, Machine& m, BitSource& in, Budget& b) {
  const int64_t stride = static_cast<int64_t>(p.stride);
  for (int step = m.step; step >= 0; --step) {
    for (size_t i = 0; i < m.lip.items.size(); ++i) {
      const int64_t pix = m.lip.items[i];
      const bool sig = in.get();
      if (b.spent()) return;
      if (sig) {
        m.lsp.push(pix);
        p.a[pix] = static_cast<float>(
            (in.get() ? -1 : 1) * (int64_t{1} << step));
        if (b.spent()) return;
        m.lip.dead[i] = 1;
      }
    }
    m.lip.compact();

    for (size_t i = 0; i < m.lis.items.size(); ++i) {
      const int64_t entry = m.lis.items[i];
      if (entry > 0) {
        const int64_t pix = entry - 1;
        const int64_t x = pix % stride, y = pix / stride;
        const bool sig = in.get();
        if (b.spent()) return;
        if (sig) {
          int64_t sx, sy;
          successor(x, y, p, &sx, &sy);
          for (int64_t dy = 0; dy < 2; ++dy)
            for (int64_t dx = 0; dx < 2; ++dx) {
              const int64_t child = sx + dx + (sy + dy) * stride;
              const bool csig = in.get();
              if (b.spent()) return;
              if (csig) {
                m.lsp.push(child);
                p.a[child] = static_cast<float>(
                    (in.get() ? -1 : 1) * (int64_t{1} << step));
                if (b.spent()) return;
              } else {
                m.lip.push(child);
              }
            }
          int64_t gx, gy;
          if (successor(sx, sy, p, &gx, &gy)) m.lis.push(-(x + y * stride + 1));
          m.lis.dead[i] = 1;
        }
      } else {
        const int64_t pix = -entry - 1;
        const bool sig = in.get();
        if (b.spent()) return;
        if (sig) {
          int64_t sx, sy;
          successor(pix % stride, pix / stride, p, &sx, &sy);
          m.lis.push(sx + sy * stride + 1);
          m.lis.push(sx + 1 + sy * stride + 1);
          m.lis.push(sx + (sy + 1) * stride + 1);
          m.lis.push(sx + 1 + (sy + 1) * stride + 1);
          m.lis.dead[i] = 1;
        }
      }
    }
    m.lis.compact();

    for (size_t i = 0; i < m.lsp.items.size(); ++i) {
      const int64_t pix = m.lsp.items[i];
      const float v = p.a[pix];
      const int64_t vi = static_cast<int64_t>(v);
      if (sig_pixel(step + 1, v)) {
        // Reconstructions are sign*(magnitude with zero low bits), so the
        // two's-complement bit ops below equal magnitude-domain set/clear
        // (mirrors spiht_re.c:400-409 exactly).
        if (in.get()) {
          p.a[pix] = static_cast<float>(
              vi >= 0 ? (vi | (int64_t{1} << step))
                      : -((-vi) | (int64_t{1} << step)));
        } else {
          p.a[pix] = static_cast<float>(vi & ~(int64_t{1} << step));
        }
        if (b.spent()) return;
      }
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

// Capability sentinel for the ctypes loader.
int etpu_has_spiht(void) { return 1; }

// Encode `height*width` floats (caller pre-normalizes into [0,1]) into an
// IMS stream.  trunc_bits==0 means unlimited (2^28 budget).  Returns the
// byte size and malloc()s *out (free with etpu_free_buffer), or 0 on
// invalid arguments.  Mirrors spiht_encode (spiht_re.c:432-475).
size_t etpu_spiht_encode(const float* buffer, size_t height, size_t width,
                         size_t trunc_bits, size_t num_stages, uint8_t** out) {
  if (!buffer || !out || num_stages < 1 || num_stages > 32) return 0;
  if (height < 1 || height > 2047 || width < 1 || width > 2047) return 0;

  Plane p;
  p.size_x = width;
  p.size_y = height;
  p.stages = num_stages;
  const size_t unit = size_t{1} << (num_stages + 1);
  p.extra_x = (unit - width % unit) % unit;
  p.extra_y = (unit - height % unit) % unit;
  if (p.extra_x > 511 || p.extra_y > 511) return 0;
  p.stride = p.px();
  p.a.assign(p.px() * p.py(), 0.0f);
  p.t.assign(p.px() * p.py(), 0.0f);

  // Load scaled payload + mirror extension; the pad-corner stays zero
  // (dwt.h:48-76).
  for (size_t y = 0; y < height; ++y)
    for (size_t x = 0; x < width; ++x)
      p.a[x + y * p.stride] = buffer[y * width + x] * kScale;
  for (size_t y = 0; y < height; ++y)
    for (size_t x = 0; x < p.extra_x; ++x)
      p.a[width + x + y * p.stride] = p.a[width - x - 1 + y * p.stride];
  for (size_t x = 0; x < width; ++x)
    for (size_t y = 0; y < p.extra_y; ++y)
      p.a[x + (height + y) * p.stride] = p.a[x + (height - y - 1) * p.stride];

  // DC removal: floored mean over the padded plane (dwt.h:319-336).
  double mean = 0.0;
  for (float v : p.a) mean += v;
  mean = std::floor(mean / static_cast<double>(p.a.size()));
  if (mean < 0 || mean > 255) return 0;  // input outside the [0,1] contract
  const float dc = static_cast<float>(mean);
  for (float& v : p.a) v -= dc;

  BitSink sink;
  sink.put_many('I', 8);
  sink.put_many('M', 8);
  sink.put_many('S', 8);
  sink.put_many(num_stages, 6);
  sink.put_many(width, 12);
  sink.put_many(height, 12);
  sink.put_many(p.extra_x, 10);
  sink.put_many(p.extra_y, 10);
  sink.put(0);  // is_color
  const size_t bits0 =
      (trunc_bits == 0) ? (size_t{1} << 28) : trunc_bits + kBudgetOffset;
  sink.put_many(bits0, 29);
  sink.put_many(static_cast<uint8_t>(dc), 8);

  fwd_multi(p);
  for (float& v : p.a) v = std::trunc(v);  // normalize(), dwt.h:355-368

  float maxmag = 2.0f;  // step >= 1 floor, spiht_re.c:33
  for (float v : p.a) maxmag = std::max(maxmag, std::fabs(v));
  const int step =
      static_cast<int>(std::floor(std::log(maxmag) / std::log(2.0)));
  if (step > kMaxStep) return 0;
  sink.put_many(static_cast<uint64_t>(step), 8);

  Machine m;
  m.step = step;
  m.seed(p);
  Budget budget(bits0 - kBudgetOffset);
  encode_passes(p, m, sink, budget);

  std::vector<uint8_t> bytes = sink.finish();
  *out = static_cast<uint8_t*>(std::malloc(bytes.size() ? bytes.size() : 1));
  if (!*out) return 0;
  std::memcpy(*out, bytes.data(), bytes.size());
  return bytes.size();
}

// Decode an IMS stream into `height*width` floats (the [0,1]-normalized
// residual).  num_bits is the caller's budget (stream bytes * 8); the
// header's bits0 caps it.  Returns 0 on success, nonzero on malformed
// input.  Mirrors spiht_decode (spiht_re.c:477-520).
int etpu_spiht_decode(const uint8_t* data, size_t size, float* out,
                      size_t height, size_t width, size_t num_bits) {
  if (!data || !out) return 1;
  BitSource src(data, size);
  if (src.get_many(8) != 'I' || src.get_many(8) != 'M' ||
      src.get_many(8) != 'S')
    return 2;
  const size_t stages = src.get_many(6);
  const size_t size_x = src.get_many(12);
  const size_t size_y = src.get_many(12);
  const size_t extra_x = src.get_many(10);
  const size_t extra_y = src.get_many(10);
  src.get();  // is_color (always 0 here)
  const size_t bits0 = src.get_many(29);
  if (stages < 1 || stages > 32 || size_x < 1 || size_y < 1) return 3;
  if (size_x != width || size_y != height) return 4;
  const size_t unit = size_t{1} << stages;
  if ((size_x + extra_x) % unit != 0 || (size_y + extra_y) % unit != 0)
    return 5;
  if (num_bits > bits0) num_bits = bits0;
  if (num_bits <= kBudgetOffset) return 6;
  num_bits -= kBudgetOffset;
  const float dc = static_cast<float>(src.get_many(8));

  Plane p;
  p.size_x = size_x;
  p.size_y = size_y;
  p.extra_x = extra_x;
  p.extra_y = extra_y;
  p.stages = stages;
  p.stride = p.px();
  p.a.assign(p.px() * p.py(), 0.0f);
  p.t.assign(p.px() * p.py(), 0.0f);

  Machine m;
  m.step = static_cast<int>(src.get_many(8));
  if (m.step > kMaxStep) return 7;
  m.seed(p);
  Budget budget(num_bits);
  decode_passes(p, m, src, budget);

  inv_multi(p);
  // add_dc (dwt.h:338-353): floor then clamp to [0, 255].
  for (float& v : p.a) {
    float r = std::floor(v + dc);
    v = r > kScale ? kScale : (r < 0.0f ? 0.0f : r);
  }
  for (size_t y = 0; y < height; ++y)
    for (size_t x = 0; x < width; ++x)
      out[y * width + x] = p.a[x + y * p.stride] / kScale;
  return 0;
}

}  // extern "C"
