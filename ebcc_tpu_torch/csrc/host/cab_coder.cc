/* ebcc_tpu_torch: the port's copy of ebcc_tpu/native/cab_coder.cc, unchanged below
 * this line; CAB bytes and stream bytes must stay the original's. */
/* Context-adaptive binary arithmetic coder for ETPU bitplane payloads.
 *
 * Role parity: the reference's compression ratio rests on two strong
 * entropy coders — OpenJPEG's EBCOT/MQ coder inside the J2K base layer and
 * SPIHT's zerotree structure + zstd-22 for the residual (reference
 * src/ebcc_codec.c:105-180,816).  The TPU build's dense-bitplane payloads
 * compress well under zstd but leave the neighbor correlation of wavelet
 * significance on the table (the CR risk called out in the survey).  This
 * coder recovers it with the textbook EBCOT-family model:
 *
 *   - running significance state per coefficient, planes MSB->LSB;
 *   - significance bits coded with a context from the 8-neighbor
 *     significance count, the subband orientation class, and the
 *     same-orientation parent's significance (zerotree correlation);
 *   - a run mode (EBCOT RLC analog): a row-group of 4 insignificant
 *     coefficients codes ONE "any significant" bit, plus a 2-bit break
 *     position when set — sparse planes cost a quarter of the coder calls
 *     and fewer bits;
 *   - hierarchical skip tiers above the groups (16-wide segment, 64-wide
 *     super-segment, whole row), each one "any" bit;
 *   - sign bits coded with a left/up-neighbor sign context;
 *   - refinement bits coded with first/later contexts;
 *   - an adaptive binary range coder (32-bit window, in-buffer carry
 *     propagation, 12-bit probabilities with shift-5 adaptation).
 *
 * TWO PROFILES share the model and the code (a template parameter):
 *
 *   backend 2 (strict): a group/tier is run-mode eligible only when every
 *     member has a fully clear neighborhood (EBCOT's RLC rule).  Max
 *     ratio; every neighbored position costs one coder call per plane.
 *   backend 4 (relaxed, "CAB2"): eligibility only requires that no MEMBER
 *     is yet significant; groups/tiers whose neighborhoods are active
 *     ("dirty") use separate contexts (bucketed by active-neighbor count
 *     at the group level) so the clean statistics stay skewed.  ~2.2x
 *     fewer coder calls for ~1-2% stream growth on the bench payloads —
 *     the throughput profile.
 *
 * Host-side C++ only (the accelerator never runs entropy code); the
 * payload structure stays "dense planes + sign plane", so both backends
 * are drop-in replacements for the zstd wrap.
 */

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BinProb {
  uint16_t p0 = 1 << 11; /* P(bit == 0), 12-bit fixed point */
  uint16_t hits = 0;     /* two-speed: adapt fast until warmed up */
  inline void update(int bit) {
    const int sh = hits < 32 ? 4 : 5;
    if (hits < 32) ++hits;
    if (bit)
      p0 -= p0 >> sh;
    else
      p0 += (4096 - p0) >> sh;
  }
};

class RangeEncoder {
 public:
  void encode(int bit, BinProb *ctx) {
    uint32_t split = (uint32_t)(((uint64_t)range_ * ctx->p0) >> 12);
    if (split == 0) split = 1;
    if (split >= range_) split = range_ - 1;
    if (!bit) {
      range_ = split;
    } else {
      low_ += split;
      if (low_ >> 32) { /* carry: ripple into emitted bytes */
        for (size_t i = out_.size(); i-- > 0;) {
          if (++out_[i] != 0) break;
        }
        low_ &= 0xFFFFFFFFull;
      }
      range_ -= split;
    }
    ctx->update(bit);
    while (range_ < (1u << 24)) {
      out_.push_back((uint8_t)(low_ >> 24));
      low_ = (low_ << 8) & 0xFFFFFFFFull;
      range_ <<= 8;
    }
  }

  void finish() {
    for (int i = 0; i < 4; ++i) {
      out_.push_back((uint8_t)(low_ >> 24));
      low_ = (low_ << 8) & 0xFFFFFFFFull;
    }
  }

  std::vector<uint8_t> out_;

 private:
  uint64_t low_ = 0;
  uint32_t range_ = 0xFFFFFFFFu;
};

class RangeDecoder {
 public:
  RangeDecoder(const uint8_t *data, size_t n) : data_(data), n_(n) {
    for (int i = 0; i < 4; ++i) code_ = (code_ << 8) | next();
  }

  int decode(BinProb *ctx) {
    uint32_t split = (uint32_t)(((uint64_t)range_ * ctx->p0) >> 12);
    if (split == 0) split = 1;
    if (split >= range_) split = range_ - 1;
    int bit;
    if (code_ < split) {
      bit = 0;
      range_ = split;
    } else {
      bit = 1;
      code_ -= split;
      range_ -= split;
    }
    ctx->update(bit);
    while (range_ < (1u << 24)) {
      code_ = ((code_ << 8) | next()) & 0xFFFFFFFFull;
      range_ <<= 8;
    }
    return bit;
  }

 private:
  uint8_t next() { return pos_ < n_ ? data_[pos_++] : 0; }
  const uint8_t *data_;
  size_t n_;
  size_t pos_ = 0;
  uint64_t code_ = 0;
  uint32_t range_ = 0xFFFFFFFFu;
};

/* Subband orientation class per (row, col) of the padded Mallat layout:
 * 0 = deepest LL, 1 = HL, 2 = LH, 3 = HH (orientation of the band the
 * coefficient belongs to, any level). */
void build_class_map(int hp, int wp, int levels, std::vector<uint8_t> *cls) {
  cls->assign((size_t)hp * wp, 3);
  for (int r = 0; r < hp; ++r) {
    for (int c = 0; c < wp; ++c) {
      uint8_t v = 3;
      if (r < (hp >> levels) && c < (wp >> levels)) {
        v = 0; /* deepest LL */
      } else {
        for (int l = levels; l >= 1; --l) {
          /* inside the level-(l-1) LL block => belongs to a level-l band */
          if (r < (hp >> (l - 1)) && c < (wp >> (l - 1))) {
            const int hl = hp >> l, wl = wp >> l;
            v = (r < hl) ? 1 : (c < wl ? 2 : 3);
            break;
          }
        }
      }
      (*cls)[(size_t)r * wp + c] = v;
    }
  }
}

constexpr int kSigCtx = 4 * 9 * 2; /* orientation x neighbors x parent-sig */
constexpr int kSignCtx = 9;
constexpr int kRefCtx = 3; /* first-no-neighbors / first-with / later */
constexpr int kRunLen = 4;  /* row-group length for run mode */
constexpr int kSegLen = 16; /* hierarchical segment: 4 run groups */
constexpr int kSupLen = 64; /* super-segment: 4 segments */

struct Contexts {
  BinProb sig[kSigCtx];
  BinProb sign[kSignCtx];
  BinProb ref[kRefCtx];
  BinProb run;       /* "any of the 4 becomes significant" (clean group) */
  BinProb runpos[2]; /* 2-bit break position, MSB first */
  BinProb seg;       /* "any of a 16-wide all-eligible segment" */
  BinProb sup;       /* "any of a 64-wide all-eligible super-segment" */
  BinProb row;       /* "any of a fully-eligible row" */
  /* Relaxed-profile (backend 4) extras: dirty-tier variants so active
   * neighborhoods don't pollute the heavily-skewed clean statistics.
   * The strict profile never touches them. */
  BinProb rund[3]; /* dirty group, bucketed by nonzero-blk count 1/2/3+ */
  BinProb segd, supd, rowd;

  /* Skewed priors: significance bits are mostly 0 (sparse planes) and run
   * groups mostly stay zero, so starting those contexts at P(0)=0.8/0.9
   * instead of 0.5 saves the adaptation warm-up — worth a few percent on
   * small chunks where warm-up is a visible fraction of the stream. */
  Contexts() {
    for (auto &c : sig) c.p0 = (uint16_t)(4096 * 4 / 5);
    run.p0 = (uint16_t)(4096 * 9 / 10);
    seg.p0 = (uint16_t)(4096 * 9 / 10);
    sup.p0 = (uint16_t)(4096 * 9 / 10);
    row.p0 = (uint16_t)(4096 * 9 / 10);
    for (auto &c : rund) c.p0 = (uint16_t)(4096 * 7 / 10);
    segd.p0 = (uint16_t)(4096 * 7 / 10);
    supd.p0 = (uint16_t)(4096 * 7 / 10);
    rowd.p0 = (uint16_t)(4096 * 7 / 10);
  }
};

/* Per-thread scratch: the coder state arrays are ~30 MB for an 8-frame
 * 721x1440 payload; a fresh vector per call means ~7k page faults per
 * call on first touch.  Reused buffers turn that into plain memsets, and
 * the class map (shape-keyed) skips its rebuild entirely for the common
 * same-shape-chunks case. */
struct Scratch {
  std::vector<uint8_t> sig, refined, nb; /* nb: hi nibble = #significant
                                          * neighbors, lo = blk count */
  std::vector<uint32_t> rowcnt, supcnt, segcnt;
  std::vector<uint32_t> srowcnt, ssupcnt, ssegcnt;
  std::vector<uint8_t> cls;
  int cls_hp = -1, cls_wp = -1, cls_levels = -1;

  static void zero8(std::vector<uint8_t> &v, size_t n) {
    if (v.size() < n) v.resize(n);
    std::memset(v.data(), 0, n);
  }
  static void zero32(std::vector<uint32_t> &v, size_t n) {
    if (v.size() < n) v.resize(n);
    std::memset(v.data(), 0, n * sizeof(uint32_t));
  }
  void prepare(size_t n, size_t rows, size_t nsup, size_t nseg, int hp,
               int wp, int levels, bool relaxed) {
    zero8(sig, n);
    zero8(refined, n);
    zero8(nb, n);
    zero32(rowcnt, rows);
    zero32(supcnt, rows * nsup);
    if (!relaxed) {
      zero32(segcnt, rows * nseg);
    } else {
      zero32(srowcnt, rows);
      zero32(ssupcnt, rows * nsup);
      zero32(ssegcnt, rows * nseg);
    }
    if (cls_hp != hp || cls_wp != wp || cls_levels != levels) {
      build_class_map(hp, wp, levels, &cls);
      cls_hp = hp;
      cls_wp = wp;
      cls_levels = levels;
    }
  }
};

thread_local Scratch g_scratch;

/* sig array bit layout: bit 0 = significant, bit 1 = negative (so the
 * sign context needs ONE load per neighbor). */
constexpr uint8_t kSig = 1, kNeg = 2;

inline int sign_context(const uint8_t *sig, int r, int c, int hp, int wp,
                        size_t base) {
  /* left/up contributions in {-1, 0, +1} -> 9 contexts */
  auto contrib = [&](int rr, int cc) -> int {
    if (rr < 0 || cc < 0 || rr >= hp || cc >= wp) return 0;
    const uint8_t v = sig[base + (size_t)rr * wp + cc];
    if (!(v & kSig)) return 0;
    return (v & kNeg) ? -1 : 1;
  };
  const int h = contrib(r, c - 1);
  const int v = contrib(r - 1, c);
  return (h + 1) * 3 + (v + 1);
}

/* Walk the payload (kept magnitude planes + sign plane, MSB-first packing
 * along width) coding or decoding every bit with the shared model.
 * kRelaxed selects the backend-4 profile (see file header). */
template <bool kEncode, bool kRelaxed>
void walk(uint8_t *payload, int kept, int d0, int hp, int wp, int levels,
          RangeEncoder *enc, RangeDecoder *dec) {
  const int wb = wp / 8;
  const size_t plane_bytes = (size_t)d0 * hp * wb;
  const size_t n = (size_t)d0 * hp * wp;
  const int nsup = (wp + kSupLen - 1) / kSupLen;
  const int nseg = (wp + kSegLen - 1) / kSegLen;
  Scratch &S = g_scratch;
  S.prepare(n, (size_t)d0 * hp, nsup, nseg, hp, wp, levels, kRelaxed);
  /* Incrementally-maintained coder state (bitstream-identical to the
   * recompute-per-position formulation this replaces):
   *   nsc[i] = number of significant 8-neighbors (a context input; max 8,
   *            so uint8 never saturates);
   *   blk[i] = sig[i] + sig[parent(i)] + nsc[i] — zero exactly when the
   *            coefficient's neighborhood is fully clear;
   *   rowcnt/supcnt/segcnt[f, r(, tile)] = number of NONZERO blk bytes in
   *            the row / 64-wide super-segment / 16-wide segment, so every
   *            skip-tier test is one counter load instead of a byte scan;
   *   s*cnt   = same counters over SIGNIFICANT members (relaxed profile's
   *            eligibility predicate).
   * All are updated only on the sig 0->1 transition, mirroring exactly
   * what live recomputation would observe mid-row. */
  uint8_t *sig = S.sig.data();
  uint8_t *refined = S.refined.data();
  /* nb packs both neighborhood counters into ONE byte per coefficient:
   * high nibble = significant-neighbor count (context input, <= 8), low
   * nibble = blk = sig + parent_sig + nsc (<= 10, the run-eligibility
   * state).  nsc > 0 implies blk > 0, so byte == 0 <=> blk == 0 and all
   * eligibility scans/loads keep their semantics while mark_significant
   * does ONE read-modify-write per neighbor instead of two. */
  uint8_t *nb = S.nb.data();
  const uint8_t *cls = S.cls.data();
  Contexts ctx;

  /* sig 0->1 transition: bump the 8 neighbors' counts, unblock-proof the
   * children (cells whose parent is (r, c) sit at (2r+dr, 2c+dc)), and
   * count the cell itself.  (0,0) is its own parent; the extra +1 it gets
   * as its own child only matters for blk != 0, which stays correct.
   * ``frbase`` = f * hp (the row-counter base for this frame). */
  auto bump_nb = [&](size_t base, size_t frbase, int rr, int cc,
                     uint8_t add) {
    uint8_t &b = nb[base + (size_t)rr * wp + cc];
    const uint8_t old = b;
    b = (uint8_t)(old + add);
    if (old == 0) {
      const size_t fr = frbase + rr;
      ++S.rowcnt[fr];
      /* Strict eligibility needs both tile counters; the relaxed profile
       * keys its clean/dirty context choice on the 64-wide counter (the
       * 16-wide one is the costliest and least informative — dropping it
       * measured +0.1% size for ~6% walk time). */
      ++S.supcnt[fr * nsup + (cc / kSupLen)];
      if (!kRelaxed) ++S.segcnt[fr * nseg + (cc / kSegLen)];
    }
  };
  auto mark_significant = [&](size_t base, size_t frbase, int r, int c,
                              size_t i) {
    sig[i] |= kSig;
    if (kRelaxed) {
      const size_t fr = frbase + r;
      ++S.srowcnt[fr];
      ++S.ssupcnt[fr * nsup + (c / kSupLen)];
      ++S.ssegcnt[fr * nseg + (c / kSegLen)];
    }
    bump_nb(base, frbase, r, c, 0x01);       /* self: blk only */
    const int ra = r > 0 ? r - 1 : 0, rb = r + 1 < hp ? r + 1 : hp - 1;
    const int ca = c > 0 ? c - 1 : 0, cb = c + 1 < wp ? c + 1 : wp - 1;
    for (int rr = ra; rr <= rb; ++rr)
      for (int cc = ca; cc <= cb; ++cc) {
        if (rr == r && cc == c) continue;
        bump_nb(base, frbase, rr, cc, 0x11); /* neighbor: nsc + blk */
      }
    for (int rr = 2 * r; rr <= 2 * r + 1 && rr < hp; ++rr)
      for (int cc = 2 * c; cc <= 2 * c + 1 && cc < wp; ++cc)
        bump_nb(base, frbase, rr, cc, 0x01); /* child: blk only */
  };

  uint8_t *signs = payload + (size_t)kept * plane_bytes;
  for (int s = 0; s < kept; ++s) {
    uint8_t *plane = payload + (size_t)s * plane_bytes;
    for (int f = 0; f < d0; ++f) {
      const size_t base = (size_t)f * hp * wp;
      const size_t frbase = (size_t)f * hp;
      const size_t bbase = (size_t)f * hp * wb;
      for (int r = 0; r < hp; ++r) {
        const uint8_t *brow = nb + base + (size_t)r * wp;
        uint8_t *prow = plane + bbase + (size_t)r * wb;
        uint8_t *srow = signs + bbase + (size_t)r * wb;
        uint8_t *sig_row = sig + base + (size_t)r * wp;
        uint8_t *ref_row = refined + base + (size_t)r * wp;
        const uint8_t *nb_row = nb + base + (size_t)r * wp;
        const uint8_t *cls_row = cls + (size_t)r * wp;
        const uint8_t *psig_row = sig + base + (size_t)(r >> 1) * wp;
        const size_t fr = frbase + r;
        const uint32_t *sup_row = S.supcnt.data() + fr * nsup;
        const uint32_t *seg_row = kRelaxed ? nullptr
                                           : S.segcnt.data() + fr * nseg;
        const bool row_clean = S.rowcnt[fr] == 0;
        const uint32_t *ssup_row = kRelaxed ? S.ssupcnt.data() + fr * nsup
                                            : nullptr;
        const uint32_t *sseg_row = kRelaxed ? S.ssegcnt.data() + fr * nseg
                                            : nullptr;
        /* Any plane bit set in [a, a+len); the skip tiers call this with
         * byte-aligned ranges only (a % 8 == 0, len % 8 == 0). */
        auto range_any = [&](int a, int len) -> int {
          const uint8_t *p = prow + a / 8;
          const int nb = len / 8;
          uint64_t acc = 0;
          int k = 0;
          for (; k + 8 <= nb; k += 8) {
            uint64_t v;
            std::memcpy(&v, p + k, 8);
            acc |= v;
          }
          for (; k < nb; ++k) acc |= p[k];
          return acc ? 1 : 0;
        };
        /* Shared significance->sign transition for a coefficient that just
         * became significant in this plane. */
        auto code_newly_significant = [&](int c, size_t i, uint8_t mask) {
          const int xc = sign_context(sig, r, c, hp, wp, base);
          int sbit;
          if (kEncode) {
            sbit = (srow[c >> 3] & mask) ? 1 : 0;
            enc->encode(sbit, &ctx.sign[xc]);
          } else {
            sbit = dec->decode(&ctx.sign[xc]);
            if (sbit) srow[c >> 3] |= mask;
          }
          mark_significant(base, frbase, r, c, i);
          if (sbit) sig[i] |= kNeg;
        };
        auto code_position = [&](int c) {
          const uint8_t mask = (uint8_t)(1u << (7 - (c & 7)));
          if (!(sig_row[c] & kSig)) {
            /* zerotree-style parent context: in the in-place Mallat layout
             * the same-orientation parent of any detail coefficient sits at
             * (r>>1, c>>1). */
            const int psig = (psig_row[c >> 1] & kSig) ? 1 : 0;
            const int sc =
                (cls_row[c] * 9 + (nb_row[c] >> 4)) * 2 + psig;
            int bit;
            if (kEncode) {
              bit = (prow[c >> 3] & mask) ? 1 : 0;
              enc->encode(bit, &ctx.sig[sc]);
            } else {
              bit = dec->decode(&ctx.sig[sc]);
              if (bit) prow[c >> 3] |= mask;
            }
            if (bit)
              code_newly_significant(c, base + (size_t)r * wp + c, mask);
          } else {
            /* EBCOT's 3 magnitude-refinement contexts: the first
             * refinement distinguishes active neighborhoods. */
            const int rc = ref_row[c] ? 2 : (nb_row[c] >> 4 ? 1 : 0);
            if (kEncode) {
              const int bit = (prow[c >> 3] & mask) ? 1 : 0;
              enc->encode(bit, &ctx.ref[rc]);
            } else {
              if (dec->decode(&ctx.ref[rc])) prow[c >> 3] |= mask;
            }
            ref_row[c] = 1;
          }
        };
        /* Hierarchical skip (zerotree-flavoured): a fully-eligible ROW
         * codes ONE "any" bit, then each 64-wide all-eligible
         * super-segment one, then each 16-wide segment one — sparse top
         * planes cost ~1 coded bit per row.  Eligibility depends only on
         * coder state shared with the decoder (and the zero branches
         * change no state), so both sides agree. */
        const bool row_elig = kRelaxed ? (S.srowcnt[fr] == 0)
                                       : (S.rowcnt[fr] == 0);
        if (wp % kRunLen == 0 && row_elig) {
          BinProb *rctx = (!kRelaxed || row_clean) ? &ctx.row : &ctx.rowd;
          int row_any;
          if (kEncode) {
            row_any = range_any(0, wp);
            enc->encode(row_any, rctx);
          } else {
            row_any = dec->decode(rctx);
          }
          if (!row_any) continue; /* whole row stays zero this plane */
        }
        for (int u0 = 0; u0 < wp; u0 += kSupLen) {
          const int uend = u0 + kSupLen <= wp ? u0 + kSupLen : wp;
          const bool sup_elig = (uend - u0) == kSupLen &&
              (kRelaxed ? ssup_row[u0 / kSupLen] == 0
                        : sup_row[u0 / kSupLen] == 0);
          if (sup_elig) {
            BinProb *sctx = (!kRelaxed || sup_row[u0 / kSupLen] == 0)
                                ? &ctx.sup : &ctx.supd;
            int sup_any;
            if (kEncode) {
              sup_any = range_any(u0, kSupLen);
              enc->encode(sup_any, sctx);
            } else {
              sup_any = dec->decode(sctx);
            }
            if (!sup_any) continue; /* all 64 stay zero this plane */
          }
        for (int s0 = u0; s0 < uend; s0 += kSegLen) {
          const int send = s0 + kSegLen <= uend ? s0 + kSegLen : uend;
          const bool seg_elig = (send - s0) == kSegLen &&
              (kRelaxed ? sseg_row[s0 / kSegLen] == 0
                        : seg_row[s0 / kSegLen] == 0);
          if (seg_elig) {
            BinProb *gctx = (!kRelaxed || sup_row[s0 / kSupLen] == 0)
                                ? &ctx.seg : &ctx.segd;
            int seg_any;
            if (kEncode) {
              seg_any = range_any(s0, kSegLen);
              enc->encode(seg_any, gctx);
            } else {
              seg_any = dec->decode(gctx);
            }
            if (!seg_any) continue; /* all 16 stay zero this plane */
          }
        for (int c0 = s0; c0 < send; c0 += kRunLen) {
          bool elig;
          uint32_t g4;
          std::memcpy(&g4, brow + c0, 4);
          BinProb *actx = &ctx.run;
          if (kRelaxed) {
            uint32_t s4;
            std::memcpy(&s4, sig_row + c0, 4);
            elig = s4 == 0;
            if (elig && g4 != 0) {
              const int nzb = (brow[c0] != 0) + (brow[c0 + 1] != 0) +
                              (brow[c0 + 2] != 0) + (brow[c0 + 3] != 0);
              actx = &ctx.rund[nzb >= 3 ? 2 : nzb - 1];
            }
          } else {
            elig = g4 == 0;
          }
          int cstart = c0;
          if (elig) {
            int any;
            /* kRunLen == 4 and c0 % 4 == 0: the group is one nibble of
             * the packed plane row. */
            const uint8_t nib_mask = (c0 % 8 == 0) ? 0xF0 : 0x0F;
            if (kEncode) {
              any = (prow[c0 / 8] & nib_mask) ? 1 : 0;
              enc->encode(any, actx);
            } else {
              any = dec->decode(actx);
            }
            if (!any) continue; /* whole group stays zero this plane */
            int first;
            if (kEncode) {
              first = 0;
              for (int k = 0; k < kRunLen; ++k) {
                const int c = c0 + k;
                if (prow[c / 8] & (uint8_t)(1u << (7 - (c % 8)))) {
                  first = k;
                  break;
                }
              }
              enc->encode((first >> 1) & 1, &ctx.runpos[0]);
              enc->encode(first & 1, &ctx.runpos[1]);
            } else {
              first = (dec->decode(&ctx.runpos[0]) << 1) |
                      dec->decode(&ctx.runpos[1]);
            }
            const int c = c0 + first;
            const size_t i = base + (size_t)r * wp + c;
            const uint8_t mask = (uint8_t)(1u << (7 - (c % 8)));
            if (!kEncode) prow[c >> 3] |= mask;
            code_newly_significant(c, i, mask);
            cstart = c + 1;
          }
          for (int c = cstart; c < c0 + kRunLen; ++c) code_position(c);
        }
        }
        }
      }
    }
  }
}

template <bool kRelaxed>
size_t cab_compress_impl(const uint8_t *payload, size_t payload_size,
                         int kept, int d0, int hp, int wp, int levels,
                         uint8_t **out) {
  if (kept <= 0 || wp % 8 != 0) return 0;
  const size_t expect = (size_t)(kept + 1) * d0 * hp * (wp / 8);
  if (payload_size != expect) return 0;
  RangeEncoder enc;
  /* walk reads the payload; const_cast is safe for the encode path */
  walk<true, kRelaxed>(const_cast<uint8_t *>(payload), kept, d0, hp, wp,
                       levels, &enc, nullptr);
  enc.finish();
  *out = (uint8_t *)std::malloc(enc.out_.size());
  if (!*out) return 0;
  std::memcpy(*out, enc.out_.data(), enc.out_.size());
  return enc.out_.size();
}

template <bool kRelaxed>
size_t cab_decompress_impl(const uint8_t *comp, size_t comp_size, int kept,
                           int d0, int hp, int wp, int levels,
                           uint8_t *out_payload, size_t payload_size) {
  if (kept <= 0 || wp % 8 != 0) return 0;
  const size_t expect = (size_t)(kept + 1) * d0 * hp * (wp / 8);
  if (payload_size != expect) return 0;
  std::memset(out_payload, 0, payload_size);
  RangeDecoder dec(comp, comp_size);
  walk<false, kRelaxed>(out_payload, kept, d0, hp, wp, levels, nullptr, &dec);
  return payload_size;
}

}  // namespace

extern "C" {

/* payload: kept magnitude planes + sign plane (raw ETPU layout).
 * Returns malloc'd compressed bytes via *out, or 0 on error. */
size_t etpu_cab_compress(const uint8_t *payload, size_t payload_size,
                         int kept, int d0, int hp, int wp, int levels,
                         uint8_t **out) {
  return cab_compress_impl<false>(payload, payload_size, kept, d0, hp, wp,
                                  levels, out);
}

/* Decompress into caller-provided payload buffer (zero-initialized here).
 * Returns payload_size on success, 0 on error. */
size_t etpu_cab_decompress(const uint8_t *comp, size_t comp_size, int kept,
                           int d0, int hp, int wp, int levels,
                           uint8_t *out_payload, size_t payload_size) {
  return cab_decompress_impl<false>(comp, comp_size, kept, d0, hp, wp,
                                    levels, out_payload, payload_size);
}

/* Backend 4 ("CAB2"): the relaxed-eligibility throughput profile.  Same
 * model, DIFFERENT bitstream — streams tagged backend 4 must decode with
 * these entry points and vice versa. */
size_t etpu_cab2_compress(const uint8_t *payload, size_t payload_size,
                          int kept, int d0, int hp, int wp, int levels,
                          uint8_t **out) {
  return cab_compress_impl<true>(payload, payload_size, kept, d0, hp, wp,
                                 levels, out);
}

size_t etpu_cab2_decompress(const uint8_t *comp, size_t comp_size, int kept,
                            int d0, int hp, int wp, int levels,
                            uint8_t *out_payload, size_t payload_size) {
  return cab_decompress_impl<true>(comp, comp_size, kept, d0, hp, wp,
                                   levels, out_payload, payload_size);
}

}  /* extern "C" */
