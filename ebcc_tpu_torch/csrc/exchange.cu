// Hand-written CUDA kernels (sm_90a) of the decode-direction exchange: X1,
// the blocked-Rice lane decode.
//
// Replaces XLA code of the JAX package, not a Pallas kernel: the 128-step
// lax.scan over 2 * n_blocks lanes of transfer.rice_block_unpack
// (ebcc_tpu/core/transfer.py:842), with the lane offsets it derives by
// cumsum (:858-861), and the scatter into the dense coefficient vector that
// follows it in kernels.rice_unpack_qflat (ebcc_tpu/core/kernels.py:1419).
//
// The host packs the sorted (position, value) pairs of a decode batch as
// element blocks of kBlock (128) entries, each block's gaps and zigzag
// values as two independent Rice-coded bit regions (lane b and lane nb + b)
// with their own parameter k (transfer.rice_block_pack_host; bit layout in
// csrc/host/rice_block_pack.cc).  A code is read from a 64-bit window at its
// start bit (the window's first word clipped to nw - 3); quotients >= kEsc
// escape to 32 raw bits, as the reference reads them.
//
// One call is a memset and two kernels on the caller's stream:
// - qflat is cleared by cudaMemsetAsync at full bandwidth;
// - lane_chunk_offsets (one CUDA block) sums the u16 lane lengths in
//   chunks of 32 lanes and writes each chunk's exclusive start, gap chunks
//   then value chunks, and the total gap bits (the value region's start);
// - rice_lanes gives each 128-pair block one warp (the warps stay resident
//   and take block after block).  The warp loads its chunk's 32 lengths
//   and finishes its two lane offsets with a warp scan, then stages both
//   lanes' words in shared memory with coalesced loads (a lane is at most
//   128 * 52 bits: 208 words, 211 with its last window).  Threads 0-15
//   take the gap lane and 16-31 the value lane, concurrently.  The 16
//   threads of a lane write the length of the code that would start at
//   each of its bits into a byte table in shared memory (kTab bits at a
//   time, 4 bits per thread from 3 staged words, one 32-bit store), with
//   zero lengths past the table's end.  One thread then walks the table
//   from start to start: the dependent chain is a shared-memory byte load
//   and an add per code, and the loop's test (a count) does not wait for
//   it; a walk that leaves the table stays on its first start past the
//   end (zero lengths), which a binary search over the ascending starts
//   finds.  All 16 threads then decode the codes at the starts.
//   Positions come from a warp prefix sum of the 128 gaps (shuffles) plus
//   base_pos, and the warp stores its 128 values straight into qflat.
// Chosen over three others that were slower on the card: 16 threads per
// lane decoding speculatively from segment borders until their entries
// agree (Rice chains with k >= 8 fall back into step slowly, so the rounds
// ran long); one thread per lane walking the staged words directly (every
// step a window and a count of trailing ones); and the table walked with a
// test of the table's end on every step (the loop then waits for each
// load before it can go on).
//
// Exactly as the plain version (transfer.rice_block_unpack and a scatter):
// a block decodes min(128, nnz - 128 * b) codes and lanes past nnz decode
// nothing; positions outside [0, n_out) are not stored; a window that is
// not staged (clipped at the stream's end, or past the lane's stated
// length) reads device memory with the same clip; codes past a lane's
// stated length (only a malformed upload) are read in sequence.  nnz is
// read on the device, so the call needs no synchronisation with the host.
// Offsets are 64-bit.
//
// What bounds it on an H100: bytes, the words read once and the dense
// qflat written once (8 B per grid coefficient of the two layers, 33.9 MB
// for a sub-batch of four 736 x 1440 frames) at 3.35 TB/s, about 0.0101 ms
// for a MAX_ERROR sub-batch and 0.012 ms for 2^22 pairs; the clearing of
// qflat alone takes about that.  What paces the decode kernel: the latency
// of one block (the walk of 128 codes, the table, a few dependent
// device-memory loads), and at high density also the warps an SM holds
// (6.4 KB of shared memory a warp).  The version before this one gave
// each block one thread that walked both lanes in step with three
// device-memory loads per code: 0.0322 ms for the kernel and 0.1465 ms
// for a call of 8 CUDA kernels on 11,715 pairs (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).
//
// Each launch is on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kBlock = 128;                        // transfer.RICE_BLOCK
constexpr int kEsc = 20;                           // transfer.RICE_ESC
constexpr int kMaxLaneBits = kBlock * (kEsc + 32);  // 128 escapes: 6656
constexpr int kStageWords = kMaxLaneBits / 32 + 4;  // >= 211 a lane reads
constexpr int kTab = 2048;                          // lane bits per table
constexpr int kPad = 64;      // zero lengths past a table's end (>= 52)
constexpr int kHalf = 16;                           // threads per lane
constexpr int kWarps = 2;                           // blocks per CUDA block
constexpr int kScanThreads = 1024;
constexpr int kScanBatch = 8;                       // chunk loads in flight
constexpr unsigned kFull = 0xffffffffu;

// One lane as its 16 threads read it: the words of stream bits
// [start, start + len) and their windows staged in shared memory, the
// rest of the stream in device memory.
struct Lane {
  const uint32_t* words;
  long long nw;
  long long start;       // the lane's first bit in the stream
  const uint32_t* stage;  // words [start / 32, ...) when lim >= 0
  int sh0;               // start % 32
  int lim;               // windows of staged word r <= lim read stage
  uint32_t k;
};

// The 64-bit window at lane bit p: its first word clipped to nw - 3.
__device__ __forceinline__ void window(const Lane& l, int p, uint32_t& lo,
                                       uint32_t& hi) {
  const int bit = p + l.sh0;
  const int r = bit >> 5;
  uint32_t w0, w1, w2;
  if (r <= l.lim) {
    w0 = l.stage[r];
    w1 = l.stage[r + 1];
    w2 = l.stage[r + 2];
  } else {
    long long wi = (l.start + p) >> 5;
    if (wi > l.nw - 3) wi = l.nw - 3;
    w0 = l.words[wi];
    w1 = l.words[wi + 1];
    w2 = l.words[wi + 2];
  }
  lo = __funnelshift_r(w0, w1, (uint32_t)bit);
  hi = __funnelshift_r(w1, w2, (uint32_t)bit);
}

// The quotient of the code whose window starts lo: its leading ones
// (31 for a window of all ones, which escapes either way).
__device__ __forceinline__ int rice_q(uint32_t lo) {
  return __popc(lo ^ (lo + 1u)) - 1;
}

__device__ __forceinline__ int rice_len(uint32_t lo, uint32_t k) {
  const int q = rice_q(lo);
  return q >= kEsc ? kEsc + 32 : q + 1 + (int)k;
}

// The code whose window is (lo, hi) -> its value z; len gets its bits.
// Branch-free, so unrolled loops over independent codes overlap.
__device__ __forceinline__ uint32_t rice_code(uint32_t lo, uint32_t hi,
                                              uint32_t k, int& len) {
  const int q = rice_q(lo);
  const bool esc = q >= kEsc;
  const int qs = esc ? 0 : q;
  len = esc ? kEsc + 32 : q + 1 + (int)k;
  const uint32_t plain =
      ((uint32_t)qs << k) | ((lo >> (qs + 1)) & ((1u << k) - 1u));
  return esc ? (lo >> kEsc) | (hi << (32 - kEsc)) : plain;
}

// The code at lane bit p -> its value z; len gets its bits.
__device__ __forceinline__ uint32_t code_at(const Lane& l, int p, int& len) {
  uint32_t lo, hi;
  window(l, p, lo, hi);
  return rice_code(lo, hi, l.k, len);
}

// The same for a code whose window is staged (lane bit p < the lane's
// pfast): shared-memory reads only, no branch on where the words are.
__device__ __forceinline__ uint32_t staged_code(const uint32_t* stage, int sh0,
                                                uint32_t k, int p, int& len) {
  const int bit = p + sh0, r = bit >> 5;
  const uint32_t w1 = stage[r + 1];
  const uint32_t lo = __funnelshift_r(stage[r], w1, (uint32_t)bit);
  const uint32_t hi = __funnelshift_r(w1, stage[r + 2], (uint32_t)bit);
  return rice_code(lo, hi, k, len);
}

// Chunk offsets: for each chunk of 32 lanes the exclusive start of its gap
// lanes (chunk_off[c]) and of its value lanes within the value region
// (chunk_off[nc + c]), then the total gap bits (chunk_off[2 * nc]).
__global__ void __launch_bounds__(kScanThreads)
    lane_chunk_offsets(const uint16_t* __restrict__ lens_g,
                       const uint16_t* __restrict__ lens_v, int nb,
                       long long* __restrict__ chunk_off) {
  __shared__ long long part[2][32];
  __shared__ long long round_total[2];
  const int nc = (nb + 31) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry_g = 0, carry_v = 0;
  for (int base = 0; base < nc; base += kScanThreads) {
    // Warp w sums chunks c0 + t with coalesced loads, kScanBatch chunks'
    // loads in flight; lane t keeps chunk c0 + t, so chunk order is thread
    // order.
    const int c0 = base + 32 * warp;
    unsigned cg = 0u, cv = 0u;
    for (int t0 = 0; t0 < 32 && c0 + t0 < nc; t0 += kScanBatch) {
      unsigned g[kScanBatch], v[kScanBatch];
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        const int j = 32 * (c0 + t0 + u) + lane;
        g[u] = j < nb ? lens_g[j] : 0u;
        v[u] = j < nb ? lens_v[j] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        const unsigned sg = __reduce_add_sync(kFull, g[u]);
        const unsigned sv = __reduce_add_sync(kFull, v[u]);
        if (lane == t0 + u) {
          cg = sg;
          cv = sv;
        }
      }
    }
    long long sg = cg, sv = cv;
    for (int d = 1; d < 32; d <<= 1) {
      const long long tg = __shfl_up_sync(kFull, sg, d);
      const long long tv = __shfl_up_sync(kFull, sv, d);
      if (lane >= d) {
        sg += tg;
        sv += tv;
      }
    }
    if (lane == 31) {
      part[0][warp] = sg;
      part[1][warp] = sv;
    }
    __syncthreads();
    if (warp == 0) {
      const long long og = part[0][lane], ov = part[1][lane];
      long long pg = og, pv = ov;
      for (int d = 1; d < 32; d <<= 1) {
        const long long tg = __shfl_up_sync(kFull, pg, d);
        const long long tv = __shfl_up_sync(kFull, pv, d);
        if (lane >= d) {
          pg += tg;
          pv += tv;
        }
      }
      part[0][lane] = pg - og;
      part[1][lane] = pv - ov;
      if (lane == 31) {
        round_total[0] = pg;
        round_total[1] = pv;
      }
    }
    __syncthreads();
    const int c = base + (int)threadIdx.x;
    if (c < nc) {
      chunk_off[c] = carry_g + part[0][warp] + sg - cg;
      chunk_off[nc + c] = carry_v + part[1][warp] + sv - cv;
    }
    carry_g += round_total[0];
    carry_v += round_total[1];
    __syncthreads();
  }
  if (threadIdx.x == 0) chunk_off[2 * nc] = carry_g;
}

__global__ void __launch_bounds__(kWarps * 32)
    rice_lanes(const uint32_t* __restrict__ words, long long nw,
               const long long* __restrict__ chunk_off,
               const uint16_t* __restrict__ lens_g,
               const uint16_t* __restrict__ lens_v,
               const uint8_t* __restrict__ k_packed,
               const int32_t* __restrict__ base_pos,
               const int32_t* __restrict__ nnz_ptr, int nb, long long n_out,
               int32_t* __restrict__ qflat) {
  __shared__ uint32_t stage_s[kWarps][2][kStageWords];
  // The length table; after the walk it holds the codes' values z.
  __shared__ __align__(16) uint8_t len_s[kWarps][2][kTab + kPad];
  __shared__ uint16_t start_s[kWarps][2][kBlock];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = lane >> 4, i = lane & 15;  // 0-15 gap lane, 16-31 value lane
  const long long nnz = *nnz_ptr;
  const int nc = (nb + 31) >> 5;
  // Each warp takes blocks b, b + (the grid's warps), ... in turn.
  for (int b = blockIdx.x * kWarps + warp; b < nb; b += gridDim.x * kWarps) {
    const long long left = nnz - (long long)b * kBlock;
    if (left <= 0) break;
    const int n = left > kBlock ? kBlock : (int)left;
    const int c = b >> 5, j = 32 * c + lane;
    const int xg = j < nb ? lens_g[j] : 0, xv = j < nb ? lens_v[j] : 0;
    const long long chunk_g = chunk_off[c], chunk_v = chunk_off[nc + c];
    const long long gap_bits = chunk_off[2 * nc];
    const uint32_t kp = k_packed[b];
    const long long pos0 = base_pos[b];

    // Lane offsets: the chunk's start plus a warp scan of its 32 lengths.
    int sg = xg, sv = xv;
    for (int d = 1; d < 32; d <<= 1) {
      const int tg = __shfl_up_sync(kFull, sg, d);
      const int tv = __shfl_up_sync(kFull, sv, d);
      if (lane >= d) {
        sg += tg;
        sv += tv;
      }
    }
    const int src = b & 31;
    const int pg = __shfl_sync(kFull, sg - xg, src);
    const int pv = __shfl_sync(kFull, sv - xv, src);
    const int lg = __shfl_sync(kFull, xg, src);
    const int lv = __shfl_sync(kFull, xv, src);
    Lane l;
    l.words = words;
    l.nw = nw;
    l.start = h == 0 ? chunk_g + pg : gap_bits + chunk_v + pv;
    l.k = h == 0 ? (kp & 15u) : (kp >> 4);
    l.sh0 = (int)(l.start & 31);
    const int len = min(h == 0 ? lg : lv, kMaxLaneBits);

    // Stage the words the lane's windows read, unless its first window is
    // already clipped (then every read goes to device memory).
    uint32_t* stage = stage_s[warp][h];
    const long long s0 = l.start >> 5;
    long long s1 = s0;
    if (len > 0) s1 = min(((l.start + len - 1) >> 5) + 3, nw);
    const int staged = s0 + 3 <= nw ? (int)(s1 - s0) : 0;
    for (int w = i; w < staged; w += kHalf) stage[w] = words[s0 + w];
    l.stage = stage;
    l.lim = staged - 3;
    // Codes starting below lane bit pfast have their windows staged.
    const int pfast = staged >= 3 ? 32 * (staged - 2) - l.sh0 : 0;
    __syncwarp();

    // The code starts: the 16 threads fill a table of the code length at
    // every lane bit (kTab bits at a time), one thread walks it.
    uint8_t* lens = len_s[warp][h];
    uint16_t* starts = start_s[warp][h];
    int p = 0, t = 0;
    for (int base = 0;; base += kTab) {
      const int end = min(base + kTab, len);
      // Bits [base, mid) in groups of 4 from staged words, one 32-bit
      // store per group; the rest (past pfast) one by one.
      const int mid = max(base, base + ((min(end, pfast) - base) & ~3));
      for (int x = base + 4 * i; x < mid; x += 4 * kHalf) {
        const int bit = x + l.sh0, r = bit >> 5, sh = bit & 31;
        const uint32_t w0 = stage[r], w1 = stage[r + 1], w2 = stage[r + 2];
        uint32_t packed = 0u;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int b = sh + u;  // 0..34
          const uint32_t lo = b < 32 ? __funnelshift_r(w0, w1, (uint32_t)b)
                                     : __funnelshift_r(w1, w2, (uint32_t)b);
          packed |= (uint32_t)rice_len(lo, l.k) << (8 * u);
        }
        *reinterpret_cast<uint32_t*>(lens + (x - base)) = packed;
      }
      for (int x = mid + i; x < end; x += kHalf) {
        int ln;
        code_at(l, x, ln);
        lens[x - base] = (uint8_t)ln;
      }
      // Zero lengths past the end: a walk that leaves the table stops
      // there, at the first code start past it.
      const int top = max(end - base, 0);
      for (int x = top + i; x < top + kPad; x += kHalf) lens[x] = 0;
      __syncwarp();
      if (i == 0 && t < n && p < end) {
        // The chain is one shared-memory byte load and an add per code;
        // the loop's test does not wait for it.
        int at = p - base;
        for (int u = t; u < n; ++u) {
          starts[u] = (uint16_t)(at + base);
          at += lens[at];
        }
        // Codes from the first start past the table on are the next
        // table's (starts ascend: a binary search).
        int lo = t, hi = n;
        while (lo < hi) {
          const int mid_t = (lo + hi) >> 1;
          if (starts[mid_t] < end) lo = mid_t + 1; else hi = mid_t;
        }
        t = lo;
        p = at + base;
      }
      __syncwarp();
      if (!__any_sync(kFull, i == 0 && t < n && p < len)) break;
    }
    if (i == 0) {
      // Codes past the lane's stated length (only a malformed upload).
      for (; t < n; ++t) {
        int ln;
        starts[t] = (uint16_t)p;
        code_at(l, p, ln);
        p += ln;
      }
    }
    __syncwarp();
    uint32_t* z = reinterpret_cast<uint32_t*>(lens);
    if (starts[n - 1] < pfast) {  // every window staged (starts ascend)
#pragma unroll 4
      for (int u = i; u < n; u += kHalf) {
        int ln;
        z[u] = staged_code(stage, l.sh0, l.k, starts[u], ln);
      }
    } else {
      for (int u = i; u < n; u += kHalf) {
        int ln;
        z[u] = code_at(l, starts[u], ln);
      }
    }
    __syncwarp();

    // Positions: a warp prefix sum of the gaps + 1; then the stores.
    const uint4 g4 = reinterpret_cast<const uint4*>(len_s[warp][0])[lane];
    const uint4 v4 = reinterpret_cast<const uint4*>(len_s[warp][1])[lane];
    const uint32_t zg[4] = {g4.x, g4.y, g4.z, g4.w};
    const uint32_t zv[4] = {v4.x, v4.y, v4.z, v4.w};
    long long own = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (4 * lane + u < n) own += (long long)zg[u] + 1;
    long long acc = own;
    for (int d = 1; d < 32; d <<= 1) {
      const long long x = __shfl_up_sync(kFull, acc, d);
      if (lane >= d) acc += x;
    }
    long long pos = pos0 + acc - own;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (4 * lane + u >= n) break;
      pos += (long long)zg[u] + 1;
      const int32_t v = (int32_t)(zv[u] >> 1) ^ -(int32_t)(zv[u] & 1u);
      if (pos >= 0 && pos < n_out) qflat[pos] = v;
    }
    __syncwarp();
  }
}

// CUDA blocks of rice_lanes: one per kWarps blocks, at most as many as the
// card holds at once (the warps then loop), so a dense batch does not pay
// for tens of thousands of block launches.
int lanes_grid(int nb) {
  static std::atomic<int> resident[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int most = dev < 64 ? resident[dev].load() : 0;
  if (most == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rice_lanes,
                                                  kWarps * 32, 0);
    most = sms * per_sm > 0 ? sms * per_sm : 1;
    if (dev < 64) resident[dev] = most;
  }
  const int want = (nb + kWarps - 1) / kWarps;
  return want < most ? want : most;
}

// Kernels launched since the library was loaded, so a caller counts the
// launches of one call without a profiler.
std::atomic<long long> g_launched{0};

int launched() {
  const int err = (int)cudaGetLastError();
  if (!err) g_launched.fetch_add(1, std::memory_order_relaxed);
  return err;
}

}  // namespace

extern "C" {

// Kernels this library has launched since it was loaded.
long long ebcc_exchange_kernels_launched() {
  return g_launched.load(std::memory_order_relaxed);
}

// Decode nb blocked-Rice lane pairs into qflat (n_out int32, cleared here).
// words: nw uint32 (nw >= 3); lens_g, lens_v: nb u16 lane bit lengths;
// k_packed: nb bytes (gap k low 4 bits, value k high 4); base_pos: nb int32
// positions preceding each gap block; nnz: one int32 on the device;
// chunk_off: scratch of 2 * ceil(nb / 32) + 1 int64.
int ebcc_rice_unpack_qflat(const uint32_t* words, long long nw,
                           const uint16_t* lens_g, const uint16_t* lens_v,
                           const uint8_t* k_packed, const int32_t* base_pos,
                           const int32_t* nnz, int nb, long long n_out,
                           long long* chunk_off, int32_t* qflat,
                           void* stream) {
  if (nb <= 0 || nw < 3 || n_out < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t set =
      cudaMemsetAsync(qflat, 0, (size_t)n_out * sizeof(int32_t), s);
  if (set != cudaSuccess) return (int)set;
  lane_chunk_offsets<<<1, kScanThreads, 0, s>>>(lens_g, lens_v, nb, chunk_off);
  const int err = launched();
  if (err) return err;
  rice_lanes<<<lanes_grid(nb), kWarps * 32, 0, s>>>(
      words, nw, chunk_off, lens_g, lens_v, k_packed, base_pos, nnz, nb, n_out,
      qflat);
  return launched();
}

}  // extern "C"
