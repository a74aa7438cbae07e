// Hand-written CUDA kernels (sm_90a) of the coded-size estimate: the plane
// statistics of ops/bitplane.py estimated_code_bytes in one pass.
//
// Replaces no Pallas kernel: the JAX package leaves the estimate to XLA
// (ebcc_tpu/ops/bitplane.py estimated_code_bytes), which fuses it.  The
// port's plain PyTorch version runs 214 (13 planes) or 349 (22 planes) CUDA
// kernels a call, most of them a full pass over the batch: per plane a
// shift, a mask and an int64 sum, per cut a shift, a cast and a sum, about
// 450-750 B of device traffic a coefficient.  The encode core runs it 8
// times a batch that takes the residual sweep (core/kernels.py), so it was
// the largest source of the core's launches.
//
// The input is an int32 q viewed as (G, N): G groups (chunks) of N
// coefficients each.  What the estimate needs of a group is 2P integers:
//   bits[p] = #{ (|q| >> p) & 1 },    p < P   (the plane's 1-bits)
//   sig[c]  = #{ (|q| >> c) != 0 },   c < P   (significant at cut c)
// with torch's int32 semantics (|INT_MIN| wraps to INT_MIN).  Both are
// column counts of one 32-bit word per coefficient: the magnitude a for
// bits, and for sig the word t whose bits at and below a's top set bit are
// all set (bit c of t is 1 exactly when a >= 2^c), one count of leading
// zeros and one funnel shift.
//
// One call is two launches on the caller's stream:
// - plane_counts, grid (blocks per group, G), 256 threads.  Each thread
//   takes 16 coefficients a step (four 16-byte loads where N is a multiple
//   of 4, else 16 scalar loads) and adds their a and t words to bit-sliced
//   column counters with a Harley-Seal carry-save tree: 15 carry-save
//   adders (two 3-input logic ops each) per 16 words keep the ones, twos,
//   fours and eights of every column, and the sixteens ripple into 8 more
//   slices, so a block takes at most 255 steps.  A coefficient costs about
//   a dozen integer operations whatever P is, where counting each plane
//   apart costs ~5P: a ballot and a popcount per plane with a shared
//   histogram of the top bit ran 11-17x slower on the card.  At the end
//   the warp adds its lanes' slices with a bit-sliced full adder over five
//   shuffle rounds, lane j reads column j's total off the slices, and the
//   block sums its 8 warps into 64 partial counts (32 columns of a, 32 of
//   t).  No atomics, no memset: every partial is written.
// - code_size_tail, one block per group, sums the blocks' partials in a
//   fixed order (exact integers) and forms the table with the float32
//   steps of the plain version as PyTorch runs it on the card: a division
//   by the Python int N is a multiplication by the float reciprocal
//   (PyTorch's CUDA division by a CPU scalar), log2f is the log2 of
//   PyTorch's kernel, and each operation is rounded on its own
//   (__fadd_rn / __fmul_rn, which nvcc never contracts into an FMA), in
//   the plain version's order; the kept planes' sizes are summed MSB first
//   one plane at a time.  So the (P + 1, G) table is bit-equal to the plain
//   version on the same card, and a group's row depends neither on the
//   batch nor on how the groups are cut into blocks.
//
// What bounds it on an H100: bytes, q read once (4 B a coefficient) at
// 3.35 TB/s, 0.0101 ms at (8, 736, 1440) and 0.0405 ms at (32, 736,
// 1440).  The integer work is ~12 operations a coefficient at 132 SMs x 64
// integer lanes x clock, about half the bytes' time; the per-thread
// slices' warp sum costs a few hundred operations a thread, which is why a
// block takes several steps of 16 coefficients a thread before it sums
// (blocks per group: two per SM over the groups, at most 255 steps).
//
// Plain C interface (ctypes): the entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;            // plane_counts
constexpr int kWarps = kThreads / 32;
constexpr int kPerStep = 16;             // coefficients a thread takes a step
constexpr long long kStep = (long long)kThreads * kPerStep;  // ... a block
constexpr int kCols = 64;                // partials a block: a's 32, t's 32
constexpr int kHi = 8;                   // slices above the eights
constexpr int kMaxSteps = (1 << kHi) - 1;  // sixteens the kHi slices hold
constexpr int kTailThreads = 64;
constexpr unsigned kFull = 0xffffffffu;

// Carry-save adder of three words, column by column: h = carries (weight
// 2), l = sums (weight 1).
__device__ __forceinline__ void csa(uint32_t& h, uint32_t& l, uint32_t a,
                                    uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  h = (a & b) | (u & c);
  l = u ^ c;
}

// Column counters of one word type: column j's count is ones_j + 2 twos_j
// + 4 fours_j + 8 eights_j + sum_k 16 * 2^k hi[k]_j.
struct Slices {
  uint32_t ones = 0, twos = 0, fours = 0, eights = 0;
  uint32_t hi[kHi];
  __device__ Slices() {
#pragma unroll
    for (int k = 0; k < kHi; ++k) hi[k] = 0;
  }
};

// Adds 16 words (Harley-Seal): 15 carry-save adders, then the sixteens
// ripple into hi.
__device__ __forceinline__ void add16(Slices& s, const uint32_t (&w)[16]) {
  uint32_t twosA, twosB, foursA, foursB, eightsA, eightsB, sixteens;
  csa(twosA, s.ones, s.ones, w[0], w[1]);
  csa(twosB, s.ones, s.ones, w[2], w[3]);
  csa(foursA, s.twos, s.twos, twosA, twosB);
  csa(twosA, s.ones, s.ones, w[4], w[5]);
  csa(twosB, s.ones, s.ones, w[6], w[7]);
  csa(foursB, s.twos, s.twos, twosA, twosB);
  csa(eightsA, s.fours, s.fours, foursA, foursB);
  csa(twosA, s.ones, s.ones, w[8], w[9]);
  csa(twosB, s.ones, s.ones, w[10], w[11]);
  csa(foursA, s.twos, s.twos, twosA, twosB);
  csa(twosA, s.ones, s.ones, w[12], w[13]);
  csa(twosB, s.ones, s.ones, w[14], w[15]);
  csa(foursB, s.twos, s.twos, twosA, twosB);
  csa(eightsB, s.fours, s.fours, foursA, foursB);
  csa(sixteens, s.eights, s.eights, eightsA, eightsB);
  uint32_t c = sixteens;
#pragma unroll
  for (int k = 0; k < kHi; ++k) {
    const uint32_t carry = s.hi[k] & c;
    s.hi[k] ^= c;
    c = carry;
  }
}

// The two words of a coefficient: a = |v| with torch's int32 wrap, and t
// with bit c set exactly when a >= 2^c (all bits at and below a's top set
// bit; 0 for a = 0, where __clz gives 32 and the funnel shift clamps).
__device__ __forceinline__ void words_of(int32_t v, uint32_t& a, uint32_t& t) {
  a = v < 0 ? 0u - (uint32_t)v : (uint32_t)v;
  t = __funnelshift_rc(0xffffffffu, 0u, (unsigned)__clz((int)a));
}

// Column j's total over the warp, returned on lane j: the lanes' slices
// are added by a bit-sliced ripple adder over five butterfly rounds (every
// lane ends with the warp's sum), then lane j gathers bit j of each slice.
__device__ __forceinline__ uint32_t warp_column_total(const Slices& s,
                                                      int lane) {
  constexpr int L = 4 + kHi + 5;  // a lane holds < 2^(4+kHi); 32 lanes 2^5
  uint32_t lv[L];
  lv[0] = s.ones;
  lv[1] = s.twos;
  lv[2] = s.fours;
  lv[3] = s.eights;
#pragma unroll
  for (int k = 0; k < kHi; ++k) lv[4 + k] = s.hi[k];
#pragma unroll
  for (int l = 4 + kHi; l < L; ++l) lv[l] = 0;
#pragma unroll
  for (int round = 0; round < 5; ++round) {
    const int off = 16 >> round;
    uint32_t c = 0;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (l > 4 + kHi + round) break;  // still zero on every lane
      const uint32_t x = lv[l];
      const uint32_t y = __shfl_xor_sync(kFull, x, off);
      lv[l] = x ^ y ^ c;
      c = (x & y) | (c & (x ^ y));
    }
  }
  uint32_t total = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) total |= ((lv[l] >> lane) & 1u) << l;
  return total;
}

// One block's 64 column counts of its share of group blockIdx.y: units
// [blockIdx.x * per, min(+per, units)) of the group's q, a unit being an
// int4 (kVec) or one int32, in `steps` steps of 16 coefficients a thread.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    plane_counts(const int32_t* __restrict__ q, long long n, long long units,
                 long long per, int steps, uint32_t* __restrict__ partial) {
  __shared__ uint32_t warp_tot[kWarps][kCols];
  const int g = blockIdx.y;
  const long long start = (long long)blockIdx.x * per;
  const long long end = start + per < units ? start + per : units;
  const int32_t* qg = q + (long long)g * n;
  constexpr int kUnitsPerThread = kVec ? kPerStep / 4 : kPerStep;
  Slices sa, st;
  for (int step = 0; step < steps; ++step) {
    const long long u0 = start + (long long)step * kThreads * kUnitsPerThread +
                         threadIdx.x;
    uint32_t wa[kPerStep], wt[kPerStep];
    if (kVec) {
      const int4* q4 = reinterpret_cast<const int4*>(qg);
      int4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long u = u0 + (long long)k * kThreads;
        v[k] = u < end ? __ldg(q4 + u) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        words_of(v[k].x, wa[4 * k], wt[4 * k]);
        words_of(v[k].y, wa[4 * k + 1], wt[4 * k + 1]);
        words_of(v[k].z, wa[4 * k + 2], wt[4 * k + 2]);
        words_of(v[k].w, wa[4 * k + 3], wt[4 * k + 3]);
      }
    } else {
      int32_t v[kPerStep];
#pragma unroll
      for (int k = 0; k < kPerStep; ++k) {
        const long long u = u0 + (long long)k * kThreads;
        v[k] = u < end ? __ldg(qg + u) : 0;
      }
#pragma unroll
      for (int k = 0; k < kPerStep; ++k) words_of(v[k], wa[k], wt[k]);
    }
    add16(sa, wa);
    add16(st, wt);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_tot[warp][lane] = warp_column_total(sa, lane);
  warp_tot[warp][32 + lane] = warp_column_total(st, lane);
  __syncthreads();
  if (threadIdx.x < kCols) {
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_tot[w][threadIdx.x];
    partial[((long long)g * gridDim.x + blockIdx.x) * kCols + threadIdx.x] =
        sum;
  }
}

// Group blockIdx.x's table: sizes[c * groups + g] for c = 0 .. planes.
__global__ void __launch_bounds__(kTailThreads)
    code_size_tail(const uint32_t* __restrict__ partial, int blocks,
                   int planes, long long n, float efficiency, int groups,
                   float* __restrict__ sizes) {
  __shared__ unsigned long long cnt[kCols];
  __shared__ float plane_bits[32];
  __shared__ float prefix[33];
  const int g = blockIdx.x, t = threadIdx.x;
  unsigned long long sum = 0;
  const uint32_t* p = partial + (long long)g * blocks * kCols + t;
  for (int b = 0; b < blocks; ++b) sum += p[(long long)b * kCols];
  cnt[t] = sum;
  __syncthreads();
  const float nf = __ll2float_rn(n);
  if (t < planes) {
    // Row t of the plain version's (P, G) tensors is plane P - 1 - t.
    const float inv_n = __fdiv_rn(1.0f, nf);
    const float eps = (float)1e-12;
    const float d = __fmul_rn(__ull2float_rn(cnt[planes - 1 - t]), inv_n);
    const float e1 = __fmul_rn(d, log2f(__fadd_rn(d, eps)));
    const float od = __fsub_rn(1.0f, d);
    const float e0 = __fmul_rn(od, log2f(__fadd_rn(od, eps)));
    const float ent = -__fadd_rn(e1, e0);
    plane_bits[t] = __fmul_rn(ent, nf);
  }
  __syncthreads();
  if (t == 0) {
    float acc = 0.0f;
    prefix[0] = acc;
    for (int i = 0; i < planes; ++i) {
      acc = __fadd_rn(acc, plane_bits[i]);
      prefix[i + 1] = acc;
    }
  }
  __syncthreads();
  if (t <= planes) {
    // Cut t keeps planes P - 1 .. t; at cut P nothing is kept.
    const float keep = t < planes ? prefix[planes - t] : 0.0f;
    const float sig = t < planes ? __ull2float_rn(cnt[32 + t]) : 0.0f;
    sizes[(long long)t * groups + g] =
        __fmul_rn(__fmul_rn(__fadd_rn(keep, sig), 0.125f), efficiency);
  }
}

// Two blocks of plane_counts per SM, shared among the groups; a block takes
// at most kMaxSteps steps.
struct Plan {
  int blocks;        // per group
  int steps;         // per block
};

Plan plan(int groups, long long n, int sms) {
  const long long need = (n + kStep - 1) / kStep;  // steps at one block
  const long long want = (2LL * sms + groups - 1) / groups;
  const long long least = (need + kMaxSteps - 1) / kMaxSteps;
  long long blocks = want > least ? want : least;
  if (blocks > need) blocks = need;
  const long long steps = (need + blocks - 1) / blocks;
  return {(int)((need + steps - 1) / steps), (int)steps};
}

template <bool kVec>
void launch_counts(const int32_t* q, int groups, long long n, Plan pl,
                   uint32_t* partial, cudaStream_t s) {
  const long long units = kVec ? n / 4 : n;
  const long long per = (long long)pl.steps * kThreads *
                        (kVec ? kPerStep / 4 : kPerStep);
  plane_counts<kVec><<<dim3(pl.blocks, groups), kThreads, 0, s>>>(
      q, n, units, per, pl.steps, partial);
}

// Kernels launched since the library was loaded, so a caller counts the
// launches of one call without a profiler.
std::atomic<long long> g_launched{0};
// The same count for the calling thread alone: a thread that captures a
// CUDA graph counts the launches it recorded while other threads launch.
thread_local long long t_launched = 0;

int launched() {
  const int err = (int)cudaGetLastError();
  if (!err) {
    g_launched.fetch_add(1, std::memory_order_relaxed);
    ++t_launched;
  }
  return err;
}

}  // namespace

extern "C" {

// Kernels this library has launched since it was loaded.
long long ebcc_bitplane_kernels_launched() {
  return g_launched.load(std::memory_order_relaxed);
}

// Kernels this library has launched from the calling thread.
long long ebcc_bitplane_thread_launched() { return t_launched; }

// Adds n to the library's count: the kernels of a CUDA graph replay, which
// run again without passing through this library's launch sites.
void ebcc_bitplane_add_launched(long long n) {
  g_launched.fetch_add(n, std::memory_order_relaxed);
}

// uint32 partials ebcc_code_size_stats needs for (groups, n) on a device
// of `sms` SMs.
long long ebcc_code_size_partials(int groups, long long n, int sms) {
  if (groups <= 0 || n <= 0 || sms <= 0) return 0;
  return (long long)groups * plan(groups, n, sms).blocks * kCols;
}

// The (planes + 1, groups) float32 table of estimated_code_bytes for the
// int32 q viewed as (groups, n), on a device of `sms` SMs.  partial:
// ebcc_code_size_partials(groups, n, sms) uint32 of scratch.
int ebcc_code_size_stats(const int32_t* q, int groups, long long n,
                         int planes, float efficiency, int sms,
                         uint32_t* partial, float* sizes, void* stream) {
  if (groups <= 0 || groups > 65535 || n <= 0 || planes < 1 || planes > 32 ||
      sms <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Plan pl = plan(groups, n, sms);
  if (n % 4 == 0 && (uintptr_t)q % 16 == 0)
    launch_counts<true>(q, groups, n, pl, partial, s);
  else
    launch_counts<false>(q, groups, n, pl, partial, s);
  const int err = launched();
  if (err) return err;
  code_size_tail<<<groups, kTailThreads, 0, s>>>(
      partial, pl.blocks, planes, n, efficiency, groups, sizes);
  return launched();
}

}  // extern "C"
