// Hand-written CUDA kernels (sm_90a) for the CDF 9/7 transforms of the codec.
//
// Replaces the three Pallas TPU kernels of the encode/decode path:
//   K1  ebcc_tpu/ops/dwt_pallas.py  dwt2d_quantize_pallas  (forward + trunc)
//   K2  ebcc_tpu/ops/dwt_pallas.py  idwt2d_dequant_pallas  (dequant + inverse)
//   K3  ebcc_tpu/ops/dwt_pallas.py  curve_stats_pallas     (error-vs-cut curve)
// and, with quantization switched off, the residual layer's forward
// transform (XLA code in the reference, ebcc_tpu/core/kernels.py:348).
//
// What bounds them on an H100: memory traffic in principle.  A lifting
// pass does ~7 flops per sample against 8 bytes moved, far below the
// card's ~20 flops/byte float32 balance point, so a call's bound is its
// bytes: 8 B per coefficient at 3.35 TB/s, 0.0101 ms at (4, 1, 736, 1440).
// The TPU kernels keep one whole frame resident in VMEM; a padded 736x1440
// float32 frame is 4.2 MB, which no Hopper block's 227 KB of shared memory
// can hold.  So each level of a frame is cut into tiles, and one launch per
// level runs both 1-D passes of every tile:
//   * a tile is 64x64 samples of the level's output (2*kTI rows, 2*kTJ
//     columns).  Its block of 288 threads copies the tile's footprint in
//     the four subbands (kTI + 2*kHalo samples of each half along each
//     axis, 72x72 floats at an odd pitch, 20.5 KB of static shared memory
//     whatever the frame's size) with cp.async, runs the column and the row
//     lifting in shared memory, and writes the tile once.  The level
//     crosses device memory once, and frames of any padded height or width
//     are taken (only the batch is bounded, by the grid's 65535 frames);
//   * the halo: the four lifting steps reach 2 samples of each half on each
//     side (worked out at inv_tile / fwd_tile).  A tile computes its halo
//     again with the same operations in the same order as its neighbour, and
//     replicates samples only at the level's true edges, so every output is
//     bit-equal to the plain version;
//   * a pass gives every thread a segment of 8 samples of each half of one
//     line (12 with the halo), lifted through all four steps in registers:
//     all 288 threads work, with one barrier between the segments' loads and
//     their stores (line segments, below);
//   * the coarse levels whose whole block fits in one block's shared memory
//     (two buffers of (hp>>l) x (wp>>l) floats, at most 227 KB) run in one
//     launch, one 1024-thread block per frame keeping the block resident
//     across those levels: the TPU kernel's frame-resident design, which
//     fits on Hopper only there.  At (736, 1440) that is levels 3 and 4, so a
//     5-level call is 4 launches (coarse + levels 2, 1, 0) and a 3-level call
//     3.  Which branch runs does not change any result.
// Intermediate levels ping-pong between two compact scratch planes (level l
// of a frame is (hp>>l) x (wp>>l)): a tiled level cannot work in place,
// since its tiles read the neighbours' footprints.  Frames never share a
// block, so a frame's result does not depend on the batch it rides in.  K2
// dequantizes on load every coefficient it reads from the integers; K1
// truncates in the store of every coefficient no later level rewrites.
//
// What holds them back (times in PERF.md): a tile block's phases (copy,
// two passes, store) run in lockstep with the other blocks of its wave, so
// the memory idles while they lift; the coarse kernel runs on one SM per
// frame.
//
// K3 lifts every cut of its grid from one load of q and t.  The cuts run in
// groups of kCutGroup (a constant; the codec's grids have 8 and 5 cuts).
// Each cut of a group has its own level planes, so the scratch is
// min(n_cuts, kCutGroup) * ebcc_dwt97_scratch_floats floats, 5/16 of the
// frames' samples per cut (5.3 MB per cut at (4, 1, 736, 1440), 42 MB for
// 8 cuts), plus 20 B of partials per (cut, frame, 64x64 tile).  Per group,
// levels levels-1 .. 1 of all its cuts run as K2's, one launch per level
// (the cut is inv_tile's blockIdx.z, inv_coarse's blockIdx.y); then
// curve_tile runs level 0: one block per (64x64 output tile, frame) copies
// q's window once as raw bits and loads the tile's targets once into
// registers, and per cut dequantizes in its column pass, copies that cut's
// level-1 LL footprint (its only per-cut read, double-buffered so the next
// cut's copy overlaps this cut's lifting) and reduces err = t - (rec *
// scale + off) in its row pass, from registers, into a per-tile partial
// (float64 sum, max, min, count) at (cut, frame, tile); two barriers per
// cut, and no frame is written.  One more launch reduces each (cut,
// frame)'s tiles in a fixed order, never with atomics, so a row depends
// neither on the batch, the run nor the other cuts of the grid.  A 5-level
// call at 736x1440 is 5 launches (coarse, levels 2 and 1, curve_tile,
// curve_reduce), a 3-level call 4.  Its bound is its operations: n_cuts
// inverse transforms, dequantization and statistics, each op one
// instruction (no FMA, below) at 132 SMs x 128 lanes x clock, about 0.034
// ms for 8 cuts at (4, 1, 736, 1440), against 0.0101 ms for 8 B per
// coefficient of q and t.  The level-1 planes add about 2 B per coefficient
// per cut (written once, read once by curve_tile), mostly within the 50 MB
// L2.  What still holds it back (PERF.md): the lifting itself.  curve_tile
// spends ~17 us per cut at (4, 1, 736, 1440), about a K2 level-0 launch:
// the halo and the overlapping 12-slot segments lift 1.7-1.9x the samples
// the outputs need, and with 3 blocks of 9 warps per SM (72 registers) it
// issues at about half the rate its instruction count allows (an estimate
// from the source, not a profiler count).  Levels 1 and 2 and the coarse
// kernel add ~75 us, the coarse kernel on 32 of 132 SMs.
//
// Arithmetic: every lifting update is o + c * (e + e_next) with each
// operation rounded on its own (__fadd_rn / __fmul_rn, which nvcc never
// contracts into an FMA), exactly as the plain PyTorch version computes it,
// so the kernels are bit-equal to it.
//
// Plain C interface (ctypes): each entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

// Coefficients rounded once from their double values, as PyTorch rounds a
// Python float scalar against a float32 tensor.
__constant__ float kAlpha = (float)(-1.586134342);
__constant__ float kBeta = (float)(-0.05298011854);
__constant__ float kGamma = (float)(0.8829110762);
__constant__ float kDelta = (float)(0.44355068522);
__constant__ float kNegAlpha = (float)(1.586134342);
__constant__ float kNegBeta = (float)(0.05298011854);
__constant__ float kNegGamma = (float)(-0.8829110762);
__constant__ float kNegDelta = (float)(-0.44355068522);
__constant__ float kXi = (float)(1.149604398);
__constant__ float kInvXi = (float)(1.0 / 1.149604398);

constexpr int kTI = 32;               // a tile's samples of one half, rows
constexpr int kTJ = 32;               // ... and columns
constexpr int kHalo = 2;              // reach of the four lifting steps
constexpr int kLI = kTI + 2 * kHalo;  // window slots of one half, rows
constexpr int kLJ = kTJ + 2 * kHalo;  // ... and columns
constexpr int kWin = 2 * kLJ;         // window columns: low half, high half
constexpr int kPitch = kWin + 1;      // odd: row lines hit distinct banks
constexpr int kTileFloats = 2 * kLI * kPitch;
constexpr int kRowsY = 4;             // blockDim = (kWin, kRowsY)
constexpr int kTileThreads = kWin * kRowsY;
constexpr int kPerThread = kLI / kRowsY;  // window rows a thread loads
constexpr int kOutPerThread = (4 * kTI * kTJ + kTileThreads - 1) / kTileThreads;
static_assert(kLI % kRowsY == 0 && kLI == kLJ, "tile shape");
constexpr int kSeg = 8;               // samples of each half a thread lifts
constexpr int kSegIn = kSeg + 2 * kHalo;  // ... and reads
constexpr int kSegs = kTI / kSeg;     // segments per window line
static_assert(kWin * kRowsY == 2 * kLI * kSegs, "one segment per thread");
constexpr int kReduceThreads = 256;   // curve_reduce
constexpr int kCoarseSmem = 227 * 1024;  // a block's dynamic shared memory
constexpr int kCoarseSide = 32;       // blockDim = (32, 32)
constexpr int kCutGroup = 8;          // K3's cuts per group of launches
constexpr int kCurveBlocks = 3;       // curve_tile blocks per SM (registers)

// A stack of per-frame float planes: frame f, row r, column c is at
// p[f * frame + r * pitch + c].  K3 keeps one stack per cut of a group,
// cut_stride floats apart.
struct Plane {
  float* p;
  size_t frame;
  int pitch;
  size_t cut_stride = 0;
};

__device__ __forceinline__ float lift(float x, float c, float a, float b) {
  return __fadd_rn(x, __fmul_rn(c, __fadd_rn(a, b)));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Asynchronous 4-byte copy from device to shared memory (no register
// round trip, no alignment needed); cp_async_wait waits for all of the
// thread's copies.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Dequantization at one cut (ebcc_tpu/ops/dwt_pallas.py:164-172): keep
// |q| >> cut << cut, add the half step (or 0.5 at cut 0) when significant,
// restore the sign.  Exact in float32 for |q| < 2^23.  The reference adds
// the half step (2^(cut-1), or 0 at cut 0) and then 0.5 (or 0 at cut > 0)
// to the positive kept value; adding +0 to a positive float is exact, so
// one add of `add` gives the same bits.
struct Dequant {
  int32_t mask;  // clears the planes below the cut
  float add;
};

__device__ __forceinline__ Dequant dequant_at(int cut) {
  cut = cut < 0 ? 0 : (cut > 30 ? 30 : cut);  // valid cuts are < 32 planes
  return Dequant{(int32_t)(0xffffffffu << cut),
                 cut > 0 ? (float)(1 << (cut - 1)) : 0.5f};
}

__device__ __forceinline__ float dequant(int32_t q, Dequant d) {
  const int32_t kept = (q < 0 ? -q : q) & d.mask;
  const float rec = kept > 0 ? __fadd_rn((float)kept, d.add) : 0.0f;
  return __int_as_float(__float_as_int(rec) | (q & (int32_t)0x80000000));
}

// --------------------------------------------------------- line segments
//
// A thread lifts kSeg consecutive samples of each half of one line at
// once, in registers.  It reads the line's slots [first, first + kSegIn)
// of both halves (kHalo on each side of its own kSeg), runs the four
// lifting steps on them, and writes back its own slots [first + kHalo,
// first + kHalo + kSeg).  The halo is the one worked out at inv_tile /
// fwd_tile, so the written slots are exact.  Register slot kb holds the
// level's first sample and ke its last (out of [0, kSegIn) when the
// segment does not reach that edge): there the neighbour outside the level
// is the sample itself (edge replication, shift_prev / shift_next in
// dwt_pallas.py:46-50).  Registers past an edge hold clamped copies that
// no written slot depends on.
struct Seg {
  float e[kSegIn], o[kSegIn];
};

// e[k] = lift(e[k], c, o[k-1], o[k]).  kb <= kHalo: a segment starts at
// most kHalo slots before the level.
__device__ __forceinline__ void seg_even(Seg& s, int kb, float c) {
#pragma unroll
  for (int k = 0; k < kSegIn; ++k)
    s.e[k] = lift(s.e[k], c,
                  (k == 0 || (k <= kHalo && k == kb)) ? s.o[k] : s.o[k - 1],
                  s.o[k]);
}

// o[k] = lift(o[k], c, e[k], e[k+1]); kEdge: the level's last sample may
// lie inside the segment, at ke.
template <bool kEdge>
__device__ __forceinline__ void seg_odd(Seg& s, int ke, float c) {
#pragma unroll
  for (int k = 0; k < kSegIn; ++k)
    s.o[k] = lift(s.o[k], c, s.e[k],
                  (k == kSegIn - 1 || (kEdge && k == ke)) ? s.e[k]
                                                          : s.e[k + 1]);
}

// kInverse: the inverse steps (-delta on even, -gamma on odd, -beta on
// even, -alpha on odd), then both halves scaled by sc.  Else the forward
// steps (alpha on odd, beta on even, gamma on odd, delta on even), then
// low * xi and high / xi.
template <bool kInverse, bool kEdge>
__device__ __forceinline__ void seg_steps(Seg& s, int kb, int ke, float sc) {
  if (kInverse) {
    seg_even(s, kb, kNegDelta);
    seg_odd<kEdge>(s, ke, kNegGamma);
    seg_even(s, kb, kNegBeta);
    seg_odd<kEdge>(s, ke, kNegAlpha);
  } else {
    seg_odd<kEdge>(s, ke, kAlpha);
    seg_even(s, kb, kBeta);
    seg_odd<kEdge>(s, ke, kGamma);
    seg_even(s, kb, kDelta);
  }
  const float sl = kInverse ? sc : kXi, sh = kInverse ? sc : kInvXi;
#pragma unroll
  for (int k = 0; k < kSegIn; ++k) {
    s.e[k] = __fmul_rn(s.e[k], sl);
    s.o[k] = __fmul_rn(s.o[k], sh);
  }
}

// Lifts a segment whose register slot 0 is the level's sample `base` of
// n per half.
template <bool kInverse>
__device__ __forceinline__ void seg_lift(Seg& s, int base, int n, float sc) {
  const int kb = base <= 0 ? -base : -1, ke = n - 1 - base;
  if (ke >= kSegIn - 1)
    seg_steps<kInverse, false>(s, kb, ke, sc);
  else
    seg_steps<kInverse, true>(s, kb, ke, sc);
}

// Slots first + k of a line (clamped into [0, n) when kClamp): low half at
// lo[k * st], high half at hi[k * st].
template <bool kClamp>
__device__ __forceinline__ void seg_load(Seg& s, const float* lo,
                                         const float* hi, int st, int first,
                                         int n) {
#pragma unroll
  for (int k = 0; k < kSegIn; ++k) {
    const int j = (kClamp ? clampi(first + k, 0, n - 1) : first + k) * st;
    s.e[k] = lo[j];
    s.o[k] = hi[j];
  }
}

// The segment's own slots first + kHalo + k (those < n when kClamp) to
// lo / hi.
template <bool kClamp>
__device__ __forceinline__ void seg_store(const Seg& s, float* lo, float* hi,
                                          int st, int first, int n) {
#pragma unroll
  for (int k = kHalo; k < kHalo + kSeg; ++k) {
    if (kClamp && first + k >= n) break;
    lo[(first + k) * st] = s.e[k];
    hi[(first + k) * st] = s.o[k];
  }
}

// One in-place pass of a tile: every active thread lifts one segment of
// one window line, the line's slots at lo[k * st] and hi[k * st], its
// register slot 0 at window slot `first` (a window's slots need no
// clamping), global index base + first.  The barrier between the loads and
// the stores keeps every read ahead of the writes of the overlapping
// neighbour segments.
template <bool kInverse>
__device__ __forceinline__ void tile_pass(bool active, float* lo, float* hi,
                                          int st, int first, int base, int n,
                                          float sc) {
  Seg g;
  if (active) seg_load<false>(g, lo, hi, st, first, kLI);
  __syncthreads();
  if (active) {
    seg_lift<kInverse>(g, base + first, n, sc);
    seg_store<false>(g, lo, hi, st, first, kLI);
  }
  __syncthreads();
}

// ------------------------------------------------------------------ tiles
//
// A tile window holds, along each axis, slots k = 0..kL-1 of both halves
// (low = even samples, high = odd samples) for the global half-indices
// g = base + k, base = tile start - kHalo: window row hr * kLI + k, window
// column hc * kLJ + k.  Samples outside the level are copied clamped to its
// edge; no output reads what is computed from them.

// Statistics of one run of samples: sum (float64), max, min, and the count
// of |err| > target.
struct Stats {
  double sum;
  float mx, mn;
  int bad;
};

__device__ __forceinline__ Stats stats_identity() {
  return Stats{0.0, -INFINITY, INFINITY, 0};
}

__device__ __forceinline__ void stats_merge(Stats& a, const Stats& b) {
  a.sum += b.sum;
  a.mx = fmaxf(a.mx, b.mx);
  a.mn = fminf(a.mn, b.mn);
  a.bad += b.bad;
}

// Reduction of one Stats per thread over a block of kReduceThreads threads
// (a power of two; thread t = its linear index) in a fixed tree, so the
// float64 sum comes out the same on every run for the same inputs.  Every
// thread returns the block's result.
__device__ Stats block_reduce(Stats v, int t) {
  static_assert((kReduceThreads & (kReduceThreads - 1)) == 0, "power of 2");
  __shared__ double r_sum[kReduceThreads];
  __shared__ float r_mx[kReduceThreads], r_mn[kReduceThreads];
  __shared__ int r_bad[kReduceThreads];
  r_sum[t] = v.sum;
  r_mx[t] = v.mx;
  r_mn[t] = v.mn;
  r_bad[t] = v.bad;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (t < half) {
      r_sum[t] += r_sum[t + half];
      r_mx[t] = fmaxf(r_mx[t], r_mx[t + half]);
      r_mn[t] = fminf(r_mn[t], r_mn[t + half]);
      r_bad[t] += r_bad[t + half];
    }
    __syncthreads();
  }
  return Stats{r_sum[0], r_mx[0], r_mn[0], r_bad[0]};
}

// The error statistics of K3's level 0 (curve_tile).
struct StatsArgs {
  const float* t;  // (n_frames, hp, wp) targets
  const float* scale;
  const float* off;
  const float* target;
  int d0, vh, vw;
  double* sum;  // one partial per (cut, frame, tile)
  float* mx;
  float* mn;
  int* bad;
};

// Copies the entries of thread (tx, ty) of a tile block, window column tx,
// rows ty, ty + kRowsY, ... of both halves, of the window whose first
// slots are the half-indices (bi, bj) of a level of (h, w) samples per
// half, clamped into the level, to s: the integers, as raw bits, from qf
// (row pitch wp), except the LL quadrant when llf is given; with kLL that
// quadrant from llf (the previous level's output, row pitch llp).
template <bool kLL>
__device__ __forceinline__ void window_copy(float* s, const int32_t* qf,
                                            int wp, const float* llf, int llp,
                                            int bi, int bj, int h, int w) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int hc = tx / kLJ;
  const int gj = clampi(bj + tx % kLJ, 0, w - 1);
  const bool ll_col = llf != nullptr && hc == 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int gi = clampi(bi + ty + i * kRowsY, 0, h - 1);
      float* d = s + (hr * kLI + ty + i * kRowsY) * kPitch + tx;
      if (ll_col && hr == 0) {
        if (kLL) cp_async4(d, llf + (size_t)gi * llp + gj);
      } else {
        cp_async4(d, qf + (size_t)(hr * h + gi) * wp + hc * w + gj);
      }
    }
}

// Inverse level l of a (hl, wl) block, one block of (kWin, kRowsY) threads
// per 64x64 output tile (blockIdx.x = tile, n_tj tiles per tile row;
// blockIdx.y = frame; blockIdx.z = K3's cut within its group, 0 for K2).
//
// Halo.  Output rows 2i, 2i+1 for i in [i0, i0 + kTI) need, after the four
// steps (-delta on even, -gamma on odd, -beta on even, -alpha on odd), even
// samples of step 3 on [i0, i0+kTI] and odd of step 4 on [i0, i0+kTI);
// hence odd of step 2 on [i0-1, i0+kTI], even of step 1 on [i0-1,
// i0+kTI+1], and inputs on [i0-2, i0+kTI+1] of both halves: kHalo = 2 on
// each side.  The same holds along the columns.
//
// Inputs: the LL quadrant from `ll` (the previous level's output) unless
// ll.p is null (the coarsest level), the other three from q dequantized at
// cut[z + frame / cut_d0].  The column pass lifts all kWin window columns
// and scales them for the row pass; the row pass lifts the 2 * kTI window
// rows the tile outputs.  Output: the interleaved tile into dst.
__global__ void __launch_bounds__(kTileThreads)
    inv_tile(const int32_t* q, const int32_t* cut, int cut_d0, int hp, int wp,
             Plane ll, Plane dst, int hl, int wl, int n_tj) {
  __shared__ float s[kTileFloats];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kWin + tx;
  const int frame = blockIdx.y, z = blockIdx.z;
  const int ti = blockIdx.x / n_tj, tj = blockIdx.x % n_tj;
  const int h = hl >> 1, w = wl >> 1;
  const int bi = ti * kTI - kHalo, bj = tj * kTJ - kHalo;
  const float* llf =
      ll.p ? ll.p + z * ll.cut_stride + frame * ll.frame : nullptr;
  {
    // The thread dequantizes and scales the entries it copied.
    window_copy<true>(s, q + (size_t)frame * hp * wp, wp, llf, ll.pitch, bi,
                      bj, h, w);
    cp_async_wait();
    const Dequant dq = dequant_at(__ldg(cut + z + frame / cut_d0));
    const bool ll_col = llf != nullptr && tx < kLJ;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        float* d = s + (hr * kLI + ty + i * kRowsY) * kPitch + tx;
        const float v = (ll_col && hr == 0) ? *d
                                            : dequant(__float_as_int(*d), dq);
        *d = __fmul_rn(v, hr ? kXi : kInvXi);
      }
  }
  __syncthreads();
  {
    // Columns: every window column, scaled for the row pass.
    const int c = tid % kWin, first = (tid / kWin) * kSeg;
    tile_pass<true>(true, s + c, s + kLI * kPitch + c, kPitch, first, bi, h,
                    c < kLJ ? kInvXi : kXi);
  }
  {
    // Rows: the 2 * kTI window rows the tile outputs.
    const int j = tid % (2 * kTI), first = (tid / (2 * kTI)) * kSeg;
    float* row = s + ((j / kTI) * kLI + kHalo + j % kTI) * kPitch;
    tile_pass<true>(tid < 2 * kTI * kSegs, row, row + kLJ, 1, first, bj, w,
                    1.0f);
  }
  // Output row 2i + hr is slot i of half hr; the same along the columns.
  const int r0 = 2 * ti * kTI, c0 = 2 * tj * kTJ;
  float* df = dst.p + z * dst.cut_stride + frame * dst.frame;
#pragma unroll
  for (int i = 0; i < kOutPerThread; ++i) {
    const int idx = tid + i * kTileThreads;
    const int r = idx / (2 * kTJ), c = idx % (2 * kTJ);
    if (idx >= 4 * kTI * kTJ || r0 + r >= hl || c0 + c >= wl) continue;
    df[(size_t)(r0 + r) * dst.pitch + c0 + c] =
        s[((r & 1) * kLI + kHalo + (r >> 1)) * kPitch + (c & 1) * kLJ + kHalo +
          (c >> 1)];
  }
}

// Reduction of one Stats per lane over a warp, in a fixed order (lane l
// takes lane l + o for o = 16, 8, 4, 2, 1); lane 0 returns the warp's.
__device__ __forceinline__ Stats warp_reduce(Stats v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.sum += __shfl_down_sync(0xffffffffu, v.sum, o);
    v.mx = fmaxf(v.mx, __shfl_down_sync(0xffffffffu, v.mx, o));
    v.mn = fminf(v.mn, __shfl_down_sync(0xffffffffu, v.mn, o));
    v.bad += __shfl_down_sync(0xffffffffu, v.bad, o);
  }
  return v;
}

constexpr int kTileWarps = kTileThreads / 32;
static_assert(kTileThreads % 32 == 0, "whole warps");
constexpr int kLLPitch = kLJ + 1;     // odd, as kPitch
constexpr int kLLFloats = kLI * kLLPitch;
constexpr int kStatsOut = 2 * kSeg;   // outputs a row-pass thread reduces
// curve_tile's dynamic shared memory: the warps' partials of every cut of
// a group, q's raw window, the lifting window, two LL footprints.
constexpr int kCurveSmem =
    (int)(kCutGroup * kTileWarps * sizeof(Stats)) +
    (2 * kTileFloats + 2 * kLLFloats) * (int)sizeof(float);

// Copies a cut's LL footprint, window slots [0, kLI) x [0, kLJ) of the
// level-1 plane at llf (row pitch llp, clamped into its (h, w)), to lb at
// pitch kLLPitch; the whole block takes part.
__device__ __forceinline__ void ll_copy(float* lb, const float* llf, int llp,
                                        int bi, int bj, int h, int w) {
  const int tid = threadIdx.y * kWin + threadIdx.x;
  for (int e = tid; e < kLI * kLJ; e += kTileThreads) {
    const int r = e / kLJ, c = e % kLJ;
    cp_async4(lb + r * kLLPitch + c, llf + (size_t)clampi(bi + r, 0, h - 1) *
                                               llp + clampi(bj + c, 0, w - 1));
  }
}

// Level 0 of every cut of a group, with the error statistics (K3): one
// block per 64x64 output tile of the valid region rows [0, vh) x cols
// [0, vw) (blockIdx.x, n_tj per tile row) and frame (blockIdx.y) takes the
// group's n_cuts cuts in turn.  q's window is copied once, as raw bits, to
// `raw`, and each row-pass thread loads the targets of its 16 outputs once
// into registers.  When ll.p is given, a cut's LL footprint comes from its
// level-1 plane into one of two buffers, the next cut's copy overlapping
// this cut's lifting.  Per cut, with the operations of inv_tile in the same
// order: the column pass reads its segment from raw (dequantized at the
// cut and scaled in registers) and the LL buffer, and stores it to s; the
// row pass lifts the output rows from s and reduces err = t - (rec * scale
// + off) over its valid outputs from registers, per warp in a fixed order;
// the warps' partials are merged in order into the partial at (cut, frame,
// tile) once all cuts are done.  Two barriers per cut.  Registers are
// capped for kCurveBlocks blocks per SM: left alone, nvcc keeps every
// cut-invariant address live and fits one block per SM (PERF.md).
__global__ void __launch_bounds__(kTileThreads, kCurveBlocks)
    curve_tile(const int32_t* q, const int32_t* cuts, int n_cuts, Plane ll,
               int hp, int wp, int n_tj, StatsArgs st) {
  extern __shared__ double curve_smem[];
  Stats(*part)[kTileWarps] = (Stats(*)[kTileWarps])curve_smem;
  float* raw = (float*)(part + kCutGroup);
  float* s = raw + kTileFloats;
  float* llb = s + kTileFloats;
  const int tid = threadIdx.y * kWin + threadIdx.x;
  const int frame = blockIdx.y;
  const int ti = blockIdx.x / n_tj, tj = blockIdx.x % n_tj;
  const int h = hp >> 1, w = wp >> 1;
  const int bi = ti * kTI - kHalo, bj = tj * kTJ - kHalo;
  const float* llf = ll.p ? ll.p + frame * ll.frame : nullptr;
  window_copy<false>(raw, q + (size_t)frame * hp * wp, wp, llf, ll.pitch, bi,
                     bj, h, w);
  if (llf != nullptr) ll_copy(llb, llf, ll.pitch, bi, bj, h, w);
  // Column pass: window column cc, segment from slot cf.  Row pass (threads
  // below 2 * kTI * kSegs): window row j of the output rows, segment from
  // slot rf, giving output row orow, columns ocol .. ocol + kStatsOut - 1.
  const int cc = tid % kWin, cf = (tid / kWin) * kSeg;
  const bool ll_col = llf != nullptr && cc < kLJ;
  const bool row_thread = tid < 2 * kTI * kSegs;
  const int j = tid % (2 * kTI), rf = (tid / (2 * kTI)) * kSeg;
  const int orow = 2 * ti * kTI + 2 * (j % kTI) + j / kTI;
  const int ocol = 2 * tj * kTJ + 2 * rf;
  const int chunk = frame / st.d0;
  const float sc = st.scale[chunk], of = st.off[chunk], tg = st.target[chunk];
  float tv[kStatsOut];
#pragma unroll
  for (int n = 0; n < kStatsOut; ++n)
    tv[n] = (row_thread && orow < st.vh && ocol + n < st.vw)
                ? __ldg(st.t + (size_t)frame * hp * wp + (size_t)orow * wp +
                        ocol + n)
                : 0.0f;
  for (int k = 0; k < n_cuts; ++k) {
    cp_async_wait();  // this thread's copies of this cut's LL (and q's)
    __syncthreads();  // everyone's; the last cut's row pass has read s
    const float* lb = llb + (k & 1) * kLLFloats;
    if (llf != nullptr && k + 1 < n_cuts)
      ll_copy(llb + ((k + 1) & 1) * kLLFloats,
              llf + (k + 1) * ll.cut_stride, ll.pitch, bi, bj, h, w);
    const Dequant dq = dequant_at(__ldg(cuts + k));
    {
      Seg g;
#pragma unroll
      for (int m = 0; m < kSegIn; ++m) {
        const int rr = cf + m;
        float lo;
        if (ll_col)
          lo = lb[rr * kLLPitch + cc];
        else
          lo = dequant(__float_as_int(raw[rr * kPitch + cc]), dq);
        g.e[m] = __fmul_rn(lo, kInvXi);
        g.o[m] = __fmul_rn(
            dequant(__float_as_int(raw[(kLI + rr) * kPitch + cc]), dq), kXi);
      }
      seg_lift<true>(g, bi + cf, h, cc < kLJ ? kInvXi : kXi);
      seg_store<false>(g, s + cc, s + kLI * kPitch + cc, kPitch, cf, kLI);
    }
    __syncthreads();
    Stats acc = stats_identity();
    if (row_thread) {
      const float* row = s + ((j / kTI) * kLI + kHalo + j % kTI) * kPitch;
      Seg g;
      seg_load<false>(g, row, row + kLJ, 1, rf, kLI);
      seg_lift<true>(g, bj + rf, w, 1.0f);
#pragma unroll
      for (int n = 0; n < kStatsOut; ++n) {
        if (orow >= st.vh || ocol + n >= st.vw) continue;
        const float v = (n & 1) ? g.o[kHalo + n / 2] : g.e[kHalo + n / 2];
        const float err = __fsub_rn(tv[n], __fadd_rn(__fmul_rn(v, sc), of));
        acc.sum += (double)err;
        acc.mx = fmaxf(acc.mx, err);
        acc.mn = fminf(acc.mn, err);
        acc.bad += fabsf(err) > tg ? 1 : 0;
      }
    }
    const Stats wr = warp_reduce(acc);
    if (tid % 32 == 0) part[k][tid / 32] = wr;
  }
  __syncthreads();
  if (tid < n_cuts) {
    Stats red = part[tid][0];
#pragma unroll
    for (int v = 1; v < kTileWarps; ++v) stats_merge(red, part[tid][v]);
    const size_t o = ((size_t)tid * gridDim.y + frame) * gridDim.x + blockIdx.x;
    st.sum[o] = red.sum;
    st.mx[o] = red.mx;
    st.mn[o] = red.mn;
    st.bad[o] = red.bad;
  }
}

// Forward level l of a (hl, wl) spatial block, one block per tile of
// kTI x kTJ coefficients in each of the four output quadrants.
//
// Halo.  The outputs of half-index i in [i0, i0 + kTI) need even of step 4
// and odd of step 3 there (steps: alpha on odd, beta on even, gamma on odd,
// delta on even); hence odd of step 3 on [i0-1, i0+kTI), even of step 2 on
// [i0-1, i0+kTI], odd of step 1 on [i0-2, i0+kTI], and input pairs on
// [i0-2, i0+kTI+1]: kHalo = 2 on each side, along both axes.
//
// The row pass lifts every window row first, then the column pass the
// 2 * kTJ window columns the tile outputs.  The LL quadrant goes to `ll`
// (the next level's input) unless this is the last level; every other
// coefficient is final and goes to q truncated toward zero (kQuant) or to
// out.
template <bool kQuant>
__global__ void __launch_bounds__(kTileThreads)
    fwd_tile(Plane src, Plane ll, float* out, int32_t* q, int hp, int wp,
             int hl, int wl, int n_tj, int last) {
  __shared__ float s[kTileFloats];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kWin + tx;
  const int frame = blockIdx.y;
  const int ti = blockIdx.x / n_tj, tj = blockIdx.x % n_tj;
  const int h = hl >> 1, w = wl >> 1;
  const int bi = ti * kTI - kHalo, bj = tj * kTJ - kHalo;
  {
    // Spatial rows 2g + hr and columns 2g + hc, deinterleaved into halves;
    // consecutive threads read consecutive columns.
    const float* sf = src.p + frame * src.frame;
    const int hc = tx & 1, m = tx >> 1;
    const int scol = 2 * clampi(bj + m, 0, w - 1) + hc;
#pragma unroll
    for (int i = 0; i < 2 * kPerThread; ++i) {
      const int a = ty + i * kRowsY;
      const int gi = clampi(bi + (a >> 1), 0, h - 1);
      cp_async4(s + ((a & 1) * kLI + (a >> 1)) * kPitch + hc * kLJ + m,
                sf + (size_t)(2 * gi + (a & 1)) * src.pitch + scol);
    }
    cp_async_wait();
  }
  __syncthreads();
  {
    // Rows: every window row.
    const int j = tid % (2 * kLI), first = (tid / (2 * kLI)) * kSeg;
    float* row = s + j * kPitch;
    tile_pass<false>(true, row, row + kLJ, 1, first, bj, w, 1.0f);
  }
  {
    // Columns: the 2 * kTJ window columns the tile outputs.
    const int j = tid % (2 * kTJ), first = (tid / (2 * kTJ)) * kSeg;
    const int c = (j / kTJ) * kLJ + kHalo + j % kTJ;
    tile_pass<false>(tid < 2 * kTJ * kSegs, s + c, s + kLI * kPitch + c,
                     kPitch, first, bi, h, 1.0f);
  }
  const size_t fq = (size_t)frame * hp * wp;
  for (int idx = tid; idx < 4 * kTI * kTJ; idx += kTileThreads) {
    const int r = idx / (2 * kTJ), c = idx % (2 * kTJ);
    const int hr = r / kTI, k = r % kTI, hc = c / kTJ, m = c % kTJ;
    const int gi = ti * kTI + k, gj = tj * kTJ + m;
    if (gi >= h || gj >= w) continue;
    const float v = s[(hr * kLI + kHalo + k) * kPitch + hc * kLJ + kHalo + m];
    if (!last && hr == 0 && hc == 0) {
      ll.p[frame * ll.frame + (size_t)gi * ll.pitch + gj] = v;
    } else {
      const size_t o = fq + (size_t)(hr * h + gi) * wp + hc * w + gj;
      if (kQuant)
        q[o] = (int32_t)truncf(v);
      else
        out[o] = v;
    }
  }
}

// ---------------------------------------------------------- coarse levels
//
// One block of (32, 32) threads per frame keeps the levels from lc on in
// shared memory: two buffers of (hp>>lc) x (wp>>lc) floats at an odd pitch
// P (so that row segments of neighbouring threads hit distinct banks).
// Each pass lifts segments of the level's lines as the tiles do, reading
// one buffer and writing the other, so no barrier separates a segment's
// loads from its stores, and the (de)interleaving of the halves is folded
// into the stores.  The level's edges are at both ends of every line.

__device__ __forceinline__ int coarse_pitch(int wp, int lc) {
  return (wp >> lc) | 1;
}

// One pass over n_lines lines of n samples per half: line j's slot k at
// lo + j * ls + k * st (high half at + hs); its results to the same slots
// of dlo / dhi (stride dst, line stride dls).  Neighbouring threads take
// neighbouring lines.  The inverse scales lines j < n_lines / 2 by sc_lo,
// the others by sc_hi.
template <bool kInverse>
__device__ __forceinline__ void coarse_pass(const float* lo, int hs, int ls,
                                            int st, float* dlo, float* dhi,
                                            int dls, int dst, int n_lines,
                                            int n, float sc_lo, float sc_hi) {
  const int n_segs = (n + kSeg - 1) / kSeg;
  const int nt = kCoarseSide * kCoarseSide;
  for (int it = threadIdx.y * kCoarseSide + threadIdx.x;
       it < n_lines * n_segs; it += nt) {
    const int j = it % n_lines, first = (it / n_lines) * kSeg - kHalo;
    Seg g;
    seg_load<true>(g, lo + j * ls, lo + j * ls + hs, st, first, n);
    seg_lift<kInverse>(g, first, n, j < n_lines / 2 ? sc_lo : sc_hi);
    seg_store<true>(g, dlo + j * dls, dhi + j * dls, dst, first, n);
  }
  __syncthreads();
}

// Forward levels [lc, levels) of one frame per block.  `a` holds the
// level's spatial block; the row pass writes its deinterleaved rows to `b`,
// the column pass the deinterleaved columns back to `a`, which then holds
// the level's Mallat block: its LL is the next level's spatial block, and
// every other coefficient (all of them at the last level) goes out.
template <bool kQuant>
__global__ void __launch_bounds__(kCoarseSide* kCoarseSide)
    fwd_coarse(Plane src, float* out, int32_t* q, int hp, int wp, int lc,
               int levels) {
  extern __shared__ float smem[];
  const int P = coarse_pitch(wp, lc), H0 = hp >> lc, W0 = wp >> lc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  float* a = smem;
  float* b = smem + H0 * P;
  const int frame = blockIdx.x;
  const float* sf = src.p + frame * src.frame;
  for (int r = ty; r < H0; r += kCoarseSide)
    for (int c = tx; c < W0; c += kCoarseSide)
      cp_async4(a + r * P + c, sf + (size_t)r * src.pitch + c);
  cp_async_wait();
  __syncthreads();
  const size_t fq = (size_t)frame * hp * wp;
  for (int l = lc; l < levels; ++l) {
    const int hl = hp >> l, wl = wp >> l, h = hl >> 1, w = wl >> 1;
    // rows: samples 2k, 2k+1 of row j -> columns k, w + k of b
    coarse_pass<false>(a, 1, P, 2, b, b + w, P, 1, hl, w, 1.0f, 1.0f);
    // columns: rows 2k, 2k+1 of column j -> rows k, h + k of a
    coarse_pass<false>(b, P, 1, 2 * P, a, a + h * P, 1, P, wl, h, 1.0f, 1.0f);
    for (int r = ty; r < hl; r += kCoarseSide)
      for (int c = tx; c < wl; c += kCoarseSide) {
        if (l + 1 < levels && r < h && c < w) continue;
        const float v = a[r * P + c];
        const size_t o = fq + (size_t)r * wp + c;
        if (kQuant)
          q[o] = (int32_t)truncf(v);
        else
          out[o] = v;
      }
    // The next level's passes only touch the LL block, which this loop
    // does not write.
  }
}

// Inverse levels levels-1 down to lc of one frame per block (blockIdx.x;
// blockIdx.y = K3's cut within its group, 0 for K2).  `a` holds the
// level's Mallat block (its LL the previous level's output), the halves
// scaled for the column pass; the column pass writes interleaved rows to
// `b`, the row pass interleaved columns back to `a`, which then holds the
// level's spatial block.  That of level lc goes to dst.
__global__ void __launch_bounds__(kCoarseSide* kCoarseSide)
    inv_coarse(const int32_t* q, const int32_t* cut, int cut_d0, int hp,
               int wp, int lc, int levels, Plane dst) {
  extern __shared__ float smem[];
  const int P = coarse_pitch(wp, lc), H0 = hp >> lc, W0 = wp >> lc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  float* a = smem;
  float* b = smem + H0 * P;
  const int frame = blockIdx.x, z = blockIdx.y;
  const Dequant dq = dequant_at(__ldg(cut + z + frame / cut_d0));
  const int32_t* qf = q + (size_t)frame * hp * wp;
  // The integers of every coarse level, as raw bits, into `a`: each level
  // consumes its own (hl, wl) block before its passes write over it, and
  // leaves the finer levels' integers outside that block in place.
  for (int r = ty; r < H0; r += kCoarseSide)
    for (int c = tx; c < W0; c += kCoarseSide)
      cp_async4(a + r * P + c, qf + (size_t)r * wp + c);
  cp_async_wait();
  __syncthreads();
  for (int l = levels - 1; l >= lc; --l) {
    const int hl = hp >> l, wl = wp >> l, h = hl >> 1, w = wl >> 1;
    for (int r = ty; r < hl; r += kCoarseSide)
      for (int c = tx; c < wl; c += kCoarseSide) {
        const float x = a[r * P + c];
        const float v = (l + 1 < levels && r < h && c < w)
                            ? x
                            : dequant(__float_as_int(x), dq);
        a[r * P + c] = __fmul_rn(v, r < h ? kInvXi : kXi);
      }
    __syncthreads();
    // columns: rows k, h + k of column j -> rows 2k, 2k+1 of b, scaled by
    // the column's half for the row pass
    coarse_pass<true>(a, h * P, 1, P, b, b + P, 1, 2 * P, wl, h, kInvXi, kXi);
    // rows: columns k, w + k of row j -> columns 2k, 2k+1 of a
    coarse_pass<true>(b, w, P, 1, a, a + 1, P, 2, hl, w, 1.0f, 1.0f);
  }
  float* df = dst.p + z * dst.cut_stride + frame * dst.frame;
  for (int r = ty; r < H0; r += kCoarseSide)
    for (int c = tx; c < W0; c += kCoarseSide)
      df[(size_t)r * dst.pitch + c] = a[r * P + c];
}

// Reduces each (cut, frame)'s n_parts partials, one block each (blockIdx.x
// the frame, blockIdx.y the cut), in a fixed order: thread t merges parts
// t, t + 256, ... in turn, then the block tree.  out[(cut * n_frames +
// frame) * 4 + {0,1,2,3}] = sum, max, min, count.
__global__ void curve_reduce(const double* p_sum, const float* p_mx,
                             const float* p_mn, const int* p_bad, int n_parts,
                             double* out) {
  const size_t cell = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const size_t r0 = cell * n_parts;
  Stats acc = stats_identity();
  for (int r = threadIdx.x; r < n_parts; r += blockDim.x)
    stats_merge(acc, Stats{p_sum[r0 + r], p_mx[r0 + r], p_mn[r0 + r],
                           p_bad[r0 + r]});
  const Stats v = block_reduce(acc, threadIdx.x);
  if (threadIdx.x == 0) {
    out[cell * 4 + 0] = v.sum;
    out[cell * 4 + 1] = (double)v.mx;
    out[cell * 4 + 2] = (double)v.mn;
    out[cell * 4 + 3] = (double)v.bad;
  }
}

// ------------------------------------------------------------------- host

// Kernels launched since the library was loaded, so a caller counts the
// launches of one call without a profiler.
std::atomic<long long> g_launched{0};
// The same count for the calling thread alone: a thread that captures a
// CUDA graph counts the launches it recorded while other threads launch.
thread_local long long t_launched = 0;

// The error of the launch just made, counted when it went out.
int launched() {
  const int err = (int)cudaGetLastError();
  if (!err) {
    g_launched.fetch_add(1, std::memory_order_relaxed);
    ++t_launched;
  }
  return err;
}

int set_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Shared memory of the coarse kernels from level lc: two buffers of the
// level's block at an odd pitch.
size_t coarse_bytes(int hp, int wp, int lc) {
  return 2 * (size_t)(hp >> lc) * ((wp >> lc) | 1) * sizeof(float);
}

// The finest level l >= lmin from which every coarser level fits in one
// block's shared memory, or `levels` when none does.
int coarse_from(int hp, int wp, int levels, int lmin) {
  for (int l = lmin; l < levels; ++l)
    if (coarse_bytes(hp, wp, l) <= (size_t)kCoarseSmem) return l;
  return levels;
}

const dim3 kTileBlock(kWin, kRowsY);
const dim3 kCoarseBlock(kCoarseSide, kCoarseSide);

// Floats of the level planes of n_frames frames (levels >= 1).
size_t scratch_floats(int n_frames, int hp, int wp) {
  return (size_t)n_frames *
         ((size_t)(hp >> 1) * (wp >> 1) + (size_t)(hp >> 2) * (wp >> 2));
}

// The compact plane of level l >= 1 (its (hp>>l) x (wp>>l) blocks) in the
// scratch buffer: odd levels in the first part (n_frames planes of
// (hp/2) x (wp/2) floats), even levels after it, so a level never reads
// the plane it writes.  K3's cut z of a group has its planes at
// scratch + z * scratch_floats.
Plane level_plane(float* scratch, int n_frames, int hp, int wp, int l) {
  const size_t first = (size_t)n_frames * (hp >> 1) * (wp >> 1);
  return Plane{(l & 1) ? scratch : scratch + first,
               (size_t)(hp >> l) * (wp >> l), wp >> l,
               scratch_floats(n_frames, hp, wp)};
}

dim3 tile_grid(int hl, int wl, int n_frames, int n_cuts, int* n_tj) {
  const int n_ti = ((hl >> 1) + kTI - 1) / kTI;
  *n_tj = ((wl >> 1) + kTJ - 1) / kTJ;
  return dim3(n_ti * *n_tj, n_frames, n_cuts);
}

// Inverse levels levels-1 down to lo of n_cuts cuts (cut[z + frame /
// cut_d0] for cut z), one launch per level; level 0's output goes to out
// (n_cuts = 1), every other level's to its scratch plane.
int inverse_levels(const int32_t* q, const int32_t* cut, int cut_d0,
                   float* scratch, Plane out, int n_frames, int n_cuts,
                   int hp, int wp, int levels, int lo, cudaStream_t st) {
  auto plane = [&](int l) {
    return l == 0 ? out : level_plane(scratch, n_frames, hp, wp, l);
  };
  const int lc = coarse_from(hp, wp, levels, lo);
  if (lc < levels) {
    const int bytes = (int)coarse_bytes(hp, wp, lc);
    int err = set_smem((const void*)inv_coarse, bytes);
    if (err) return err;
    inv_coarse<<<dim3(n_frames, n_cuts), kCoarseBlock, bytes, st>>>(
        q, cut, cut_d0, hp, wp, lc, levels, plane(lc));
    err = launched();
    if (err) return err;
  }
  for (int l = lc - 1; l >= lo; --l) {
    const int hl = hp >> l, wl = wp >> l;
    int n_tj;
    const dim3 grid = tile_grid(hl, wl, n_frames, n_cuts, &n_tj);
    const Plane ll = l + 1 < levels ? plane(l + 1) : Plane{nullptr, 0, 0};
    inv_tile<<<grid, kTileBlock, 0, st>>>(q, cut, cut_d0, hp, wp, ll,
                                          plane(l), hl, wl, n_tj);
    const int err = launched();
    if (err) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Floats of scratch the forward and inverse transforms of n_frames frames
// need.
long long ebcc_dwt97_scratch_floats(int n_frames, int hp, int wp) {
  return (long long)scratch_floats(n_frames, hp, wp);
}

// Floats of scratch ebcc_curve_stats needs for a grid of n_cuts cuts: the
// level planes of one group of cuts.
long long ebcc_curve_scratch_floats(int n_cuts, int n_frames, int hp,
                                    int wp) {
  return (long long)(n_cuts < kCutGroup ? n_cuts : kCutGroup) *
         (long long)scratch_floats(n_frames, hp, wp);
}

// Kernels this library has launched since it was loaded.
long long ebcc_kernels_launched() {
  return g_launched.load(std::memory_order_relaxed);
}

// Kernels this library has launched from the calling thread.
long long ebcc_thread_launched() { return t_launched; }

// Adds n to the library's count: the kernels of a CUDA graph replay, which
// run again without passing through this library's launch sites.
void ebcc_add_launched(long long n) {
  g_launched.fetch_add(n, std::memory_order_relaxed);
}

// Cuts per group of ebcc_curve_stats' launches.
int ebcc_curve_cut_group() { return kCutGroup; }

// Number of per-(cut, frame) partials of ebcc_curve_stats for a valid
// region of (vh, vw): one per 64x64 output tile of level 0 covering it.
int ebcc_curve_parts(int vh, int vw) {
  return ((vh + 2 * kTI - 1) / (2 * kTI)) * ((vw + 2 * kTJ - 1) / (2 * kTJ));
}

// Multi-level forward transform of n_frames (hp, wp) float32 frames.
// scratch: ebcc_dwt97_scratch_floats floats.  The coefficients go to q
// truncated toward zero when q is given, else to out (float32, hp x wp per
// frame).
int ebcc_dwt2d_forward(const float* x, float* scratch, float* out, int32_t* q,
                       int n_frames, int hp, int wp, int levels,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto plane = [&](int l) {
    return l == 0 ? Plane{(float*)x, (size_t)hp * wp, wp}
                  : level_plane(scratch, n_frames, hp, wp, l);
  };
  const int lc = coarse_from(hp, wp, levels, 0);
  for (int l = 0; l < lc; ++l) {
    const int hl = hp >> l, wl = wp >> l;
    int n_tj;
    const dim3 grid = tile_grid(hl, wl, n_frames, 1, &n_tj);
    const int last = l == levels - 1;
    const Plane ll = last ? Plane{nullptr, 0, 0} : plane(l + 1);
    if (q != nullptr)
      fwd_tile<true><<<grid, kTileBlock, 0, st>>>(plane(l), ll, out, q, hp, wp,
                                                hl, wl, n_tj, last);
    else
      fwd_tile<false><<<grid, kTileBlock, 0, st>>>(plane(l), ll, out, q, hp,
                                                 wp, hl, wl, n_tj, last);
    const int err = launched();
    if (err) return err;
  }
  if (lc < levels) {
    const int bytes = (int)coarse_bytes(hp, wp, lc);
    const void* fn = q != nullptr ? (const void*)fwd_coarse<true>
                                  : (const void*)fwd_coarse<false>;
    int err = set_smem(fn, bytes);
    if (err) return err;
    if (q != nullptr)
      fwd_coarse<true><<<n_frames, kCoarseBlock, bytes, st>>>(
          plane(lc), out, q, hp, wp, lc, levels);
    else
      fwd_coarse<false><<<n_frames, kCoarseBlock, bytes, st>>>(
          plane(lc), out, q, hp, wp, lc, levels);
    err = launched();
    if (err) return err;
  }
  return 0;
}

// Dequantize n_frames (hp, wp) int32 frames at their chunk's cut
// (cut[frame / d0]) and run the multi-level inverse transform into out.
// scratch: ebcc_dwt97_scratch_floats floats.
int ebcc_idwt2d_dequant(const int32_t* q, const int32_t* cut, float* scratch,
                        float* out, int n_frames, int d0, int hp, int wp,
                        int levels, void* stream) {
  return inverse_levels(q, cut, d0, scratch, Plane{out, (size_t)hp * wp, wp},
                        n_frames, 1, hp, wp, levels, 0, (cudaStream_t)stream);
}

// Error-vs-cut statistics (K3).  For each of the n_cuts cuts in `cuts`
// (device int32, any order, repeats taken), in groups of kCutGroup cuts:
// levels levels-1 .. 1 of every frame as K2 reconstructs them at each cut
// of the group, one launch per level, into `scratch`
// (ebcc_curve_scratch_floats floats); then curve_tile, for the valid
// region rows [0, vh) x cols [0, vw), err = t - (rec * scale[chunk] +
// off[chunk]) and its tile partials (part_* arrays of n_cuts * n_frames *
// ebcc_curve_parts(vh, vw) entries).  Last, one launch reduces the partials
// of each (cut, frame) into out (n_cuts, n_frames, 4) float64: sum, max,
// min, count(|err| > target[chunk]).  chunk = frame / d0.
int ebcc_curve_stats(const int32_t* q, const float* t, const int32_t* cuts,
                     const float* scale, const float* off,
                     const float* target, float* scratch, double* part_sum,
                     float* part_mx, float* part_mn, int* part_bad,
                     double* out, int n_cuts, int n_frames, int d0, int hp,
                     int wp, int levels, int vh, int vw, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_ti = (vh + 2 * kTI - 1) / (2 * kTI);
  const int n_tj = (vw + 2 * kTJ - 1) / (2 * kTJ);
  const size_t per_cut = (size_t)n_frames * n_ti * n_tj;
  const Plane ll = levels > 1 ? level_plane(scratch, n_frames, hp, wp, 1)
                              : Plane{nullptr, 0, 0};
  for (int k = 0; k < n_cuts; k += kCutGroup) {
    const int n = n_cuts - k < kCutGroup ? n_cuts - k : kCutGroup;
    // cut_d0 = n_frames: every frame of cut z reads cuts[k + z].
    int err = inverse_levels(q, cuts + k, n_frames, scratch,
                             Plane{nullptr, 0, 0}, n_frames, n, hp, wp,
                             levels, 1, st);
    if (err) return err;
    const StatsArgs sa{t, scale, off, target, d0, vh, vw,
                       part_sum + k * per_cut, part_mx + k * per_cut,
                       part_mn + k * per_cut, part_bad + k * per_cut};
    err = set_smem((const void*)curve_tile, kCurveSmem);
    if (err) return err;
    curve_tile<<<dim3(n_ti * n_tj, n_frames), kTileBlock, kCurveSmem, st>>>(
        q, cuts + k, n, ll, hp, wp, n_tj, sa);
    err = launched();
    if (err) return err;
  }
  curve_reduce<<<dim3(n_frames, n_cuts), kReduceThreads, 0, st>>>(
      part_sum, part_mx, part_mn, part_bad, n_ti * n_tj, out);
  return launched();
}

}  // extern "C"
