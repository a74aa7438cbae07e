// Hand-written CUDA kernels (sm_90a) for the CDF 9/7 transforms of the codec.
//
// Replaces the three Pallas TPU kernels of the encode/decode path:
//   K1  ebcc_tpu/ops/dwt_pallas.py  dwt2d_quantize_pallas  (forward + trunc)
//   K2  ebcc_tpu/ops/dwt_pallas.py  idwt2d_dequant_pallas  (dequant + inverse)
//   K3  ebcc_tpu/ops/dwt_pallas.py  curve_stats_pallas     (error-vs-cut curve)
// and, with quantization switched off, the residual layer's forward
// transform (XLA code in the reference, ebcc_tpu/core/kernels.py:348).
//
// What bounds them on an H100: memory traffic.  A lifting pass does ~7 flops
// per sample against 8 bytes moved, far below the card's ~20 flops/byte
// float32 balance point.  The TPU kernels keep one whole frame resident in
// VMEM; a padded 736x1440 float32 frame is 4.2 MB, which no Hopper block's
// 227 KB of shared memory can hold.  So each level runs as two launches:
//   * a row pass: one block per (row, frame) loads the whole row (<= 8 KB)
//     into shared memory, runs the four lifting steps in place separated by
//     __syncthreads(), scales, and writes it back deinterleaved (forward) or
//     interleaved (inverse);
//   * a column pass: one block per (32-column tile, frame) loads the tile of
//     whole columns (32 x rows floats, 94 KB at 736 rows) with loads
//     coalesced across the 32 columns, lifts along the rows, writes back.
// Between passes the frame goes through device memory, which the 50 MB L2
// mostly absorbs at these sizes.  Frames never share a block, so a frame's
// result does not depend on the batch it rides in.  K2 fuses the
// dequantization into the loads of its first touch of every coefficient; K1
// fuses the truncation into the stores of the last pass that writes each
// coefficient.  Faster designs (cp.async/TMA halo tiles, several levels per
// launch, a frame kept in L2 or across a cluster's shared memory) are later
// work.
//
// K3 runs K2's passes once per cut of its grid over one frame-batch of
// scratch (so its memory does not grow with the grid), with the error
// statistics fused into the last row pass: that pass writes no frame, only
// per-row partials (float64 sum, max, min, count), and one more launch
// reduces each (cut, frame)'s rows in a fixed order, never with atomics,
// so the sum does not depend on the batch or the run.  Its bound: the
// operations of n_cuts inverse transforms against one read of q and t
// (8 B per coefficient); the TPU kernel kept the frame in VMEM across all
// cuts, which a Hopper block cannot, so each cut costs K2's frame trips.
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

constexpr int kRowThreads = 256;
constexpr int kTileCols = 32;
constexpr int kColRows = 8;  // blockDim.y of the column pass

__device__ __forceinline__ float lift(float x, float c, float a, float b) {
  return __fadd_rn(x, __fmul_rn(c, __fadd_rn(a, b)));
}

// Dequantize one coefficient at `cut` (ebcc_tpu/ops/dwt_pallas.py:164-172):
// keep |q| >> cut << cut, add the half step (or 0.5 at cut 0) when
// significant, restore the sign.  Exact in float32 for |q| < 2^23.
__device__ __forceinline__ float dequant(int32_t q, int cut) {
  cut = cut < 0 ? 0 : (cut > 30 ? 30 : cut);  // valid cuts are < 32 planes
  int32_t mag = q < 0 ? -q : q;
  int32_t kept = (mag >> cut) << cut;
  float rec = 0.0f;
  if (kept > 0) {
    float off = cut > 0 ? (float)((1 << cut) >> 1) : 0.0f;
    rec = __fadd_rn(__fadd_rn((float)kept, off), cut == 0 ? 0.5f : 0.0f);
  }
  return q < 0 ? -rec : rec;
}

// ---------------------------------------------------------------- forward

// Forward lifting of the 2*h interleaved samples s[0..2h) in place; the
// caller syncs before, the last step syncs after.
__device__ __forceinline__ void fwd_lift_row(float* s, int h) {
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    int n = i + 1 < h ? i + 1 : h - 1;
    s[2 * i + 1] = lift(s[2 * i + 1], kAlpha, s[2 * i], s[2 * n]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    int p = i > 0 ? i - 1 : 0;
    s[2 * i] = lift(s[2 * i], kBeta, s[2 * p + 1], s[2 * i + 1]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    int n = i + 1 < h ? i + 1 : h - 1;
    s[2 * i + 1] = lift(s[2 * i + 1], kGamma, s[2 * i], s[2 * n]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    int p = i > 0 ? i - 1 : 0;
    s[2 * i] = lift(s[2 * i], kDelta, s[2 * p + 1], s[2 * i + 1]);
  }
  __syncthreads();
}

// Row pass of forward level: rows [0, hl) x cols [0, wl) of each frame.
// src and dst may alias (a block owns its whole row).
__global__ void fwd_rows(const float* src, float* dst, int hp, int wp, int wl) {
  extern __shared__ float s[];
  const size_t base = (size_t)blockIdx.y * hp * wp + (size_t)blockIdx.x * wp;
  const int h = wl >> 1;
  for (int j = threadIdx.x; j < wl; j += blockDim.x) s[j] = src[base + j];
  __syncthreads();
  fwd_lift_row(s, h);
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    dst[base + i] = __fmul_rn(s[2 * i], kXi);
    dst[base + h + i] = __fmul_rn(s[2 * i + 1], kInvXi);
  }
}

// Column pass of forward level on a 32-column tile of rows [0, hl).  A
// coefficient this level writes is final unless it lies in the next level's
// LL block (rows < hl/2, cols < wl/2, not the last level): final ones go to
// q truncated toward zero when q is given, everything else to buf.
__global__ void fwd_cols(float* buf, int32_t* q, int hp, int wp, int hl,
                         int wl, int last) {
  extern __shared__ float s[];
  const int c = threadIdx.x;
  const int col = blockIdx.x * kTileCols + c;
  const bool live = col < wl;
  const size_t frame = (size_t)blockIdx.y * hp * wp;
  for (int r = threadIdx.y; r < hl; r += blockDim.y)
    if (live) s[r * kTileCols + c] = buf[frame + (size_t)r * wp + col];
  __syncthreads();
  const int h = hl >> 1;
  // Lift each column: thread (c, y) walks the column's pairs y, y+8, ...
  float* sc = s + c;
  for (int step = 0; step < 4; ++step) {
    const bool odd_step = (step & 1) == 0;  // steps 0, 2 update odd samples
    const float coef = step == 0 ? kAlpha : step == 1 ? kBeta
                     : step == 2 ? kGamma : kDelta;
    if (live) {
      for (int i = threadIdx.y; i < h; i += blockDim.y) {
        if (odd_step) {
          int n = i + 1 < h ? i + 1 : h - 1;
          sc[(2 * i + 1) * kTileCols] =
              lift(sc[(2 * i + 1) * kTileCols], coef, sc[2 * i * kTileCols],
                   sc[2 * n * kTileCols]);
        } else {
          int p = i > 0 ? i - 1 : 0;
          sc[2 * i * kTileCols] =
              lift(sc[2 * i * kTileCols], coef, sc[(2 * p + 1) * kTileCols],
                   sc[(2 * i + 1) * kTileCols]);
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  const bool col_in_next = col < (wl >> 1);
  for (int r = threadIdx.y; r < hl; r += blockDim.y) {
    // output row r holds even sample r (r < h) or odd sample r - h
    float v = r < h ? __fmul_rn(sc[2 * r * kTileCols], kXi)
                    : __fmul_rn(sc[(2 * (r - h) + 1) * kTileCols], kInvXi);
    const size_t o = frame + (size_t)r * wp + col;
    const bool final_here = last || r >= h || !col_in_next;
    if (q != nullptr && final_here)
      q[o] = (int32_t)truncf(v);
    else
      buf[o] = v;
  }
}

// ---------------------------------------------------------------- inverse

// Column pass of inverse level l on a 32-column tile of rows [0, hl).
// Coefficients inside the already reconstructed block (rows < hd, cols < wd)
// are read from out; all others are read from q and dequantized at the
// frame's chunk cut.
__global__ void inv_cols(const int32_t* q, const int32_t* cut, float* out,
                         int d0, int hp, int wp, int hl, int wl, int hd,
                         int wd) {
  extern __shared__ float s[];
  const int c = threadIdx.x;
  const int col = blockIdx.x * kTileCols + c;
  const bool live = col < wl;
  const size_t frame = (size_t)blockIdx.y * hp * wp;
  const int fcut = cut[blockIdx.y / d0];
  const int h = hl >> 1;
  float* sc = s + c;
  if (live) {
    for (int r = threadIdx.y; r < hl; r += blockDim.y) {
      const size_t o = frame + (size_t)r * wp + col;
      float v = (r < hd && col < wd) ? out[o] : dequant(q[o], fcut);
      // rows [0, h) are even samples, [h, hl) odd; scale on load
      sc[r * kTileCols] = r < h ? __fmul_rn(v, kInvXi) : __fmul_rn(v, kXi);
    }
  }
  __syncthreads();
  // even at sc[i], odd at sc[(h + i)] (units of kTileCols)
  for (int step = 0; step < 4; ++step) {
    const bool even_step = (step & 1) == 0;  // steps 0, 2 update even
    const float coef = step == 0 ? kNegDelta : step == 1 ? kNegGamma
                     : step == 2 ? kNegBeta : kNegAlpha;
    if (live) {
      for (int i = threadIdx.y; i < h; i += blockDim.y) {
        if (even_step) {
          int p = i > 0 ? i - 1 : 0;
          sc[i * kTileCols] = lift(sc[i * kTileCols], coef,
                                   sc[(h + p) * kTileCols],
                                   sc[(h + i) * kTileCols]);
        } else {
          int n = i + 1 < h ? i + 1 : h - 1;
          sc[(h + i) * kTileCols] = lift(sc[(h + i) * kTileCols], coef,
                                         sc[i * kTileCols],
                                         sc[n * kTileCols]);
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  for (int r = threadIdx.y; r < hl; r += blockDim.y) {
    // output row r = even sample r/2 (r even) or odd sample r/2 (r odd)
    const int i = r >> 1;
    out[frame + (size_t)r * wp + col] =
        (r & 1) ? sc[(h + i) * kTileCols] : sc[i * kTileCols];
  }
}

// Loads row [0, wl) of src into s (even half scaled by 1/xi, odd by xi)
// and runs the four inverse lifting steps in place: afterwards sample 2i is
// s[i] and sample 2i+1 is s[h + i].
__device__ __forceinline__ void inv_lift_row(float* s, const float* src,
                                             int wl) {
  const int h = wl >> 1;
  for (int j = threadIdx.x; j < wl; j += blockDim.x) {
    float v = src[j];
    s[j] = j < h ? __fmul_rn(v, kInvXi) : __fmul_rn(v, kXi);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    int p = i > 0 ? i - 1 : 0;
    s[i] = lift(s[i], kNegDelta, s[h + p], s[h + i]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    int n = i + 1 < h ? i + 1 : h - 1;
    s[h + i] = lift(s[h + i], kNegGamma, s[i], s[n]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    int p = i > 0 ? i - 1 : 0;
    s[i] = lift(s[i], kNegBeta, s[h + p], s[h + i]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    int n = i + 1 < h ? i + 1 : h - 1;
    s[h + i] = lift(s[h + i], kNegAlpha, s[i], s[n]);
  }
  __syncthreads();
}

// Row pass of inverse level: rows [0, hl) x cols [0, wl), in place on out.
__global__ void inv_rows(float* out, int hp, int wp, int wl) {
  extern __shared__ float s[];
  const size_t base = (size_t)blockIdx.y * hp * wp + (size_t)blockIdx.x * wp;
  const int h = wl >> 1;
  inv_lift_row(s, out + base, wl);
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    out[base + 2 * i] = s[i];
    out[base + 2 * i + 1] = s[h + i];
  }
}

// ------------------------------------------------------------ curve stats

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

// Tree reduction of one Stats per thread over a block of kRowThreads
// threads.  The pairing is fixed, so the float64 sum comes out the same on
// every run for the same inputs.  Thread 0 returns the block's result.
__device__ Stats block_reduce(Stats v) {
  __shared__ double r_sum[kRowThreads];
  __shared__ float r_mx[kRowThreads], r_mn[kRowThreads];
  __shared__ int r_bad[kRowThreads];
  const int t = threadIdx.x;
  r_sum[t] = v.sum;
  r_mx[t] = v.mx;
  r_mn[t] = v.mn;
  r_bad[t] = v.bad;
  __syncthreads();
  for (int half = kRowThreads / 2; half > 0; half >>= 1) {
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

// Last row pass of the inverse transform fused with the error statistics:
// one block per (valid row, frame).  The row is lifted as in inv_rows, then
// every valid column's err = t - (rec * scale + off) (each op rounded on
// its own, as the plain version computes it) is reduced to the row's
// partial statistics.  The reconstruction itself is never stored.
__global__ void inv_rows_stats(const float* buf, const float* t,
                               const float* scale, const float* off,
                               const float* target, int d0, int hp, int wp,
                               int vw, double* row_sum, float* row_mx,
                               float* row_mn, int* row_bad) {
  extern __shared__ float s[];
  const size_t base = (size_t)blockIdx.y * hp * wp + (size_t)blockIdx.x * wp;
  const int h = wp >> 1;
  inv_lift_row(s, buf + base, wp);
  const int chunk = blockIdx.y / d0;
  const float sc = scale[chunk], of = off[chunk], tg = target[chunk];
  Stats acc = stats_identity();
  for (int j = threadIdx.x; j < vw; j += blockDim.x) {
    const float rec = (j & 1) ? s[h + (j >> 1)] : s[j >> 1];
    const float err = __fsub_rn(t[base + j],
                                __fadd_rn(__fmul_rn(rec, sc), of));
    acc.sum += (double)err;
    acc.mx = fmaxf(acc.mx, err);
    acc.mn = fminf(acc.mn, err);
    acc.bad += fabsf(err) > tg ? 1 : 0;
  }
  const Stats r = block_reduce(acc);
  if (threadIdx.x == 0) {
    const size_t o = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    row_sum[o] = r.sum;
    row_mx[o] = r.mx;
    row_mn[o] = r.mn;
    row_bad[o] = r.bad;
  }
}

// Reduces each (cut, frame)'s vh row partials, one block each (blockIdx.x
// the frame, blockIdx.y the cut), in a fixed order: thread t sums rows t,
// t + 256, ... in turn, then the block tree.  out[(cut * n_frames + frame)
// * 4 + {0,1,2,3}] = sum, max, min, count.
__global__ void curve_reduce(const double* row_sum, const float* row_mx,
                             const float* row_mn, const int* row_bad,
                             int vh, double* out) {
  const size_t cell = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const size_t r0 = cell * vh;
  Stats acc = stats_identity();
  for (int r = threadIdx.x; r < vh; r += blockDim.x)
    stats_merge(acc, Stats{row_sum[r0 + r], row_mx[r0 + r], row_mn[r0 + r],
                           row_bad[r0 + r]});
  const Stats v = block_reduce(acc);
  if (threadIdx.x == 0) {
    out[cell * 4 + 0] = v.sum;
    out[cell * 4 + 1] = (double)v.mx;
    out[cell * 4 + 2] = (double)v.mn;
    out[cell * 4 + 3] = (double)v.bad;
  }
}

int col_smem(int hl) { return hl * kTileCols * (int)sizeof(float); }

int set_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// Largest padded frame height the column pass takes (its tile of 32 whole
// columns must fit in one block's shared memory).
int ebcc_dwt97_max_rows(void) { return (227 * 1024) / (kTileCols * 4); }

// Multi-level forward transform of n_frames (hp, wp) float32 frames.
// scratch: n_frames*hp*wp float32 work buffer.  q: int32 output, truncated
// toward zero; when q is null the float coefficients are left in scratch.
int ebcc_dwt2d_forward(const float* x, float* scratch, int32_t* q,
                       int n_frames, int hp, int wp, int levels,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = set_smem((const void*)fwd_cols, col_smem(hp));
  if (err) return err;
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int hl = hp >> lvl, wl = wp >> lvl;
    fwd_rows<<<dim3(hl, n_frames), kRowThreads, wl * sizeof(float), st>>>(
        lvl == 0 ? x : scratch, scratch, hp, wp, wl);
    err = (int)cudaGetLastError();
    if (err) return err;
    fwd_cols<<<dim3((wl + kTileCols - 1) / kTileCols, n_frames),
               dim3(kTileCols, kColRows), col_smem(hl), st>>>(
        scratch, q, hp, wp, hl, wl, lvl == levels - 1);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// Dequantize n_frames (hp, wp) int32 frames at their chunk's cut
// (cut[frame / d0]) and run the multi-level inverse transform into out.
int ebcc_idwt2d_dequant(const int32_t* q, const int32_t* cut, float* out,
                        int n_frames, int d0, int hp, int wp, int levels,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = set_smem((const void*)inv_cols, col_smem(hp));
  if (err) return err;
  for (int lvl = levels - 1; lvl >= 0; --lvl) {
    const int hl = hp >> lvl, wl = wp >> lvl;
    const int hd = lvl == levels - 1 ? 0 : hl >> 1;
    const int wd = lvl == levels - 1 ? 0 : wl >> 1;
    inv_cols<<<dim3((wl + kTileCols - 1) / kTileCols, n_frames),
               dim3(kTileCols, kColRows), col_smem(hl), st>>>(
        q, cut, out, d0, hp, wp, hl, wl, hd, wd);
    err = (int)cudaGetLastError();
    if (err) return err;
    inv_rows<<<dim3(hl, n_frames), kRowThreads, wl * sizeof(float), st>>>(
        out, hp, wp, wl);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// Error-vs-cut statistics (K3).  For each of the n_cuts cuts in `cuts`
// (device int32): reconstruct every frame as K2 does at that cut into
// `scratch` (n_frames*hp*wp float32), with the last row pass computing, for
// the valid region rows [0, vh) x cols [0, vw), err = t - (rec *
// scale[chunk] + off[chunk]) and its row partials (row_* arrays of
// n_cuts*n_frames*vh entries); then one launch reduces the rows of each
// (cut, frame) into out (n_cuts, n_frames, 4) float64: sum, max, min,
// count(|err| > target[chunk]).  chunk = frame / d0.
int ebcc_curve_stats(const int32_t* q, const float* t, const int32_t* cuts,
                     const float* scale, const float* off,
                     const float* target, float* scratch, double* row_sum,
                     float* row_mx, float* row_mn, int* row_bad, double* out,
                     int n_cuts, int n_frames, int d0, int hp, int wp,
                     int levels, int vh, int vw, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = set_smem((const void*)inv_cols, col_smem(hp));
  if (err) return err;
  const size_t per_cut = (size_t)n_frames * vh;
  for (int k = 0; k < n_cuts; ++k) {
    for (int lvl = levels - 1; lvl >= 0; --lvl) {
      const int hl = hp >> lvl, wl = wp >> lvl;
      const int hd = lvl == levels - 1 ? 0 : hl >> 1;
      const int wd = lvl == levels - 1 ? 0 : wl >> 1;
      // d0 = n_frames: every frame reads its cut from cuts[k].
      inv_cols<<<dim3((wl + kTileCols - 1) / kTileCols, n_frames),
                 dim3(kTileCols, kColRows), col_smem(hl), st>>>(
          q, cuts + k, scratch, n_frames, hp, wp, hl, wl, hd, wd);
      err = (int)cudaGetLastError();
      if (err) return err;
      if (lvl > 0) {
        inv_rows<<<dim3(hl, n_frames), kRowThreads, wl * sizeof(float),
                   st>>>(scratch, hp, wp, wl);
      } else {
        inv_rows_stats<<<dim3(vh, n_frames), kRowThreads, wp * sizeof(float),
                         st>>>(scratch, t, scale, off, target, d0, hp, wp, vw,
                               row_sum + k * per_cut, row_mx + k * per_cut,
                               row_mn + k * per_cut, row_bad + k * per_cut);
      }
      err = (int)cudaGetLastError();
      if (err) return err;
    }
  }
  curve_reduce<<<dim3(n_frames, n_cuts), kRowThreads, 0, st>>>(
      row_sum, row_mx, row_mn, row_bad, vh, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
