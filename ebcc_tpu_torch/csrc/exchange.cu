// Hand-written CUDA kernel (sm_90a) of the decode-direction exchange: X1,
// the blocked-Rice lane decode.
//
// Replaces XLA code of the JAX package, not a Pallas kernel: the 128-step
// lax.scan over 2 * n_blocks lanes of transfer.rice_block_unpack
// (ebcc_tpu/core/transfer.py:842) and the scatter into the dense
// coefficient vector that follows it in kernels.rice_unpack_qflat
// (ebcc_tpu/core/kernels.py:1419).
//
// The host packs the sorted (position, value) pairs of a decode batch as
// element blocks of kBlock (128) entries, each block's gaps and zigzag
// values as two independent Rice-coded bit regions (lane b and lane nb + b)
// with their own parameter k (transfer.rice_block_pack_host; bit layout in
// csrc/host/rice_block_pack.cc).  One thread owns block b: it walks the gap
// lane and the value lane in step, decodes one code of each per step from a
// 64-bit window read at the lane's running bit offset (the window's first
// word clipped to nw - 3, quotients >= kEsc escape to 32 raw bits, as the
// reference reads them), accumulates the position and stores the value at
// it in qflat, which the caller cleared.  A block's codes stop at its own
// count (nnz - 128 * b, at most 128), so no lane steps past its data.
// Lane start offsets come from the caller (exclusive cumsums of the u16
// block bit lengths, transfer.rice_lane_offsets), nnz from device memory,
// so the launch needs no synchronisation with the host.
//
// What bounds it on an H100: by bytes, about 1 B of words per coefficient
// read and the dense qflat written once (8 B per grid coefficient of the
// two layers, mostly by the caller's zeroing) at 3.35 TB/s.  What paces it
// is the dependent chain: each thread decodes up to 256 codes in sequence,
// every code's window depending on the previous code's length, and a
// batch has only nnz / 128 threads (one warp per block, so they spread
// over the SMs).  This kernel is the simple and right version; making it
// fast (several threads per lane, a warp-cooperative bit reader) is later
// work.  It launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kBlock = 128;   // transfer.RICE_BLOCK
constexpr int kEsc = 20;      // transfer.RICE_ESC
constexpr int kThreads = 32;  // one warp per CUDA block

// One Rice code at bit ``off`` with parameter k -> z; advances off.
__device__ __forceinline__ uint32_t decode_one(
    const uint32_t* __restrict__ words, long long nw, long long& off,
    uint32_t k) {
  const uint32_t sh = (uint32_t)(off & 31);
  long long wi = off >> 5;
  if (wi > nw - 3) wi = nw - 3;
  if (wi < 0) wi = 0;
  const uint64_t a = ((uint64_t)words[wi + 1] << 32) | words[wi];
  const uint64_t b = ((uint64_t)words[wi + 2] << 32) | words[wi + 1];
  const uint32_t lo = (uint32_t)(a >> sh);
  const uint32_t hi = (uint32_t)(b >> sh);
  const uint32_t y = ~lo;
  const uint32_t q = y == 0u ? 32u : (uint32_t)(__ffs((int)y) - 1);
  if (q >= (uint32_t)kEsc) {
    off += kEsc + 32;
    return (lo >> kEsc) | (hi << (32 - kEsc));
  }
  off += q + 1 + k;
  return (q << k) | ((lo >> (q + 1)) & ((1u << k) - 1u));
}

__global__ void __launch_bounds__(kThreads)
    rice_lanes(const uint32_t* __restrict__ words, long long nw,
               const long long* __restrict__ off_lane,
               const uint8_t* __restrict__ k_packed,
               const int32_t* __restrict__ base_pos,
               const int32_t* __restrict__ nnz_ptr, int nb, long long n_out,
               int32_t* __restrict__ qflat) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= nb) return;
  long long n = (long long)*nnz_ptr - (long long)b * kBlock;
  if (n <= 0) return;
  if (n > kBlock) n = kBlock;
  long long og = off_lane[b];
  long long ov = off_lane[nb + b];
  const uint32_t kp = k_packed[b];
  const uint32_t kg = kp & 15u, kv = kp >> 4;
  long long pos = base_pos[b];
  for (int t = 0; t < n; ++t) {
    pos += (long long)decode_one(words, nw, og, kg) + 1;
    const uint32_t z = decode_one(words, nw, ov, kv);
    const int32_t v = (int32_t)(z >> 1) ^ -(int32_t)(z & 1u);
    if (pos >= 0 && pos < n_out) qflat[pos] = v;
  }
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

// Decode nb blocked-Rice lane pairs into qflat (n_out int32, cleared by the
// caller).  words: nw uint32 (nw >= 3); off_lane: 2 * nb int64 lane start
// bits; k_packed: nb bytes (gap k low nibble, value k high); base_pos: nb
// int32 positions preceding each gap block; nnz: one int32 on the device.
int ebcc_rice_unpack_qflat(const uint32_t* words, long long nw,
                           const long long* off_lane, const uint8_t* k_packed,
                           const int32_t* base_pos, const int32_t* nnz, int nb,
                           long long n_out, int32_t* qflat, void* stream) {
  if (nb <= 0 || nw < 3) return (int)cudaErrorInvalidValue;
  const int grid = (nb + kThreads - 1) / kThreads;
  rice_lanes<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      words, nw, off_lane, k_packed, base_pos, nnz, nb, n_out, qflat);
  return launched();
}

}  // extern "C"
