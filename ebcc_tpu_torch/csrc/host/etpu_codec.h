/* ebcc_tpu_torch: the port's copy of ebcc_tpu/native/etpu_codec.h, unchanged below
 * this line; CAB bytes and stream bytes must stay the original's. */
/* ebcc_tpu native codec: portable C++ implementation of the ETPU/ETPK
 * bitstream (see ebcc_tpu/core/stream.py for the format definition).
 *
 * Role parity: the reference ships its codec as a C library consumed by an
 * HDF5 filter plugin, Zarr via ctypes, and CDO (reference src/ebcc_codec.h
 * API: ebcc_encode/ebcc_decode/ebcc_encode_chunking/ebcc_decode_chunking/
 * free_buffer).  This library provides the same integration surface for the
 * TPU build's format: storage-stack consumers (h5py/netCDF/CDO through the
 * filter plugin, or direct linking) can encode and decode ETPU streams with
 * zero Python/JAX dependency.  The TPU path remains the high-throughput
 * encoder; this native path trades speed for universal embeddability, like
 * the reference codec itself (serial, per-chunk).
 *
 * Numerical note: the inverse DWT here follows the exact op order of
 * ebcc_tpu/ops/dwt.py in float32; cross-implementation differences are at
 * the ulp level (documented decoder-parity tolerance: 1e-5 of the data
 * range).
 */
#ifndef ETPU_CODEC_H
#define ETPU_CODEC_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
  uint64_t dims[3];       /* (n_frames/leading, height, width) */
  float base_cr;          /* rate target for residual_mode == 0 */
  int32_t residual_mode;  /* 0 NONE, 1 MAX_ERROR, 2 RELATIVE_ERROR */
  float error;            /* bound for modes 1/2 */
  uint64_t chunk_dims[3]; /* zeros => whole array as one chunk */
  int32_t zstd_level;     /* <=0 => default */
  int32_t entropy_backend; /* 0/1 zstd, 2 CAB arithmetic, 3 auto (best-of) */
  int32_t temporal;       /* !=0: closed-loop predictive coding along the
                             chunk's leading axis (error-bounded modes,
                             multi-frame chunks only; see docs/FORMAT.md) */
  int32_t allow_nan;      /* !=0: NaN samples are masked out of the encode
                             (per-frame mean fill + mask section) and
                             restored on decode; bound applies to valid
                             samples.  Inf still errors. */
} etpu_config_t;

/* Decode one ETPU frame stream (or dispatch an ETPK container).
 * Returns number of floats written to *out (malloc'd; free with etpu_free),
 * 0 on error. */
size_t etpu_decode(const uint8_t *data, size_t size, float **out);

/* Decode an ETPK container (or dispatch a plain ETPU stream). */
size_t etpu_decode_chunked(const uint8_t *data, size_t size, float **out);

/* Encode one array (single chunk) -> ETPU stream.  Returns byte size of
 * *out (malloc'd), 0 on error. */
size_t etpu_encode(const float *data, const etpu_config_t *config,
                   uint8_t **out);

/* Chunked encode -> ETPK container (serial per-chunk loop, parity with
 * reference ebcc_encode_chunking). */
size_t etpu_encode_chunked(const float *data, const etpu_config_t *config,
                           uint8_t **out);

void etpu_free(void *ptr);

const char *etpu_version(void);

#ifdef __cplusplus
}
#endif

#endif /* ETPU_CODEC_H */
