/* The slice of libzstd's public API that the host codec calls
 * (etpu_codec.cc: zstd_pack, zstd_unpack and the partial-plane size check),
 * declared here from zstd.h's documented stable interface (zstd >= 1.4), on
 * the pattern of ebcc_tpu/native/h5_minimal.h.  The codec then builds on a
 * machine that has the runtime library libzstd.so.1 but no zstd.h, and
 * links it as -l:libzstd.so.1 (ops/_build.py).
 */
#ifndef ETPU_ZSTD_DECLS_H
#define ETPU_ZSTD_DECLS_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct ZSTD_CCtx_s ZSTD_CCtx;

typedef enum {
  ZSTD_c_compressionLevel = 100,
  ZSTD_c_checksumFlag = 201
} ZSTD_cParameter;

#define ZSTD_CONTENTSIZE_UNKNOWN (0ULL - 1)
#define ZSTD_CONTENTSIZE_ERROR (0ULL - 2)

ZSTD_CCtx *ZSTD_createCCtx(void);
size_t ZSTD_freeCCtx(ZSTD_CCtx *cctx);
size_t ZSTD_CCtx_setParameter(ZSTD_CCtx *cctx, ZSTD_cParameter param,
                              int value);
size_t ZSTD_compressBound(size_t srcSize);
size_t ZSTD_compress2(ZSTD_CCtx *cctx, void *dst, size_t dstCapacity,
                      const void *src, size_t srcSize);
unsigned ZSTD_isError(size_t code);
unsigned long long ZSTD_getFrameContentSize(const void *src,
                                            size_t srcSize);
size_t ZSTD_decompress(void *dst, size_t dstCapacity, const void *src,
                       size_t compressedSize);

#ifdef __cplusplus
}
#endif

#endif /* ETPU_ZSTD_DECLS_H */
