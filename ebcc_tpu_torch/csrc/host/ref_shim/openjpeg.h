/* ebcc_tpu_torch: the port's copy of scripts/ref_shim/openjpeg.h, unchanged below
 * this line; compat/reference_bin.py builds it with the reference. */
/* Shim openjpeg.h for building the REFERENCE EBCC codec in this image.
 *
 * The reference vendors OpenJPEG as a git submodule that is empty in this
 * environment, and no OpenJPEG development headers exist on the system (only
 * the runtime .so Pillow links).  This header — entirely our own code —
 * declares just the opj_* surface the reference's two J2K wrapper functions
 * use (reference src/ebcc_codec.c:105-180, 1092-1136), and opj_shim.c routes
 * the actual J2K encode/decode through callbacks the test harness registers
 * (ebcc_shim_register_j2k), which the Python side implements with
 * Pillow/OpenJPEG — the SAME libopenjp2 the reference would link, driven
 * with the same parameters (raw J2K codestream, 16-bit grayscale,
 * irreversible CDF 9/7, rate = base_cr/2, one tile per frame).
 *
 * Everything else in the reference build (SPIHT coder, DWT, bit I/O, codec
 * orchestration, searches, serialization, zstd level 22) is the reference's
 * own unmodified C, so cross-validation against this binary exercises the
 * reference's real stream format and algorithms.
 */
#ifndef EBCC_SHIM_OPENJPEG_H
#define EBCC_SHIM_OPENJPEG_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int OPJ_BOOL;
#define OPJ_TRUE 1
#define OPJ_FALSE 0
typedef uint8_t OPJ_BYTE;
typedef uint32_t OPJ_UINT32;
typedef size_t OPJ_SIZE_T;

typedef enum { OPJ_CODEC_J2K = 0 } OPJ_CODEC_FORMAT;
typedef enum { OPJ_CLRSPC_GRAY = 2 } OPJ_COLOR_SPACE;

/* Only the fields the reference touches (ebcc_codec.c:110-125); layout is
 * OURS, not OpenJPEG ABI — the shim is the only consumer. */
typedef struct {
  int tcp_numlayers;
  int cp_disto_alloc;
  float tcp_rates[100];
  int irreversible;
  int cp_tx0, cp_ty0;
  OPJ_BOOL tile_size_on;
  int cp_tdx, cp_tdy;
} opj_cparameters_t;

typedef struct {
  int decod_format;
  int cp_layer;
  int cp_reduce;
} opj_dparameters_t;

typedef struct {
  OPJ_UINT32 dx, dy, w, h, x0, y0, prec, sgnd;
} opj_image_cmptparm_t;

typedef struct {
  OPJ_UINT32 dx, dy, w, h, x0, y0, prec, sgnd;
  int32_t *data;
} opj_image_comp_t;

typedef struct {
  OPJ_UINT32 x0, y0, x1, y1, numcomps;
  opj_image_comp_t *comps;
} opj_image_t;

typedef struct opj_codec opj_codec_t;
typedef struct opj_stream opj_stream_t;
typedef OPJ_SIZE_T (*opj_stream_write_fn)(void *, OPJ_SIZE_T, void *);
typedef OPJ_SIZE_T (*opj_stream_read_fn)(void *, OPJ_SIZE_T, void *);

void opj_set_default_encoder_parameters(opj_cparameters_t *p);
void opj_set_default_decoder_parameters(opj_dparameters_t *p);

opj_image_t *opj_image_create(OPJ_UINT32 numcmpts,
                              opj_image_cmptparm_t *cmptparms,
                              OPJ_COLOR_SPACE clrspc);
opj_image_t *opj_image_tile_create(OPJ_UINT32 numcmpts,
                                   opj_image_cmptparm_t *cmptparms,
                                   OPJ_COLOR_SPACE clrspc);
void opj_image_destroy(opj_image_t *image);

opj_codec_t *opj_create_compress(OPJ_CODEC_FORMAT format);
opj_codec_t *opj_create_decompress(OPJ_CODEC_FORMAT format);
void opj_destroy_codec(opj_codec_t *codec);

OPJ_BOOL opj_setup_encoder(opj_codec_t *codec, opj_cparameters_t *params,
                           opj_image_t *image);
OPJ_BOOL opj_setup_decoder(opj_codec_t *codec, opj_dparameters_t *params);

opj_stream_t *opj_stream_default_create(OPJ_BOOL is_input);
void opj_stream_destroy(opj_stream_t *stream);
void opj_stream_set_user_data(opj_stream_t *stream, void *data,
                              void (*free_fn)(void *));
void opj_stream_set_user_data_length(opj_stream_t *stream,
                                     uint64_t data_length);
void opj_stream_set_write_function(opj_stream_t *stream,
                                   opj_stream_write_fn fn);
void opj_stream_set_read_function(opj_stream_t *stream,
                                  opj_stream_read_fn fn);

OPJ_BOOL opj_start_compress(opj_codec_t *codec, opj_image_t *image,
                            opj_stream_t *stream);
OPJ_BOOL opj_write_tile(opj_codec_t *codec, OPJ_UINT32 tile_index,
                        OPJ_BYTE *data, OPJ_UINT32 data_size,
                        opj_stream_t *stream);
OPJ_BOOL opj_encode(opj_codec_t *codec, opj_stream_t *stream);
OPJ_BOOL opj_end_compress(opj_codec_t *codec, opj_stream_t *stream);

OPJ_BOOL opj_read_header(opj_stream_t *stream, opj_codec_t *codec,
                         opj_image_t **image);
OPJ_BOOL opj_decode(opj_codec_t *codec, opj_stream_t *stream,
                    opj_image_t *image);
OPJ_BOOL opj_end_decompress(opj_codec_t *codec, opj_stream_t *stream);

/* ---- shim registration (the Python A/B harness provides these) ---- */

/* -> bytes written to out (0 = failure); rate is tcp_rates[0] verbatim. */
typedef size_t (*ebcc_shim_j2k_encode_fn)(const uint16_t *img, size_t h,
                                          size_t w, size_t tile_rows,
                                          float rate, uint8_t *out,
                                          size_t out_cap);
/* -> 1 on success; fills out (row-major, <= cap int32 samples) + oh/ow. */
typedef int (*ebcc_shim_j2k_decode_fn)(const uint8_t *blob, size_t nbytes,
                                       int32_t *out, size_t cap,
                                       uint32_t *oh, uint32_t *ow);

void ebcc_shim_register_j2k(ebcc_shim_j2k_encode_fn enc,
                            ebcc_shim_j2k_decode_fn dec);

#ifdef __cplusplus
}
#endif
#endif /* EBCC_SHIM_OPENJPEG_H */
