/* ebcc_tpu_torch: the port's copy of scripts/ref_shim/opj_shim.c, unchanged below
 * this line; compat/reference_bin.py builds it with the reference. */
/* Implementation of the shim openjpeg.h (see that header's preamble): the
 * opj_* call sequence the reference's j2k_encode_internal /
 * j2k_decode_internal perform is replayed against small local structs, and
 * the actual J2K work happens in the registered callbacks.  The reference
 * never checks opj return values, which keeps the contract simple. */

#include "openjpeg.h"

#include <stdlib.h>
#include <string.h>

static ebcc_shim_j2k_encode_fn g_encode = NULL;
static ebcc_shim_j2k_decode_fn g_decode = NULL;

void ebcc_shim_register_j2k(ebcc_shim_j2k_encode_fn enc,
                            ebcc_shim_j2k_decode_fn dec) {
  g_encode = enc;
  g_decode = dec;
}

struct opj_stream {
  int is_input;
  void *user_data;
  uint64_t user_data_length;
  opj_stream_write_fn write_fn;
  opj_stream_read_fn read_fn;
};

struct opj_codec {
  int is_encoder;
  opj_cparameters_t cparams;
  opj_image_t *image;      /* not owned */
  uint16_t *staging;       /* encoder: collected image samples */
  size_t staged_h, staged_w;
};

void opj_set_default_encoder_parameters(opj_cparameters_t *p) {
  memset(p, 0, sizeof(*p));
}
void opj_set_default_decoder_parameters(opj_dparameters_t *p) {
  memset(p, 0, sizeof(*p));
}

static opj_image_t *image_alloc(OPJ_UINT32 numcmpts,
                                opj_image_cmptparm_t *parms, int with_data) {
  if (numcmpts != 1) return NULL; /* reference is single-component */
  opj_image_t *img = (opj_image_t *)calloc(1, sizeof(opj_image_t));
  img->numcomps = 1;
  img->comps = (opj_image_comp_t *)calloc(1, sizeof(opj_image_comp_t));
  img->comps[0].dx = parms->dx;
  img->comps[0].dy = parms->dy;
  img->comps[0].w = parms->w;
  img->comps[0].h = parms->h;
  img->comps[0].x0 = parms->x0;
  img->comps[0].y0 = parms->y0;
  img->comps[0].prec = parms->prec;
  img->comps[0].sgnd = parms->sgnd;
  if (with_data)
    img->comps[0].data =
        (int32_t *)calloc((size_t)parms->w * parms->h, sizeof(int32_t));
  return img;
}

opj_image_t *opj_image_create(OPJ_UINT32 n, opj_image_cmptparm_t *p,
                              OPJ_COLOR_SPACE c) {
  (void)c;
  return image_alloc(n, p, 1);
}
opj_image_t *opj_image_tile_create(OPJ_UINT32 n, opj_image_cmptparm_t *p,
                                   OPJ_COLOR_SPACE c) {
  (void)c;
  return image_alloc(n, p, 0); /* tile data arrives via opj_write_tile */
}
void opj_image_destroy(opj_image_t *image) {
  if (!image) return;
  if (image->comps) free(image->comps[0].data);
  free(image->comps);
  free(image);
}

opj_codec_t *opj_create_compress(OPJ_CODEC_FORMAT f) {
  (void)f;
  opj_codec_t *c = (opj_codec_t *)calloc(1, sizeof(*c));
  c->is_encoder = 1;
  return c;
}
opj_codec_t *opj_create_decompress(OPJ_CODEC_FORMAT f) {
  (void)f;
  return (opj_codec_t *)calloc(1, sizeof(struct opj_codec));
}
void opj_destroy_codec(opj_codec_t *codec) {
  if (codec) free(codec->staging);
  free(codec);
}

OPJ_BOOL opj_setup_encoder(opj_codec_t *codec, opj_cparameters_t *params,
                           opj_image_t *image) {
  codec->cparams = *params;
  codec->image = image;
  return OPJ_TRUE;
}
OPJ_BOOL opj_setup_decoder(opj_codec_t *codec, opj_dparameters_t *params) {
  (void)codec;
  (void)params;
  return OPJ_TRUE;
}

opj_stream_t *opj_stream_default_create(OPJ_BOOL is_input) {
  opj_stream_t *s = (opj_stream_t *)calloc(1, sizeof(*s));
  s->is_input = is_input;
  return s;
}
void opj_stream_destroy(opj_stream_t *s) { free(s); }
void opj_stream_set_user_data(opj_stream_t *s, void *d, void (*f)(void *)) {
  (void)f;
  s->user_data = d;
}
void opj_stream_set_user_data_length(opj_stream_t *s, uint64_t n) {
  s->user_data_length = n;
}
void opj_stream_set_write_function(opj_stream_t *s, opj_stream_write_fn fn) {
  s->write_fn = fn;
}
void opj_stream_set_read_function(opj_stream_t *s, opj_stream_read_fn fn) {
  s->read_fn = fn;
}

OPJ_BOOL opj_start_compress(opj_codec_t *codec, opj_image_t *image,
                            opj_stream_t *stream) {
  (void)stream;
  codec->image = image;
  codec->staged_w = image->x1 - image->x0;
  codec->staged_h = image->y1 - image->y0;
  free(codec->staging);
  codec->staging = (uint16_t *)calloc(codec->staged_h * codec->staged_w,
                                      sizeof(uint16_t));
  return codec->staging != NULL;
}

OPJ_BOOL opj_write_tile(opj_codec_t *codec, OPJ_UINT32 tile_index,
                        OPJ_BYTE *data, OPJ_UINT32 data_size,
                        opj_stream_t *stream) {
  (void)stream;
  /* one tile per frame, cp_tdy rows each (reference ebcc_codec.c:121-125,
   * 167-171); payload is the frame's raw uint16 samples */
  const size_t rows = (size_t)codec->cparams.cp_tdy;
  const size_t off = (size_t)tile_index * rows * codec->staged_w;
  if (data_size != rows * codec->staged_w * sizeof(uint16_t)) return OPJ_FALSE;
  if (off + rows * codec->staged_w > codec->staged_h * codec->staged_w)
    return OPJ_FALSE;
  memcpy(codec->staging + off, data, data_size);
  return OPJ_TRUE;
}

OPJ_BOOL opj_encode(opj_codec_t *codec, opj_stream_t *stream) {
  (void)stream;
  /* single-image path: samples live in image->comps[0].data */
  const size_t n = codec->staged_h * codec->staged_w;
  for (size_t i = 0; i < n; ++i)
    codec->staging[i] = (uint16_t)codec->image->comps[0].data[i];
  return OPJ_TRUE;
}

OPJ_BOOL opj_end_compress(opj_codec_t *codec, opj_stream_t *stream) {
  if (!g_encode || !stream->write_fn || !codec->staging) return OPJ_FALSE;
  const size_t h = codec->staged_h, w = codec->staged_w;
  const size_t tile_rows =
      codec->cparams.tile_size_on ? (size_t)codec->cparams.cp_tdy : h;
  const size_t cap = h * w * 2 + 65536;
  uint8_t *buf = (uint8_t *)malloc(cap);
  if (!buf) return OPJ_FALSE;
  const size_t produced = g_encode(codec->staging, h, w, tile_rows,
                                   codec->cparams.tcp_rates[0], buf, cap);
  if (produced == 0 || produced > cap) {
    free(buf);
    return OPJ_FALSE;
  }
  stream->write_fn(buf, produced, stream->user_data);
  free(buf);
  return OPJ_TRUE;
}

OPJ_BOOL opj_read_header(opj_stream_t *stream, opj_codec_t *codec,
                         opj_image_t **image) {
  (void)stream;
  opj_image_cmptparm_t parm;
  memset(&parm, 0, sizeof(parm));
  parm.dx = parm.dy = 1;
  parm.prec = 16;
  *image = image_alloc(1, &parm, 0);
  codec->image = *image;
  return *image != NULL;
}

OPJ_BOOL opj_decode(opj_codec_t *codec, opj_stream_t *stream,
                    opj_image_t *image) {
  (void)codec;
  if (!g_decode || !stream->read_fn) return OPJ_FALSE;
  /* drain the whole codestream through the registered read function (the
   * reference's buffer stream reports total length via user_data_length) */
  size_t cap = stream->user_data_length
                   ? (size_t)stream->user_data_length
                   : (size_t)1 << 20;
  uint8_t *blob = (uint8_t *)malloc(cap);
  if (!blob) return OPJ_FALSE;
  size_t n = 0;
  for (;;) {
    if (n == cap) {
      cap *= 2;
      uint8_t *nb = (uint8_t *)realloc(blob, cap);
      if (!nb) {
        free(blob);
        return OPJ_FALSE;
      }
      blob = nb;
    }
    OPJ_SIZE_T got = stream->read_fn(blob + n, cap - n, stream->user_data);
    if (got == (OPJ_SIZE_T)-1 || got == 0) break;
    n += got;
  }
  /* worst-case sample count bound: J2K >= ~1 byte per 8 samples here */
  size_t sample_cap = (size_t)2048 * 2048 * 8;
  int32_t *out = (int32_t *)malloc(sample_cap * sizeof(int32_t));
  if (!out) {
    free(blob);
    return OPJ_FALSE;
  }
  uint32_t oh = 0, ow = 0;
  const int ok = g_decode(blob, n, out, sample_cap, &oh, &ow);
  free(blob);
  if (!ok || (size_t)oh * ow > sample_cap) {
    free(out);
    return OPJ_FALSE;
  }
  free(image->comps[0].data);
  image->comps[0].data =
      (int32_t *)malloc((size_t)oh * ow * sizeof(int32_t));
  memcpy(image->comps[0].data, out, (size_t)oh * ow * sizeof(int32_t));
  free(out);
  image->x0 = image->y0 = 0;
  image->x1 = ow;
  image->y1 = oh;
  image->comps[0].w = ow;
  image->comps[0].h = oh;
  return OPJ_TRUE;
}

OPJ_BOOL opj_end_decompress(opj_codec_t *codec, opj_stream_t *stream) {
  (void)codec;
  (void)stream;
  return OPJ_TRUE;
}
