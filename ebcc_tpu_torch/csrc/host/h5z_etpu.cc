/* ebcc_tpu_torch: the port's copy of ebcc_tpu/native/h5z_etpu.cc, unchanged below
 * this line; HDF5 sees the original's filter. */
/* HDF5 filter plugin for the ebcc_tpu ETPU/ETPK bitstream (filter id 33030).
 *
 * Role parity: reference src/h5z_ebcc.c (filter id 308) — registered filter
 * class with encoder+decoder, H5PL discovery entry points, and the
 * cd_values -> config mapping (populate_config, h5z_ebcc.c:38-93):
 *   cd_values = [height, width, float_bits(base_cr), residual_mode,
 *                float_bits(error)?]
 * The leading dim is inferred from the incoming chunk byte count and must
 * divide exactly.  Decode replaces *buf with codec-allocated output.
 */

#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "etpu_codec.h"
#include "h5_minimal.h"

#define H5Z_FILTER_ETPU 33030

namespace {

float bits_to_float(unsigned int u) {
  float f;
  std::memcpy(&f, &u, sizeof(f));
  return f;
}

/* cd_values -> config; returns 0 on error (mirrors populate_config
 * validation; errors report-and-fail instead of exit()). */
int populate_config(etpu_config_t *config, size_t cd_nelmts,
                    const unsigned int cd_values[], size_t nbytes) {
  if (cd_nelmts < 4) {
    std::fprintf(stderr, "[etpu-h5z] need >= 4 cd_values, got %zu\n",
                 cd_nelmts);
    return 0;
  }
  const size_t height = cd_values[0], width = cd_values[1];
  if (height < 32 || width < 32 || height > 2047 || width > 2047) {
    std::fprintf(stderr, "[etpu-h5z] invalid tile %zux%zu\n", height, width);
    return 0;
  }
  const size_t tile = height * width;
  const size_t n_values = nbytes / sizeof(float);
  if (n_values < tile || n_values % tile != 0) {
    std::fprintf(stderr,
                 "[etpu-h5z] buffer %zu not a multiple of tile %zu\n",
                 n_values, tile);
    return 0;
  }
  std::memset(config, 0, sizeof(*config));
  config->dims[0] = n_values / tile;
  config->dims[1] = height;
  config->dims[2] = width;
  config->base_cr = bits_to_float(cd_values[2]);
  config->residual_mode = (int32_t)cd_values[3];
  if (config->residual_mode >= 1 && config->residual_mode <= 3) {
    if (cd_nelmts < 5) {
      std::fprintf(stderr, "[etpu-h5z] error-bounded mode needs 5 values\n");
      return 0;
    }
    config->error = bits_to_float(cd_values[4]);
  } else if (config->residual_mode != 0 && config->residual_mode != 4) {
    std::fprintf(stderr, "[etpu-h5z] invalid residual mode %d\n",
                 config->residual_mode);
    return 0;
  }
  /* Optional flags word after the mode/error values (TPU-build extension,
   * mirrors api/filter_wrapper.py): bit0 = temporal predictive coding,
   * bit1 = allow_nan (mask NaN samples instead of failing).  Modes 0
   * (rate) and 4 (lossless) carry no error value. */
  const int err_modes = (config->residual_mode >= 1 &&
                         config->residual_mode <= 3);
  const size_t nxt = err_modes ? 5 : 4;
  if (cd_nelmts > nxt) {
    const unsigned int fl = cd_values[nxt];
    if ((fl & 0x1u) && err_modes && config->dims[0] > 1)
      config->temporal = 1;
    if (fl & 0x2u) config->allow_nan = 1;
  }
  return 1;
}

size_t filter_etpu(unsigned int flags, size_t cd_nelmts,
                   const unsigned int cd_values[], size_t nbytes,
                   size_t *buf_size, void **buf) {
  if (flags & H5Z_FLAG_REVERSE) {
    float *out = nullptr;
    const size_t n = etpu_decode((const uint8_t *)*buf, nbytes, &out);
    if (!n) {
      etpu_free(out);
      return 0;
    }
    std::free(*buf);
    *buf = out;
    *buf_size = n * sizeof(float);
    return n * sizeof(float);
  }
  etpu_config_t config;
  if (!populate_config(&config, cd_nelmts, cd_values, nbytes)) return 0;
  uint8_t *out = nullptr;
  const size_t n = etpu_encode((const float *)*buf, &config, &out);
  if (!n) {
    etpu_free(out);
    return 0;
  }
  std::free(*buf);
  *buf = out;
  *buf_size = n;
  return n;
}

const H5Z_class2_t kEtpuFilterClass = {
    H5Z_CLASS_T_VERS,
    (H5Z_filter_t)H5Z_FILTER_ETPU,
    1, /* encoder present */
    1, /* decoder present */
    "ebcc_tpu ETPU error-bounded climate compressor",
    nullptr,
    nullptr,
    (H5Z_func_t)filter_etpu,
};

}  // namespace

extern "C" {

H5PL_type_t H5PLget_plugin_type(void) { return H5PL_TYPE_FILTER; }
const void *H5PLget_plugin_info(void) { return &kEtpuFilterClass; }

/* Also exported directly for ctypes consumers (Zarr-style integration,
 * parity with reference zarr_filter.py using populate_config via CDLL). */
int etpu_populate_config(etpu_config_t *config, size_t cd_nelmts,
                         const unsigned int cd_values[], size_t nbytes) {
  return populate_config(config, cd_nelmts, cd_values, nbytes);
}

}  /* extern "C" */
