/* ebcc_tpu_torch: the port's copy of ebcc_tpu/native/h5_minimal.h, unchanged below
 * this line; HDF5 sees the original's filter. */
/* Minimal HDF5 filter-plugin ABI declarations.
 *
 * An HDF5 filter plugin needs only a tiny, stable slice of the HDF5 public
 * ABI (H5Z_class2_t + the two plugin discovery entry points), so — like the
 * reference, which builds its plugin against a small extracted stub instead
 * of linking HDF5 (reference src/hdf5_stub.h:4-5) — we declare that slice
 * here from the documented public interface (HDF5 1.10+; hid_t is int64
 * since 1.10).  The plugin has zero link-time HDF5 dependency; the hosting
 * application (h5py/netCDF/CDO) provides the library at runtime.
 */
#ifndef ETPU_H5_MINIMAL_H
#define ETPU_H5_MINIMAL_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int herr_t;
typedef int htri_t;
typedef int64_t hid_t;
typedef int H5Z_filter_t;

#define H5Z_CLASS_T_VERS 1
#define H5Z_FLAG_REVERSE 0x0100u

typedef htri_t (*H5Z_can_apply_func_t)(hid_t dcpl_id, hid_t type_id,
                                       hid_t space_id);
typedef herr_t (*H5Z_set_local_func_t)(hid_t dcpl_id, hid_t type_id,
                                       hid_t space_id);
typedef size_t (*H5Z_func_t)(unsigned int flags, size_t cd_nelmts,
                             const unsigned int cd_values[], size_t nbytes,
                             size_t *buf_size, void **buf);

typedef struct H5Z_class2_t {
  int version;
  H5Z_filter_t id;
  unsigned encoder_present;
  unsigned decoder_present;
  const char *name;
  H5Z_can_apply_func_t can_apply;
  H5Z_set_local_func_t set_local;
  H5Z_func_t filter;
} H5Z_class2_t;

typedef enum H5PL_type_t {
  H5PL_TYPE_ERROR = -1,
  H5PL_TYPE_FILTER = 0,
  H5PL_TYPE_NONE = 1
} H5PL_type_t;

#ifdef __cplusplus
}
#endif

#endif /* ETPU_H5_MINIMAL_H */
