"""HDF5 datasets holding ETPK containers.

The port's counterpart of ``ebcc_tpu/api/hdf5.py`` route 1: the container
is stored as an opaque uint8 dataset with its shape and format in
attributes, readable with stock ``h5py`` and no plugin.  The attribute
prefix stays ``ebcc_tpu``, so a dataset written by either package loads
with the other.  Route 2 of the JAX module, the native HDF5 filter
plugin (filter id 33030: datasets chunked as frames, compressed by HDF5
itself), is the port's ``libebcc_h5filter.so`` in the directory
:func:`ebcc_tpu_torch.native.plugin_dir` returns; name it in
``HDF5_PLUGIN_PATH`` (and the JAX package's plugin directory not), and
give ``h5py`` the filter of :class:`~.filter_wrapper.EBCC_Filter`.
:mod:`.xarray_io` wires it up.  ``h5py`` is imported by the caller's
``group``; this module imports nothing of it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import CodecConfig, EncodeOptions
from ..core import codec as _codec

_ATTR_PREFIX = "ebcc_tpu"


def save_dataset(group, name: str, data: np.ndarray, config: CodecConfig,
                 opts: Optional[EncodeOptions] = None, device="cuda"):
    """Compress ``data`` on ``device`` (the card unless ``device="cpu"``)
    and store the container as dataset ``name`` of the h5py ``group``,
    with its format, shape and dims in attributes."""
    data = np.asarray(data, dtype=np.float32)
    blob = _codec.encode_chunked(data.reshape(config.dims), config, opts,
                                 device=device)
    dset = group.create_dataset(
        name, data=np.frombuffer(blob, dtype=np.uint8))
    dset.attrs[f"{_ATTR_PREFIX}:format"] = "ETPK"
    dset.attrs[f"{_ATTR_PREFIX}:shape"] = data.shape
    dset.attrs[f"{_ATTR_PREFIX}:dims"] = config.dims
    return dset


def load_dataset(group, name: str, device="cuda") -> np.ndarray:
    """Decompress dataset ``name`` of ``group`` (written by either
    package's ``save_dataset``) on ``device`` (the card unless
    ``device="cpu"``)."""
    dset = group[name]
    fmt = dset.attrs.get(f"{_ATTR_PREFIX}:format")
    if fmt not in ("ETPK", b"ETPK"):
        raise ValueError(f"dataset {name!r} is not an ebcc_tpu payload")
    blob = bytes(np.asarray(dset[...], dtype=np.uint8))
    out = _codec.decode_chunked(blob, device=device)
    shape = tuple(dset.attrs[f"{_ATTR_PREFIX}:shape"])
    return out.reshape(shape)
