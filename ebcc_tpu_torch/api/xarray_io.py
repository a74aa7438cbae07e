"""xarray convenience layer: compress/open climate datasets (the PyTorch
port's copy of ``ebcc_tpu/api/xarray_io.py``, wired to the port's HDF5
filter plugin, :func:`ebcc_tpu_torch.native.plugin_dir`).

Role parity: the reference depends on xarray for its climate-tooling story
(reference pyproject.toml:24-28) and its benchmark scripts follow the
pattern open-with-xarray -> write-through-h5py+filter -> reopen (reference
tests/benchmarks/compress_ebcc.py:12-42).  This module packages that
pattern as an API:

    import xarray as xr, ebcc_tpu_torch.api.xarray_io as exr
    exr.compress_dataset(ds, "out.nc", error=0.5)      # every float var
    ds2 = exr.open_compressed("out.nc")                # plugin path wired

Files are netCDF-4-flavoured HDF5 (dimension scales attached), so stock
xarray/netCDF4/h5netcdf readers work once HDF5_PLUGIN_PATH includes the
plugin directory — :func:`open_compressed` sets that up automatically.
The JAX package's plugin has the same filter id (33030), so a process
should name only one package's plugin directory.

xarray and h5py are optional; every entry point raises a clear ImportError
when they are missing.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .filter_wrapper import EBCC_Filter


def _require(modname):
    try:
        return __import__(modname)
    except ImportError as e:
        raise ImportError(
            f"ebcc_tpu_torch.api.xarray_io needs {modname!r}; install the "
            f"[hdf5] extra and xarray") from e


def _plugin_dir() -> Optional[str]:
    from .. import native as native_mod

    try:
        return native_mod.plugin_dir()
    except RuntimeError:
        return None


def _residual_opt(error: Optional[float], relative_error: Optional[float],
                  pointwise_relative_error: Optional[float] = None,
                  lossless: bool = False) -> Tuple[str, float]:
    given = [v for v in (error, relative_error, pointwise_relative_error)
             if v is not None] + ([0] if lossless else [])
    if len(given) != 1:
        raise ValueError(
            "pass exactly one of error= (absolute bound), relative_error= "
            "(fraction of the value range), pointwise_relative_error= "
            "(fraction of each value; strictly positive data), or "
            "lossless=True (bit-exact)")
    if lossless:
        return ("lossless", 0)
    if error is not None:
        return ("max_error_target", float(error))
    if relative_error is not None:
        return ("relative_error_target", float(relative_error))
    return ("pointwise_relative_error_target",
            float(pointwise_relative_error))


def compress_dataarray(da, path: str, name: Optional[str] = None, *,
                       base_cr: float = 30.0,
                       error: Optional[float] = None,
                       relative_error: Optional[float] = None,
                       pointwise_relative_error: Optional[float] = None,
                       lossless: bool = False,
                       allow_nan: bool = False,
                       temporal_chunk: int = 0,
                       mode: str = "w") -> None:
    """Write one DataArray to ``path`` through the ETPU HDF5 filter.

    The trailing two dims are the spatial (height, width) plane — the same
    contract as the filter itself; leading dims become frames.  Coordinates
    become dimension-scale datasets so netCDF readers see a normal file.
    ``allow_nan`` masks NaN samples (xarray's usual missing-value encoding)
    instead of failing; ``temporal_chunk`` > 1 groups that many leading-dim
    frames per chunk with closed-loop temporal prediction.
    """
    _require("xarray")
    h5py = _require("h5py")

    data = np.asarray(da.data, np.float32)
    if data.ndim < 2:
        raise ValueError("DataArray must be at least 2-D (got %dD)"
                         % data.ndim)
    var = name or da.name or "data"
    filt = EBCC_Filter(base_cr=base_cr, height=data.shape[-2],
                       width=data.shape[-1],
                       residual_opt=_residual_opt(error, relative_error,
                                                  pointwise_relative_error,
                                                  lossless),
                       data_dim=data.ndim, allow_nan=allow_nan,
                       temporal_chunk=temporal_chunk)
    pdir = _plugin_dir()
    if pdir:
        h5py.h5pl.append(pdir.encode())
    with h5py.File(path, mode) as f:
        d = f.create_dataset(var, shape=data.shape, **filt)
        d[...] = data
        for axis, dim in enumerate(da.dims):
            if dim in da.coords and dim not in f:
                c = f.create_dataset(dim, data=np.asarray(da.coords[dim]))
                c.make_scale(dim)
            if dim in f:
                d.dims[axis].attach_scale(f[dim])
        for k, v in da.attrs.items():
            try:
                d.attrs[k] = v
            except TypeError:
                d.attrs[k] = str(v)


def compress_dataset(ds, path: str, *,
                     variables: Optional[Sequence[str]] = None,
                     base_cr: float = 30.0,
                     error: Optional[float] = None,
                     relative_error: Optional[float] = None,
                     pointwise_relative_error: Optional[float] = None,
                     lossless: bool = False,
                     allow_nan: bool = False,
                     temporal_chunk: int = 0) -> None:
    """Write every (selected) >=2-D float variable of an xarray Dataset
    through the filter; other variables are stored uncompressed."""
    _require("xarray")
    h5py = _require("h5py")

    if variables is None:
        variables = [v for v in ds.data_vars
                     if ds[v].ndim >= 2 and
                     np.issubdtype(ds[v].dtype, np.floating)]
    first = True
    for v in variables:
        compress_dataarray(ds[v], path, v, base_cr=base_cr, error=error,
                           relative_error=relative_error,
                           pointwise_relative_error=pointwise_relative_error,
                           lossless=lossless,
                           allow_nan=allow_nan,
                           temporal_chunk=temporal_chunk,
                           mode="w" if first else "a")
        first = False
    with h5py.File(path, "a" if not first else "w") as f:
        for v in ds.data_vars:
            if v not in variables and v not in f:
                f.create_dataset(v, data=np.asarray(ds[v]))
        for k, val in ds.attrs.items():
            try:
                f.attrs[k] = val
            except TypeError:
                f.attrs[k] = str(val)


def open_compressed(path: str, **kwargs):
    """Open a filter-compressed file as an xarray Dataset (h5netcdf or
    netcdf4 engine), with HDF5_PLUGIN_PATH wired to the built plugin."""
    xarray = _require("xarray")

    pdir = _plugin_dir()
    if pdir:
        existing = os.environ.get("HDF5_PLUGIN_PATH", "")
        if pdir not in existing.split(os.pathsep):
            os.environ["HDF5_PLUGIN_PATH"] = (
                pdir + (os.pathsep + existing if existing else ""))
    last = None
    for engine in ("h5netcdf", "netcdf4"):
        try:
            return xarray.open_dataset(path, engine=engine, **kwargs)
        except (ImportError, ValueError) as e:
            last = e
    raise last
