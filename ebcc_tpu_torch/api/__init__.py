"""The port's user surfaces: the filter spec (``filter_wrapper``), the
command line (``python -m ebcc_tpu_torch.api.cli``), HDF5 datasets
(``hdf5``), the Zarr codec (``zarr_filter``, imported on its own: it
imports ``numcodecs``) and xarray datasets through the HDF5 filter plugin
(``xarray_io``, imported on its own).  Importing this package imports
neither ``h5py`` nor ``numcodecs``."""

from . import cli, filter_wrapper, hdf5  # noqa: F401
from .filter_wrapper import EBCC_Filter, populate_config  # noqa: F401
