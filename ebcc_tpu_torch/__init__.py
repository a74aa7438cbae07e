"""ebcc_tpu_torch — the PyTorch/CUDA port of the error-bounded climate-data
compressor, for NVIDIA Hopper (H100).

It sits beside ``ebcc_tpu`` (the JAX reference, which it never imports) and
writes and reads the same ETPU streams and ETPK chunked containers (with
region decode; streaming file IO in ``ebcc_tpu_torch.io``; containers coded
over several CUDA devices or ``torch.distributed`` ranks in
``ebcc_tpu_torch.parallel``; the filter spec, the command line
``python -m ebcc_tpu_torch.api.cli``, HDF5 datasets, the HDF5 filter
plugin, xarray datasets and the Zarr codec in ``ebcc_tpu_torch.api``;
``torch.profiler`` traces in ``ebcc_tpu_torch.utils.profiling``), and
reads and writes the reference codec's EBCC/EBCK streams
(``ebcc_tpu_torch.compat``, on the host, as in the JAX package).  It covers every residual mode of
the codec, encode and decode: rate mode (RESIDUAL_NONE, the default), the
error-bounded modes (MAX_ERROR, RELATIVE_ERROR, POINTWISE_RELATIVE_ERROR,
with ``allow_nan``, intra or ``temporal``) and lossless mode.  The wavelet
transforms run as hand-written CUDA kernels (``csrc/dwt97.cu``, built with
``nvcc`` at first use), the rest of the device work as PyTorch.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.

Quick start::

    import numpy as np
    from ebcc_tpu_torch import CodecConfig, RESIDUAL_MAX_ERROR, encode, decode

    data = np.random.rand(1, 721, 1440).astype(np.float32)
    config = CodecConfig(dims=data.shape, base_cr=30,
                         residual_mode=RESIDUAL_MAX_ERROR, error=0.01)
    blob = encode(data, config)           # on the card
    out = decode(blob)                    # max |data - out| <= 0.01
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    BASE_NUM_PLANES,
    RES_NUM_PLANES,
    CodecConfig,
    EncodeOptions,
    RESIDUAL_LOSSLESS,
    RESIDUAL_MAX_ERROR,
    RESIDUAL_NONE,
    RESIDUAL_POINTWISE_RELATIVE_ERROR,
    RESIDUAL_RELATIVE_ERROR,
)
from .convert import config_from_reference, options_from_reference  # noqa: F401
from .core.codec import (  # noqa: F401
    decode,
    decode_chunked,
    decode_chunked_region,
    decode_frames_device,
    encode,
    encode_chunked,
    encode_chunked_compat,
    encode_frames_device,
    roundtrip_frames_device,
)
