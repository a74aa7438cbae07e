"""zstd without the ``zstandard`` module: the port's ``ctypes`` binding of
``libzstd.so.1`` (``ebcc_tpu_torch.core.entropy``) and the host codec built
from the port's declarations header (``csrc/host/zstd_decls.h``), on the
CPU.

The card's machine has ``libzstd.so.1`` but neither ``zstandard`` nor
``zstd.h``.  Setting ``entropy._zstd`` to None here takes the path it
takes there:

* frames round-trip through the binding at the levels the codec and the
  legacy layer use, cross-decode with ``zstandard``, and a corrupt frame
  raises ``ValueError``;
* the port's streams then carry backend 1 (ZSTD), stay byte-identical
  across batch partitionings, and a lossless stream's size is within 1% of
  the JAX package's (the MAX_ERROR streams against the JAX package's are
  in ``test_torch_codec.py``, whose module fixture holds the JAX package's
  encodes);
* ``libebcc_native_codec.so`` builds without ``zstd.h`` and its decode of
  a port stream agrees with the port's decode.

Every port call passes ``device="cpu"``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import zstandard

import ebcc_tpu
from ebcc_tpu.core.kernels import DECODER_EPS_REL

import ebcc_tpu_torch as et
from ebcc_tpu_torch import native as tnative
from ebcc_tpu_torch.core import entropy as tentropy
from ebcc_tpu_torch.core import stream as tstream
from ebcc_tpu_torch.ops import _build

torch.set_num_threads(2)


@pytest.fixture
def libzstd(monkeypatch):
    """The port's zstd as on the card's machine: ``libzstd.so.1`` through
    ``ctypes``, ``zstandard`` hidden."""
    assert tentropy._libzstd is not None, "libzstd.so.1 not loadable"
    monkeypatch.setattr(tentropy, "_zstd", None)
    return tentropy


def _payload(kind, n=1 << 16, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "sparse":
        return ((rng.random(n) < 0.05) * rng.integers(1, 255, n)).astype(
            np.uint8).tobytes()
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return b""


def _frames(dims, seed=0):
    n, h, w = dims
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = 260 + 25 * np.sin(yy / h * np.pi) * np.cos(xx / w * 6.28)
    return np.stack([f + 0.1 * k + 0.3 * rng.normal(size=(h, w))
                     for k in range(n)]).astype(np.float32)


@pytest.mark.parametrize("level", [3, 22])
@pytest.mark.parametrize("kind", ["sparse", "random", "empty"])
def test_ctypes_roundtrip(libzstd, kind, level):
    data = _payload(kind)
    comp = libzstd.compress(data, libzstd.BACKEND_ZSTD, level)
    assert libzstd.default_backend() == libzstd.BACKEND_ZSTD
    assert libzstd.zstd_binding().startswith("libzstd.so.1 ")
    assert libzstd.decompress(comp, libzstd.BACKEND_ZSTD, len(data)) == data
    # One frame format: each binding reads the other's frames.
    assert zstandard.ZstdDecompressor().decompress(comp) == data
    other = zstandard.ZstdCompressor(level=level,
                                     write_checksum=True).compress(data)
    assert libzstd.decompress(other, libzstd.BACKEND_ZSTD, len(data)) == data
    if kind == "sparse":
        # A frame without a checksum, as the legacy layer writes it.
        bare = libzstd.zstd_compress(data, level, checksum=False)
        assert len(bare) == len(comp) - 4
        assert libzstd.zstd_decompress(bare, len(data)) == data


@pytest.mark.parametrize("corrupt", ["flip", "truncate", "garbage",
                                     "too_large"])
def test_ctypes_corrupt_frame_raises(libzstd, corrupt):
    data = _payload("sparse")
    comp = bytearray(libzstd.compress(data, libzstd.BACKEND_ZSTD, 3))
    size = len(data)
    if corrupt == "flip":
        comp[len(comp) // 2] ^= 0x5A
    elif corrupt == "truncate":
        comp = comp[:-7]
    elif corrupt == "garbage":
        comp = bytearray(b"not a zstd frame" * 4)
    else:
        size -= 1       # the frame holds more than the stream says
    with pytest.raises(ValueError, match="corrupt entropy payload"):
        libzstd.decompress(bytes(comp), libzstd.BACKEND_ZSTD, size)


def test_ctypes_streams_independent_of_partitioning(libzstd):
    x = _frames((4, 64, 96))
    cfg = et.CodecConfig(dims=x.shape, base_cr=30, chunk_dims=(1, 64, 96),
                         residual_mode=et.RESIDUAL_MAX_ERROR, error=0.1,
                         zstd_level=3)
    t = torch.from_numpy(x[:, None])
    runs = [et.encode_frames_device(t, cfg, max_batch=mb)
            for mb in (1, 3, None)]
    assert runs[0] == runs[1] == runs[2]
    for s, f in zip(runs[0], x):
        assert tstream.split_frame_stream(s)[0].entropy == 1
        assert np.abs(et.decode(s, device="cpu")[0] - f).max() <= 0.1


def test_ctypes_lossless_matches_reference(libzstd):
    """Lossless mode codes its residual planes with zstd on the host in
    both packages (no JAX compile): the port's stream through ``libzstd``
    decodes bit for bit in the JAX package, and its size is within 1% of
    the JAX package's through ``zstandard``."""
    x = _frames((2, 64, 96))
    ref = ebcc_tpu.CodecConfig(dims=x.shape,
                               residual_mode=ebcc_tpu.RESIDUAL_LOSSLESS,
                               zstd_level=3)
    s_jax = ebcc_tpu.encode(x, ref)
    s = et.encode(x, et.config_from_reference(dataclasses.asdict(ref)),
                  device="cpu")
    np.testing.assert_array_equal(ebcc_tpu.decode(s).view(np.uint32),
                                  x.view(np.uint32))
    assert abs(len(s) - len(s_jax)) <= 0.01 * len(s_jax)


def test_native_codec_builds_from_declarations():
    """The host codec includes the port's declarations, never ``zstd.h``,
    and links the runtime library: the build the card's machine makes.
    Its decode of a port stream agrees with the port's own decode."""
    srcs, headers, libs = _build.HOST_LIBS["ebcc_native_codec"]
    assert "zstd_decls.h" in headers and libs == ["-l:libzstd.so.1"]
    with open(f"{_build.HOST_SRC}/etpu_codec.cc") as f:
        text = f.read()
    assert "#include <zstd.h>" not in text
    assert '#include "zstd_decls.h"' in text
    x = _frames((1, 64, 96))
    cfg = et.CodecConfig(dims=x.shape, base_cr=30,
                         residual_mode=et.RESIDUAL_MAX_ERROR, error=0.1,
                         zstd_level=3)
    s = et.encode(x, cfg, device="cpu")
    native = tnative.native_decode(s).reshape(x.shape)
    ours = et.decode(s, device="cpu")
    rng = float(x.max() - x.min())
    assert np.abs(native - ours).max() <= DECODER_EPS_REL * rng
    assert np.abs(native - x).max() <= 0.1
