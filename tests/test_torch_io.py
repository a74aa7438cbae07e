"""The port's streaming file IO (``ebcc_tpu_torch.io``) against its
container encode and the JAX package's IO, on the CPU.

``compress_stream`` from an ``np.memmap`` writes the bytes of
``encode_chunked`` (MAX_ERROR, POINTWISE_RELATIVE with ``allow_nan``, whose
log check runs per slab, and lossless); ``decompress_stream`` reads them
back.  Appending frames to a chunk-aligned container, in memory or in place
in a file, gives the bytes of one encode of all the frames; a killed append
leaves trailing bytes that readers refuse and ``repair_chunked_file``
removes; a failed write restores the old file.  ``compress_hdf5`` writes the
container of the dataset.  The JAX package reads every file the port
writes.  Every port call passes ``device="cpu"``.
"""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

import ebcc_tpu
from ebcc_tpu.io import pipeline as jpipeline

import ebcc_tpu_torch as et
from ebcc_tpu_torch import io as tio
from ebcc_tpu_torch.core import stream as tstream

torch.set_num_threads(2)

DIMS = (6, 80, 120)
CHUNK = (2, 48, 64)
MODES = {
    "max_error": dict(residual_mode=ebcc_tpu.RESIDUAL_MAX_ERROR, error=0.1),
    "pointwise_nan": dict(
        residual_mode=ebcc_tpu.RESIDUAL_POINTWISE_RELATIVE_ERROR, error=1e-3,
        allow_nan=True),
    "lossless": dict(residual_mode=ebcc_tpu.RESIDUAL_LOSSLESS),
}


def frames(dims=DIMS, seed=0):
    """Smooth positive fields with fine noise."""
    n, h, w = dims
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = [260 + 25 * np.sin(yy / h * np.pi + i) * np.cos(xx / w * 6.28)
           + 0.02 * rng.normal(size=(h, w)) for i in range(n)]
    return np.stack(out).astype(np.float32)


def data_and_config(mode, dims=DIMS):
    x = frames(dims)
    if MODES[mode].get("allow_nan"):
        x[1, 5:30, 10:40] = np.nan
    cfg = et.CodecConfig(dims=dims, chunk_dims=CHUNK, zstd_level=3,
                         **MODES[mode])
    return x, cfg


def memmap_of(tmp_path, x):
    mm = np.lib.format.open_memmap(str(tmp_path / "src.npy"), mode="w+",
                                   dtype=np.float32, shape=x.shape)
    mm[:] = x
    mm.flush()
    return np.load(str(tmp_path / "src.npy"), mmap_mode="r")


@pytest.mark.parametrize("mode", list(MODES))
def test_compress_stream_equals_encode_chunked(tmp_path, mode):
    x, cfg = data_and_config(mode)
    want = et.encode_chunked(x, cfg, device="cpu")
    path = tmp_path / "out.etpk"
    with open(path, "wb") as f:
        n = tio.compress_stream(memmap_of(tmp_path, x), cfg, f, max_batch=2,
                                device="cpu")
    blob = path.read_bytes()
    assert n == len(blob) and blob == want
    with open(path, "rb") as f:
        got = tio.decompress_stream(f, device="cpu")
    np.testing.assert_array_equal(got, et.decode_chunked(want, device="cpu"))
    out = ebcc_tpu.decode_chunked(blob)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(x))


@pytest.mark.parametrize("mode", ["max_error", "lossless"])
def test_append_chunked_equals_one_encode(mode):
    x, cfg = data_and_config(mode)
    head = dataclasses.replace(cfg, dims=(4, *DIMS[1:]))
    grown = tio.append_chunked(et.encode_chunked(x[:4], head, device="cpu"),
                               x[4:], cfg, device="cpu")
    assert grown == et.encode_chunked(x, cfg, device="cpu")


def test_append_refuses_unaligned_or_misshaped_data():
    x, cfg = data_and_config("max_error")
    odd = et.encode_chunked(x[:5], dataclasses.replace(cfg, dims=(5, 80, 120)),
                            device="cpu")
    with pytest.raises(ValueError, match="chunk-aligned"):
        tio.append_chunked(odd, x[5:], cfg, device="cpu")
    blob = et.encode_chunked(x, cfg, device="cpu")
    with pytest.raises(ValueError, match="appended data"):
        tio.append_chunked(blob, x[:2, :, :100], cfg, device="cpu")


def _head_file(tmp_path, x, cfg):
    head = et.encode_chunked(x[:4], dataclasses.replace(cfg, dims=(4, 80, 120)),
                             device="cpu")
    path = tmp_path / "archive.etpk"
    path.write_bytes(head)
    return path, head


def test_append_chunked_file_in_place(tmp_path):
    x, cfg = data_and_config("max_error")
    path, head = _head_file(tmp_path, x, cfg)
    n = tio.append_chunked_file(str(path), x[4:], cfg, device="cpu")
    blob = path.read_bytes()
    assert blob == et.encode_chunked(x, cfg, device="cpu")
    assert n == len(blob) - len(head)
    assert tio.repair_chunked_file(str(path)) == 0
    region = ((3, 6), (40, 80), (0, 70))
    got = et.decode_chunked_region(blob, region, device="cpu")
    sl = tuple(slice(*r) for r in region)
    assert np.abs(got - x[sl]).max() <= 0.1
    assert np.abs(ebcc_tpu.decode_chunked(blob) - x).max() <= 0.1


def test_repair_after_a_killed_append(tmp_path):
    """The records of an append landed but the header was not rewritten:
    readers refuse the trailing bytes, repair removes exactly them (as the
    JAX package's repair does on the same file) and the old archive is
    back."""
    x, cfg = data_and_config("max_error")
    path, head = _head_file(tmp_path, x, cfg)
    grown = tio.append_chunked(head, x[4:], cfg, device="cpu")
    path.write_bytes(head + grown[len(head):-10])
    with pytest.raises(tstream.StreamError):
        et.decode_chunked(path.read_bytes(), device="cpu")
    twin = tmp_path / "twin.etpk"
    twin.write_bytes(path.read_bytes())
    removed = tio.repair_chunked_file(str(path))
    assert removed == len(grown) - 10 - len(head)
    assert path.read_bytes() == head
    assert jpipeline.repair_chunked_file(str(twin)) == removed
    assert tio.repair_chunked_file(str(path)) == 0


def test_repair_refuses_a_truncated_record(tmp_path):
    x, cfg = data_and_config("max_error")
    path, head = _head_file(tmp_path, x, cfg)
    path.write_bytes(head[:-5])
    with pytest.raises(tstream.StreamError, match="truncated chunk"):
        tio.repair_chunked_file(str(path))


def test_failed_append_restores_the_old_file(tmp_path, monkeypatch):
    x, cfg = data_and_config("max_error")
    path, head = _head_file(tmp_path, x, cfg)

    def disk_full(fd):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(os, "fsync", disk_full)
    with pytest.raises(OSError):
        tio.append_chunked_file(str(path), x[4:], cfg, device="cpu")
    assert path.read_bytes() == head


@pytest.mark.parametrize("rank", [3, 4])
def test_compress_hdf5(tmp_path, rank):
    h5py = pytest.importorskip("h5py")
    x, _ = data_and_config("max_error")
    src = tmp_path / "src.h5"
    with h5py.File(src, "w") as f:
        f["t"] = x if rank == 3 else x.reshape(2, 3, *DIMS[1:])
    kw = dict(residual_mode=ebcc_tpu.RESIDUAL_MAX_ERROR, error=0.1,
              zstd_level=3)
    dst = tmp_path / "port.etpk"
    n = tio.compress_hdf5(str(src), "t", str(dst), kw, device="cpu")
    blob = dst.read_bytes()
    assert n == len(blob)
    cfg = et.CodecConfig(dims=DIMS, chunk_dims=(1, *DIMS[1:]), **kw)
    assert blob == et.encode_chunked(x, cfg, device="cpu")
    ref = tmp_path / "jax.etpk"
    jpipeline.compress_hdf5(str(src), "t", str(ref), kw)
    assert ref.read_bytes()[:tstream.CHUNKED_HEADER_SIZE] == \
        blob[:tstream.CHUNKED_HEADER_SIZE]
    assert np.abs(ebcc_tpu.decode_chunked(blob) - x).max() <= 0.1


@pytest.mark.parametrize("call", ["compress_stream", "decompress_stream",
                                  "append_chunked"])
def test_default_device_is_the_card(monkeypatch, call):
    x, cfg = data_and_config("max_error")
    blob = et.encode_chunked(x, cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "compress_stream":
            tio.compress_stream(x, cfg, io.BytesIO())
        elif call == "decompress_stream":
            tio.decompress_stream(io.BytesIO(blob))
        else:
            tio.append_chunked(blob, x[:2], cfg)
