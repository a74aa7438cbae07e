"""The port's user surfaces (``ebcc_tpu_torch.api``, ``utils.profiling``)
against the JAX package's, on the CPU.

* ``EBCC_Filter`` (items, ``hdf_filter_opts``, chunks), ``populate_config``
  (every field of the config) and the float<->uint32 helpers equal the JAX
  package's for each residual option, the ``pointwise`` and ``lossless``
  extensions, the temporal and NaN flags included; bad options raise in
  both.
* ``cli.main(["spec", ...])`` prints the JAX package's strings, stdout and
  stderr alike.
* ``compress`` and ``decompress`` with ``--device cpu`` write a container
  that the JAX package's ``decode_chunked`` reads within the bound
  (MAX_ERROR 0.1 plus its decoder's ``DECODER_EPS_REL`` of the range);
  ``--region`` equals the crop of the full decode bit for bit.
* ``hdf5.save_dataset`` of either package loads with the other's
  ``load_dataset`` (the attribute prefix is shared).
* The Zarr codec round-trips within the bound, its config round-trips, and
  its bytes decode with ``ebcc_tpu.decode``.
* ``profiling.trace`` writes a Chrome trace holding its annotation.

The frames are the 64x64 smooth frames of ``test_torch_parallel.py`` (6
one-frame chunks).  The JAX package compiles one container decode here
(the CLI's container and the HDF5 dataset are the same bytes) and one
stream decode (the Zarr codec's).  Every port call passes
``device="cpu"``.
"""

import ast
import contextlib
import dataclasses
import glob
import io
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import ebcc_tpu
from ebcc_tpu.api import cli as jcli
from ebcc_tpu.api import filter_wrapper as jfw
from ebcc_tpu.api import hdf5 as jhdf5
from ebcc_tpu.core.kernels import DECODER_EPS_REL

from ebcc_tpu_torch import api
from ebcc_tpu_torch.api import cli as tcli
from ebcc_tpu_torch.api import filter_wrapper as tfw
from ebcc_tpu_torch.api import hdf5 as thdf5
from ebcc_tpu_torch.api.zarr_filter import EBCCZarrFilter
from ebcc_tpu_torch.utils import profiling

from test_torch_parallel import configs, jax_config, smooth_frames

DIMS = (6, 64, 64)
ERROR = 0.1
RESIDUAL_OPTS = [None, ("none", 0), ("max_error_target", 0.5),
                 ("relative_error_target", 1e-3),
                 ("pointwise_relative_error_target", 1e-2),
                 ("lossless", 0)]


def config_fields(c):
    return dataclasses.asdict(c)


@pytest.mark.parametrize("residual_opt", RESIDUAL_OPTS)
@pytest.mark.parametrize("extra", [
    dict(), dict(data_dim=3), dict(data_dim=4, temporal_chunk=8),
    dict(data_dim=3, allow_nan=True),
    dict(data_dim=3, temporal_chunk=8, allow_nan=True)])
def test_filter_and_populate_config_match_jax(residual_opt, extra):
    kw = dict(base_cr=200, height=721, width=1440, residual_opt=residual_opt,
              **extra)
    error_free = residual_opt is None or residual_opt[0] in ("none",
                                                             "lossless")
    if extra.get("temporal_chunk") and error_free:
        for mod in (jfw, tfw):
            with pytest.raises(ValueError, match="temporal_chunk"):
                mod.EBCC_Filter(**kw)
        return
    ref, got = jfw.EBCC_Filter(**kw), tfw.EBCC_Filter(**kw)
    assert dict(got) == dict(ref)
    assert got.hdf_filter_opts == ref.hdf_filter_opts
    assert got.chunks == ref.chunks and hash(got) == hash(ref)
    for frames in (1, 8):
        nbytes = frames * 721 * 1440 * 4
        assert config_fields(tfw.populate_config(
            got.hdf_filter_opts, nbytes)) == config_fields(
            jfw.populate_config(ref.hdf_filter_opts, nbytes))


@pytest.mark.parametrize("cd_values, nbytes", [
    ((721, 1440), 721 * 1440 * 4),                 # too few values
    ((16, 1440, 0, 0), 16 * 1440 * 4),             # tile too small
    ((721, 1440, 0, 0), 721 * 1440 * 4 - 4),       # buffer < tile
    ((721, 1440, 0, 0), 721 * 1440 * 6),           # not divisible
    ((721, 1440, 0, 1), 721 * 1440 * 4),           # error value missing
    ((721, 1440, 0, 9), 721 * 1440 * 4)])          # unknown mode
def test_populate_config_rejects_what_jax_rejects(cd_values, nbytes):
    for mod in (jfw, tfw):
        with pytest.raises(ValueError):
            mod.populate_config(cd_values, nbytes)
    for mod in (jfw, tfw):
        with pytest.raises(ValueError, match="residual_type"):
            mod.EBCC_Filter(30, 64, 64, ("bogus", 1))


@pytest.mark.parametrize("v", [0.0, -0.0, 1e-3, 0.5, 30.0, 200.0, 1e30,
                               -7.25])
def test_float_helpers_match_jax(v):
    assert tfw.float_to_uint32(v) == jfw.float_to_uint32(v)
    assert tfw.double_to_uint32(v) == jfw.double_to_uint32(v)
    u = jfw.float_to_uint32(v)
    assert tfw.uint32_to_float(u) == jfw.uint32_to_float(u)


def run_cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    [], ["spec"], ["-b", "200", "-H", "721", "-W", "1440", "-r", "0.01"],
    ["spec", "-b", "30", "-H", "64", "-W", "96", "-m", "0.5"],
    ["spec", "-p", "0.001", "--help-cdo"], ["spec", "--lossless"],
    ["spec", "-b", "12.5", "-m", "0.25", "-r", "0.1"]])
def test_cli_spec_prints_jax_strings(argv):
    assert run_cli(tcli.main, list(argv)) == run_cli(jcli.main, list(argv))


@pytest.fixture(scope="module")
def frames():
    return smooth_frames(DIMS)


def test_cli_roundtrip_reads_under_jax(frames, tmp_path):
    src, blob, out = (tmp_path / n for n in ("in.npy", "c.etpk", "out.npy"))
    np.save(src, frames)
    assert tcli.main(["compress", str(src), str(blob), "--max-error",
                      str(ERROR), "--device", "cpu"]) == 0
    assert tcli.main(["decompress", str(blob), str(out), "--device",
                      "cpu"]) == 0
    full = np.load(out)
    assert full.shape == frames.shape
    assert np.abs(full - frames).max() <= ERROR
    tol = ERROR + DECODER_EPS_REL * float(frames.max() - frames.min())
    assert np.abs(ebcc_tpu.decode_chunked(blob.read_bytes())
                  - frames).max() <= tol
    assert tcli.main(["decompress", str(blob), str(out), "--device", "cpu",
                      "--region", "1:4,10:50,3:61"]) == 0
    np.testing.assert_array_equal(np.load(out), full[1:4, 10:50, 3:61])
    assert tcli.main(["decompress", str(blob), str(out), "--device", "cpu",
                      "--region", "0:9,0:1,0:1"]) == 2


def test_cli_default_device_is_the_card(frames, tmp_path, monkeypatch):
    src = tmp_path / "in.npy"
    np.save(src, frames[:1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["compress", str(src), str(tmp_path / "c.etpk")])


def test_hdf5_datasets_cross_both_ways(frames, tmp_path):
    """The port's MAX_ERROR dataset loads with the JAX package within the
    bound (the CLI test's container, so its JAX decode is compiled once);
    the JAX package's lossless dataset (its host coder: no JAX compile)
    loads with the port bit for bit."""
    h5py = pytest.importorskip("h5py")
    cfg = configs(dims=DIMS)[0]
    ref_cfg = jax_config(configs("lossless", dims=DIMS)[0])
    tol = ERROR + DECODER_EPS_REL * float(frames.max() - frames.min())
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:
        thdf5.save_dataset(f, "port", frames, cfg, device="cpu")
        jhdf5.save_dataset(f, "jax", frames, ref_cfg)
        f.create_dataset("plain", data=np.zeros(4, np.uint8))
    with h5py.File(path, "r") as f:
        assert np.abs(jhdf5.load_dataset(f, "port") - frames).max() <= tol
        np.testing.assert_array_equal(
            thdf5.load_dataset(f, "jax", device="cpu"), frames)
        with pytest.raises(ValueError, match="not an ebcc_tpu payload"):
            thdf5.load_dataset(f, "plain", device="cpu")


def test_zarr_codec_roundtrip_config_and_jax_decode(frames):
    spec = tfw.EBCC_Filter(30, 64, 64, ("max_error_target", ERROR),
                           data_dim=3)
    codec = EBCCZarrFilter(spec.hdf_filter_opts, device="cpu")
    assert codec.codec_id == "ebcc_tpu_filter"
    buf = frames[:2].copy()
    enc = codec.encode(buf)
    assert np.abs(codec.decode(enc) - buf.ravel()).max() <= ERROR
    out = np.empty_like(buf)
    assert codec.decode(enc, out=out) is out
    assert np.abs(out - buf).max() <= ERROR
    conf = codec.get_config()
    assert json.loads(json.dumps(conf)) == conf
    again = EBCCZarrFilter.from_config(conf)
    assert again.get_config() == conf and again.device == "cuda"
    tol = ERROR + DECODER_EPS_REL * float(buf.max() - buf.min())
    assert np.abs(ebcc_tpu.decode(enc).ravel() - buf.ravel()).max() <= tol
    with pytest.raises(TypeError):
        codec.encode(buf.astype(np.float64))


def test_api_imports_neither_h5py_nor_numcodecs():
    """``ebcc_tpu_torch.api`` and the modules it imports reach ``h5py``
    and ``numcodecs`` only inside functions (or not at all)."""
    root = pathlib.Path(api.__file__).parent
    for name in ("__init__.py", "cli.py", "filter_wrapper.py", "hdf5.py"):
        for node in ast.parse((root / name).read_text()).body:
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] + [a.name for a in node.names]
            else:
                continue
            assert not any(m.split(".")[0] in ("h5py", "numcodecs",
                                               "zarr_filter")
                           for m in mods), (name, mods)


def test_trace_writes_a_chrome_trace(frames, tmp_path):
    with profiling.trace("port_trace", profile_dir=str(tmp_path)):
        with profiling.annotate("port_encode"):
            torch.from_numpy(frames).sum()
    files = glob.glob(os.path.join(tmp_path, "port_trace.*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))[
        "traceEvents"]}
    assert {"port_trace", "port_encode"} <= names
    with profiling.trace("off"):          # no directory: a no-op
        pass
    assert len(os.listdir(tmp_path)) == 1
