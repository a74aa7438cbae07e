"""The port's HDF5 filter plugin (``native.plugin_dir()``, filter id 33030),
its ``api/xarray_io.py`` and ``compat/reference_bin.py``, on the CPU.

* The filter callback, reached as HDF5 reaches it (``H5PLget_plugin_info``
  through ``ctypes``): the class describes filter 33030, encoding writes
  the JAX package's native encoder's bytes, which the port's decode reads
  within the bound, and the reverse flag gives ``native.native_decode``'s
  values.
* ``h5py`` in subprocesses, as ``tests/test_native.py`` runs the JAX
  plugin: a dataset written through the port's plugin reads back through
  it within the bound and through the JAX package's plugin to the same
  values, and the reverse.  The two plugins share the filter id, so each
  process names one plugin directory in ``HDF5_PLUGIN_PATH``.
* ``xarray_io`` is wired to the port's plugin; its round trips skip without
  ``xarray``, as ``tests/test_xarray.py`` does.
* ``reference_bin`` builds into the port's build directory and raises
  ``ReferenceUnavailable`` without the reference's sources; its A/B tests
  skip then, as ``tests/test_reference_ab.py`` does.
"""

import ctypes
import ctypes.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import ebcc_tpu
from ebcc_tpu import native as jnative

import ebcc_tpu_torch as et
from ebcc_tpu_torch import native as tnative
from ebcc_tpu_torch.api.filter_wrapper import EBCC_Filter
from ebcc_tpu_torch.ops import _build

FILTER_ID = 33030
H5Z_FLAG_REVERSE = 0x0100
ERROR = 0.5
SHAPE = (2, 64, 96)
_FILTER_FN = ctypes.CFUNCTYPE(
    ctypes.c_size_t, ctypes.c_uint, ctypes.c_size_t,
    ctypes.POINTER(ctypes.c_uint), ctypes.c_size_t,
    ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_void_p))


class _H5ZClass2(ctypes.Structure):
    """``H5Z_class2_t`` of ``csrc/host/h5_minimal.h``."""

    _fields_ = [("version", ctypes.c_int), ("id", ctypes.c_int),
                ("encoder_present", ctypes.c_uint),
                ("decoder_present", ctypes.c_uint),
                ("name", ctypes.c_char_p), ("can_apply", ctypes.c_void_p),
                ("set_local", ctypes.c_void_p), ("filter", _FILTER_FN)]


def _frames(dims=SHAPE, seed=3):
    n, h, w = dims
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = 270 + 10 * np.sin(yy / 9) * np.cos(xx / 7)
    return np.stack([f + k + 0.2 * rng.normal(size=(h, w))
                     for k in range(n)]).astype(np.float32)


def _filter_kwargs(h, w):
    return dict(EBCC_Filter(base_cr=20, height=h, width=w,
                            residual_opt=("max_error_target", ERROR),
                            data_dim=3))


@pytest.fixture(scope="module")
def plugin():
    """(the port's plugin directory, its library loaded with ctypes)."""
    pdir = tnative.plugin_dir()
    assert os.listdir(pdir) == [f"lib{_build.PLUGIN}.so"]
    assert pdir != str(jnative.BUILD_DIR)
    return pdir, ctypes.CDLL(os.path.join(pdir, f"lib{_build.PLUGIN}.so"))


def _run_filter(lib, flags, cd, data: bytes) -> bytes:
    """Call the plugin's filter on a malloc'd copy of ``data``, as HDF5
    does (the filter frees the buffer it is given)."""
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    libc.malloc.restype = ctypes.c_void_p
    libc.malloc.argtypes = [ctypes.c_size_t]
    libc.free.argtypes = [ctypes.c_void_p]
    lib.H5PLget_plugin_info.restype = ctypes.POINTER(_H5ZClass2)
    cls = lib.H5PLget_plugin_info().contents
    buf = ctypes.c_void_p(libc.malloc(len(data)))
    ctypes.memmove(buf, data, len(data))
    size = ctypes.c_size_t(len(data))
    cdv = (ctypes.c_uint * len(cd))(*cd)
    n = cls.filter(flags, len(cd), cdv, len(data), ctypes.byref(size),
                   ctypes.byref(buf))
    try:
        return ctypes.string_at(buf, n) if n else b""
    finally:
        libc.free(buf)


def test_filter_class(plugin):
    _, lib = plugin
    lib.H5PLget_plugin_type.restype = ctypes.c_int
    lib.H5PLget_plugin_info.restype = ctypes.POINTER(_H5ZClass2)
    cls = lib.H5PLget_plugin_info().contents
    assert lib.H5PLget_plugin_type() == 0          # H5PL_TYPE_FILTER
    assert (cls.version, cls.id, cls.encoder_present,
            cls.decoder_present) == (1, FILTER_ID, 1, 1)
    assert cls.name.startswith(b"ebcc_tpu")


def test_filter_callback(plugin):
    _, lib = plugin
    x = _frames()
    kw = _filter_kwargs(*SHAPE[1:])
    cd = kw["compression_opts"]
    blob = _run_filter(lib, 0, cd, x.tobytes())
    cfg = ebcc_tpu.CodecConfig(dims=SHAPE, base_cr=20,
                               residual_mode=ebcc_tpu.RESIDUAL_MAX_ERROR,
                               error=ERROR)
    assert blob == jnative.native_encode(x, cfg)
    assert np.abs(et.decode(blob, device="cpu") - x).max() <= ERROR
    back = np.frombuffer(_run_filter(lib, H5Z_FLAG_REVERSE, cd, blob),
                         np.float32)
    np.testing.assert_array_equal(back, tnative.native_decode(blob))
    # A tile that does not divide the chunk fails the filter (0 bytes).
    assert _run_filter(lib, 0, (48, *cd[1:]), x.tobytes()) == b""


_WRITE = """
import sys, numpy as np, h5py
kw = eval(sys.argv[3])
x = np.load(sys.argv[2])
with h5py.File(sys.argv[1], "w") as f:
    f.create_dataset("v", shape=x.shape, **kw)[...] = x
"""
_READ = """
import sys, numpy as np, h5py
with h5py.File(sys.argv[1], "r") as f:
    np.save(sys.argv[2], f["v"][...])
"""


def _h5py(code, pdir, *args):
    """Run ``code`` in a process whose ``HDF5_PLUGIN_PATH`` is ``pdir``
    alone."""
    env = dict(os.environ, HDF5_PLUGIN_PATH=pdir)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                           *map(str, args)], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture(scope="module")
def written(plugin, tmp_path_factory):
    """package -> an HDF5 file its plugin wrote, and the frames."""
    pytest.importorskip("h5py")
    jnative.load()
    dirs = {"port": plugin[0], "jax": str(jnative.BUILD_DIR)}
    tmp = tmp_path_factory.mktemp("h5plugin")
    x = _frames((3, 64, 96))
    np.save(tmp / "x.npy", x)
    out = {}
    for pkg, pdir in dirs.items():
        out[pkg] = tmp / f"{pkg}.h5"
        _h5py(_WRITE, pdir, out[pkg], tmp / "x.npy",
              repr(_filter_kwargs(64, 96)))
    return dirs, out, x, tmp


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
def test_h5py_through_plugins(written, writer, reader):
    dirs, files, x, tmp = written
    got = tmp / f"{writer}_{reader}.npy"
    _h5py(_READ, dirs[reader], files[writer], got)
    out = np.load(got)
    assert out.shape == x.shape and np.abs(out - x).max() <= ERROR
    if writer != reader:
        # The same C decoder in both plugins: the values agree bit for bit.
        same = tmp / f"{writer}_{writer}.npy"
        if not same.exists():
            _h5py(_READ, dirs[writer], files[writer], same)
        np.testing.assert_array_equal(out, np.load(same))


def test_xarray_io_wired_to_the_port_plugin(plugin):
    from ebcc_tpu_torch.api import xarray_io
    assert xarray_io._plugin_dir() == plugin[0]
    assert xarray_io._residual_opt(None, 0.01) == ("relative_error_target",
                                                   0.01)
    with pytest.raises(ValueError):
        xarray_io._residual_opt(0.5, 0.01)


def _dataset(xr):
    rng = np.random.default_rng(11)
    t = (270 + rng.normal(scale=2, size=(3, 128, 128))
         .cumsum(axis=2) / 20).astype(np.float32)
    return xr.Dataset(
        {"t2m": (("time", "lat", "lon"), t),
         "mask": (("lat", "lon"), np.ones((128, 128), np.int8))},
        coords={"time": np.arange(3),
                "lat": np.linspace(-60, 60, 128).astype(np.float32),
                "lon": np.linspace(0, 359, 128).astype(np.float32)})


@pytest.mark.parametrize("bound", ["error", "relative_error"])
def test_xarray_roundtrip(tmp_path, bound):
    xr = pytest.importorskip("xarray")
    pytest.importorskip("h5py")
    from ebcc_tpu_torch.api import xarray_io
    ds = _dataset(xr)
    path = str(tmp_path / "ds.nc")
    value = 0.1 if bound == "error" else 0.01
    xarray_io.compress_dataset(ds, path, **{bound: value})
    out = xarray_io.open_compressed(path)
    limit = value if bound == "error" else value * float(
        ds["t2m"].max() - ds["t2m"].min())
    assert np.abs(np.asarray(out["t2m"]) - ds["t2m"].values).max() <= limit
    assert "mask" in out


def test_reference_bin_is_the_port_own():
    from ebcc_tpu_torch.compat import reference_bin as rb
    assert str(rb.SHIM_DIR).startswith(_build.HOST_SRC)
    assert str(rb.BUILD_DIR).startswith(_build.BUILD_DIR)
    for f in ("opj_shim.c", "openjpeg.h"):
        with open(rb.SHIM_DIR / f) as a, open(
                f"{_build.CSRC}/../../scripts/ref_shim/{f}") as b:
            assert a.read().split("\n", 2)[2] == b.read()
    if not (rb.REFERENCE_SRC / "ebcc_codec.c").exists():
        with pytest.raises(rb.ReferenceUnavailable):
            rb.load()


@pytest.fixture(scope="module")
def ref():
    from ebcc_tpu_torch.compat import reference_bin as rb
    try:
        rb.load()
    except Exception as e:
        pytest.skip(f"reference binary unavailable: {e}")
    return rb


def test_reference_streams_both_ways(ref, base_test_data):
    from ebcc_tpu_torch import compat
    frame = np.ascontiguousarray(base_test_data[:128, :192])
    blob = ref.encode(frame[None], base_cr=30, mode=1, error=0.5)
    np.testing.assert_array_equal(compat.decode(blob), ref.decode(blob))
    cfg = et.CodecConfig(dims=(1, *frame.shape), base_cr=30,
                         residual_mode=et.RESIDUAL_MAX_ERROR, error=0.5)
    ours = compat.encode_frame(frame, cfg)
    np.testing.assert_array_equal(ref.decode(ours), compat.decode(ours))
