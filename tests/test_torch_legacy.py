"""The port's legacy EBCC/EBCK interop (``ebcc_tpu_torch.compat``) against
the JAX package's (``ebcc_tpu.compat``), on the CPU.

Both packages drive the same Pillow/OpenJPEG for the J2K base layer, the
same SPIHT coder (each its own build of ``spiht_coder.cc``) and zstd level
22 for the residual, so on one machine:

* the port's ``spiht_encode`` writes the JAX package's bytes and
  ``spiht_decode`` reads them back to the same values;
* ``encode_frame``, ``encode_chunked`` and ``encode_chunked_compat`` write
  the JAX package's bytes, in every mode the legacy format has, with and
  without a SPIHT residual;
* streams cross-decode both ways to the same values, also through
  ``ebcc_tpu_torch.decode(device="cpu")``, which dispatches on the magic;
* malformed streams raise ``LegacyFormatError`` in both packages;
* through ``libzstd.so.1`` (no ``zstandard``, as on the card's machine)
  the port's streams decode in the JAX package.

The JAX package's streams are made once, in a module fixture.  Skips
without Pillow's JPEG 2000 support, as ``tests/test_legacy.py`` does.
"""

import struct
import subprocess

import numpy as np
import pytest

import ebcc_tpu
from ebcc_tpu import native as jnative

import ebcc_tpu_torch as et
from ebcc_tpu_torch import native as tnative
from ebcc_tpu_torch.core import entropy as tentropy

H, W = 64, 128
# name -> (entry point, dims, config fields, environment of the encode).
# "residual" relaxes the base layer's quantile and turns the pure-base
# fallback off, so a SPIHT residual ships (zstd level 22).
CASES = {
    "max_error": ("encode_frame", (1, H, W),
                  dict(residual_mode=1, error=0.5), {}),
    "relative": ("encode_frame", (1, H, W),
                 dict(residual_mode=2, error=1e-3), {}),
    "rate": ("encode_frame", (1, H, W), dict(base_cr=50, residual_mode=0),
             {}),
    "residual": ("encode_frame", (1, H, W),
                 dict(residual_mode=1, error=0.1),
                 {"EBCC_INIT_BASE_ERROR_QUANTILE": "1e-2",
                  "EBCC_DISABLE_PURE_BASE_COMPRESSION_FALLBACK": "1"}),
    "const": ("encode_frame", (1, H, W), dict(residual_mode=1, error=0.1),
              {}),
    "tiled": ("encode_frame", (3, H, W), dict(residual_mode=1, error=0.5),
              {}),
    "container": ("encode_chunked", (2, H, W),
                  dict(residual_mode=1, error=0.5, chunk_dims=(1, 48, 96)),
                  {}),
    "compat": ("encode_chunked_compat", (1, H, W),
               dict(residual_mode=2, error=1e-2), {}),
}
# Bound on the decoded values: (absolute error, or a fraction of the range).
BOUND = {"max_error": 0.5, "relative": ("rel", 1e-3), "residual": 0.1,
         "const": 0.0, "tiled": 0.5, "container": 0.5,
         "compat": ("rel", 1e-2)}


def _data(base, name):
    _, dims, _, _ = CASES[name]
    if name == "const":
        return np.full(dims, -7.5, np.float32)
    n = dims[0]
    return np.ascontiguousarray(np.stack(
        [base[30 * i:30 * i + H, 200 + 40 * i:200 + 40 * i + W]
         for i in range(n)]).astype(np.float32))


def _config(pkg, name):
    _, dims, fields, _ = CASES[name]
    kw = dict(base_cr=30)
    kw.update(fields)
    return pkg.CodecConfig(dims=dims, **kw)


def _encode(compat, pkg, name, data, monkeypatch):
    fn, _, _, env = CASES[name]
    with monkeypatch.context() as m:
        for k, v in env.items():
            m.setenv(k, v)
        return getattr(compat, fn)(data, _config(pkg, name))


def _check_bound(name, data, out):
    out = out.reshape(data.shape)
    bound = BOUND.get(name)
    if bound is None:
        assert np.isfinite(out).all()
        return
    if isinstance(bound, tuple):
        bound = bound[1] * float(data.max() - data.min())
    assert np.abs(out - data).max() <= bound


@pytest.fixture(scope="module")
def compat():
    """(port compat, JAX compat); skips without Pillow's JPEG 2000 or the
    JAX package's native toolchain."""
    pytest.importorskip("PIL")
    from PIL import features
    if not features.check("jpg_2000"):
        pytest.skip("Pillow lacks JPEG2000 support")
    try:
        jnative.load()
    except (RuntimeError, FileNotFoundError, subprocess.CalledProcessError):
        pytest.skip("the JAX package's native toolchain is unavailable")
    from ebcc_tpu import compat as jcompat
    from ebcc_tpu_torch import compat as tcompat
    tnative.load_host()
    return tcompat, jcompat


@pytest.fixture(scope="module")
def jax_streams(compat, base_test_data):
    """name -> (data, the JAX package's stream)."""
    _, jcompat = compat
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in CASES:
            x = _data(base_test_data, name)
            out[name] = (x, _encode(jcompat, ebcc_tpu, name, x, mp))
    return out


@pytest.mark.parametrize("case", [((64, 128), 0, 3), ((64, 128), 6000, 3),
                                  ((96, 64), 0, 2), ((33, 47), 0, 3)],
                         ids=["full", "budget", "stages2", "odd"])
def test_spiht_equal_reference(compat, case):
    (h, w), trunc_bits, stages = case
    rng = np.random.default_rng(h * w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    norm = 0.5 + 0.4 * np.sin(yy / 7) * np.cos(xx / 5)
    norm = np.clip(norm + 0.05 * rng.normal(size=(h, w)), 0, 1).astype(
        np.float32)
    blob = tnative.spiht_encode(norm, trunc_bits, stages)
    assert blob == jnative.spiht_encode(norm, trunc_bits, stages)
    for nbytes in (len(blob), max(20, len(blob) // 3)):
        np.testing.assert_array_equal(
            tnative.spiht_decode(blob[:nbytes], h, w, nbytes * 8),
            jnative.spiht_decode(blob[:nbytes], h, w, nbytes * 8))
    for pkg in (tnative, jnative):
        with pytest.raises(ValueError):
            pkg.spiht_decode(b"not an ims stream" * 10, h, w, 800)


@pytest.mark.parametrize("name", list(CASES))
def test_encoders_equal_reference(compat, jax_streams, name, monkeypatch):
    tcompat, _ = compat
    x, s_jax = jax_streams[name]
    assert _encode(tcompat, et, name, x, monkeypatch) == s_jax
    if name == "residual":
        (comp_size,) = struct.unpack_from("<Q", s_jax, 32)
        assert comp_size > 0, "no SPIHT residual shipped"


@pytest.mark.parametrize("name", list(CASES))
def test_cross_decode(compat, jax_streams, name):
    """The JAX package's stream decodes in the port to the JAX package's
    values, through ``compat.decode`` and ``ebcc_tpu_torch.decode``."""
    tcompat, jcompat = compat
    x, s_jax = jax_streams[name]
    want = jcompat.decode(s_jax)
    for got in (tcompat.decode(s_jax), et.decode(s_jax, device="cpu")):
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ebcc_tpu.decode(s_jax), want)
    _check_bound(name, x, want)


def test_unversioned_layout(compat, jax_streams):
    """The pre-"EBCC" layout (the reference's ebcc_decode_legacy) reads
    the same in both packages."""
    tcompat, jcompat = compat
    x, blob = jax_streams["residual"]
    (_, _, _, _, min_bits, max_bits, coeffs_size, rmin_bits, rmax_bits,
     comp_size, _) = struct.unpack_from("<4sBBHIIQIIQQ", blob)
    f32 = lambda b: np.uint32(b).view(np.float32)  # noqa: E731
    old = struct.pack("<ffQffQ", f32(min_bits), f32(max_bits), coeffs_size,
                      f32(rmin_bits), f32(rmax_bits), comp_size) + blob[48:]
    out = tcompat.decode(old)
    np.testing.assert_array_equal(out, jcompat.decode(old))
    _check_bound("residual", x, out)


def _corruptions(frame, container):
    tampered = bytearray(frame)
    tampered[16:24] = struct.pack("<Q", 1 << 60)       # absurd coeffs_size
    bad_version = bytearray(frame)
    bad_version[4] = 2
    grid = bytearray(container)
    grid[72:80] = struct.pack("<Q", 7)                 # chunk_size
    return {"header": frame[:40], "payload": frame[:-10],
            "coeffs_size": bytes(tampered), "version": bytes(bad_version),
            "container_table": container[:85],
            "container_payload": container[:-3],
            "container_grid": bytes(grid),
            "container_trailing": container + b"\0"}


@pytest.mark.parametrize("what", ["header", "payload", "coeffs_size",
                                  "version", "container_table",
                                  "container_payload", "container_grid",
                                  "container_trailing"])
def test_corrupt_streams_raise(compat, jax_streams, what):
    tcompat, jcompat = compat
    bad = _corruptions(jax_streams["residual"][1],
                       jax_streams["container"][1])[what]
    with pytest.raises(tcompat.LegacyFormatError):
        et.decode(bad, device="cpu")
    with pytest.raises(jcompat.LegacyFormatError):
        ebcc_tpu.decode(bad)


def test_corrupt_residual_raises(compat, jax_streams):
    """A flipped byte in the zstd residual frame: the port raises
    ``LegacyFormatError`` (a ``ValueError``) where the JAX package lets
    zstandard's own error through."""
    tcompat, _ = compat
    blob = bytearray(jax_streams["residual"][1])
    blob[48:52] = b"\0\0\0\0"                          # the frame's magic
    with pytest.raises(tcompat.LegacyFormatError, match="residual"):
        tcompat.decode(bytes(blob))


@pytest.mark.parametrize("name", ["residual", "container"])
def test_libzstd_streams_decode_in_reference(compat, jax_streams, name,
                                             monkeypatch):
    """Without ``zstandard`` (the card's machine) the port writes the
    residual through ``libzstd.so.1``; the JAX package reads the stream to
    the port's values, within the bound."""
    tcompat, jcompat = compat
    x, _ = jax_streams[name]
    monkeypatch.setattr(tentropy, "_zstd", None)
    blob = _encode(tcompat, et, name, x, monkeypatch)
    out = tcompat.decode(blob)
    np.testing.assert_array_equal(jcompat.decode(blob), out)
    _check_bound(name, x, out)
