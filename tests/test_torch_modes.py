"""The port's RELATIVE_ERROR, POINTWISE_RELATIVE_ERROR and ``allow_nan``
modes against the JAX package's, on the CPU.

Streams of each mode cross between the packages in both directions: NaNs
come back exactly where the input had them, and the mode's bound holds on
every valid sample (RELATIVE: error times the chunk's valid range;
POINTWISE: |x̂/x - 1| <= error; MAX_ERROR: error).  Header flags are equal
and stream sizes agree within 1% (the mask sections code the same bits the
same way).  Then the edge cases of ``tests/test_masked.py`` that apply to
the port.  Every port call passes ``device="cpu"``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ebcc_tpu

import ebcc_tpu_torch as et
from ebcc_tpu_torch.core import stream as tstream

torch.set_num_threads(2)

MODES = {
    "relative": dict(residual_mode=ebcc_tpu.RESIDUAL_RELATIVE_ERROR,
                     error=1e-3),
    "pointwise": dict(
        residual_mode=ebcc_tpu.RESIDUAL_POINTWISE_RELATIVE_ERROR, error=1e-3),
    "masked": dict(residual_mode=ebcc_tpu.RESIDUAL_MAX_ERROR, error=0.1,
                   allow_nan=True),
    "masked_pointwise": dict(
        residual_mode=ebcc_tpu.RESIDUAL_POINTWISE_RELATIVE_ERROR, error=1e-2,
        allow_nan=True),
}


def _frames(base):
    """Two 96x128 crops of the (positive) fixture frame."""
    return np.ascontiguousarray(np.stack(
        [base[40:136, 300:428], base[200:296, 700:828]]).astype(np.float32))


def _mask():
    """A "sea" blob and a border strip in frame 0, others in frame 1."""
    yy, xx = np.mgrid[0:96, 0:128]
    m0 = ((yy - 40) ** 2 + (xx - 60) ** 2 < 600) | (xx > 115)
    m1 = (yy < 10) | ((xx - 30) ** 2 + (yy - 70) ** 2 < 300)
    return np.stack([m0, m1])


def _data(base, mode):
    x = _frames(base)
    if MODES[mode].get("allow_nan"):
        x[_mask()] = np.nan
    return x


def _configs(shape, **kw):
    ref = ebcc_tpu.CodecConfig(dims=shape, base_cr=30, zstd_level=3, **kw)
    return ref, et.config_from_reference(dataclasses.asdict(ref))


def _assert_bound(mode_kw, x, out):
    nan = np.isnan(x)
    assert out.shape == x.shape and out.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(out), nan)
    v = ~nan
    err = mode_kw["error"]
    if mode_kw["residual_mode"] == ebcc_tpu.RESIDUAL_POINTWISE_RELATIVE_ERROR:
        assert np.abs(out[v] / x[v] - 1).max() <= err
    elif mode_kw["residual_mode"] == ebcc_tpu.RESIDUAL_RELATIVE_ERROR:
        assert np.abs(out[v] - x[v]).max() <= err * (x[v].max() - x[v].min())
    else:
        assert np.abs(out[v] - x[v]).max() <= err


@pytest.fixture(scope="module")
def streams(base_test_data):
    """mode -> (data, JAX stream, port stream)."""
    out = {}
    for mode, kw in MODES.items():
        x = _data(base_test_data, mode)
        ref_cfg, cfg = _configs(x.shape, **kw)
        out[mode] = (x, ebcc_tpu.encode(x, ref_cfg),
                     et.encode(x, cfg, device="cpu"))
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_cross_package_decode(streams, mode, direction):
    x, s_jax, s_port = streams[mode]
    out = (ebcc_tpu.decode(s_port) if direction == "port_to_jax"
           else et.decode(s_jax, device="cpu"))
    _assert_bound(MODES[mode], x, out)


@pytest.mark.parametrize("mode", list(MODES))
def test_flags_and_sizes_match_jax(streams, mode):
    x, s_jax, s_port = streams[mode]
    hj = tstream.split_frame_stream(s_jax)[0]
    hp = tstream.split_frame_stream(s_port)[0]
    assert hp.masked == hj.masked == bool(MODES[mode].get("allow_nan"))
    assert hp.log_domain == hj.log_domain
    assert hp.log_domain == (MODES[mode]["residual_mode"]
                             == ebcc_tpu.RESIDUAL_POINTWISE_RELATIVE_ERROR)
    assert abs(len(s_port) - len(s_jax)) <= 0.01 * len(s_jax)
    if hp.masked:
        assert (tstream.split_mask_section(s_port, hp)
                == tstream.split_mask_section(s_jax, hj))


@pytest.mark.parametrize("mode", ["relative", "masked_pointwise"])
def test_fused_curve_makes_the_same_streams(monkeypatch, base_test_data,
                                            mode):
    """EBCC_FUSED_CURVE=1 (K3's plain version here) against the unfused
    encode: the same cuts and flags, sizes within 1%."""
    x = _data(base_test_data, mode)
    _, cfg = _configs(x.shape, **MODES[mode])
    monkeypatch.setenv("EBCC_FUSED_CURVE", "1")
    fused = et.encode(x, cfg, device="cpu")
    monkeypatch.setenv("EBCC_FUSED_CURVE", "0")
    plain = et.encode(x, cfg, device="cpu")
    hf = tstream.split_frame_stream(fused)[0]
    hu = tstream.split_frame_stream(plain)[0]
    assert (hf.flags, hf.base_cut, hf.res_cut) == (hu.flags, hu.base_cut,
                                                   hu.res_cut)
    assert abs(len(fused) - len(plain)) <= 0.01 * len(plain)
    _assert_bound(MODES[mode], x, et.decode(fused, device="cpu"))


def test_device_resident_paths(base_test_data):
    """A numpy batch through encode_frames_device / roundtrip_frames_device
    (pipelined sub-batches slice the masks) makes the streams a one-chunk
    encode makes; decode_frames_device restores the NaNs on its device."""
    kw = MODES["masked_pointwise"]
    frames = _data(base_test_data, "masked_pointwise")
    xb = np.concatenate([frames, frames[::-1]])[:, None]      # (4, 1, h, w)
    _, cfg = _configs((4,) + frames.shape[1:], chunk_dims=(1, 96, 128), **kw)
    _, one = _configs((1,) + frames.shape[1:], **kw)
    want = [et.encode(c, one, device="cpu") for c in xb]
    assert et.encode_frames_device(xb, cfg, device="cpu") == want
    got, dec = et.roundtrip_frames_device(xb, cfg, max_batch=3,
                                          device="cpu")
    assert got == want
    assert dec.device.type == "cpu"
    _assert_bound(kw, xb, dec.numpy())
    dec2 = et.decode_frames_device(got, max_batch=3, device="cpu")
    np.testing.assert_array_equal(dec2.numpy(), dec.numpy())


@pytest.mark.parametrize("case", ["all_nan_chunk", "all_nan_frame"])
def test_all_nan(base_test_data, case):
    """A fully masked chunk decodes to NaN everywhere; a fully masked frame
    in a live chunk fills with the chunk's valid mean, so the relative
    range (and the bound) is the valid one."""
    if case == "all_nan_chunk":
        x = np.full((2, 64, 64), np.nan, np.float32)
    else:
        x = _frames(base_test_data)
        x[1] = np.nan
    kw = dict(residual_mode=ebcc_tpu.RESIDUAL_RELATIVE_ERROR, error=1e-3,
              allow_nan=True)
    ref_cfg, cfg = _configs(x.shape, **kw)
    blob = et.encode(x, cfg, device="cpu")
    for out in (et.decode(blob, device="cpu"), ebcc_tpu.decode(blob)):
        if case == "all_nan_chunk":
            assert np.isnan(out).all()
        else:
            _assert_bound(kw, x, out)
    if case == "all_nan_frame":
        _assert_bound(kw, x, et.decode(ebcc_tpu.encode(x, ref_cfg),
                                       device="cpu"))


def test_inf_raises_even_with_allow_nan(base_test_data):
    x = _frames(base_test_data)
    x[0, 5, 5] = np.inf
    _, cfg = _configs(x.shape, **MODES["masked"])
    with pytest.raises(ValueError):
        et.encode(x, cfg, device="cpu")


def test_nan_tensor_raises_even_with_allow_nan(base_test_data):
    """allow_nan masks numpy inputs; a tensor with NaN is refused."""
    x = _data(base_test_data, "masked")
    _, cfg = _configs((2,) + x.shape[1:], chunk_dims=(1, 96, 128),
                      **MODES["masked"])
    with pytest.raises(ValueError):
        et.encode_frames_device(torch.from_numpy(x[:, None]), cfg)


def test_no_nan_means_no_section(base_test_data):
    """allow_nan on finite data is a no-op: byte-identical streams."""
    x = _frames(base_test_data)
    kw = dict(MODES["masked"])
    _, with_flag = _configs(x.shape, **kw)
    kw.pop("allow_nan")
    _, without = _configs(x.shape, **kw)
    blob = et.encode(x, with_flag, device="cpu")
    assert blob == et.encode(x, without, device="cpu")
    assert not tstream.split_frame_stream(blob)[0].masked


def test_truncated_mask_section_raises(streams):
    _, _, blob = streams["masked"]
    for bad in (blob[:-3], blob + b"x"):
        with pytest.raises(tstream.StreamError):
            et.decode(bad, device="cpu")


def test_pointwise_requires_positive_data(base_test_data):
    x = _frames(base_test_data)
    x[1, 3, 4] = -1.0
    _, cfg = _configs(x.shape, **MODES["pointwise"])
    with pytest.raises(ValueError, match="positive"):
        et.encode(x, cfg, device="cpu")

