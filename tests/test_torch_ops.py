"""The PyTorch port's plain ops, held against the JAX package on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances: the transforms are compared to ``1e-5 * max|x|`` (float32
rounding of a few lifting steps; XLA may contract multiply-adds where PyTorch
rounds each op); integer-valued ops must agree exactly.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ebcc_tpu
from ebcc_tpu.core import stream as jstream
from ebcc_tpu.ops import bitplane as jbit
from ebcc_tpu.ops import dwt as jdwt
from ebcc_tpu.ops import metrics as jmet

import ebcc_tpu_torch
from ebcc_tpu_torch.core import stream as tstream
from ebcc_tpu_torch.ops import bitplane as tbit
from ebcc_tpu_torch.ops import dwt as tdwt
from ebcc_tpu_torch.ops import metrics as tmet

torch.set_num_threads(2)

PORT_ROOT = pathlib.Path(ebcc_tpu_torch.__file__).parent


def _rand(shape, seed=0, scale=1000.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("levels", [3, 5])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_dwt_matches_jax(levels, direction):
    x = _rand((2, 1, 96, 128), seed=levels)
    if direction == "forward":
        ref = np.asarray(jdwt.dwt2d(jnp.asarray(x), levels))
        got = tdwt.dwt2d(torch.from_numpy(x), levels).numpy()
    else:
        ref = np.asarray(jdwt.idwt2d(jnp.asarray(x), levels))
        got = tdwt.idwt2d(torch.from_numpy(x), levels).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(x).max()


@pytest.mark.parametrize("levels", [3, 5])
def test_dwt_perfect_reconstruction(levels):
    x = _rand((1, 2, 64, 96), seed=7)
    y = tdwt.dwt2d(torch.from_numpy(x), levels)
    back = tdwt.idwt2d(y, levels).numpy()
    assert np.abs(back - x).max() <= 1e-5 * np.abs(x).max()


def test_dwt_rejects_indivisible_dims():
    with pytest.raises(ValueError):
        tdwt.dwt2d(torch.zeros(1, 1, 40, 64), 5)


@pytest.mark.parametrize("hw", [(90, 100), (20, 100), (100, 20)],
                         ids=["symmetric", "edge-rows", "edge-cols"])
def test_pad_to_multiple_matches_jax(hw):
    x = _rand((2, 1) + hw, seed=3)
    ref, ref_hw = jdwt.pad_to_multiple(jnp.asarray(x), 32)
    got, got_hw = tdwt.pad_to_multiple(torch.from_numpy(x), 32)
    assert got_hw == ref_hw == hw
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tdwt.unpad(got, got_hw).numpy(), x)


def test_subband_shapes_match_jax():
    assert tdwt.subband_shapes(736, 1440, 5) == jdwt.subband_shapes(
        736, 1440, 5)


@pytest.mark.parametrize("cut", [0, 1, 4, 9])
def test_reconstruct_at_cut_matches_jax(cut):
    q = np.random.default_rng(cut).integers(-5000, 5000, (2, 1, 32, 64),
                                            dtype=np.int32)
    cuts = np.array([cut, max(cut - 1, 0)], np.int32)[:, None, None, None]
    ref = np.asarray(jbit.reconstruct_at_cut(jnp.asarray(q),
                                             jnp.asarray(cuts)))
    got = tbit.reconstruct_at_cut(torch.from_numpy(q),
                                  torch.from_numpy(cuts)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_quantize_floor_matches_jax():
    x = _rand((3, 40), seed=11, scale=50.0)
    np.testing.assert_array_equal(
        tbit.quantize_floor(torch.from_numpy(x)).numpy(),
        np.asarray(jbit.quantize_floor(jnp.asarray(x))))


@pytest.mark.parametrize("num_planes", [13, 22])
def test_estimated_code_bytes_matches_jax(num_planes):
    q = np.random.default_rng(num_planes).integers(
        -(1 << (num_planes - 4)), 1 << (num_planes - 4), (2, 96, 128),
        dtype=np.int32)
    ref = np.asarray(jbit.estimated_code_bytes(jnp.asarray(q), num_planes))
    got = tbit.estimated_code_bytes(torch.from_numpy(q), num_planes).numpy()
    assert got.shape == ref.shape == (num_planes + 1, 2)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    dens = tbit.plane_bit_density(torch.from_numpy(q), num_planes).numpy()
    np.testing.assert_allclose(
        dens, np.asarray(jbit.plane_bit_density(jnp.asarray(q), num_planes)),
        rtol=1e-6)


def test_metrics_match_jax():
    x = _rand((3, 1, 48, 64), seed=5, scale=30.0)
    rec = x + _rand(x.shape, seed=6, scale=0.2)
    tx, tr = torch.from_numpy(x), torch.from_numpy(rec)
    jx, jr = jnp.asarray(x), jnp.asarray(rec)
    for got, ref in zip(tmet.minmax(tx), jmet.minmax(jx)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tmet.max_abs_error(tx, tr).numpy(),
                                  np.asarray(jmet.max_abs_error(jx, jr)))
    (gc, gm), (rc, rm) = (tmet.centered_max_abs_error(tx, tr),
                          jmet.centered_max_abs_error(jx, jr))
    np.testing.assert_allclose(gm.numpy(), np.asarray(rm), atol=1e-6)
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), atol=1e-5)
    tgt = np.array([0.1, 0.2, 0.3], np.float32)
    np.testing.assert_allclose(
        tmet.error_quantile(tx, tr, torch.from_numpy(tgt)).numpy(),
        np.asarray(jmet.error_quantile(jx, jr, jnp.asarray(tgt))),
        rtol=1e-6)


def test_batch_mean_independent_of_batch():
    x = _rand((5, 1, 64, 96), seed=9, scale=3.0)
    full = tmet.batch_mean(torch.from_numpy(x)).numpy()
    one = np.concatenate([tmet.batch_mean(torch.from_numpy(x[i:i + 1]))
                          .numpy() for i in range(5)])
    np.testing.assert_array_equal(full, one)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_ebcc_tpu():
    scripts = sorted((PORT_ROOT.parent / "scripts").glob("torch_*.py"))
    sources = sorted(PORT_ROOT.rglob("*.py")) + [
        PORT_ROOT.parent / "chip_smoke.py"] + scripts
    assert len(sources) > 10
    for sub in ("native", "parallel", "api"):
        assert PORT_ROOT / sub / "__init__.py" in sources
    for mod in ("core/transfer.py", "core/routing.py",
                "ops/exchange_hopper.py", "compat/legacy.py", "compat/j2k.py",
                "compat/reference_bin.py", "api/xarray_io.py", "bench.py"):
        assert PORT_ROOT / mod in sources
    for name in ("stream_bench", "scaling_bench", "compare_targets",
                 "attribute_roundtrip", "kernel_times"):
        assert PORT_ROOT.parent / "scripts" / f"torch_{name}.py" in scripts
    bad = []
    for path in sources:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib") or top == "ebcc_tpu":
                bad.append(f"{path.name}: {mod}")
        # The port builds and loads its own host libraries, never the JAX
        # package's plugin or build directory.
        text = path.read_text()
        for name in ("libh5z_etpu", "native/build"):
            if name in text:
                bad.append(f"{path.name}: {name}")
    assert not bad, bad


def test_config_carried_across():
    ref = ebcc_tpu.CodecConfig(dims=(3, 96, 128), base_cr=20,
                               residual_mode=ebcc_tpu.RESIDUAL_MAX_ERROR,
                               error=0.25, zstd_level=3)
    got = ebcc_tpu_torch.config_from_reference(dataclasses.asdict(ref))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    opts = ebcc_tpu.EncodeOptions(base_error_quantile=1e-4,
                                  disable_mean_adjustment=True)
    got_o = ebcc_tpu_torch.options_from_reference(dataclasses.asdict(opts))
    assert dataclasses.asdict(got_o) == dataclasses.asdict(opts)
    assert got_o.base_quantile_target == opts.base_quantile_target
    with pytest.raises(ValueError):
        ebcc_tpu_torch.config_from_reference({"dims": (1, 64, 64),
                                              "bogus": 1})


def test_stream_header_bytes_identical():
    kw = dict(flags=tstream.FLAG_HAS_RESIDUAL | tstream.FLAG_MEAN_ADJUSTED,
              entropy=1, n_frames=2, height=96, width=128, minval=-1.5,
              maxval=3.25, rmin=-0.125, rmax=0.5, base_levels=5,
              res_levels=3, base_nplanes=22, base_cut=7, base_top=3,
              res_nplanes=13, res_cut=2, res_top=4, base_comp_size=5,
              res_comp_size=3)
    a = tstream.pack_frame_stream(tstream.FrameHeader(**kw), b"12345",
                                  b"abc")
    b = jstream.pack_frame_stream(jstream.FrameHeader(**kw), b"12345",
                                  b"abc")
    assert a == b
    hd, bp, rp = tstream.split_frame_stream(b)
    assert dataclasses.asdict(hd) == dataclasses.asdict(
        jstream.split_frame_stream(a)[0])
    assert (bp, rp) == (b"12345", b"abc")
    for name in ("FLAG_CONST", "FLAG_HAS_RESIDUAL", "FLAG_MEAN_ADJUSTED",
                 "FLAG_BASE_PARTIAL", "FLAG_TEMPORAL", "FLAG_MASKED",
                 "FLAG_LOG_DOMAIN", "FLAG_LOSSLESS", "FRAME_VERSION",
                 "FRAME_HEADER_SIZE"):
        assert getattr(tstream, name) == getattr(jstream, name), name
