"""The port's bench (``ebcc_tpu_torch/bench.py``) against the JAX package's
``bench.py``, on the CPU: the same frames, the same JSON fields, every
section run at 2 x 64 x 128 with its bounds held, and the compression ratio
within 1% of ``ebcc_tpu.encode_chunked``'s on the same frames."""

import ast
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import ebcc_tpu
from ebcc_tpu_torch import bench

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, H, W = 2, 64, 128


def _jax_bench():
    """The root ``bench.py`` as a module (its top level imports only json,
    os, sys, time and numpy)."""
    spec = importlib.util.spec_from_file_location("_jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_result_keys():
    """Every key ``bench.py``'s device bench writes into ``result``: the
    dict literal's and those it sets afterwards."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "result"
                and isinstance(node.value, ast.Dict)):
            keys.update(k.value for k in node.value.keys)
        elif (isinstance(node, ast.Assign)
              and isinstance(node.targets[0], ast.Subscript)
              and isinstance(node.targets[0].value, ast.Name)
              and node.targets[0].value.id == "result"):
            keys.add(node.targets[0].slice.value)
    return keys


@pytest.fixture(scope="module")
def port_run():
    launches = {}
    result = bench.run(device="cpu", frames=N, h=H, w=W, reps=1,
                       launches=launches)
    return result, launches


@pytest.fixture(scope="module")
def jax_cr():
    data = bench.load_frames(N, H, W)
    config = ebcc_tpu.CodecConfig(
        dims=data.shape, base_cr=30,
        residual_mode=ebcc_tpu.RESIDUAL_MAX_ERROR, error=0.5,
        chunk_dims=(1, H, W), zstd_level=3, entropy_backend="zstd")
    return data.nbytes / len(ebcc_tpu.encode_chunked(data, config))


def test_load_frames_bit_equal_to_jax_bench(monkeypatch):
    monkeypatch.delenv("EBCC_ERA5_FRAME", raising=False)
    jb = _jax_bench()
    want = jb.load_frames(3)
    got = bench.load_frames(3)
    assert got.dtype == want.dtype and got.shape == (3, bench.H, bench.W)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (bench.H, bench.W) == (jb.H, jb.W)
    assert bench.BASELINE_PTS_PER_S == jb.BASELINE_PTS_PER_S


def test_json_keys_equal_jax_bench(port_run):
    result, _ = port_run
    want = _jax_result_keys()
    assert len(want) > 40
    assert set(result) == want
    json.loads(json.dumps(result))


def test_every_section_holds_its_bound(port_run):
    result, launches = port_run
    assert set(launches) == {"headline", "host", "cab_host", "proxy",
                             "temporal", "lossless", "native", "window2",
                             "dual", "cab_point", "cab2_point"}
    assert result["frames"] == N
    assert result["error_target"] == 0.5
    assert result["max_error"] <= 0.5
    assert result["device"].startswith("cpu")
    for key, v in result.items():
        if key.startswith("ref_binary") or key.startswith(
                "baseline_point") or key.endswith("vs_ref_binary") or (
                key == "cab_point_cr_vs_ref"):
            assert v is None, key
        elif key not in ("metric", "unit", "device", "max_error",
                         "error_target", "frames"):
            assert isinstance(v, float) and np.isfinite(v) and v > 0, key
    # The temporal chunk codes the 2 frames as one with a delta: never
    # larger than twice the intra streams.
    assert result["temporal_compression_ratio"] > (
        0.5 * result["temporal_intra_compression_ratio"])
    assert result["lossless_compression_ratio"] > 1.0
    # On the CPU the wrappers take the plain versions: no kernel launched.
    assert all(v == 0 for c in launches.values() for v in c.values())


def test_compression_ratio_matches_jax(port_run, jax_cr):
    result, _ = port_run
    assert result["compression_ratio"] == pytest.approx(jax_cr, rel=0.01)


def test_switches_leave_sections_out(monkeypatch):
    for name in ("CAB", "TEMPORAL", "LOSSLESS", "DUAL", "CAB_POINT", "REF"):
        monkeypatch.setenv(f"EBCC_BENCH_{name}", "0")
    launches = {}
    result = bench.run(device="cpu", frames=1, h=32, w=64, reps=1,
                       launches=launches)
    assert set(launches) == {"headline", "host", "proxy", "native",
                             "window2"}
    for key in ("compression_ratio_cab", "temporal_compression_ratio",
                "lossless_compression_ratio", "dual_point_pts_per_s",
                "cab_point_pts_per_s", "cab2_point_compression_ratio"):
        assert result[key] is None, key
    assert result["max_error"] <= 0.5


def test_main_without_card_raises_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
    assert capsys.readouterr().out == ""
