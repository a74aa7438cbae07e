"""The port's measurement scripts (``scripts/torch_*.py``) against the JAX
package's (``scripts/stream_bench.py``, ``scaling_bench.py``,
``compare_targets.py``, ``attribute_roundtrip.py``), on the CPU: the same
inputs, the same JSON fields and table, each script run end to end at a
small shape."""

import ast
import importlib.util
import json
import pathlib
import tempfile

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"


def _load(name, monkeypatch=None, **env):
    """A script as a module (its ``main`` not run), with ``env`` set while
    its top level runs."""
    if monkeypatch is not None:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_keys(name):
    """The keys of the dict literals passed to ``json.dumps`` in a
    script's source."""
    tree = ast.parse((SCRIPTS / f"{name}.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            keys.update(k.value for k in node.args[0].keys
                        if isinstance(k, ast.Constant))
    return keys


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_json_fields_cover_the_jax_scripts():
    for name in ("stream_bench", "scaling_bench", "attribute_roundtrip"):
        want = _json_keys(name)
        assert want, name
        assert want <= _json_keys(f"torch_{name}"), name


def test_stream_cube_equals_jax_script(tmp_path, monkeypatch):
    monkeypatch.delenv("EBCC_ERA5_FRAME", raising=False)
    monkeypatch.syspath_prepend(str(ROOT))
    jax_mod = _load("stream_bench")
    port = _load("torch_stream_bench")
    want = jax_mod.build_cube(str(tmp_path / "j.npy"), 2, 2)
    got = port.build_cube(str(tmp_path / "p.npy"), 2, 2)
    assert np.array_equal(np.asarray(got).view(np.uint32),
                          np.asarray(want).view(np.uint32))


def _small_bench_frames(monkeypatch, h, w):
    from ebcc_tpu_torch import bench
    monkeypatch.setattr(bench, "H", h)
    monkeypatch.setattr(bench, "W", w)


def test_stream_bench_runs(tmp_path, monkeypatch, capsys):
    _small_bench_frames(monkeypatch, 64, 128)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    port = _load("torch_stream_bench")
    assert port.main(["--levels", "2", "--hours", "3", "--device", "cpu"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["cube"] == [6, 64, 128]
    assert out["max_error"] <= 0.5
    assert out["streamed_pts_per_s"] > 0 and out["compression_ratio"] > 1
    assert list(tmp_path.iterdir()) == []      # the cube is removed


def test_scaling_frames_equal_jax_script(monkeypatch):
    env = dict(EBCC_SCALE_H="48", EBCC_SCALE_W="80")
    jax_mod = _load("scaling_bench", monkeypatch, **env)
    port = _load("torch_scaling_bench", monkeypatch, **env)
    assert (port.H, port.W) == (48, 80)
    np.testing.assert_array_equal(port.frames(3), jax_mod.frames(3))


def test_scaling_bench_on_cpu_mesh(monkeypatch, capsys):
    port = _load("torch_scaling_bench", monkeypatch, EBCC_SCALE_H="48",
                 EBCC_SCALE_W="80", EBCC_SCALE_FRAMES_PER_DEV="2",
                 EBCC_SCALE_REPS="1")
    assert port.main(["--cpu-mesh", "2"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["platform"] == "cpu"
    assert [r["devices"] for r in out["rows"]] == [1, 2]
    assert all(r["byte_identical"] and r["pts_per_s"] > 0
               for r in out["rows"])


def test_compare_targets_table(monkeypatch, capsys):
    port = _load("torch_compare_targets")
    monkeypatch.setattr(port, "H", 48)
    monkeypatch.setattr(port, "W", 96)
    assert port.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    header = "| abs target | rel target | backend | bytes | CR | max err | "
    assert header + "rmse | encode s |" in lines
    jax_src = (SCRIPTS / "compare_targets.py").read_text()
    assert header in jax_src and "rmse | encode s |" in jax_src
    rows = [ln.split("|")[1:-1] for ln in lines if ln.startswith("| ")
            and not ln.startswith("| abs")]
    assert len(rows) == 12
    for row in rows:
        target, maxerr = float(row[0]), float(row[5])
        assert maxerr <= target


def test_compare_targets_frame_equals_jax_script(monkeypatch):
    monkeypatch.delenv("EBCC_ERA5_FRAME", raising=False)
    tree = ast.parse((SCRIPTS / "compare_targets.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "load_frame")
    scope = {"os": __import__("os"), "np": np}
    exec(compile(ast.Module([fn], []), "compare_targets.py", "exec"), scope)
    port = _load("torch_compare_targets")
    np.testing.assert_array_equal(port.load_frame(), scope["load_frame"]())


@pytest.mark.parametrize("mode", ["max_error", "temporal"])
def test_attribute_roundtrip_runs(mode, tmp_path, monkeypatch, capsys):
    from ebcc_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "ENABLED", True)
    monkeypatch.syspath_prepend(str(ROOT))
    _small_bench_frames(monkeypatch, 48, 96)
    port = _load("torch_attribute_roundtrip", monkeypatch,
                 EBCC_BENCH_FRAMES="3", EBCC_BENCH_SUBBATCH="2",
                 EBCC_BENCH_REPS="1")
    out_file = tmp_path / "attr.json"
    assert port.main(["--device", "cpu", "--mode", mode,
                      "--out", str(out_file)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert json.loads(out_file.read_text()) == out
    temporal = mode == "temporal"
    assert out["mode"] == mode and out["frames_per_chunk"] == (
        3 if temporal else 1)
    assert len(out["wall_per_rep_s"]) == 1 and out["pts_per_s"] > 0
    assert out["bytes_up_per_rep"] > 0 and out["bytes_down_per_rep"] > 0
    assert "assemble+zstd" in out["stages"]
    assert out["profile"] is None
    assert [p["chunks"] for p in out["sub_batches"]] == (
        [[0, 1]] if temporal else [[0, 2], [2, 3]])
    assert all(p["nnz"] > 0 and p["assemble_host_s"] > 0
               for p in out["sub_batches"])


@pytest.mark.parametrize("name", ["torch_stream_bench",
                                  "torch_scaling_bench",
                                  "torch_compare_targets",
                                  "torch_attribute_roundtrip"])
def test_scripts_default_to_the_card(name, monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = _load(name)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.main([])
    assert capsys.readouterr().out == ""
