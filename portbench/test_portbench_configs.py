"""A configuration as data: runs and the control read its codec settings,
field profile and decoder from the configuration file, and derive its
bound from the codec settings (``harness.deployment``).

Today's two configurations give, bit for bit, the slabs and the
``CodecConfig`` that the harness gave before it read these keys (the
frozen copies below).  A configuration with the geopotential profile of
``scripts/ab_reference.py``, written only as data in a temporary folder,
runs through ``harness.run_cell`` and is correct, and altered it is not.
Each key reaches the program or the check, and a malformed one stops the
run."""

import dataclasses
import json
import math
import os
import time

import pytest
import torch

import ebcc_tpu_torch as et
from portbench import check, harness, run, traffic

CONFIGS = ["era5_max0.5_cr30", "era5_rel0.01_cr200"]
GRID = (64, 96)
SEED = 2**31 + 2121

# ---- frozen copies of the generator and the codec settings as they were
# before a configuration could state a field profile or codec keywords ----

_COARSE = (24, 46)


def _frozen_make_slabs(seed, n_slabs, frames, h, w, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    base = 260 + 25 * torch.sin(yy / h * math.pi) * torch.cos(
        xx / w * 2 * math.pi)
    drift = 0.3 * torch.arange(frames, dtype=torch.float32,
                               device=device)[:, None, None]
    yi = torch.linspace(0, _COARSE[0] - 1, h, dtype=torch.float64,
                        device=device)
    xi = torch.linspace(0, _COARSE[1] - 1, w, dtype=torch.float64,
                        device=device)
    y0 = yi.to(torch.int64).clamp(0, _COARSE[0] - 2)
    x0 = xi.to(torch.int64).clamp(0, _COARSE[1] - 2)
    fy = (yi - y0).to(torch.float32)[:, None]
    fx = (xi - x0).to(torch.float32)[None, :]
    out = torch.empty((n_slabs, frames, h, w), dtype=torch.float32,
                      device=device)
    for s in range(n_slabs):
        c = torch.randn((frames, *_COARSE), generator=g, device=device)
        noise = torch.randn((frames, h, w), generator=g, device=device)
        smooth = (c[:, y0][:, :, x0] * (1 - fy) * (1 - fx)
                  + c[:, y0][:, :, x0 + 1] * (1 - fy) * fx
                  + c[:, y0 + 1][:, :, x0] * fy * (1 - fx)
                  + c[:, y0 + 1][:, :, x0 + 1] * fy * fx)
        out[s] = base + drift + smooth + 0.02 * noise
    return out


def _frozen_codec_config(config, frames, h, w):
    mode = {"MAX_ERROR": et.RESIDUAL_MAX_ERROR,
            "RELATIVE_ERROR": et.RESIDUAL_RELATIVE_ERROR}[
                config["residual_mode"]]
    chunk = tuple(config["chunk"])
    if chunk[1:] != (h, w):
        chunk = (chunk[0], h, w)
    return et.CodecConfig(dims=(frames, h, w), base_cr=config["base_cr"],
                          residual_mode=mode, error=config["error"],
                          chunk_dims=chunk)


# ---- the geopotential profile of scripts/ab_reference.py ----

G = 9.80665
LEVELS_HPA = [1000, 975, 950, 925, 900, 875]   # the first 6 of its 37


def _std_height(p_hpa):
    """ICAO standard-atmosphere geopotential height, troposphere (every
    level above is at or below 226.32 hPa's pressure: none here)."""
    return 44330.8 * (1.0 - (p_hpa / 1013.25) ** 0.190263)


def _anomaly_std(p_hpa):
    return 400.0 + 4600.0 * (1.0 - p_hpa / 1000.0) ** 1.5


MEANS = [G * _std_height(p) for p in LEVELS_HPA]
STDS = [_anomaly_std(p) for p in LEVELS_HPA]
GEOPOTENTIAL = {
    "name": "era5_geopotential_6lev",
    "source": "https://github.com/spcl/EBCC compress_ebcc.py:16-22: ERA5 "
              "geopotential, absolute error 10, base_cr 30",
    "grid": [721, 1440],
    "chunk": [1, 721, 1440],
    "base_cr": 30,
    "residual_mode": "MAX_ERROR",
    "error": 10,
    "field": {"mean": MEANS, "std": STDS},
    "env": {"EBCC_ENCODE_BACKEND": "device", "EBCC_DECODE_BACKEND": "device"},
    "reference": "portbench/reference.py",
}


def _mix(op, frames):
    return {"op": op, "frames": frames, "pool": 2, "clients": 1,
            "warmup_requests": 1, "check_requests": 4, "trace_requests": 1}


_load_json = traffic.load_json      # the repository's files, unpatched


def _config(name, **change):
    return {**_load_json("configs", name), **change}


@pytest.fixture
def room(tmp_path, monkeypatch):
    """A folder of configurations and mixes that the harness reads in
    place of its own (``traffic.load_json`` patched to it), and cells of
    them added to the benchmark's entries; the environment that a run
    sets is restored."""
    saved = dict(os.environ)
    real_bench = harness.load_benchmark()
    cells = []

    def load_json(kind, name):
        with open(tmp_path / kind / f"{name}.json") as f:
            return json.load(f)

    def load_benchmark():
        return {**real_bench, "workloads": real_bench["workloads"] + cells}

    def add(config, op="write", frames=8):
        name = f"room{len(cells)}"
        for kind, body in (("configs", config), ("mixes", _mix(op, frames))):
            (tmp_path / kind).mkdir(exist_ok=True)
            (tmp_path / kind / f"{name}.json").write_text(json.dumps(body))
        cell = f"{name}.{op}"
        cells.append({"name": cell, "config": name, "traffic": name,
                      "chips": 1, "why": "a test's cell"})
        return cell

    monkeypatch.setattr(traffic, "load_json", load_json)
    monkeypatch.setattr(harness, "load_benchmark", load_benchmark)
    yield add
    os.environ.clear()
    os.environ.update(saved)


def _run(cell):
    return harness.run_cell(cell, SEED, 0.3, False, time.perf_counter(),
                            device="cpu", grid=GRID, pool=2)


def _alter(monkeypatch, op, by):
    """One value of every answer altered: at the source of a write, in
    the decoded array of a read."""
    if op == "write":
        real_enc = et.encode_chunked

        def encode(data, config, *a, **kw):
            data = data.copy()
            data[0, 5, 7] += by
            return real_enc(data, config, *a, **kw)
        monkeypatch.setattr(et, "encode_chunked", encode)
        return
    real_dec = et.decode_chunked

    def decode(buf, *a, **kw):
        out = real_dec(buf, *a, **kw)
        out[0, 5, 7] += by
        return out
    monkeypatch.setattr(et, "decode_chunked", decode)


# ---- today's configurations read as before ----

@pytest.mark.parametrize("grid", [(40, 64), (64, 96)])
@pytest.mark.parametrize("name", CONFIGS)
def test_existing_configuration_reads_as_before(name, grid):
    config = traffic.load_json("configs", name)
    frames = traffic.load_json("mixes", "write8")["frames"]
    h, w = grid
    dep = harness.deployment(et, config, frames, grid)
    assert dep.field is None
    assert torch.equal(
        traffic.make_slabs(SEED, 3, frames, h, w, "cpu", dep.field),
        _frozen_make_slabs(SEED, 3, frames, h, w, "cpu"))
    assert dataclasses.asdict(dep.codec) == dataclasses.asdict(
        _frozen_codec_config(config, frames, h, w))
    kind = {"MAX_ERROR": "max_abs", "RELATIVE_ERROR": "chunk_relative"}[
        config["residual_mode"]]
    assert dep.bound == check.Bound(kind, config["error"], 4e-6)
    assert dep.bound.limits == check.LIMITS
    assert os.path.samefile(dep.decoder.__file__,
                            os.path.join(harness.HERE, "reference.py"))


# ---- the geopotential profile, written only as data ----

@pytest.mark.parametrize("op", ["write", "read"])
def test_geopotential_profile_runs_from_files_alone(room, monkeypatch, op):
    made = []
    real = traffic.make_slabs

    def kept(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]
    monkeypatch.setattr(traffic, "make_slabs", kept)
    r = _run(room(GEOPOTENTIAL, op, len(LEVELS_HPA)))
    assert r["correct"] is True, r["checks"]
    assert list(r["checks"]) == (["err_over_bound"] if op == "write"
                                 else ["err_over_bound", "gap_over_range"])
    pool = made[0].to(torch.float64)
    assert pool.shape == (2, len(LEVELS_HPA), *GRID)
    want_mean = torch.tensor(MEANS, dtype=torch.float64)
    want_std = torch.tensor(STDS, dtype=torch.float64)
    for slab in pool:
        mean = slab.mean(dim=(1, 2))
        std = slab.std(dim=(1, 2), correction=0)
        assert ((mean - want_mean).abs() <= 0.01 * want_mean).all()
        assert ((std - want_std).abs() <= 0.01 * want_std).all()


@pytest.mark.parametrize("op", ["write", "read"])
def test_geopotential_altered_answer_is_not_correct(room, monkeypatch, op):
    _alter(monkeypatch, op, 3 * GEOPOTENTIAL["error"])
    r = _run(room(GEOPOTENTIAL, op, len(LEVELS_HPA)))
    assert r["correct"] is False, r["checks"]


def test_field_profile_broadcasts_one_entry():
    field = harness.field_profile({"field": {"mean": [5.0e4],
                                             "std": STDS[:3]}}, 3)
    assert field == ([5.0e4] * 3, STDS[:3])
    pool = traffic.make_slabs(SEED, 2, 3, 40, 64, "cpu", field)
    assert torch.allclose(pool.to(torch.float64).mean(dim=(2, 3)),
                          torch.full((2, 3), 5.0e4, dtype=torch.float64))


# ---- each key reaches the program or the check ----

@pytest.mark.parametrize("key,value", [
    ("temporal", True), ("zstd_level", 3), ("base_levels", 4),
    ("residual_levels", 4), ("entropy_backend", "auto"),
    ("allow_nan", True)])
def test_codec_key_reaches_codec_config(key, value):
    config = _config(CONFIGS[0], codec={key: value})
    cfg = harness.deployment(et, config, 8, GRID).codec
    want = dataclasses.replace(
        _frozen_codec_config(config, 8, *GRID), **{key: value})
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", ["NONE", "MAX_ERROR", "RELATIVE_ERROR",
                                  "POINTWISE_RELATIVE_ERROR", "LOSSLESS"])
def test_residual_mode_by_the_name_of_its_constant(name):
    config = _config(CONFIGS[0], residual_mode=name, error=0.01)
    cfg = harness.codec_config(et, config, 8, *GRID, grid=GRID)
    assert cfg.residual_mode == getattr(et, f"RESIDUAL_{name}")


def test_codec_key_reaches_the_encoder_in_a_run(room, monkeypatch):
    seen = []
    real = et.encode_chunked

    def spy(data, config, *a, **kw):
        seen.append(config.zstd_level)
        return real(data, config, *a, **kw)
    monkeypatch.setattr(et, "encode_chunked", spy)
    r = _run(room(_config(CONFIGS[0], codec={"zstd_level": 3})))
    assert r["correct"] is True, r["checks"]
    assert seen and set(seen) == {3}


@pytest.mark.parametrize("change,kind,value,eps", [
    ({}, "max_abs", 0.5, 4e-6),
    ({"residual_mode": "RELATIVE_ERROR", "error": 0.01}, "chunk_relative",
     0.01, 4e-6),
    ({"codec": {"temporal": True}}, "max_abs", 0.5, 4e-6),
    ({"codec": {"temporal": True}, "chunk": [4, 721, 1440]}, "max_abs",
     0.5, 2 * 4 * 4e-6),
    ({"chunk": [4, 721, 1440]}, "max_abs", 0.5, 4e-6),
], ids=lambda c: json.dumps(c)[:40] if isinstance(c, dict) else None)
def test_bound_follows_the_codec_settings(change, kind, value, eps):
    """docs/FORMAT.md: the error under the mode on every sample; decoders
    apart by 4e-6 of the range, by 2 * T * 4e-6 in a temporal chunk of T
    frames (a one-frame chunk has no deltas)."""
    dep = harness.deployment(et, _config(CONFIGS[0], **change), 8, GRID)
    assert dep.bound == check.Bound(kind, value, eps)
    assert dep.bound.limits == {"err_over_bound": 1.0,
                                "gap_over_range": eps}


@pytest.mark.parametrize("chunk,grid,want", [
    ([1, 721, 1440], None, (1, 721, 1440)),
    ([1, 256, 256], None, (1, 256, 256)),
    ([8, 721, 1440], None, (8, 721, 1440)),
    ([1, 721, 1440], GRID, (1, *GRID)),
    ([1, 256, 256], GRID, (1, *GRID)),
    ([1, 32, 48], GRID, (1, 32, 48)),
])
def test_chunk_is_the_configurations_own(chunk, grid, want):
    """A tiled chunk stays tiled at the configuration's grid; only a
    test's smaller grid rewrites it, to span or fit that grid."""
    dep = harness.deployment(et, _config(CONFIGS[0], chunk=chunk), 8, grid)
    assert dep.codec.chunk_dims == want


@pytest.mark.parametrize("chunk", [[1, 722, 1440], [1, 721, 1441],
                                   [9, 721, 1440], [0, 721, 1440],
                                   [1, 721], [1.0, 721, 1440]])
def test_chunk_that_does_not_fit_is_a_run_error(chunk):
    with pytest.raises(harness.RunError, match="chunk"):
        harness.deployment(et, _config(CONFIGS[0], chunk=chunk), 8)


@pytest.fixture
def decoders(tmp_path, monkeypatch):
    """A benchmark folder of decoder files (``harness.DECODER_DIR``
    patched to it): writes one and gives the path a configuration names."""
    folder = tmp_path / "portbench"
    folder.mkdir()
    monkeypatch.setattr(harness, "DECODER_DIR", str(folder))

    def write(name, text):
        (folder / name).write_text(text)
        return f"portbench/{name}"
    return write


_REFUSING = ("class FormatError(Exception):\n"
             "    pass\n\n\n"
             "def decode_container(buf, device='cpu', dtype=None):\n"
             "    raise FormatError('refused')\n")


def test_decoder_file_that_refuses_makes_correct_false(room, decoders):
    rel = decoders("refusing_decoder.py", _REFUSING)
    r = _run(room(_config(CONFIGS[0], reference=rel)))
    assert r["correct"] is False
    assert r["checks"]["format"]["value"] == "FormatError: refused"


@pytest.mark.parametrize("head", [
    "import ebcc_tpu_torch\n",
    "from ebcc_tpu_torch.core import codec\n",
    "import jax.numpy as jnp\n",
    "from ebcc_tpu import api\n",
    "def helper():\n    import ebcc_tpu_torch as et\n",
    "from . import harness\n",
    "from .control import readings\n",
    "from portbench import harness\n",
    "from .. import ebcc_tpu_torch\n",
])
def test_decoder_file_that_imports_the_program_is_refused(decoders, head):
    """Read from the source, with the modules of this package that the
    file imports: the decoder that decides correct takes nothing of the
    program, nor of the JAX package."""
    rel = decoders("leaky_decoder.py", head + _REFUSING)
    with pytest.raises(harness.RunError, match="imports"):
        harness.deployment(et, _config(CONFIGS[0], reference=rel), 8, GRID)


@pytest.mark.parametrize("rel", ["portbench/../ebcc_tpu_torch/__init__.py",
                                 "ebcc_tpu_torch/__init__.py",
                                 os.path.abspath(os.path.join(
                                     harness.HERE, "reference.py")), 7])
def test_decoder_path_outside_the_benchmark_is_refused(rel):
    with pytest.raises(harness.RunError, match="inside"):
        harness.deployment(et, _config(CONFIGS[0], reference=rel), 8, GRID)


def test_every_configurations_decoder_imports_nothing_of_the_program():
    for path in sorted(os.listdir(os.path.join(harness.HERE, "configs"))):
        config = traffic.load_json("configs", path[:-len(".json")])
        mod = harness.load_decoder(config)
        assert harness.program_imports(mod.__file__) == [], path


# ---- malformed configurations stop the run ----

@pytest.mark.parametrize("change", [
    {"codec": {"zstd_levl": 3}},
    {"codec": {"chunk_dims": [1, 64, 96]}},
    {"codec": {"error": 1.0}},
    {"codec": {"entropy_backend": "lz4"}},
    {"codec": ["temporal"]},
    {"residual_mode": "MAX_ERRORS"},
    {"residual_mode": "NONE"},
    {"residual_mode": "LOSSLESS"},
    {"residual_mode": "POINTWISE_RELATIVE_ERROR", "error": 0.01},
    {"error": 0},
    {"field": {"mean": [1.0, 2.0], "std": [1.0]}},
    {"field": {"mean": [1.0], "std": [1.0], "min": [0.0]}},
    {"field": {"mean": [1.0], "std": ["1"]}},
    {"feild": {"mean": [1.0], "std": [1.0]}},
    {"bound": {"kind": "max_abs", "value": 1.0}},
    {"reference": "portbench/no_such_decoder.py"},
    {"reference": "portbench/check.py"},
], ids=lambda c: json.dumps(c)[:40])
def test_malformed_configuration_is_a_run_error(change):
    with pytest.raises(harness.RunError):
        harness.deployment(et, _config(CONFIGS[0], **change), 8, GRID)


@pytest.mark.parametrize("key", harness.REQUIRED_KEYS)
def test_configuration_without_a_required_key_is_a_run_error(key):
    config = _config(CONFIGS[0])
    del config[key]
    with pytest.raises(harness.RunError, match=key):
        harness.deployment(et, config, 8)


@pytest.mark.parametrize("change,said", [
    ({"codec": {"zstd_levl": 3}}, "zstd_levl"),
    ({"residual_mode": "MAX_ERRORS"}, "MAX_ERRORS"),
    ({"field": {"mean": [1.0, 2.0], "std": [1.0]}}, "field.mean"),
    ({"bound": {"kind": "max_abs", "value": 1.0}}, "bound"),
    ({"chunk": [1, 721, 2000]}, "chunk"),
])
def test_run_exits_2_with_a_message(room, capsys, change, said):
    cell = room(_config(CONFIGS[0], **change))
    assert run.main(["--workload", cell, "--seed", str(SEED),
                     "--seconds", "0.1"]) == 2
    err = capsys.readouterr().err
    assert "no result" in err and said in err
