"""The harness on the CPU at a small shape: the closed loop's arithmetic,
whole runs (the look for a card skipped), the faults that must come out
not correct, and that nothing here imports JAX, the JAX package or the old
bench."""

import ast
import json
import math
import os
import time

import numpy as np
import pytest

import ebcc_tpu_torch as et
from portbench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GRID = (64, 96)
CELLS = ["max0.5_cr30.write8", "rel0.01_cr200.write8", "max0.5_cr30.read8"]


def _run(workload, trace=False, seconds=0.3):
    return harness.run_cell(workload, 2**31 + 99, seconds, trace,
                            time.perf_counter(), device="cpu", grid=GRID,
                            pool=2)


def test_closed_loop_arithmetic():
    run = harness.Run(op="write", frames=8, points_per_request=1000,
                      setup_s=2.5, latencies=[0.01 * (i + 1)
                                              for i in range(40)],
                      window_s=8.0, raw_bytes=4000 * 40, out_bytes=400)
    assert run.points == 40_000
    assert harness.reader("pts_per_s")(run) == 5000.0
    # nearest rank: ceil(0.95 * 40) = 38th smallest = 0.38 s
    assert math.isclose(harness.reader("request_p95_ms")(run), 380.0)
    assert harness.reader("compression_ratio")(run) == 400.0
    assert harness.reader("setup_s")(run) == 2.5
    run.op = "read"
    assert harness.reader("compression_ratio")(run) is None


def test_p95_of_one_request():
    run = harness.Run(op="read", frames=1, points_per_request=1,
                      setup_s=0.0, latencies=[0.2], window_s=0.2)
    assert math.isclose(harness.reader("request_p95_ms")(run), 200.0)


@pytest.mark.parametrize("workload", CELLS)
def test_whole_run_is_correct(workload):
    r = _run(workload)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    names = set(r["metrics"])
    assert {"pts_per_s", "setup_s"} <= names
    write = workload.endswith("write8")
    assert ("compression_ratio" in names) == write
    assert ("request_p95_ms" in names) == write
    assert list(r)[-1] == "checks"


def test_traced_run_reports_per_layer():
    r = _run("max0.5_cr30.read8", trace=True)
    assert r["correct"] is True
    assert "link_bytes_per_point" in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _alter_answer(monkeypatch, op):
    if op == "write":
        real = et.encode_chunked

        def broken(data, config, *a, **kw):
            data = np.array(data, copy=True)
            data[0, 5, 7] += 3.0          # one value altered at the source
            return real(data, config, *a, **kw)
        monkeypatch.setattr(et, "encode_chunked", broken)
    else:
        real = et.decode_chunked

        def broken(buf, *a, **kw):
            out = real(buf, *a, **kw)
            out[0, 5, 7] += 0.01          # one value altered in the answer
            return out
        monkeypatch.setattr(et, "decode_chunked", broken)


def _drop_half(monkeypatch, op):
    if op == "write":
        real = et.encode_chunked

        def broken(data, config, *a, **kw):
            half = data.shape[0] // 2     # half of the slab's frames
            cfg = et.CodecConfig(dims=(half, *data.shape[1:]),
                                 base_cr=config.base_cr,
                                 residual_mode=config.residual_mode,
                                 error=config.error,
                                 chunk_dims=config.chunk_dims)
            return real(np.ascontiguousarray(data[:half]), cfg, *a, **kw)
        monkeypatch.setattr(et, "encode_chunked", broken)
    else:
        real = et.decode_chunked

        def broken(buf, *a, **kw):
            out = real(buf, *a, **kw)
            out[out.shape[0] // 2:] = 0.0  # half of the frames left out
            return out
        monkeypatch.setattr(et, "decode_chunked", broken)


@pytest.mark.parametrize("fault", [_alter_answer, _drop_half])
@pytest.mark.parametrize("workload", ["max0.5_cr30.write8",
                                      "max0.5_cr30.read8"])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch, "write" if workload.endswith("write8") else "read")
    r = _run(workload)
    assert r["correct"] is False, r["checks"]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


def _py_files():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ebcc_tpu_torch is not ebcc_tpu."""
    bad = {"jax", "jaxlib", "flax", "ebcc_tpu", "bench"}
    for path in _py_files():
        for name in _imports(path):
            assert name.split(".")[0] not in bad, (path, name)
            assert name != "ebcc_tpu_torch.bench", (path, name)


def test_yardstick_imports_nothing_of_the_program():
    """The fixed files, and every decoder file a configuration names."""
    decoders = set()
    for f in os.listdir(os.path.join(HERE, "configs")):
        with open(os.path.join(HERE, "configs", f)) as fh:
            rel = json.load(fh).get("reference", "portbench/reference.py")
        decoders.add(os.path.relpath(os.path.join(ROOT, rel), HERE))
    for f in sorted({"reference.py", "zstd_ref.py", "check.py",
                     "roofline.py", "traffic.py", "tracing.py"} | decoders):
        for name in _imports(os.path.join(HERE, f)):
            assert name.split(".")[0] != "ebcc_tpu_torch", (f, name)
