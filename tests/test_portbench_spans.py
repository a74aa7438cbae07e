"""Every cell of ``BENCHMARK.json`` traced on the CPU at a small shape: each
per-layer metric that the program reports (source ``program_span`` or
``program_counter``) and that the benchmark lists for the cell is in the
result line, and each span it reads opened in the window."""

import importlib.util
import os
import pathlib
import time

import pytest

from ebcc_tpu_torch.utils import timing
from portbench import harness, traffic

METRICS = pathlib.Path(harness.HERE) / "metrics"
CELLS = [c["name"] for c in harness.load_benchmark()["workloads"]]
PROGRAM = ("program_span", "program_counter")
# Spans read by the metric readers that do not name them in ``SPANS``.
READS = {"enc_device_thread_s_per_mpt": ("enc: device",),
         "assemble_zstd_s_per_mpt": ("assemble+zstd",),
         "dec_parse_s_per_mpt": ("dec: entropy decode",
                                 "dec: unpack planes")}
# Metrics whose spans do not open in a cell: the read cell decodes each
# request in one batch, on the request thread, so it waits for no worker
# and the metric reads 0.0.
READ_ZERO = {("max0.5_cr30.read8", "dec_worker_wait_s_per_mpt")}
# Metrics of what only a CUDA tensor's encode makes, with the counters they
# read: on the CPU the encode core runs eagerly and builds no CUDA graph, so
# the counters never open and the metric is left out of the line.
CARD_ONLY = {"enc_core_graph_pct": ("core: graph replays",
                                    "core: graph captures")}


def spans_read(name: str) -> tuple:
    spec = importlib.util.spec_from_file_location(
        f"spans_of_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, "SPANS", READS.get(name, ()))


@pytest.fixture
def traced_cell(monkeypatch):
    """Spans on (``EBCC_TIMING`` is read at import), one request in the
    profiled stretch (the profiler slows the CPU's encode twentyfold), the
    run each reader read kept, and the environment that the harness sets
    restored."""
    saved = dict(os.environ)
    monkeypatch.setattr(timing, "ENABLED", True)
    load_json = traffic.load_json

    def one_traced(kind, name):
        out = load_json(kind, name)
        return {**out, "trace_requests": 1} if kind == "mixes" else out
    monkeypatch.setattr(traffic, "load_json", one_traced)
    runs = []
    real = harness.reader

    def spy(name):
        read = real(name)

        def kept(run):
            runs.append(run)
            return read(run)
        return kept
    monkeypatch.setattr(harness, "reader", spy)
    yield runs
    os.environ.clear()
    os.environ.update(saved)
    timing.reset_stats()


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_reports_every_program_metric(cell, traced_cell):
    r = harness.run_cell(cell, 2**31 + 4321, 0.3, True, time.perf_counter(),
                         device="cpu", grid=(64, 96), pool=2)
    assert r["correct"] is True, r["checks"]
    listed = [m["name"] for m in harness.load_benchmark()["per_layer"]
              if m["source"] in PROGRAM and harness.applies(m, cell)]
    assert len(listed) >= 5
    assert not [n for n in listed
                if (n in r["metrics"]) == (n in CARD_ONLY)]
    stats = traced_cell[0].stats
    for name in listed:
        if name in CARD_ONLY:
            assert not any(c in stats for c in CARD_ONLY[name]), name
            continue
        spans = spans_read(name)
        if (cell, name) in READ_ZERO:
            assert not any(stats.get(s, (0,))[0] for s in spans), name
            assert r["metrics"][name]["value"] == 0.0, name
            continue
        if spans:
            assert any(stats.get(s, (0,))[0] >= 1 for s in spans), \
                (name, spans)
        if name.endswith("_s_per_mpt"):
            assert r["metrics"][name]["value"] > 0, name


def test_span_metrics_leave_a_program_without_self_seconds_out():
    run = harness.Run(op="read", frames=8, points_per_request=10**6,
                      setup_s=1.0, latencies=[0.1, 0.1], window_s=0.2)
    names = ("link_up_s_per_mpt", "link_down_s_per_mpt",
             "device_wait_s_per_mpt", "dec_worker_wait_s_per_mpt",
             "request_self_s_per_mpt")
    for name in names:                   # untraced
        assert harness.reader(name)(run) is None
    run.stats = {"dec: entropy decode": [3, 0.5]}    # the old table
    for name in names:
        assert harness.reader(name)(run) is None
    run.stats = {"request: decode_chunked": [2, 0.25, 0.125],
                 "link: down": [2, 0.05, 0.05]}
    assert harness.reader("link_down_s_per_mpt")(run) == 0.025
    assert harness.reader("request_self_s_per_mpt")(run) == 0.0625
    assert harness.reader("link_up_s_per_mpt")(run) == 0.0   # not opened
