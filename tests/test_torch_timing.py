"""The port's stage spans (``ebcc_tpu_torch.utils.timing``) on the CPU: the
span tree across the pipelines' worker threads, self time, the shape of
``STATS``, constant span names, the link spans around every counted byte
(``core/transfer.py``), nothing recorded or waited for with spans off, and
the spans in ``utils.profiling.trace``'s Chrome trace on its clock."""

import ast
import glob
import json
import os
import pathlib
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import ebcc_tpu_torch as et
from ebcc_tpu_torch.core import codec, transfer
from ebcc_tpu_torch.utils import profiling, timing

PACKAGE = pathlib.Path(et.__file__).parent


def frames(n=4, h=64, w=96, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([20 * np.sin(yy / 9 + i) * np.cos(xx / 13)
                     + 0.3 * rng.normal(size=(h, w))
                     for i in range(n)]).astype(np.float32)


def config(x, **kw):
    kw = {"residual_mode": et.RESIDUAL_MAX_ERROR, "error": 0.5, **kw}
    return et.CodecConfig(dims=x.shape, base_cr=30,
                          chunk_dims=(1, *x.shape[1:]), **kw)


@pytest.fixture
def spans_on(monkeypatch):
    monkeypatch.setattr(timing, "ENABLED", True)
    timing.reset_stats()
    yield
    timing.reset_stats()


def by_id(records):
    return {r[1]: r for r in records}


def test_worker_span_has_the_request_span_as_parent(spans_on):
    x = frames()
    cfg = config(x)
    with timing.recording() as recs:
        blob = et.encode_chunked(x, cfg, max_batch=2, device="cpu")
        out = et.decode_chunked(blob, max_batch=2, device="cpu")
    assert np.abs(out - x).max() <= 0.5
    spans = by_id(recs)
    main = threading.get_native_id()
    for request, inner in (("request: encode_chunked", "enc: device"),
                           ("request: decode_chunked",
                            "dec: entropy decode")):
        root = next(r for r in recs if r[0] == request)
        assert root[2] is None and root[3] == main
        workers = [r for r in recs if r[0] == inner]
        assert len(workers) == 2
        for r in workers:
            assert r[3] != main, r          # on a pipeline worker
            assert spans[r[2]] == root      # its parent is the request
            assert root[4] <= r[4] and r[5] <= root[5]


def test_self_time_is_wall_less_same_thread_children(spans_on):
    with timing.recording() as recs:
        with timing.stage("outer"):
            time.sleep(0.002)
            with timing.stage("inner"):
                time.sleep(0.003)
            with ThreadPoolExecutor(1) as pool:
                timing.submit(pool, time.sleep, 0.001).result()
                timing.submit(pool, _nap_in_span).result()
    outer = next(r for r in recs if r[0] == "outer")
    inner = next(r for r in recs if r[0] == "inner")
    other = next(r for r in recs if r[0] == "other thread")
    assert inner[2] == outer[1] and other[2] == outer[1]
    assert other[3] != outer[3]
    wall = (outer[5] - outer[4]) / 1e9
    inner_wall = (inner[5] - inner[4]) / 1e9
    # The child on another thread runs in parallel: not subtracted.
    assert outer[6] == pytest.approx(wall - inner_wall, abs=1e-9)
    assert inner[6] == pytest.approx(inner_wall, abs=1e-9)
    e = timing.STATS["outer"]
    assert len(e) == 3
    assert e[0] == 1                                  # count
    assert e[1] == pytest.approx(wall, abs=1e-9)      # thread seconds
    assert e[2] == pytest.approx(outer[6], abs=1e-12)  # self seconds
    snap = timing.snapshot()["outer"]
    assert set(snap) == {"count", "total_s", "self_s"}
    assert snap["self_s"] < snap["total_s"]


def test_concurrent_spans_lose_no_update(spans_on):
    """More workers than cores, a short switch interval: every span is
    counted once, the request's self time keeps its workers' time, and
    each worker's parent is the request."""
    n_workers, per_task = 4 * (os.cpu_count() or 1), 50

    def task():
        for _ in range(per_task):
            with timing.stage("leaf"):
                pass
        return threading.get_native_id()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timing.recording() as recs:
            with timing.stage("root"):
                with ThreadPoolExecutor(n_workers) as pool:
                    futs = [timing.submit(pool, task)
                            for _ in range(n_workers)]
                    for f in futs:
                        f.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    root = next(r for r in recs if r[0] == "root")
    leaves = [r for r in recs if r[0] == "leaf"]
    assert timing.STATS["leaf"][0] == len(leaves) == n_workers * per_task
    assert {r[2] for r in leaves} == {root[1]}
    assert root[6] == pytest.approx((root[5] - root[4]) / 1e9, abs=1e-9)


def _nap_in_span():
    with timing.stage("other thread"):
        time.sleep(0.004)


def _stage_calls(path, called="stage"):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.id if isinstance(f, ast.Name) else getattr(f, "attr",
                                                                None)
            if name == called:
                yield node


def _counter_calls(path):
    return (n for n in _stage_calls(path, "count")
            if ast.unparse(n.func) == "timing.count")


def test_span_names_are_constants():
    calls = 0
    for path in PACKAGE.rglob("*.py"):
        if path.name == "timing.py":
            continue
        for node in _stage_calls(path):
            calls += 1
            where = f"{path.name}:{node.lineno}"
            # One positional string literal: the harness's mirror of
            # core/codec.py's ``stage`` takes exactly that.
            assert len(node.args) == 1 and not node.keywords, where
            arg = node.args[0]
            assert isinstance(arg, ast.Constant), where
            assert isinstance(arg.value, str), where
    assert calls > 20


def test_names_in_stats_are_the_literals(spans_on):
    x = frames(2)
    et.decode_chunked(et.encode_chunked(x, config(x), device="cpu"),
                      device="cpu")
    literals = {n.args[0].value for p in PACKAGE.rglob("*.py")
                if p.name != "timing.py"
                for calls in (_stage_calls(p), _counter_calls(p))
                for n in calls}
    assert timing.STATS and set(timing.STATS) <= literals
    assert not hasattr(timing, "_DIGITS")


def test_counter_names_are_constants():
    names = set()
    for path in PACKAGE.rglob("*.py"):
        for node in _counter_calls(path):
            where = f"{path.name}:{node.lineno}"
            assert len(node.args) == 2 and not node.keywords, where
            assert isinstance(node.args[0], ast.Constant), where
            assert isinstance(node.args[0].value, str), where
            names.add(node.args[0].value)
    assert names == {"exch: compact pairs", "exch: index pairs",
                     "core: graph captures", "core: graph replays"}


def test_counter_entry_is_additions_and_sum(spans_on):
    with timing.stage("span"):
        timing.count("counted", 5)
        timing.count("counted", 7)
    assert timing.STATS["counted"] == [2, 12]
    assert set(timing.snapshot()) == {"span"}    # counters left out
    timing.ENABLED = False
    timing.count("counted", 100)
    timing.count("not counted", 1)
    assert timing.STATS["counted"] == [2, 12]
    assert "not counted" not in timing.STATS


def test_spans_off_record_nothing_and_wait_for_nothing(monkeypatch):
    monkeypatch.setattr(timing, "ENABLED", False)
    timing.reset_stats()
    waits = []
    monkeypatch.setattr(transfer, "_device_wait",
                        lambda device: waits.append(device))
    seen = []
    real_count = transfer.count_up
    monkeypatch.setattr(transfer, "count_up", lambda n: (
        seen.append(timing.current()), real_count(n)))
    x = frames(2)
    blob = et.encode_chunked(x, config(x), max_batch=1, device="cpu")
    et.decode_chunked(blob, max_batch=1, device="cpu")
    assert timing.STATS == {}
    assert waits == []
    assert seen and all(s is None for s in seen)
    with ThreadPoolExecutor(1) as pool:
        with timing.stage("not opened"):
            assert timing.current() is None
            assert timing.submit(pool, timing.current).result() is None


def test_submit_ahead_keeps_order_and_depth(spans_on):
    """Results come back in item order; with a depth, at most that many
    calls are in flight, the next item starts only after the oldest result
    was waited for, and each wait opens its own span; without one, every
    item starts at once and the waits share one span."""
    lock = threading.Lock()
    state = {"running": 0, "most": 0, "started": []}

    def fn(i):
        with lock:
            state["running"] += 1
            state["most"] = max(state["most"], state["running"])
            state["started"].append(i)
        time.sleep(0.002 * (i % 3))
        with lock:
            state["running"] -= 1
        return i * i

    got = []
    for k, out in enumerate(codec._submit_ahead(fn, list(range(8)), 3,
                                                codec._enc_wait)):
        with lock:
            assert max(state["started"]) <= k + 3
        got.append(out)
    assert got == [i * i for i in range(8)]
    assert state["most"] <= 3
    assert timing.STATS["enc: wait worker"][0] == 8
    got = list(codec._submit_ahead(fn, iter(range(8)), None,
                                   codec._dec_wait, workers=2))
    assert got == [i * i for i in range(8)]
    assert timing.STATS["dec: wait worker"][0] == 1


def test_submit_ahead_runs_one_item_on_the_caller(spans_on):
    got = list(codec._submit_ahead(lambda i: threading.get_native_id(),
                                   [0], 2, codec._dec_wait))
    assert got == [threading.get_native_id()]
    assert "dec: wait worker" not in timing.STATS


def test_submit_ahead_raises_a_failed_call():
    def fn(i):
        if i == 2:
            raise ValueError("item 2")
        return i

    gen = codec._submit_ahead(fn, list(range(5)), 2, codec._enc_wait)
    assert [next(gen), next(gen)] == [0, 1]
    with pytest.raises(ValueError, match="item 2"):
        next(gen)


def test_host_pool_map_caps_its_workers():
    """Results in item order on at most ``workers`` threads; one item, or a
    cap of one, on the caller's thread."""
    lock = threading.Lock()
    state = {"running": 0, "most": 0, "threads": set()}

    def fn(i):
        with lock:
            state["running"] += 1
            state["most"] = max(state["most"], state["running"])
            state["threads"].add(threading.get_native_id())
        time.sleep(0.002)
        with lock:
            state["running"] -= 1
        return -i

    assert codec._host_pool_map(fn, range(9), 2) == [-i for i in range(9)]
    assert state["most"] <= 2 and len(state["threads"]) <= 2
    for items, workers in ((range(1), None), (range(4), 1)):
        state["threads"].clear()
        assert codec._host_pool_map(fn, items, workers) == [-i for i in items]
        assert state["threads"] == {threading.get_native_id()}


def test_one_batch_decode_parses_on_the_request_thread(spans_on):
    """A container decoded in one batch opens no ``dec: wait worker``: its
    parse runs on the request thread; two batches keep the worker."""
    x = frames()
    blob = et.encode_chunked(x, config(x), device="cpu")
    for max_batch, waits in ((32, 0), (2, 2)):
        timing.reset_stats()
        with timing.recording() as recs:
            et.decode_chunked(blob, max_batch=max_batch, device="cpu")
        root = next(r for r in recs if r[0] == "request: decode_chunked")
        parse = {r[3] for r in recs if r[0] == "dec: entropy decode"}
        assert timing.STATS.get("dec: wait worker", [0])[0] == waits
        assert (parse == {root[3]}) == (waits == 0)


def test_spans_on_wait_before_every_copy(spans_on, monkeypatch):
    waits = []
    real = transfer._device_wait
    monkeypatch.setattr(transfer, "_device_wait", lambda device: (
        waits.append(device.type), real(device)))
    x = frames(2)
    et.decode_chunked(et.encode_chunked(x, config(x), device="cpu"),
                      device="cpu")
    copies = (timing.STATS["link: up"][0] + timing.STATS["link: down"][0])
    assert waits == ["cpu"] * copies
    assert timing.STATS["device: wait"][0] == copies


@pytest.mark.parametrize("chunk,copied", [
    ((1, 64, 96), False), ((1, 48, 64), True), ((3, 64, 96), True)],
    ids=["per_frame", "padded", "padded_frames"])
def test_gather_copy_opens_only_on_the_copy_path(spans_on, chunk, copied):
    """``chunked: gather copy`` never opens where the chunk grid is a view
    of the slab (one chunk per frame), and once per gather, inside it,
    where edge padding makes the gather copy."""
    x = frames()
    cfg = et.CodecConfig(dims=x.shape, base_cr=30, chunk_dims=chunk,
                         residual_mode=et.RESIDUAL_MAX_ERROR, error=0.5)
    with timing.recording() as recs:
        for _ in range(2):
            et.encode_chunked(x, cfg, device="cpu")
    assert timing.STATS["chunked: gather"][0] == 2
    copies = [r for r in recs if r[0] == "chunked: gather copy"]
    assert len(copies) == (2 if copied else 0)
    assert timing.STATS.get("chunked: gather copy", [0])[0] == len(copies)
    gathers = {r[1] for r in recs if r[0] == "chunked: gather"}
    assert all(r[2] in gathers for r in copies)


@pytest.mark.parametrize("case", ["default", "no_rice", "above_cap",
                                  "one_stream"])
def test_every_counted_byte_moves_inside_a_link_span(case, spans_on,
                                                     monkeypatch):
    """Every exchange form: the compact Rice forms, the index form without
    the host library and above the compaction cap (both directions), and
    one link stream in place of sliced copies."""
    if case == "no_rice":
        monkeypatch.setattr(codec, "_rice_enabled", lambda: False)
    elif case == "above_cap":
        monkeypatch.setattr(transfer, "COMPACT_CAP_LIMIT", 0)
    elif case == "one_stream":
        monkeypatch.setenv("EBCC_LINK_STREAMS", "1")
    counted = {"up": [], "down": []}
    for way in counted:
        real = getattr(transfer, f"count_{way}")

        def spy(n, way=way, real=real):
            span = timing.current()
            counted[way].append((span.name if span else None, n))
            real(n)
        monkeypatch.setattr(transfer, f"count_{way}", spy)
    x = frames(4, 96, 160)
    cfg = config(x)
    transfer.reset_link_stats()
    # Two encodes of the same shape: the second takes the hinted fused
    # fetch where the Rice exchange is on.
    for _ in range(2):
        blob = et.encode_chunked(x, cfg, max_batch=2, device="cpu")
    out = et.decode_chunked(blob, max_batch=2, device="cpu")
    assert np.abs(out - x).max() <= 0.5
    for way, name in (("up", "link: up"), ("down", "link: down")):
        assert counted[way], way
        assert {s for s, _ in counted[way]} == {name}, counted[way]
        assert sum(n for _, n in counted[way]) == transfer.LINK_STATS[way]
        assert timing.STATS[name][0] == len(counted[way])


def test_recording_restores_the_switch(monkeypatch):
    monkeypatch.setattr(timing, "ENABLED", False)
    with timing.recording() as recs:
        assert timing.ENABLED
        with timing.stage("kept"):
            pass
    assert not timing.ENABLED
    assert [r[0] for r in recs] == ["kept"]
    with timing.stage("not kept"):
        pass
    assert len(recs) == 1
    timing.reset_stats()


def test_clock_offset_takes_the_overlap_of_both_ends():
    # Trace clock = perf clock + 1000 us; the open bracket is wide.
    off = profiling.clock_offset(1000 + 50, 1000 + 900, (0, 80_000),
                                 (899_000, 901_000))
    assert off == pytest.approx(1000, abs=1)


def test_trace_holds_worker_spans_inside_the_request(tmp_path):
    x = frames()
    blob = et.encode_chunked(x, config(x), device="cpu")
    was = timing.ENABLED
    with profiling.trace("spans", profile_dir=str(tmp_path)):
        with profiling.annotate("mark"):
            with timing.stage("right inside"):
                pass
        out = et.decode_chunked(blob, max_batch=2, device="cpu")
    assert timing.ENABLED == was
    assert np.abs(out - x).max() <= 0.5
    files = glob.glob(os.path.join(tmp_path, "spans.*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    spans = [e for e in events if e.get("cat") == profiling.SPAN_CATEGORY]
    ids = {e["args"]["span"]: e for e in spans}
    root = next(e for e in spans if e["name"] == "request: decode_chunked")
    workers = [e for e in spans if e["tid"] != root["tid"]]
    assert {"dec: entropy decode", "dec: unpack planes",
            "link: up"} <= {e["name"] for e in workers}
    assert len([e for e in workers if e["name"] == "dec: entropy decode"]) \
        == 2                                     # two batches

    def under_root(e):
        while e["args"]["parent"] is not None:
            e = ids[e["args"]["parent"]]
        return e is root
    for e in workers:
        assert under_root(e), e
        assert root["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= root["ts"] + root["dur"]
        assert e["args"]["self_us"] <= e["dur"] + 1e-3
    mark = next(e for e in events if e.get("name") == "mark"
                and e.get("cat") == "user_annotation")
    probe = next(e for e in spans if e["name"] == "right inside")
    assert probe["tid"] == root["tid"] == threading.get_native_id()
    assert abs(probe["ts"] - mark["ts"]) < 1000            # within 1 ms
