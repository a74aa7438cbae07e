"""The benchmark's ERA5 geopotential deployment on the CPU at a small grid:
the committed configuration against ``scripts/ab_reference.py``'s 37-level
profile, the cell ``geo37_max10_cr30.write37`` through the harness, the
program's containers against the plain reference decoder, the encode
exchange's two paths (compact Rice pair, int32 index fallback) giving the
same bytes with the counters that say which path carried the pairs, and
the two metric readers that read them."""

import math
import os
import time

import numpy as np
import pytest
import torch

import ebcc_tpu_torch as et
from ebcc_tpu_torch.core import codec, transfer
from ebcc_tpu_torch.utils import timing
from portbench import check, harness, traffic

CELL = "geo37_max10_cr30.write37"
CONFIG = "era5_geopotential37_max10_cr30"
GRID = (64, 96)
SEED = 2**31 + 3737

# scripts/ab_reference.py: LEVELS_HPA, std_height, anomaly_std.
G = 9.80665
LEVELS_HPA = [1000, 975, 950, 925, 900, 875, 850, 825, 800, 775, 750, 700,
              650, 600, 550, 500, 450, 400, 350, 300, 250, 225, 200, 175,
              150, 125, 100, 70, 50, 30, 20, 10, 7, 5, 3, 2, 1]


def std_height(p_hpa):
    if p_hpa >= 226.32:
        return 44330.8 * (1.0 - (p_hpa / 1013.25) ** 0.190263)
    if p_hpa >= 54.75:
        return 11000.0 + 6341.6 * math.log(226.32 / p_hpa)
    return 20000.0 + 216650.0 * ((54.75 / p_hpa) ** 0.0292713 - 1.0)


def anomaly_std(p_hpa):
    return 400.0 + 4600.0 * (1.0 - p_hpa / 1000.0) ** 1.5


@pytest.fixture
def env_restored():
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def small_deployment():
    """The configuration as a run reads it, at the test grid, with its
    environment (the route pinned to the device path) set."""
    config = traffic.load_json("configs", CONFIG)
    os.environ.update(config["env"])
    return harness.deployment(et, config, len(LEVELS_HPA), GRID)


def slab(seed, dep):
    return traffic.make_slabs(seed, 1, len(LEVELS_HPA), *GRID, "cpu",
                              dep.field)[0]


# ---- (a) the committed configuration ----

def test_configuration_is_the_published_profile():
    config = traffic.load_json("configs", CONFIG)
    assert config["field"]["mean"] == [G * std_height(p) for p in LEVELS_HPA]
    assert config["field"]["std"] == [anomaly_std(p) for p in LEVELS_HPA]
    assert round(config["field"]["mean"][0]) == 1087
    assert round(config["field"]["mean"][-1]) == 460236
    assert round(config["field"]["std"][-1]) == 4993


def test_configuration_reads_as_upstream_states_it(env_restored):
    config = traffic.load_json("configs", CONFIG)
    dep = harness.deployment(et, config, len(LEVELS_HPA))
    assert dep.grid == (721, 1440)
    assert dep.codec.residual_mode == et.RESIDUAL_MAX_ERROR
    assert dep.codec.error == 10.0 and dep.codec.base_cr == 30
    assert dep.codec.chunk_dims == (1, 721, 1440)
    assert dep.codec.dims == (37, 721, 1440)
    assert dep.bound == check.Bound("max_abs", 10.0, check.DECODER_EPS_REL)
    mix = traffic.load_json("mixes", "write37")
    assert (mix["op"], mix["frames"], mix["pool"]) == ("write", 37, 24)
    cell = next(c for c in harness.load_benchmark()["workloads"]
                if c["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "write37", 1)


# ---- (b) the cell at a small size ----

def _run():
    return harness.run_cell(CELL, SEED, 0.3, False, time.perf_counter(),
                            device="cpu", grid=GRID, pool=2)


def test_cell_runs_correct(env_restored):
    r = _run()
    assert r["correct"] is True, r["checks"]
    assert list(r["checks"]) == ["err_over_bound"]
    assert 0.5 < r["checks"]["err_over_bound"]["value"] <= 1.0
    assert r["metrics"]["compression_ratio"]["value"] > 1


def test_altered_value_is_not_correct(env_restored, monkeypatch):
    real = et.encode_chunked

    def encode(data, config, *a, **kw):
        data = data.copy()
        data[0, 5, 7] += 3 * 10.0
        return real(data, config, *a, **kw)
    monkeypatch.setattr(et, "encode_chunked", encode)
    r = _run()
    assert r["correct"] is False, r["checks"]


# ---- (c) the program against the plain reference ----

@pytest.mark.parametrize("seed", [SEED, 2**33 + 17])
def test_reference_decode_matches_the_program(env_restored, seed):
    dep = small_deployment()
    x = slab(seed, dep)
    blob = et.encode_chunked(x.numpy(), dep.codec, device="cpu")
    ref, ranges = dep.decoder.decode_container(blob, "cpu")
    port = torch.from_numpy(et.decode_chunked(blob, device="cpu"))
    cdims = dep.codec.chunk_dims
    assert check.gap_over_range(port, ref, ranges, cdims) <= \
        check.DECODER_EPS_REL
    assert check.err_over_bound(ref, x, cdims, dep.bound) <= 1.0
    assert check.err_over_bound(port, x, cdims, dep.bound) <= 1.0


# ---- (d) the exchange paths give the same bytes ----

@pytest.fixture
def spans_on(monkeypatch, env_restored):
    monkeypatch.setattr(timing, "ENABLED", True)
    timing.reset_stats()
    yield
    timing.reset_stats()


def _encode_counting(x, cfg, monkeypatch, **kw):
    """-> (container, [(chunks, pairs) per batch], exchange counters)."""
    batches = []
    real = codec._fetch_encode_outputs

    def spy(out, b, *a):
        res = real(out, b, *a)
        batches.append((b, int(res["sparse"].idx.size)))
        return res
    monkeypatch.setattr(codec, "_fetch_encode_outputs", spy)
    timing.reset_stats()
    blob = et.encode_chunked(x, cfg, device="cpu", **kw)
    monkeypatch.setattr(codec, "_fetch_encode_outputs", real)
    counters = {k: list(v) for k, v in timing.STATS.items()
                if k.startswith("exch: ")}
    return blob, batches, counters


def test_index_fallback_gives_the_compact_bytes(spans_on, monkeypatch):
    dep = small_deployment()
    x = slab(SEED, dep).numpy()
    blob, batches, counters = _encode_counting(x, dep.codec, monkeypatch)
    assert [b for b, _ in batches] == [32, 5]
    (_, n32), (_, n5) = batches
    assert transfer.bucket_count(n5) < transfer.bucket_count(n32)
    assert counters == {"exch: compact pairs": [2, n32 + n5]}
    # The cap just under the 32-chunk slice's pairs: that slice takes the
    # index fallback, the 5-chunk slice the compact pair.
    monkeypatch.setattr(transfer, "COMPACT_CAP_LIMIT",
                        transfer.bucket_count(n32) - 1)
    low, batches_low, counters_low = _encode_counting(x, dep.codec,
                                                      monkeypatch)
    assert low == blob
    assert batches_low == batches
    assert counters_low == {"exch: index pairs": [1, n32],
                            "exch: compact pairs": [1, n5]}


def test_no_rice_takes_the_index_fallback_for_every_pair(spans_on,
                                                         monkeypatch):
    dep = small_deployment()
    x = slab(SEED, dep).numpy()
    blob, batches, _ = _encode_counting(x, dep.codec, monkeypatch)
    monkeypatch.setattr(codec, "_rice_enabled", lambda: False)
    plain, _, counters = _encode_counting(x, dep.codec, monkeypatch)
    assert plain == blob
    assert counters == {"exch: index pairs": [2, sum(n for _, n in batches)]}


def test_one_slice_and_two_give_the_same_bytes(spans_on, monkeypatch):
    dep = small_deployment()
    x = slab(SEED, dep).numpy()
    waits = {}
    blobs = {}
    for max_batch in (32, 37):
        blobs[max_batch], batches, _ = _encode_counting(
            x, dep.codec, monkeypatch, max_batch=max_batch)
        assert [b for b, _ in batches] == ([32, 5] if max_batch == 32
                                           else [37])
        waits[max_batch] = timing.STATS.get("enc: wait worker", [0])[0]
    assert blobs[32] == blobs[37]
    assert waits[32] == 3 and waits[37] == 0


def test_spans_off_count_nothing(env_restored, monkeypatch):
    monkeypatch.setattr(timing, "ENABLED", False)
    timing.reset_stats()
    dep = small_deployment()
    et.encode_chunked(slab(SEED, dep).numpy(), dep.codec, device="cpu")
    assert timing.STATS == {}


# ---- (e) the new readers ----

def _reader_run(stats):
    return harness.Run(op="write", frames=37, points_per_request=10**6,
                       setup_s=1.0, latencies=[0.5, 0.5], window_s=1.0,
                       stats=stats)


@pytest.mark.parametrize("stats,want", [
    (None, None),                                          # untraced
    ({"enc: device": [2, 0.5, 0.5]}, None),                # no counters
    ({"exch: compact pairs": [4, 1000]}, 0.0),
    ({"exch: compact pairs": [2, 0]}, 0.0),                # no pair at all
    ({"exch: index pairs": [1, 3000],
      "exch: compact pairs": [1, 1000]}, 75.0),
    ({"exch: index pairs": [2, 500]}, 100.0),
], ids=["untraced", "parent", "compact_only", "empty", "mixed",
        "index_only"])
def test_index_pairs_share(stats, want):
    assert harness.reader("enc_index_pairs_pct")(_reader_run(stats)) == want


def test_worker_wait_per_mpt():
    read = harness.reader("enc_worker_wait_s_per_mpt")
    assert read(_reader_run(None)) is None
    assert read(_reader_run({"enc: wait worker": [3, 0.5]})) is None
    run = _reader_run({"enc: wait worker": [3, 0.5, 0.5],
                       "request: encode_chunked": [2, 1.0, 0.1]})
    assert read(run) == pytest.approx(0.25)     # 0.5 s over 2 Mpt
    run.stats.pop("enc: wait worker")
    assert read(run) == 0.0
