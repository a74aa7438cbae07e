"""The encode core replayed as CUDA graphs (``core/graphs.py``).

On the CPU: a CPU tensor's core runs eagerly and builds no graph; the key
follows every setting the core bakes in; the runner's path logic (eager
first, then capture, then replay, a path of its own for each branch
variant) runs with a stand-in for the CUDA graph whose replay runs the
captured segment again on the tensors it captured with, into the outputs
it captured, and gives the eager core's outputs bit for bit; a wrapper
given a ``ReplayedCall`` counts it and launches nothing; the benchmark's
reader of ``enc_core_graph_pct``.

Cases marked ``cuda`` run on the card: replayed batches ``torch.equal`` to
the eager core at the three configurations' settings and batch sizes and
in each branch variant, containers byte-identical to the eager core's,
two threads at once, every launch counter moved alike, the profiler
seeing in a replayed batch the kernels its counters add, and an evicted
key giving its pool back.  This file imports no JAX.
"""

import collections
import functools
import gc
import importlib.util
import os
import pathlib
import re
import sys
import threading

import numpy as np
import pytest
import torch

import ebcc_tpu_torch as et
from ebcc_tpu_torch.core import graphs, kernels
from ebcc_tpu_torch.ops import bitplane_hopper, dwt_hopper, metrics
from ebcc_tpu_torch.utils import timing

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W = 64, 96
CAPTURES, REPLAYS = "core: graph captures", "core: graph replays"


@pytest.fixture(autouse=True)
def _fresh_graphs():
    """Each test starts and ends with no graph: a graph replays what its
    capture ran, so a function one test patched would reach the next."""
    graphs.clear()
    yield
    graphs.clear()


@pytest.fixture
def spans_on(monkeypatch):
    monkeypatch.setattr(timing, "ENABLED", True)
    timing.reset_stats()
    yield timing.STATS
    timing.reset_stats()


def batch(kind, b, h=H, w=W, seed=0, device="cpu"):
    """(b, 1, h, w) float32 chosen to take one branch variant of the core
    at an absolute bound of 0.5: ``noisy`` takes the residual sweep with no
    refinable chunk, ``smooth`` skips the residual and refines every
    chunk, ``const`` skips it and refines none, ``mixed`` sweeps and
    refines its smooth chunk."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    field = (260 + 25 * np.sin(yy / h * np.pi) * np.cos(xx / w * 2 * np.pi)
             + 5 * np.sin(yy / 7.0) * np.sin(xx / 9.0)).astype(np.float32)
    frames = []
    for i in range(b):
        if kind == "noisy" or (kind == "mixed" and i):
            f = field + rng.normal(scale=0.8, size=(h, w))
        elif kind == "const":
            f = np.full((h, w), 250.0 + i)
        else:                                  # smooth, or mixed's chunk 0
            f = 260 + 0.05 * field / 30 + 0.001 * i
        frames.append(f.astype(np.float32))
    return torch.from_numpy(np.stack(frames)[:, None]).to(device)


PATHS = {"noisy": ("head", "sweep", "outputs"),
         "smooth": ("head", "trivial", "refine", "outputs"),
         "const": ("head", "trivial", "outputs"),
         "mixed": ("head", "sweep", "refine", "outputs")}
SETTINGS = dict(base_levels=5, res_levels=3, relative_mode=False,
                use_centered=True)
# A base quantile target that leaves the bound to the residual layer.
BQ = 0.9


def eager(x, error=0.5, bq=BQ, **kw):
    """The eager core, as the temporal encode calls it."""
    return kernels._encode_core(x, *metrics.minmax(x), error, bq,
                                **{**SETTINGS, **kw})


def assert_equal_outputs(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# ---- on the CPU ---------------------------------------------------------------

def test_cpu_tensor_builds_no_graph(spans_on):
    x = batch("mixed", 3)
    for _ in range(3):
        out = kernels.encode_batch(x, 0.5, BQ)
    assert list(graphs._CHAINS) == []
    assert not {CAPTURES, REPLAYS} & set(spans_on)
    assert_equal_outputs(out, eager(x))


def _key(x=None, error=0.5, bq=BQ, **kw):
    x = torch.zeros((2, 1, 8, 8)) if x is None else x
    return kernels.graph_key(x, kernels._settings(error, bq,
                                                  **{**SETTINGS, **kw}))


@pytest.mark.parametrize("change", [
    "device", "shape", "dtype", "base_levels", "res_levels",
    "relative_mode", "use_centered", "error_target", "bq_target",
    "fused_curve"])
def test_key_changes_with_each_setting(change, monkeypatch):
    """Each thing the captured core bakes in gives another key; values
    equal in float32 give the same key."""
    base = _key()
    assert _key() == base and hash(_key()) == hash(base)
    assert _key(error=0.5 + 1e-9) == base        # the same float32
    if change == "device":
        other = _key(torch.zeros((2, 1, 8, 8), device="meta"))
    elif change == "shape":
        other = _key(torch.zeros((3, 1, 8, 8)))
    elif change == "dtype":
        other = _key(torch.zeros((2, 1, 8, 8), dtype=torch.float64))
    elif change == "base_levels":
        other = _key(base_levels=4)
    elif change == "res_levels":
        other = _key(res_levels=2)
    elif change == "relative_mode":
        other = _key(relative_mode=True)
    elif change == "use_centered":
        other = _key(use_centered=False)
    elif change == "error_target":
        other = _key(error=0.25)
    elif change == "bq_target":
        other = _key(bq=0.5)
    else:
        monkeypatch.setenv("EBCC_FUSED_CURVE", "1")
        other = _key()
    assert other != base


class StandIn:
    """A CUDA graph's semantics on the CPU: replay runs the captured
    segment again on the tensors it captured with and copies the results
    into the outputs it captured."""

    def __init__(self, fn, st, outputs):
        self.fn, self.st, self.outputs = fn, dict(st), outputs
        self.replays = 0

    def replay(self):
        self.replays += 1
        new = self.fn(dict(self.st))
        for k, v in self.outputs.items():
            v.copy_(new[k])


@pytest.fixture
def stand_in(monkeypatch):
    made = []

    def capture(chain, fn, st):
        outputs = fn(dict(st))
        seg = graphs._Segment(StandIn(fn, st, outputs), outputs, [], [0, 0])
        made.append(seg)
        return seg
    monkeypatch.setattr(graphs._Chain, "capture", capture)
    return made


def through_graphs(x, error=0.5, bq=BQ, **kw):
    c = kernels._settings(error, bq, **{**SETTINGS, **kw})
    return graphs.run(kernels.graph_key(x, c), x,
                      functools.partial(kernels._encode_chain, c))


@pytest.mark.parametrize("kind", list(PATHS))
def test_runner_eager_then_capture_then_replay(kind, stand_in, spans_on):
    x = batch(kind, 3)
    want = eager(x)
    assert_equal_outputs(through_graphs(x), want)       # eager warm-up
    assert not stand_in and CAPTURES not in spans_on
    [chain] = graphs._CHAINS.values()
    assert chain.seen == {PATHS[kind][:i + 1]
                          for i in range(len(PATHS[kind]))}
    assert_equal_outputs(through_graphs(x), want)       # captures
    n = len(PATHS[kind])
    assert len(stand_in) == n and spans_on[CAPTURES][1] == n
    assert set(chain.segments) == {PATHS[kind][:i + 1] for i in range(n)}
    for k in range(1, 3):                                # replays
        out = through_graphs(x)
        assert_equal_outputs(out, want)
        assert spans_on[REPLAYS][1] == k * n
    assert len(stand_in) == n
    # The outputs are clones: the next batch does not write them.
    through_graphs(batch("noisy" if kind != "noisy" else "smooth", 3))
    assert_equal_outputs(out, want)


def test_runner_each_path_has_its_own_graphs(stand_in, spans_on):
    """Batches of one key that take other branches: a segment met for the
    first time runs eagerly with the rest of its batch, is captured the
    next time, and every batch gives the eager core's outputs."""
    kinds = ["noisy", "noisy", "smooth", "noisy", "smooth", "const", "mixed",
             "const", "mixed", "smooth", "mixed", "const", "noisy"]
    for i, kind in enumerate(kinds):
        x = batch(kind, 3, seed=i)
        assert_equal_outputs(through_graphs(x), eager(x))
    [chain] = graphs._CHAINS.values()
    want = {p[:i + 1] for p in PATHS.values() for i in range(len(p))}
    assert set(chain.segments) == want == chain.seen
    assert len(stand_in) == len(want) == 9


def test_runner_keeps_the_most_recent_keys(monkeypatch, stand_in):
    monkeypatch.setattr(graphs, "MAX_KEYS", 2)
    xs = [batch("noisy", b) for b in (1, 2, 3)]
    for x in xs + [xs[1]]:
        through_graphs(x)
    shapes = [k[1][0] for k in list(graphs._CHAINS)]
    assert shapes == [3, 2]


def test_runner_threads_share_a_key(stand_in):
    """More threads than cores encode batches of one key at once, each
    branch variant among them, with a short switch interval: the key's
    lock keeps every thread's outputs the eager core's."""
    xs = [batch(k, 3, seed=i) for i, k in enumerate(list(PATHS) * 2)]
    want = [eager(x) for x in xs]
    errors = []

    def work(j):
        try:
            for i in range(4):
                k = (i + j) % len(xs)
                assert_equal_outputs(through_graphs(xs[k]), want[k])
        except Exception as e:        # noqa: BLE001 - asserted below
            errors.append(e)
    threads = [threading.Thread(target=work, args=(j,))
               for j in range((os.cpu_count() or 4) + 2)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(graphs._CHAINS) == 1


def test_replayed_call_counts_and_launches_nothing():
    """A wrapper given a ReplayedCall counts the call as a launch and
    returns without touching a library (none loads on this machine)."""
    q = torch.zeros((2, 1, 32, 32), dtype=torch.int32, device="meta")
    rep = dwt_hopper.ReplayedCall(q)
    assert rep.shape == (2, 1, 32, 32) and rep.dtype == torch.int32
    dwt_hopper.reset_launch_counts()
    bitplane_hopper.reset_launch_counts()
    assert dwt_hopper.idwt2d_dequant(rep, None, 3) is None
    assert dwt_hopper.dwt2d_quantize(rep, 5) is None
    assert dwt_hopper.dwt2d_transform(rep, 3) is None
    assert dwt_hopper.curve_stats(rep, None, None, None, None, levels=3,
                                  cut_grid=(0,), valid_hw=(32, 32)) is None
    from ebcc_tpu_torch.ops import bitplane
    assert bitplane.estimated_code_bytes(rep, 13) is None
    assert dwt_hopper.launch_counts() == {
        "dwt2d_quantize": 1, "dwt2d_transform": 1, "idwt2d_dequant": 1,
        "curve_stats": 1}
    assert bitplane_hopper.launch_counts() == {"code_size_stats": 1}


def test_segment_replay_makes_each_noted_call_again(monkeypatch):
    """A replay makes every call its capture noted again through the
    module attribute, so a wrapper put around it after the capture sees
    it, and adds each library's kernels to its count."""
    seen, added = [], []
    q = torch.zeros((4, 1, 32, 32), dtype=torch.int32)
    calls = []
    with dwt_hopper.noting_calls(calls):
        dwt_hopper.note_call(dwt_hopper, "idwt2d_dequant", q, None, 3)
    monkeypatch.setattr(dwt_hopper, "idwt2d_dequant",
                        lambda x, cut, levels: seen.append((x.shape,
                                                            levels)))
    monkeypatch.setattr(dwt_hopper, "add_kernels_launched", added.append)
    monkeypatch.setattr(bitplane_hopper, "add_kernels_launched",
                        added.append)

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1
    graphs._Segment(Graph(), {}, calls, [4, 0]).replay()
    assert Graph.replays == 1 and seen == [((4, 1, 32, 32), 3)]
    assert added == [4]
    dwt_hopper.note_call(dwt_hopper, "idwt2d_dequant", q, None, 3)
    assert len(calls) == 1                     # noting is off again


def _reader():
    path = ROOT / "portbench" / "metrics" / "enc_core_graph_pct.py"
    spec = importlib.util.spec_from_file_location("enc_core_graph_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Run:
    def __init__(self, stats):
        self.stats = stats


@pytest.mark.parametrize("stats, want", [
    (None, None),
    ({}, None),
    ({"exch: compact pairs": [4, 100]}, None),
    ({"core: graph captures": [4, 4]}, 0.0),
    ({"core: graph replays": [40, 40]}, 100.0),
    ({"core: graph replays": [30, 30], "core: graph captures": [10, 10]},
     75.0),
], ids=["untraced", "empty", "no_counter", "captures_only", "replays_only",
        "mixed"])
def test_enc_core_graph_pct_reader(stats, want):
    assert _reader()(_Run(stats)) == want


# ---- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc)")
    return torch.device("cuda")


def _slab(config_name, frames, seed):
    """One slab of a benchmark configuration as the harness makes it, on
    the card, with the configuration's codec settings."""
    from portbench import harness, traffic
    config = traffic.load_json("configs", config_name)
    dep = harness.deployment(et, config, frames)
    slab = traffic.make_slabs(seed, 1, frames, *dep.grid, "cuda",
                              dep.field)[0]
    return slab, dep.codec


def _core_args(cfg):
    return dict(error=cfg.error, bq=et.EncodeOptions().base_quantile_target,
                base_levels=cfg.base_levels, res_levels=cfg.residual_levels,
                relative_mode=cfg.residual_mode == et.RESIDUAL_RELATIVE_ERROR,
                use_centered=True)


def _encode(x, error, bq, **kw):
    return kernels.encode_batch(x, error, bq, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("config_name, frames, chunks", [
    ("era5_max0.5_cr30", 8, 8), ("era5_rel0.01_cr200", 8, 8),
    ("era5_geopotential37_max10_cr30", 37, 32),
    ("era5_geopotential37_max10_cr30", 37, 5)])
def test_card_replays_bit_equal_to_eager(card, spans_on, config_name,
                                         frames, chunks):
    slab, cfg = _slab(config_name, frames, 2**31 + 25)
    x = slab[:chunks, None].contiguous() if chunks == 32 else \
        slab[-chunks:, None].contiguous()
    args = _core_args(cfg)
    want = eager(x, **args)
    for _ in range(3):
        assert_equal_outputs(_encode(x, **args), want)
    assert spans_on[REPLAYS][1] >= 3
    assert spans_on[CAPTURES][1] >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(PATHS))
def test_card_each_branch_variant_bit_equal(card, spans_on, kind):
    x = batch(kind, 8, 721, 1440, device="cuda")
    want = eager(x)
    for _ in range(3):
        assert_equal_outputs(_encode(x, 0.5, BQ), want)
    [chain] = graphs._CHAINS.values()
    assert max(chain.segments, key=len) == PATHS[kind]
    assert spans_on[REPLAYS][1] == len(PATHS[kind])


@pytest.mark.cuda
@pytest.mark.parametrize("config_name, frames", [
    ("era5_max0.5_cr30", 8), ("era5_rel0.01_cr200", 8),
    ("era5_geopotential37_max10_cr30", 37)])
def test_card_containers_identical_to_eager_core(card, monkeypatch,
                                                 config_name, frames):
    slab, cfg = _slab(config_name, frames, 2**31 + 26)
    data = slab.cpu().numpy()
    blobs = [et.encode_chunked(data, cfg, device="cuda") for _ in range(3)]
    assert list(graphs._CHAINS)
    monkeypatch.setattr(graphs, "run",
                        lambda key, x, chain: chain({"x": x}, kernels._eager))
    graphs.clear()
    want = et.encode_chunked(data, cfg, device="cuda")
    assert not list(graphs._CHAINS)
    assert all(b == want for b in blobs)


@pytest.mark.cuda
def test_card_two_threads_match_serial(card):
    xs = [batch(k, 8, 721, 1440, seed=i, device="cuda")
          for i, k in enumerate(["noisy", "mixed", "smooth", "noisy"])]
    want = [eager(x) for x in xs]
    errors = []

    def work(order):
        try:
            for _ in range(3):
                for i in order:
                    assert_equal_outputs(_encode(xs[i], 0.5, BQ),
                                         want[i])
        except BaseException as e:       # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=work, args=(o,))
               for o in ([0, 1, 2, 3], [3, 2, 1, 0])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(list(graphs._CHAINS)) == 1


def _counts():
    from ebcc_tpu_torch.ops import exchange_hopper
    torch.cuda.synchronize()
    return {**dwt_hopper.launch_counts(), **bitplane_hopper.launch_counts(),
            "dwt97": dwt_hopper.cuda_kernels_launched(),
            "bitplane": bitplane_hopper.cuda_kernels_launched(),
            "exchange": exchange_hopper.cuda_kernels_launched()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "smooth"])
def test_card_counters_move_alike(card, kind):
    x = batch(kind, 8, 721, 1440, device="cuda")
    deltas = []
    for run in (lambda: eager(x), lambda: _encode(x, 0.5, BQ)):
        for _ in range(3):
            before = _counts()
            run()
            after = _counts()
            deltas.append({k: after[k] - before[k] for k in after})
    eager_d, replay_d = deltas[0], deltas[-1]
    assert eager_d["idwt2d_dequant"] > 0 and eager_d["dwt97"] > 0
    assert all(d == eager_d for d in deltas), deltas
    assert replay_d == eager_d


# The kernels of each library, by the names ``csrc/dwt97.cu`` and
# ``csrc/bitplane.cu`` give them.
LIBRARY_KERNELS = {
    "dwt97": ("fwd_tile", "fwd_coarse", "inv_tile", "inv_coarse",
              "curve_tile", "curve_reduce"),
    "bitplane": ("plane_counts", "code_size_tail")}


def _profiled(fn):
    """(every counter's move, the library kernels the profiler saw run:
    {kernel: count}) over one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    before = _counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    after = _counts()
    seen = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for names in LIBRARY_KERNELS.values():
            for k in names:
                if re.search(rf"\b{k}\b", e.name):
                    seen[k] += 1
    return {k: after[k] - before[k] for k in after}, seen


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "smooth"])
def test_card_replay_runs_the_kernels_it_counts(card, kind):
    """The counters a replayed batch adds were copied from its capture, so
    a replay of an empty or stale graph would move them all the same.  The
    profiler sees the kernels that ran: in a replayed batch they are the
    eager core's, kernel for kernel, and as many as each library's count
    and the estimate's and the curve's wrapper counts moved."""
    x = batch(kind, 8, 721, 1440, device="cuda")
    eager_d, eager_k = _profiled(lambda: eager(x))
    for _ in range(2):
        _encode(x, 0.5, BQ)
    [chain] = graphs._CHAINS.values()
    assert len(chain.segments) == len(PATHS[kind])     # all captured
    replay_d, replay_k = _profiled(lambda: _encode(x, 0.5, BQ))
    assert replay_d == eager_d
    assert replay_k == eager_k
    assert replay_k["inv_tile"] > 0 and replay_k["fwd_tile"] > 0
    assert replay_k["code_size_tail"] > 0
    for lib, names in LIBRARY_KERNELS.items():
        assert sum(replay_k[k] for k in names) == replay_d[lib], lib
    assert replay_k["code_size_tail"] == replay_d["code_size_stats"]
    assert replay_k["plane_counts"] == replay_d["code_size_stats"]
    assert replay_k["curve_reduce"] == replay_d["curve_stats"]


@pytest.mark.cuda
def test_card_evicting_a_key_frees_its_pool(card):
    x = batch("mixed", 8, 721, 1440, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    for _ in range(3):
        out = _encode(x, 0.5, BQ)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - base
    assert held > x.numel() * 4 * 4          # the pool and the static input
    graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() - base < 0.1 * held
