"""One run of one cell: set-up, the measured window, the traced stretch,
the check, the result line.

A cell is a closed loop with one client: the next request goes out when
the last one returns.  A ``write`` request is
``ebcc_tpu_torch.encode_chunked(slab, config)`` on a host float32 slab,
returning the ETPK container; a ``read`` request is
``ebcc_tpu_torch.decode_chunked(container)``, returning the array.  The
slabs are a pool drawn from the seed in set-up (:mod:`portbench.traffic`);
requests cycle through it.  The read cells' containers are made in set-up
by the program's encoder.  Set-up ends with a few requests of the same
shapes, so that nothing builds or compiles inside the window.

After the window: the program's kernel launches in it and its route go to
standard output on a line of their own (a window that launched nothing on
the card fails the run); with ``--trace 1`` a short stretch of further
requests runs under ``torch.profiler``; then the reference decodes a sample
of the window's requests, drawn from the seed, and ``correct`` is decided
(:mod:`portbench.check`).
"""

from __future__ import annotations

import dataclasses
import fcntl
import glob
import importlib.util
import json
import os
import random
import resource
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ebcc_tpu")
BUILD_DIR = os.path.join(ROOT, "ebcc_tpu_torch", "csrc", "build")
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
             "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}
CACHE_ROOT = os.path.join(ROOT, ".portbench_cache")


class RunError(RuntimeError):
    """A run that cannot give a result (exit code 2)."""


@dataclasses.dataclass
class Run:
    """What the metric readers (``metrics/<name>.py``) read."""
    op: str
    frames: int
    points_per_request: int
    setup_s: float
    latencies: list
    window_s: float
    raw_bytes: int = 0
    out_bytes: int = 0
    link_up: int = 0
    link_down: int = 0
    stats: dict = None          # stage -> [count, thread seconds], traced runs
    trace: object = None        # tracing.Trace, traced runs

    @property
    def points(self) -> int:
        return self.points_per_request * len(self.latencies)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def report_build_locks() -> None:
    """Lock files of the program's build directory, reported and never
    waited on: each is tried without blocking and said to be held or
    free."""
    for path in sorted(glob.glob(os.path.join(BUILD_DIR, "*.lock"))
                       + glob.glob(os.path.join(BUILD_DIR, ".*.lock"))):
        with open(path, "a") as f:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                fcntl.flock(f, fcntl.LOCK_UN)
                state = "free"
            except OSError:
                state = "held by another process"
        log(f"portbench: build lock {os.path.relpath(path, ROOT)}: {state}")


def host_usage(u0, u1, cpu_s: float, window_s: float) -> dict:
    """What the process took from its host over the window: CPU seconds
    of all its threads, context switches and page faults (``getrusage``),
    so that a slow run can be told from a slow host."""
    return {"cpu_s": cpu_s, "cpu_over_wall": cpu_s / window_s,
            "voluntary_switches": u1.ru_nvcsw - u0.ru_nvcsw,
            "involuntary_switches": u1.ru_nivcsw - u0.ru_nivcsw,
            "minor_faults": u1.ru_minflt - u0.ru_minflt,
            "major_faults": u1.ru_majflt - u0.ru_majflt}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def codec_config(et, config: dict, frames: int, h: int, w: int):
    mode = {"MAX_ERROR": et.RESIDUAL_MAX_ERROR,
            "RELATIVE_ERROR": et.RESIDUAL_RELATIVE_ERROR}[
                config["residual_mode"]]
    chunk = tuple(config["chunk"])
    if chunk[1:] != (h, w):
        chunk = (chunk[0], h, w)
    return et.CodecConfig(dims=(frames, h, w), base_cr=config["base_cr"],
                          residual_mode=mode, error=config["error"],
                          chunk_dims=chunk)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", grid=None,
             pool=None) -> dict:
    """One run -> the result dict.  ``device``, ``grid`` (h, w) and
    ``pool`` are for the CPU tests, which drive a run at a small shape;
    the command line always runs the cell as committed, on the card."""
    bench = load_benchmark()
    cell = next((c for c in bench["workloads"] if c["name"] == workload),
                None)
    if cell is None:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    from . import traffic
    config = traffic.load_json("configs", cell["config"])
    mix = traffic.load_json("mixes", cell["traffic"])
    if mix.get("clients", 1) != 1:
        raise RunError("the generator drives one closed-loop client")
    op = mix["op"]
    if op not in ("write", "read"):
        raise RunError(f"unknown request kind {op!r}")
    os.environ.update(config.get("env", {}))
    if trace:
        os.environ["EBCC_TIMING"] = "2"   # read when the program is imported
    for key, sub in CACHE_ENV.items():
        os.environ.setdefault(key, os.path.join(CACHE_ROOT, sub))
    report_build_locks()

    import numpy as np
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RunError("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell asks for {cell['chips']}")
    dev = torch.device(device)

    import ebcc_tpu_torch as et
    from ebcc_tpu_torch.core import codec, routing, transfer
    from ebcc_tpu_torch.ops import dwt_hopper, exchange_hopper
    from ebcc_tpu_torch.utils import timing
    from . import check, reference, tracing

    marks = [("imports", time.perf_counter())]
    h, w = grid or config["grid"]
    frames = mix["frames"]
    n_pool = pool or mix["pool"]
    cfg = codec_config(et, config, frames, h, w)
    cdims = cfg.chunk_dims

    slabs_dev = traffic.make_slabs(seed, n_pool, frames, h, w, dev)
    slabs = [np.ascontiguousarray(s) for s in slabs_dev.cpu().numpy()]
    del slabs_dev
    marks.append(("slab pool", time.perf_counter()))
    blobs = ([et.encode_chunked(s, cfg, device=dev) for s in slabs]
             if op == "read" else None)
    marks.append(("containers", time.perf_counter()))

    def request(i):
        if op == "write":
            return et.encode_chunked(slabs[i % n_pool], cfg, device=dev)
        return et.decode_chunked(blobs[i % n_pool], device=dev)

    for i in range(min(n_pool, mix["warmup_requests"])):
        request(i)
    marks.append(("warm-up", time.perf_counter()))
    cuda = dev.type == "cuda"

    def launched():
        return (dwt_hopper.cuda_kernels_launched()
                + exchange_hopper.cuda_kernels_launched()) if cuda else 0

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # ---- the measured window ----
    sample_rng = random.Random(seed)
    k = mix["check_requests"]
    sample = []                    # (request index, answer)
    latencies = []
    raw_bytes = out_bytes = 0
    timing.reset_stats()
    transfer.reset_link_stats()
    dwt_hopper.reset_launch_counts()
    exchange_hopper.reset_launch_counts()
    launched0 = launched()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    usage0, cpu0 = resource.getrusage(resource.RUSAGE_SELF), time.process_time()
    setup_s = time.perf_counter() - t_start
    prev = t_start
    parts = []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f} s")
        prev = t
    log("portbench: set-up: " + ", ".join(parts))
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        a = time.perf_counter()
        answer = request(i)
        b = time.perf_counter()
        latencies.append(b - a)
        if op == "write":
            raw_bytes += slabs[i % n_pool].nbytes
            out_bytes += len(answer)
        if len(sample) < k:
            sample.append((i, answer))
        else:
            j = sample_rng.randrange(i + 1)
            if j < k:
                sample[j] = (i, answer)
        del answer
        i += 1
        if b >= deadline:
            break
    window_s = time.perf_counter() - t0
    usage1, cpu1 = resource.getrusage(resource.RUSAGE_SELF), time.process_time()
    n_window = i
    launches = {**dwt_hopper.launch_counts(),
                **exchange_hopper.launch_counts(),
                "cuda_kernels": launched() - launched0}
    route = {kind: routing.backend_choice(kind, dev)
             for kind in ("encode", "decode")}
    run = Run(op=op, frames=frames, points_per_request=frames * h * w,
              setup_s=setup_s, latencies=latencies, window_s=window_s,
              raw_bytes=raw_bytes, out_bytes=out_bytes,
              link_up=transfer.LINK_STATS["up"],
              link_down=transfer.LINK_STATS["down"],
              stats=({k_: list(v) for k_, v in timing.STATS.items()}
                     if trace else None))
    print(json.dumps({"portbench": "window", "workload": workload,
                      "requests": n_window, "route": route,
                      "launches": launches,
                      "host": host_usage(usage0, usage1, cpu1 - cpu0,
                                         window_s)}), flush=True)
    if cuda and launches["cuda_kernels"] <= 0:
        raise RunError("the window launched no CUDA kernel of the program")
    memory_peak = (int(torch.cuda.max_memory_allocated(dev)) if cuda else 0)

    # ---- the traced stretch ----
    if trace:
        n_tr = mix["trace_requests"]
        run.trace = tracing.profile_stretch(
            lambda: [request(n_window + j) for j in range(n_tr)],
            n_tr * frames, codec, dwt_hopper, dev)

    # ---- the check: the reference over a sample of the window ----
    if cuda:
        torch.cuda.empty_cache()
    numbers = {"err_over_bound": 0.0}
    if op == "read":
        numbers["gap_over_range"] = 0.0
    try:
        for idx, answer in sorted(sample, key=lambda t: t[0]):
            slab = torch.from_numpy(slabs[idx % n_pool]).to(dev)
            if op == "write":
                decoded, _ = reference.decode_container(answer, dev)
            else:
                ref, ranges = reference.decode_container(
                    blobs[idx % n_pool], dev)
                decoded = torch.from_numpy(np.asarray(answer)).to(dev)
                numbers["gap_over_range"] = max(
                    numbers["gap_over_range"],
                    check.gap_over_range(decoded, ref, ranges, cdims))
            numbers["err_over_bound"] = max(
                numbers["err_over_bound"],
                check.err_over_bound(decoded, slab, cdims,
                                     config["residual_mode"],
                                     config["error"]))
        failure = None
    except (reference.FormatError, ValueError) as e:
        failure = f"{type(e).__name__}: {e}"
    correct = failure is None and all(
        v <= check.LIMITS[n] for n, v in numbers.items())

    # ---- metrics ----
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[section]:
        if not applies(m, workload):
            continue
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": (torch.cuda.get_device_name(dev) if cuda
                         else "cpu"),
                "count": cell["chips"] if cuda else 0,
                "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": n_window, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = run.trace.busy_s
        dev_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.top_gaps()}
    result["checks"] = {n: {"value": v, "limit": check.LIMITS[n]}
                        for n, v in numbers.items()}
    if failure:
        result["checks"]["format"] = {"value": failure, "limit": "none"}
    lat = sorted(latencies)
    half = len(latencies) // 2 or 1
    log(f"portbench: {workload} seed {seed}: {n_window} requests in "
        f"{window_s:.3f} s; card {card_line() if cuda else 'cpu'}; "
        f"checked {len(sample)} requests; latency ms min {lat[0] * 1e3:.2f}"
        f" median {lat[len(lat) // 2] * 1e3:.2f} max {lat[-1] * 1e3:.2f},"
        f" mean of first half {sum(latencies[:half]) / half * 1e3:.2f},"
        f" of second half "
        f"{sum(latencies[half:]) / max(1, len(latencies) - half) * 1e3:.2f}")
    return result
