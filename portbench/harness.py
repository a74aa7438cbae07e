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

import ast
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


REQUIRED_KEYS = ("grid", "chunk", "base_cr", "residual_mode")
# The other keys a run reads, and those that only document the deployment.
READ_KEYS = ("error", "codec", "field", "env", "reference")
DOC_KEYS = ("name", "source", "deployment", "guarantee", "assumed")
# CodecConfig keys that a configuration states at its top level, or that
# the harness takes from the grid, the mix and the configuration's chunk.
TOP_LEVEL_KEYS = ("base_cr", "residual_mode", "error")
HARNESS_KEYS = ("dims", "chunk_dims")
# Decoder files lie in the benchmark's own folder.
DECODER_DIR = HERE
PROGRAM = "ebcc_tpu_torch"


@dataclasses.dataclass
class Deployment:
    """What a configuration file states, as the run uses it."""
    grid: tuple               # (h, w)
    codec: object             # ebcc_tpu_torch.CodecConfig
    field: tuple              # (means, stds) per frame, or None
    bound: object             # check.Bound
    decoder: object           # module: decode_container, FormatError


def chunk_dims(config: dict, frames: int, h: int, w: int, grid) -> tuple:
    """The configuration's ``chunk``, each axis within the slab's; at a
    test's ``grid`` in place of the configuration's own, a chunk that
    spans the frame spans the test's frame, and a tile is cut to fit."""
    chunk = config["chunk"]
    if not (isinstance(chunk, list) and len(chunk) == 3
            and all(isinstance(c, int) and not isinstance(c, bool)
                    and c > 0 for c in chunk)):
        raise RunError("chunk: three whole numbers above 0")
    if grid is not None:
        if chunk[1:] == list(config["grid"]):
            return (chunk[0], h, w)
        return (chunk[0], min(chunk[1], h), min(chunk[2], w))
    if chunk[0] > frames or chunk[1] > h or chunk[2] > w:
        raise RunError(f"chunk {chunk} does not fit a slab of "
                       f"{(frames, h, w)}")
    return tuple(chunk)


def codec_config(et, config: dict, frames: int, h: int, w: int,
                 grid=None):
    """The program's ``CodecConfig``: ``residual_mode`` by the name of its
    ``RESIDUAL_*`` constant, ``base_cr`` and ``error`` from the top level,
    every other keyword from ``codec``; dims from the mix's frames and the
    grid, chunks from ``chunk`` (:func:`chunk_dims`)."""
    name = config["residual_mode"]
    mode = getattr(et, f"RESIDUAL_{name}", None) if isinstance(
        name, str) else None
    if not isinstance(mode, int):
        raise RunError(f"unknown residual_mode {name!r}")
    extra = config.get("codec", {})
    if not isinstance(extra, dict):
        raise RunError("codec: an object of CodecConfig keywords")
    known = {f.name for f in dataclasses.fields(et.CodecConfig)}
    bad = sorted(k for k in extra
                 if k not in known or k in TOP_LEVEL_KEYS + HARNESS_KEYS)
    if bad:
        raise RunError(f"codec keys {bad}: not CodecConfig keywords that "
                       f"a configuration sets there")
    chunk = chunk_dims(config, frames, h, w, grid)
    error = {"error": config["error"]} if "error" in config else {}
    try:
        return et.CodecConfig(dims=(frames, h, w), base_cr=config["base_cr"],
                              residual_mode=mode, chunk_dims=chunk,
                              **error, **extra)
    except (TypeError, ValueError) as e:
        raise RunError(f"codec: {e}") from e


def field_profile(config: dict, frames: int):
    """``field`` -> (means, stds), one entry per frame, or None."""
    field = config.get("field")
    if field is None:
        return None
    if not isinstance(field, dict) or sorted(field) != ["mean", "std"]:
        raise RunError("field: an object with the lists mean and std")
    out = []
    for key in ("mean", "std"):
        values = field[key]
        if (not isinstance(values, list) or len(values) not in (1, frames)
                or not all(isinstance(v, (int, float))
                           and not isinstance(v, bool) for v in values)):
            raise RunError(f"field.{key}: a list of {frames} numbers, one "
                           f"per frame of the mix, or of one")
        out.append([float(v) for v in values] * (frames // len(values)))
    return tuple(out)


def bound_of(et, cfg):
    """The guarantee that decides ``correct``, as docs/FORMAT.md states it
    for the codec settings: MAX_ERROR ``error`` on every sample, or
    RELATIVE_ERROR ``error`` times the chunk's range; conforming decoders
    differ by 4e-6 of the range per intra chunk, by 2 * T * 4e-6 per
    temporal chunk of T frames.  A mode whose guarantee the benchmark
    cannot check yet is a ``RunError``."""
    from . import check
    kind = {et.RESIDUAL_MAX_ERROR: "max_abs",
            et.RESIDUAL_RELATIVE_ERROR: "chunk_relative"}.get(
                cfg.residual_mode)
    if kind is None:
        raise RunError(f"residual_mode {cfg.residual_mode_name}: the "
                       f"benchmark has no check of its guarantee yet")
    if not cfg.error > 0:
        raise RunError(f"error {cfg.error}: a bound above 0")
    frames = cfg.chunk_dims[0]
    eps = check.DECODER_EPS_REL * (
        2 * frames if cfg.temporal and frames > 1 else 1)
    return check.Bound(kind, float(cfg.error), eps)


def program_imports(path: str, seen=None) -> list:
    """Imports of the program or of the JAX package in a decoder file and
    in the modules of this package that it imports, read from the
    source."""
    seen = set() if seen is None else seen
    if path in seen:
        return []
    seen.add(path)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            pkg = __package__.split(".")
            up = pkg[:len(pkg) + 1 - node.level] if node.level else []
            mod = ".".join(up + ([node.module] if node.module else []))
            names += [mod] + [f"{mod}.{a.name}".lstrip(".")
                              for a in node.names]
    found = []
    for name in names:
        parts = name.split(".")
        if parts[0] in FORBIDDEN + (PROGRAM,):
            found.append(name)
        elif parts[0] == __package__:
            sub = os.path.join(ROOT, *parts) + ".py"
            if os.path.isfile(sub):
                found += program_imports(sub, seen)
    return found


def load_decoder(config: dict):
    """The decoder file the configuration names under ``reference``, a
    path inside the benchmark's folder, loaded by path as a module of this
    package, so that its relative imports name this package's modules.
    A file that imports the program or the JAX package is refused."""
    rel = config.get("reference", os.path.join("portbench", "reference.py"))
    folder = os.path.realpath(DECODER_DIR)
    path = (os.path.realpath(os.path.join(os.path.dirname(folder), rel))
            if isinstance(rel, str) and not os.path.isabs(rel) else None)
    if path is None or os.path.commonpath([path, folder]) != folder:
        raise RunError(f"reference: {rel!r} is not a path inside "
                       f"{os.path.basename(folder)}/")
    if not os.path.isfile(path):
        raise RunError(f"reference: no file {rel}")
    bad = program_imports(path)
    if bad:
        raise RunError(f"reference: {rel} imports {sorted(set(bad))}; the "
                       f"decoder that decides correct takes nothing of the "
                       f"program")
    stem = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.decoder_{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # for dataclasses and pickling in it
    spec.loader.exec_module(mod)
    if not (callable(getattr(mod, "decode_container", None))
            and isinstance(getattr(mod, "FormatError", None), type)
            and issubclass(mod.FormatError, Exception)):
        raise RunError(f"reference: {rel} gives no decode_container and "
                       f"FormatError")
    return mod


def deployment(et, config: dict, frames: int, grid=None) -> Deployment:
    """The one reading of a configuration file, for runs and the control,
    at its own grid or at ``grid`` (h, w); a missing or unknown key or
    mode, a chunk that does not fit, or a list of the wrong length, is a
    ``RunError``."""
    missing = sorted(set(REQUIRED_KEYS) - set(config))
    if missing:
        raise RunError(f"the configuration lacks {missing}")
    unknown = sorted(set(config) - set(REQUIRED_KEYS + READ_KEYS
                                       + DOC_KEYS))
    if unknown:
        raise RunError(f"unknown configuration keys {unknown}")
    h, w = grid or config["grid"]
    cfg = codec_config(et, config, frames, h, w, grid)
    return Deployment(grid=(h, w), codec=cfg,
                      field=field_profile(config, frames),
                      bound=bound_of(et, cfg),
                      decoder=load_decoder(config))


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

    import ebcc_tpu_torch as et
    frames = mix["frames"]
    dep = deployment(et, config, frames, grid)
    h, w = dep.grid
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RunError("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell asks for {cell['chips']}")
    dev = torch.device(device)

    from ebcc_tpu_torch.core import codec, routing, transfer
    from ebcc_tpu_torch.ops import dwt_hopper, exchange_hopper
    from ebcc_tpu_torch.utils import timing
    from . import check, tracing

    marks = [("imports", time.perf_counter())]
    n_pool = pool or mix["pool"]
    cfg, bound, decoder = dep.codec, dep.bound, dep.decoder
    cdims = cfg.chunk_dims

    slabs_dev = traffic.make_slabs(seed, n_pool, frames, h, w, dev,
                                   dep.field)
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
    limits = bound.limits
    numbers = {"err_over_bound": 0.0}
    if op == "read":
        numbers["gap_over_range"] = 0.0
    try:
        for idx, answer in sorted(sample, key=lambda t: t[0]):
            slab = torch.from_numpy(slabs[idx % n_pool]).to(dev)
            if op == "write":
                decoded, _ = decoder.decode_container(answer, dev)
            else:
                ref, ranges = decoder.decode_container(
                    blobs[idx % n_pool], dev)
                decoded = torch.from_numpy(np.asarray(answer)).to(dev)
                numbers["gap_over_range"] = max(
                    numbers["gap_over_range"],
                    check.gap_over_range(decoded, ref, ranges, cdims))
            numbers["err_over_bound"] = max(
                numbers["err_over_bound"],
                check.err_over_bound(decoded, slab, cdims, bound))
        failure = None
    except (decoder.FormatError, ValueError) as e:
        failure = f"{type(e).__name__}: {e}"
    correct = failure is None and all(
        v <= limits[n] for n, v in numbers.items())

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
    result["checks"] = {n: {"value": v, "limit": limits[n]}
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
