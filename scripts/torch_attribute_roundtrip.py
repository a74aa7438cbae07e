#!/usr/bin/env python3
"""Attribute the wall time of the PyTorch port's device-resident roundtrip
(``scripts/attribute_roundtrip.py`` on a CUDA card, plus a breakdown of
each sub-batch and a device trace).

Runs the port bench's roundtrip (``ebcc_tpu_torch.bench``:
``EBCC_BENCH_FRAMES`` (32) frames of 721x1440 float32, zstd level
``EBCC_BENCH_ZSTD_LEVEL`` (3) with ``EBCC_BENCH_ENTROPY``) in one of four
modes (``--mode``):

* ``max_error`` (default): MAX_ERROR 0.5, base_cr 30, one-frame chunks in
  sub-batches of ``EBCC_BENCH_SUBBATCH`` (4): the bench's headline and
  ``chip_smoke.py`` phase 3;
* ``relative``: RELATIVE_ERROR 1e-2, otherwise the same (phase 5;
  ``EBCC_FUSED_CURVE=1`` in the environment switches the fused curve sweep
  on);
* ``rate``: rate mode (RESIDUAL_NONE) at base_cr 30, otherwise the same
  (phase 8);
* ``temporal``: MAX_ERROR 0.5 with ``temporal``, chunks of 8 drifting
  frames in sub-batches of 2 chunks (phase 9);

and reports, in one JSON object:

* the wall of each of ``EBCC_BENCH_REPS`` (3) roundtrips, each ending in
  the max error on the device, held to the bound; the best and its
  points/s;
* the link rates (``bench.measure_link``), the bytes each rep moved each
  way (``transfer.LINK_STATS``) and the floors those imply;
* the port's stage timers (``EBCC_TIMING=2``; stages overlap across the
  pipeline's threads, so they attribute work, not latency);
* each sub-batch taken apart, each part synchronised: device encode, the
  fetch of its outputs through the pipeline's exchange, host assembly,
  then the decode's host parse and device decode;
* on the card, a ``torch.profiler`` trace of one roundtrip: device busy
  time (the union of kernel intervals), the idle share of the wall time,
  and device time by kernel name.

Run from the root of a checkout::

    python3 scripts/torch_attribute_roundtrip.py \
        [--mode max_error|relative|rate|temporal] [--out FILE] [--device cuda]

With ``--out FILE`` the JSON also goes to FILE.
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("EBCC_TIMING", "2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ebcc_tpu_torch import bench  # noqa: E402


def _busy_seconds(intervals):
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _profile(torch, roundtrip):
    """One roundtrip under ``torch.profiler``: its wall, the device busy
    time, the idle share and device time of the 25 busiest kernel names."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        roundtrip()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    intervals = []
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            s, e = ev.time_range.start, ev.time_range.end
            intervals.append((s, e))
            d = by_name.setdefault(ev.name, [0, 0.0])
            d[0] += 1
            d[1] += (e - s) / 1e3
    busy_ms = _busy_seconds(intervals) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    return {"wall_s": wall, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
            "device_events": len(intervals),
            "device_ms_by_kernel": {k: {"count": c, "ms": ms}
                                    for k, (c, ms) in top}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="max_error",
                    choices=("max_error", "relative", "rate", "temporal"))
    ap.add_argument("--out", help="write the JSON result here too")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import ebcc_tpu_torch as et
    from ebcc_tpu_torch.core import codec, transfer
    from ebcc_tpu_torch.device import resolve_device
    from ebcc_tpu_torch.utils import timing

    dev = resolve_device(args.device)
    n = int(os.environ.get("EBCC_BENCH_FRAMES", "32"))
    reps = int(os.environ.get("EBCC_BENCH_REPS", "3"))
    h, w = bench.H, bench.W
    frames = bench.load_frames(n, h, w)
    mode, error = {"max_error": (et.RESIDUAL_MAX_ERROR, 0.5),
                   "relative": (et.RESIDUAL_RELATIVE_ERROR, 1e-2),
                   "rate": (et.RESIDUAL_NONE, 0.0),
                   "temporal": (et.RESIDUAL_MAX_ERROR, 0.5)}[args.mode]
    temporal = args.mode == "temporal"
    if temporal:
        # Frames per chunk, chunks per sub-batch (phase 9).
        from chip_smoke import drifting_chunks
        d0, sub = min(8, n), 2
        x = drifting_chunks(frames, n // d0, d0)
    else:
        d0, sub = 1, int(os.environ.get("EBCC_BENCH_SUBBATCH", "4"))
        x = frames.reshape(n, 1, h, w)
    config = bench.bench_config((x.shape[0] * d0, h, w), h, w,
                                chunk=(d0, h, w), residual_mode=mode,
                                error=error, temporal=temporal)
    opts = et.EncodeOptions.from_env()
    x_dev = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    bound = {"relative": error * float(frames.max() - frames.min()),
             "rate": float("inf")}.get(args.mode, error)

    def roundtrip():
        streams, err = bench.device_roundtrip(x_dev, config, opts, sub)
        if not err <= bound:
            raise AssertionError((args.mode, err, bound))
        return streams

    roundtrip()                                        # warm-up: builds

    # ---- end to end, with the link's bytes and floors ----
    up_mbps, down_mbps = bench.measure_link(dev)
    timing.reset_stats()
    transfer.reset_link_stats()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        streams = roundtrip()
        walls.append(time.perf_counter() - t0)
    up_b = transfer.LINK_STATS["up"] / reps
    down_b = transfer.LINK_STATS["down"] / reps
    stats = timing.snapshot()
    for k in stats:
        stats[k]["per_rep_s"] = round(stats[k]["total_s"] / reps, 4)

    # ---- each sub-batch, part by part ----
    hp, wp = codec._padded_hw(h, w, max(config.base_levels,
                                        config.residual_levels))
    backend = codec.entropy.backend_id(config)
    levels = dict(base_levels=config.base_levels,
                  res_levels=config.residual_levels)

    def timed(fn):
        bench._sync(dev)
        t0 = time.perf_counter()
        out = fn()
        bench._sync(dev)
        return out, time.perf_counter() - t0

    def encode_device(xb):
        if args.mode == "rate":
            return codec.kernels.encode_batch_rate_only(
                xb, codec._rate_budget(config, d0, h, w), **levels)
        if temporal:
            return codec.kernels.encode_batch_temporal(
                xb, config.error, opts.base_quantile_target, **levels)
        return codec.kernels.encode_batch(
            xb, config.error, opts.base_quantile_target,
            relative_mode=args.mode == "relative", **levels)

    parts = []
    for s0 in range(0, x_dev.shape[0], sub):
        xb = x_dev[s0:s0 + sub]
        nb = xb.shape[0]
        out, t_dev = timed(lambda: encode_device(xb))
        small, t_fetch = timed(lambda: codec._fetch_encode_outputs(
            out, nb, d0, hp, wp))
        streams_b, t_asm = timed(lambda: codec._assemble_batch(
            small, config, opts, d0, h, w, backend, nb))
        _, t_dec = timed(lambda: codec._decode_streams_device(streams_b,
                                                              dev))
        part = {"chunks": [s0, s0 + nb], "nnz": int(small["sparse"].idx.size),
                "encode_device_s": t_dev, "fetch_exchange_s": t_fetch,
                "assemble_host_s": t_asm,
                "decode_parse_upload_device_s": t_dec}
        if "skip_residual" in small:
            part["residual_chunks"] = int((~small["skip_residual"]).sum())
        if temporal:
            part["skipped_deltas"] = int(small["t_skip"].sum())
        parts.append(part)

    text = json.dumps({
        "device": bench.device_line(dev),
        "mode": args.mode,
        "error": error,
        "frames": n,
        "frames_per_chunk": d0,
        "sub_batch": sub,
        "fused_curve": os.environ.get("EBCC_FUSED_CURVE", "0") == "1",
        "stream_bytes": sum(len(s) for s in streams),
        "wall_per_rep_s": [round(t, 4) for t in walls],
        "best_wall_s": round(min(walls), 4),
        "pts_per_s": round(frames.size / min(walls), 1),
        "link_up_MBps": round(up_mbps, 1),
        "link_down_MBps": round(down_mbps, 1),
        "bytes_up_per_rep": int(up_b),
        "bytes_down_per_rep": int(down_b),
        "up_floor_s": round(up_b / (up_mbps * 1e6), 4),
        "down_floor_s": round(down_b / (down_mbps * 1e6), 4),
        "stages": stats,
        "sub_batches": parts,
        "profile": (_profile(torch, roundtrip) if dev.type == "cuda"
                    else None),
    }, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
