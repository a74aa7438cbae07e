#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one CUDA card.

Runs one of the roundtrips of ``chip_smoke.py`` on 32 frames of 721x1440
float32, zstd level 3 (``--mode``):

* ``max_error`` (default): MAX_ERROR 0.5, base_cr 30, 32 one-frame chunks in
  sub-batches of 4 (phase 3);
* ``relative``: RELATIVE_ERROR 1e-2, otherwise the same (phase 5;
  ``EBCC_FUSED_CURVE=1`` in the environment switches the fused curve sweep
  on);
* ``rate``: rate mode (RESIDUAL_NONE) at base_cr 30, otherwise the same
  (phase 8);
* ``temporal``: MAX_ERROR 0.5 with ``temporal``, 4 chunks of 8 drifting
  frames in sub-batches of 2 chunks (phase 9);

and reports:

* wall time and points/s of ``roundtrip_frames_device`` over ``--reps`` runs;
* the port's stage timers (``EBCC_TIMING=2``; stages overlap across the
  pipeline's threads, so they attribute work, not latency);
* each sub-batch taken apart, each part synchronised: device encode, the
  small-output fetch, the sparse exchange, host assembly, then the decode's
  host parse and device decode;
* a ``torch.profiler`` trace of one roundtrip: device busy time (the union
  of kernel intervals), the idle share of the wall time, and device time by
  kernel name.

Run from the root of a checkout::

    python3 scripts/torch_roundtrip_breakdown.py [--reps 3] \
        [--mode max_error|relative|rate|temporal] [--out FILE]

A summary goes to stdout, and with ``--out FILE`` the whole JSON result,
including device time by kernel, goes to FILE.
"""

import argparse
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("EBCC_TIMING", "2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--mode", default="max_error",
                    choices=("max_error", "relative", "rate", "temporal"))
    ap.add_argument("--out", help="write the full JSON result here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import ebcc_tpu_torch as et
    from chip_smoke import H, W, drifting_chunks, load_frames
    from ebcc_tpu_torch.core import codec
    from ebcc_tpu_torch.utils import timing

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    n = 32
    frames = load_frames(n)
    mode, error = {"max_error": (et.RESIDUAL_MAX_ERROR, 0.5),
                   "relative": (et.RESIDUAL_RELATIVE_ERROR, 1e-2),
                   "rate": (et.RESIDUAL_NONE, 0.0),
                   "temporal": (et.RESIDUAL_MAX_ERROR, 0.5)}[args.mode]
    temporal = args.mode == "temporal"
    d0, b = (8, 2) if temporal else (1, 4)   # frames per chunk, sub-batch
    config = et.CodecConfig(
        dims=(n, H, W), base_cr=30, residual_mode=mode, error=error,
        chunk_dims=(d0, H, W), zstd_level=3, temporal=temporal)
    opts = et.EncodeOptions()
    if temporal:
        x = torch.from_numpy(drifting_chunks(frames, n // d0, d0)).cuda()
    else:
        x = torch.from_numpy(frames).reshape(n, 1, H, W).cuda()
    et.roundtrip_frames_device(x[:b], config, opts, max_batch=b)  # warm-up

    result = {"card": card, "frames": n, "points": x.numel(),
              "mode": args.mode, "error": error, "frames_per_chunk": d0,
              "fused_curve": os.environ.get("EBCC_FUSED_CURVE", "0") == "1"}

    # ---- end to end ----
    timing.reset_stats()
    walls = []
    for _ in range(args.reps):
        (streams, _dec), wall = _sync_time(
            torch, lambda: et.roundtrip_frames_device(x, config, opts,
                                                      max_batch=b))
        walls.append(wall)
    result["roundtrip_s"] = walls
    result["roundtrip_pts_per_s"] = [x.numel() / w for w in walls]
    result["stream_bytes"] = sum(len(s) for s in streams)
    result["stages_total_s"] = {k: v["total_s"] / args.reps
                                for k, v in timing.snapshot().items()}

    # ---- each sub-batch, part by part ----
    hp, wp = 736, 1440
    backend = codec.entropy.backend_id(config)
    levels = dict(base_levels=config.base_levels,
                  res_levels=config.residual_levels)

    def encode_device(xb):
        if args.mode == "rate":
            return codec.kernels.encode_batch_rate_only(
                xb, codec._rate_budget(config, d0, H, W), **levels)
        if temporal:
            return codec.kernels.encode_batch_temporal(
                xb, config.error, opts.base_quantile_target, **levels)
        return codec.kernels.encode_batch(
            xb, config.error, opts.base_quantile_target,
            relative_mode=args.mode == "relative", **levels)

    parts = []
    for s0 in range(0, x.shape[0], b):
        xb = x[s0:s0 + b]
        out, t_dev = _sync_time(torch, lambda: encode_device(xb))
        small, t_small = _sync_time(torch, lambda: codec._fetch_small(
            {k: v for k, v in out.items() if k != "vals_comb"}))

        def exchange():
            idx = torch.nonzero(out["vals_comb"]).reshape(-1)
            vals = out["vals_comb"][idx].cpu().numpy()
            return idx.to(torch.int32).cpu().numpy(), vals
        (idx, vals), t_exch = _sync_time(torch, exchange)
        small["sparse"] = codec._SparseBatch(idx, vals, b, d0, hp, wp)
        streams_b, t_asm = _sync_time(torch, lambda: codec._assemble_batch(
            small, config, opts, d0, H, W, backend, b))
        _, t_dec = _sync_time(
            torch, lambda: codec._decode_streams_device(streams_b, x.device))
        part = {"chunks": [s0, s0 + b], "nnz": int(idx.size),
                "encode_device_s": t_dev, "fetch_small_s": t_small,
                "exchange_nonzero_d2h_s": t_exch, "assemble_host_s": t_asm,
                "decode_parse_upload_device_s": t_dec}
        if "skip_residual" in small:
            part["residual_chunks"] = int((~small["skip_residual"]).sum())
        if temporal:
            part["skipped_deltas"] = int(small["t_skip"].sum())
        parts.append(part)
    result["sub_batches"] = parts

    # ---- profiler: device busy share and kernel time by name ----
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _sync_time(torch, lambda: et.roundtrip_frames_device(
            x, config, opts, max_batch=b))
    intervals = []
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            s = ev.time_range.start
            e = ev.time_range.end
            intervals.append((s, e))
            d = by_name.setdefault(ev.name, [0, 0.0])
            d[0] += 1
            d[1] += (e - s) / 1e3
    busy_ms = _busy_seconds(intervals) / 1e3
    result["profiled_wall_s"] = wall
    result["device_busy_ms"] = busy_ms
    result["device_idle_share"] = 1.0 - busy_ms / (wall * 1e3)
    result["device_events"] = len(intervals)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    result["device_ms_by_kernel"] = {k: {"count": c, "ms": ms}
                                     for k, (c, ms) in top}

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(card)
    print(json.dumps({k: v for k, v in result.items()
                      if k != "device_ms_by_kernel"}, indent=1))
    for k, (c, ms) in top[:12]:
        print(f"{ms:10.3f} ms {c:7d}x  {k[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
