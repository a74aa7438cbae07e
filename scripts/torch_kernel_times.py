#!/usr/bin/env python3
"""Times the port's wavelet kernels (K1, its float variant, K2, K3) and its
exchange kernel X1 of one checkout on one CUDA card, so that two checkouts
can be compared in turns inside one call.

For each kernel, at the main path's shape (4, 1, 736, 1440) and at the tall
frame (4, 1, 1824, 3616) of a 1801x3600 grid, on the inputs ``chip_smoke.py``
builds (K3: the base call, 5 levels and 8 cuts, and the residual call, 3
levels and 5 cuts on the input modulo 255, over the valid region):
the median time of one wrapper call between two CUDA events (the
smoke's ``ms``, the wrapper's host work included), and from
``torch.profiler`` the CUDA kernels one call launches and the device span of
a call (first kernel's start to last kernel's end), and the device time of
each kernel of one call.  A shape the checkout refuses is recorded with the
error it raised.

X1 (``rice_unpack_qflat``) at five densities, on synthetic pairs with the
pair counts of ``chip_smoke.py`` phase 14c (:data:`X1_DENSITIES`),
packed by the checkout's host library: bit-equality with its plain
version, the device span of a call (its clearing included) and X1's own
kernel time, kernels per call (the library's count and the profiler's),
event ms, the byte bound and the plain ms (``chip_smoke.x1_row``).

Run from the root of a checkout of this repository::

    python3 scripts/torch_kernel_times.py [--root DIR] [--out FILE]

``--root`` names the checkout whose ``ebcc_tpu_torch`` is timed (by default
this one); the helpers come from this checkout's ``chip_smoke.py``.  One
JSON object goes to stdout (and to FILE).
"""

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = 736 * 1440
# name -> (pairs, coefficients of one layer, mean value magnitude): the
# first Rice call of chip_smoke.py phase 3 (MAX_ERROR, a sub-batch of 4
# frames), phase 8 (rate) and phase 9 (temporal, 2 chunks of 8 frames),
# the rate density the encode's pairs would give (25.9M pairs over 8
# sub-batches), and the compaction's cap; the magnitudes put the words near
# the smoke's (5,632 words at MAX_ERROR, 832 at rate, 81,920 temporal).
X1_DENSITIES = {
    "X1 MAX_ERROR": (11715, 4 * FRAME, 2),
    "X1 rate": (2088, 4 * FRAME, 1),
    "X1 temporal": (242676, 16 * FRAME, 1),
    "X1 rate 3.2M": (3240000, 4 * FRAME, 600),
    "X1 cap": (1 << 22, 4 * FRAME, 16),
}


def kernels_of_one_call(torch, fn):
    """[[kernel name, device us], ...] of one call of fn, in launch order."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset")))
    return [[kernel_name(name), round(b - a, 3)] for a, b, name in ev]


def kernel_name(signature):
    """'inv_tile<false>' out of 'void (anonymous namespace)::inv_tile<false>
    (int const*, ...)'."""
    m = re.search(r"(\w+(?:<[^>(]*>)?)\(", signature.replace(
        "(anonymous namespace)", ""))
    return m.group(1) if m else signature[:40]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ebcc_tpu_torch import bench
    from ebcc_tpu_torch.ops import dwt_hopper as dh
    if not os.path.abspath(dh.__file__).startswith(root):
        raise RuntimeError(f"imported {dh.__file__}, not from {root}")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    cs.f32_ops_per_s(torch)
    frames = bench.load_frames(4)
    tall = bench.load_frames(4, cs.TALL_H, cs.TALL_W)
    result = {"root": root, "card": card, "rows": {}}
    gen = torch.Generator(device="cpu").manual_seed(0)
    for shape, src, valid in (((4, 1, 736, 1440), frames, (cs.H, cs.W)),
                              ((4, 1, 1824, 3616), tall,
                               (cs.TALL_H, cs.TALL_W))):
        u = cs.scaled_input(torch, src, shape)
        calls = {k: fn for k, (fn, _, _) in
                 cs.kernel_calls(torch, dh, u, gen).items()}
        r = (u % 255.0).contiguous()
        for name, levels, grid, t, target in (
                ("curve_stats", 5, cs.BASE_GRID, u, 0.5),
                ("curve_stats L3", 3, cs.RES_GRID, r, 0.05)):
            k3 = (dh.dwt2d_quantize_plain(t, levels), t) + tuple(
                torch.full((shape[0],), v, device=u.device)
                for v in (1.0, 0.0, target))
            kw = dict(levels=levels, cut_grid=grid, valid_hw=valid)
            calls[name] = lambda k3=k3, kw=kw: dh.curve_stats(*k3, **kw)
        for name, fn in calls.items():
            key = f"{name} {shape}"
            try:
                fn()
            except ValueError as e:
                result["rows"][key] = {"refused": str(e)}
                print(f"{key}: refused ({e})", flush=True)
                continue
            per_call, device_ms = cs.device_profile(torch, fn)
            row = {"event_ms": cs.median_ms(fn), "device_ms": device_ms,
                   "kernels_per_call": per_call,
                   "kernels_us": kernels_of_one_call(torch, fn)}
            result["rows"][key] = row
            print(f"{key}: {json.dumps(row)}", flush=True)
    from ebcc_tpu_torch.ops import exchange_hopper as xh
    for seed, (key, (n, s, scale)) in enumerate(X1_DENSITIES.items()):
        idx, vals = cs.synthetic_pairs(n, 2 * s, scale, seed)
        x1_args, kw = cs.x1_inputs(torch, idx, vals)
        kw["s"] = s
        fn = lambda: xh.rice_unpack_qflat(*x1_args, **kw)
        row = cs.x1_row(torch, xh, x1_args, kw)
        row["kernels_us"] = kernels_of_one_call(torch, fn)
        result["rows"][key] = row
        print(f"{key}: {json.dumps(row)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
