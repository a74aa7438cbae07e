#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ebcc_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. Card and build: PyTorch version, the card's name and power limit, whether
   ``zstandard`` is importable (without it the codec writes STORE payloads,
   so the printed CR is not the codec's), and the ``nvcc`` build of every
   kernel source under ``ebcc_tpu_torch/csrc/``.
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shape (4, 1, 736, 1440): K1 ``dwt2d_quantize`` at 5 levels, its
   float variant ``dwt2d_transform`` at 3 levels, K2 ``idwt2d_dequant`` at 5
   and 3 levels with random per-chunk cuts; median times of each kernel and
   its plain version.
3. Main path: 32 frames of 721x1440 float32 on the card through
   ``roundtrip_frames_device`` at MAX_ERROR 0.5, base_cr 30, zstd level 3,
   sub-batches of 4; the bound is checked on the card, the streams decode
   again bit-equal through ``decode_frames_device``, the first 8 frames
   encode byte-identically one at a time, every kernel of the
   path must have launched, and a small input encoded on the CPU (the plain
   path the CPU tests hold against the JAX package) must agree with the
   card's encode.
4. K3 ``curve_stats`` against its plain version at (4, 1, 736, 1440): the
   base call (5 levels, cuts 21, 18, ..., 0) and a residual call (3 levels,
   cuts 12, 9, ..., 0); max, min and count equal, the float64 sum within
   its stated tolerance; median times.
5. The fused-curve path: the 32 frames through ``roundtrip_frames_device``
   at RELATIVE_ERROR 1e-2 with ``EBCC_FUSED_CURVE=1``; every chunk within
   1e-2 of its range, ``curve_stats`` launched; the same roundtrip with the
   flag off must make the same cuts and flags, sizes within 1%.
6. POINTWISE_RELATIVE 1e-3 with ``allow_nan`` on 8 frames given as a numpy
   array with NaN over a fixed ~30% mask: ``encode_frames_device`` then
   ``decode_frames_device`` on the card restore every NaN and keep
   |x̂/x - 1| <= 1e-3; ``decode(..., device="cuda")`` of one stream agrees.

The line before the last is a JSON object describing every kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside
a checkout of the repository, the script exits non-zero and prints no
result.  ``EBCC_ERA5_FRAME`` may name a 721x1440 ``.npy`` frame to use as
the base field; without it the base is synthetic.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

H, W = 721, 1440
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores


def load_frames(n):
    """Synthetic ERA5-shaped frames, seed 0 (same generator as bench.py)."""
    path = os.environ.get("EBCC_ERA5_FRAME")
    if path and os.path.exists(path):
        base = np.load(path).astype(np.float32)
    else:
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        base = (260 + 25 * np.sin(yy / H * np.pi) * np.cos(xx / W * 2 * np.pi)
                ).astype(np.float32)
    rng = np.random.default_rng(0)
    frames = []
    for i in range(n):
        f = base + 0.3 * i + smooth_field(rng, 1.0) + rng.normal(
            scale=0.02, size=base.shape)
        frames.append(f.astype(np.float32))
    return np.stack(frames)


def smooth_field(rng, amplitude):
    """An H x W field interpolated bilinearly from a 24 x 46 normal grid."""
    coarse = rng.normal(scale=amplitude, size=(24, 46)).astype(np.float32)
    yi = np.linspace(0, 23, H)
    xi = np.linspace(0, 45, W)
    y0 = np.clip(yi.astype(int), 0, 22)
    x0 = np.clip(xi.astype(int), 0, 44)
    fy = (yi - y0)[:, None].astype(np.float32)
    fx = (xi - x0)[None, :].astype(np.float32)
    c00 = coarse[y0][:, x0]
    c01 = coarse[y0][:, x0 + 1]
    c10 = coarse[y0 + 1][:, x0]
    c11 = coarse[y0 + 1][:, x0 + 1]
    return (c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
            + c10 * fy * (1 - fx) + c11 * fy * fx)


def land_mask(fraction=0.3):
    """A fixed H x W "land" mask of about ``fraction`` of the samples: a
    smooth field (seed 0) below its quantile."""
    field = smooth_field(np.random.default_rng(0), 1.0)
    return field < np.quantile(field, fraction)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def median_ms(fn, reps=20, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def lifting_ops(hp, wp, levels):
    """float32 operations of a multi-level 9/7 transform of one frame: per
    level, two 1-D passes over the (hp>>l, wp>>l) block, each doing 4
    lifting updates of 3 ops on half the samples plus 1 scaling op per
    sample (7 ops per sample per pass)."""
    return sum(2 * 7 * (hp >> l) * (wp >> l) for l in range(levels))


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp_gap(a, b):
    import torch
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


def phase_kernels(torch, dh, frames):
    """Phase 2: every kernel against its plain version at (4, 1, 736, 1440)."""
    from ebcc_tpu_torch.ops import dwt as dwt_ops

    dev = torch.device("cuda")
    x = torch.from_numpy(frames[:4]).reshape(4, 1, H, W).to(dev)
    mn = x.amin(dim=(1, 2, 3), keepdim=True)
    mx = x.amax(dim=(1, 2, 3), keepdim=True)
    u, _ = dwt_ops.pad_to_multiple((x - mn) / (mx - mn) * 65535.0, 32)
    u = u.contiguous()
    b, d0, hp, wp = u.shape
    numel = u.numel()
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = {}

    # K1: forward + truncation, 5 levels.
    qk = dh.dwt2d_quantize(u, 5)
    qp = dh.dwt2d_quantize_plain(u, 5)
    torch.cuda.synchronize()
    diff = (qk.to(torch.int64) - qp.to(torch.int64)).abs()
    n_mis, worst = int((diff > 0).sum()), int(diff.max())
    print(f"K1 dwt2d_quantize L5 {tuple(u.shape)}: {n_mis} mismatches of "
          f"{numel}, largest {worst}")
    if n_mis > 1e-5 * numel or worst > 1:
        raise AssertionError("K1 disagrees with its plain version")
    rows["dwt2d_quantize"] = dict(
        fn=lambda: dh.dwt2d_quantize(u, 5),
        plain=lambda: dh.dwt2d_quantize_plain(u, 5), err=worst,
        nbytes=8 * numel, ops=b * d0 * (lifting_ops(hp, wp, 5) + hp * wp),
        replaces="ebcc_tpu/ops/dwt_pallas.py:130")

    # K1's kernel without truncation: the residual forward transform.
    r = (u[:, :, :, :] % 255.0).contiguous()
    yk = dh.dwt2d_transform(r, 3)
    yp = dh.dwt2d_transform_plain(r, 3)
    torch.cuda.synchronize()
    gap = 0 if torch.equal(yk, yp) else ulp_gap(yk, yp)
    err = float((yk - yp).abs().max())
    print(f"dwt2d_transform L3: bit-equal={gap == 0} largest ulp gap {gap}")
    if gap > 4:
        raise AssertionError("dwt2d_transform disagrees with its plain version")
    rows["dwt2d_transform"] = dict(
        fn=lambda: dh.dwt2d_transform(r, 3),
        plain=lambda: dh.dwt2d_transform_plain(r, 3), err=err,
        nbytes=8 * numel, ops=b * d0 * lifting_ops(hp, wp, 3),
        replaces="ebcc_tpu/core/kernels.py:348 (XLA, no Pallas kernel)")

    # K2 at 5 levels (base) and 3 levels (residual), random per-chunk cuts.
    q3 = dh.dwt2d_quantize_plain(r * 2.37, 3)
    k2 = {}
    for levels, q, planes in ((5, qp, 22), (3, q3, 13)):
        cut = torch.randint(0, planes, (b,), generator=gen,
                            dtype=torch.int32).to(dev)
        ok_ = dh.idwt2d_dequant(q, cut, levels)
        op_ = dh.idwt2d_dequant_plain(q, cut, levels)
        torch.cuda.synchronize()
        gap = 0 if torch.equal(ok_, op_) else ulp_gap(ok_, op_)
        err = float((ok_ - op_).abs().max())
        print(f"K2 idwt2d_dequant L{levels} cuts {cut.tolist()}: "
              f"bit-equal={gap == 0} largest ulp gap {gap}")
        if gap > 4:
            raise AssertionError(f"K2 (L{levels}) disagrees with its plain "
                                 "version")
        k2[levels] = dict(
            fn=lambda q=q, cut=cut, levels=levels: dh.idwt2d_dequant(
                q, cut, levels),
            plain=lambda q=q, cut=cut, levels=levels:
                dh.idwt2d_dequant_plain(q, cut, levels),
            err=err, nbytes=8 * numel + 4 * b,
            ops=b * d0 * (lifting_ops(hp, wp, levels) + 7 * hp * wp),
            replaces="ebcc_tpu/ops/dwt_pallas.py:187")
    rows["idwt2d_dequant"] = k2[5]
    rows["idwt2d_dequant L3"] = k2[3]

    time_rows(rows)
    return rows


def time_rows(rows):
    for name, row in rows.items():
        row["ms"] = median_ms(row["fn"])
        row["plain_ms"] = median_ms(row["plain"])
        row["bound_ms"], row["bound_by"] = bound(row["nbytes"], row["ops"])
        print(f"  {name}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")


BASE_GRID = tuple(range(21, -1, -3))          # 21, 18, ..., 3, 0
RES_GRID = tuple(range(12, -1, -3))            # 12, 9, 6, 3, 0


def phase_curve(torch, dh, frames):
    """Phase 4: K3 ``curve_stats`` against its plain version at
    (4, 1, 736, 1440): the base call (5 levels, 8 cuts) and a residual
    call (3 levels, 5 cuts).  Max, min and count must be equal; the float64
    sums may differ by their summation order, within 1e-9 of n * max|err|
    (a bound on the sum of |err| over the n valid samples)."""
    from ebcc_tpu_torch.ops import dwt as dwt_ops

    dev = torch.device("cuda")
    x = torch.from_numpy(frames[:4]).reshape(4, 1, H, W).to(dev)
    b = x.shape[0]
    mn = x.amin(dim=(1, 2, 3))
    rng_ = x.amax(dim=(1, 2, 3)) - mn
    b4 = lambda v: v[:, None, None, None]
    u, _ = dwt_ops.pad_to_multiple((x - b4(mn)) / b4(rng_) * 65535.0, 32)
    q5 = dh.dwt2d_quantize_plain(u.contiguous(), 5)
    hp, wp = q5.shape[-2:]

    def zero_pad(v):
        out = torch.zeros((b, 1, hp, wp), dtype=torch.float32, device=dev)
        out[..., :H, :W] = v
        return out

    # The residual layer of a base reconstruction at cut 12.
    base = (dh.idwt2d_dequant_plain(q5, 12, 5)[..., :H, :W]
            * b4(rng_ / 65535.0) + b4(mn))
    res = x - base
    rmin = res.amin(dim=(1, 2, 3))
    rrng = res.amax(dim=(1, 2, 3)) - rmin
    rn, _ = dwt_ops.pad_to_multiple((res - b4(rmin)) / b4(rrng) * 255.0, 32)
    q3 = dh.dwt2d_quantize_plain(rn.contiguous(), 3)

    calls = {
        "curve_stats": dict(q=q5, t=zero_pad(x), scale=rng_ / 65535.0,
                            off=mn, target=torch.full_like(mn, 0.5),
                            levels=5, grid=BASE_GRID),
        "curve_stats L3": dict(q=q3, t=zero_pad(res), scale=rrng / 255.0,
                               off=rmin, target=torch.full_like(mn, 0.05),
                               levels=3, grid=RES_GRID),
    }
    rows = {}
    n_valid = H * W
    for name, c in calls.items():
        kw = dict(levels=c["levels"], cut_grid=c["grid"], valid_hw=(H, W))
        args = (c["q"], c["t"], c["scale"], c["off"], c["target"])
        got = dh.curve_stats(*args, **kw)
        want = dh.curve_stats_plain(*args, **kw)
        torch.cuda.synchronize()
        exact = all(torch.equal(got[..., i], want[..., i]) for i in (1, 2, 3))
        maxabs = float(torch.maximum(want[..., 1].abs(),
                                     want[..., 2].abs()).max())
        sum_err = float((got[..., 0] - want[..., 0]).abs().max())
        tol = 1e-9 * n_valid * maxabs
        print(f"K3 {name} ({c['levels']} levels, cuts {c['grid']}): max/min/count "
              f"equal={exact}, largest sum difference {sum_err:.3e} "
              f"(tolerance {tol:.3e})")
        if not exact or sum_err > tol:
            raise AssertionError(f"K3 ({name}) disagrees with its plain "
                                 "version")
        n_cuts = len(c["grid"])
        per_cut = (lifting_ops(hp, wp, c["levels"]) + 7 * hp * wp
                   + 8 * n_valid)
        rows[name] = dict(
            fn=lambda args=args, kw=kw: dh.curve_stats(*args, **kw),
            plain=lambda args=args, kw=kw: dh.curve_stats_plain(*args, **kw),
            err=sum_err, nbytes=8 * c["q"].numel() + 32 * n_cuts * b,
            ops=b * n_cuts * per_cut,
            replaces="ebcc_tpu/ops/dwt_pallas.py:253")
    time_rows(rows)
    return rows


def phase_main_path(torch, et, dh, frames, card):
    """Phase 3: the port's main path, the roundtrip of 32 frames."""
    from ebcc_tpu_torch.core import entropy

    dev = torch.device("cuda")
    n = frames.shape[0]
    config = et.CodecConfig(
        dims=(n, H, W), base_cr=30, residual_mode=et.RESIDUAL_MAX_ERROR,
        error=0.5, chunk_dims=(1, H, W), zstd_level=3)
    opts = et.EncodeOptions()
    x = torch.from_numpy(frames).reshape(n, 1, H, W).to(dev)
    torch.cuda.synchronize()

    # Warm-up on one sub-batch (CUDA context, allocator, library loads).
    et.roundtrip_frames_device(x[:4], config, opts, max_batch=4)
    torch.cuda.synchronize()

    dh.reset_launch_counts()
    t0 = time.perf_counter()
    streams, dec = et.roundtrip_frames_device(x, config, opts, max_batch=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dh.launch_counts()

    maxerr = float((x - dec).abs().max())
    if not (dec.shape == x.shape and bool(torch.isfinite(dec).all())):
        raise AssertionError(f"decoded batch has shape {tuple(dec.shape)} "
                             "or non-finite values")
    if maxerr > config.error:
        raise AssertionError(f"max error {maxerr} exceeds {config.error}")
    dec2 = et.decode_frames_device(streams, max_batch=4)
    torch.cuda.synchronize()
    if not torch.equal(dec, dec2):
        raise AssertionError("decode_frames_device differs from the "
                             "roundtrip's decode")
    if et.encode_frames_device(x[:8], config, opts, max_batch=1) != \
            streams[:8]:
        raise AssertionError("streams depend on the batch partitioning")
    nbytes = sum(len(s) for s in streams)
    cr = x.numel() * 4 / nbytes
    backend = entropy.default_backend()
    print(f"main path on {card}: {n} frames {H}x{W}, roundtrip {wall:.4f} s, "
          f"{x.numel() / wall:.1f} pts/s, CR {cr:.3f} (entropy backend "
          f"{'zstd' if backend == entropy.BACKEND_ZSTD else 'STORE'}), "
          f"max error {maxerr:.6f}")
    print(f"launches on the main path: {launches}")
    missing = [k for k in ("dwt2d_quantize", "dwt2d_transform",
                           "idwt2d_dequant") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    # Small input: the CPU plain path (held against the JAX package by the
    # CPU tests) and the card must agree.
    small = frames[:1, :128, :256].copy()
    cfg_s = et.CodecConfig(dims=small.shape, residual_mode=et.RESIDUAL_MAX_ERROR,
                           error=0.5, zstd_level=3)
    s_cpu = et.encode(small, cfg_s, opts, device="cpu")
    s_gpu = et.encode(small, cfg_s, opts, device="cuda")
    for s in (s_cpu, s_gpu):
        for d in ("cpu", "cuda"):
            e = float(np.abs(et.decode(s, device=d) - small).max())
            if e > 0.5:
                raise AssertionError(f"small-input decode error {e}")
    rel = abs(len(s_cpu) - len(s_gpu)) / len(s_cpu)
    print(f"small input: CPU stream {len(s_cpu)} B, card stream "
          f"{len(s_gpu)} B, byte-identical={s_cpu == s_gpu}")
    if rel > 0.01:
        raise AssertionError("CPU and card stream sizes differ by > 1%")
    return launches, wall, cr


def phase_relative(torch, et, dh, frames, card):
    """Phase 5: the fused-curve path, RELATIVE_ERROR 1e-2 on the 32 frames
    through ``roundtrip_frames_device`` with EBCC_FUSED_CURVE=1; then the
    same roundtrip with the flag off, for its launches and streams."""
    from ebcc_tpu_torch.core import stream

    dev = torch.device("cuda")
    n = frames.shape[0]
    rel = 1e-2
    config = et.CodecConfig(
        dims=(n, H, W), base_cr=30, residual_mode=et.RESIDUAL_RELATIVE_ERROR,
        error=rel, chunk_dims=(1, H, W), zstd_level=3)
    opts = et.EncodeOptions()
    x = torch.from_numpy(frames).reshape(n, 1, H, W).to(dev)
    bound_c = rel * (x.amax(dim=(1, 2, 3)) - x.amin(dim=(1, 2, 3)))

    def run(fused):
        os.environ["EBCC_FUSED_CURVE"] = "1" if fused else "0"
        try:
            et.roundtrip_frames_device(x[:4], config, opts, max_batch=4)
            torch.cuda.synchronize()
            dh.reset_launch_counts()
            t0 = time.perf_counter()
            streams, dec = et.roundtrip_frames_device(x, config, opts,
                                                      max_batch=4)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dh.launch_counts()
        finally:
            os.environ.pop("EBCC_FUSED_CURVE")
        err_c = (x - dec).abs().amax(dim=(1, 2, 3))
        if not (dec.shape == x.shape and bool(torch.isfinite(dec).all())):
            raise AssertionError("relative roundtrip: bad decoded batch")
        if not bool((err_c <= bound_c).all()):
            raise AssertionError("relative roundtrip exceeds error * range "
                                 f"(fused={fused})")
        print(f"relative {rel} on {card}, fused curve {fused}: {n} frames, "
              f"roundtrip {wall:.4f} s, {x.numel() / wall:.1f} pts/s, "
              f"largest error/bound {float((err_c / bound_c).max()):.6f}")
        print(f"  launches: {launches}")
        return streams, launches

    streams_f, launches_f = run(True)
    if launches_f["curve_stats"] == 0:
        raise AssertionError("curve_stats not launched on the fused path")
    streams_u, launches_u = run(False)

    def decisions(s):
        hd = stream.split_frame_stream(s)[0]
        return (hd.flags, hd.base_cut, hd.res_cut)

    same = sum(a == b for a, b in zip(streams_f, streams_u))
    size_rel = max(abs(len(a) - len(b)) / len(b)
                   for a, b in zip(streams_f, streams_u))
    differ = [i for i, (a, b) in enumerate(zip(streams_f, streams_u))
              if decisions(a) != decisions(b)]
    print(f"fused vs unfused: {same} of {n} streams byte-identical, largest "
          f"size difference {size_rel:.6f}, chunks with other cuts/flags "
          f"{differ}")
    print(f"  K2 launches {launches_u['idwt2d_dequant']} -> "
          f"{launches_f['idwt2d_dequant']}, K3 launches "
          f"{launches_f['curve_stats']}, residual sweeps "
          f"{launches_f['dwt2d_transform']} of {n // 4} batches")
    if differ or size_rel > 0.01:
        raise AssertionError("fused and unfused encodes disagree")
    return launches_f


def phase_pointwise_masked(torch, et, dh, frames, card):
    """Phase 6: POINTWISE_RELATIVE 1e-3 with allow_nan on 8 frames given
    as a numpy array with NaN over a fixed ~30% "land" mask: NaNs must come
    back exactly at the mask and |x̂/x - 1| <= 1e-3 on every valid
    sample."""
    eps = 1e-3
    mask = land_mask()
    data = frames[:8].reshape(8, 1, H, W).copy()
    data[:, :, mask] = np.nan
    config = et.CodecConfig(
        dims=(8, H, W), base_cr=30,
        residual_mode=et.RESIDUAL_POINTWISE_RELATIVE_ERROR, error=eps,
        chunk_dims=(1, H, W), zstd_level=3, allow_nan=True)
    opts = et.EncodeOptions()
    dh.reset_launch_counts()
    t0 = time.perf_counter()
    streams = et.encode_frames_device(data, config, opts, max_batch=4)
    dec = et.decode_frames_device(streams, max_batch=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dh.launch_counts()
    if dec.device.type != "cuda":
        raise AssertionError("pointwise decode left the card")
    x = torch.from_numpy(data).to(dec.device)
    nan_x = torch.isnan(x)
    if not torch.equal(torch.isnan(dec), nan_x):
        raise AssertionError("NaNs not restored exactly at the mask")
    ratio = float((dec[~nan_x] / x[~nan_x] - 1).abs().max())
    if ratio > eps:
        raise AssertionError(f"pointwise bound broken: {ratio} > {eps}")
    one = et.decode(streams[0], device="cuda")
    if not np.array_equal(one, dec[0].cpu().numpy(), equal_nan=True):
        raise AssertionError("decode() differs from decode_frames_device")
    size = sum(len(s) for s in streams)
    print(f"pointwise {eps} + allow_nan on {card}: 8 frames, "
          f"{float(mask.mean()):.4f} masked, encode+decode {wall:.4f} s, "
          f"largest |x^/x - 1| {ratio:.3e}, {size} stream bytes, launches "
          f"{launches}")
    missing = [k for k in ("dwt2d_quantize", "idwt2d_dequant")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched: {missing}")


def main():
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "ebcc_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import ebcc_tpu_torch as et
    from ebcc_tpu_torch.ops import _build
    from ebcc_tpu_torch.ops import dwt_hopper as dh

    # ---- phase 1: card and build ----
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"card: {card}")
    try:
        import zstandard  # noqa: F401
        print("zstandard: importable")
    except ImportError:
        print("zstandard: NOT importable; payloads are STORE and the CR "
              "printed below is not the codec's")
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        list(pool.map(_build.load, sources))
    print(f"built {sources} in {time.perf_counter() - t0:.2f} s "
          f"({_build.BUILD_SECONDS})")

    # ---- phase 2: kernels against their plain versions ----
    frames = load_frames(32)
    rows = phase_kernels(torch, dh, frames)
    print(f"card: {card}")

    # ---- phase 3: main path ----
    launches, wall, cr = phase_main_path(torch, et, dh, frames, card)

    # ---- phase 4: K3 against its plain version ----
    rows.update(phase_curve(torch, dh, frames))

    # ---- phase 5: the fused-curve path, RELATIVE_ERROR ----
    launches["curve_stats"] = phase_relative(
        torch, et, dh, frames, card)["curve_stats"]

    # ---- phase 6: POINTWISE_RELATIVE with allow_nan ----
    phase_pointwise_masked(torch, et, dh, frames, card)

    src = "ebcc_tpu_torch/csrc/dwt97.cu"
    kernels = []
    for name in ("dwt2d_quantize", "dwt2d_transform", "idwt2d_dequant",
                 "curve_stats"):
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": row["replaces"], "launches": launches[name],
            "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
