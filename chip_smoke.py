#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ebcc_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. Card and build: PyTorch version, the card's name and power limit, the
   zstd binding the ZSTD backend uses (``zstandard``, or ``libzstd.so.1``
   through ``ctypes`` where the module is missing) and libzstd's version
   (the run fails with neither: STORE payloads would make every CR below
   another codec's), the ``nvcc`` build of every kernel source under
   ``ebcc_tpu_torch/csrc/`` and, at the same time, the ``c++`` build of the
   host libraries (the CAB coder with PGO where the compiler can run it;
   phase 12a prints which build each got).
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shape (4, 1, 736, 1440): K1 ``dwt2d_quantize`` at 5 levels, its
   float variant ``dwt2d_transform`` at 3 levels, K2 ``idwt2d_dequant`` at 5
   and 3 levels with random per-chunk cuts; median times of each kernel and
   its plain version (CUDA events around one call, the wrapper's host work
   included); the kernels one call launches, from the kernels' library's
   own count (a 5-level K2 call may launch at most 4, a 3-level one 3); and
   from ``torch.profiler`` the CUDA kernels and the device span of a call
   (printed, "not measured" when three sessions give no whole calls).  Then the same checks at the edge shapes
   (2, 1, 96, 160), (1, 2, 224, 416), (1, 1, 32, 64) (levels shrink to 1-2
   samples), (4, 1, 1824, 3616) (a 1801x3600 grid, padded; timed too) and
   (2, 1, 1024, 1024) (the compat tiles of phase 11; timed too).
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
   its stated tolerance; median times, device spans, the kernels one call
   launches by the library's count (a base call may launch at most 5, a
   residual call 4), and the CUDA kernels of one call with each one's
   device time.  A 22-cut grid (every base plane, three groups of
   cuts) against the plain version, and an unordered grid with a repeated
   cut whose every row must equal a one-cut call's.  Then the base and
   residual calls at the edge shapes of phase 2, with a valid region short
   of the padding, and the 22-cut grid at the tall one.
5. The fused-curve path: the 32 frames through ``roundtrip_frames_device``
   at RELATIVE_ERROR 1e-2 with ``EBCC_FUSED_CURVE=1``; every chunk within
   1e-2 of its range, ``curve_stats`` launched; the same roundtrip with the
   flag off must make the same cuts and flags and byte-identical streams.
6. POINTWISE_RELATIVE 1e-3 with ``allow_nan`` on 8 frames given as a numpy
   array with NaN over a fixed ~30% mask: ``encode_frames_device`` then
   ``decode_frames_device`` on the card restore every NaN and keep
   |x̂/x - 1| <= 1e-3; ``decode(..., device="cuda")`` of one stream agrees.
7. 4 frames of 1801x3600 (a 0.1-degree grid, padded to 1824x3616) through
   ``roundtrip_frames_device`` at MAX_ERROR 0.5; the bound is checked on the
   card and K1 and K2 must have launched.
8. Rate mode (RESIDUAL_NONE, the config's default): K1 must equal the
   truncation of its float variant at (4, 1, 736, 1440), bit for bit (rate
   mode takes K1); the 32 frames through ``roundtrip_frames_device`` at
   base_cr 30, sub-batches of 4: every stream within raw bytes / 30, the
   budget use, max error and RMSE printed, the decode again bit-equal, the
   first 4 frames byte-identical one at a time, K1 and K2 launched.  8
   frames at base_cr 4 take a budget 7.5x larger, which with zstd holds
   every plane (cut 0, no partial plane): the search's other end; a
   128x256 input at base_cr 8 must make the same cut and flags on the CPU
   and on the card.
9. Temporal mode: 4 chunks of 8 frames (frame c advected 0.7 samples per
   step plus a drift) at MAX_ERROR 0.5 through ``roundtrip_frames_device``,
   sub-batches of 2 chunks: every frame within 0.5, the decode equal bit
   for bit to the reconstruction the encoder carried, a chunk alone
   byte-identical to the same chunk in the batch, ``decode`` of one stream
   on the card agrees; stream bytes beside an intra encode of the same
   frames and the delta frames skipped; K1, its float variant and K2
   launched.
10. Lossless mode: 8 frames (2 chunks of 4) with NaN, +-Inf and -0.0, a
    tensor on the card through ``encode_frames_device`` and
    ``decode_frames_device``: bit-exact, no kernel launched (host work).
11. ETPK containers: (a) the 32 frames of phase 3 through
    ``encode_chunked`` in one-frame chunks, ``max_batch=4``: every record
    byte-identical to phase 3's stream, ``decode_chunked`` within 0.5, K1
    and K2 launched, wall times beside ``encode_frames_device`` and the
    host gather and scatter; (b) the 4 frames of phase 7 through
    ``encode_chunked_compat`` in (1, 1024, 1024) tiles (32 chunks, 29.4%
    edge padding): the full decode within 0.5, a region decode that
    touches 8 chunks equal to the crop of the full decode bit for bit; (c)
    ``compress_stream`` from an ``np.memmap`` of the 32 frames writes (a)'s
    container byte for byte, ``append_chunked_file`` adds 8 frames, a
    region across the append holds 0.5, ``repair_chunked_file`` removes
    nothing; (d) phase 9's drifting frames as one (32, 721, 1440) array
    through ``encode_chunked_compat`` with ``temporal=True``: 4 chunks of
    8 frames, every record byte-identical to phase 9's stream, every frame
    within 0.5.
12. Host C++ (``ebcc_tpu_torch/csrc/host/``): (a) the build seconds of
    ``libebcc_host.so`` (built in phase 1 beside the kernels), whether
    ``zstd.h`` and ``libzstd`` exist, and the build of
    ``libebcc_native_codec.so`` from the port's zstd declarations (the run
    fails without it); (b) the 32 frames of phase 3 through
    ``roundtrip_frames_device`` with ``entropy_backend`` cab, cab2 and
    auto (CAB against zstd, the backends it kept counted): every frame
    within 0.5, K1 and K2 launched, the decode again
    bit-equal, stream bytes, CR and host stage times; (c) the native
    packer and unpacker against their numpy twins: phase 3's encode
    byte-identical with ``EBCC_NO_NATIVE_PACK=1``, phase 3's and phase 9's
    streams decoded bit-equal with ``EBCC_NO_NATIVE_UNPACK=1``, with the
    ``dec: unpack planes`` thread time and decode walls of each; (d) phase
    8's rate roundtrip with the host assembly time per sub-batch; (e)
    native routing: 4 frames encoded through the host codec (zstd) and
    decoded on the card, (b)'s streams and phase 11a's container decoded
    through it, all within 0.5.
13. Scale-out and the user surfaces: (a) the 32 frames of phase 3 through
    ``encode_chunked_sharded`` over ``make_mesh()`` (every visible card;
    ``torch.cuda.device_count()`` printed) in one-frame chunks,
    ``max_batch=4``: the container byte-identical to phase 11a's,
    ``decode_chunked_sharded`` bit-equal to ``decode_chunked``, K1 and K2
    launched, ``global_range`` equal to numpy's, wall times beside
    ``encode_chunked``'s, and ``dryrun_multidevice(1)``; (b) two processes
    (this script with ``--worker encode``) in a gloo group through
    ``multihost.initialize``, each coding its 16 chunks on ``cuda:0``: the
    merged container byte-identical to phase 11a's, each rank's cross-rank
    ``global_range`` right and its K1/K2 launched, the 2-rank wall beside
    one process's encode of all 32; (c) one NCCL rank (``--worker nccl``):
    ``all_reduce`` MIN and MAX of a CUDA tensor, ``global_range`` through
    the group; (d) ``python -m ebcc_tpu_torch.api.cli`` as processes:
    ``spec`` prints the JAX package's string, ``compress`` of 4 frames,
    ``decompress`` within 0.5, ``decompress --region`` equal to the crop;
    (e) ``utils.profiling.trace`` around a 4-frame roundtrip writes a
    Chrome trace that names K2's kernels and the trace's annotation.  A
    failing process fails the phase.

14. The exchange (``core/transfer.py``), on the 32 frames of phase 3
    (MAX_ERROR 0.5, ``max_batch`` 4), phase 8's rate frames and phase 9's
    temporal chunks: (a) each encoded in the default form (compact Rice),
    again (every sub-batch hinted: one copy of the small outputs and the
    pair buffer) and with ``EBCC_NO_RICE=1`` (``torch.nonzero``): streams
    byte-identical to those phases', down bytes per significant
    coefficient and per point, the ``enc:`` stage times, the walls; (b)
    each set of streams decoded through the blocked-Rice, nibble, byte,
    bitmap and index uploads: bit-equal to the index form, up bytes per
    significant coefficient, the ``dec:`` stage times, the walls, the
    launches of X1 and K2; (c) X1 ``rice_unpack_qflat`` against its plain
    version, bit-equal, on the blocks of (b)'s first Rice call of each of
    the three runs, at nnz 0, 1, 127, 128, 129, an escape in every block, k
    at its clamp of 11, a lane ending in the stream's last 3 words, windows
    clipped at the stream's end, 128 escapes in a block (6,656-bit lanes),
    nnz 1024 with padded lanes, and 2^22 pairs at the compaction's cap;
    at the three runs' calls and the cap its pairs, lanes, device span, X1
    kernels' own time, kernels per call (the library's count, at most 3),
    event, plain and byte-bound times; (d) the 32
    frames as a numpy array with the u16 upload: within 0.5 of the float
    originals, upload bytes per point against the float upload, K1
    launched; (e) the link probe both ways, ``backend_choice`` for encode
    and decode, and under ``EBCC_LINK_MBPS=1`` the decision and an explicit
    native route's encode, decoded on the card within 0.5.
15. The host modules of the JAX package (no kernel: every launch count
    must stay 0): (a) legacy EBCC/EBCK (``ebcc_tpu_torch.compat``; Pillow's
    version and JPEG 2000 support printed): ``LEGACY_FRAMES`` frames of
    721x1440 through ``compat.encode_chunked`` in (1, 721, 1440) chunks at
    MAX_ERROR 0.5, base_cr 30, and one frame through ``encode_frame`` at
    RELATIVE_ERROR 1e-2: each within its bound through ``compat.decode``
    and ``ebcc_tpu_torch.decode(..., device="cuda")``, a truncated stream
    raising ``LegacyFormatError``, encode and decode walls and bytes; (b)
    the HDF5 filter plugin: its build seconds, its filter called through
    ``H5PLget_plugin_info()`` on a (4, 721, 1440) chunk at MAX_ERROR 0.5,
    the encoded bytes decoded on the card within 0.5, the reverse flag
    equal to ``native.native_decode``; where ``h5py`` imports, a dataset
    written and read through it in a process whose ``HDF5_PLUGIN_PATH``
    names the port's plugin directory alone; (c) native routing built (the
    host codec's build seconds and what phases 12e and 14e ran); (d) the
    CAB coder with PGO and without it, each its own ``libebcc_host.so``:
    phase 12b's ``cab`` roundtrip on each (PGO, plain, plain, PGO),
    streams byte-identical, ``assemble+zstd`` and ``dec: entropy decode``
    of each run and both build times; (e) ``compat.reference_bin``, which
    raises ``ReferenceUnavailable`` without the reference's sources.
16. The port's bench (``ebcc_tpu_torch.bench``, the JAX package's
    ``bench.py`` on the card): ``bench.run(device="cuda", frames=8,
    reps=1)`` with every section on; its JSON line printed on a line of its
    own; every error field within its bound, every rate and ratio positive
    (the reference binary's fields ``null``), ``device`` naming the card
    and its power limit, and K1, K2 and X1 launched in the headline
    section (each wrapper's count; the launches and seconds of every
    section go to stderr).

Phases 3, 5, 7, 8, 9 and 12 print the total stream bytes or the budget use of
their roundtrips, and phases 3, 8 and 9 the launches of each kernel in the
run (X1 ``rice_unpack_qflat`` among them: every decode's default upload).

The line before the last is a JSON object describing every kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside
a checkout of the repository, the script exits non-zero and prints no
result.  ``EBCC_ERA5_FRAME`` may name a 721x1440 ``.npy`` frame to use as
the base field; without it the base is synthetic.
"""

import argparse
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

H, W = 721, 1440
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
# Separately rounded float32 adds or multiplies the card issues per second
# (the kernels never contract them into an FMA): SMs x 128 lanes x the
# maximum SM clock, set by f32_ops_per_s() from the card at hand.
F32_OPS_PER_S = None


def land_mask(fraction=0.3):
    """A fixed H x W "land" mask of about ``fraction`` of the samples: a
    smooth field (seed 0) below its quantile."""
    from ebcc_tpu_torch.bench import smooth_field
    field = smooth_field(np.random.default_rng(0), 1.0)
    return field < np.quantile(field, fraction)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def f32_ops_per_s(torch):
    """multi_processor_count x 128 x the card's maximum SM clock."""
    global F32_OPS_PER_S
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    F32_OPS_PER_S = sms * 128 * float(mhz) * 1e6
    return F32_OPS_PER_S


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


EDGE_SHAPES = ((2, 1, 96, 160), (1, 2, 224, 416), (1, 1, 32, 64),
               (4, 1, 1824, 3616), (2, 1, 1024, 1024))
TALL_H, TALL_W = 1801, 3600     # a 0.1-degree grid, padded to 1824 x 3616
COMPAT_TILE = 1024              # compat tiles of phase 11b: 2 x 4 per frame
COMPAT_REGION = ((0, 4), (200, 550), (900, 1300))   # 8 of its 32 chunks


def scaled_input(torch, frames, shape):
    """(B, D0, Hp, Wp) float32 on the card: frames padded to a multiple of
    32 and cropped to (Hp, Wp), each scaled to [0, 65535] as the base layer
    scales them."""
    from ebcc_tpu_torch.ops import dwt as dwt_ops
    b, d0, hp, wp = shape
    x = torch.from_numpy(frames[np.arange(b * d0) % len(frames)]).cuda()
    x, _ = dwt_ops.pad_to_multiple(x, 32)
    x = x[:, :hp, :wp]
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    return ((x - mn) / (mx - mn) * 65535.0).reshape(shape).contiguous()


def check_ints(name, got, want):
    """K1's rule: integers equal except at truncation boundaries (at most
    1e-5 of them, none off by more than 1).  Returns the largest gap."""
    import torch
    torch.cuda.synchronize()
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    n_mis, worst = int((diff > 0).sum()), int(diff.max())
    print(f"{name}: {n_mis} mismatches of {want.numel()}, largest {worst}")
    if n_mis > 1e-5 * want.numel() or worst > 1:
        raise AssertionError(f"{name} disagrees with its plain version")
    return worst


def check_floats(name, got, want):
    """The float kernels' rule: bit-equal by construction, a gap of at most
    4 ulp tolerated.  Returns the largest absolute difference."""
    import torch
    torch.cuda.synchronize()
    gap = 0 if torch.equal(got, want) else ulp_gap(got, want)
    print(f"{name}: bit-equal={gap == 0} largest ulp gap {gap}")
    if gap > 4:
        raise AssertionError(f"{name} disagrees with its plain version")
    return float((got - want).abs().max())


def kernel_calls(torch, dh, u, gen):
    """The calls phase 2 makes at one shape: K1 at 5 levels, its float
    variant at 3, K2 at 5 and 3 levels with random per-chunk cuts, each
    beside its plain version, keyed by row name."""
    b = u.shape[0]
    r = (u % 255.0).contiguous()
    q5 = dh.dwt2d_quantize_plain(u, 5)
    q3 = dh.dwt2d_quantize_plain(r * 2.37, 3)
    cut5, cut3 = (torch.randint(0, planes, (b,), generator=gen,
                                dtype=torch.int32).cuda() for planes in (22, 13))
    return {
        "dwt2d_quantize": (lambda: dh.dwt2d_quantize(u, 5),
                           lambda: dh.dwt2d_quantize_plain(u, 5),
                           "K1 dwt2d_quantize L5"),
        "dwt2d_transform": (lambda: dh.dwt2d_transform(r, 3),
                            lambda: dh.dwt2d_transform_plain(r, 3),
                            "dwt2d_transform L3"),
        "idwt2d_dequant": (lambda: dh.idwt2d_dequant(q5, cut5, 5),
                           lambda: dh.idwt2d_dequant_plain(q5, cut5, 5),
                           f"K2 idwt2d_dequant L5 cuts {cut5.tolist()}"),
        "idwt2d_dequant L3": (lambda: dh.idwt2d_dequant(q3, cut3, 3),
                              lambda: dh.idwt2d_dequant_plain(q3, cut3, 3),
                              f"K2 idwt2d_dequant L3 cuts {cut3.tolist()}"),
    }


def check_calls(calls, shape):
    """Runs every call of :func:`kernel_calls` once against its plain
    version; returns {row: largest error}."""
    errs = {}
    for name, (fn, plain, label) in calls.items():
        check = check_ints if name == "dwt2d_quantize" else check_floats
        errs[name] = check(f"{label} {shape}", fn(), plain())
    return errs


def frame_ops(name, hp, wp):
    """float32 operations of one frame of a phase-2 row: the lifting, plus
    the truncation (K1) or the ~7 dequantization ops (K2) per sample."""
    levels = 3 if name.endswith("L3") or name == "dwt2d_transform" else 5
    extra = {"dwt2d_quantize": 1, "dwt2d_transform": 0}.get(name, 7)
    return lifting_ops(hp, wp, levels) + extra * hp * wp


def device_profile(torch, fn, calls=5, sessions=3):
    """(CUDA kernels one call of fn launches, median device span of a call
    in ms: its first kernel's start to its last kernel's end), from one
    torch.profiler session over calls + 1 calls in a row, the first left
    out; a session whose device events do not split into calls + 1 equal
    calls is printed and taken again, up to ``sessions`` in all; (None,
    None) when none does."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls + 1):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.name.startswith(("Memcpy", "Memset")))
        if ev and not len(ev) % (calls + 1):
            per = len(ev) // (calls + 1)
            spans = [(ev[k + per - 1][1] - ev[k][0]) / 1e3
                     for k in range(per, len(ev), per)]
            return per, statistics.median(spans)
        print(f"  device profile: {len(ev)} device events over "
              f"{calls + 1} calls: {sorted({n[:60] for _, _, n in ev})}")
    return None, None


def reset_all_counts(dh):
    """Every wrapper's launch count set to 0: the kernels of
    ``dwt_hopper`` and X1 of ``exchange_hopper``."""
    from ebcc_tpu_torch.ops import exchange_hopper as xh
    dh.reset_launch_counts()
    xh.reset_launch_counts()


def all_counts(dh):
    from ebcc_tpu_torch.ops import exchange_hopper as xh
    return {**dh.launch_counts(), **xh.launch_counts()}


def kernels_launched(torch, dh, fn):
    """CUDA kernels one call of fn launches, from the kernels' library's
    own count at its launch sites (no profiler)."""
    torch.cuda.synchronize()
    before = dh.cuda_kernels_launched()
    fn()
    torch.cuda.synchronize()
    return dh.cuda_kernels_launched() - before


def phase_kernels(torch, dh, frames, tall):
    """Phase 2: every kernel against its plain version at the main path's
    shape (4, 1, 736, 1440), timed, with the CUDA kernels each call
    launches; then again at every edge shape of EDGE_SHAPES."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    u = scaled_input(torch, frames, (4, 1, 736, 1440))
    b, d0, hp, wp = u.shape
    numel = u.numel()
    calls = kernel_calls(torch, dh, u, gen)
    errs = check_calls(calls, tuple(u.shape))
    replaces = {"dwt2d_quantize": "ebcc_tpu/ops/dwt_pallas.py:130",
                "dwt2d_transform":
                    "ebcc_tpu/core/kernels.py:348 (XLA, no Pallas kernel)",
                "idwt2d_dequant": "ebcc_tpu/ops/dwt_pallas.py:187",
                "idwt2d_dequant L3": "ebcc_tpu/ops/dwt_pallas.py:187"}
    rows = {name: dict(fn=fn, plain=plain, err=errs[name],
                       nbytes=8 * numel + (4 * b if "dequant" in name else 0),
                       ops=b * d0 * frame_ops(name, hp, wp),
                       replaces=replaces[name])
            for name, (fn, plain, _) in calls.items()}
    time_rows(rows)
    profile_rows(torch, dh, rows)
    for name, most in (("idwt2d_dequant", 4), ("idwt2d_dequant L3", 3)):
        if not 0 < rows[name]["launched"] <= most:
            raise AssertionError(f"{name}: {rows[name]['launched']} kernels "
                                 f"launched, 1 to {most} expected")

    for shape in EDGE_SHAPES:
        src = tall if shape[2] > 736 or shape[3] > 1440 else frames
        ue = scaled_input(torch, src, shape)
        calls_e = kernel_calls(torch, dh, ue, gen)
        check_calls(calls_e, shape)
        if shape[2] > 736:
            tall_rows = {f"{k} {shape}": dict(
                fn=fn, plain=plain, nbytes=8 * ue.numel(),
                ops=shape[0] * shape[1] * frame_ops(k, *shape[2:]))
                for k, (fn, plain, _) in calls_e.items()
                if k in ("dwt2d_quantize", "idwt2d_dequant")}
            time_rows(tall_rows)
            profile_rows(torch, dh, tall_rows)
    return rows


def profile_rows(torch, dh, rows):
    """Adds each row's kernels launched per call (the library's count), its
    CUDA kernels per call and its device span per call (the profiler's)."""
    for name, row in rows.items():
        row["launched"] = kernels_launched(torch, dh, row["fn"])
        row["per_call"], row["device_ms"] = device_profile(torch, row["fn"])
        print(f"  {name}: {row['launched']} kernels launched per call; "
              + (f"{row['per_call']} CUDA kernels per call, device span "
                 f"{row['device_ms']:.4f} ms" if row["per_call"]
                 else "device profile not measured"))


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
ALL_BASE_CUTS = tuple(range(21, -1, -1))       # every base plane: 22 cuts
UNORDERED_GRID = (0, 6, 6, 12)


def kernel_times_module():
    """``scripts/torch_kernel_times.py`` of this checkout, as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "torch_kernel_times.py")
    spec = importlib.util.spec_from_file_location("torch_kernel_times", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_rows_independent(torch, dh, name, args, kw):
    """Every row of a call on kw's grid equals the row of a one-cut call
    at that cut: a row depends on no other cut of the grid."""
    got = dh.curve_stats(*args, **kw)
    for k, cut in enumerate(kw["cut_grid"]):
        one = dh.curve_stats(*args, **dict(kw, cut_grid=(cut,)))
        if not torch.equal(got[k], one[0]):
            raise AssertionError(f"K3 ({name}): the row of cut {cut} "
                                 "depends on the grid")
    print(f"K3 {name}: rows of grid {kw['cut_grid']} equal one-cut calls")


def phase_curve(torch, dh, frames, tall):
    """Phase 4: K3 ``curve_stats`` against its plain version at
    (4, 1, 736, 1440): the base call (5 levels, 8 cuts) and a residual
    call (3 levels, 5 cuts), timed; then both at every edge shape of
    EDGE_SHAPES.  Max, min and count must be equal; the float64 sums may
    differ by their summation order, within 1e-9 of n * max|err| (a bound
    on the sum of |err| over the n valid samples)."""
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
        sum_err = check_curve(torch, dh, f"{name} {tuple(c['q'].shape)}",
                              args, kw)
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
    profile_rows(torch, dh, rows)
    ktm = kernel_times_module()
    for name, most in (("curve_stats", 5), ("curve_stats L3", 4)):
        row = rows[name]
        print(f"  {name}: kernels of one call (device us): "
              f"{ktm.kernels_of_one_call(torch, row['fn'])}")
        if not 0 < row["launched"] <= most:
            raise AssertionError(f"{name}: {row['launched']} kernels "
                                 f"launched per call, 1 to {most} expected")

    c = calls["curve_stats"]
    args = (c["q"], c["t"], c["scale"], c["off"], c["target"])
    check_curve(torch, dh, f"curve_stats {tuple(q5.shape)}", args,
                dict(levels=5, cut_grid=ALL_BASE_CUTS, valid_hw=(H, W)))
    check_rows_independent(torch, dh, f"curve_stats {tuple(q5.shape)}", args,
                           dict(levels=5, cut_grid=UNORDERED_GRID,
                                valid_hw=(H, W)))

    # Edge shapes: the padded frame itself as the target, unit scale, a
    # valid region short of the padding by 3 rows and 5 columns.
    for shape in EDGE_SHAPES:
        src = tall if shape[2] > 736 or shape[3] > 1440 else frames
        ue = scaled_input(torch, src, shape)
        re_ = (ue % 255.0).contiguous()
        ones = torch.ones(shape[0], device=dev)
        valid = (shape[2] - 3, shape[3] - 5)
        grids = ((5, BASE_GRID, ue, 0.5), (3, RES_GRID, re_, 0.05))
        if shape[2] > 736:
            grids += ((5, ALL_BASE_CUTS, ue, 0.5),)
        for levels, grid, t, target in grids:
            q = dh.dwt2d_quantize_plain(t, levels)
            check_curve(torch, dh, f"curve_stats L{levels} {shape}",
                        (q, t, ones, 0 * ones, target * ones),
                        dict(levels=levels, cut_grid=grid, valid_hw=valid))
    return rows


def check_curve(torch, dh, name, args, kw):
    """K3 against its plain version: max, min and count equal; the float64
    sums within 1e-9 of n * max|err| (n valid samples).  Returns the
    largest sum difference."""
    got = dh.curve_stats(*args, **kw)
    want = dh.curve_stats_plain(*args, **kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(got[..., i], want[..., i]) for i in (1, 2, 3))
    maxabs = float(torch.maximum(want[..., 1].abs(), want[..., 2].abs()).max())
    sum_err = float((got[..., 0] - want[..., 0]).abs().max())
    vh, vw = kw["valid_hw"]
    tol = 1e-9 * vh * vw * maxabs
    print(f"K3 {name} (cuts {kw['cut_grid']}): max/min/count equal={exact}, "
          f"largest sum difference {sum_err:.3e} (tolerance {tol:.3e})")
    if not exact or sum_err > tol:
        raise AssertionError(f"K3 ({name}) disagrees with its plain version")
    return sum_err


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

    reset_all_counts(dh)
    t0 = time.perf_counter()
    streams, dec = et.roundtrip_frames_device(x, config, opts, max_batch=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_counts(dh)

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
    if backend != entropy.BACKEND_ZSTD:
        raise AssertionError("the main path's streams are not zstd's")
    print(f"main path on {card}: {n} frames {H}x{W}, roundtrip {wall:.4f} s, "
          f"{x.numel() / wall:.1f} pts/s, CR {cr:.3f} (entropy backend "
          f"zstd level 3, {entropy.zstd_binding()}), "
          f"max error {maxerr:.6f}, stream bytes {nbytes}")
    print(f"launches on the main path: {launches}")
    missing = [k for k in ("dwt2d_quantize", "dwt2d_transform",
                           "idwt2d_dequant", "rice_unpack_qflat")
               if launches[k] == 0]
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
    return launches, wall, cr, streams


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
        print(f"  launches: {launches}, stream bytes "
              f"{sum(len(s) for s in streams)}")
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
    if differ or same != n:
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


def phase_tall(torch, et, dh, tall, card):
    """Phase 7: 4 frames of a 0.1-degree grid (1801 x 3600, padded to
    1824 x 3616) through ``roundtrip_frames_device`` at MAX_ERROR 0.5 on
    the card: the bound holds and K1 and K2 launched."""
    n = tall.shape[0]
    config = et.CodecConfig(
        dims=(n, TALL_H, TALL_W), base_cr=30,
        residual_mode=et.RESIDUAL_MAX_ERROR, error=0.5,
        chunk_dims=(1, TALL_H, TALL_W), zstd_level=3)
    x = torch.from_numpy(tall).reshape(n, 1, TALL_H, TALL_W).cuda()
    dh.reset_launch_counts()
    t0 = time.perf_counter()
    streams, dec = et.roundtrip_frames_device(x, config, et.EncodeOptions(),
                                              max_batch=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dh.launch_counts()
    if not (dec.shape == x.shape and bool(torch.isfinite(dec).all())):
        raise AssertionError("tall roundtrip: bad decoded batch")
    maxerr = float((x - dec).abs().max())
    print(f"tall frames on {card}: {n} x {TALL_H}x{TALL_W}, roundtrip "
          f"{wall:.4f} s (first call at this shape), max error "
          f"{maxerr:.6f}, stream bytes {sum(len(s) for s in streams)}, "
          f"launches {launches}")
    if maxerr > config.error:
        raise AssertionError(f"tall roundtrip: max error {maxerr} exceeds "
                             f"{config.error}")
    missing = [k for k in ("dwt2d_quantize", "idwt2d_dequant")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched: {missing}")


def backend_name():
    from ebcc_tpu_torch.core import entropy
    return ("zstd" if entropy.default_backend() == entropy.BACKEND_ZSTD
            else "STORE")


def rate_roundtrip(torch, et, dh, x, base_cr, card):
    """One rate-mode roundtrip of ``x`` (B, 1, H, W) on the card, sub-batches
    of 4: every stream within raw bytes / base_cr, the decode again through
    ``decode_frames_device`` bit-equal.  Returns (config, streams,
    launches)."""
    from ebcc_tpu_torch.core import stream
    n = x.shape[0]
    config = et.CodecConfig(dims=(n, H, W), base_cr=base_cr,
                            chunk_dims=(1, H, W), zstd_level=3)
    if config.residual_mode != et.RESIDUAL_NONE:
        raise AssertionError("rate mode is not the config's default")
    opts = et.EncodeOptions()
    et.roundtrip_frames_device(x[:4], config, opts, max_batch=4)
    torch.cuda.synchronize()
    reset_all_counts(dh)
    t0 = time.perf_counter()
    streams, dec = et.roundtrip_frames_device(x, config, opts, max_batch=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_counts(dh)
    if not (dec.shape == x.shape and bool(torch.isfinite(dec).all())):
        raise AssertionError("rate roundtrip: bad decoded batch")
    limit = H * W * 4 / base_cr
    over = [i for i, s in enumerate(streams) if len(s) > limit]
    if over:
        raise AssertionError(f"rate streams {over} exceed {limit} bytes")
    if not torch.equal(dec, et.decode_frames_device(streams, max_batch=4)):
        raise AssertionError("rate: decode_frames_device differs from the "
                             "roundtrip's decode")
    err = x - dec
    cuts = sorted({stream.split_frame_stream(s)[0].base_cut
                   for s in streams})
    partial = sum(bool(stream.split_frame_stream(s)[0].flags
                       & stream.FLAG_BASE_PARTIAL) for s in streams)
    print(f"rate mode base_cr {base_cr} on {card}: {n} frames, roundtrip "
          f"{wall:.4f} s, budget use "
          f"{sum(len(s) for s in streams) / (n * limit):.6f}, max error "
          f"{float(err.abs().max()):.6f}, RMSE "
          f"{float(err.pow(2).mean().sqrt()):.6f}, cuts {cuts}, partial "
          f"plane in {partial} of {n} (entropy backend {backend_name()})")
    return config, streams, launches


def phase_rate(torch, et, dh, frames, card):
    """Phase 8: rate mode (RESIDUAL_NONE, the config's default) on the 32
    frames at base_cr 30 through ``roundtrip_frames_device``: every stream
    within its budget, the decode again bit-equal, the first 4 frames
    byte-identical one at a time, K1 and K2 launched, and a small input
    encoded on the CPU makes the card's cut and flags.  K1 must equal the
    truncation of its float variant (rate mode takes K1).  8 frames at
    base_cr 4 give the cut search a budget that holds every plane with zstd
    (with STORE payloads, before the port bound ``libzstd.so.1``, this was
    the only run that kept more than one plane)."""
    from ebcc_tpu_torch.core import stream
    from ebcc_tpu_torch.ops import bitplane
    u = scaled_input(torch, frames, (4, 1, 736, 1440))
    if not torch.equal(dh.dwt2d_quantize(u, 5), bitplane.quantize_floor(
            dh.dwt2d_transform(u, 5))):
        raise AssertionError("K1 differs from the truncation of its float "
                             "variant")
    print("rate mode: K1 at 5 levels equals trunc(dwt2d_transform) bit for "
          "bit at (4, 1, 736, 1440)")
    n = frames.shape[0]
    x = torch.from_numpy(frames).reshape(n, 1, H, W).cuda()
    config, streams, launches = rate_roundtrip(torch, et, dh, x, 30, card)
    print(f"launches on the rate path: {launches}")
    missing = [k for k in ("dwt2d_quantize", "idwt2d_dequant")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the rate path: "
                             f"{missing}")
    if et.encode_frames_device(x[:4], config, max_batch=1) != streams[:4]:
        raise AssertionError("rate streams depend on the batch partitioning")
    rate_roundtrip(torch, et, dh, x[:8], 4, card)
    rate_streams = streams

    small = frames[:1, :128, :256].copy()
    cfg_s = et.CodecConfig(dims=small.shape, base_cr=8, zstd_level=3)
    heads = [stream.split_frame_stream(et.encode(small, cfg_s, device=d))[0]
             for d in ("cpu", "cuda")]
    got = [(hd.flags, hd.base_cut, hd.base_top, hd.base_comp_size)
           for hd in heads]
    print(f"rate small input (base_cr 8): CPU (flags, cut, top, bytes) "
          f"{got[0]}, card {got[1]}")
    if got[0][:3] != got[1][:3]:
        raise AssertionError("CPU and card rate encodes pick other cuts")
    return config, rate_streams


def subpixel_shift(a, s):
    """``a`` moved by ``s`` samples along its rows' axis, linearly between
    neighbours, wrapping."""
    i = int(np.floor(s))
    f = np.float32(s - i)
    return (1 - f) * np.roll(a, i, axis=1) + f * np.roll(a, i + 1, axis=1)


def drifting_chunks(frames, n_chunks, t):
    """(n_chunks, t, H, W): chunk c is frame c advected 0.7 samples per step
    plus a drift of 0.12 per step."""
    return np.stack([[subpixel_shift(frames[c], 0.7 * k) + 0.12 * k
                      for k in range(t)] for c in range(n_chunks)]).astype(
        np.float32)


def phase_temporal(torch, et, dh, frames, card):
    """Phase 9: temporal mode, 4 chunks of 8 drifting frames at MAX_ERROR
    0.5 through ``roundtrip_frames_device`` (sub-batches of 2 chunks):
    every frame within 0.5, the first sub-batch's decode equal bit for bit
    to the reconstruction its encoder carried, a chunk alone byte-identical
    to the same chunk in the batch, ``decode(..., device="cuda")`` agrees;
    K1, its float variant and K2 launched."""
    import dataclasses
    from ebcc_tpu_torch.core import kernels, stream
    n_chunks, t = 4, 8
    x = torch.from_numpy(drifting_chunks(frames, n_chunks, t)).cuda()
    config = et.CodecConfig(
        dims=(n_chunks * t, H, W), residual_mode=et.RESIDUAL_MAX_ERROR,
        error=0.5, temporal=True, chunk_dims=(t, H, W), zstd_level=3)
    opts = et.EncodeOptions()
    torch.cuda.synchronize()
    reset_all_counts(dh)
    t0 = time.perf_counter()
    streams, dec = et.roundtrip_frames_device(x, config, opts, max_batch=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_counts(dh)
    if not (dec.shape == x.shape and bool(torch.isfinite(dec).all())):
        raise AssertionError("temporal roundtrip: bad decoded batch")
    per_frame = (x - dec).abs().amax(dim=(2, 3))
    if not bool((per_frame <= config.error).all()):
        raise AssertionError(f"temporal frames over the bound: {per_frame}")
    carry = kernels.encode_batch_temporal(
        x[:2], config.error, opts.base_quantile_target,
        return_carry=True)["_carry"]
    if not torch.equal(carry, dec[:2]):
        raise AssertionError("temporal decode differs from the encoder's "
                             "carried reconstruction")
    if et.encode_frames_device(x[1:2], config, opts) != streams[1:2]:
        raise AssertionError("a temporal chunk alone differs from the same "
                             "chunk in the batch")
    if not np.array_equal(et.decode(streams[0], device="cuda"),
                          dec[0].cpu().numpy()):
        raise AssertionError("temporal decode() differs from "
                             "decode_frames_device")
    intra = et.encode_frames_device(
        x, dataclasses.replace(config, temporal=False), opts, max_batch=2)
    skipped = 0
    for s in streams:
        records, _ = stream.split_temporal_section(
            s, stream.split_frame_stream(s)[0])
        skipped += sum(r.comp_size == 0 for r in records)
    print(f"temporal MAX_ERROR 0.5 on {card}: {n_chunks} chunks x {t} "
          f"frames {H}x{W}, roundtrip {wall:.4f} s (first call at this "
          f"shape), largest frame error {float(per_frame.max()):.6f}, "
          f"stream bytes {sum(len(s) for s in streams)} against "
          f"{sum(len(s) for s in intra)} intra, {skipped} of "
          f"{n_chunks * (t - 1)} delta frames skipped (entropy backend "
          f"{backend_name()}); decode equals the carry bit for bit")
    print(f"launches on the temporal path: {launches}")
    missing = [k for k in ("dwt2d_quantize", "dwt2d_transform",
                           "idwt2d_dequant") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the temporal path: "
                             f"{missing}")
    return x.cpu().numpy(), streams, config


def phase_lossless(torch, et, dh, frames, card):
    """Phase 10: lossless mode on 8 frames (2 chunks of 4) with NaN, +-Inf
    and -0.0 planted, from a tensor on the card through
    ``encode_frames_device`` and ``decode_frames_device``: bit-exact, and
    no kernel launched (host-only work)."""
    data = frames[:8].reshape(2, 4, H, W).copy()
    data[0, 0, 10, 20] = np.nan
    data[0, 3, H - 21, W - 40] = np.nan
    data[1, 1, 50, 90] = np.inf
    data[1, 2, 5, 7] = -np.inf
    data[1, 3, H // 2, W // 2] = -0.0
    x = torch.from_numpy(data).cuda()
    config = et.CodecConfig(dims=(8, H, W), residual_mode=et.RESIDUAL_LOSSLESS,
                            chunk_dims=(4, H, W), zstd_level=3)
    torch.cuda.synchronize()
    dh.reset_launch_counts()
    t0 = time.perf_counter()
    streams = et.encode_frames_device(x, config)
    dec = et.decode_frames_device(streams)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dh.launch_counts()
    if dec.device.type != "cuda":
        raise AssertionError("lossless decode left the card")
    if not torch.equal(dec.view(torch.int32), x.view(torch.int32)):
        raise AssertionError("lossless roundtrip is not bit-exact")
    if any(launches.values()):
        raise AssertionError(f"lossless launched kernels: {launches}")
    cr = x.numel() * 4 / sum(len(s) for s in streams)
    print(f"lossless on {card}: host-only work (no kernel), 8 frames as 2 "
          f"chunks of 4 with NaN/+-Inf/-0.0, encode+decode {wall:.4f} s, "
          f"bit-exact, CR {cr:.4f} (entropy backend {backend_name()})")


def timed(fn, *args, **kw):
    """-> (fn's result, wall seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def era5_config(et, n):
    return et.CodecConfig(
        dims=(n, H, W), base_cr=30, residual_mode=et.RESIDUAL_MAX_ERROR,
        error=0.5, chunk_dims=(1, H, W), zstd_level=3)


def phase_container_era5(et, dh, frames, main_streams, card):
    """Phase 11a: the 32 frames as an ETPK container of one-frame chunks,
    ``max_batch=4``: every record byte-identical to phase 3's stream of the
    same frame, the decode within 0.5; wall times beside
    ``encode_frames_device`` on the same frames, and the host gather and
    scatter."""
    from ebcc_tpu_torch.core import codec, stream
    n = frames.shape[0]
    config = era5_config(et, n)
    opts = et.EncodeOptions()
    _, t_frames = timed(et.encode_frames_device, frames.reshape(n, 1, H, W),
                        config, opts, max_batch=4)
    dh.reset_launch_counts()
    blob, t_enc = timed(et.encode_chunked, frames, config, opts, max_batch=4)
    enc_launches = dh.launch_counts()
    if stream.iter_chunked(blob)[1] != main_streams:
        raise AssertionError("container records differ from the streams of "
                             "encode_frames_device")
    dh.reset_launch_counts()
    out, t_dec = timed(et.decode_chunked, blob, max_batch=4)
    dec_launches = dh.launch_counts()
    maxerr = float(np.abs(out - frames).max())
    if out.shape != frames.shape or maxerr > config.error:
        raise AssertionError(f"container decode: shape {out.shape}, max "
                             f"error {maxerr}")
    grid = (n, 1, 1)
    chunks, t_gather = timed(codec._gather_chunks, frames, (1, H, W), grid)
    _, t_scatter = timed(codec._scatter_chunks, chunks, frames.shape,
                         (1, H, W), grid)
    print(f"container (a) on {card}: {n} chunks of (1, {H}, {W}), "
          f"{len(blob)} bytes, records byte-identical to "
          f"encode_frames_device's; encode_chunked {t_enc:.4f} s against "
          f"encode_frames_device {t_frames:.4f} s, gather {t_gather:.4f} s, "
          f"decode_chunked {t_dec:.4f} s, scatter {t_scatter:.4f} s, max "
          f"error {maxerr:.6f}")
    print(f"launches on the container path: encode {enc_launches}, decode "
          f"{dec_launches}")
    for name, got in (("encode", enc_launches["dwt2d_quantize"]),
                      ("decode", dec_launches["idwt2d_dequant"])):
        if got == 0:
            raise AssertionError(f"container {name} launched no kernel")
    return blob


def phase_container_compat(et, dh, tall, card):
    """Phase 11b: 4 frames of the 0.1-degree grid through
    ``encode_chunked_compat`` in (1, 1024, 1024) tiles: 32 chunks, edge
    chunks padded; the full decode within 0.5; a region decode that
    crosses the column boundary at 1024 reaches the device decode with 8
    streams and equals the crop of the full decode bit for bit."""
    from ebcc_tpu_torch.core import codec
    dims = tall.shape
    chunk_dims = (1, COMPAT_TILE, COMPAT_TILE)
    config = et.CodecConfig(
        dims=dims, base_cr=30, residual_mode=et.RESIDUAL_MAX_ERROR,
        error=0.5, chunk_dims=chunk_dims, zstd_level=3)
    region = COMPAT_REGION
    want_full = int(np.prod(codec._chunk_grid(dims, chunk_dims)))
    want_region = int(np.prod([-(-hi // c) - lo // c for (lo, hi), c
                               in zip(region, chunk_dims)]))
    blob, t_enc = timed(et.encode_chunked_compat, tall, config)
    inner = codec._decode_streams_device
    seen = []

    def counting(streams, device):
        seen.append(len(streams))
        return inner(streams, device)

    codec._decode_streams_device = counting
    try:
        dh.reset_launch_counts()
        full, t_full = timed(et.decode_chunked, blob)
        full_k2, full_streams = dh.launch_counts()["idwt2d_dequant"], sum(seen)
        seen.clear()
        dh.reset_launch_counts()
        got, t_region = timed(et.decode_chunked_region, blob, region)
        reg_k2, reg_streams = dh.launch_counts()["idwt2d_dequant"], sum(seen)
    finally:
        codec._decode_streams_device = inner
    maxerr = float(np.abs(full - tall).max())
    crop = full[tuple(slice(*r) for r in region)]
    print(f"container (b) on {card}: {dims} in {chunk_dims} tiles, "
          f"{len(blob)} bytes, encode_chunked_compat "
          f"{t_enc:.4f} s; full decode {t_full:.4f} s ({full_streams} streams "
          f"to the device decode, {full_k2} K2 launches), max error "
          f"{maxerr:.6f}; region {region} {t_region:.4f} s ({reg_streams} "
          f"streams, {reg_k2} K2 launches), equal to the crop: "
          f"{np.array_equal(got, crop)}")
    if maxerr > config.error:
        raise AssertionError(f"compat container: max error {maxerr}")
    if (full_streams, reg_streams) != (want_full, want_region):
        raise AssertionError(f"streams decoded: full {full_streams}, region "
                             f"{reg_streams} (want {want_full} and "
                             f"{want_region})")
    if not np.array_equal(got.view(np.int32), crop.view(np.int32)):
        raise AssertionError("region decode differs from the crop of the "
                             "full decode")
    if reg_k2 == 0:
        raise AssertionError("region decode launched no K2")


def phase_container_stream(et, frames, blob, card):
    """Phase 11c: ``compress_stream`` from an ``np.memmap`` of the 32 frames
    writes phase 11a's container byte for byte; ``append_chunked_file``
    adds 8 frames; a region across the append holds 0.5 against the
    source; ``repair_chunked_file`` finds nothing to remove."""
    import tempfile
    from ebcc_tpu_torch import io as tio
    n = frames.shape[0]
    config = era5_config(et, n)
    extra = (frames[:8] + 0.5).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "frames.npy")
        mm = np.lib.format.open_memmap(src, mode="w+", dtype=np.float32,
                                       shape=frames.shape)
        mm[:] = frames
        mm.flush()
        del mm
        path = os.path.join(tmp, "archive.etpk")
        with open(path, "wb") as f:
            written, t_stream = timed(
                tio.compress_stream, np.load(src, mmap_mode="r"), config, f,
                max_batch=4)
        with open(path, "rb") as f:
            if f.read() != blob:
                raise AssertionError("compress_stream differs from "
                                     "encode_chunked")
        appended, t_append = timed(tio.append_chunked_file, path, extra,
                                   config)
        with open(path, "rb") as f:
            grown = f.read()
        region = ((n - 4, n + 4), (H // 7, H // 2), (W // 3, W * 5 // 8))
        got, t_region = timed(et.decode_chunked_region, grown, region)
        removed = tio.repair_chunked_file(path)
    source = np.concatenate([frames, extra])[tuple(slice(*r)
                                                   for r in region)]
    maxerr = float(np.abs(got - source).max())
    print(f"container (c) on {card}: compress_stream from a memmap "
          f"{t_stream:.4f} s for {written} bytes "
          f"({frames.size / t_stream:.1f} values/s), byte-identical to "
          f"encode_chunked; append of 8 frames {t_append:.4f} s "
          f"({appended} bytes); region {region} across the append "
          f"{t_region:.4f} s, max error {maxerr:.6f}; repair removed "
          f"{removed} bytes")
    if maxerr > config.error or removed != 0:
        raise AssertionError(f"streaming: max error {maxerr}, repair "
                             f"removed {removed}")


def phase_container_temporal(et, dh, drifting, temporal_streams, card):
    """Phase 11d: phase 9's 4 x 8 drifting frames as (32, H, W) with
    ``temporal=True`` through ``encode_chunked_compat``: 4 chunks of
    (8, H, W) (the 8-frame lead), every record byte-identical to phase 9's
    stream of the same chunk, every frame within 0.5."""
    from ebcc_tpu_torch.core import stream
    x = drifting.reshape(-1, H, W)
    config = et.CodecConfig(
        dims=x.shape, residual_mode=et.RESIDUAL_MAX_ERROR, error=0.5,
        temporal=True, zstd_level=3)
    dh.reset_launch_counts()
    blob, t_enc = timed(et.encode_chunked_compat, x, config)
    header, records = stream.iter_chunked(blob)
    out, t_dec = timed(et.decode_chunked, blob)
    launches = dh.launch_counts()
    per_frame = np.abs(out - x).max(axis=(1, 2))
    print(f"container (d) on {card}: temporal compat, chunk dims "
          f"{header.chunk_dims}, {len(records)} records, encode "
          f"{t_enc:.4f} s, decode {t_dec:.4f} s, largest frame error "
          f"{float(per_frame.max()):.6f}, launches {launches}")
    if header.chunk_dims != (8, H, W) or records != temporal_streams:
        raise AssertionError("temporal compat records differ from phase 9's "
                             "streams")
    if not bool((per_frame <= config.error).all()):
        raise AssertionError(f"temporal container over the bound: "
                             f"{per_frame}")


def stage_s(snap, name):
    """Total seconds of a timing stage in a snapshot (0.0 if absent)."""
    return snap.get(name, {}).get("total_s", 0.0)


def timed_stages(fn, *args, **kw):
    """-> (fn's result, wall seconds, timing snapshot of the run): stage
    timing (``utils.timing``) on for the call only."""
    from ebcc_tpu_torch.utils import timing
    was = timing.ENABLED
    timing.reset_stats()
    timing.ENABLED = True
    try:
        out, wall = timed(fn, *args, **kw)
    finally:
        timing.ENABLED = was
    return out, wall, timing.snapshot()


@contextlib.contextmanager
def env_set(**kw):
    """Environment variables set for a ``with`` block, then restored."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def error_line(e):
    """The line of an exception's message that names the compiler error
    (its first line when none does)."""
    lines = str(e).splitlines()
    return next((ln.strip() for ln in lines if "error" in ln), lines[0])


def compiler_line(cxx):
    """A compiler's path and the first line of its ``--version``."""
    out = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return f"{cxx} ({out[0] if out else 'no version'})"


def phase_native_build(build_seconds, codec_error):
    """Phase 12a: the host libraries' build (phase 1 built them, the CAB
    coder with PGO where the compiler can) and zstd for the host codec,
    which takes its
    declarations from ``csrc/host/zstd_decls.h`` and links
    ``libzstd.so.1``, so it builds without ``zstd.h``."""
    import ctypes.util
    from ebcc_tpu_torch.ops import _build
    secs = {k: round(v, 2) for k, v in build_seconds.items()
            if k.startswith(("cab_pgo", "ebcc_host", "ebcc_native_codec"))}
    print(f"host compiler {compiler_line(_build.cxx_path())}; "
          f"libebcc_host.so: "
          f"{_build.BUILD_KIND['ebcc_host']}; build seconds {secs} "
          f"(-O3 -ffp-contract=off)")
    print(f"zstd.h: {'present' if os.path.exists('/usr/include/zstd.h') else 'absent'} "
          f"at /usr/include; libzstd: {ctypes.util.find_library('zstd')}")
    if codec_error is not None:
        raise AssertionError(f"libebcc_native_codec.so did not build: "
                             f"{error_line(codec_error)}")
    print(f"libebcc_native_codec.so built from csrc/host/zstd_decls.h: "
          f"{_build.BUILD_KIND['ebcc_native_codec']}")


def phase_cab_main_path(torch, et, dh, frames, card):
    """Phase 12b: the 32 frames through ``roundtrip_frames_device`` at
    MAX_ERROR 0.5, sub-batches of 4, with ``entropy_backend`` cab, cab2 and
    auto: every frame within 0.5 on the card, K1 and K2 launched, the
    decode again bit-equal; stream bytes, CR, wall time and the host
    stages.  ``auto`` codes each layer with CAB and with zstd and keeps the
    smaller; the ids kept are counted.  Returns backend -> streams."""
    import collections
    import dataclasses
    from ebcc_tpu_torch.core import stream
    n = frames.shape[0]
    x = torch.from_numpy(frames).reshape(n, 1, H, W).cuda()
    opts = et.EncodeOptions()
    out = {}
    for backend in ("cab", "cab2", "auto"):
        config = dataclasses.replace(era5_config(et, n),
                                     entropy_backend=backend)
        torch.cuda.synchronize()
        dh.reset_launch_counts()
        (streams, dec), wall, snap = timed_stages(
            et.roundtrip_frames_device, x, config, opts, max_batch=4)
        torch.cuda.synchronize()
        launches = dh.launch_counts()
        maxerr = float((x - dec).abs().max())
        nbytes = sum(len(s) for s in streams)
        print(f"CAB main path ({backend}) on {card}: {n} frames, roundtrip "
              f"{wall:.4f} s, stream bytes {nbytes}, CR "
              f"{x.numel() * 4 / nbytes:.4f}, max error {maxerr:.6f}, "
              f"assemble+zstd {stage_s(snap, 'assemble+zstd'):.4f} s, "
              f"dec: entropy decode {stage_s(snap, 'dec: entropy decode'):.4f}"
              f" s, dec: unpack planes "
              f"{stage_s(snap, 'dec: unpack planes'):.4f} s (thread time), "
              f"launches {launches}")
        if not (dec.shape == x.shape and bool(torch.isfinite(dec).all())):
            raise AssertionError(f"{backend}: bad decoded batch")
        if maxerr > config.error:
            raise AssertionError(f"{backend}: max error {maxerr}")
        missing = [k for k in ("dwt2d_quantize", "idwt2d_dequant")
                   if launches[k] == 0]
        if missing:
            raise AssertionError(f"{backend}: kernels not launched: "
                                 f"{missing}")
        if not torch.equal(dec, et.decode_frames_device(streams,
                                                        max_batch=4)):
            raise AssertionError(f"{backend}: decode_frames_device differs "
                                 "from the roundtrip's decode")
        kept = collections.Counter(
            stream.split_frame_stream(s)[0].entropy for s in streams)
        print(f"  {backend}: header entropy ids {dict(sorted(kept.items()))}"
              f" (1 zstd, 2 cab, 4 cab2)")
        out[backend] = streams
    return out


def phase_pack_unpack_twins(torch, et, frames, main_streams,
                            temporal_streams, card):
    """Phase 12c: the native packer and unpacker against their numpy
    twins, in this call: phase 3's encode byte-identical with
    ``EBCC_NO_NATIVE_PACK=1``; phase 3's and phase 9's streams decode
    bit-equal with ``EBCC_NO_NATIVE_UNPACK=1``; host stage times and
    decode walls (native, twin, native)."""
    n = frames.shape[0]
    x = torch.from_numpy(frames).reshape(n, 1, H, W).cuda()
    config = era5_config(et, n)
    opts = et.EncodeOptions()
    runs = {}
    for name, env in (("native", {}), ("numpy twin",
                                       {"EBCC_NO_NATIVE_PACK": "1"})):
        with env_set(**env):
            streams, wall, snap = timed_stages(
                et.encode_frames_device, x, config, opts, max_batch=4)
        runs[name] = streams
        print(f"pack ({name}) on {card}: encode_frames_device {wall:.4f} "
              f"s, assemble+zstd {stage_s(snap, 'assemble+zstd'):.4f} s "
              f"(thread time)")
    if runs["native"] != main_streams or runs["numpy twin"] != main_streams:
        raise AssertionError("native and numpy packers give other streams")
    print("pack: native and numpy twin streams byte-identical to phase 3's")

    for label, streams, mb in (("MAX_ERROR", main_streams, 4),
                               ("temporal", temporal_streams, 2)):
        ref = None
        for name in ("native", "numpy twin", "native"):
            env = {"EBCC_NO_NATIVE_UNPACK": "1"} if name != "native" else {}
            per_batch = []
            with env_set(**env):
                dec, wall, snap = timed_stages(et.decode_frames_device,
                                               streams, max_batch=mb)
                torch.cuda.synchronize()
                for i in range(0, len(streams), mb):
                    _, t = timed(et.decode_frames_device, streams[i:i + mb])
                    torch.cuda.synchronize()
                    per_batch.append(t)
            if ref is None:
                ref = dec
            elif not torch.equal(dec, ref):
                raise AssertionError(f"{label}: {name} unpack decodes "
                                     "other values")
            print(f"unpack {label} ({name}) on {card}: decode_frames_device "
                  f"{wall:.4f} s for {len(streams)} streams, dec: unpack "
                  f"planes {stage_s(snap, 'dec: unpack planes'):.4f} s, dec: "
                  f"entropy decode {stage_s(snap, 'dec: entropy decode'):.4f}"
                  f" s (thread time); per sub-batch of {mb} alone "
                  f"{[round(t, 4) for t in per_batch]} s")
    print("unpack: native and numpy twin decodes bit-equal")


def phase_rate_assembly(torch, et, dh, frames, card):
    """Phase 12d: phase 8's rate roundtrip (base_cr 30), with the host
    assembly time per sub-batch of 4 (the partial-plane bisection)."""
    n = frames.shape[0]
    x = torch.from_numpy(frames).reshape(n, 1, H, W).cuda()
    (_, _, launches), wall, snap = timed_stages(rate_roundtrip, torch, et,
                                                dh, x, 30, card)
    asm = snap.get("assemble+zstd", {"count": 0, "total_s": 0.0})
    print(f"rate assembly on {card}: roundtrip {wall:.4f} s with its "
          f"warm-up, {asm['count']} sub-batches of 4 (the warm-up's "
          f"included), assemble+zstd {asm['total_s']:.4f} s in all, "
          f"{asm['total_s'] / max(asm['count'], 1):.4f} s per sub-batch; "
          f"launches {launches}")
    missing = [k for k in ("dwt2d_quantize", "idwt2d_dequant")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the rate path: "
                             f"{missing}")


def phase_native_routing(et, frames, cab_streams, blob, codec_error, card):
    """Phase 12e: native routing: 4 frames encoded through the host codec
    (zstd payloads, the format's default) and decoded on the card, the
    card's CAB streams of 12b decoded through it, and one container
    through both routes, all within 0.5.  (Before the port bound
    ``libzstd.so.1`` the host codec did not build on the card's machine,
    and this phase checked that a routed call raised.)"""
    from concurrent.futures import ThreadPoolExecutor
    config = era5_config(et, 4)
    four = frames[:4]
    if codec_error is not None:
        raise AssertionError("native routing: the host codec did not build")
    with env_set(EBCC_ENCODE_BACKEND="native"):
        routed, t_enc = timed(et.encode_chunked, four, config)
    dev, t_dev_dec = timed(et.decode_chunked, routed)
    err = float(np.abs(dev - four).max())
    print(f"native routing on {card}: 4 frames encoded through the host "
          f"codec in {t_enc:.4f} s ({len(routed)} bytes), decoded on the "
          f"card in {t_dev_dec:.4f} s, max error {err:.6f}")
    if err > 0.5:
        raise AssertionError(f"native encode, card decode: error {err}")
    n = frames.shape[0]
    with env_set(EBCC_DECODE_BACKEND="native"):
        for backend, streams in cab_streams.items():
            with ThreadPoolExecutor(max_workers=8) as pool:
                outs, t = timed(lambda: list(pool.map(et.decode, streams)))
            err = float(np.abs(np.concatenate(outs) - frames).max())
            print(f"native decode of the card's {backend} streams: {t:.4f} "
                  f"s for {n} streams, max error {err:.6f}")
            if err > 0.5:
                raise AssertionError(f"native decode of {backend}: {err}")
        back, t_nat = timed(et.decode_chunked, routed)
        card_blob, t_nat2 = timed(et.decode_chunked, blob)
    err_n = float(np.abs(back - four).max())
    err_c = float(np.abs(card_blob - frames).max())
    print(f"container through both routes: host-encoded container decoded "
          f"by the host codec in {t_nat:.4f} s (max error {err_n:.6f}); "
          f"phase 11a's card container decoded by it in {t_nat2:.4f} s "
          f"(max error {err_c:.6f})")
    if max(err_n, err_c) > 0.5:
        raise AssertionError("native container decode over the bound")


# ---- phase 13: scale-out and the user surfaces ----

# The JAX package's ``spec`` string for these arguments (the CPU tests hold
# the two CLIs equal on every case).
CLI_SPEC_ARGS = ["spec", "-b", "200", "-H", "721", "-W", "1440", "-r",
                 "0.01"]
CLI_SPEC_WANT = "33030,721,1440,1128792064,2,1008981770"
CLI_REGION = ((1, 3), (200, 550), (900, 1300))
CHILD_TIMEOUT_S = 300


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_children(argvs, timeout=CHILD_TIMEOUT_S):
    """Start every command at once, wait for all (each within ``timeout``
    seconds) -> their standard outputs; any non-zero exit or timeout kills
    the rest and raises with the output."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    procs = [subprocess.Popen(a, cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for a, p, out in zip(argvs, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{' '.join(a[1:4])} exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
    return outs


def phase_sharded(torch, et, dh, frames, blob, card):
    """Phase 13a: the 32 frames through ``encode_chunked_sharded`` over
    ``make_mesh()`` (every visible card), one-frame chunks, ``max_batch=4``:
    the container byte-identical to phase 11a's, ``decode_chunked_sharded``
    bit-equal to ``decode_chunked``, K1 and K2 launched, ``global_range``
    equal to numpy's, wall times beside ``encode_chunked``'s, and
    ``dryrun_multidevice(1)``."""
    from ebcc_tpu_torch.parallel import (decode_chunked_sharded,
                                         dryrun_multidevice,
                                         encode_chunked_sharded,
                                         global_range, make_mesh)
    n = frames.shape[0]
    config = era5_config(et, n)
    opts = et.EncodeOptions()
    mesh = make_mesh()
    _, t_plain = timed(et.encode_chunked, frames, config, opts, max_batch=4)
    dh.reset_launch_counts()
    got, t_sh = timed(encode_chunked_sharded, frames, config, opts, mesh,
                      max_batch=4)
    enc_launches = dh.launch_counts()
    if got != blob:
        raise AssertionError("sharded container differs from phase 11a's")
    dh.reset_launch_counts()
    dec, t_dec = timed(decode_chunked_sharded, blob, mesh, max_batch=4)
    dec_launches = dh.launch_counts()
    want, t_dec_plain = timed(et.decode_chunked, blob, max_batch=4)
    if not np.array_equal(dec, want):
        raise AssertionError("sharded decode differs from decode_chunked")
    rng = global_range(frames, mesh)
    if rng != (float(frames.min()), float(frames.max())):
        raise AssertionError(f"global_range {rng} against numpy's "
                             f"{frames.min()}, {frames.max()}")
    dry = dryrun_multidevice(1)
    print(f"sharded (a) on {card}: torch.cuda.device_count() "
          f"{torch.cuda.device_count()}, mesh {mesh.shape} of {mesh.flat}; "
          f"encode_chunked_sharded {t_sh:.4f} s against encode_chunked "
          f"{t_plain:.4f} s, container byte-identical to phase 11a's; "
          f"decode_chunked_sharded {t_dec:.4f} s against decode_chunked "
          f"{t_dec_plain:.4f} s, bit-equal; global_range {rng}; "
          f"dryrun_multidevice(1) {dry}")
    print(f"launches on the sharded path: encode {enc_launches}, decode "
          f"{dec_launches}")
    for name, got_n in (("encode K1", enc_launches["dwt2d_quantize"]),
                        ("encode K2", enc_launches["idwt2d_dequant"]),
                        ("decode K2", dec_launches["idwt2d_dequant"])):
        if got_n == 0:
            raise AssertionError(f"sharded {name} not launched")


def phase_two_ranks(et, frames, blob, tmp, card):
    """Phase 13b: two processes in a gloo group (``multihost.initialize``;
    NCCL refuses two ranks on one card), each coding its own 16 chunks of
    the 32 frames on ``cuda:0``: the merged container byte-identical to
    phase 11a's, the cross-rank ``global_range`` right, each rank's K1/K2
    launches and wall; the 2-rank wall beside one process's encode of all
    32."""
    from ebcc_tpu_torch.parallel import multihost
    n = frames.shape[0]
    config = era5_config(et, n)
    (streams, _), t_one = timed(multihost.encode_owned_chunks, frames, config,
                           et.EncodeOptions(), process_id=0,
                           process_count=1, max_batch=4)
    if multihost.merge_container_parts(
            config, [multihost.container_part(streams)]) != blob:
        raise AssertionError("one-process owned encode differs from phase "
                             "11a's container")
    np.save(os.path.join(tmp, "frames.npy"), frames)
    port = free_port()
    run_children([[sys.executable, os.path.abspath(__file__), "--worker",
                   "encode", "--rank", str(r), "--world", "2", "--port",
                   str(port), "--dir", tmp] for r in range(2)])
    metas = []
    for r in range(2):
        with open(os.path.join(tmp, f"meta{r}.json")) as f:
            metas.append(json.load(f))
    parts = []
    for r in range(2):
        with open(os.path.join(tmp, f"part{r}.bin"), "rb") as f:
            parts.append(f.read())
    if multihost.merge_container_parts(config, parts) != blob:
        raise AssertionError("2-rank merged container differs from phase "
                             "11a's")
    want = [float(frames.min()), float(frames.max())]
    wall = max(m["t1"] for m in metas) - min(m["t0"] for m in metas)
    for m in metas:
        print(f"rank {m['rank']} of 2 on {card}: chunks [{m['start']}, "
              f"{m['stop']}) on {m['device']}, encode {m['wall']:.4f} s, "
              f"launches {m['launches']}, global_range {m['range']}")
        if m["range"] != want:
            raise AssertionError(f"rank {m['rank']} global_range "
                                 f"{m['range']} against {want}")
        if min(m["launches"]["dwt2d_quantize"],
               m["launches"]["idwt2d_dequant"]) == 0:
            raise AssertionError(f"rank {m['rank']} launched no K1 or K2")
    print(f"two ranks (b) on {card}: merged container byte-identical to "
          f"phase 11a's; 2-rank wall {wall:.4f} s against one process's "
          f"encode of all {n} {t_one:.4f} s")


def phase_nccl(tmp, card):
    """Phase 13c: one NCCL rank (NCCL refuses two on one card) in its own
    process: ``all_reduce`` MIN and MAX of a CUDA tensor, and
    ``global_range`` of the 32 frames through the group."""
    run_children([[sys.executable, os.path.abspath(__file__), "--worker",
                   "nccl", "--rank", "0", "--world", "1", "--port",
                   str(free_port()), "--dir", tmp]])
    with open(os.path.join(tmp, "nccl.json")) as f:
        meta = json.load(f)
    print(f"nccl (c) on {card}: backend {meta['backend']}, all_reduce "
          f"MIN/MAX of a CUDA tensor {meta['reduced']}, global_range "
          f"{meta['range']}")


def phase_cli(frames, tmp, card):
    """Phase 13d: ``python -m ebcc_tpu_torch.api.cli`` on the card, each
    command a process: ``spec`` prints the JAX package's string;
    ``compress`` of 4 frames from a ``.npy`` at --max-error 0.5;
    ``decompress`` within 0.5; ``decompress --region`` equal to the crop."""
    cli = [sys.executable, "-m", "ebcc_tpu_torch.api.cli"]
    spec = run_children([cli + CLI_SPEC_ARGS])[0].strip().splitlines()[-1]
    if spec != CLI_SPEC_WANT:
        raise AssertionError(f"cli spec {spec!r}, want {CLI_SPEC_WANT!r}")
    four = frames[:4]
    src, blob, full, part = (os.path.join(tmp, f) for f in (
        "cli_in.npy", "cli.etpk", "cli_full.npy", "cli_region.npy"))
    np.save(src, four)
    t0 = time.perf_counter()
    run_children([cli + ["compress", src, blob, "--max-error", "0.5"]])
    t1 = time.perf_counter()
    region = ",".join(f"{a}:{b}" for a, b in CLI_REGION)
    run_children([cli + ["decompress", blob, full],
                  cli + ["decompress", blob, part, "--region", region]])
    t2 = time.perf_counter()
    out = np.load(full)
    err = float(np.abs(out - four).max())
    if out.shape != four.shape or err > 0.5:
        raise AssertionError(f"cli decompress: shape {out.shape}, max error "
                             f"{err}")
    crop = out[tuple(slice(a, b) for a, b in CLI_REGION)]
    if not np.array_equal(np.load(part), crop):
        raise AssertionError("cli --region differs from the crop")
    print(f"cli (d) on {card}: spec {spec}; compress of 4 frames "
          f"{os.path.getsize(blob)} bytes in {t1 - t0:.2f} s (a process), "
          f"decompress max error {err:.6f} and --region {region} equal to "
          f"the crop, both processes in {t2 - t1:.2f} s")


def phase_trace(torch, et, frames, tmp, card):
    """Phase 13e: ``profiling.trace`` around one roundtrip of 4 frames on
    the card writes a Chrome trace whose events name K2's CUDA kernel and
    the trace's own annotation."""
    import glob
    from ebcc_tpu_torch.utils import profiling
    name = "ebcc_smoke_trace"
    x = torch.from_numpy(frames[:4].reshape(4, 1, H, W)).cuda()
    config = et.CodecConfig(dims=(1, H, W), base_cr=30,
                            residual_mode=et.RESIDUAL_MAX_ERROR, error=0.5)
    with profiling.trace(name, profile_dir=tmp):
        et.roundtrip_frames_device(x, config)
        torch.cuda.synchronize()
    files = glob.glob(os.path.join(tmp, f"{name}.*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace files: {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # CUDA kernel names are demangled signatures, in an anonymous namespace.
    k2 = sorted({m.group() for n in names
                 for m in [re.search(r"\binv_(tile|coarse)\b", n)] if m})
    if name not in names or not k2:
        raise AssertionError(f"trace lacks the annotation or K2: "
                             f"{name in names}, {k2}")
    print(f"trace (e) on {card}: {os.path.getsize(files[0])} bytes, "
          f"{len(events)} events, annotation {name!r} and K2's kernels "
          f"{k2}")


# ---- phase 14: the exchange forms, X1, the u16 upload, routing ----

UPLOAD_FORMS = {"rice": ["rice"], "nibble": ["nibble", "bytes"],
                "bytes": ["bytes"], "bitmap": ["bitmap"], "index": ["index"]}


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` replaced for a ``with`` block, then restored."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def stage_line(snap, prefix):
    return ", ".join(f"{k} {v['total_s']:.4f} s" for k, v in snap.items()
                     if k.startswith(prefix))


def phase_encode_forms(torch, et, runs, card):
    """Phase 14a: each run's encode in the default form (compact Rice, the
    hints cleared first), again (every sub-batch hinted: one copy of the
    small outputs and the pair buffer) and with ``EBCC_NO_RICE=1`` (the
    ``torch.nonzero`` fetch): streams byte-identical to the earlier
    phase's, down bytes per significant coefficient and per point, the
    ``enc:`` stage times (thread time) and the wall."""
    from ebcc_tpu_torch.core import codec, transfer
    real_fetch = codec._fetch_encode_outputs
    counted = []

    def counting_fetch(*a, **kw):
        out = real_fetch(*a, **kw)
        counted.append(int(out["sparse"].idx.size))
        return out

    for label, (x, config, mb, want) in runs.items():
        pts = x.numel()
        codec._EXCH_HINTS.clear()
        for form, env in (("compact Rice", {}), ("hinted fused", {}),
                          ("torch.nonzero", {"EBCC_NO_RICE": "1"})):
            counted.clear()
            transfer.reset_link_stats()
            with env_set(**env), patched(codec, "_fetch_encode_outputs",
                                         counting_fetch):
                streams, wall, snap = timed_stages(
                    et.encode_frames_device, x, config, max_batch=mb)
            down = transfer.LINK_STATS["down"]
            nnz = sum(counted)
            print(f"encode {label} ({form}) on {card}: wall {wall:.4f} s, "
                  f"down {down} B = {down / max(nnz, 1):.4f} B per "
                  f"significant coefficient ({nnz}), {down / pts:.6f} B per "
                  f"point; {stage_line(snap, 'enc:')}")
            if streams != want:
                raise AssertionError(f"{label}: the {form} encode differs "
                                     "from the earlier phase's streams")
        print(f"encode {label}: the three forms' streams byte-identical to "
              "the earlier phase's")


def phase_decode_forms(torch, et, dh, xh, runs, card):
    """Phase 14b: each run's streams decoded through every upload form
    (the chain pinned to it; the nibble tiers pass a batch they cannot
    hold to the byte form, as the default chain does): bit-equal to the
    index form, up bytes per significant coefficient, the ``dec:`` stage
    times, the wall, and the launches of X1 and K2.  Returns {run label:
    the arguments of X1's first call on that run's streams} (the blocks of
    14c)."""
    from ebcc_tpu_torch.core import codec, transfer
    captured = {}
    real_x1 = xh.rice_unpack_qflat
    label = None

    def capturing_x1(*a, **kw):
        captured.setdefault(label, (a, kw))
        return real_x1(*a, **kw)

    for label, (x, config, mb, streams) in runs.items():
        outs = {}
        for form, chain in UPLOAD_FORMS.items():
            seen = []

            def pinned(nnz, s, chain=chain):
                seen.append(nnz)
                return list(chain)

            dh.reset_launch_counts()
            xh.reset_launch_counts()
            transfer.reset_link_stats()
            with patched(codec, "_upload_chain", pinned), \
                    patched(xh, "rice_unpack_qflat", capturing_x1):
                dec, wall, snap = timed_stages(
                    et.decode_frames_device, streams, max_batch=mb)
                torch.cuda.synchronize()
            up = transfer.LINK_STATS["up"]
            nnz = sum(seen)
            outs[form] = dec
            print(f"decode {label} ({form}) on {card}: wall {wall:.4f} s, "
                  f"up {up} B = {up / max(nnz, 1):.4f} B per significant "
                  f"coefficient ({nnz}); {stage_line(snap, 'dec:')}; "
                  f"launches X1 "
                  f"{xh.launch_counts()['rice_unpack_qflat']}, K2 "
                  f"{dh.launch_counts()['idwt2d_dequant']}")
            if form == "rice" and xh.launch_counts()["rice_unpack_qflat"] == 0:
                raise AssertionError("the Rice form did not launch X1")
        for form, dec in outs.items():
            if not torch.equal(dec, outs["index"]):
                raise AssertionError(f"{label}: the {form} decode differs "
                                     "from the index form's")
        if config.residual_mode != et.RESIDUAL_NONE:
            err = float((outs["rice"] - x).abs().max())
            if err > config.error:
                raise AssertionError(f"{label}: decode error {err}")
        print(f"decode {label}: every upload form bit-equal to the index "
              "form")
    return captured


def x1_inputs(torch, idx, vals, trim=None):
    """X1's arguments for sorted positions idx and values vals, packed by
    the host library (``native.rice_block_pack``) and padded as the codec
    pads them, on the card: -> (args, kwargs without s).  With ``trim``
    the words are not padded and the last ``trim`` of them are dropped."""
    from ebcc_tpu_torch import native
    from ebcc_tpu_torch.core import transfer
    w, lg, lv, kp, bp, nb = native.rice_block_pack(idx, vals)
    nbk = transfer.rice_block_bucket(nb)
    nwk = transfer.rice_block_bucket(w.size) if trim is None else w.size - trim

    def pad(a, size, dt, view):
        out = np.zeros(size, dt)
        out[:min(a.size, size)] = a[:size]
        return torch.from_numpy(out.view(view)).cuda()

    args = (pad(w, nwk, np.uint32, np.int32),
            pad(lg, nbk, np.uint16, np.int16),
            pad(lv, nbk, np.uint16, np.int16),
            pad(kp, nbk, np.uint8, np.uint8),
            pad(bp, nbk, np.int32, np.int32),
            torch.tensor([idx.size], dtype=torch.int32).cuda())
    return args, {"n_blocks": nbk}


X1_S = 4 * 736 * 1440    # one layer of a MAX_ERROR or rate sub-batch


def synthetic_pairs(n, space, scale, seed):
    """n sorted distinct positions in [0, space) and values of magnitude
    geometric with mean ``scale``, random signs and every 997th an escape
    (2^28), from a seed."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(space, n, replace=False)).astype(np.int64)
    vals = rng.geometric(1.0 / scale, n) * rng.choice([-1, 1], n)
    vals[::997] = 1 << 28
    return idx, vals.astype(np.int32)


def lane_case(torch, case, rng):
    """X1's arguments of an edge case, padded as the codec pads them:
    -> (args, kwargs)."""
    from ebcc_tpu_torch.core import transfer
    s = 1 << 23
    n = {"escape in every block": 1024, "k at its clamp": 1024,
         "128 escapes in a block": 128,
         "lane ending in the last 3 words": 3000,
         "windows clipped at the stream's end": 3000,
         "nnz 1024 with padded lanes": 1024,
         "2^22 pairs at the cap": transfer.COMPACT_CAP_LIMIT}.get(case)
    n = int(case) if n is None else n
    if case == "2^22 pairs at the cap":
        s = X1_S
        idx, vals = synthetic_pairs(n, 2 * s, 16, seed=22)
    elif case == "128 escapes in a block":
        idx = (np.arange(n, dtype=np.int64) + 1) * 100000
        vals = (rng.integers(1 << 20, 1 << 30, n)
                * rng.choice([-1, 1], n)).astype(np.int32)
    else:
        idx = np.sort(rng.choice(1 << 22, n, replace=False)).astype(np.int64)
        vals = rng.integers(-300, 301, n).astype(np.int32)
    if case == "escape in every block":
        vals[::128] = -(1 << 30)
    if case == "k at its clamp":
        vals[:] = 1 << 13
    trim = {"lane ending in the last 3 words": 0,
            "windows clipped at the stream's end": 2}.get(case)
    args, kw = x1_inputs(torch, idx, vals, trim)
    kp, lg, lv = args[3], args[1], args[2]
    if case == "k at its clamp" and not ((kp[:1] >> 4) == 11).all():
        raise AssertionError("the k-clamp case does not reach k = 11")
    if case == "128 escapes in a block" and not (
            int(lg[0]) & 0xFFFF == int(lv[0]) & 0xFFFF == 6656):
        raise AssertionError("the escape block's lanes are not 6,656 bits")
    return args, {**kw, "s": s}


X1_EDGE_CASES = ("0", "1", "127", "128", "129", "escape in every block",
                 "k at its clamp", "lane ending in the last 3 words",
                 "windows clipped at the stream's end",
                 "128 escapes in a block", "nnz 1024 with padded lanes")


def x1_row(torch, xh, args, kw, plain_limit_s=3.0):
    """One X1 density: bit-equal to the plain version, then pairs, lanes,
    words, device span and the X1 kernels' own time (``x1_profile``),
    kernels per call by the library's count, event ms, the byte bound and
    the plain ms (skipped when one plain call takes over
    ``plain_limit_s``)."""
    fn = lambda: xh.rice_unpack_qflat(*args, **kw)
    plain = lambda: xh.rice_unpack_qflat_plain(*args, **kw)
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    got = fn()
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    del got, want
    before = xh.cuda_kernels_launched()
    fn()
    torch.cuda.synchronize()
    words, nb = args[0], kw["n_blocks"]
    row = {"pairs": int(args[5].reshape(-1)[0]), "lanes": nb,
           "words": words.numel(), "equal": equal,
           "kernels_per_call": xh.cuda_kernels_launched() - before,
           "nbytes": 4 * words.numel() + 5 * nb + 4 + 4 * nb + 8 * kw["s"]}
    row["bound_ms"], row["bound_by"] = bound(row["nbytes"], 0)
    row["ms"] = median_ms(fn)
    row["plain_ms"] = (median_ms(plain, reps=3, warm=1)
                       if plain_s < plain_limit_s else None)
    row["device_ms"], row["kernel_ms"], row["profiled_kernels"] = (
        x1_profile(torch, fn))
    return row


def x1_line(name, row):
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    plain = ("skipped (one call over 3 s)" if row["plain_ms"] is None
             else f"{row['plain_ms']:.4f} ms")
    return (f"  X1 {name}: {row['pairs']} pairs, {row['lanes']} lanes, "
            f"{row['words']} words; device span {fmt(row['device_ms'])}, "
            f"X1 kernels {fmt(row['kernel_ms'])}, kernels per call "
            f"{row['kernels_per_call']} (library count; profiler "
            f"{row['profiled_kernels']}), event {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {plain}")


def phase_x1(torch, xh, first_calls, main_launches, card):
    """Phase 14c: X1 against its plain version on the card, bit for bit:
    on the blocks of 14b's first Rice call of each run (MAX_ERROR, rate,
    temporal), on the edge cases and on 2^22 pairs at the compaction's cap
    (32,768 blocks).  At the four densities the numbers of
    :func:`x1_row`; at most 3 kernels per call by the library's count.
    Returns the MAX_ERROR row (the kernels line's)."""
    rows = {}
    for label, (args, kw) in first_calls.items():
        rows[label] = x1_row(torch, xh, args, kw)
    rng = np.random.default_rng(14)
    for case in X1_EDGE_CASES:
        args, kw = lane_case(torch, case, rng)
        got = xh.rice_unpack_qflat(*args, **kw)
        want = xh.rice_unpack_qflat_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"X1 disagrees with its plain version "
                                 f"({case})")
    cap = "2^22 pairs at the cap"
    args, kw = lane_case(torch, cap, rng)
    rows[cap] = x1_row(torch, xh, args, kw)
    del args
    print(f"X1 on {card}: bit-equal to its plain version at nnz "
          f"{', '.join(X1_EDGE_CASES)}")
    for name, row in rows.items():
        print(x1_line(name, row))
        if not row["equal"]:
            raise AssertionError(f"X1 disagrees with its plain version on "
                                 f"{name}")
        if row["kernels_per_call"] > 3:
            raise AssertionError(f"X1 launched {row['kernels_per_call']} "
                                 f"kernels in one call ({name})")
    print(f"  X1: {main_launches} launches per 32-frame roundtrip (phase 3)")
    return {**rows["MAX_ERROR"], "err": 0.0}


def x1_profile(torch, fn, calls=5):
    """(median device span of one call of fn, median device time of X1's
    kernels in a call, median CUDA kernels per call) from one
    torch.profiler session over calls + 1 calls, the first left out.  A
    call ends at each end of the decode kernel (``rice_lanes``); its span
    starts at its first device event, the clearing memset included; X1's
    kernels are ``lane_chunk_offsets`` and ``rice_lanes``; memsets and
    copies are not counted as kernels.  (None, None, None) when the
    session has no X1 kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls + 1):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    spans, kernel, counts = [], [], []
    start, own, n = None, 0.0, 0
    for t0, t1, name in ev:
        start = t0 if start is None else start
        if "rice_lanes" in name or "lane_chunk_offsets" in name:
            own += t1 - t0
        n += not name.startswith(("Memcpy", "Memset"))
        if "rice_lanes" in name:
            spans.append((t1 - start) / 1e3)
            kernel.append(own / 1e3)
            counts.append(n)
            start, own, n = None, 0.0, 0
    if len(spans) < 2:
        return None, None, None
    return (statistics.median(spans[1:]), statistics.median(kernel[1:]),
            statistics.median(counts[1:]))


def phase_u16(torch, et, dh, frames, main_streams, card):
    """Phase 14d: the 32 numpy frames through ``encode_frames_device`` with
    the u16 upload: every frame within 0.5 of the float originals under
    the port's decoder, upload bytes per point against the float upload,
    stream bytes against it, K1 launched."""
    from ebcc_tpu_torch.core import transfer
    n = frames.shape[0]
    x = frames.reshape(n, 1, H, W)
    config = era5_config(et, n)
    runs = {}
    for name, opts in (("float32", et.EncodeOptions()),
                       ("u16", et.EncodeOptions(u16_upload=True))):
        dh.reset_launch_counts()
        transfer.reset_link_stats()
        streams, wall = timed(et.encode_frames_device, x, config, opts,
                              max_batch=4)
        runs[name] = (streams, transfer.LINK_STATS["up"], wall,
                      dh.launch_counts()["dwt2d_quantize"])
    if runs["float32"][0] != main_streams:
        raise AssertionError("the numpy float32 upload differs from phase "
                             "3's streams")
    streams = runs["u16"][0]
    dec = et.decode_frames_device(streams, max_batch=4)
    err = float((dec - torch.from_numpy(x).cuda()).abs().max())
    for name, (st, up, wall, k1) in runs.items():
        print(f"u16 (d) on {card}: {name} upload {up} B = {up / x.size:.4f} "
              f"B per point, streams {sum(map(len, st))} B, encode wall "
              f"{wall:.4f} s, K1 launches {k1}")
    print(f"u16 (d): max error {err:.6f} against the float originals")
    if err > config.error or runs["u16"][3] == 0:
        raise AssertionError(f"u16 upload: error {err}, K1 launches "
                             f"{runs['u16'][3]}")


def phase_routing(et, frames, card):
    """Phase 14e: the link probe of the card both ways, ``backend_choice``
    for encode and decode, and under ``EBCC_LINK_MBPS=1`` the decision and
    an explicit native route's encode, decoded on the card within 0.5 (the
    host codec builds: phase 12a).  Returns what ran."""
    from ebcc_tpu_torch.core import routing
    with env_set(EBCC_LINK_MBPS=""):          # "" = probe the link
        routing.reset_cache()
        up, down = routing.link_mbps("cuda")
        choice = {k: routing.backend_choice(k) for k in ("encode", "decode")}
    print(f"routing (e) on {card}: link probe {up:.1f} MB/s up, "
          f"{down:.1f} MB/s down; host codec available "
          f"{routing._native_available()}; backend_choice {choice}")
    with env_set(EBCC_LINK_MBPS="1"):
        routing.reset_cache()
        slow = {k: routing.backend_choice(k) for k in ("encode", "decode")}
        print(f"routing (e) with EBCC_LINK_MBPS=1: backend_choice {slow}")
        with env_set(EBCC_ENCODE_BACKEND="native"):
            routed, t_enc = timed(et.encode, frames[0], era5_config(et, 1))
    routing.reset_cache()
    err = float(np.abs(et.decode(routed, device="cuda")[0] - frames[0]).max())
    print(f"routing (e): explicit native encode of one frame in {t_enc:.4f}"
          f" s, {len(routed)} bytes, decoded on the card, max error "
          f"{err:.6f}")
    if not routing._native_available():
        raise AssertionError("routing: the host codec is not available")
    if err > 0.5:
        raise AssertionError(f"routing: native encode over the bound {err}")
    return {"choice": choice, "slow link": slow, "native encode error": err}


# ---- phase 15: the JAX package's host modules ----

# Full 721 x 1440 frames of phase 15a: the J2K search takes ~14.5 s a frame
# on the H100 host's CPU (PERF.md), so 3 keep the phase near 60 s.
LEGACY_FRAMES = 3


def no_launches(torch, dh, fn, *args, **kw):
    """-> (fn's result, wall seconds); raises when a kernel of the port was
    launched in the call (K1, K2, K3 and X1: the wrappers' counts and the
    kernels' library's own)."""
    torch.cuda.synchronize()
    reset_all_counts(dh)
    before = dh.cuda_kernels_launched()
    out, wall = timed(fn, *args, **kw)
    torch.cuda.synchronize()
    counts = all_counts(dh)
    if any(counts.values()) or dh.cuda_kernels_launched() != before:
        raise AssertionError(f"host-only work launched kernels: {counts}")
    return out, wall


def phase_legacy(torch, et, dh, frames, card):
    """Phase 15a: legacy EBCC/EBCK streams (host work: J2K through Pillow,
    SPIHT and zstd level 22 in C).  ``LEGACY_FRAMES`` frames through
    ``compat.encode_chunked`` in (1, H, W) chunks at MAX_ERROR 0.5 and one
    through ``encode_frame`` at RELATIVE_ERROR 1e-2: each within its bound
    through ``compat.decode`` and ``ebcc_tpu_torch.decode`` on the card; a
    truncated stream raises ``LegacyFormatError``; no kernel launched."""
    import PIL
    from PIL import features
    from ebcc_tpu_torch import compat
    print(f"Pillow {PIL.__version__}, jpg_2000 "
          f"{features.check('jpg_2000')}")
    n = LEGACY_FRAMES
    data = frames[:n]
    cfg = et.CodecConfig(dims=(n, H, W), base_cr=30,
                         residual_mode=et.RESIDUAL_MAX_ERROR, error=0.5,
                         chunk_dims=(1, H, W))
    rel = et.CodecConfig(dims=(1, H, W), base_cr=30,
                         residual_mode=et.RESIDUAL_RELATIVE_ERROR, error=1e-2)
    rng = float(frames[n].max() - frames[n].min())
    cases = (("EBCK", compat.encode_chunked, data, cfg, 0.5),
             ("EBCC", compat.encode_frame, frames[n], rel, 1e-2 * rng))
    for magic, enc, x, config, bound in cases:
        blob, t_enc = no_launches(torch, dh, enc, x, config)
        if blob[:4] != magic.encode():
            raise AssertionError(f"legacy stream magic {blob[:4]!r}")
        host, t_dec = no_launches(torch, dh, compat.decode, blob)
        card_out, t_card = no_launches(torch, dh, et.decode, blob,
                                       device="cuda")
        if not np.array_equal(host, card_out):
            raise AssertionError("ebcc_tpu_torch.decode differs from "
                                 "compat.decode on a legacy stream")
        err = float(np.abs(host.reshape(x.shape) - x).max())
        print(f"legacy {magic} on {card}: {x.size // (H * W)} frame(s) "
              f"{H}x{W}, {config.residual_mode} at {config.error}, encode "
              f"{t_enc:.4f} s, compat.decode {t_dec:.4f} s, "
              f"ebcc_tpu_torch.decode(device='cuda') {t_card:.4f} s, "
              f"{len(blob)} bytes, CR {x.nbytes / len(blob):.3f}, max "
              f"error {err:.6f} (bound {bound:.6f}); no kernel launched")
        if err > bound:
            raise AssertionError(f"legacy {magic}: error {err} > {bound}")
        try:
            compat.decode(blob[:-5])
        except compat.LegacyFormatError as e:
            print(f"  truncated {magic} stream: LegacyFormatError ({e})")
        else:
            raise AssertionError("a truncated legacy stream decoded")


def phase_plugin(et, frames, tmp, card):
    """Phase 15b: the port's HDF5 filter plugin.  Its filter, reached as
    HDF5 reaches it (``H5PLget_plugin_info``), on a (4, H, W) chunk at
    MAX_ERROR 0.5: the bytes decode on the card within 0.5, the reverse
    flag gives ``native.native_decode``'s values.  Where ``h5py`` imports,
    a dataset written and read through the plugin in a process of its
    own."""
    import ctypes
    import ctypes.util
    from ebcc_tpu_torch import native
    from ebcc_tpu_torch.api.filter_wrapper import EBCC_Filter
    from ebcc_tpu_torch.ops import _build
    t0 = time.perf_counter()
    pdir = native.plugin_dir()
    lib_path = os.path.join(pdir, os.listdir(pdir)[0])
    secs = {k: round(v, 2) for k, v in _build.BUILD_SECONDS.items()
            if k.startswith(_build.PLUGIN)}
    print(f"HDF5 plugin {os.path.relpath(lib_path)} "
          f"({_build.BUILD_KIND[_build.PLUGIN]}) built in {secs} s "
          f"({time.perf_counter() - t0:.2f} s with its checks); directory "
          f"entries {os.listdir(pdir)}")
    if len(os.listdir(pdir)) != 1:
        raise AssertionError("the plugin directory holds more than it")
    fn_t = ctypes.CFUNCTYPE(
        ctypes.c_size_t, ctypes.c_uint, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_void_p))

    class H5ZClass2(ctypes.Structure):
        _fields_ = [("version", ctypes.c_int), ("id", ctypes.c_int),
                    ("encoder_present", ctypes.c_uint),
                    ("decoder_present", ctypes.c_uint),
                    ("name", ctypes.c_char_p),
                    ("can_apply", ctypes.c_void_p),
                    ("set_local", ctypes.c_void_p), ("filter", fn_t)]

    lib = ctypes.CDLL(lib_path)
    lib.H5PLget_plugin_info.restype = ctypes.POINTER(H5ZClass2)
    cls = lib.H5PLget_plugin_info().contents
    if (cls.version, cls.id, cls.encoder_present,
            cls.decoder_present) != (1, 33030, 1, 1):
        raise AssertionError("the plugin's filter class is not 33030's")
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    libc.malloc.restype = ctypes.c_void_p
    libc.malloc.argtypes = [ctypes.c_size_t]
    libc.free.argtypes = [ctypes.c_void_p]
    kw = dict(EBCC_Filter(base_cr=30, height=H, width=W,
                          residual_opt=("max_error_target", 0.5),
                          data_dim=3))
    cd = (ctypes.c_uint * 5)(*kw["compression_opts"])

    def run(flags, data):
        buf = ctypes.c_void_p(libc.malloc(len(data)))
        ctypes.memmove(buf, data, len(data))
        size = ctypes.c_size_t(len(data))
        n = cls.filter(flags, 5, cd, len(data), ctypes.byref(size),
                       ctypes.byref(buf))
        try:
            if n == 0:
                raise AssertionError("the plugin's filter failed")
            return ctypes.string_at(buf, n)
        finally:
            libc.free(buf)

    x = np.ascontiguousarray(frames[:4])
    blob, t_enc = timed(run, 0, x.tobytes())
    out, t_dec = timed(et.decode, blob, device="cuda")
    err = float(np.abs(out - x).max())
    back, t_rev = timed(run, 0x0100, blob)
    back = np.frombuffer(back, np.float32)
    if not np.array_equal(back, native.native_decode(blob)):
        raise AssertionError("the plugin's reverse filter differs from "
                             "native_decode")
    print(f"plugin filter on {card}: (4, {H}, {W}) chunk encoded in "
          f"{t_enc:.4f} s ({len(blob)} bytes, CR "
          f"{x.nbytes / len(blob):.3f}), decoded on the card in {t_dec:.4f}"
          f" s, max error {err:.6f}; reverse flag in {t_rev:.4f} s == "
          f"native_decode")
    if err > 0.5:
        raise AssertionError(f"plugin stream over the bound: {err}")
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("h5py: not importable; no dataset written through the plugin")
        return
    np.save(os.path.join(tmp, "plugin_x.npy"), x)
    code = ("import sys, numpy as np, h5py\n"
            "x = np.load(sys.argv[1]); kw = eval(sys.argv[2])\n"
            "with h5py.File(sys.argv[3], 'w') as f:\n"
            "    f.create_dataset('v', shape=x.shape, **kw)[...] = x\n"
            "with h5py.File(sys.argv[3], 'r') as f:\n"
            "    y = f['v'][...]\n"
            "print(float(abs(y - x).max()))\n")
    env = dict(os.environ, HDF5_PLUGIN_PATH=pdir)
    proc, t = timed(subprocess.run, [
        sys.executable, "-c", code, os.path.join(tmp, "plugin_x.npy"),
        repr(kw), os.path.join(tmp, "plugin.h5")], capture_output=True,
        text=True, env=env, timeout=CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"h5py through the plugin failed: "
                             f"{proc.stderr[-2000:]}")
    err = float(proc.stdout.split()[-1])
    print(f"h5py (importable) through the plugin: 4 frames written and read"
          f" in a process in {t:.2f} s, max error {err:.6f}")
    if err > 0.5:
        raise AssertionError(f"h5py through the plugin: error {err}")


def phase_native_built(build_seconds, routed):
    """Phase 15c: native routing builds on this machine now (phase 12a's
    library) and phases 12e and 14e ran their routed calls."""
    secs = {k: round(v, 2) for k, v in build_seconds.items()
            if k.startswith("ebcc_native_codec")}
    print(f"native routing: libebcc_native_codec.so built in {secs} s; "
          f"phase 12e "
          f"(routed container encode and decodes) and 14e ({routed}) ran "
          f"within 0.5")


def phase_pgo(torch, et, frames, card):
    """Phase 15d: the CAB coder with PGO and without it, each its own
    ``libebcc_host.so``: phase 12b's ``cab`` roundtrip on each (PGO,
    plain, plain, PGO), streams byte-identical, the host stages of each
    run and both builds' seconds."""
    import ctypes
    import dataclasses
    import shutil
    import tempfile
    from ebcc_tpu_torch import native
    from ebcc_tpu_torch.ops import _build
    default = _build.BUILD_KIND["ebcc_host"]
    with contextlib.ExitStack() as stack:
        if default != "pgo":
            # One compiler for both builds, so the comparison is PGO's
            # alone, in a build directory of this phase's own.
            cxx = shutil.which("c++")
            print(f"CAB PGO: the default build is {default!r}; both builds "
                  f"with {cxx} in a build directory of this phase's own")
            stack.enter_context(env_set(CXX=cxx))
            stack.enter_context(patched(_build, "BUILD_DIR", stack.enter_context(
                tempfile.TemporaryDirectory(dir=_build.BUILD_DIR))))
            stack.enter_context(patched(_build, "BUILD_SECONDS", {}))
        paths = {}
        for kind, pgo in (("pgo", True), ("plain", False)):
            paths[kind] = _build.build_host("ebcc_host", pgo=pgo)
            if _build.BUILD_KIND["ebcc_host"] != kind:
                raise AssertionError(f"libebcc_host.so {kind} build: "
                                     f"{_build.BUILD_KIND['ebcc_host']}")
        secs = {k: round(v, 2) for k, v in _build.BUILD_SECONDS.items()
                if k.startswith(("cab_pgo", "ebcc_host"))}
        print(f"CAB PGO on {card}: {compiler_line(_build.cxx_path())}, "
              f"libebcc_host.so "
              f"builds {[os.path.relpath(p, _build.CSRC) for p in paths.values()]}"
              f", build seconds {secs} (the PGO sequence's steps, then each "
              f"library)")
        libs = {k: native.bind_host(ctypes.CDLL(p)) for k, p in paths.items()}
    _build.BUILD_KIND["ebcc_host"] = default
    if paths["pgo"] == paths["plain"]:
        raise AssertionError("the PGO and plain builds share a file")
    n = frames.shape[0]
    x = torch.from_numpy(frames).reshape(n, 1, H, W).cuda()
    config = dataclasses.replace(era5_config(et, n), entropy_backend="cab")
    opts = et.EncodeOptions()
    streams = {}
    for kind in ("pgo", "plain", "plain", "pgo"):
        with patched(native, "_host_lib", libs[kind]):
            torch.cuda.synchronize()
            (out, dec), wall, snap = timed_stages(
                et.roundtrip_frames_device, x, config, opts, max_batch=4)
            torch.cuda.synchronize()
        err = float((x - dec).abs().max())
        print(f"  cab roundtrip with the {kind} coder: {wall:.4f} s, "
              f"assemble+zstd {stage_s(snap, 'assemble+zstd'):.4f} s, dec: "
              f"entropy decode {stage_s(snap, 'dec: entropy decode'):.4f} s"
              f" (thread time), {sum(len(s) for s in out)} bytes, max "
              f"error {err:.6f}")
        if err > 0.5:
            raise AssertionError(f"cab ({kind}): error {err}")
        if streams.setdefault(kind, out) != out:
            raise AssertionError(f"cab ({kind}) streams differ between runs")
    if streams["pgo"] != streams["plain"]:
        raise AssertionError("PGO and plain CAB coders wrote other streams")
    print("  PGO and plain CAB streams byte-identical")


def phase_reference_bin(card):
    """Phase 15e: ``compat.reference_bin`` needs the reference's C sources,
    which no checkout holds: it raises ``ReferenceUnavailable``."""
    from ebcc_tpu_torch.compat import reference_bin as rb
    try:
        rb.load()
    except rb.ReferenceUnavailable as e:
        print(f"reference_bin on {card}: ReferenceUnavailable ({e}); "
              f"sources looked for in {rb.REFERENCE_SRC}")
        return
    print(f"reference_bin on {card}: the reference built from "
          f"{rb.REFERENCE_SRC}")


def phase_bench(card):
    """Phase 16: every section of the port's bench at 8 frames of
    721x1440, one timed headline rep."""
    from ebcc_tpu_torch import bench
    launches = {}
    t0 = time.perf_counter()
    result = bench.run(device="cuda", frames=8, reps=1, launches=launches)
    wall = time.perf_counter() - t0
    print(json.dumps(result))
    print(f"bench on {card}: {wall:.2f} s, sections {sorted(launches)}, "
          f"headline launches {launches['headline']}")
    if result["max_error"] > result["error_target"]:
        raise AssertionError(f"bench max error {result['max_error']}")
    ref_keys = ("ref_binary_pts_per_s", "ref_binary_cr",
                "ref_binary_max_error", "vs_ref_binary",
                "cab_point_vs_ref_binary", "cab_point_cr_vs_ref",
                "baseline_point_backend", "baseline_point_pts_per_s",
                "baseline_point_compression_ratio")
    for k, v in result.items():
        if k in ref_keys:
            continue
        if v is None:
            raise AssertionError(f"bench field {k} is null")
        if ("pts_per_s" in k or "ratio" in k or "MBps" in k
                or k in ("value", "vs_baseline", "vs_measured_serial")):
            if not (np.isfinite(v) and v > 0):
                raise AssertionError(f"bench field {k} = {v}")
    if card not in result["device"]:
        raise AssertionError(f"bench device {result['device']!r} does not "
                             f"name {card!r}")
    head = launches["headline"]
    for name in ("dwt2d_quantize", "idwt2d_dequant", "rice_unpack_qflat"):
        if not head.get(name):
            raise AssertionError(f"bench headline launched no {name}")


def rank_worker(args):
    """One rank of phase 13b or 13c (this script run with ``--worker``)."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ebcc_tpu_torch.parallel import global_range, make_mesh, multihost
    dist = torch.distributed
    frames = np.load(os.path.join(args.dir, "frames.npy"), mmap_mode="r")
    if args.worker == "nccl":
        multihost.initialize(f"localhost:{args.port}", 1, 0)
        try:
            t = torch.tensor([[3.0, -2.0], [-1.0, 5.0]], device="cuda")
            lo, hi = t.clone(), t.clone()
            dist.all_reduce(lo, op=dist.ReduceOp.MIN)
            dist.all_reduce(hi, op=dist.ReduceOp.MAX)
            if not (torch.equal(lo, t) and torch.equal(hi, t)):
                raise AssertionError("one-rank all_reduce changed its input")
            rng = global_range(np.asarray(frames), make_mesh())
            if rng != (float(frames.min()), float(frames.max())):
                raise AssertionError(f"nccl global_range {rng}")
            meta = {"backend": dist.get_backend(), "range": list(rng),
                    "reduced": lo.tolist()}
        finally:
            dist.destroy_process_group()
        with open(os.path.join(args.dir, "nccl.json"), "w") as f:
            json.dump(meta, f)
        return 0
    import ebcc_tpu_torch as et
    from ebcc_tpu_torch.ops import dwt_hopper as dh
    multihost.initialize(f"localhost:{args.port}", args.world, args.rank,
                         backend="gloo")
    try:
        n = frames.shape[0]
        config = era5_config(et, n)
        opts = et.EncodeOptions()
        et.encode_chunked(np.asarray(frames[:1]), era5_config(et, 1), opts)
        dist.barrier()
        dh.reset_launch_counts()
        t0 = time.time()
        streams, (start, stop) = multihost.encode_owned_chunks(
            frames, config, opts, max_batch=4)
        t1 = time.time()
        launches = dh.launch_counts()
        rng = global_range(np.asarray(frames[start:stop]), make_mesh())
        with open(os.path.join(args.dir, f"part{args.rank}.bin"), "wb") as f:
            f.write(multihost.container_part(streams))
        meta = {"rank": args.rank, "start": start, "stop": stop,
                "device": str(make_mesh().flat[0]), "t0": t0, "t1": t1,
                "wall": t1 - t0, "launches": launches, "range": list(rng)}
        with open(os.path.join(args.dir, f"meta{args.rank}.json"), "w") as f:
            json.dump(meta, f)
    finally:
        dist.destroy_process_group()
    return 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # A rank of phase 13 (the script starts these itself).
    for flag in ("--worker", "--rank", "--world", "--port", "--dir"):
        parser.add_argument(flag, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        args.rank, args.world = int(args.rank), int(args.world)
        return rank_worker(args)
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
    from ebcc_tpu_torch import native
    from ebcc_tpu_torch.ops import _build
    from ebcc_tpu_torch.bench import load_frames
    from ebcc_tpu_torch.ops import dwt_hopper as dh

    # ---- phase 1: card and build ----
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"card: {card}, float32 add/multiply rate "
          f"{f32_ops_per_s(torch):.4e} ops/s (bounds' operations rate)")
    from ebcc_tpu_torch.core import entropy
    binding = entropy.zstd_binding()
    print(f"zstd binding: {binding}")
    if binding is None:
        raise AssertionError("no zstd binding (neither zstandard nor "
                             "libzstd.so.1): payloads would be STORE")
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                     if f.endswith(".cu"))

    def host_codec():
        """The native codec's build; its failure is recorded (phase 12)."""
        try:
            native.load_codec()
        except RuntimeError as e:
            return e
        return None

    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(sources) + 2) as pool:
        builds = [pool.submit(_build.load, s) for s in sources]
        builds.append(pool.submit(_build.load_host, "ebcc_host"))
        codec_build = pool.submit(host_codec)
        for f in builds:
            f.result()
        codec_error = codec_build.result()
    print(f"built {sources}, libebcc_host.so and "
          f"{'libebcc_native_codec.so' if codec_error is None else 'not the native codec'} "
          f"in {time.perf_counter() - t0:.2f} s ({_build.BUILD_SECONDS})")

    # ---- phase 2: kernels against their plain versions ----
    frames = load_frames(32)
    tall = load_frames(4, TALL_H, TALL_W)
    rows = phase_kernels(torch, dh, frames, tall)
    print(f"card: {card}")

    # ---- phase 3: main path ----
    launches, wall, cr, main_streams = phase_main_path(torch, et, dh, frames,
                                                      card)

    # ---- phase 4: K3 against its plain version ----
    rows.update(phase_curve(torch, dh, frames, tall))

    # ---- phase 5: the fused-curve path, RELATIVE_ERROR ----
    launches["curve_stats"] = phase_relative(
        torch, et, dh, frames, card)["curve_stats"]

    # ---- phase 6: POINTWISE_RELATIVE with allow_nan ----
    phase_pointwise_masked(torch, et, dh, frames, card)

    # ---- phase 7: frames taller than the old column pass took ----
    phase_tall(torch, et, dh, tall, card)

    # ---- phase 8: rate mode ----
    rate_config, rate_streams = phase_rate(torch, et, dh, frames, card)

    # ---- phase 9: temporal mode ----
    drifting, temporal_streams, temporal_config = phase_temporal(
        torch, et, dh, frames, card)

    # ---- phase 10: lossless mode ----
    phase_lossless(torch, et, dh, frames, card)

    # ---- phase 11: ETPK containers, region decode, streaming IO ----
    blob = phase_container_era5(et, dh, frames, main_streams, card)
    phase_container_compat(et, dh, tall, card)
    phase_container_stream(et, frames, blob, card)
    phase_container_temporal(et, dh, drifting, temporal_streams, card)

    # ---- phase 12: CAB, native packer/unpacker, native routing ----
    phase_native_build(_build.BUILD_SECONDS, codec_error)
    cab_streams = phase_cab_main_path(torch, et, dh, frames, card)
    phase_pack_unpack_twins(torch, et, frames, main_streams,
                            temporal_streams, card)
    phase_rate_assembly(torch, et, dh, frames, card)
    phase_native_routing(et, frames, cab_streams, blob, codec_error, card)

    # ---- phase 13: scale-out and the user surfaces ----
    import tempfile
    phase_sharded(torch, et, dh, frames, blob, card)
    with tempfile.TemporaryDirectory() as tmp:
        phase_two_ranks(et, frames, blob, tmp, card)
        phase_nccl(tmp, card)
        phase_cli(frames, tmp, card)
        phase_trace(torch, et, frames, tmp, card)

    # ---- phase 14: the exchange forms, X1, the u16 upload, routing ----
    from ebcc_tpu_torch.ops import exchange_hopper as xh
    n = frames.shape[0]
    x_main = torch.from_numpy(frames).reshape(n, 1, H, W).cuda()
    runs = {"MAX_ERROR": (x_main, era5_config(et, n), 4, main_streams),
            "rate": (x_main, rate_config, 4, rate_streams),
            "temporal": (torch.from_numpy(drifting).cuda(), temporal_config,
                         2, temporal_streams)}
    phase_encode_forms(torch, et, runs, card)
    first_calls = phase_decode_forms(torch, et, dh, xh, runs, card)
    x1 = phase_x1(torch, xh, first_calls, launches["rice_unpack_qflat"],
                  card)
    phase_u16(torch, et, dh, frames, main_streams, card)
    routed = phase_routing(et, frames, card)

    # ---- phase 15: legacy streams, the HDF5 plugin, PGO, reference_bin ----
    phase_legacy(torch, et, dh, frames, card)
    with tempfile.TemporaryDirectory() as tmp:
        phase_plugin(et, frames, tmp, card)
    phase_native_built(_build.BUILD_SECONDS, routed)
    phase_pgo(torch, et, frames, card)
    phase_reference_bin(card)

    # ---- phase 16: the port's bench ----
    phase_bench(card)

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
    kernels.append({
        "name": "exchange_rice_unpack", "route": "cuda",
        "source": "ebcc_tpu_torch/csrc/exchange.cu",
        "replaces": "ebcc_tpu/core/transfer.py:842 (XLA lax.scan, no Pallas "
                    "kernel)",
        "launches": launches["rice_unpack_qflat"], "max_abs_err": x1["err"],
        "ms": x1["ms"], "plain_ms": x1["plain_ms"],
        "bound_ms": x1["bound_ms"], "bound_by": x1["bound_by"],
        "library_ms": None})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
