"""The port's bench: the JAX package's ``bench.py`` on a CUDA card.

Run from the root of a checkout::

    python -m ebcc_tpu_torch.bench

It prints ONE JSON line with every field of ``bench.py``'s, under the same
names and with the same definitions:

* ``value``: device-resident encode+decode throughput in grid-points/s,
  the best of ``EBCC_BENCH_REPS`` (7) runs of ``roundtrip_frames_device`` on
  ``EBCC_BENCH_FRAMES`` (32) frames of 721x1440 float32 that start and end
  on the card, sub-batches of ``EBCC_BENCH_SUBBATCH`` (4), every link byte
  and all host work (entropy coding, stream assembly and parse) inside the
  timed region, the max error computed on the card; ``median_window_pts_per_s``
  is the median over two sampling windows of each window's best;
* ``link_bytes_{up,down}_per_point`` (``transfer.LINK_STATS`` over the timed
  runs) and ``link_{up,down}_MBps`` (16 MiB of incompressible bytes each
  way, ``torch.cuda.synchronize()`` closing each leg);
* the host-to-host path (``encode_chunked`` / ``decode_chunked`` from numpy)
  and its CR, which is the bench's ``compression_ratio``; the CR of the
  same container with the CAB coder;
* ``device_compute_pts_per_s``: the encode chained into the device
  reconstruction of both shipped candidates, all on the card, no exchange;
  4 reps carry a data dependency and end in one synchronisation;
* temporal against intra CR on 8 frames, lossless CR and throughput
  (bit-exact), the port's serial host codec on one frame and the host
  codec through ``EBCC_ENCODE_BACKEND=native`` on all frames;
* a second headline window, the dual point (zstd level 9) and the CAB and
  CAB2 points through the same timed device-resident path;
* the reference binary through ``compat.reference_bin``: ``null`` (the
  reason on stderr) when ``ReferenceUnavailable``, with every field that
  depends on it.

``device`` names the card and its power limit as ``nvidia-smi`` reports
them, and the number of devices.  Kernel launches per section (K1, its
float variant, K2, K3 and X1, each wrapper's count, and the CUDA kernels
of both kernel libraries) go to stderr.

Settings, as in ``bench.py``: ``EBCC_BENCH_FRAMES``, ``EBCC_BENCH_ERROR``
(0.5), ``EBCC_BENCH_MODE`` (``max`` or ``rel``), ``EBCC_BENCH_REPS``,
``EBCC_BENCH_SUBBATCH``, ``EBCC_BENCH_ZSTD_LEVEL`` (3), ``EBCC_BENCH_ENTROPY``
(``zstd``), and the switches ``EBCC_BENCH_CAB``, ``EBCC_BENCH_TEMPORAL``,
``EBCC_BENCH_LOSSLESS``, ``EBCC_BENCH_DUAL``, ``EBCC_BENCH_CAB_POINT`` and
``EBCC_BENCH_REF`` (``0`` leaves a section out, its fields ``null``).
``EBCC_ERA5_FRAME`` may name a 721x1440 ``.npy`` frame to use as the base
field; without it the base is synthetic.

There is no fallback: without a card :func:`main` raises, and a section
that fails fails the bench.  :func:`run` takes the sizes and the device,
so the same sections run on the CPU (``device="cpu"``) at small shapes.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_PTS_PER_S = 1.0e6

H, W = 721, 1440


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _on(name: str) -> bool:
    """A section switch: on unless ``name`` is set to something but 1."""
    return os.environ.get(name, "1") == "1"


def smooth_field(rng, amplitude, h=H, w=W):
    """An h x w field interpolated bilinearly from a 24 x 46 normal grid
    drawn from ``rng``: synoptic-scale change from frame to frame rather
    than white noise."""
    coarse = rng.normal(scale=amplitude, size=(24, 46)).astype(np.float32)
    yi = np.linspace(0, 23, h)
    xi = np.linspace(0, 45, w)
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


def load_frames(n, h=H, w=W):
    """``n`` synthetic ERA5-shaped frames of h x w, seed 0: a smooth base
    field (or the frame ``EBCC_ERA5_FRAME`` names, at 721x1440) plus 0.3 per
    frame, a spatially correlated perturbation and 0.02 white noise, the
    generator of ``bench.py``."""
    path = os.environ.get("EBCC_ERA5_FRAME")
    if (h, w) == (H, W) and path and os.path.exists(path):
        base = np.load(path).astype(np.float32)
    else:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = (260 + 25 * np.sin(yy / h * np.pi) * np.cos(xx / w * 2 * np.pi)
                ).astype(np.float32)
    rng = np.random.default_rng(0)
    frames = []
    for i in range(n):
        f = base + 0.3 * i + smooth_field(rng, 1.0, h, w) + rng.normal(
            scale=0.02, size=base.shape)
        frames.append(f.astype(np.float32))
    return np.stack(frames)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_link(device="cuda"):
    """(up, down) MB/s between the host and ``device``: 16 MiB of
    incompressible bytes (a constant buffer would measure a transport's
    compressor, not the link), each leg closed by a synchronisation.  On
    the CPU both legs are copies in host memory."""
    import torch
    from .device import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 256, (16, 1024, 1024), np.uint8))
    a = x[:2].to(dev, copy=True)          # context, allocator
    a.to("cpu", copy=True)
    _sync(dev)
    t0 = time.perf_counter()
    a = x.to(dev, copy=True)
    _sync(dev)
    t1 = time.perf_counter()
    a.to("cpu", copy=True)
    _sync(dev)
    t2 = time.perf_counter()
    return 16 / (t1 - t0), 16 / (t2 - t1)


def device_line(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, and
    the number of devices; on the CPU, the CPU and its torch threads."""
    import torch
    if dev.type != "cuda":
        return f"cpu, {torch.get_num_threads()} threads"
    count = torch.cuda.device_count()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = lines[idx] if idx < len(lines) else torch.cuda.get_device_name(idx)
    return f"{card.strip()}, {count} device{'s' if count != 1 else ''}"


class _Launches:
    """Kernel launches per section: each wrapper's count (K1
    ``dwt2d_quantize``, its float variant ``dwt2d_transform``, K2
    ``idwt2d_dequant``, K3 ``curve_stats``, X1 ``rice_unpack_qflat``) and,
    on the card, the CUDA kernels both kernel libraries launched.  Printed
    to stderr with the section's wall time; kept in ``self.by_section``."""

    def __init__(self, dev):
        from .ops import dwt_hopper, exchange_hopper
        self.dh, self.xh = dwt_hopper, exchange_hopper
        self.cuda = dev.type == "cuda"
        self.by_section = {}

    def _libs(self) -> int:
        return (self.dh.cuda_kernels_launched()
                + self.xh.cuda_kernels_launched())

    @contextlib.contextmanager
    def section(self, name: str):
        self.dh.reset_launch_counts()
        self.xh.reset_launch_counts()
        lib0 = self._libs() if self.cuda else 0
        t0 = time.perf_counter()
        yield
        seconds = time.perf_counter() - t0
        counts = {**self.dh.launch_counts(), **self.xh.launch_counts()}
        if self.cuda:
            counts["cuda_kernels"] = self._libs() - lib0
        self.by_section[name] = counts
        print(f"bench section {name}: {seconds:.3f} s, launches "
              f"{json.dumps(counts)}", file=sys.stderr)


def _check(ok, what) -> None:
    if not ok:
        raise AssertionError(what)


def _r(v, nd):
    """``round(v, nd)``, None kept."""
    return None if v is None else round(v, nd)


def _proxy_chain(xb, error, h, w, reps):
    """``reps`` chained device-compute roundtrips of ``xb`` (nb, 1, h, w):
    the encode, then the device reconstruction of both candidates the host
    may ship (candidate A: base at ``base_cut`` re-truncated from the
    exchanged ``store_cut`` values plus the residual; candidate B: pure
    base at ``store_cut``), the better centered max error of the two per
    chunk, the worst chunk.  Each rep's input depends on the last rep's
    error, as ``bench.py``'s ``lax.scan`` carry does; one synchronisation
    at the end (the float of the result).  -> max error over the reps."""
    import torch
    from .core import kernels
    nb = xb.shape[0]
    hp = -(-h // 32) * 32
    wpd = -(-w // 32) * 32
    s_ = nb * 1 * hp * wpd
    grid = dict(base_levels=5, res_levels=3, out_hw=(h, w),
                grid_shape=(nb, 1, hp, wpd))

    def centered_err(rec, x):
        err = rec - x
        m = err.mean(dim=(1, 2, 3), keepdim=True)
        return (err - m).abs().amax(dim=(1, 2, 3))

    def roundtrip(x):
        o = kernels.encode_batch(x, error, 1e-6)
        qb = o["vals_comb"][:s_].reshape(nb, -1)
        sh = (o["base_cut"] - o["store_cut"])[:, None]
        qb = torch.where(qb < 0, -((-qb) >> sh), qb >> sh).reshape(-1)
        rec_a = kernels._decode_from_qflat(
            torch.cat([qb, o["vals_comb"][s_:]]), o["base_cut"],
            o["res_cut"], o["minval"], o["maxval"], o["rmin"], o["rmax"],
            has_residual=True, **grid)
        rec_b = kernels._decode_from_qflat(
            o["vals_comb"], o["store_cut"], o["res_cut"], o["minval"],
            o["maxval"], o["rmin"], o["rmax"], has_residual=False, **grid)
        return torch.minimum(centered_err(rec_a, x),
                             centered_err(rec_b, x)).max()

    carry = torch.zeros((), dtype=torch.float32, device=xb.device)
    errs = []
    for i in range(reps):
        carry = roundtrip(xb + (carry * 0 + float(i)) * 1e-6)
        errs.append(carry)
    return float(torch.stack(errs).max())


def bench_config(dims, h, w, chunk=None, **kw):
    """The bench's ``CodecConfig`` over ``dims`` in (1, h, w) chunks (or
    ``chunk``): base_cr 30, the mode and error of ``EBCC_BENCH_MODE`` and
    ``EBCC_BENCH_ERROR``, zstd level ``EBCC_BENCH_ZSTD_LEVEL`` and the
    ``EBCC_BENCH_ENTROPY`` backend; ``kw`` overrides any field."""
    from . import CodecConfig, RESIDUAL_MAX_ERROR, RESIDUAL_RELATIVE_ERROR
    rel = os.environ.get("EBCC_BENCH_MODE", "max") == "rel"
    kw.setdefault("base_cr", 30)
    kw.setdefault("residual_mode", RESIDUAL_RELATIVE_ERROR if rel
                  else RESIDUAL_MAX_ERROR)
    kw.setdefault("error", float(os.environ.get("EBCC_BENCH_ERROR", "0.5")))
    kw.setdefault("zstd_level", _env_int("EBCC_BENCH_ZSTD_LEVEL", 3))
    kw.setdefault("entropy_backend",
                  os.environ.get("EBCC_BENCH_ENTROPY", "zstd"))
    return CodecConfig(dims=tuple(dims), chunk_dims=chunk or (1, h, w), **kw)


def device_roundtrip(x_dev, config, opts, sub):
    """The headline's timed unit: ``roundtrip_frames_device`` of the
    frames on the device in sub-batches of ``sub`` (sub-batch k's host
    assembly and decode run while k+1 encodes; streams byte-identical to
    sequential), then the max error on the device.  -> (streams, max
    error)."""
    from . import roundtrip_frames_device
    streams, dec = roundtrip_frames_device(x_dev, config, opts,
                                           max_batch=sub)
    return streams, float((x_dev - dec).abs().max())


def run(device="cuda", frames=None, h=H, w=W, reps=None, launches=None):
    """Every section of the bench on ``device`` (the card unless
    ``device="cpu"``) over ``frames`` frames of h x w (default
    ``EBCC_BENCH_FRAMES``, 32) with ``reps`` timed headline runs (default
    ``EBCC_BENCH_REPS``, 7); the other settings from the environment.
    -> the result dict (``bench.py``'s fields).  ``launches``, a dict,
    receives the kernel launches of each section."""
    import torch

    from . import (CodecConfig, EncodeOptions, RESIDUAL_LOSSLESS,
                   RESIDUAL_MAX_ERROR, decode_chunked, encode_chunked,
                   native)
    from .compat import reference_bin
    from .core import transfer
    from .device import resolve_device

    dev = resolve_device(device)
    n = _env_int("EBCC_BENCH_FRAMES", 32) if frames is None else int(frames)
    reps = _env_int("EBCC_BENCH_REPS", 7) if reps is None else int(reps)
    error_mode = os.environ.get("EBCC_BENCH_MODE", "max")
    sub = _env_int("EBCC_BENCH_SUBBATCH", 4)
    log = _Launches(dev)

    data = load_frames(n, h, w)
    n_points = data.size

    def cfg(dims=data.shape, chunk=None, **kw):
        return bench_config(dims, h, w, chunk, **kw)

    config = cfg()
    error = config.error
    opts = EncodeOptions.from_env()
    bound = error if error_mode == "max" else error * float(
        data.max() - data.min())

    # ---- device-resident path (headline) ----
    x_dev = torch.from_numpy(data.reshape(n, 1, h, w)).to(dev)
    _sync(dev)

    def roundtrip(c=config):
        return device_roundtrip(x_dev, c, opts, sub)

    with log.section("headline"):
        streams, maxerr = roundtrip()    # warm-up: kernel builds
        _check(maxerr <= bound, ("headline", maxerr, bound))
        blob_bytes = sum(len(s) for s in streams)
        window_minima = []       # each sampling window's best rep (s)
        dev_t = []
        transfer.reset_link_stats()
        for _ in range(reps):
            t0 = time.perf_counter()
            streams, maxerr = roundtrip()
            dev_t.append(time.perf_counter() - t0)
            _check(maxerr <= bound, ("headline", maxerr, bound))
        window_minima.append(min(dev_t))
        link_up_bpp = transfer.LINK_STATS["up"] / (reps * n_points)
        link_down_bpp = transfer.LINK_STATS["down"] / (reps * n_points)

    # ---- host-to-host path ----
    with log.section("host"):
        blob = encode_chunked(data, config, device=dev)
        out = decode_chunked(blob, device=dev)
        host_maxerr = float(np.abs(out - data).max())
        _check(host_maxerr <= bound, ("host", host_maxerr, bound))
        he0 = time.perf_counter()
        blob = encode_chunked(data, config, device=dev)
        he1 = time.perf_counter()
        out = decode_chunked(blob, device=dev)
        he2 = time.perf_counter()
        host_pts_per_s = n_points / (he2 - he0)
        host_encode_pts = n_points / (he1 - he0)
        host_decode_pts = n_points / (he2 - he1)
        cr = data.nbytes / len(blob)
    up, down = measure_link(dev)

    # CR at the CAB coder on the same data and bound (the ratio headline;
    # the throughput headline uses EBCC_BENCH_ENTROPY).
    cab_cr = cab_encode_pts = None
    if _on("EBCC_BENCH_CAB") and config.entropy_backend != "cab":
        cab_cfg = cfg(entropy_backend="cab")
        with log.section("cab_host"):
            cblob = encode_chunked(data, cab_cfg, device=dev)
            ct0 = time.perf_counter()
            cblob = encode_chunked(data, cab_cfg, device=dev)
            cab_encode_pts = n_points / (time.perf_counter() - ct0)
            cout = decode_chunked(cblob, device=dev)
            cab_err = float(np.abs(cout - data).max())
            _check(cab_err <= bound, ("cab", cab_err, bound))
            cab_cr = data.nbytes / len(cblob)

    # Device-compute proxy (max mode only, as in bench.py): on a host whose
    # link is fast the roundtrip approaches this rate.
    device_compute_pts = None
    if error_mode == "max":
        nb = min(8, n)
        chain_reps = 4
        xc = x_dev[:nb]
        with log.section("proxy"):
            _proxy_chain(xc, error, h, w, chain_reps)       # warm-up
            _sync(dev)
            tc0 = time.perf_counter()
            mx = _proxy_chain(xc, error, h, w, chain_reps)
            dtc = time.perf_counter() - tc0
        _check(mx <= bound * 1.01, ("proxy", mx, bound))
        device_compute_pts = nb * h * w * chain_reps / dtc

    # Temporal (closed-loop predictive) against intra CR on the leading 8
    # frames: one multi-frame chunk, each frame after the first coded as a
    # bounded delta against the previous reconstruction.
    temporal_cr = temporal_intra_cr = None
    if error_mode == "max" and _on("EBCC_BENCH_TEMPORAL"):
        tdata = np.ascontiguousarray(data[:min(8, n)])
        tcfg = cfg(dims=tdata.shape, chunk=tdata.shape,
                   residual_mode=RESIDUAL_MAX_ERROR, temporal=True)
        icfg = cfg(dims=tdata.shape, residual_mode=RESIDUAL_MAX_ERROR)
        with log.section("temporal"):
            tblob = encode_chunked(tdata, tcfg, device=dev)
            tout = decode_chunked(tblob, device=dev)
            terr = float(np.abs(tout - tdata).max())
            _check(terr <= error, ("temporal", terr, error))
            temporal_cr = tdata.nbytes / len(tblob)
            temporal_intra_cr = tdata.nbytes / len(
                encode_chunked(tdata, icfg, device=dev))

    # Lossless (bit-exact, host coder): ratio and throughput.
    lossless_cr = lossless_pts = None
    if _on("EBCC_BENCH_LOSSLESS"):
        ldata = np.ascontiguousarray(data[:min(8, n)])
        lcfg = CodecConfig(dims=ldata.shape, residual_mode=RESIDUAL_LOSSLESS,
                           chunk_dims=(1, h, w),
                           zstd_level=config.zstd_level)
        with log.section("lossless"):
            lblob = encode_chunked(ldata, lcfg, device=dev)     # warm-up
            lt0 = time.perf_counter()
            lblob = encode_chunked(ldata, lcfg, device=dev)
            lout = decode_chunked(lblob, device=dev)
            dt = time.perf_counter() - lt0
        _check(np.array_equal(lout.view(np.uint32), ldata.view(np.uint32)),
               "lossless roundtrip is not bit-exact")
        lossless_cr = ldata.nbytes / len(lblob)
        lossless_pts = ldata.size / dt

    # The port's serial host codec on one frame (the stand-in for the
    # reference's serial C codec), then the host codec on every frame
    # through native routing: the CPU-only deployment's rate.
    with log.section("native"):
        native.load_codec()                     # its build, untimed
        one = np.ascontiguousarray(data[:1])
        ncfg = CodecConfig(dims=one.shape, base_cr=30,
                           residual_mode=RESIDUAL_MAX_ERROR, error=error)
        tn = time.perf_counter()
        nblob = native.native_encode(one, ncfg)
        native.native_decode(nblob)
        native_pts = one.size / (time.perf_counter() - tn)
        saved = {k: os.environ.get(k) for k in ("EBCC_ENCODE_BACKEND",
                                                "EBCC_DECODE_BACKEND")}
        os.environ.update(EBCC_ENCODE_BACKEND="native",
                          EBCC_DECODE_BACKEND="native")
        try:
            tn = time.perf_counter()
            nblob = encode_chunked(data, config, device=dev)
            nout = decode_chunked(nblob, device=dev)
            native_host_pts = n_points / (time.perf_counter() - tn)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        nerr = float(np.abs(nout - data).max())
        _check(nerr <= bound, ("native routing", nerr, bound))

    # Second headline window: the same estimator, sampled again after the
    # extras; the global best and the median of the windows' bests.
    with log.section("window2"):
        window2 = []
        for _ in range(max(2, reps // 2)):
            rt0 = time.perf_counter()
            streams, maxerr = roundtrip()
            window2.append(time.perf_counter() - rt0)
            _check(maxerr <= bound, ("window2", maxerr, bound))
    window_minima.append(min(window2))
    dev_t += window2

    # Dual point: zstd level 9 through the same timed path.
    dual_pts = dual_cr = None
    if error_mode == "max" and _on("EBCC_BENCH_DUAL"):
        dcfg = cfg(zstd_level=9)
        dual_t = []
        with log.section("dual"):
            for _ in range(max(2, reps // 2)):
                dt0 = time.perf_counter()
                dstreams, derr = roundtrip(dcfg)
                dual_t.append(time.perf_counter() - dt0)
                _check(derr <= bound, ("dual", derr, bound))
        dual_pts = n_points / min(dual_t)
        dual_cr = data.nbytes / sum(len(s) for s in dstreams)

    # CAB points: backends 2 (strict) and 4 (relaxed CAB2) through the same
    # timed path.
    cab_point = {}
    if error_mode == "max" and _on("EBCC_BENCH_CAB_POINT"):
        for be_name in ("cab", "cab2"):
            ccfg = cfg(entropy_backend=be_name)
            cab_t = []
            with log.section(f"{be_name}_point"):
                cstreams, cerr = roundtrip(ccfg)     # warm-up
                for _ in range(max(3, reps // 2)):
                    ct0 = time.perf_counter()
                    cstreams, cerr = roundtrip(ccfg)
                    cab_t.append(time.perf_counter() - ct0)
                    _check(cerr <= bound, (be_name, cerr, bound))
            cab_point[be_name] = (n_points / min(cab_t), data.nbytes / sum(
                len(s) for s in cstreams))
    cab_point_pts, cab_point_cr = cab_point.get("cab", (None, None))
    cab2_point_pts, cab2_point_cr = cab_point.get("cab2", (None, None))

    # The reference's own codec at this operating point, one frame.
    ref_binary_pts = ref_binary_cr = ref_binary_maxerr = None
    if error_mode == "max" and _on("EBCC_BENCH_REF"):
        try:
            reference_bin.load()
        except reference_bin.ReferenceUnavailable as e:
            print(f"reference binary unavailable: ReferenceUnavailable({e})",
                  file=sys.stderr)
        else:
            one = np.ascontiguousarray(data[0])
            rb_t0 = time.perf_counter()
            rblob = reference_bin.encode(one, 30.0, 1, error)
            rdec = reference_bin.decode(rblob).reshape(h, w)
            rb_dt = time.perf_counter() - rb_t0
            ref_binary_pts = one.size / rb_dt
            ref_binary_cr = one.nbytes / len(rblob)
            # The reference adjusts min/max after verifying the bound and
            # may overshoot slightly: reported, not asserted.
            ref_binary_maxerr = float(np.abs(rdec - one).max())

    dev_pts_per_s = n_points / min(dev_t)
    median_window_pts = n_points / float(np.median(window_minima))
    # All the points over all the time of both windows: unlike the best-of
    # estimators above, a stall in a window moves it.  Stderr only, so the
    # JSON line keeps bench.py's fields.
    print(f"headline over all {len(dev_t)} timed runs: "
          f"{n_points * len(dev_t) / sum(dev_t):.1f} points/s",
          file=sys.stderr)

    result = {
        "metric": "device-resident encode+decode throughput @ max_error bound",
        "value": round(dev_pts_per_s, 1),
        "unit": "grid-points/s",
        "vs_baseline": round(dev_pts_per_s / BASELINE_PTS_PER_S, 2),
        "vs_measured_serial": round(dev_pts_per_s / native_pts, 2),
        "compression_ratio": round(cr, 2),
        "compression_ratio_cab": _r(cab_cr, 2),
        "cab_host_encode_pts_per_s": _r(cab_encode_pts, 1),
        "compression_ratio_device_streams": round(
            data.nbytes / blob_bytes, 2),
        "max_error": maxerr,
        "error_target": error,
        "device_compute_pts_per_s": _r(device_compute_pts, 1),
        "link_bytes_up_per_point": round(link_up_bpp, 4),
        "link_bytes_down_per_point": round(link_down_bpp, 4),
        "host_roundtrip_pts_per_s": round(host_pts_per_s, 1),
        "host_encode_pts_per_s": round(host_encode_pts, 1),
        "host_decode_pts_per_s": round(host_decode_pts, 1),
        "median_window_pts_per_s": round(median_window_pts, 1),
        "dual_point_pts_per_s": _r(dual_pts, 1),
        "dual_point_vs_baseline": _r(
            None if dual_pts is None else dual_pts / BASELINE_PTS_PER_S, 2),
        "dual_point_compression_ratio": _r(dual_cr, 2),
        "cab_point_pts_per_s": _r(cab_point_pts, 1),
        "cab_point_vs_baseline": _r(
            None if cab_point_pts is None
            else cab_point_pts / BASELINE_PTS_PER_S, 2),
        "cab_point_compression_ratio": _r(cab_point_cr, 2),
        "cab2_point_pts_per_s": _r(cab2_point_pts, 1),
        "cab2_point_vs_baseline": _r(
            None if cab2_point_pts is None
            else cab2_point_pts / BASELINE_PTS_PER_S, 2),
        "cab2_point_compression_ratio": _r(cab2_point_cr, 2),
        "ref_binary_pts_per_s": _r(ref_binary_pts, 1),
        "ref_binary_cr": _r(ref_binary_cr, 2),
        "ref_binary_max_error": ref_binary_maxerr,
        "link_up_MBps": round(up, 1),
        "link_down_MBps": round(down, 1),
        "temporal_compression_ratio": _r(temporal_cr, 2),
        "lossless_compression_ratio": _r(lossless_cr, 2),
        "lossless_roundtrip_pts_per_s": _r(lossless_pts, 1),
        "temporal_intra_compression_ratio": _r(temporal_intra_cr, 2),
        "native_serial_pts_per_s": round(native_pts, 1),
        "native_host_roundtrip_pts_per_s": round(native_host_pts, 1),
        "frames": n,
        "device": device_line(dev),
        # The ratios against the reference binary's rate and CR measured
        # in this run, and the highest-ratio point that meets both
        # baseline targets (>= 50x the baseline rate, CR >= the
        # reference's): None without the reference.
        "vs_ref_binary": None,
        "cab_point_vs_ref_binary": None,
        "cab_point_cr_vs_ref": None,
        "baseline_point_backend": None,
        "baseline_point_pts_per_s": None,
        "baseline_point_compression_ratio": None,
    }
    if ref_binary_pts:
        result["vs_ref_binary"] = round(dev_pts_per_s / ref_binary_pts, 2)
        if cab_point_pts is not None:
            result["cab_point_vs_ref_binary"] = round(
                cab_point_pts / ref_binary_pts, 2)
        if cab_point_cr is not None and ref_binary_cr:
            result["cab_point_cr_vs_ref"] = round(
                cab_point_cr / ref_binary_cr, 3)
    if ref_binary_cr:
        candidates = [
            ("zstd-%d" % config.zstd_level, dev_pts_per_s,
             data.nbytes / blob_bytes),
            ("zstd-9", dual_pts, dual_cr),
            ("cab", cab_point_pts, cab_point_cr),
            ("cab2", cab2_point_pts, cab2_point_cr),
        ]
        best = None
        for name, pts_c, cr_c in candidates:
            if pts_c is None or cr_c is None:
                continue
            if (pts_c >= 50 * BASELINE_PTS_PER_S and cr_c >= ref_binary_cr
                    and (best is None or cr_c > best[2])):
                best = (name, pts_c, cr_c)
        if best:
            result["baseline_point_backend"] = best[0]
            result["baseline_point_pts_per_s"] = round(best[1], 1)
            result["baseline_point_compression_ratio"] = round(best[2], 2)
    # Every reported rate and ratio must be finite and positive: a timer
    # fault fails the bench instead of publishing a negative rate.
    for k, v in result.items():
        if isinstance(v, (int, float)) and (
                "pts_per_s" in k or "ratio" in k or "MBps" in k
                or k in ("value", "vs_baseline", "vs_measured_serial")):
            _check(np.isfinite(v) and v > 0, (k, v))
    if launches is not None:
        launches.update(log.by_section)
    return result


def main() -> int:
    """The bench on the card at 721x1440, settings from the environment;
    prints its JSON line."""
    result = run(device="cuda")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
