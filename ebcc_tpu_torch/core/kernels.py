"""Batched device programs of the codec, in PyTorch.

Counterpart of ``ebcc_tpu/core/kernels.py`` (``_coarse_fine_search``
:63-131, ``encode_batch``/``_encode_core`` :139-158 and :195-845 in their
batched formulation, with relative targets, the fused curve sweep and
``return_internal``, ``encode_batch_temporal`` :853-1121,
``encode_batch_rate_only`` :1126-1173, ``decode_batch_sparse`` :1181-1214
(the index upload), the blocked-Rice upload's ``rice_unpack_qflat`` and
``decode_from_qflat_program`` :1419-1497, ``temporal_accumulate``
:1501-1520 and ``_decode_from_qflat`` :1523-1544).  Every step keeps the
reference's arithmetic and decisions; what changes is the idiom:

  * PyTorch runs eagerly, so there is no ``jit``: each ``lax.map`` over
    candidate cuts is a Python loop of kernel launches, and each
    ``lax.cond`` is a host-side branch on one small device-to-host read.
    On a CUDA tensor the encode core's launches between those branches are
    captured once into CUDA graphs and replayed (``core/graphs.py``).
  * The transforms go through the hand-written kernels of
    ``ops.dwt_hopper`` on a CUDA tensor (their plain versions on a CPU
    tensor).  Frames never share a kernel block and every other operation
    is elementwise or a per-chunk max/min/count (exact) or a float64 mean,
    so a chunk's results do not depend on the batch it rides in: the port
    needs no counterpart of the reference's per-chunk ``lax.map`` under
    ``det`` or of ``codec._pad_min_batch``.  The temporal encode is
    likewise one batched formulation; its ``lax.scan`` over frames is a
    Python loop carrying the reconstruction.
  * The blocked-Rice upload's ``lax.scan`` over 128 steps and its scatter
    are one hand-written kernel on the card (X1,
    ``ops.exchange_hopper.rice_unpack_qflat``).
  * The blocked-Rice upload's int32 and float32 sections are views of its
    uint8 buffer (a copy where a section does not start on its element
    size), in place of ``lax.bitcast_convert_type``.

Every encode program returns, beside its small outputs, ``vals_comb`` (the
flat signed kept values of its layers), ``sig_comb`` (their packed
significance, one bitmap per layer) and ``exchange_nnz`` (their count), the
inputs of the exchange of ``core/transfer.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from ..config import (BASE_NUM_PLANES, BASE_REFINE_ITERS, DELTA_NUM_PLANES,
                      RES_NUM_PLANES, RES_REFINE_RATIOS, RES_SCALE_STEPS)
from ..device import constant
from ..ops import bitplane, dwt, dwt_hopper, exchange_hopper, metrics
from . import graphs, transfer

BASE_SCALE = 65535.0
RES_SCALE = 255.0

# Normative inter-decoder divergence allowance (docs/FORMAT.md "Decoder
# conformance"); the reference's value (ebcc_tpu/core/kernels.py:60).
DECODER_EPS_REL = 4e-6


def _b4(v):
    """(B,) -> (B, 1, 1, 1) for broadcasting against frame batches."""
    return v[:, None, None, None]


def _take(arr, idx):
    """arr[idx[j], j] for a (K, B) arr and a (B,) index vector."""
    return arr.gather(0, idx.long()[None])[0]


def _coarse_fine_search(q, num_planes, levels, metrics_fn, criteria,
                        step: int = 3, curve_fn=None):
    """Coarse-to-fine cut search (reference ``_coarse_fine_search``):
    evaluate the strided coarse grid of cuts (descending, ending at 0),
    then refine ``step - 1`` finer candidates above each criterion's
    coarsest feasible coarse cut.

    metrics_fn(spatial, cut_vec) -> tuple of (B,) metrics; criteria: fns of
    that tuple (stacked or single) -> feasibility.  curve_fn (optional):
    fn(cut grid tuple) -> the stacked metric tuple of the whole coarse grid
    from one fused pass (K3, ``dwt_hopper.curve_stats``), in place of one
    K2 evaluation per coarse cut; refinements keep the per-cut path.
    Returns ``(per_criterion, coarse, coarse_cuts)`` as the reference does.
    """
    b = q.shape[0]
    dev = q.device
    cc = np.arange(num_planes - 1, -1, -step, dtype=np.int32)
    if cc[-1] != 0:
        cc = np.append(cc, np.int32(0))
    cc_dev = constant(cc.tolist(), torch.int32, dev)

    def eval_vec(cut_vec):
        spatial = dwt_hopper.idwt2d_dequant(q, cut_vec, levels)
        return metrics_fn(spatial, cut_vec)

    if curve_fn is not None:
        coarse = curve_fn(tuple(int(c) for c in cc))
    else:
        rows = [eval_vec(torch.full((b,), int(c), dtype=torch.int32,
                                    device=dev)) for c in cc]
        coarse = tuple(torch.stack(m) for m in zip(*rows))

    out = []
    for crit in criteria:
        feas_c = crit(coarse)                      # (n_coarse, B)
        any_f = feas_c.any(dim=0)
        # Coarsest feasible row; none feasible -> the last row (cut 0).
        first = torch.where(any_f, feas_c.to(torch.int32).argmax(dim=0),
                            len(cc) - 1)
        k_c = cc_dev[first]
        chosen_cut = k_c
        chosen_m = tuple(_take(m, first) for m in coarse)
        for i in range(1, step):
            cut_i = torch.clamp(k_c + i, max=num_planes - 1)
            m_i = eval_vec(cut_i)
            feas_i = crit(m_i) & (k_c + i <= num_planes - 1) & any_f
            chosen_cut = torch.where(feas_i, cut_i, chosen_cut)
            chosen_m = tuple(torch.where(feas_i, mi, mc)
                             for mi, mc in zip(m_i, chosen_m))
        out.append((chosen_cut.to(torch.int32), any_f, chosen_m))
    return out, coarse, cc


@dataclasses.dataclass(frozen=True)
class _CoreSettings:
    """What the encode core bakes in beside its batch's shape: the float32
    values of the targets (``error_target`` may instead be a (B,) tensor
    of absolute per-chunk targets, the temporal encode's frame 0), the
    levels, the modes and the ``EBCC_FUSED_CURVE`` reading."""
    error_target: object
    bq_target: float
    base_levels: int
    res_levels: int
    relative_mode: bool
    use_centered: bool
    use_curve: bool
    return_internal: bool = False


def _settings(error_target, base_quantile_target, *, base_levels, res_levels,
              relative_mode, use_centered, return_internal=False):
    if not isinstance(error_target, torch.Tensor):
        error_target = float(np.float32(error_target))
    return _CoreSettings(
        error_target, float(np.float32(base_quantile_target)), base_levels,
        res_levels, relative_mode, use_centered,
        os.environ.get("EBCC_FUSED_CURVE", "0") == "1", return_internal)


def encode_batch(x, error_target: float, base_quantile_target: float, *,
                 base_levels: int = 5, res_levels: int = 3,
                 relative_mode: bool = False, use_centered: bool = True):
    """Full batched error-bounded encode of ``x`` (B, D0, H, W) float32:
    ``error_target`` is absolute, or a fraction of each chunk's range with
    ``relative_mode``.  Returns a dict of device tensors (the reference's
    ``small`` keys plus ``vals_comb``, ``sig_comb`` and ``exchange_nnz``
    of both layers); stream assembly happens on the host (``core.codec``).

    ``EBCC_FUSED_CURVE=1`` (read at each call, as the reference reads it)
    runs each coarse cut sweep as one K3 pass instead of one K2 evaluation
    per cut.

    A CUDA tensor's core runs as CUDA graphs captured once per key
    (:func:`graph_key`) and replayed for every later batch of it
    (``core/graphs.py``); a CPU tensor's runs eagerly.  The same kernels
    run in the same order on the same values either way."""
    c = _settings(error_target, base_quantile_target,
                  base_levels=base_levels, res_levels=res_levels,
                  relative_mode=relative_mode, use_centered=use_centered)
    chain = functools.partial(_encode_chain, c)
    if x.device.type == "cuda":
        return graphs.run(graph_key(x, c), x, chain)
    return chain({"x": x}, _eager)


def graph_key(x, c: _CoreSettings) -> tuple:
    """Everything a captured core bakes in: the device, the batch's shape
    and dtype, and the settings."""
    return (x.device, tuple(x.shape), x.dtype, c)


def _eager(name, fn, st):
    return fn(st)


def _encode_chain(c: _CoreSettings, st: dict, seg) -> dict:
    """The encode core as four segments between its two host branches:
    the head (range, K1, the base search and reconstruction, the residual
    range), the residual sweep or its trivial form (each with the overflow
    and refinable flags), the base-scale bisection where a chunk can take
    it, and the outputs.  ``st`` holds ``x`` (and, from the temporal
    encode, ``minval`` and ``maxval``); ``seg(name, fn, st)`` runs one
    segment, ``fn(st)`` -> the dict of its new tensors (eagerly, or as a
    CUDA graph in ``core/graphs.py``)."""
    def run(name, fn):
        st.update(seg(name, functools.partial(fn, c), st))

    run("head", _core_head)
    # When every chunk's base layer already meets the bound the sweep is
    # dead work (the reference's lax.cond at :530-532).
    if bool(st["skip_residual"].all()):
        run("trivial", _core_trivial)
    else:
        run("sweep", _core_sweep)
    # Host-side branch in place of the reference's lax.cond at :649-651:
    # with no refinable chunk no candidate could be adopted.
    if bool(st["refinable"].any()):
        run("refine", _core_refine)
    return seg("outputs", functools.partial(_core_outputs, c), st)


def _exchange_outputs(layers) -> dict:
    """``vals_comb``, ``sig_comb`` and ``exchange_nnz`` of the kept-value
    layers (each (B, D0, Hp, Wp) int32), in layer order."""
    vals_comb = torch.cat([v.reshape(-1) for v in layers])
    return {"vals_comb": vals_comb,
            "sig_comb": torch.stack([transfer.pack_bitmap(v != 0)
                                     for v in layers]),
            "exchange_nnz": (vals_comb != 0).sum().to(torch.int32)}


def _encode_core(x, minval, maxval, error_target, base_quantile_target, *,
                 base_levels, res_levels, relative_mode, use_centered,
                 return_internal: bool = False):
    """The core, eagerly.  ``error_target``: a scalar, or a (B,) tensor of
    absolute per-chunk targets (the temporal encode's frame 0).
    ``return_internal`` (reference :781-827) returns, in place of
    ``vals_comb``, the kept values ``_vb`` and ``_vr`` and ``_recon``, the
    reconstruction a decoder will make of the candidate the device picks
    (skip-residual: base at base_cut; residual feasible: base + residual;
    else pure base at pure_cut), with the decoder's arithmetic."""
    c = _settings(error_target, base_quantile_target,
                  base_levels=base_levels, res_levels=res_levels,
                  relative_mode=relative_mode, use_centered=use_centered,
                  return_internal=return_internal)
    return _encode_chain(c, {"x": x, "minval": minval, "maxval": maxval},
                         _eager)


def _combine(stats, n_pts: int, use_centered: bool):
    """K3's per-frame rows -> the metric tuple of the per-cut path.  Max,
    min and count are exact; the sum is float64 and divided once, as
    metrics.batch_mean does, so the mean matches it up to a double-rounding
    tie.  The max error is exact too: rounding is monotone, so
    max|err - m| = max(mx - m, m - mn)."""
    s = stats[..., 0].sum(-1)
    mx = stats[..., 1].amax(-1).to(torch.float32)
    mn = stats[..., 2].amin(-1).to(torch.float32)
    bad = stats[..., 3].sum(-1).to(torch.float32)
    m = (s / n_pts).to(torch.float32)
    maxe = (torch.maximum(mx - m, m - mn) if use_centered
            else torch.maximum(mx, -mn))
    # The float32 steps of metrics.error_quantile on an exact count.
    return maxe, 1.0 - bad / n_pts, m


def _core_head(c: _CoreSettings, st: dict) -> dict:
    """Range, K1, the base search, the base reconstruction at the chosen
    cut, ``skip_residual`` and the residual's range."""
    x = st["x"]
    b, d0, h, w = x.shape
    mult = 1 << max(c.base_levels, c.res_levels)
    minval, maxval = ((st["minval"], st["maxval"]) if "minval" in st
                      else metrics.minmax(x))

    # ---- per-chunk range & const detection ----
    const = minval == maxval
    rng = torch.where(const, 1.0, maxval - minval)
    # Absolute target per chunk (reference :206-208, REL->ABS).
    if isinstance(c.error_target, torch.Tensor):
        target = c.error_target
    else:
        target = ((maxval - minval) * c.error_target if c.relative_mode
                  else torch.full_like(minval, c.error_target))
    # Feasibility is verified at target minus the decoder allowance, unless
    # that would eat more than half the target (reference :217-220).
    base_t = torch.clamp(target, min=0.0)
    eps_d = DECODER_EPS_REL * (maxval - minval)
    target = torch.where(base_t - eps_d >= 0.5 * target, base_t - eps_d,
                         base_t)

    u = (x - _b4(minval)) / _b4(rng) * BASE_SCALE
    up, orig_hw = dwt.pad_to_multiple(u, mult)

    # ---- base layer transform + quantize (K1) ----
    qbase = dwt_hopper.dwt2d_quantize(up.contiguous(), c.base_levels)

    scale_back = _b4(rng) / BASE_SCALE
    off = _b4(minval)

    def base_metrics(rec_spatial, cut):
        recon = dwt.unpad(rec_spatial, orig_hw) * scale_back + off
        maxe_c, m = metrics.centered_max_abs_error(x, recon)
        maxe = maxe_c if c.use_centered else metrics.max_abs_error(x, recon)
        qt = metrics.error_quantile(x, recon, target)
        return maxe, qt, m

    # Fused curve sweep (reference :260-294): K3's per-frame rows combine
    # into the metric tuples of the per-cut path.
    base_curve = None
    if c.use_curve:
        xpad = dwt.pad_to_multiple(x, mult)[0].contiguous()
        scale_v = rng / BASE_SCALE

        def base_curve(cut_grid):
            return _combine(dwt_hopper.curve_stats(
                qbase, xpad, scale_v, minval, target, levels=c.base_levels,
                cut_grid=cut_grid, valid_hw=orig_hw), d0 * h * w,
                c.use_centered)

    # Two criteria share one coarse sweep: the quantile target and the full
    # bound (pure-base candidate).
    bq_target = c.bq_target
    [(base_cut, _, base_m), (pure_cut, pure_feasible, pure_m)], \
        base_coarse, _cc = _coarse_fine_search(
            qbase, BASE_NUM_PLANES, c.base_levels, base_metrics,
            [lambda m: m[1] >= bq_target, lambda m: m[0] <= target],
            curve_fn=base_curve)

    hp, wp = qbase.shape[-2], qbase.shape[-1]
    base_sizes = bitplane.estimated_code_bytes(
        qbase.reshape(b, d0 * hp, wp), BASE_NUM_PLANES)

    # ---- base reconstruction at the chosen cut ----
    base_spatial = dwt_hopper.idwt2d_dequant(qbase, base_cut, c.base_levels)
    base_recon = dwt.unpad(base_spatial, orig_hw) * scale_back + off
    residual = x - base_recon
    base_maxerr = metrics.max_abs_error(x, base_recon)
    skip_residual = base_maxerr <= target

    # ---- the residual's range ----
    rmin = residual.amin(dim=(1, 2, 3))
    rmax = residual.amax(dim=(1, 2, 3))
    rrng = torch.where(rmax > rmin, rmax - rmin, 1.0)
    return {"minval": minval, "maxval": maxval, "const": const, "rng": rng,
            "target": target, "qbase": qbase, "off": off,
            "base_cut": base_cut, "base_m0": base_m[0],
            "base_m2": base_m[2], "pure_cut": pure_cut,
            "pure_feasible": pure_feasible, "pure_m0": pure_m[0],
            "pure_m2": pure_m[2], "base_quantiles": base_coarse[1],
            "base_sizes": base_sizes, "base_recon": base_recon,
            "residual": residual, "base_maxerr": base_maxerr,
            "skip_residual": skip_residual, "rmin": rmin, "rrng": rrng}


def _residual_flags(st: dict, res: dict) -> dict:
    """The tail of both residual segments: ``overflow`` and the chunks the
    base-scale bisection may refine."""
    qbase, qres = st["qbase"], res["qres"]
    skip_residual = st["skip_residual"]
    overflow = ((qbase.abs().amax(dim=(1, 2, 3)) >= (1 << BASE_NUM_PLANES))
                | (qres.abs().amax(dim=(1, 2, 3)) >= (1 << RES_NUM_PLANES)))
    ship_pure_only = (~skip_residual) & (~res["res_feasible"])
    refinable = (skip_residual | ship_pure_only) & (~st["const"])
    return {**res, "overflow": overflow, "ship_pure_only": ship_pure_only,
            "refinable": refinable}


def _core_sweep(c: _CoreSettings, st: dict) -> dict:
    """The residual layer with the fractional-scale sweep and the
    post-selection refinement."""
    x, residual, target = st["x"], st["residual"], st["target"]
    base_recon, rmin, rrng = st["base_recon"], st["rmin"], st["rrng"]
    b, d0, h, w = x.shape
    mult = 1 << max(c.base_levels, c.res_levels)
    orig_hw = (h, w)
    res_levels = c.res_levels
    res_off = _b4(rmin)

    rn = (residual - res_off) / _b4(rrng) * RES_SCALE
    rnp_, _ = dwt.pad_to_multiple(rn, mult)
    yres = dwt_hopper.dwt2d_transform(rnp_.contiguous(), res_levels)
    hp, wp = yres.shape[-2], yres.shape[-1]
    res_pad = (dwt.pad_to_multiple(residual, mult)[0].contiguous()
               if c.use_curve else None)
    maxe_l, mean_l, cut_l, feas_l, est_l, rmax_adj_l, qres_l = (
        [], [], [], [], [], [], [])
    for f in RES_SCALE_STEPS:
        q_f = bitplane.quantize_floor(yres * f)
        qres_l.append(q_f)
        # Mirror the decoder: it reads the stored f32 rmax_adj and
        # computes (rmax_adj - rmin) / RES_SCALE.
        rmax_adj = rmin + rrng / f
        sb = _b4(rmax_adj - rmin) / RES_SCALE
        rmax_adj_l.append(rmax_adj)

        def res_metrics(rec_spatial, cut, sb=sb):
            recon = base_recon + (dwt.unpad(rec_spatial, orig_hw) * sb
                                  + res_off)
            maxe_c, m = metrics.centered_max_abs_error(x, recon)
            maxe = (maxe_c if c.use_centered
                    else metrics.max_abs_error(x, recon))
            return maxe, m

        res_curve = None
        if c.use_curve:
            # The reference's formulation (:373-390): the residual is
            # the target frame, err = res - (rec * sb + rmin), which can
            # differ from res_metrics' x - (base_recon + ...) in the
            # last ulp.
            sb_v = (rmax_adj - rmin) / RES_SCALE

            def res_curve(cut_grid, q_f=q_f, sb_v=sb_v):
                maxe, _q, m = _combine(dwt_hopper.curve_stats(
                    q_f, res_pad, sb_v, rmin, target, levels=res_levels,
                    cut_grid=cut_grid, valid_hw=orig_hw), d0 * h * w,
                    c.use_centered)
                return maxe, m

        [(cut_f, feas_f, (maxe_f, mean_f))], _, _ = _coarse_fine_search(
            q_f, RES_NUM_PLANES, res_levels, res_metrics,
            [lambda m: m[0] <= target], curve_fn=res_curve)
        est_f = bitplane.estimated_code_bytes(
            q_f.reshape(b, d0 * hp, wp), RES_NUM_PLANES)
        maxe_l.append(maxe_f)
        mean_l.append(mean_f)
        est_l.append(_take(est_f, cut_f))
        cut_l.append(cut_f)
        feas_l.append(feas_f)

    res_maxe_f = torch.stack(maxe_l)      # (Nf, B) at each f's cut
    res_mean_f = torch.stack(mean_l)
    res_cut_f = torch.stack(cut_l)
    res_feas_f = torch.stack(feas_l)
    res_est_f = torch.stack(est_l)
    rmax_adj_f = torch.stack(rmax_adj_l)

    # Among feasible scales pick the smallest estimated coded size.
    f_idx = torch.where(res_feas_f, res_est_f, 3.4e38).argmin(dim=0)
    sel = lambda arr: _take(arr, f_idx)
    ar = torch.arange(b, device=x.device)
    best_q = torch.stack(qres_l)[f_idx, ar]
    del qres_l

    # ---- post-selection scale refinement (reference :417-519) ----
    f_grid = constant(RES_SCALE_STEPS, torch.float32, x.device)
    f_sel = f_grid[f_idx]
    cut_sel = sel(res_cut_f).to(torch.int32)
    any_feas = res_feas_f.any(dim=0)
    best_maxe, best_mean = sel(res_maxe_f), sel(res_mean_f)
    best_rmax, best_est = sel(rmax_adj_f), sel(res_est_f)
    adopted = torch.zeros((b,), dtype=torch.bool, device=x.device)
    for r in RES_REFINE_RATIOS:                  # coarsest first
        f_r = f_sel / r
        q_r = bitplane.quantize_floor(yres * _b4(f_r))
        rmax_r = rmin + rrng / f_r
        sb_r = _b4(rmax_r - rmin) / RES_SCALE
        spatial_r = dwt_hopper.idwt2d_dequant(q_r, cut_sel, res_levels)
        recon_r = base_recon + (dwt.unpad(spatial_r, orig_hw) * sb_r
                                + res_off)
        maxe_c_r, mean_r = metrics.centered_max_abs_error(x, recon_r)
        maxe_r = (maxe_c_r if c.use_centered
                  else metrics.max_abs_error(x, recon_r))
        feas_r = (maxe_r <= target) & any_feas & ~adopted
        est_tab = bitplane.estimated_code_bytes(
            q_r.reshape(b, d0 * hp, wp), RES_NUM_PLANES)
        est_r = _take(est_tab, cut_sel)
        best_q = torch.where(_b4(feas_r), q_r, best_q)
        best_maxe = torch.where(feas_r, maxe_r, best_maxe)
        best_mean = torch.where(feas_r, mean_r, best_mean)
        best_rmax = torch.where(feas_r, rmax_r, best_rmax)
        best_est = torch.where(feas_r, est_r, best_est)
        adopted |= feas_r
    return _residual_flags(st, {
        "res_cut": cut_sel, "res_feasible": any_feas,
        "res_maxerr": best_maxe, "res_mean": best_mean, "rmax": best_rmax,
        "res_sizes": best_est, "qres": best_q})


def _core_trivial(c: _CoreSettings, st: dict) -> dict:
    """The residual layer of a batch whose every chunk skips it."""
    qbase = st["qbase"]
    b = qbase.shape[0]
    dev = qbase.device
    zero = torch.zeros((b,), dtype=torch.float32, device=dev)
    return _residual_flags(st, {
        "res_cut": torch.full((b,), RES_NUM_PLANES - 1, dtype=torch.int32,
                              device=dev),
        "res_feasible": torch.ones((b,), dtype=torch.bool, device=dev),
        "res_maxerr": zero, "res_mean": zero,
        "rmax": st["rmin"] + st["rrng"], "res_sizes": zero,
        "qres": torch.zeros(qbase.shape, dtype=torch.int32, device=dev)})


def _core_refine(c: _CoreSettings, st: dict) -> dict:
    """Base-scale bisection for base-only chunks (reference :538-691).
    Returns the shipped base layer under the head's names: ``qbase``,
    ``maxval``, ``base_maxerr`` and the base and pure metrics, each
    replaced where a chunk adopted a scale."""
    x, qbase, target = st["x"], st["qbase"], st["target"]
    minval, rng, off = st["minval"], st["rng"], st["off"]
    skip_residual, refinable = st["skip_residual"], st["refinable"]
    ship_pure_only = st["ship_pure_only"]
    b, d0, h, w = x.shape
    orig_hw = (h, w)
    qbase_ship = qbase
    maxval_ship = st["maxval"]
    base_maxerr_out = st["base_maxerr"]
    base_m0, base_m2 = st["base_m0"], st["base_m2"]
    pure_m0, pure_m2 = st["pure_m0"], st["pure_m2"]
    cut_ship_ref = torch.where(skip_residual, st["base_cut"], st["pure_cut"])
    cut4s = _b4(cut_ship_ref)
    vmag_f = (qbase.abs() >> cut4s).to(torch.float32)  # exact in f32
    sgn_neg = qbase < 0
    g_lo = torch.ones((b,), dtype=torch.float32, device=x.device)
    g_hi = torch.full((b,), 2.0, dtype=torch.float32, device=x.device)
    for _ in range(BASE_REFINE_ITERS):
        gf = 0.5 * (g_lo + g_hi)
        # 1/g and rng*g are rounded as separate steps (the reference
        # pins this with optimization_barrier, :600 and :608); eager
        # PyTorch runs and rounds each op on its own.
        inv_g = torch.reciprocal(gf)
        vmag_g = torch.floor((vmag_f + 0.5) * _b4(inv_g)).to(torch.int32)
        q_g = torch.where(sgn_neg, -(vmag_g << cut4s), vmag_g << cut4s)
        maxval_g = minval + rng * gf
        sb_g = _b4((maxval_g - minval) / BASE_SCALE)
        recon_g = (dwt.unpad(dwt_hopper.idwt2d_dequant(
            q_g, cut_ship_ref, c.base_levels), orig_hw) * sb_g + off)
        maxe_c_g, mean_g = metrics.centered_max_abs_error(x, recon_g)
        maxe_u_g = metrics.max_abs_error(x, recon_g)
        crit_pure = maxe_c_g if c.use_centered else maxe_u_g
        crit_g = torch.where(skip_residual, maxe_u_g, crit_pure)
        feas_g = (crit_g <= target) & refinable
        g_lo = torch.where(feas_g, gf, g_lo)
        g_hi = torch.where(feas_g, g_hi, gf)
        qbase_ship = torch.where(_b4(feas_g), q_g, qbase_ship)
        maxval_ship = torch.where(feas_g, maxval_g, maxval_ship)
        upd_b = feas_g & skip_residual
        base_maxerr_out = torch.where(upd_b, maxe_u_g, base_maxerr_out)
        base_m0 = torch.where(upd_b, crit_pure, base_m0)
        base_m2 = torch.where(upd_b, mean_g, base_m2)
        upd_p = feas_g & ship_pure_only
        pure_m0 = torch.where(upd_p, crit_pure, pure_m0)
        pure_m2 = torch.where(upd_p, mean_g, pure_m2)
    return {"qbase": qbase_ship, "maxval": maxval_ship,
            "base_maxerr": base_maxerr_out, "base_m0": base_m0,
            "base_m2": base_m2, "pure_m0": pure_m0, "pure_m2": pure_m2}


def _core_outputs(c: _CoreSettings, st: dict) -> dict:
    """The exchange values (reference :693-707) and the small outputs."""
    qbase_ship, qres = st["qbase"], st["qres"]
    skip_residual, res_feasible = st["skip_residual"], st["res_feasible"]
    base_cut, pure_cut, res_cut = (st["base_cut"], st["pure_cut"],
                                   st["res_cut"])
    # Base kept-values at the deepest cut any candidate can need; residual
    # kept-values at res_cut, zeroed for chunks without a residual layer.
    store_cut = torch.minimum(pure_cut, base_cut)
    pc = _b4(store_cut)
    magb = qbase_ship.abs()
    vb = torch.where(qbase_ship < 0, -(magb >> pc), magb >> pc)
    rc = _b4(res_cut)
    res_active = _b4((~skip_residual) & res_feasible)
    magr = qres.abs()
    vr = torch.where(qres < 0, -(magr >> rc), magr >> rc)
    vr = torch.where(res_active, vr, 0)

    small = {
        "minval": st["minval"], "maxval": st["maxval"],
        "const": st["const"], "overflow": st["overflow"],
        "target_abs": st["target"],
        "store_cut": store_cut,
        "base_cut": base_cut, "pure_cut": pure_cut,
        "pure_feasible": st["pure_feasible"],
        "base_est_sizes": st["base_sizes"],
        "base_quantiles": st["base_quantiles"],  # (n_coarse, B), coarse grid
        "pure_maxerr": st["pure_m0"],
        "pure_mean": st["pure_m2"],
        "skip_residual": skip_residual,
        "base_maxerr": st["base_maxerr"],
        "base_maxerr_centered": st["base_m0"],
        "base_mean": st["base_m2"],
        "rmin": st["rmin"], "rmax": st["rmax"],
        "res_cut": res_cut, "res_feasible": res_feasible,
        "res_maxerr": st["res_maxerr"],
        "res_mean": st["res_mean"],
        "res_est_size": st["res_sizes"],  # (B,) at the selected (scale, cut)
    }
    if not c.return_internal:
        small.update(_exchange_outputs((vb, vr)))
        return small

    # The shipped candidate as a decoder rebuilds it (_decode_from_qflat's
    # layer arithmetic; K2 masks at the cut, so the integers before the
    # shift to the kept values give the same spatial field).
    h, w = st["x"].shape[-2:]
    minval, rmin, rmax_out = st["minval"], st["rmin"], st["rmax"]
    cut_ship = torch.where((~skip_residual) & (~res_feasible), pure_cut,
                           base_cut)
    rng_ship = torch.where(st["const"], 1.0, st["maxval"] - minval)
    spat_b = dwt_hopper.idwt2d_dequant(qbase_ship, cut_ship, c.base_levels)
    recon_b = (dwt.unpad(spat_b, (h, w)) * _b4(rng_ship / BASE_SCALE)
               + st["off"])
    rrng_out = torch.where(rmax_out > rmin, rmax_out - rmin, 1.0)
    spat_r = dwt_hopper.idwt2d_dequant(qres, res_cut, c.res_levels)
    res_rec = (dwt.unpad(spat_r, (h, w)) * _b4(rrng_out / RES_SCALE)
               + _b4(rmin))
    small["_recon"] = recon_b + torch.where(res_active, res_rec, 0.0)
    small["_vb"] = vb
    small["_vr"] = vr
    return small


def encode_batch_rate_only(x, budget_bytes: int, *, base_levels: int = 5,
                           res_levels: int = 3):
    """Rate-targeted (RESIDUAL_NONE) encode of ``x`` (B, D0, H, W) float32
    (reference ``encode_batch_rate_only``): no error scans.  The host picks
    the cut from real compressed sizes, so the device makes the base
    layer's size estimates and ships its kept values at ``store_cut`` =
    the estimated cut minus 3, fine enough for the host's search and its
    partial-plane fill.

    The reference runs this transform in XLA and truncates it
    (``quantize_floor(dwt2d(u))``); the port runs it through K1, whose
    truncating store takes the float coefficients of the same kernel
    without it (``dwt2d_transform``), so the integers are the same and the
    float field is never written."""
    b, d0, h, w = x.shape
    mult = 1 << max(base_levels, res_levels)
    minval, maxval = metrics.minmax(x)
    const = minval == maxval
    rng = torch.where(const, 1.0, maxval - minval)
    u = (x - _b4(minval)) / _b4(rng) * BASE_SCALE
    up, _ = dwt.pad_to_multiple(u, mult)
    qbase = dwt_hopper.dwt2d_quantize(up.contiguous(), base_levels)
    hp, wp = qbase.shape[-2], qbase.shape[-1]
    sizes = bitplane.estimated_code_bytes(
        qbase.reshape(b, d0 * hp, wp), BASE_NUM_PLANES)      # (P+1, B)
    feasible = sizes <= float(np.float32(budget_bytes))
    est_cut = torch.where(feasible.any(dim=0),
                          feasible.to(torch.int32).argmax(dim=0),
                          BASE_NUM_PLANES).to(torch.int32)
    # 3-plane margin (reference :1156-1160): the estimate overshoots zstd's
    # plane bytes by up to ~2 cuts, and the partial fill needs one more.
    store_cut = torch.clamp(est_cut - 3, 0, BASE_NUM_PLANES - 1)
    sc4 = _b4(store_cut)
    mag = qbase.abs()
    vals = torch.where(qbase < 0, -(mag >> sc4), mag >> sc4)
    return {"minval": minval, "maxval": maxval, "const": const,
            "store_cut": store_cut, "base_est_sizes": sizes,
            **_exchange_outputs((vals,))}


def encode_batch_temporal(x, error_target: float,
                          base_quantile_target: float, *,
                          base_levels: int = 5, res_levels: int = 3,
                          relative_mode: bool = False,
                          return_carry: bool = False):
    """Closed-loop temporal encode of ``x`` (B, T, H, W) float32, T >= 2
    (reference ``encode_batch_temporal``): frame 0 is intra-coded by
    :func:`_encode_core`; every later frame is coded as an error-bounded
    delta against the previous frame's reconstruction, carried through a
    loop over the frames.  Prediction uses what a decoder will rebuild, so
    quantization error never accumulates and the bound holds on every
    frame.  A frame already within the bound ships as a skip (rmin = rmax =
    0, no payload).

    Deltas take the residual layer's machinery: a min/max normalization
    with an adaptive scale (``f_dyn``), the quantization-scale sweep over
    ``RES_SCALE_STEPS`` with a coarse-to-fine cut search each (K2 on
    ``DELTA_NUM_PLANES`` planes), the refinement over
    ``RES_REFINE_RATIOS``, the uncentered criterion.  Returns the frame-0
    outputs of :func:`_encode_core` with the whole chunk's ``const``,
    ``overflow`` and ``target_abs``, ``vals_comb`` (both layers of shape
    (B, T, Hp, Wp): frame 0's layers in slot 0, each delta in layer 1 at
    its frame) and the (B, T-1) per-delta ``t_rmin``, ``t_rmax``,
    ``t_cut``, ``t_skip``, ``t_feasible`` and ``t_maxerr``.
    ``return_carry`` adds ``_carry``, the (B, T, H, W) reconstructions the
    loop carried (for tests)."""
    b, t, h, w = x.shape
    mult = 1 << max(base_levels, res_levels)

    # The target derives from the chunk-global range in relative mode,
    # though frame 0's base layer is normalized by its own min/max.
    gmin, gmax = metrics.minmax(x)
    err = float(np.float32(error_target))
    target = ((gmax - gmin) * err if relative_mode
              else torch.full_like(gmin, err))
    # The decoder accumulates every delta into the carried frame, so the
    # inter-decoder allowance is budgeted 2 * T times (reference :895-903),
    # never more than half the target.  float32 product as the reference's.
    eps_scale = float(np.float32(2 * t) * np.float32(DECODER_EPS_REL))
    eps_t = eps_scale * (gmax - gmin)
    target = torch.where(target - eps_t >= 0.5 * target, target - eps_t,
                         target)

    x0 = x[:, :1]
    min0, max0 = metrics.minmax(x0)
    out0 = _encode_core(
        x0, min0, max0, target, base_quantile_target,
        base_levels=base_levels, res_levels=res_levels, relative_mode=False,
        use_centered=False, return_internal=True)
    recon = out0.pop("_recon")
    carry = [recon]
    steps = []
    for k in range(1, t):
        recon, st = _temporal_step(x[:, k:k + 1], recon, target, mult,
                                   res_levels)
        steps.append(st)
        if return_carry:
            carry.append(recon)

    vb0 = out0.pop("_vb")                      # (B, 1, Hp, Wp)
    vr0 = out0.pop("_vr")
    hp, wp = vb0.shape[-2:]
    layer0 = torch.cat([vb0, vb0.new_zeros((b, t - 1, hp, wp))], dim=1)
    layer1 = torch.cat([vr0] + [st["vr"] for st in steps], dim=1)
    out = dict(out0)
    out["const"] = gmin == gmax
    out["overflow"] = out0["overflow"] | torch.stack(
        [st["overflow"] for st in steps]).any(dim=0)
    out["target_abs"] = target
    out.update(_exchange_outputs((layer0, layer1)))
    for key in ("rmin", "rmax", "cut", "skip", "feasible", "maxerr"):
        out["t_" + key] = torch.stack([st[key] for st in steps], dim=1)
    if return_carry:
        out["_carry"] = torch.cat(carry, dim=1)
    return out


def _temporal_step(x_t, recon, target, mult: int, res_levels: int):
    """One frame of the temporal loop (the reference's scan body,
    :916-1089): -> (the next carried reconstruction, this frame's
    outputs)."""
    b = x_t.shape[0]
    r = x_t - recon
    skip = metrics.max_abs_error(x_t, recon) <= target
    rmin = r.amin(dim=(1, 2, 3))
    rmax = r.amax(dim=(1, 2, 3))
    rrng = torch.where(rmax > rmin, rmax - rmin, 1.0)
    rn = (r - _b4(rmin)) / _b4(rrng) * RES_SCALE
    rnp_, orig_hw = dwt.pad_to_multiple(rn, mult)
    yd = dwt_hopper.dwt2d_transform(rnp_.contiguous(), res_levels)
    hp_, wp_ = yd.shape[-2:]

    # Adaptive quantization scale: the finest step resolves the target
    # with ~4x margin; the 800 cap keeps |coeff| inside DELTA_NUM_PLANES.
    f_dyn = torch.clamp(
        4.0 * rrng / (RES_SCALE * torch.clamp(target, min=1e-30)),
        min=1.0, max=800.0)

    cut_l, feas_l, est_l, rmax_l, q_l = [], [], [], [], []
    for f in RES_SCALE_STEPS:
        fv = f_dyn * float(np.float32(f))
        q_f = bitplane.quantize_floor(yd * _b4(fv))
        rmax_adj = rmin + rrng / fv
        sb = torch.where(rmax_adj > rmin, rmax_adj - rmin, 1.0) / RES_SCALE

        def dmetrics(rec_spatial, cut, sb=sb):
            rec = dwt.unpad(rec_spatial, orig_hw) * _b4(sb) + _b4(rmin)
            return (metrics.max_abs_error(x_t, recon + rec),)

        [(cut_f, feas_f, _m)], _, _ = _coarse_fine_search(
            q_f, DELTA_NUM_PLANES, res_levels, dmetrics,
            [lambda m: m[0] <= target])
        est_f = bitplane.estimated_code_bytes(
            q_f.reshape(b, hp_, wp_), DELTA_NUM_PLANES)
        cut_l.append(cut_f)
        feas_l.append(feas_f)
        est_l.append(_take(est_f, cut_f))
        rmax_l.append(rmax_adj)
        q_l.append(q_f)

    feas_s = torch.stack(feas_l)
    f_idx = torch.where(feas_s, torch.stack(est_l), 3.4e38).argmin(dim=0)
    sel = lambda arr: _take(torch.stack(arr), f_idx)
    cut = sel(cut_l).to(torch.int32)
    rmax_out = sel(rmax_l)
    qsel = torch.stack(q_l)[f_idx, torch.arange(b, device=x_t.device)]
    del q_l

    # Post-selection refinement at the chosen cut (reference :983-1048):
    # adopt the coarsest sub-grid scale still feasible.
    f_grid = constant(RES_SCALE_STEPS, torch.float32, x_t.device)
    fv_sel = f_dyn * f_grid[f_idx]
    any_feas = feas_s.any(dim=0)
    adopted = torch.zeros((b,), dtype=torch.bool, device=x_t.device)
    for rr in RES_REFINE_RATIOS:                     # coarsest first
        fv_r = fv_sel / float(np.float32(rr))
        q_r = bitplane.quantize_floor(yd * _b4(fv_r))
        rmax_r = rmin + rrng / fv_r
        sb_r = torch.where(rmax_r > rmin, rmax_r - rmin, 1.0) / RES_SCALE
        rec_r = (dwt.unpad(dwt_hopper.idwt2d_dequant(q_r, cut, res_levels),
                           orig_hw) * _b4(sb_r) + _b4(rmin))
        feas_r = (metrics.max_abs_error(x_t, recon + rec_r) <= target)
        feas_r = feas_r & any_feas & ~adopted
        qsel = torch.where(_b4(feas_r), q_r, qsel)
        rmax_out = torch.where(feas_r, rmax_r, rmax_out)
        adopted |= feas_r

    cut4 = _b4(cut)
    mag = qsel.abs()
    overflow = mag.amax(dim=(1, 2, 3)) >= (1 << DELTA_NUM_PLANES)
    vr = torch.where(qsel < 0, -(mag >> cut4), mag >> cut4)
    vr = torch.where(_b4(skip), 0, vr)
    rmin_s = torch.where(skip, 0.0, rmin)
    rmax_f = torch.where(skip, 0.0, rmax_out)

    # The shipped delta as a decoder rebuilds it: kept values expanded by
    # the cut, dequantized there, scaled by the stored rmin/rmax; a skip's
    # zero values and rmin = rmax = 0 give an exact zero.
    q_ship = torch.where(vr < 0, -((-vr) << cut4), vr << cut4)
    spat = dwt_hopper.idwt2d_dequant(q_ship, cut, res_levels)
    rng_s = torch.where(rmax_f > rmin_s, rmax_f - rmin_s, 1.0)
    delta = dwt.unpad(spat, orig_hw) * _b4(rng_s / RES_SCALE) + _b4(rmin_s)
    recon_next = recon + delta
    return recon_next, {
        "vr": vr, "rmin": rmin_s, "rmax": rmax_f, "cut": cut, "skip": skip,
        "feasible": skip | any_feas,
        "maxerr": metrics.max_abs_error(x_t, recon_next),
        "overflow": overflow & ~skip,
    }


def decode_batch_sparse(idx, vals, base_cut, res_cut, minval, maxval, rmin,
                        rmax, *, base_levels: int = 5, res_levels: int = 3,
                        out_hw=(721, 1440), has_residual: bool = True,
                        grid_shape=(1, 1, 736, 1440)):
    """Batched decode from the sparse exchange: ``idx`` (int64) flat
    positions into the (2, B, D0, Hp, Wp) coefficient space (base layer
    first), ``vals`` the signed kept-values at each chunk's cut.  One
    scatter rebuilds the coefficient field, then the inverse transforms."""
    s = int(np.prod(grid_shape))
    qflat = torch.zeros(2 * s, dtype=torch.int32, device=vals.device)
    qflat[idx] = vals.to(torch.int32)
    return _decode_from_qflat(
        qflat, base_cut, res_cut, minval, maxval, rmin, rmax,
        base_levels=base_levels, res_levels=res_levels, out_hw=out_hw,
        has_residual=has_residual, grid_shape=grid_shape)


def _bitcast(seg, dtype):
    """A uint8 tensor's bytes as ``dtype`` (little-endian, as the host
    wrote them): a view, or a view of a copy where ``seg`` does not start on
    the element size."""
    size = torch.empty(0, dtype=dtype).element_size()
    if seg.storage_offset() % size:
        seg = seg.clone()
    return seg.view(dtype)


def rice_unpack_qflat(buf_u8, *, n_blocks: int, n_words: int,
                      n_entries: int, s: int):
    """Blocked-Rice upload, stage 1 (reference ``rice_unpack_qflat``):
    one uint8 buffer [words u32 LE (n_words) | lens_g u16 (n_blocks) |
    lens_v u16 | k_packed u8 | base_pos i32 (n_blocks) | base_cut i32
    (n_entries) | res_cut i32 | nnz | floats (4, n_entries)] -> (qflat,
    base_cut, res_cut, floats).  The lanes decode straight into ``qflat``
    through X1 (``ops.exchange_hopper.rice_unpack_qflat``; its plain
    version on a CPU tensor)."""
    b = n_entries
    nb = n_blocks
    o = 4 * n_words
    words = _bitcast(buf_u8[:o], torch.int32)
    lens_g = _bitcast(buf_u8[o:o + 2 * nb], torch.int16)
    o += 2 * nb
    lens_v = _bitcast(buf_u8[o:o + 2 * nb], torch.int16)
    o += 2 * nb
    k_packed = buf_u8[o:o + nb]
    o += nb
    n_ints = nb + 2 * b + 1
    ints = _bitcast(buf_u8[o:o + 4 * n_ints], torch.int32)
    o += 4 * n_ints
    floats = _bitcast(buf_u8[o:o + 16 * b], torch.float32).reshape(4, b)
    qflat = exchange_hopper.rice_unpack_qflat(
        words, lens_g, lens_v, k_packed, ints[:nb], ints[nb + 2 * b:],
        n_blocks=nb, s=s)
    return qflat, ints[nb:nb + b], ints[nb + b:nb + 2 * b], floats


def decode_from_qflat_program(qflat, base_cut, res_cut, floats, *,
                              base_levels: int = 5, res_levels: int = 3,
                              out_hw=(721, 1440), has_residual: bool = True,
                              grid_shape=(1, 1, 736, 1440)):
    """Blocked-Rice upload, stage 2 (reference
    ``decode_from_qflat_program``): the dense ``qflat`` -> frames, with
    floats = (4, B) [minval, maxval, rmin, rmax]."""
    return _decode_from_qflat(
        qflat, base_cut, res_cut, *floats, base_levels=base_levels,
        res_levels=res_levels, out_hw=out_hw, has_residual=has_residual,
        grid_shape=grid_shape)


def temporal_accumulate(frames, t_frames: int):
    """Per-frame temporal entries (n*T, 1, h, w) -> the chunks' frames
    (n, T, h, w): frame t is frame t-1 plus entry t.  The adds run one
    frame at a time, left to right, in float32: the arithmetic the
    encoder's loop carried when it verified each frame's bound (a prefix
    sum such as ``torch.cumsum`` may add in another order)."""
    n = frames.shape[0] // t_frames
    fr = frames[:, 0].reshape(n, t_frames, *frames.shape[2:])
    out = [fr[:, 0]]
    for k in range(1, t_frames):
        out.append(out[-1] + fr[:, k])
    return torch.stack(out, dim=1)


def _decode_from_qflat(qflat, base_cut, res_cut, minval, maxval, rmin, rmax,
                       *, base_levels, res_levels, out_hw, has_residual,
                       grid_shape):
    h, w = out_hw
    b, d0, hp, wp = grid_shape
    s = b * d0 * hp * wp

    def layer(qkept, cut, levels, scale, lo, hi):
        cut4 = _b4(cut)
        q = torch.where(qkept < 0, -((-qkept) << cut4), qkept << cut4)
        spatial = dwt_hopper.idwt2d_dequant(q, cut, levels)[..., :h, :w]
        rng = torch.where(hi > lo, hi - lo, 1.0)
        return spatial * (_b4(rng) / scale) + _b4(lo)

    out = layer(qflat[:s].reshape(b, d0, hp, wp), base_cut,
                base_levels, BASE_SCALE, minval, maxval)
    if has_residual:
        out = out + layer(qflat[s:].reshape(b, d0, hp, wp), res_cut,
                          res_levels, RES_SCALE, rmin, rmax)
    return out
