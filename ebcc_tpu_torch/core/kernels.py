"""Batched device programs of the MAX_ERROR codec, in PyTorch.

Counterpart of ``ebcc_tpu/core/kernels.py`` (``_coarse_fine_search``
:63-131, ``encode_batch``/``_encode_core`` :139-158 and :195-845 in their
batched formulation, with relative targets and the fused curve sweep,
``decode_batch_sparse`` :1181-1214 and ``_decode_from_qflat``
:1523-1544).  Every step keeps the reference's arithmetic and decisions;
what changes is the idiom:

  * PyTorch runs eagerly, so there is no ``jit``: each ``lax.map`` over
    candidate cuts is a Python loop of kernel launches, and each
    ``lax.cond`` is a host-side branch on one small device-to-host read.
  * The transforms go through the hand-written kernels of
    ``ops.dwt_hopper`` on a CUDA tensor (their plain versions on a CPU
    tensor).  Frames never share a kernel block and every other operation
    is elementwise or a per-chunk max/min/count (exact) or a float64 mean,
    so a chunk's results do not depend on the batch it rides in: the port
    needs no counterpart of the reference's per-chunk ``lax.map`` under
    ``det`` or of ``codec._pad_min_batch``.

Not ported here (see ROADMAP): rate mode, temporal mode and
``return_internal``, the u16 upload and the link-saving exchange programs
of ``core/transfer.py``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import (BASE_NUM_PLANES, BASE_REFINE_ITERS, RES_NUM_PLANES,
                      RES_REFINE_RATIOS, RES_SCALE_STEPS)
from ..ops import bitplane, dwt, dwt_hopper, metrics

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
    cc_dev = torch.as_tensor(cc, device=dev)

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


def encode_batch(x, error_target: float, base_quantile_target: float, *,
                 base_levels: int = 5, res_levels: int = 3,
                 relative_mode: bool = False, use_centered: bool = True):
    """Full batched error-bounded encode of ``x`` (B, D0, H, W) float32:
    ``error_target`` is absolute, or a fraction of each chunk's range with
    ``relative_mode``.  Returns a dict of device tensors (the reference's
    ``small`` keys plus ``vals_comb``, the flat signed kept-values of both
    layers); stream assembly happens on the host (``core.codec``).

    ``EBCC_FUSED_CURVE=1`` (read at each call, as the reference reads it)
    runs each coarse cut sweep as one K3 pass instead of one K2 evaluation
    per cut."""
    minval, maxval = metrics.minmax(x)
    return _encode_core(x, minval, maxval, error_target,
                        base_quantile_target, base_levels=base_levels,
                        res_levels=res_levels, relative_mode=relative_mode,
                        use_centered=use_centered)


def _encode_core(x, minval, maxval, error_target, base_quantile_target, *,
                 base_levels, res_levels, relative_mode, use_centered):
    b, d0, h, w = x.shape
    mult = 1 << max(base_levels, res_levels)
    error_target = float(np.float32(error_target))
    bq_target = float(np.float32(base_quantile_target))

    # ---- per-chunk range & const detection ----
    const = minval == maxval
    rng = torch.where(const, 1.0, maxval - minval)
    # Absolute target per chunk (reference :206-208, REL->ABS).
    target = ((maxval - minval) * error_target if relative_mode
              else torch.full_like(minval, error_target))
    # Feasibility is verified at target minus the decoder allowance, unless
    # that would eat more than half the target (reference :217-220).
    base_t = torch.clamp(target, min=0.0)
    eps_d = DECODER_EPS_REL * (maxval - minval)
    target = torch.where(base_t - eps_d >= 0.5 * target, base_t - eps_d,
                         base_t)

    u = (x - _b4(minval)) / _b4(rng) * BASE_SCALE
    up, orig_hw = dwt.pad_to_multiple(u, mult)

    # ---- base layer transform + quantize (K1) ----
    qbase = dwt_hopper.dwt2d_quantize(up.contiguous(), base_levels)
    hp, wp = qbase.shape[-2], qbase.shape[-1]

    scale_back = _b4(rng) / BASE_SCALE
    off = _b4(minval)

    def base_metrics(rec_spatial, cut):
        recon = dwt.unpad(rec_spatial, orig_hw) * scale_back + off
        maxe_c, m = metrics.centered_max_abs_error(x, recon)
        maxe = maxe_c if use_centered else metrics.max_abs_error(x, recon)
        qt = metrics.error_quantile(x, recon, target)
        return maxe, qt, m

    # Fused curve sweep (reference :260-294): K3's per-frame rows combine
    # into the metric tuples of the per-cut path.  Max, min and count are
    # exact; the sum is float64 and divided once, as metrics.batch_mean
    # does, so the mean matches it up to a double-rounding tie.  The max
    # error is exact too: rounding is monotone, so max|err - m| =
    # max(mx - m, m - mn).
    n_pts = d0 * h * w
    use_curve = os.environ.get("EBCC_FUSED_CURVE", "0") == "1"

    def _combine(stats):
        s = stats[..., 0].sum(-1)
        mx = stats[..., 1].amax(-1).to(torch.float32)
        mn = stats[..., 2].amin(-1).to(torch.float32)
        bad = stats[..., 3].sum(-1).to(torch.float32)
        m = (s / n_pts).to(torch.float32)
        maxe = (torch.maximum(mx - m, m - mn) if use_centered
                else torch.maximum(mx, -mn))
        # The float32 steps of metrics.error_quantile on an exact count.
        return maxe, 1.0 - bad / n_pts, m

    base_curve = None
    if use_curve:
        xpad = dwt.pad_to_multiple(x, mult)[0].contiguous()
        scale_v = rng / BASE_SCALE

        def base_curve(cut_grid):
            return _combine(dwt_hopper.curve_stats(
                qbase, xpad, scale_v, minval, target, levels=base_levels,
                cut_grid=cut_grid, valid_hw=orig_hw))

    # Two criteria share one coarse sweep: the quantile target and the full
    # bound (pure-base candidate).
    [(base_cut, _, base_m), (pure_cut, pure_feasible, pure_m)], \
        base_coarse, _cc = _coarse_fine_search(
            qbase, BASE_NUM_PLANES, base_levels, base_metrics,
            [lambda m: m[1] >= bq_target, lambda m: m[0] <= target],
            curve_fn=base_curve)

    base_sizes = bitplane.estimated_code_bytes(
        qbase.reshape(b, d0 * hp, wp), BASE_NUM_PLANES)

    # ---- base reconstruction at the chosen cut ----
    base_spatial = dwt_hopper.idwt2d_dequant(qbase, base_cut, base_levels)
    base_recon = dwt.unpad(base_spatial, orig_hw) * scale_back + off
    residual = x - base_recon
    base_maxerr = metrics.max_abs_error(x, base_recon)
    skip_residual = base_maxerr <= target

    # ---- residual layer with the fractional-scale sweep ----
    rmin = residual.amin(dim=(1, 2, 3))
    rmax = residual.amax(dim=(1, 2, 3))
    rrng = torch.where(rmax > rmin, rmax - rmin, 1.0)
    res_off = _b4(rmin)

    def residual_sweep():
        rn = (residual - res_off) / _b4(rrng) * RES_SCALE
        rnp_, _ = dwt.pad_to_multiple(rn, mult)
        yres = dwt_hopper.dwt2d_transform(rnp_.contiguous(), res_levels)
        res_pad = (dwt.pad_to_multiple(residual, mult)[0].contiguous()
                   if use_curve else None)
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
                maxe = (maxe_c if use_centered
                        else metrics.max_abs_error(x, recon))
                return maxe, m

            res_curve = None
            if use_curve:
                # The reference's formulation (:373-390): the residual is
                # the target frame, err = res - (rec * sb + rmin), which can
                # differ from res_metrics' x - (base_recon + ...) in the
                # last ulp.
                sb_v = (rmax_adj - rmin) / RES_SCALE

                def res_curve(cut_grid, q_f=q_f, sb_v=sb_v):
                    maxe, _q, m = _combine(dwt_hopper.curve_stats(
                        q_f, res_pad, sb_v, rmin, target, levels=res_levels,
                        cut_grid=cut_grid, valid_hw=orig_hw))
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
        f_grid = torch.tensor(RES_SCALE_STEPS, dtype=torch.float32,
                              device=x.device)
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
            maxe_r = (maxe_c_r if use_centered
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
        return (cut_sel, any_feas, best_maxe, best_mean, best_rmax,
                best_est, best_q)

    def residual_trivial():
        zero = torch.zeros((b,), dtype=torch.float32, device=x.device)
        return (torch.full((b,), RES_NUM_PLANES - 1, dtype=torch.int32,
                           device=x.device),
                torch.ones((b,), dtype=torch.bool, device=x.device),
                zero, zero, rmin + rrng, zero,
                torch.zeros((b, d0, hp, wp), dtype=torch.int32,
                            device=x.device))

    # When every chunk's base layer already meets the bound the sweep is
    # dead work (the reference's lax.cond at :530-532).
    (res_cut, res_feasible, res_maxerr_sel, res_mean_sel, rmax_out,
     res_sizes, qres) = (residual_trivial() if bool(skip_residual.all())
                         else residual_sweep())

    overflow = ((qbase.abs().amax(dim=(1, 2, 3)) >= (1 << BASE_NUM_PLANES))
                | (qres.abs().amax(dim=(1, 2, 3)) >= (1 << RES_NUM_PLANES)))

    # ---- base-scale bisection for base-only chunks (reference :538-691) --
    ship_pure_only = (~skip_residual) & (~res_feasible)
    refinable = (skip_residual | ship_pure_only) & (~const)
    cut_ship_ref = torch.where(skip_residual, base_cut, pure_cut)
    qbase_ship = qbase
    maxval_ship = maxval
    base_maxerr_out = base_maxerr
    base_m0, base_m2 = base_m[0], base_m[2]
    pure_m0, pure_m2 = pure_m[0], pure_m[2]
    # Host-side branch in place of the reference's lax.cond at :649-651:
    # with no refinable chunk no candidate could be adopted.
    if bool(refinable.any()):
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
                q_g, cut_ship_ref, base_levels), orig_hw) * sb_g + off)
            maxe_c_g, mean_g = metrics.centered_max_abs_error(x, recon_g)
            maxe_u_g = metrics.max_abs_error(x, recon_g)
            crit_pure = maxe_c_g if use_centered else maxe_u_g
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

    # ---- exchange values (reference :693-707) ----
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

    return {
        "minval": minval, "maxval": maxval_ship, "const": const,
        "overflow": overflow,
        "target_abs": target,
        "store_cut": store_cut,
        "base_cut": base_cut, "pure_cut": pure_cut,
        "pure_feasible": pure_feasible,
        "base_est_sizes": base_sizes,
        "base_quantiles": base_coarse[1],  # (n_coarse, B), coarse cut grid
        "pure_maxerr": pure_m0,
        "pure_mean": pure_m2,
        "skip_residual": skip_residual,
        "base_maxerr": base_maxerr_out,
        "base_maxerr_centered": base_m0,
        "base_mean": base_m2,
        "rmin": rmin, "rmax": rmax_out,
        "res_cut": res_cut, "res_feasible": res_feasible,
        "res_maxerr": res_maxerr_sel,
        "res_mean": res_mean_sel,
        "res_est_size": res_sizes,  # (B,) at the selected (scale, cut)
        "vals_comb": torch.cat([vb.reshape(-1), vr.reshape(-1)]),
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
