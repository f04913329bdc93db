"""Exponential variogram: model, empirical estimator, batched WLS fit.

Parity target: the reference's rpy2 -> R gstat ``variogram`` +
``fit.variogram(vgm(..., "Exp"))`` calls in
``twx/interp/interp_tair.py::BuildKrigParams`` (SURVEY.md §2.11). BASELINE
mandates deleting the R bridge; this module is the native replacement:

* empirical estimator: gstat-style equal-width distance bins, semivariance
  0.5 * mean (z_i - z_j)^2 per bin, with pair counts and mean bin distance;
* fit: weighted least squares with gstat's default weighting
  (fit.method = 7: w_j = N_j / h_j^2), minimized by a damped Gauss-Newton
  (Levenberg-Marquardt) loop — batched over thousands of stations at once
  instead of one R call per station.

All math is mask-aware and static-shape so the moving-window per-station
fits (SURVEY.md §3.3) run as one jit over the whole station set.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Solve-chain products must run at full f32 fidelity: on the GPU, XLA may
# compute an unpinned f32 dot in TF32 (about 1e-3 relative), which costs
# degrees of error in the WLS/kriging chain, while these products are
# FLOP-trivial. No-op on CPU.
HI = jax.lax.Precision.HIGHEST

from jax import lax


def exp_variogram(h, nugget, psill, rng):
    """gamma(h) = nugget + psill * (1 - exp(-h / rng)) for h > 0; 0 at h = 0."""
    rng = jnp.maximum(rng, 1e-6)
    g = nugget + psill * (1.0 - jnp.exp(-h / rng))
    return jnp.where(h > 0.0, g, 0.0)


def exp_covariance(h, nugget, psill, rng):
    """C(h) = sill - gamma(h): psill * exp(-h/rng), + nugget at h == 0."""
    rng = jnp.maximum(rng, 1e-6)
    c = psill * jnp.exp(-h / rng)
    return jnp.where(h > 0.0, c, psill + nugget)


class EmpiricalVariogram(NamedTuple):
    gamma: jnp.ndarray   # (B, n_bins) binned semivariance (0 where empty)
    h: jnp.ndarray       # (B, n_bins) mean pair distance per bin
    npairs: jnp.ndarray  # (B, n_bins) pair counts
    cutoff: jnp.ndarray  # (B,) distance cutoff used


class VariogramFit(NamedTuple):
    nugget: jnp.ndarray  # (B,)
    psill: jnp.ndarray   # (B,)
    rng: jnp.ndarray     # (B,) effective exponential range parameter, km
    sse: jnp.ndarray     # (B,) weighted SSE at the solution
    ok: jnp.ndarray      # (B,) bool — enough pairs/bins to fit


def empirical_variogram(
    dist: jnp.ndarray,
    values: jnp.ndarray,
    mask: jnp.ndarray,
    n_bins: int = 15,
    max_dist_frac: float = 1.0,
) -> EmpiricalVariogram:
    """Binned empirical semivariogram, batched.

    Args:
      dist: (B, k, k) pairwise distances within each neighborhood, km.
      values: (B, k) residuals (already detrended).
      mask: (B, k) validity.
      n_bins: number of equal-width bins.
      max_dist_frac: cutoff as a fraction of the max valid pair distance
        (gstat's default cutoff is diagonal/3 of the bbox; with kNN
        neighborhoods the max pair distance plays the diagonal's role).
    """
    pair_mask = mask[..., :, None] & mask[..., None, :]
    k = dist.shape[-1]
    iu = jnp.triu(jnp.ones((k, k), dtype=bool), 1)
    pair_mask = pair_mask & iu & (dist > 0.0)

    dmax = jnp.max(jnp.where(pair_mask, dist, 0.0), axis=(-2, -1))
    cutoff = jnp.maximum(dmax * max_dist_frac, 1e-3)
    width = cutoff / n_bins

    dv = values[..., :, None] - values[..., None, :]
    sv = 0.5 * dv * dv

    bin_idx = jnp.clip(
        (dist / width[..., None, None]).astype(jnp.int32), 0, n_bins - 1
    )
    in_range = pair_mask & (dist <= cutoff[..., None, None])

    def per_bin(b, carry):
        gsum, hsum, cnt = carry
        sel = in_range & (bin_idx == b)
        selw = sel.astype(sv.dtype)
        gsum = gsum.at[..., b].set(jnp.sum(sv * selw, axis=(-2, -1)))
        hsum = hsum.at[..., b].set(jnp.sum(dist * selw, axis=(-2, -1)))
        cnt = cnt.at[..., b].set(jnp.sum(selw, axis=(-2, -1)))
        return gsum, hsum, cnt

    B = dist.shape[:-2]
    z = jnp.zeros(B + (n_bins,), dtype=sv.dtype)
    gsum, hsum, cnt = lax.fori_loop(0, n_bins, per_bin, (z, z, z))

    safe = jnp.maximum(cnt, 1.0)
    return EmpiricalVariogram(
        gamma=gsum / safe, h=hsum / safe, npairs=cnt, cutoff=cutoff
    )


def fit_exp_variogram(
    emp: EmpiricalVariogram,
    n_iters: int = 50,
    min_bins: int = 4,
) -> VariogramFit:
    """Batched damped Gauss-Newton WLS fit of the exponential model.

    Weights follow gstat fit.method = 7: w_j = N_j / h_j^2. Parameters are
    clamped to their feasible box each step; the damping factor adapts per
    batch element (LM style: shrink on improvement, grow on failure) using
    elementwise selects — no data-dependent control flow, so the whole
    station set fits in one jit (SURVEY.md §2.11's per-station R calls
    become one device launch).
    """
    gamma, h, npairs = emp.gamma, emp.h, emp.npairs
    bin_ok = npairs > 0.0
    w = jnp.where(bin_ok, npairs / jnp.maximum(h, 1e-3) ** 2, 0.0)
    # Normalize weights so SSE and damping scales are comparable across cells.
    w = w / (jnp.sum(w, axis=-1, keepdims=True) + 1e-30)

    n_ok = jnp.sum(bin_ok, axis=-1)
    fit_ok = n_ok >= min_bins

    # Initial values (standard geostatistics heuristics, akin to gstat's vgm
    # defaults): nugget from the first non-empty bin, sill from the high bins.
    first_gamma = _first_valid(gamma, bin_ok)
    tail_gamma = _tail_mean(gamma, bin_ok)
    sill0 = jnp.maximum(tail_gamma, 1e-8)
    nug0 = jnp.clip(first_gamma * 0.5, 0.0, 0.9 * sill0)
    psill0 = jnp.maximum(sill0 - nug0, 1e-8)
    rng0 = jnp.maximum(emp.cutoff / 3.0, 1e-2)

    hmax = jnp.max(jnp.where(bin_ok, h, 0.0), axis=-1)
    rng_hi = jnp.maximum(hmax * 10.0, 1.0)
    rng_lo = 1e-2

    def sse_of(nug, ps, rg):
        g = nug[..., None] + ps[..., None] * (
            1.0 - jnp.exp(-h / jnp.maximum(rg[..., None], 1e-6))
        )
        r = jnp.where(bin_ok, gamma - g, 0.0)
        return jnp.sum(w * r * r, axis=-1)

    def body(_, state):
        nug, ps, rg, lam_damp, sse = state
        rgc = jnp.maximum(rg, 1e-6)
        e = jnp.exp(-h / rgc[..., None])
        model = nug[..., None] + ps[..., None] * (1.0 - e)
        r = jnp.where(bin_ok, gamma - model, 0.0)
        # Jacobian columns: d/dnug = 1, d/dpsill = (1-e), d/drng = -ps*h/r^2*e
        J = jnp.stack(
            [
                jnp.ones_like(h),
                1.0 - e,
                -(ps[..., None] * h / (rgc[..., None] ** 2)) * e,
            ],
            axis=-1,
        )  # (B, n_bins, 3)
        Jw = J * w[..., None]
        A = jnp.einsum("...ji,...jk->...ik", Jw, J, precision=HI)
        g = jnp.einsum("...ji,...j->...i", Jw, r, precision=HI)
        diag_scale = jnp.trace(A, axis1=-2, axis2=-1)[..., None, None] / 3.0
        eye = jnp.eye(3, dtype=A.dtype)
        A_d = A + (lam_damp[..., None, None] * diag_scale + 1e-30) * eye
        delta = _solve3(A_d, g)
        nug_n = jnp.clip(nug + delta[..., 0], 0.0, None)
        ps_n = jnp.maximum(ps + delta[..., 1], 1e-8)
        rg_n = jnp.clip(rg + delta[..., 2], rng_lo, rng_hi)
        sse_n = sse_of(nug_n, ps_n, rg_n)
        improved = sse_n < sse
        nug = jnp.where(improved, nug_n, nug)
        ps = jnp.where(improved, ps_n, ps)
        rg = jnp.where(improved, rg_n, rg)
        sse = jnp.where(improved, sse_n, sse)
        lam_damp = jnp.where(improved, lam_damp * 0.5, lam_damp * 2.0)
        lam_damp = jnp.clip(lam_damp, 1e-8, 1e8)
        return nug, ps, rg, lam_damp, sse

    lam0 = jnp.full_like(nug0, 1e-3)
    sse0 = sse_of(nug0, psill0, rng0)
    nug, ps, rg, _, sse = lax.fori_loop(
        0, n_iters, body, (nug0, psill0, rng0, lam0, sse0)
    )
    return VariogramFit(nugget=nug, psill=ps, rng=rg, sse=sse, ok=fit_ok)


def _solve3(A, b):
    """Solve (B, 3, 3) systems via adjugate/determinant — cheaper and more
    fusable than a batched LAPACK call for 3x3."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    det = jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) / det
    x1 = (c10 * b0 + c11 * b1 + c12 * b2) / det
    x2 = (c20 * b0 + c21 * b1 + c22 * b2) / det
    return jnp.stack([x0, x1, x2], axis=-1)


def _first_valid(x, ok):
    big = jnp.where(ok, jnp.arange(x.shape[-1]), x.shape[-1])
    idx = jnp.argmin(big, axis=-1)
    return jnp.take_along_axis(x, idx[..., None], axis=-1)[..., 0]


def _tail_mean(x, ok, frac=0.5):
    n = x.shape[-1]
    start = int(n * frac)
    sel = ok & (jnp.arange(n) >= start)
    s = jnp.sum(jnp.where(sel, x, 0.0), axis=-1)
    c = jnp.sum(sel, axis=-1)
    full = jnp.sum(jnp.where(ok, x, 0.0), axis=-1) / jnp.maximum(
        jnp.sum(ok, axis=-1), 1
    )
    return jnp.where(c > 0, s / jnp.maximum(c, 1), full)
