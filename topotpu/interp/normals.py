"""Moving-window regression kriging of monthly normals.

Parity target: ``twx/interp/interp_tair.py::KrigTair`` (SURVEY.md §2.12) —
per cell x month: GWR trend on covariates (elevation, TDI, monthly MODIS LST)
plus ordinary kriging of the trend residuals with per-cell exponential
variogram parameters, producing the kriged mean AND kriging variance (the
reference's 95% CI source). The reference runs this through rpy2 -> R gstat
once per cell; here a whole tile of cells is one batched jit.

Variogram parameters per cell are distance-weighted interpolations of the
per-station fitted parameters, mirroring the reference's design of fitting
variograms at stations once and interpolating them to cells (SURVEY.md §3.3).

All arrays arrive pre-gathered per neighborhood (see ``topotpu.interp.point``
for the gather stage): shapes (C, k) / (C, k, q) with a validity mask.
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


from topotpu.geo.neighbors import distance_weights
from topotpu.kernels.ok_krige import ok_krige
from topotpu.kernels.wls import batched_wls, center_design


class NormalsResult(NamedTuple):
    normal: jnp.ndarray    # (C,) kriged monthly normal
    variance: jnp.ndarray  # (C,) kriging variance (deg C^2)
    se: jnp.ndarray        # (C,) sqrt variance
    trend: jnp.ndarray     # (C,) GWR trend component (diagnostic)
    ok: jnp.ndarray        # (C,) bool solvable flag
    vario: jnp.ndarray     # (C, 3) cell-interpolated nugget/psill/range


def interp_cell_variogram(
    nbr_vario: jnp.ndarray, w: jnp.ndarray
) -> jnp.ndarray:
    """(C, k, 3) station params + (C, k) weights -> (C, 3) cell params."""
    wsum = jnp.sum(w, axis=-1, keepdims=True) + 1e-30
    v = jnp.einsum("ck,ckp->cp", w, nbr_vario, precision=HI) / wsum
    nug = jnp.maximum(v[..., 0], 0.0)
    psill = jnp.maximum(v[..., 1], 1e-6)
    rng = jnp.maximum(v[..., 2], 1e-2)
    return jnp.stack([nug, psill, rng], axis=-1)


def krig_normals_and_gains(
    dist, mask, nbr_xyz, nbr_cov, cell_cov, nbr_norm, nbr_vario,
    anom_cov, cell_anom_cov,
    weight_kernel="bisquare", ridge=1e-6, jitter_frac=1e-5,
    min_neighbors=3,
):
    """krig_normals + anomaly-GWR gain rows over the SAME neighborhoods."""
    from topotpu.interp.anoms import anomaly_gain_rows

    res = krig_normals(
        dist, mask, nbr_xyz, nbr_cov, cell_cov, nbr_norm, nbr_vario,
        weight_kernel=weight_kernel, ridge=ridge, jitter_frac=jitter_frac,
        min_neighbors=min_neighbors,
    )
    gains = anomaly_gain_rows(
        dist, mask, anom_cov, cell_anom_cov,
        weight_kernel=weight_kernel, ridge=ridge,
    )
    return res, gains


def krig_normals(
    dist: jnp.ndarray,
    mask: jnp.ndarray,
    nbr_xyz: jnp.ndarray,
    nbr_cov: jnp.ndarray,
    cell_cov: jnp.ndarray,
    nbr_norm: jnp.ndarray,
    nbr_vario: jnp.ndarray,
    weight_kernel: str = "bisquare",
    ridge: float = 1e-6,
    jitter_frac: float = 1e-5,
    min_neighbors: int = 3,
) -> NormalsResult:
    """Regression-krige monthly normals for a batch of cells.

    Args:
      dist: (C, k) neighbor distances, km. mask: (C, k) validity.
      nbr_xyz: (C, k, 3) neighbor unit-sphere coords (for pair distances).
      nbr_cov: (C, k, q) neighbor covariates; cell_cov: (C, q) at the cell.
      nbr_norm: (C, k) neighbor station monthly normals.
      nbr_vario: (C, k, 3) per-station (nugget, psill, range).
    """
    w = distance_weights(dist, mask, weight_kernel)

    # --- GWR trend (the reference's trend surface) ---
    X, x0, _ = center_design(nbr_cov, cell_cov, w)
    beta = batched_wls(X, nbr_norm, w, ridge)
    trend_cell = jnp.einsum("cp,cp->c", x0, beta, precision=HI)
    trend_at_stn = jnp.einsum("ckp,cp->ck", X, beta, precision=HI)
    resid = jnp.where(mask, nbr_norm - trend_at_stn, 0.0)

    # --- per-cell variogram params (interpolated, not refit: SURVEY §3.3) ---
    vario = interp_cell_variogram(nbr_vario, w)

    # --- ordinary kriging of residuals ---
    sol = ok_krige(nbr_xyz, dist, mask, vario, jitter_frac, min_neighbors)
    resid_krig = jnp.sum(sol.weights * resid, axis=-1)

    normal = trend_cell + resid_krig
    var = sol.variance
    return NormalsResult(
        normal=normal,
        variance=var,
        se=jnp.sqrt(jnp.maximum(var, 0.0)),
        trend=trend_cell,
        ok=sol.ok,
        vario=vario,
    )
