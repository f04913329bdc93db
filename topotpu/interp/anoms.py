"""Daily-anomaly GWR, restructured as one matmul per month.

Parity target: ``twx/interp/interp_tair.py::GwrTairAnom`` (SURVEY.md §2.13):
per cell x day, geographically-weighted regression of station daily anomalies
(obs - station monthly normal) on covariates. The reference runs a numpy
lstsq per cell per day — hot loop #3 of SURVEY §3.1 (~25k days x 1e7 cells).

Batched restructuring: the GWR design matrix and weights depend only on
(cell, month) geometry, never on the day. So the per-day solve collapses to a
precomputed *gain row* g (see ``kernels.wls.batched_gwr_gain``):

    anom(cell, day) = sum_j g[cell, j] * anom_stn[idx[cell, j], day]

Scattering each cell's k gains into a dense (cells x stations) matrix G turns
an entire month of days into ONE matmul  G @ Y  — large and batched
(cells x stations x days), which is where this framework's speedup over the
reference comes from.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Solve-chain products must run at full f32 fidelity: on the GPU, XLA may
# compute an unpinned f32 dot in TF32 (about 1e-3 relative), which costs
# degrees of error in the WLS/kriging chain, while these products are
# FLOP-trivial. No-op on CPU.
HI = jax.lax.Precision.HIGHEST


from topotpu.geo.neighbors import distance_weights
from topotpu.kernels.wls import batched_gwr_gain, center_design


def anomaly_gain_rows(
    dist: jnp.ndarray,
    mask: jnp.ndarray,
    nbr_cov: jnp.ndarray,
    cell_cov: jnp.ndarray,
    weight_kernel: str = "bisquare",
    ridge: float = 1e-6,
) -> jnp.ndarray:
    """(C, k) GWR prediction gains for one (tile, month) geometry."""
    w = distance_weights(dist, mask, weight_kernel)
    X, x0, _ = center_design(nbr_cov, cell_cov, w)
    return batched_gwr_gain(X, w, x0, ridge)


def scatter_gains(
    gains: jnp.ndarray, idx: jnp.ndarray, mask: jnp.ndarray, n_stations: int
) -> jnp.ndarray:
    """Scatter (C, k) neighborhood gains into a dense (C, S) matrix.

    S is the (padded) tile station pool — a few hundred — so G is small and
    G @ Y is one dense matmul. Masked entries contribute 0.
    """
    g = jnp.where(mask, gains, 0.0)
    C, k = gains.shape
    G = jnp.zeros((C, n_stations), dtype=gains.dtype)
    rows = jnp.broadcast_to(jnp.arange(C)[:, None], (C, k))
    return G.at[rows, idx].add(g)


def predict_daily(
    G: jnp.ndarray, stn_anoms: jnp.ndarray
) -> jnp.ndarray:
    """(C, S) gains x (S, D) station anomaly matrix -> (C, D) cell anomalies.

    One matmul replaces D per-cell lstsq solves.
    """
    return jnp.dot(G, stn_anoms, preferred_element_type=G.dtype,
                   precision=HI)


def predict_daily_gathered(
    gains: jnp.ndarray,      # (C, k)
    idx: jnp.ndarray,        # (C, k)
    mask: jnp.ndarray,       # (C, k)
    stn_anoms: jnp.ndarray,  # (S, D)
) -> jnp.ndarray:
    """Scatter-free variant: gather each neighborhood's day rows and
    contract. Trades the (C, S) scatter-add for a (C, k, D) gather +
    einsum. Preferable when k*D stays modest
    (single-year chunks); the tile facade picks per configuration."""
    g = jnp.where(mask, gains, 0.0)
    rows = jnp.take(stn_anoms, idx, axis=0)          # (C, k, D)
    return jnp.einsum("ck,ckd->cd", g, rows, precision=HI)
