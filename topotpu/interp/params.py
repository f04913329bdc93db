"""Moving-window variogram-parameter build.

Parity target: ``twx/interp/interp_tair.py::BuildKrigParams`` + the
``bin/mpi_krig_params.py`` driver (SURVEY.md §2.11, §3.3): at each *station*,
take the surrounding moving-window neighborhood (excluding the station
itself), detrend the monthly normals with GWR, fit an exponential variogram
to the residuals (R gstat in the reference), and store
(nugget, psill, range) x 12 as station attributes. Gridded runs then
*interpolate* these parameters to cells instead of refitting — the design
decision that makes per-cell kriging embarrassingly batchable.

Batched: the reference farms one station per MPI task and one R call per
fit; here ALL stations x 12 months fit in a handful of jitted batched
Gauss-Newton launches.
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

import numpy as np

from topotpu.core.config import InterpParams, VariogramParams
from topotpu.geo.distance import unit_xyz, pairwise_km_from_xyz
from topotpu.geo.neighbors import select_neighbors, distance_weights
from topotpu.kernels.wls import batched_wls, center_design
from topotpu.stats.variogram import empirical_variogram, fit_exp_variogram


class KrigParamsResult(NamedTuple):
    vario: jnp.ndarray  # (S, 12, 3) nugget/psill/range per station per month
    sse: jnp.ndarray    # (S, 12) weighted fit SSE
    ok: jnp.ndarray     # (S, 12) fit usable


def build_krig_params(
    stn_lon: jnp.ndarray,
    stn_lat: jnp.ndarray,
    stn_elev: jnp.ndarray,
    stn_tdi: jnp.ndarray,
    stn_lst: jnp.ndarray,   # (S, 12)
    stn_norm: jnp.ndarray,  # (S, 12)
    stn_valid: jnp.ndarray,  # (S, 12) bool
    vparams: VariogramParams,
    iparams: InterpParams,
) -> KrigParamsResult:
    """Fit per-station monthly exponential variograms, batched over stations."""
    k = vparams.k_fit_neighbors

    # ONE jitted per-month program, compiled once and reused 12x2-vars
    # times; station arrays go in as jit ARGUMENTS, never closure
    # constants, so the program does not embed the network.
    @jax.jit
    def _one_month(lon, lat, elev, tdi, valid_m, lst_m, norm_m):
        xyz = unit_xyz(lon, lat)
        # LOO by IDENTITY (queries == pool): keeps the cheap cos-matmul
        # branch instead of the exact (S, S) trig program, the
        # superlinear term of this stage at 10^4 stations. Exact distances
        # are still recomputed for the selected k below, so weights are
        # unchanged.
        nbr = select_neighbors(
            lon, lat, lon, lat, valid_m, k=k,
            exclude_idx=jnp.arange(lon.shape[0]),
        )
        take = lambda a: jnp.take(a, nbr.idx, axis=0)  # noqa: E731
        w = distance_weights(nbr.dist, nbr.mask, iparams.weight_kernel)

        # Trend design: covariates only (elev/tdi/LST). Locality enters via
        # the window weights, NOT explicit x/y — an in-window planar x/y term
        # would absorb the spatially-correlated residual the variogram must
        # measure (observed: fitted sill collapsed to ~25% of truth with x/y
        # in the design). Mirrors the reference's covariate-only trend.
        nbr_cov = jnp.stack([take(elev), take(tdi), take(lst_m)], axis=-1)
        cell_cov = jnp.stack([elev, tdi, lst_m], axis=-1)
        X, _, _ = center_design(nbr_cov, cell_cov, w)
        y = take(norm_m)
        beta = batched_wls(X, y, w, iparams.ridge)
        resid = jnp.where(nbr.mask, y - jnp.einsum("skp,sp->sk", X, beta,
                                                    precision=HI), 0.0)

        dist_pair = pairwise_km_from_xyz(take(xyz), take(xyz))
        emp = empirical_variogram(
            dist_pair, resid, nbr.mask,
            n_bins=vparams.n_bins, max_dist_frac=vparams.max_dist_frac,
        )
        fit = fit_exp_variogram(emp, n_iters=vparams.gn_iters)
        return (
            jnp.stack([fit.nugget, fit.psill, fit.rng], axis=-1),
            fit.sse,
            fit.ok & valid_m,
        )

    varios, sses, oks = [], [], []
    for m in range(12):
        v, s, o = _one_month(
            stn_lon, stn_lat, stn_elev, stn_tdi,
            stn_valid[:, m], stn_lst[:, m], stn_norm[:, m],
        )
        varios.append(v)
        sses.append(s)
        oks.append(o)

    return KrigParamsResult(
        vario=jnp.stack(varios, axis=1),
        sse=jnp.stack(sses, axis=1),
        ok=jnp.stack(oks, axis=1),
    )


def fill_failed_fits(vario: np.ndarray, ok: np.ndarray) -> np.ndarray:
    """Replace failed per-station fits with the monthly median of good fits
    (host-side post-pass; the reference falls back to default vgm params)."""
    out = np.array(vario, copy=True)
    for m in range(vario.shape[1]):
        good = ok[:, m]
        if good.any():
            med = np.median(vario[good, m, :], axis=0)
        else:
            med = np.array([0.0, 1.0, 100.0])
        out[~good, m, :] = med
    return out
