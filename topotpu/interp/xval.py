"""Cross-validation machinery.

Parity target: the reference's correctness story (SURVEY.md §4) — there is
no unit-test suite in the public repo; its validation is cross-validation
built into the pipeline:

  * held-out-station x-val of the interpolation (``bin/mpi_xval_*``):
    leave each station out, interpolate to its location, score MAE/bias/R^2
    of normals — the numbers behind the paper's error tables;
  * infill x-val (``twx/infill/random_xval.py``-style): mask observed
    spans, impute, score;
  * station-count optimization (``bin/mpi_optim_nstns_*``, SURVEY §2.16):
    sweep neighborhood sizes, pick the per-region minimum-MAE k.

Batched: leave-one-out over ALL stations is one batched run per month —
the "cells" of the tile pipeline are simply the station locations with
self-exclusion — instead of one MPI task per held-out station.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from topotpu.core.config import InterpParams, PPCAParams
from topotpu.geo.distance import unit_xyz
from topotpu.geo.neighbors import select_neighbors
from topotpu.interp.normals import krig_normals


@dataclasses.dataclass
class XvalScores:
    mae: np.ndarray    # (12,) or scalar-per-month metric
    bias: np.ndarray   # (12,)
    r2: np.ndarray     # (12,)
    per_station_err: np.ndarray  # (S, 12) prediction - truth


def xval_interp_normals(
    stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm, stn_vario,
    stn_valid, params: InterpParams,
) -> XvalScores:
    """Leave-one-station-out normals interpolation, batched over stations.

    All inputs are numpy/(jnp) arrays shaped like the serial DB attributes:
    lon/lat/elev/tdi (S,), lst/norm/valid (S, 12), vario (S, 12, 3).
    """
    S = stn_lon.shape[0]
    dt = jnp.float32
    lon = jnp.asarray(stn_lon, dt)
    lat = jnp.asarray(stn_lat, dt)
    elev = jnp.asarray(stn_elev, dt)
    tdi = jnp.asarray(stn_tdi, dt)
    lst = jnp.asarray(stn_lst, dt)
    norm = jnp.asarray(stn_norm, dt)
    vario = jnp.asarray(stn_vario, dt)
    valid = jnp.asarray(stn_valid)
    xyz = unit_xyz(lon, lat)

    import jax

    @jax.jit  # one compiled program, reused for every month
    def _one_month(valid_m, lst_m, norm_m, vario_m):
        # LOO by identity index — keeps the cos-matmul selection branch (see
        # interp/params.py; the station is excluded from its own
        # neighborhood exactly, with no (S, S) exact-trig program)
        nbr = select_neighbors(
            lon, lat, lon, lat, valid_m, k=params.k_neighbors,
            exclude_idx=jnp.arange(lon.shape[0]),
        )
        take = lambda a: jnp.take(a, nbr.idx, axis=0)  # noqa: E731
        nbr_cov = jnp.stack([take(elev), take(tdi), take(lst_m)], axis=-1)
        cell_cov = jnp.stack([elev, tdi, lst_m], axis=-1)
        res = krig_normals(
            nbr.dist, nbr.mask, take(xyz), nbr_cov, cell_cov,
            take(norm_m), take(vario_m),
            weight_kernel=params.weight_kernel, ridge=params.ridge,
            jitter_frac=params.chol_jitter, min_neighbors=params.min_neighbors,
        )
        return res.normal - norm_m, res.ok

    errs = np.zeros((S, 12), np.float32)
    oks = np.zeros((S, 12), bool)
    for m in range(12):
        e, o = _one_month(valid[:, m], lst[:, m], norm[:, m], vario[:, m, :])
        errs[:, m] = np.asarray(e)
        oks[:, m] = np.asarray(o)

    # score only entries that are BOTH valid-this-month and actually
    # solved: an ok=False solve returns a clamped/meaningless normal whose
    # error is solve failure, not interpolation skill — counting it would
    # poison the MAE bar and bias the optimize_nnghs argmin against small
    # k (where sparse neighborhoods fail more often)
    truth = np.asarray(norm)
    # also require finite truth and error: a BAD station's stale/NaN stored
    # norm is not a scorable entry (it would NaN the monthly aggregates)
    use = (
        np.asarray(valid) & oks & np.isfinite(truth) & np.isfinite(errs)
    )
    maes, biases, r2s = [], [], []
    for m in range(12):
        e = errs[use[:, m], m]
        t = truth[use[:, m], m]
        if e.size == 0:
            maes.append(np.nan)
            biases.append(np.nan)
            r2s.append(np.nan)
            continue
        maes.append(np.abs(e).mean())
        biases.append(e.mean())
        ss_res = (e**2).sum()
        ss_tot = ((t - t.mean()) ** 2).sum() + 1e-12
        r2s.append(1.0 - ss_res / ss_tot)
    return XvalScores(
        mae=np.array(maes), bias=np.array(biases), r2=np.array(r2s),
        per_station_err=np.where(use, errs, np.nan),
    )


def xval_interp_daily(
    stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm, stn_vario,
    stn_valid, stn_anoms, month_idx, params: InterpParams,
) -> dict:
    """Leave-one-station-out x-val of full DAILY values (normals + GWR
    anomalies recombined) — the protocol behind the reference paper's daily
    MAE/bias tables (SURVEY §4/§6: daily x-val MAE ~1.2-2.0 C).

    stn_anoms: (S, T) serially-complete daily anomalies; month_idx: (T,).
    """
    import jax

    from topotpu.interp.anoms import anomaly_gain_rows, predict_daily_gathered
    from topotpu.interp.point import month_layout, group_days_by_month, ungroup_days

    S = stn_lon.shape[0]
    dt = jnp.float32
    lon = jnp.asarray(stn_lon, dt)
    lat = jnp.asarray(stn_lat, dt)
    elev = jnp.asarray(stn_elev, dt)
    tdi = jnp.asarray(stn_tdi, dt)
    lst = jnp.asarray(stn_lst, dt)
    norm = jnp.asarray(stn_norm, dt)
    vario = jnp.asarray(stn_vario, dt)
    valid = jnp.asarray(stn_valid)
    xyz = unit_xyz(lon, lat)

    import types

    layout = month_layout(
        types.SimpleNamespace(month_idx=month_idx, ndays=len(month_idx))
    )
    anoms_g = group_days_by_month(stn_anoms.astype(np.float32), layout)
    anoms_g = jnp.asarray(np.moveaxis(anoms_g, 1, 0))  # (12, S, dpm)

    # locational covariates: the SAME conversion the tile path uses
    # (interp/point.py::_local_xy_km at the pool-mean latitude) — the x-val
    # protocol must not desynchronize from the production path it validates
    from topotpu.interp.point import _local_xy_km

    sx, sy = _local_xy_km(lon, lat, float(np.mean(np.asarray(stn_lat))))

    @jax.jit
    def _month(valid_m, lst_m, norm_m, vario_m, Y_m):
        nbr = select_neighbors(
            lon, lat, lon, lat, valid_m, k=params.k_neighbors,
            exclude_idx=jnp.arange(lon.shape[0]),
        )
        take = lambda a: jnp.take(a, nbr.idx, axis=0)  # noqa: E731
        nbr_cov = jnp.stack([take(elev), take(tdi), take(lst_m)], axis=-1)
        cell_cov = jnp.stack([elev, tdi, lst_m], axis=-1)
        res = krig_normals(
            nbr.dist, nbr.mask, take(xyz), nbr_cov, cell_cov,
            take(norm_m), take(vario_m),
            weight_kernel=params.weight_kernel, ridge=params.ridge,
            jitter_frac=params.chol_jitter, min_neighbors=params.min_neighbors,
        )
        # anomaly neighborhood: a free distance-sorted prefix of the
        # normals one (the reference tunes the two sizes independently —
        # mpi_optim_nstns_norms vs _anoms, SURVEY §2.16 — so the daily
        # protocol must honor k_neighbors_anom to make that sweep real)
        ka = min(params.k_neighbors_anom, params.k_neighbors)
        idx_a, dist_a, mask_a = (
            nbr.idx[:, :ka], nbr.dist[:, :ka], nbr.mask[:, :ka]
        )
        take_a = lambda a: jnp.take(a, idx_a, axis=0)  # noqa: E731
        nca = jnp.stack([take_a(elev), take_a(sx), take_a(sy)], axis=-1)
        cca = jnp.stack([elev, sx, sy], axis=-1)
        g = anomaly_gain_rows(dist_a, mask_a, nca, cca,
                              weight_kernel=params.weight_kernel,
                              ridge=params.ridge)
        anom_pred = predict_daily_gathered(g, idx_a, mask_a, Y_m)
        return res.normal[:, None] + anom_pred, res.ok  # (S, dpm), (S,)

    pred_g = np.zeros((S, 12, layout.dpm), np.float32)
    oks = np.zeros((S, 12), bool)
    for m in range(12):
        pg, o = _month(valid[:, m], lst[:, m], norm[:, m], vario[:, m, :],
                       anoms_g[m])
        pred_g[:, m, :] = np.asarray(pg)
        oks[:, m] = np.asarray(o)
    pred = ungroup_days(pred_g, layout)                      # (S, T)
    truth = stn_norm[:, month_idx] + stn_anoms
    # score only stations valid AND solved in every month: a failed solve's
    # clamped normal would grade solve failure, not interpolation skill
    vmask = np.asarray(stn_valid).all(axis=1) & oks.all(axis=1)
    err = (pred - truth)[vmask]
    abs_all = np.abs(pred - truth)
    psm = abs_all.mean(axis=1)
    # per-month daily MAE — the reference paper reports its daily error
    # tables by month (SURVEY §6)
    mae_by_month = [
        float(abs_all[vmask][:, month_idx == m].mean()) if err.size
        else float("nan")
        for m in range(12)
    ]
    return {
        "mae": float(np.abs(err).mean()) if err.size else float("nan"),
        "bias": float(err.mean()) if err.size else float("nan"),
        "rmse": (
            float(np.sqrt((err**2).mean())) if err.size else float("nan")
        ),
        "mae_by_month": mae_by_month,
        "per_station_mae": np.where(vmask, psm, np.nan),
    }


def xval_infill(
    obs: np.ndarray,
    month_idx: np.ndarray,
    params: PPCAParams,
    holdout_frac: float = 0.2,
    seed: int = 0,
    stn_lon=None,
    stn_lat=None,
) -> dict:
    """Hold out observed entries, infill, score (SURVEY §2.9; BASELINE
    config #3's '20% missing obs' protocol)."""
    from topotpu.infill import infill_network

    rng = np.random.default_rng(seed)
    observed = np.isfinite(obs)
    hold = observed & (rng.uniform(size=obs.shape) < holdout_frac)
    obs_masked = np.where(hold, np.nan, obs)
    res = infill_network(obs_masked, month_idx, params,
                         stn_lon=stn_lon, stn_lat=stn_lat)
    err = (res.filled - obs)[hold]
    return {
        "mae": float(np.abs(err).mean()),
        "bias": float(err.mean()),
        "rmse": float(np.sqrt((err**2).mean())),
        "n_holdout": int(hold.sum()),
        "result": res,
    }


def _pick_k(scores: dict, fallback: int, parsimony: bool) -> int:
    """Choose k from {k: (mean_mae, se)}. ``parsimony`` applies the 1-SE
    rule: the SMALLEST k whose mean MAE is within one standard error of the
    best — a bare argmin over LOO-MAE structurally saturates at the largest
    candidate at ordinary station densities (more averaging always looks
    marginally better), which is not an optimizer (gstat-era practice and
    the reference's optim jobs intend the cheapest adequate neighborhood).
    """
    if not scores:
        return fallback
    kbest = min(scores, key=lambda k: scores[k][0])
    if not parsimony:
        return int(kbest)
    bar = scores[kbest][0] + scores[kbest][1]
    return int(min(k for k in scores if scores[k][0] <= bar))


def _mean_se(vals: np.ndarray):
    """(mean, standard error) over finite entries; None if empty."""
    vals = vals[np.isfinite(vals)]
    if not vals.size:
        return None
    se = float(vals.std(ddof=1) / np.sqrt(vals.size)) if vals.size > 1 else 0.0
    return float(vals.mean()), se


def optimize_nnghs(
    stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm, stn_vario,
    stn_valid,
    candidates=(8, 16, 24, 32, 48),
    region_labels: np.ndarray | None = None,
    base_params: InterpParams | None = None,
    parsimony: bool = True,
) -> dict:
    """Sweep neighborhood sizes via LOO x-val; per-region smallest k within
    one SE of the best MAE (``parsimony=False`` -> bare argmin).

    ``region_labels``: (S,) ints (e.g. climate-division ids); None = one
    global region. Returns {"best": {region: k}, "mae": {k: (12,)} , ...}.
    """
    base = base_params or InterpParams()
    if region_labels is None:
        region_labels = np.zeros(len(stn_lon), int)
    regions = np.unique(region_labels)

    mae_by_k = {}
    err_by_k = {}
    for k in candidates:
        p = dataclasses.replace(base, k_neighbors=int(k))
        sc = xval_interp_normals(
            stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm,
            stn_vario, stn_valid, p,
        )
        mae_by_k[int(k)] = sc.mae
        err_by_k[int(k)] = sc.per_station_err

    best = {}
    for r in regions:
        in_r = region_labels == r
        # per_station_err is NaN where a (station, month) was invalid or
        # its solve failed — score over the finite entries only; a region
        # with no usable entries for a candidate drops that candidate, and
        # with none at all falls back to the base k (an arbitrary argmin
        # over NaNs would silently pick the first candidate)
        scores = {}
        for k in mae_by_k:
            # aggregate to per-station MAE first: the station is the
            # independent unit for the 1-SE bar (a station's 12 month
            # errors share its location and are strongly correlated, so a
            # flat mean over station-months understates the SE ~3.5x)
            err = np.abs(err_by_k[k][in_r])
            fin = np.isfinite(err)
            cnt = fin.sum(axis=1)
            stn_mae = np.where(
                cnt > 0,
                np.where(fin, err, 0.0).sum(axis=1) / np.maximum(cnt, 1),
                np.nan,
            )
            ms = _mean_se(stn_mae)
            if ms is not None:
                scores[k] = ms
        best[int(r)] = _pick_k(scores, int(base.k_neighbors), parsimony)
    return {"best": best, "mae": mae_by_k, "per_station_err": err_by_k}


def optimize_nnghs_anoms(
    stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm, stn_vario,
    stn_valid, stn_anoms, month_idx,
    candidates=(8, 16, 24, 32),
    region_labels: np.ndarray | None = None,
    base_params: InterpParams | None = None,
    parsimony: bool = True,
) -> dict:
    """Sweep the ANOMALY (GWR daily) neighborhood size via daily LOO x-val,
    holding the normals k fixed — the reference tunes the two sizes with
    separate jobs (mpi_optim_nstns_norms vs mpi_optim_nstns_anoms,
    SURVEY §2.16). Per-region smallest k within one SE of the best
    per-station daily MAE (``parsimony=False`` -> bare argmin).

    Returns {"best": {region: ka}, "mae": {ka: float},
    "per_station_mae": {ka: (S,)}}.
    """
    base = base_params or InterpParams()
    if region_labels is None:
        region_labels = np.zeros(len(stn_lon), int)
    regions = np.unique(region_labels)

    mae_by_k = {}
    stn_mae_by_k = {}
    for ka in candidates:
        # gains use a prefix of the normals neighborhood, so ka > k would
        # silently clamp — make the sweep honest about the usable range
        ka_eff = min(int(ka), base.k_neighbors)
        p = dataclasses.replace(base, k_neighbors_anom=ka_eff)
        sc = xval_interp_daily(
            stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm,
            stn_vario, stn_valid, stn_anoms, month_idx, p,
        )
        mae_by_k[int(ka)] = sc["mae"]
        stn_mae_by_k[int(ka)] = sc["per_station_mae"]

    best = {}
    for r in regions:
        in_r = region_labels == r
        # NaN per-station MAEs mark stations invalid or unsolved in some
        # month — same finite-only scoring + fallback as optimize_nnghs
        scores = {}
        for k in stn_mae_by_k:
            ms = _mean_se(stn_mae_by_k[k][in_r])
            if ms is not None:
                scores[k] = ms
        best[int(r)] = _pick_k(
            scores, min(base.k_neighbors_anom, base.k_neighbors), parsimony
        )
    return {"best": best, "mae": mae_by_k, "per_station_mae": stn_mae_by_k}
