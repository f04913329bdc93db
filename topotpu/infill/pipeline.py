"""Station-series infilling pipeline.

Parity target: ``twx/infill/infill_daily.py`` + the ``bin/mpi_infill_stn_obs``
driver (SURVEY.md §2.8, §3.2): for every station needing serial completion,
build a predictor matrix from its most-correlated neighbor series, run PPCA
imputation over the joint matrix, post-adjust imputed variance, and emit a
serially-complete daily series plus estimated monthly normals.

Batched restructuring: the reference farms one station per MPI worker with
an R ppca call; here targets are processed in fixed-size device batches —
(B, T, V) tensors through one jitted EM loop (``topotpu.stats.ppca``), with
predictor selection done once on-device via a masked correlation matrix.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from topotpu.core.config import PPCAParams
from topotpu.stats.ppca import ppca_impute, variance_adjust


@dataclasses.dataclass
class InfillResult:
    filled: np.ndarray        # (S, T) serially complete series
    obs_mask: np.ndarray      # (S, T) original observation mask
    norms: np.ndarray         # (S, 12) monthly normals from filled series
    n_iters: np.ndarray       # (S,) EM iterations per target's batch
    predictors: np.ndarray    # (S, n_neighbors) chosen predictor indices
    bad: np.ndarray           # (S,) too few obs for a trustworthy infill


def select_predictors(
    obs: np.ndarray,
    mask: np.ndarray,
    n_neighbors: int,
    stn_lon: np.ndarray | None = None,
    stn_lat: np.ndarray | None = None,
) -> np.ndarray:
    """(S, n_neighbors) indices of the most-correlated predictor stations.

    Mirrors the reference's correlation-ranked neighbor selection
    (SURVEY.md §3.2 'corr-ranked serially-complete neighbors'). For sparse
    targets whose observation overlap is too short to estimate correlations
    (< 30 jointly-observed days), slots fall back to *nearest* stations when
    coordinates are given — otherwise such a target would get arbitrary
    predictors and unusable imputations (observed: 8 C MAE on a 95%-missing
    station before this fallback).

    Size-dependent backend: below ~2e11 gram FLOPs (e.g. 4000 stations x
    a year) the whole selection runs in host BLAS, where a device program
    would mostly pay its compile. Above the cutoff (production 1e4 stations
    x 25k days = ~1.5e13 FLOPs, hours of host BLAS) it is ONE device program
    that returns only the (S, n) index matrix — the (S, S) correlation never
    crosses the device->host link."""
    mu = np.nanmean(np.where(mask, obs, np.nan), axis=1)
    sd = np.nanstd(np.where(mask, obs, np.nan), axis=1) + 1e-6
    xs = np.where(mask, (obs - mu[:, None]) / sd[:, None], 0.0).astype(np.float32)
    S, T = xs.shape
    # a station can have at most S-1 distinct predictors; tiny networks
    # (tests, sparse regions) get the truncated matrix rather than a crash
    n_neighbors = min(int(n_neighbors), S - 1)

    if 6.0 * S * S * T < 2e11:
        m = mask.astype(np.float32)
        n = m @ m.T
        sx = xs @ m.T
        sxy = xs @ xs.T
        sxx = (xs * xs) @ m.T
        safe_n = np.maximum(n, 1.0)
        cov = sxy / safe_n - (sx / safe_n) * (sx.T / safe_n)
        vx = np.maximum(sxx / safe_n - (sx / safe_n) ** 2, 1e-12)
        score = np.abs(np.where(n < 30, 0.0, cov / np.sqrt(vx * vx.T)))
        if stn_lon is not None:
            from topotpu.oracle.numpy_ref import haversine_km

            d = haversine_km(
                stn_lon[:, None], stn_lat[:, None],
                stn_lon[None, :], stn_lat[None, :],
            )
            # proximity as a strictly-weaker tiebreak: any real
            # correlation wins over any pure-distance candidate
            prox = 1e-4 / (1.0 + d)
            score = np.where(score > 0, score + 1.0, prox)
        np.fill_diagonal(score, -1.0)  # never select self
        part = np.argpartition(-score, n_neighbors, axis=1)[:, :n_neighbors]
        rows = np.arange(S)[:, None]
        order = np.argsort(-score[rows, part], axis=1, kind="stable")
        return part[rows, order].astype(np.int32)

    if stn_lon is None:
        # degenerate coords: the distance tiebreak never beats a real
        # correlation, so zeros only affect the sparse-overlap fallback
        lon = np.zeros(len(obs), np.float32)
        lat = np.zeros(len(obs), np.float32)
    else:
        lon = np.asarray(stn_lon, np.float32)
        lat = np.asarray(stn_lat, np.float32)
    # mask ships as bool (1 B/entry) and widens on device: at production
    # scale an f32 mask would be ~400 MB of upload
    idx = _device_select_predictors(
        xs, mask, lon, lat, bool(stn_lon is not None), int(n_neighbors)
    )
    return np.asarray(idx, np.int32)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _device_select_predictors(xs, m, lon, lat, use_dist, n_neighbors):
    import jax.numpy as jnp

    m = m.astype(xs.dtype)

    # grams at full f32 fidelity: a TF32 dot perturbs
    # near-tied correlations enough to flip top-k ranks, which would make
    # the device path disagree with the host-BLAS path across the size
    # cutoff (same rationale as interp/normals.py's HI pinning)
    hi = jax.lax.Precision.HIGHEST
    mm = functools.partial(jnp.matmul, precision=hi)
    S = xs.shape[0]
    n = mm(m, m.T)
    sx = mm(xs, m.T)
    sy = sx.T
    sxy = mm(xs, xs.T)
    sxx = mm(xs * xs, m.T)
    syy = sxx.T
    safe_n = jnp.maximum(n, 1.0)
    cov = sxy / safe_n - (sx / safe_n) * (sy / safe_n)
    vx = jnp.maximum(sxx / safe_n - (sx / safe_n) ** 2, 1e-12)
    vy = jnp.maximum(syy / safe_n - (sy / safe_n) ** 2, 1e-12)
    corr = cov * jax.lax.rsqrt(vx * vy)
    score = jnp.abs(jnp.where(n < 30, 0.0, corr))
    if use_dist:
        from topotpu.geo.distance import pairwise_great_circle_km

        d = pairwise_great_circle_km(lon, lat, lon, lat)
        # proximity as a strictly-weaker tiebreak: any real correlation
        # wins over any pure-distance candidate
        prox = 1e-4 / (1.0 + d)
        score = jnp.where(score > 0, score + 1.0, prox)
    eye = jnp.eye(S, dtype=bool)
    score = jnp.where(eye, -1.0, score)  # never select self
    _, idx = jax.lax.top_k(score, n_neighbors)
    return idx.astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _infill_batch(obs_all, mask_all, cols, month_idx, n_comp, max_iters, tol):
    """Gather [target | predictors] series on device, impute, adjust.

    obs_all/mask_all are the full (S, T) station tensors, resident on the
    device across all batches; ``cols`` is the (B, V) station-index matrix
    for this batch (column 0 = target); rows are whole T-length series."""
    Y = obs_all[cols].transpose(0, 2, 1)   # (B, T, V)
    M = mask_all[cols].transpose(0, 2, 1)
    res = ppca_impute(
        Y, M, n_components=n_comp, max_iters=max_iters, tol=tol
    )
    tgt_filled = variance_adjust(
        res.filled[..., 0], mask_all[cols[:, 0]], month_idx
    )
    return tgt_filled, res.n_iters


def infill_network(
    obs: np.ndarray,
    month_idx: np.ndarray,
    params: PPCAParams,
    batch_size: int | None = None,
    stn_lon: np.ndarray | None = None,
    stn_lat: np.ndarray | None = None,
    min_obs_days: int = 365,
) -> InfillResult:
    """Serially complete an (S, T) obs matrix (NaN = missing).

    Processes targets in device batches of ``batch_size``; each target's
    predictor matrix is [target | n_neighbors correlated stations]. Stations
    with fewer than ``min_obs_days`` observations are still imputed but
    flagged ``bad`` (the reference's BAD station attribute, SURVEY.md §2.3) —
    downstream interpolation masks them out.
    """
    if batch_size is None:
        batch_size = params.batch_size
    S, T = obs.shape
    mask = np.isfinite(obs)
    obs0 = np.where(mask, obs, 0.0).astype(np.float32)
    preds = select_predictors(obs, mask, params.n_neighbors, stn_lon, stn_lat)
    bad = mask.sum(axis=1) < min(min_obs_days, T // 2)

    V = 1 + preds.shape[1]  # select_predictors clamps to S-1 on tiny pools
    filled = np.array(obs0, copy=True)
    n_iters = np.zeros(S, np.int32)

    # The (S, T) station tensors are uploaded ONCE and stay device-resident;
    # each batch ships only its (B, V) index matrix and the predictor gather
    # happens inside the jit. Host-side gather re-uploaded every predictor
    # series ~V times per variable — ~12.6 GB at 4000 stn x 69 yr vs
    # ~0.5 GB resident. Values are bitwise identical (f32 gather is exact).
    obs_dev = jax.device_put(obs0)
    mask_dev = jax.device_put(mask)
    midx_dev = jax.device_put(np.asarray(month_idx))
    n_comp = min(params.n_components, V - 1)

    pad_to = ((S + batch_size - 1) // batch_size) * batch_size
    # Each batch's EM while_loop runs until its SLOWEST element converges
    # (per-target freeze makes stragglers cheap but not free), so group
    # similar-difficulty targets together: order by missing-obs count.
    # Per-target results are batch-composition-independent (every op in
    # ppca_impute is elementwise over B), so this is pure scheduling.
    by_difficulty = np.argsort(mask.sum(axis=1), kind="stable").astype(np.int64)
    order = by_difficulty[np.arange(pad_to) % S]  # wrap padding targets

    pending: list[tuple[np.ndarray, tuple]] = []

    def _drain() -> None:
        tgt0, (tf, ni) = pending.pop(0)
        filled[tgt0] = np.asarray(tf)  # wrapped padding recomputes identically
        n_iters[tgt0] = np.asarray(ni)

    for start in range(0, pad_to, batch_size):
        tgt = order[start : start + batch_size]
        cols = np.concatenate([tgt[:, None], preds[tgt]], axis=1)  # (B, V)
        out = _infill_batch(
            obs_dev, mask_dev, jnp.asarray(cols), midx_dev,
            n_comp, params.max_iters, params.tol,
        )
        pending.append((tgt, out))
        # keep one batch in flight: the device computes batch i+1 while the
        # host pulls batch i's (B, T) result back over the link
        if len(pending) > 1:
            _drain()
    while pending:
        _drain()

    norms = monthly_normals(filled, month_idx)
    return InfillResult(
        filled=filled,
        obs_mask=mask,
        norms=norms,
        n_iters=n_iters,
        predictors=preds,
        bad=bad,
    )


def monthly_normals(series: np.ndarray, month_idx: np.ndarray) -> np.ndarray:
    """(S, T) complete series -> (S, 12) monthly normals."""
    out = np.zeros((series.shape[0], 12), series.dtype)
    for m in range(12):
        sel = month_idx == m
        out[:, m] = series[:, sel].mean(axis=1)
    return out
