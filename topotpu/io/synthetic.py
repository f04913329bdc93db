"""Synthetic station network + covariate world generator.

No real GHCN/SNOTEL/MODIS data ships with this environment (SURVEY.md §7
step 1), so every test and benchmark runs on a synthetic but physically
structured world:

* a DEM built from smoothed random ridges (drives the lapse-rate signal),
* a TDI (topographic dissection) raster derived from the DEM,
* 12 monthly LST rasters = seasonal cycle + elevation coupling + noise,
* stations sampled at random land cells, monthly normals generated from a
  *known* linear covariate model + a Gaussian-process residual field with a
  *known* exponential variogram (so kriging has a recoverable ground truth),
* daily anomalies from an AR(1) synoptic process shared across stations with
  distance-decaying spatial correlation.

The generator intentionally mirrors the statistical model the interpolator
assumes, making BASELINE config #1's accuracy check meaningful (can we
recover the truth field within the kriging variance?).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from topotpu.core.grid import GridSpec
from topotpu.oracle.numpy_ref import haversine_km


@dataclasses.dataclass
class SyntheticWorld:
    grid: GridSpec
    elev: np.ndarray      # (nrows, ncols) m
    tdi: np.ndarray       # (nrows, ncols)
    lst: np.ndarray       # (12, nrows, ncols) deg C
    landmask: np.ndarray  # (nrows, ncols) bool
    # stations
    stn_lon: np.ndarray
    stn_lat: np.ndarray
    stn_elev: np.ndarray
    stn_tdi: np.ndarray
    stn_lst: np.ndarray   # (S, 12)
    stn_norm: np.ndarray  # (S, 12) true monthly normals at stations
    stn_anoms: np.ndarray  # (S, ndays) daily anomalies
    # ground truth for scoring
    true_vario: tuple     # (nugget, psill, range_km) of the residual GP
    trend_coef: np.ndarray
    resid_field_fn: object  # callable (lon, lat) -> GP residual (exact, via conditioning)
    ndays: int
    # callable (lon, lat) -> (N, ndays) noise-free daily-anomaly field (the
    # synoptic modes evaluated at arbitrary points, per-point demeaned like
    # stn_anoms) — ground truth for daily-value spot checks; None on worlds
    # built before round 5
    anom_field_fn: object = None

    @property
    def n_stations(self) -> int:
        return self.stn_lon.shape[0]

    def true_normal(self, lon, lat, elev, tdi, lst_m, month):
        """Trend part of the true normal at arbitrary points + GP residual."""
        t = _trend(self.trend_coef, month, elev, tdi, lst_m)
        return t + self.resid_field_fn(lon, lat)


def tile_inputs_from_world(
    world: "SyntheticWorld",
    days_month_idx: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    dtype=np.float32,
    stn_vario: np.ndarray | None = None,
):
    """Build a device-facing TileInputs from a SyntheticWorld (shared by
    bench.py, chip_smoke.py and integration tests)."""
    import jax.numpy as jnp

    from topotpu.core.dates import DaysMetadata
    from topotpu.interp.point import TileInputs, month_layout, group_days_by_month

    lon, lat = world.grid.cell_lonlat(rows, cols)
    S = world.n_stations
    if stn_vario is None:
        nug, ps, rg = world.true_vario
        stn_vario = np.tile(np.array([nug, ps, rg], dtype=dtype), (S, 12, 1))

    # minimal DaysMetadata stand-in: layout only needs month_idx
    class _D:
        month_idx = days_month_idx
        ndays = len(days_month_idx)

    layout = month_layout(_D)
    anoms = group_days_by_month(world.stn_anoms.astype(dtype), layout)
    ti = TileInputs(
        cell_lon=jnp.asarray(lon, dtype),
        cell_lat=jnp.asarray(lat, dtype),
        cell_elev=jnp.asarray(world.elev[rows, cols], dtype),
        cell_tdi=jnp.asarray(world.tdi[rows, cols], dtype),
        cell_lst=jnp.asarray(world.lst[:, rows, cols].T, dtype),
        cell_mask=jnp.asarray(world.landmask[rows, cols]),
        stn_lon=jnp.asarray(world.stn_lon, dtype),
        stn_lat=jnp.asarray(world.stn_lat, dtype),
        stn_elev=jnp.asarray(world.stn_elev, dtype),
        stn_tdi=jnp.asarray(world.stn_tdi, dtype),
        stn_lst=jnp.asarray(world.stn_lst, dtype),
        stn_norm=jnp.asarray(world.stn_norm, dtype),
        stn_vario=jnp.asarray(stn_vario, dtype),
        stn_valid=jnp.ones((S, 12), bool),
        stn_anoms=jnp.asarray(np.moveaxis(anoms, 1, 0), dtype),
    )
    return ti, layout


def _smooth2d(a: np.ndarray, iters: int = 12) -> np.ndarray:
    """Cheap separable box smoothing (no scipy dependency needed on host)."""
    for _ in range(iters):
        a = 0.25 * (
            np.roll(a, 1, 0) + np.roll(a, -1, 0) + np.roll(a, 1, 1) + np.roll(a, -1, 1)
        )
    return a


def _trend(coef, month, elev, tdi, lst_m):
    lapse, tdi_c, lst_c, const = coef
    seasonal = 10.0 * np.cos((month - 6.5) * np.pi / 6.0)
    return const + seasonal + lapse * elev + tdi_c * tdi + lst_c * lst_m


def make_world(
    rng: np.random.Generator,
    nrows: int = 100,
    ncols: int = 100,
    n_stations: int = 200,
    ndays: int = 365,
    lon_min: float = -106.0,
    lat_max: float = 41.0,
    cellsize: float = 1.0 / 120.0,
    vario=(0.05, 1.0, 40.0),
    ocean_frac: float = 0.0,
) -> SyntheticWorld:
    grid = GridSpec(
        lon0=lon_min + cellsize / 2,
        lat0=lat_max - cellsize / 2,
        cellsize=cellsize,
        nrows=nrows,
        ncols=ncols,
    )
    lon_g, lat_g = grid.lonlat_grids()

    elev = _smooth2d(rng.normal(size=(nrows, ncols)), 15)
    elev = 1500.0 + 2500.0 * (elev - elev.min()) / (np.ptp(elev) + 1e-9)
    gy, gx = np.gradient(elev)
    tdi = _smooth2d(np.abs(gx) + np.abs(gy), 4)
    tdi = (tdi - tdi.mean()) / (tdi.std() + 1e-9)

    months = np.arange(1, 13)
    lst = np.stack(
        [
            8.0 * np.cos((m - 7) * np.pi / 6.0)
            - 0.0055 * elev
            + 15.0
            + 0.5 * _smooth2d(rng.normal(size=(nrows, ncols)), 8)
            for m in months
        ]
    )

    landmask = np.ones((nrows, ncols), bool)
    if ocean_frac > 0:
        blob = _smooth2d(rng.normal(size=(nrows, ncols)), 20)
        landmask = blob > np.quantile(blob, ocean_frac)

    # --- stations at random land cells ---
    land_idx = np.flatnonzero(landmask.ravel())
    if n_stations > land_idx.size:
        raise ValueError(
            f"n_stations={n_stations} exceeds the {land_idx.size} land cells "
            f"of a {nrows}x{ncols} grid at ocean_frac={ocean_frac}; "
            f"raise --grid (or lower --stations)"
        )
    pick = rng.choice(land_idx, size=n_stations, replace=False)
    rr, cc = np.unravel_index(pick, (nrows, ncols))
    stn_lon, stn_lat = grid.cell_lonlat(rr, cc)
    # de-grid jitter so stations aren't exactly at cell centers
    stn_lon = stn_lon + rng.uniform(-0.4, 0.4, n_stations) * cellsize
    stn_lat = stn_lat + rng.uniform(-0.4, 0.4, n_stations) * cellsize
    stn_elev = elev[rr, cc] + rng.normal(0, 10, n_stations)
    stn_tdi = tdi[rr, cc]
    stn_lst = lst[:, rr, cc].T  # (S, 12)

    # --- true normals: linear trend + GP residual with known variogram ---
    trend_coef = np.array([-0.0065, -0.8, 0.35, 12.0])  # lapse, tdi, lst, const
    nugget, psill, rng_km = vario
    d = haversine_km(
        stn_lon[:, None], stn_lat[:, None], stn_lon[None, :], stn_lat[None, :]
    )
    cov = psill * np.exp(-d / rng_km)
    np.fill_diagonal(cov, psill + nugget)
    Lc = np.linalg.cholesky(cov + 1e-9 * np.eye(n_stations))
    resid_stn = Lc @ rng.normal(size=n_stations)  # one shared residual field

    stn_norm = np.stack(
        [
            _trend(trend_coef, m, stn_elev, stn_tdi, stn_lst[:, m - 1]) + resid_stn
            for m in months
        ],
        axis=1,
    )

    # Conditional-mean GP evaluator for scoring at arbitrary points (exact
    # simple-kriging conditioning on the station residuals, float64).
    cov_inv_resid = np.linalg.solve(cov, resid_stn)

    def resid_field_fn(lon, lat):
        dq = haversine_km(
            np.atleast_1d(lon)[:, None],
            np.atleast_1d(lat)[:, None],
            stn_lon[None, :],
            stn_lat[None, :],
        )
        return (psill * np.exp(-dq / rng_km)) @ cov_inv_resid

    # --- daily anomalies: spatially correlated AR(1) synoptics ---
    n_modes = 8
    centers = rng.uniform(
        [stn_lon.min(), stn_lat.min()], [stn_lon.max(), stn_lat.max()], (n_modes, 2)
    )
    dmode = haversine_km(
        stn_lon[:, None], stn_lat[:, None], centers[None, :, 0], centers[None, :, 1]
    )
    loadings = np.exp(-dmode / 120.0)  # (S, n_modes)
    phi = 0.75
    z = np.zeros((ndays, n_modes))
    eps = rng.normal(size=(ndays, n_modes)) * 2.0
    for t in range(1, ndays):
        z[t] = phi * z[t - 1] + eps[t]
    z[0] = eps[0]
    stn_anoms = (loadings @ z.T) + 0.3 * rng.normal(size=(n_stations, ndays))
    # anomalies must be zero-mean per station-month by construction; enforce
    stn_anoms -= stn_anoms.mean(axis=1, keepdims=True)

    def anom_field_fn(lon, lat):
        """Noise-free synoptic anomaly field at arbitrary points (same
        mode loadings + AR(1) series the stations sampled, same per-point
        demeaning; excludes the 0.3 C station noise) — daily-value ground
        truth for spot checks. Pure closure over already-drawn (centers,
        z): adds no rng draws, so worlds regenerate bit-identically."""
        dq = haversine_km(
            np.atleast_1d(lon)[:, None], np.atleast_1d(lat)[:, None],
            centers[None, :, 0], centers[None, :, 1],
        )
        a = np.exp(-dq / 120.0) @ z.T  # (N, ndays)
        return a - a.mean(axis=1, keepdims=True)

    return SyntheticWorld(
        grid=grid,
        elev=elev,
        tdi=tdi,
        lst=lst,
        landmask=landmask,
        stn_lon=stn_lon,
        stn_lat=stn_lat,
        stn_elev=stn_elev,
        stn_tdi=stn_tdi,
        stn_lst=stn_lst,
        stn_norm=stn_norm,
        stn_anoms=stn_anoms,
        true_vario=vario,
        trend_coef=trend_coef,
        resid_field_fn=resid_field_fn,
        ndays=ndays,
        anom_field_fn=anom_field_fn,
    )
