"""Edge cases the production pipeline will eventually hit."""

import numpy as np
import jax
import jax.numpy as jnp

from topotpu.core.config import InterpParams
from topotpu.interp.point import interp_tile
from topotpu.io.synthetic import make_world, tile_inputs_from_world
from topotpu.core.dates import get_days_metadata


def _tile(rng, n_cells=64, n_stations=40, k=8):
    world = make_world(rng, nrows=16, ncols=16, n_stations=n_stations, ndays=62)
    days = get_days_metadata("2015-01-01", "2015-12-31")
    rows, cols = np.unravel_index(np.arange(n_cells), (16, 16))
    ti, _ = tile_inputs_from_world(world, days.month_idx[:62], rows, cols)
    return ti, InterpParams(k_neighbors=k)


def test_per_month_validity_variation(rng):
    """The general (non-shared-validity) path: different stations valid in
    different months must change neighborhoods month by month."""
    ti, params = _tile(rng)
    valid = np.ones((40, 12), bool)
    valid[:20, 3] = False   # half the network missing in April
    valid[20:, 9] = False   # the other half missing in October
    ti = ti._replace(stn_valid=jnp.asarray(valid))
    res = interp_tile(ti, params, shared_validity=False)
    assert np.isfinite(np.asarray(res.normal)).all()
    # April and October used disjoint station halves -> normals must differ
    # from a run where everything was valid
    res_all = interp_tile(ti._replace(stn_valid=jnp.ones((40, 12), bool)), params)
    d_apr = np.abs(np.asarray(res.normal[3]) - np.asarray(res_all.normal[3]))
    assert d_apr.max() > 0.01


def test_shared_validity_flag_equivalence(rng):
    """With truly month-invariant validity the fast path must match the
    general path exactly (same selected neighborhoods)."""
    ti, params = _tile(rng)
    r1 = interp_tile(ti, params, shared_validity=False)
    r2 = interp_tile(ti, params, shared_validity=True)
    np.testing.assert_allclose(
        np.asarray(r1.normal), np.asarray(r2.normal), atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(r1.ok), np.asarray(r2.ok))


def test_colocated_stations_survive(rng):
    """Duplicate station coordinates make the covariance singular up to the
    nugget/jitter — the solve must stay finite and masked-sane."""
    ti, params = _tile(rng)
    lon = np.asarray(ti.stn_lon).copy()
    lat = np.asarray(ti.stn_lat).copy()
    lon[1] = lon[0]
    lat[1] = lat[0]   # exact co-location
    ti = ti._replace(stn_lon=jnp.asarray(lon), stn_lat=jnp.asarray(lat))
    res = interp_tile(ti, params)
    assert np.isfinite(np.asarray(res.normal)).all()
    assert np.isfinite(np.asarray(res.se)).all()


def test_interp_points_facade(rng):
    # The reference's PtInterpTair interpolated arbitrary points; the
    # facade must reproduce station values when asked to predict AT
    # station sites (nearest neighbor is the site itself at distance ~0).
    from topotpu.dist.engine import StationSet
    from topotpu.interp.point import interp_points, ungroup_days

    world = make_world(rng, nrows=24, ncols=24, n_stations=40, ndays=31)
    days = get_days_metadata("2015-01-01", "2015-01-31")
    nug, ps, rg = world.true_vario
    stations = StationSet(
        lon=world.stn_lon, lat=world.stn_lat, elev=world.stn_elev,
        tdi=world.stn_tdi, lst=world.stn_lst, norm=world.stn_norm,
        vario=np.tile(np.array([nug, ps, rg], np.float32),
                      (world.n_stations, 12, 1)),
        valid=np.ones((world.n_stations, 12), bool),
        anoms=world.stn_anoms.astype(np.float32),
    )
    pts = slice(0, 16)
    res, layout = interp_points(
        world.stn_lon[pts], world.stn_lat[pts], world.stn_elev[pts],
        world.stn_tdi[pts], world.stn_lst[pts], stations, days,
        InterpParams(k_neighbors=8),
    )
    normal = np.asarray(res.normal)          # (12, 16)
    assert np.asarray(res.ok).all()
    # at a station site the kriged normal should be close to the station's
    d = np.abs(normal.T - world.stn_norm[pts])
    assert d.mean() < 0.2, d.mean()
    # calendar-ordered dailies recoverable and month-mean ~ January normal
    daily = ungroup_days(
        np.asarray(res.daily).transpose(1, 0, 2), layout
    )  # (16, 31)
    assert daily.shape == (16, 31)
    assert np.abs(daily.mean(axis=1) - normal[0]).mean() < 1.0


def test_make_world_rejects_station_overflow(rng):
    # more stations than land cells must raise an actionable message, not
    # numpy's generic sample-size ValueError (hit live at 10k stn / 96 grid)
    import pytest

    with pytest.raises(ValueError, match="land cells"):
        make_world(rng, nrows=8, ncols=8, n_stations=100, ndays=31)
