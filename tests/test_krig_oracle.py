"""The XLA normals-kriging chain (``interp.normals``) against the float64
oracle (``oracle/pipeline.py``), per neighborhood size and weight kernel.

The oracle solves the augmented Lagrange system with LU in float64 over the
same neighborhoods; the device chain is the SPD simple-kriging reduction in
float32. Agreement to ~1e-2 C on normals is the f32 solve-chain budget."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from topotpu.geo.distance import unit_xyz
from topotpu.geo.neighbors import select_neighbors
from topotpu.interp.normals import krig_normals, krig_normals_and_gains
from topotpu.io.synthetic import make_world
from topotpu.oracle.numpy_ref import haversine_km
from topotpu.oracle.pipeline import centered_wls_gain, krige_normal

KERNELS = ("bisquare", "gaussian", "uniform")
N_STN = 90


@pytest.fixture(scope="module")
def world():
    return make_world(np.random.default_rng(21), nrows=30, ncols=30,
                      n_stations=N_STN, ndays=30)


def _gathered(world, k, C=16, valid=None, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 30, C)
    cols = rng.integers(0, 30, C)
    lon, lat = world.grid.cell_lonlat(rows, cols)
    if valid is None:
        valid = np.ones(N_STN, bool)
        valid[5] = False
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    nbr = select_neighbors(f32(lon), f32(lat), f32(world.stn_lon),
                           f32(world.stn_lat), jnp.asarray(valid), k=k)
    vario = np.stack([rng.uniform(0.03, 0.2, N_STN),
                      rng.uniform(0.6, 1.4, N_STN),
                      rng.uniform(25.0, 60.0, N_STN)], -1)
    stn_cov = np.stack([world.stn_elev, world.stn_tdi, world.stn_lst[:, 0]], -1)
    stn_anom_cov = np.stack([world.stn_elev, world.stn_lon * 85.0,
                             world.stn_lat * 111.32], -1)
    cell_cov = np.stack([world.elev[rows, cols], world.tdi[rows, cols],
                         world.lst[0, rows, cols]], -1)
    cell_anom_cov = np.stack([world.elev[rows, cols], lon * 85.0,
                              lat * 111.32], -1)
    take = lambda a: jnp.take(f32(a), nbr.idx, axis=0)  # noqa: E731
    args = dict(
        dist=nbr.dist, mask=nbr.mask,
        nbr_xyz=jnp.take(unit_xyz(f32(world.stn_lon), f32(world.stn_lat)),
                         nbr.idx, axis=0),
        nbr_cov=take(stn_cov), cell_cov=f32(cell_cov),
        nbr_norm=take(world.stn_norm[:, 0]), nbr_vario=take(vario),
    )
    host = dict(lon=lon, lat=lat, idx=np.asarray(nbr.idx),
                mask=np.asarray(nbr.mask), stn_cov=stn_cov,
                cell_cov=cell_cov, vario=vario,
                stn_anom_cov=stn_anom_cov, cell_anom_cov=cell_anom_cov)
    return args, host, (take(stn_anom_cov), f32(cell_anom_cov))


def _oracle(world, host, kernel, i):
    s = host["idx"][i][host["mask"][i]]
    d0 = haversine_km(host["lon"][i], host["lat"][i],
                      world.stn_lon[s], world.stn_lat[s])
    dp = haversine_km(world.stn_lon[s][:, None], world.stn_lat[s][:, None],
                      world.stn_lon[s][None, :], world.stn_lat[s][None, :])
    np.fill_diagonal(dp, 0.0)
    return s, krige_normal(d0, dp, host["stn_cov"][s], host["cell_cov"][i],
                           world.stn_norm[s, 0], host["vario"][s],
                           weight_kernel=kernel, jitter_frac=1e-5)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("k", [8, 16, 32, 48, 64])
def test_krig_normals_matches_f64_oracle(world, k, kernel):
    args, host, _ = _gathered(world, k)
    res = jax.jit(lambda a: krig_normals(**a, weight_kernel=kernel))(args)
    assert np.asarray(res.ok).all()
    for i in range(len(host["lon"])):
        _, want = _oracle(world, host, kernel, i)
        np.testing.assert_allclose(float(res.normal[i]), want["normal"],
                                   atol=1e-2, rtol=1e-4)
        np.testing.assert_allclose(float(res.trend[i]), want["trend"],
                                   atol=1e-2, rtol=1e-4)
        np.testing.assert_allclose(float(res.variance[i]), want["variance"],
                                   atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(np.asarray(res.vario[i]), want["vario"],
                                   rtol=1e-3)


def test_krig_normals_flags_underpopulated(world):
    """Fewer valid stations than min_neighbors: ok is False and the normal
    stays finite (masked slots are inert)."""
    valid = np.zeros(N_STN, bool)
    valid[:2] = True
    args, _, _ = _gathered(world, 16, valid=valid)
    res = krig_normals(**args, min_neighbors=3)
    assert not np.asarray(res.ok).any()
    assert np.asarray(args["mask"]).sum(1).max() == 2
    assert np.isfinite(np.asarray(res.normal)).all()


@pytest.mark.parametrize("kernel", KERNELS)
def test_normals_and_gains_match_oracle(world, kernel):
    """Anomaly-GWR gain rows over the normals' own neighborhoods."""
    args, host, (anom_cov, cell_anom_cov) = _gathered(world, 24)
    res, gains = krig_normals_and_gains(
        **args, anom_cov=anom_cov, cell_anom_cov=cell_anom_cov,
        weight_kernel=kernel,
    )
    gains = np.asarray(gains)
    for i in range(len(host["lon"])):
        s, want = _oracle(world, host, kernel, i)
        g = centered_wls_gain(host["stn_anom_cov"][s],
                              host["cell_anom_cov"][i], want["weights"])
        np.testing.assert_allclose(gains[i][host["mask"][i]], g, atol=2e-4)
        np.testing.assert_allclose(float(res.normal[i]), want["normal"],
                                   atol=1e-2, rtol=1e-4)
    # gains reproduce constants (sum to 1 with an intercept design)
    np.testing.assert_allclose(gains.sum(-1), 1.0, atol=2e-3)
