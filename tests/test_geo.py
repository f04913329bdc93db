import numpy as np
import jax.numpy as jnp

from topotpu.geo import (
    great_circle_km,
    pairwise_great_circle_km,
    select_neighbors,
    distance_weights,
)
from topotpu.oracle import numpy_ref as oracle


def test_great_circle_matches_oracle(rng):
    lon1 = rng.uniform(-125, -66, 64)
    lat1 = rng.uniform(24, 50, 64)
    lon2 = rng.uniform(-125, -66, 64)
    lat2 = rng.uniform(24, 50, 64)
    got = np.asarray(great_circle_km(lon1, lat1, lon2, lat2))
    want = oracle.haversine_km(lon1, lat1, lon2, lat2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)


def test_pairwise_matches_elementwise(rng):
    lon_a = rng.uniform(-110, -100, 10)
    lat_a = rng.uniform(30, 45, 10)
    lon_b = rng.uniform(-110, -100, 17)
    lat_b = rng.uniform(30, 45, 17)
    got = np.asarray(pairwise_great_circle_km(lon_a, lat_a, lon_b, lat_b))
    want = oracle.haversine_km(
        lon_a[:, None], lat_a[:, None], lon_b[None, :], lat_b[None, :]
    )
    # chord formulation in f32 vs f64 haversine: sub-100m agreement at CONUS scales
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.1)


def test_select_neighbors_orders_and_masks(rng):
    stn_lon = rng.uniform(-105, -100, 40)
    stn_lat = rng.uniform(38, 42, 40)
    valid = np.ones(40, bool)
    valid[5] = False
    nb = select_neighbors(
        jnp.array([-102.5]), jnp.array([40.0]), stn_lon, stn_lat, valid, k=8
    )
    assert nb.idx.shape == (1, 8)
    d = np.asarray(nb.dist[0])
    assert np.all(np.diff(d) >= -1e-6)  # sorted ascending
    assert 5 not in np.asarray(nb.idx[0])  # invalid station excluded
    # brute-force nearest check
    dd = oracle.haversine_km(-102.5, 40.0, stn_lon, stn_lat)
    dd[5] = np.inf
    want_idx = np.argsort(dd)[:8]
    assert set(np.asarray(nb.idx[0]).tolist()) == set(want_idx.tolist())


def test_select_neighbors_pads_when_scarce(rng):
    stn_lon = rng.uniform(-105, -100, 5)
    stn_lat = rng.uniform(38, 42, 5)
    valid = np.array([True, True, True, False, False])
    nb = select_neighbors(
        jnp.array([-102.0]), jnp.array([40.0]), stn_lon, stn_lat, valid, k=8
    )
    assert int(nb.mask.sum()) == 3
    assert np.all(np.asarray(nb.dist)[~np.asarray(nb.mask)] == 0.0)


def test_exclude_self(rng):
    stn_lon = rng.uniform(-105, -100, 30)
    stn_lat = rng.uniform(38, 42, 30)
    valid = np.ones(30, bool)
    # query exactly at station 7
    nb = select_neighbors(
        jnp.array([stn_lon[7]]),
        jnp.array([stn_lat[7]]),
        stn_lon,
        stn_lat,
        valid,
        k=5,
        exclude_self_km=0.5,
    )
    assert 7 not in np.asarray(nb.idx[0])[np.asarray(nb.mask[0])]


def test_exclude_idx_matches_threshold_loo(rng):
    """Identity-index LOO (cheap cos-matmul branch) must select the same
    neighborhoods as the legacy km-threshold LOO (exact-distance branch) —
    the branch swap that removed the (S, S) exact-trig program from the
    krig-params / x-val drivers must be a pure mechanism change."""
    S, k = 120, 12
    stn_lon = rng.uniform(-115, -95, S)
    stn_lat = rng.uniform(32, 46, S)
    valid = np.ones(S, bool)
    valid[rng.integers(0, S, 10)] = False
    old = select_neighbors(
        stn_lon, stn_lat, stn_lon, stn_lat, valid, k=k, exclude_self_km=1e-3
    )
    new = select_neighbors(
        stn_lon, stn_lat, stn_lon, stn_lat, valid, k=k,
        exclude_idx=jnp.arange(S),
    )
    np.testing.assert_array_equal(np.asarray(old.mask), np.asarray(new.mask))
    m = np.asarray(new.mask)
    # same members in the same (distance-sorted) order: random CONUS-scale
    # spacing is far above the f32 cos-score ordering fuzz
    np.testing.assert_array_equal(
        np.asarray(old.idx)[m], np.asarray(new.idx)[m]
    )
    np.testing.assert_allclose(
        np.asarray(old.dist)[m], np.asarray(new.dist)[m], rtol=1e-5, atol=1e-3
    )
    # self never appears in its own neighborhood
    assert not ((np.asarray(new.idx) == np.arange(S)[:, None]) & m).any()


def test_exclude_idx_exact_branch(rng):
    """exclude_idx composes with a precomputed exact distance matrix too."""
    S, k = 40, 6
    stn_lon = rng.uniform(-105, -100, S)
    stn_lat = rng.uniform(38, 42, S)
    valid = np.ones(S, bool)
    dmat = pairwise_great_circle_km(stn_lon, stn_lat, stn_lon, stn_lat)
    nb = select_neighbors(
        stn_lon, stn_lat, stn_lon, stn_lat, valid, k=k,
        dist_matrix=dmat, exclude_idx=jnp.arange(S),
    )
    idx = np.asarray(nb.idx)
    mask = np.asarray(nb.mask)
    assert mask.all()
    assert not (idx == np.arange(S)[:, None]).any()


def test_distance_weights_masked_zero(rng):
    dist = jnp.array([[0.0, 10.0, 50.0, 100.0]])
    mask = jnp.array([[True, True, True, False]])
    w = np.asarray(distance_weights(dist, mask, "bisquare"))
    assert w[0, 3] == 0.0
    assert np.all(np.diff(w[0, :3]) <= 0)  # decreasing with distance
    assert w[0, 0] > 0.9  # near-point weight ~ 1
