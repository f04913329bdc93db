"""Great-circle distances, batched for the device.

Parity target: the distance computations backing
``twx/interp/station_select.py::StationSelect`` (SURVEY.md §2.10) — the
reference computes per-point station distances with a haversine-style formula
on host numpy; here they are jittable and batched (cells x stations), which is
the shape the tile engine feeds the device.

All inputs in degrees; outputs in kilometres.
"""

from __future__ import annotations

import jax.numpy as jnp

EARTH_RADIUS_KM = 6371.0087714  # IUGG mean earth radius


def great_circle_km(lon1, lat1, lon2, lat2):
    """Elementwise haversine distance in km. Broadcasts like jnp ops.

    Haversine is numerically stable for small angles (unlike the spherical
    law of cosines), which matters in f32 for ~1 km station spacing.
    """
    lon1, lat1, lon2, lat2 = (jnp.deg2rad(x) for x in (lon1, lat1, lon2, lat2))
    dlon = lon2 - lon1
    dlat = lat2 - lat1
    a = jnp.sin(dlat / 2.0) ** 2 + jnp.cos(lat1) * jnp.cos(lat2) * jnp.sin(dlon / 2.0) ** 2
    # Clamp for f32 roundoff before sqrt/asin.
    a = jnp.clip(a, 0.0, 1.0)
    return 2.0 * EARTH_RADIUS_KM * jnp.arcsin(jnp.sqrt(a))


def pairwise_great_circle_km(lon_a, lat_a, lon_b, lat_b):
    """(A,) x (B,) -> (A, B) distance matrix in km.

    Chord-difference form on the unit-sphere embedding:
        d = 2 R asin(||p_a - p_b|| / 2).
    The coordinate *difference* is computed directly (never via the
    1 - cos(theta) dot product), so there is no catastrophic cancellation for
    nearby points: absolute error is ~2 m in f32 at any separation. The dot
    form was measured to lose ~km-scale accuracy under JAX's default reduced
    matmul precision and is unusable for <10 km station spacing; this op is
    bandwidth-bound either way (a few FLOPs per pair), so skipping the
    matmul loses nothing (see tests/test_geo.py precision checks).
    """
    pa = _unit_xyz(lon_a, lat_a)  # (A, 3)
    pb = _unit_xyz(lon_b, lat_b)  # (B, 3)
    return pairwise_km_from_xyz(pa, pb)


def unit_xyz(lon, lat):
    """Unit-sphere embedding (..., 3) of lon/lat degrees. Precomputed once per
    station pool so neighborhood pair distances are gathers + one matmul."""
    return _unit_xyz(lon, lat)


def pairwise_km_from_xyz(xyz_a, xyz_b):
    """(..., A, 3) x (..., B, 3) -> (..., A, B) great-circle km.

    Stable chord-difference form (see pairwise_great_circle_km). The three
    broadcasted difference planes fuse into one elementwise pass under XLA.
    """
    d2 = None
    for i in range(3):
        diff = xyz_a[..., :, None, i] - xyz_b[..., None, :, i]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    half_chord = 0.5 * jnp.sqrt(d2)
    return 2.0 * EARTH_RADIUS_KM * jnp.arcsin(jnp.clip(half_chord, 0.0, 1.0))


def _unit_xyz(lon, lat):
    lon = jnp.deg2rad(jnp.asarray(lon))
    lat = jnp.deg2rad(jnp.asarray(lat))
    cl = jnp.cos(lat)
    return jnp.stack([cl * jnp.cos(lon), cl * jnp.sin(lon), jnp.sin(lat)], axis=-1)
