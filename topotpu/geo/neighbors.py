"""Static-shape kNN station neighborhoods.

Parity target: ``twx/interp/station_select.py::StationSelect`` (SURVEY.md
§2.10). The reference grows a search radius per point until ``nnghs`` stations
are found, one point at a time, on host. Rebuilt for batched devices:

* one (cells x stations) distance matrix per tile (one matmul on unit-sphere
  embeddings, see ``geo.distance``),
* ``jax.lax.top_k`` for the k nearest — a fixed k so every tile shares one
  compiled shape (the SURVEY §7 static-shape commitment),
* invalid / monthly-masked stations pushed to +inf distance; a boolean
  neighborhood mask carries validity downstream so a masked station can never
  perturb the kriging mean or variance (tested algebraically).

Distance weighting mirrors the reference's GWR kernels: adaptive-bandwidth
bisquare (bandwidth = distance to the k-th neighbor) or gaussian.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from topotpu.geo.distance import (
    pairwise_great_circle_km,
    pairwise_km_from_xyz,
    unit_xyz,
)

_INF = jnp.inf
_RERANK = 8  # cos-branch candidates beyond k, re-ranked by exact distance


class Neighborhood(NamedTuple):
    """Per-cell padded neighborhoods. All arrays (ncells, k)."""

    idx: jnp.ndarray   # int32 station indices into the tile station pool
    dist: jnp.ndarray  # km; 0 where masked
    mask: jnp.ndarray  # bool; False entries carry no weight anywhere downstream


def select_neighbors(
    cell_lon: jnp.ndarray,
    cell_lat: jnp.ndarray,
    stn_lon: jnp.ndarray,
    stn_lat: jnp.ndarray,
    stn_valid: jnp.ndarray,
    k: int,
    exclude_self_km: float = 0.0,
    dist_matrix: jnp.ndarray | None = None,
    cos_matrix: jnp.ndarray | None = None,
    exclude_idx: jnp.ndarray | None = None,
) -> Neighborhood:
    """k nearest valid stations for each cell.

    Args:
      cell_lon/cell_lat: (ncells,) query points.
      stn_lon/stn_lat: (nstn,) station pool (tile-local, padded).
      stn_valid: (nstn,) bool — False for padding or monthly-invalid stations.
      k: neighborhood size (static).
      exclude_self_km: if > 0, stations within this distance of the query are
        excluded — a leave-one-out mode for queries that are NOT pool members
        (needs the exact-distance branch; see exclude_idx for the cheap
        identity form the LOO drivers use).
      dist_matrix: optional precomputed (C, S) distances — callers that
        select per-month neighborhoods from the same geometry (the tile
        facade) compute it once instead of 12 times.
      exclude_idx: (ncells,) int — per-query station index excluded from its
        own neighborhood. The leave-one-out mode used when the queries ARE
        the station pool (cross-validation and the per-station
        variogram-parameter build, SURVEY.md §3.3): identity is known by
        index, so no metric resolution is needed and the cheap cos-matmul
        branch stays usable — the exact (S, S) trig program the km-threshold
        form forces grows superlinearly with the network (config #7 runs
        10^4 stations).

    Returns a Neighborhood with masked padding where fewer than k valid
    stations exist.
    """
    S = stn_lon.shape[0]
    # exclude_self needs exact metric resolution (~1 m) that the cheap
    # cos metric cannot provide — silently dropping it would make every
    # x-val station its own nearest neighbor (errors collapse to ~0)
    assert not (cos_matrix is not None and exclude_self_km > 0.0), (
        "exclude_self_km requires the exact-distance branch; pass "
        "dist_matrix (or neither matrix), not cos_matrix"
    )
    if cos_matrix is not None or (dist_matrix is None and exclude_self_km == 0.0):
        # Cheap selection metric: cosine similarity on the unit-sphere
        # embedding — one matmul instead of 33M trig evaluations. Near
        # 1.0, f32 cos resolves distance only to ~100 m at tens of km, so
        # cos picks k + _RERANK candidates and the exact chord distance of
        # the exact branch ranks them: the neighborhoods are those of the
        # exact branch. The exclude_self mode needs metric resolution at
        # ~1 m over the whole pool — that mode takes the exact branch.
        pa = unit_xyz(cell_lon, cell_lat)
        pb = unit_xyz(stn_lon, stn_lat)
        if cos_matrix is None:
            # HIGHEST: a TF32 dot (~1e-3 relative) is coarser than 1 - cos
            # between stations 100 km apart (~1.2e-4).
            cos_matrix = jnp.dot(
                pa, pb.T, preferred_element_type=jnp.float32,
                precision=lax.Precision.HIGHEST,
            )
        score = jnp.where(stn_valid[None, :], cos_matrix, -jnp.inf)
        if exclude_idx is not None:  # identity-exclusion LOO (exact, cheap)
            score = jnp.where(
                jnp.arange(S)[None, :] == exclude_idx[:, None], -jnp.inf,
                score,
            )
        if score.shape[-1] < k:
            pad = jnp.full(score.shape[:-1] + (k - score.shape[-1],),
                           -jnp.inf, score.dtype)
            score = jnp.concatenate([score, pad], axis=-1)
        top_score, cand = lax.top_k(score, min(k + _RERANK, score.shape[-1]))
        cand = jnp.minimum(cand, S - 1)
        # exact distances for the candidates only (C, k + _RERANK)
        d = pairwise_km_from_xyz(pa[:, None, :], jnp.take(pb, cand, axis=0))
        d = jnp.where(jnp.isfinite(top_score), d[:, 0, :], _INF)
        neg_top, order = lax.top_k(-d, k)
        idx = jnp.take_along_axis(cand, order, axis=1)
        dist = -neg_top
        mask = jnp.isfinite(dist)
        dist = jnp.where(mask, dist, 0.0)
        return Neighborhood(idx=idx.astype(jnp.int32), dist=dist, mask=mask)

    if dist_matrix is None:
        dist_matrix = pairwise_great_circle_km(cell_lon, cell_lat, stn_lon, stn_lat)
    d = dist_matrix  # (C, S)
    d = jnp.where(stn_valid[None, :], d, _INF)
    if exclude_self_km > 0.0:
        d = jnp.where(d <= exclude_self_km, _INF, d)
    if exclude_idx is not None:
        d = jnp.where(
            jnp.arange(d.shape[-1])[None, :] == exclude_idx[:, None], _INF, d
        )
    if d.shape[-1] < k:  # pool smaller than k: pad with unreachable stations
        pad = jnp.full(d.shape[:-1] + (k - d.shape[-1],), _INF, d.dtype)
        d = jnp.concatenate([d, pad], axis=-1)
    neg_top, idx = lax.top_k(-d, k)  # nearest = largest negative distance
    idx = jnp.minimum(idx, stn_lon.shape[0] - 1)  # clamp pad indices into pool
    dist = -neg_top
    mask = jnp.isfinite(dist)
    dist = jnp.where(mask, dist, 0.0)
    return Neighborhood(idx=idx.astype(jnp.int32), dist=dist, mask=mask)


def distance_weights(
    dist: jnp.ndarray,
    mask: jnp.ndarray,
    kernel: str = "bisquare",
    bandwidth_scale: float = 1.0,
) -> jnp.ndarray:
    """Adaptive-bandwidth distance kernel weights, (..., k) -> (..., k).

    Bandwidth per cell = max masked neighbor distance * bandwidth_scale
    (adaptive kNN bandwidth — the standard GWR choice and the behavior the
    reference's expanding-radius StationSelect induces).
    Masked entries get exactly 0 weight.
    """
    big = jnp.max(jnp.where(mask, dist, 0.0), axis=-1, keepdims=True)
    bw = jnp.maximum(big * bandwidth_scale, 1e-3)
    r = jnp.minimum(dist / bw, 1.0)
    if kernel == "bisquare":
        w = (1.0 - r**2) ** 2
        # Keep the k-th neighbor from being annihilated by its own bandwidth.
        w = jnp.maximum(w, 1e-4)
    elif kernel == "gaussian":
        w = jnp.exp(-0.5 * (dist / bw) ** 2)
    elif kernel == "uniform":
        w = jnp.ones_like(dist)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    return jnp.where(mask, w, 0.0)
