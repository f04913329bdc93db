"""Batched ordinary-kriging solve (mean weights + kriging variance).

Parity target: the kriging system assembly + solve the reference delegates to
R gstat's ``krige`` through rpy2 (``twx/interp/interp_tair.py::KrigTair``,
SURVEY.md §2.12 and the BASELINE mandate to delete the R bridge).

Formulation: gstat solves the (k+1)x(k+1) *indefinite* augmented
ordinary-kriging system (Lagrange multiplier row). Indefinite systems need LU;
SPD systems get Cholesky, which batches well and fits one warp per system in
a hand kernel (``kernels/ok_krige.py``). So we use the classical simple-kriging reduction, which is algebraically identical
to the augmented system but touches only the SPD covariance C:

    C a = c0,   C u = 1
    mu      = (1 - 1^T a) / (1^T u)          (Lagrange multiplier)
    lambda  = a + mu * u                      (OK weights)
    sigma^2 = sill - lambda^T c0 - mu         (OK variance)

Masking: a masked station j gets row/col e_j in C, 0 in c0, and 0 in the
"ones" vector — its weight is then exactly 0 and it cannot perturb the mean
or the variance (verified algebraically in tests/test_kernels.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from topotpu.geo.distance import pairwise_km_from_xyz


class OKSolution(NamedTuple):
    weights: jnp.ndarray   # (B, k) ordinary-kriging weights (0 at masked)
    variance: jnp.ndarray  # (B,) kriging variance
    ok: jnp.ndarray        # (B,) bool — enough stations / solvable


def assemble_exp_cov(
    dist_pair: jnp.ndarray,
    dist_point: jnp.ndarray,
    nugget: jnp.ndarray,
    psill: jnp.ndarray,
    rng: jnp.ndarray,
    mask: jnp.ndarray,
    jitter_frac: float = 1e-5,
):
    """Exponential-model covariance blocks for a padded neighborhood.

    Args:
      dist_pair: (B, k, k) neighbor-neighbor distances, km.
      dist_point: (B, k) neighbor-to-prediction-point distances.
      nugget/psill/rng: (B,) per-cell variogram parameters (the reference
        interpolates per-station fitted params to each cell, SURVEY.md §3.3).
      mask: (B, k) neighborhood validity.

    Returns (C, c0, sill): C (B, k, k) SPD with masked rows/cols folded to
    identity; c0 (B, k) masked to 0; sill (B,) = nugget + psill (the prior
    variance used in the OK variance identity).
    """
    nugget = nugget[..., None]
    psill = psill[..., None]
    rng = jnp.maximum(rng[..., None], 1e-3)
    c0 = psill * jnp.exp(-dist_point / rng)
    c0 = jnp.where(mask, c0, 0.0)

    C = psill[..., None] * jnp.exp(-dist_pair / rng[..., None])
    k = dist_pair.shape[-1]
    eye = jnp.eye(k, dtype=C.dtype)
    sill = (nugget + psill)[..., 0]
    # Diagonal: full sill + proportional jitter for f32 Cholesky stability.
    C = C + (nugget[..., None] + jitter_frac * sill[..., None, None]) * eye
    pair_mask = mask[..., :, None] & mask[..., None, :]
    C = jnp.where(pair_mask, C, 0.0)
    # Masked diagonal -> 1 keeps C SPD without coupling masked entries.
    diag_fix = jnp.where(mask, 0.0, 1.0)
    C = C + diag_fix[..., :, None] * eye
    return C, c0, sill


def ok_solve(
    C: jnp.ndarray,
    c0: jnp.ndarray,
    mask: jnp.ndarray,
    sill: jnp.ndarray,
    min_neighbors: int = 3,
) -> OKSolution:
    """Batched ordinary-kriging weights and variance via Cholesky.

    C must already have masked rows/cols folded to identity (see
    ``assemble_exp_cov``); c0 masked to 0.
    """
    ones = jnp.where(mask, 1.0, 0.0).astype(C.dtype)
    rhs = jnp.stack([c0, ones], axis=-1)  # (B, k, 2)
    L = jnp.linalg.cholesky(C)
    z = lax.linalg.triangular_solve(L, rhs, left_side=True, lower=True)
    sol = lax.linalg.triangular_solve(
        L, z, left_side=True, lower=True, transpose_a=True
    )
    a = sol[..., 0]
    u = sol[..., 1]
    sum_a = jnp.sum(a * ones, axis=-1)
    sum_u = jnp.sum(u * ones, axis=-1)
    n_valid = jnp.sum(mask, axis=-1)
    solvable = (n_valid >= min_neighbors) & (sum_u > 1e-12) & jnp.isfinite(sum_u)
    safe_sum_u = jnp.where(solvable, sum_u, 1.0)
    t = (1.0 - sum_a) / safe_sum_u
    lam = a + t[..., None] * u
    lam = jnp.where(mask, lam, 0.0)
    # OK variance: sigma^2 = sill - lambda^T c0 - mu, with the Lagrange
    # multiplier mu = -t under the convention C lam + mu 1 = c0. Far from all
    # stations (c0 -> 0) this correctly tends to sill + t > sill
    # (extrapolation inflates uncertainty).
    var = sill - jnp.sum(lam * c0, axis=-1) + t
    var = jnp.maximum(var, 0.0)
    return OKSolution(weights=lam, variance=var, ok=solvable)


def ok_krige_xla(
    nbr_xyz: jnp.ndarray,
    dist: jnp.ndarray,
    mask: jnp.ndarray,
    vario: jnp.ndarray,
    jitter_frac: float = 1e-5,
    min_neighbors: int = 3,
) -> OKSolution:
    """Pair distances + covariance assembly + ``ok_solve`` in plain jnp.

    nbr_xyz (B, k, 3) unit-sphere neighbor coordinates, dist (B, k) km to
    the prediction point, mask (B, k), vario (B, 3) nugget/psill/range. The
    reference semantics of the fused CUDA solve (``kernels/ok_krige.py``).
    """
    dist_pair = pairwise_km_from_xyz(nbr_xyz, nbr_xyz)
    C, c0, sill = assemble_exp_cov(
        dist_pair, dist, vario[..., 0], vario[..., 1], vario[..., 2], mask,
        jitter_frac=jitter_frac,
    )
    return ok_solve(C, c0, mask, sill, min_neighbors)
