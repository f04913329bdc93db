"""Batched masked weighted least squares.

Parity target: the GWR solves inside ``twx/interp/interp_tair.py`` —
``GwrTairAnom`` daily-anomaly regression and the trend stage of ``KrigTair``
(SURVEY.md §2.12-2.13). The reference calls numpy lstsq once per cell per
day/month; here one batched solve covers a whole tile of cells, and the
daily-anomaly path is reduced to a *gain row* per (cell, month) so that all
days become a single matmul (see ``topotpu.interp.anoms``).

Shapes: X (B, k, p) design, y (B, k) targets, w (B, k) weights (0 = masked).
p is tiny (<= 8): each system is a few fused elementwise loops over its k
rows (``_qr``), with no batched solver library call.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def _qr(X: jnp.ndarray, w: jnp.ndarray, ridge: float, extra=()):
    """Modified Gram-Schmidt QR of the ridge-augmented weighted design.

    Z = [sqrt(w) X; sqrt(lam) I] with lam = ridge * tr(X^T W X) / p, so
    Z^T Z is the ridge-regularised normal matrix while Z's condition number
    is the square root of it (the normal equations square it, which costs
    f32 digits when covariates are near-collinear). ``extra`` are (B, k)
    right-hand sides swept through the same projections. Columns are
    unrolled over the static p (<= 8) as elementwise operations: XLA fuses
    them, and every system is computed by the same instructions whatever
    the batch size, so sharding the batch cannot change a result.

    Returns (Q, R, qe): Q (p columns of (B, k + p)), R[i][j] (B,) for
    j >= i, qe (Q^T e for each extra right-hand side, p entries each)."""
    s = jnp.sqrt(w)
    p = X.shape[-1]
    Z = X * s[..., None]
    lam = ridge * jnp.sum(Z * Z, axis=(-2, -1)) / p + 1e-30
    pad = jnp.sqrt(lam)[..., None, None] * jnp.eye(p, dtype=X.dtype)  # (B, p, p)
    cols = [jnp.concatenate([Z[..., j], pad[..., j]], axis=-1)
            for j in range(p)]
    rhs = [jnp.concatenate([e * s, jnp.zeros_like(pad[..., 0])], axis=-1)
           for e in extra]
    R = [[None] * p for _ in range(p)]
    qe = [[None] * p for _ in rhs]
    Q = []
    for j in range(p):
        R[j][j] = jnp.sqrt(jnp.sum(cols[j] * cols[j], axis=-1))
        q = cols[j] / R[j][j][..., None]
        Q.append(q)
        for l in range(j + 1, p):
            R[j][l] = jnp.sum(q * cols[l], axis=-1)
            cols[l] = cols[l] - R[j][l][..., None] * q
        for n, r in enumerate(rhs):
            qe[n][j] = jnp.sum(q * r, axis=-1)
            rhs[n] = r - qe[n][j][..., None] * q
    return Q, R, qe


def batched_wls(
    X: jnp.ndarray,
    y: jnp.ndarray,
    w: jnp.ndarray,
    ridge: float = 1e-6,
) -> jnp.ndarray:
    """Solve the ridge-regularised weighted least-squares problem per batch
    element (the normal equations' solution, computed by QR).

    Returns beta (B, p). Masked rows must carry w == 0 and contribute nothing.
    """
    _, R, (qy,) = _qr(X, w, ridge, extra=(y,))
    p = X.shape[-1]
    beta = [None] * p
    for i in reversed(range(p)):
        acc = qy[i] - sum(R[i][m] * beta[m] for m in range(i + 1, p))
        beta[i] = acc / R[i][i]
    return jnp.stack(beta, axis=-1)


def batched_gwr_gain(
    X: jnp.ndarray,
    w: jnp.ndarray,
    x0: jnp.ndarray,
    ridge: float = 1e-6,
) -> jnp.ndarray:
    """Prediction gain row g (B, k): pred(y) = sum_k g * y for ANY target y.

    g = x0^T (X^T W X)^-1 X^T W. Because X, w, x0 depend only on (cell, month)
    geometry — not on the day — computing g once makes every daily-anomaly
    prediction a dot product, and a month of days one matmul. This is the
    restructuring that moves the reference's hot loop #3 (SURVEY.md §3.1,
    ~25k days x 1e7 cells of per-cell lstsq) into dense matmuls.

    With sqrt(W) X = Q R (ridge rows below): g = sqrt(w) * (Q t), where
    R^T t = x0.
    """
    Q, R, _ = _qr(X, w, ridge)
    p = X.shape[-1]
    t = []
    for i in range(p):
        t.append((x0[..., i] - sum(R[m][i] * t[m] for m in range(i)))
                 / R[i][i])
    k = X.shape[-2]
    g = sum(Q[i][..., :k] * t[i][..., None] for i in range(p))
    return jnp.sqrt(w) * g


def center_design(
    cov_stack: jnp.ndarray,
    cov_point: jnp.ndarray,
    w: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Build a locally-centered, scaled design matrix.

    Args:
      cov_stack: (B, k, p-1) raw neighbor covariates (no intercept column).
      cov_point: (B, p-1) covariates at the prediction point.
      w: (B, k) weights (0 = masked) used for the scaling statistics.

    Returns (X, x0, scale): X (B, k, p) with intercept column prepended and
    covariates centered at the prediction point and scaled by their weighted
    std; x0 is then exactly e0, so pred = beta[0]. Centering at the point is
    the classic local-regression trick that keeps f32 normal equations
    well-conditioned (SURVEY.md §7 "f32 vs f64" risk item).
    """
    d = cov_stack - cov_point[..., None, :]
    wsum = jnp.sum(w, axis=-1, keepdims=True) + 1e-30  # (B, 1): broadcasts over q
    mean = jnp.sum(w[..., None] * d, axis=-2) / wsum
    var = jnp.sum(w[..., None] * (d - mean[..., None, :]) ** 2, axis=-2) / wsum
    scale = jnp.sqrt(var) + 1e-6
    dn = d / scale[..., None, :]
    B, k, _ = cov_stack.shape
    ones = jnp.ones((B, k, 1), dtype=cov_stack.dtype)
    X = jnp.concatenate([ones, dn], axis=-1)
    x0 = jnp.zeros((B, X.shape[-1]), dtype=cov_stack.dtype).at[:, 0].set(1.0)
    return X, x0, scale
