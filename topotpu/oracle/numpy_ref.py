"""Slow, trusted numpy/scipy oracle implementations.

These deliberately use *different formulations* from the device kernels so a
shared bug cannot hide:

* ordinary kriging is solved via the full (k+1) augmented indefinite system
  with a general LU solve — the formulation R gstat uses internally (the
  reference's path, SURVEY.md §2.12) — while the device kernel uses the SPD
  simple-kriging reduction;
* WLS goes through numpy lstsq on the sqrt-weighted system (the reference's
  GwrTairAnom approach) instead of normal equations;
* the variogram fit uses scipy.optimize.least_squares with numerical
  Jacobians instead of hand-derived Gauss-Newton.

Everything here is float64, per-point, loop-based — the test-time ground
truth for the batched f32 device kernels (SURVEY.md §4 test plan).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.optimize

EARTH_RADIUS_KM = 6371.0087714


def haversine_km(lon1, lat1, lon2, lat2):
    lon1, lat1, lon2, lat2 = map(np.deg2rad, (lon1, lat1, lon2, lat2))
    a = (
        np.sin((lat2 - lat1) / 2) ** 2
        + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2
    )
    return 2 * EARTH_RADIUS_KM * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def wls_lstsq(X, y, w):
    """sqrt-weighted lstsq solve; rows with w == 0 dropped entirely."""
    keep = w > 0
    sw = np.sqrt(w[keep])
    beta, *_ = np.linalg.lstsq(X[keep] * sw[:, None], y[keep] * sw, rcond=None)
    return beta


def exp_cov(h, nugget, psill, rng):
    c = psill * np.exp(-h / max(rng, 1e-6))
    return np.where(h > 0, c, psill + nugget)


def ok_krige_augmented(dist_pair, dist_point, residuals, nugget, psill, rng,
                       jitter_frac=0.0):
    """Ordinary kriging via the augmented Lagrange system (gstat's route).

    dist_pair (k, k), dist_point (k,), residuals (k,) — valid stations only.
    Returns (prediction, variance, weights).
    """
    k = len(dist_point)
    C = exp_cov(dist_pair, nugget, psill, rng)
    np.fill_diagonal(C, psill + nugget + jitter_frac * (psill + nugget))
    c0 = psill * np.exp(-dist_point / max(rng, 1e-6))
    A = np.zeros((k + 1, k + 1))
    A[:k, :k] = C
    A[:k, k] = 1.0
    A[k, :k] = 1.0
    b = np.concatenate([c0, [1.0]])
    sol = scipy.linalg.solve(A, b)
    lam, mu = sol[:k], sol[k]
    pred = float(lam @ residuals)
    var = float((psill + nugget) - lam @ c0 - mu)
    return pred, var, lam


def empirical_variogram_loops(dist, values, n_bins, cutoff):
    """Triple-loop binned semivariance. dist (k,k), values (k,) valid only."""
    k = len(values)
    width = cutoff / n_bins
    gsum = np.zeros(n_bins)
    hsum = np.zeros(n_bins)
    cnt = np.zeros(n_bins)
    for i in range(k):
        for j in range(i + 1, k):
            d = dist[i, j]
            if d <= 0 or d > cutoff:
                continue
            b = min(int(d / width), n_bins - 1)
            gsum[b] += 0.5 * (values[i] - values[j]) ** 2
            hsum[b] += d
            cnt[b] += 1
    safe = np.maximum(cnt, 1)
    return gsum / safe, hsum / safe, cnt


def fit_exp_scipy(gamma, h, npairs):
    """WLS exponential-variogram fit via scipy least_squares (gstat
    fit.method=7 weights N/h^2)."""
    ok = npairs > 0
    g, hh, n = gamma[ok], h[ok], npairs[ok]
    w = np.sqrt(n / hh**2)
    w = w / w.sum()

    def resid(theta):
        nug, ps, rg = theta
        model = nug + ps * (1 - np.exp(-hh / max(rg, 1e-6)))
        return w * (g - model)

    sill0 = max(np.mean(g[len(g) // 2 :]), 1e-8)
    nug0 = min(g[0] * 0.5, 0.9 * sill0)
    x0 = [max(nug0, 0.0), max(sill0 - nug0, 1e-8), max(hh.max() / 3, 1e-2)]
    res = scipy.optimize.least_squares(
        resid, x0, bounds=([0, 1e-9, 1e-3], [np.inf, np.inf, hh.max() * 20])
    )
    return res.x  # nugget, psill, rng


def gwr_point(cov_stack, cov_point, w, y):
    """Local regression prediction at a point: raw (uncentered) design with
    intercept, float64 lstsq — oracle for the centered device path."""
    X = np.concatenate([np.ones((len(y), 1)), cov_stack], axis=1)
    beta = wls_lstsq(X, y, w)
    x0 = np.concatenate([[1.0], cov_point])
    return float(x0 @ beta)
