"""Station-observation quality assurance.

Parity target: ``twx/qa/qa_temp.py`` (SURVEY.md §2.5) — the reference's
Python port of the GHCN-Daily QA suite (Durre et al. 2010, J. Appl. Meteor.
Climatol. 49: "Comprehensive automated quality assurance of daily surface
observations"). Implemented checks (flag codes in topotpu.core.constants):

non-spatial (per station):
  * duplicate-year / duplicate-month series
  * tmin-series-duplicates-tmax within a month
  * world-record exceedance
  * repeated-value streaks
  * gap check in the sorted monthly distribution
  * internal consistency (tmax < tmin; monthly mega-consistency)
  * spike/dip (swing vs both neighbors)
  * climatological z-score outlier (biweight day-of-year climatology)

spatial (needs neighbors):
  * spatial regression corroboration (weighted neighbor estimate residual,
    confirmed against nearest-neighbor anomaly differences)

This stage stays on host (SURVEY.md §3.4): numpy over (S, T) matrices, a
few seconds for the full network — not a device-shaped workload.

Flags are "sticky worst": a value once flagged by an earlier check is
excluded from later statistics, mirroring the reference's sequential
application order.
"""

from __future__ import annotations

import numpy as np

from topotpu.core import constants as C
from topotpu.core.dates import DaysMetadata

WORLD_RECORD_MAX = 57.7    # Death Valley 1913, deg C
WORLD_RECORD_MIN = -89.4   # Vostok; far below any CONUS value
STREAK_LEN = 20
GAP_THRESHOLD = 10.0       # deg C gap in sorted monthly values
SPIKE_THRESHOLD = 25.0     # deg C swing against both neighbors
ZSCORE_THRESHOLD = 6.0     # climatological outlier
SPATIAL_RESID_THRESHOLD = 8.0   # deg C regression residual
SPATIAL_CORROB_THRESHOLD = 10.0  # deg C anomaly-difference corroboration


def _biweight(x: np.ndarray, axis=None, c: float = 7.5):
    """Biweight mean/std (Durre's robust climatology estimator).

    NaN-aware. Returns (mean, std)."""
    med = np.nanmedian(x, axis=axis, keepdims=True)
    mad = np.nanmedian(np.abs(x - med), axis=axis, keepdims=True)
    mad = np.where(mad < 1e-6, 1e-6, mad)
    u = (x - med) / (c * mad)
    w = np.where(np.abs(u) < 1.0, (1.0 - u**2) ** 2, 0.0)
    w = np.where(np.isnan(x), 0.0, w)
    xz = np.where(np.isnan(x), 0.0, x)
    denom = np.sum(w, axis=axis, keepdims=True)
    denom = np.where(denom <= 0, 1.0, denom)
    bw_mean = med + np.sum(w * (xz - med), axis=axis, keepdims=True) / denom
    var = np.sum(w * (xz - bw_mean) ** 2, axis=axis, keepdims=True) / denom
    bw_std = np.sqrt(np.maximum(var, 1e-12))
    if axis is None:
        return float(bw_mean), float(bw_std)
    return np.squeeze(bw_mean, axis=axis), np.squeeze(bw_std, axis=axis)


def _flag(flags, where, code):
    """Set code where condition holds and not already flagged."""
    flags[np.asarray(where) & (flags == C.QA_OK)] = code


def _valid(obs, flags):
    return np.isfinite(obs) & (flags == C.QA_OK)


# ------------------------------------------------------------------ checks


def check_world_records(obs, flags):
    _flag(flags, np.isfinite(obs) & ((obs > WORLD_RECORD_MAX) | (obs < WORLD_RECORD_MIN)),
          C.QA_IMPOSS_VALUE)


def check_streaks(obs, flags):
    """>= STREAK_LEN identical consecutive (observed) values."""
    S, T = obs.shape
    for s in range(S):
        v = obs[s]
        ok = np.isfinite(v)
        # run-length encode over observed values only
        idx = np.flatnonzero(ok)
        if len(idx) < STREAK_LEN:
            continue
        vals = v[idx]
        change = np.flatnonzero(np.diff(vals) != 0) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [len(vals)]])
        # python-loop only the rare qualifying runs, not every value change
        # (a 25k-day series has ~20k runs; long ones are the exception)
        long = ends - starts >= STREAK_LEN
        for a, b in zip(starts[long], ends[long]):
            flags[s, idx[a:b]] = np.where(
                flags[s, idx[a:b]] == C.QA_OK, C.QA_STREAK, flags[s, idx[a:b]]
            )


def _flag_span(flags, s, span_mask, code):
    f = flags[s, span_mask]
    f[f == C.QA_OK] = code
    flags[s, span_mask] = f


def _hash_i20(v: np.ndarray) -> np.ndarray:
    """Deterministic 20-bit integer hash of f32 values (as f64), NaN -> 0.

    The duplicate checks below turn O(years^2 x slots) series compares into
    three batched matmuls over these codes; 20 bits keeps every product and
    every <=372-term sum exactly representable in f64 (< 2^49), so the
    matmul identity test is integer-exact — no float-ordering tolerance."""
    u = np.where(np.isfinite(v), v, np.float32(0.0)).view(np.uint32)
    u = u.astype(np.uint64)
    u = (u ^ (u >> 16)) * np.uint64(0x45D9F3B)
    u = (u ^ (u >> 16)) * np.uint64(0x45D9F3B)
    u = u ^ (u >> 16)
    return ((u & np.uint64(0xFFFFF)) + np.uint64(1)).astype(np.float64)


def _duplicate_pairs(A: np.ndarray, min_common: int):
    """Find (station, year_i, year_j) with identical observed values on
    >= min_common common slots. A: (n, Y, W) f32 slot-aligned series, NaN =
    unobserved.

    The pairwise test is recast as dense linear algebra (the same move the
    interpolation hot path makes — comparisons become matmuls): with x = hash(A)
    masked to observed slots, G = x @ x.T sums hash products over COMMON
    slots, and E_ij = (x^2 @ m.T)_ij sums x_i^2 over the same slots. A true
    duplicate has x_j == x_i wherever both observed, so G == E termwise and
    (integer-exact f64) G == E == E.T. A hash collision (2^-20 per
    differing slot) can only ADD a false candidate, never hide a real one;
    candidates are exact-verified below. O(Y^2 W) BLAS per station instead
    of Python pair loops (~0.8 s/station at Y=69 measured round 3)."""
    fin = np.isfinite(A)
    m = fin.astype(np.float64)
    x = _hash_i20(A) * m                                   # 0 at missing
    G = x @ x.transpose(0, 2, 1)                           # (n, Y, Y)
    E = (x * x) @ m.transpose(0, 2, 1)
    cnt = m @ m.transpose(0, 2, 1)
    cand = (
        (G == E) & (G == E.transpose(0, 2, 1)) & (cnt >= min_common)
    )
    cand &= np.tri(A.shape[1], k=-1, dtype=bool).T        # i < j only
    out = []
    for si, i, j in zip(*np.nonzero(cand)):
        a, b = A[si, i], A[si, j]
        both = fin[si, i] & fin[si, j]
        if np.array_equal(a[both], b[both]):               # kill collisions
            out.append((int(si), int(i), int(j)))
    return out


def check_duplicate_years(obs, flags, days: DaysMetadata,
                          chunk_stations: int = 256):
    """Two calendar years with identical observed series (>= 180 common
    observed days, all equal) -> both years flagged.

    Recast as batched matmuls (_duplicate_pairs): per-station Python pair
    loops measured ~0.8 s/station at a 69-yr span — hours at the
    reference's ~1e4 network (`twx/qa/qa_temp.py` scale)."""
    years = days.years
    Y = len(years)
    if Y < 2:
        return
    # align years on (month, day) — a fixed 12*31 slot per calendar date —
    # so leap vs non-leap years compare Mar-1 to Mar-1, not off-by-one
    slot = (days.month - 1) * 31 + (days.day - 1)
    yidx = np.searchsorted(years, days.year)
    ymasks = [days.year == y for y in years]
    S = obs.shape[0]
    for s0 in range(0, S, chunk_stations):
        ob = obs[s0 : s0 + chunk_stations]
        A = np.full((ob.shape[0], Y, 12 * 31), np.nan, np.float32)
        A[:, yidx, slot] = ob
        for si, i, j in _duplicate_pairs(A, min_common=180):
            for yi in (i, j):
                _flag_span(flags, s0 + si, ymasks[yi], C.QA_DUP_YEAR)


def check_duplicate_months(obs, flags, days: DaysMetadata,
                           chunk_stations: int = 512):
    """Identical observed series in the same calendar month of different
    years (>= 20 common observed days, all equal) -> both months flagged.

    Same matmul recast as check_duplicate_years, per month-of-year on a
    (stations, years, 31) day-of-month-aligned block (leap Feb-29 pairs a
    NaN slot in non-leap years, so it is excluded exactly as the
    reference's positional truncation excluded it)."""
    years = days.years
    Y = len(years)
    if Y < 2:
        return
    yidx = np.searchsorted(years, days.year)
    S = obs.shape[0]
    for m in range(1, 13):
        msel = days.month == m
        if not msel.any():
            continue
        dom = days.day[msel] - 1
        yi_m = yidx[msel]
        spans = [msel & (days.year == y) for y in years]
        for s0 in range(0, S, chunk_stations):
            ob = obs[s0 : s0 + chunk_stations, msel]
            B = np.full((ob.shape[0], Y, 31), np.nan, np.float32)
            B[:, yi_m, dom] = ob
            for si, i, j in _duplicate_pairs(B, min_common=20):
                for yi in (i, j):
                    _flag_span(flags, s0 + si, spans[yi],
                               C.QA_DUP_YEAR_MONTH)


def check_tmax_dup_tmin(tmax, tmin, flags_tmax, flags_tmin, days: DaysMetadata):
    """tmax series identical to tmin series within a calendar month."""
    keys = days.year * 100 + days.month
    for k in np.unique(keys):
        sl = keys == k
        a, b = tmax[:, sl], tmin[:, sl]
        both = np.isfinite(a) & np.isfinite(b)
        eq = ~np.where(both, a != b, False).any(axis=1)
        eq &= both.sum(axis=1) >= 20
        for s in np.flatnonzero(eq):
            for fl in (flags_tmax, flags_tmin):
                _flag_span(fl, s, sl, C.QA_DUP_WITHIN_MONTH)


def check_internal_consistency(tmax, tmin, flags_tmax, flags_tmin):
    bad = (
        np.isfinite(tmax) & np.isfinite(tmin)
        & (flags_tmax == C.QA_OK) & (flags_tmin == C.QA_OK)
        & (tmax < tmin)
    )
    _flag(flags_tmax, bad, C.QA_INTERNAL)
    _flag(flags_tmin, bad, C.QA_INTERNAL)


def check_mega_consistency(tmax, tmin, flags_tmax, flags_tmin, days: DaysMetadata):
    """Monthly max(tmax) < monthly min(tmin) -> whole month inconsistent."""
    keys = days.year * 100 + days.month
    for k in np.unique(keys):
        sl = keys == k
        a = np.where(_valid(tmax[:, sl], flags_tmax[:, sl]), tmax[:, sl], np.nan)
        b = np.where(_valid(tmin[:, sl], flags_tmin[:, sl]), tmin[:, sl], np.nan)
        has_a = np.isfinite(a).any(axis=1)
        has_b = np.isfinite(b).any(axis=1)
        amax = np.where(has_a, np.nanmax(np.where(np.isfinite(a), a, -np.inf), axis=1), np.nan)
        bmin = np.where(has_b, np.nanmin(np.where(np.isfinite(b), b, np.inf), axis=1), np.nan)
        with np.errstate(invalid="ignore"):
            bad = amax < bmin
        bad = np.nan_to_num(bad.astype(float)).astype(bool) & has_a & has_b
        for s in np.flatnonzero(bad):
            for fl, o in ((flags_tmax, tmax), (flags_tmin, tmin)):
                f = fl[s, sl]
                f[(f == C.QA_OK) & np.isfinite(o[s, sl])] = C.QA_MEGA
                fl[s, sl] = f


def check_spike_dip(obs, flags):
    """Durre et al. spike/dip: the excursion must OPPOSE both neighbors —
    a spike sits above prev and next, a dip below both. A genuine monotone
    ramp (large same-sign day-to-day changes) is not flagged."""
    v = np.where(_valid(obs, flags), obs, np.nan)
    d_prev = np.diff(v, axis=1, prepend=np.nan)            # v_t - v_{t-1}
    d_next = -np.diff(v, axis=1, append=np.nan)            # v_t - v_{t+1}
    spike = (d_prev > SPIKE_THRESHOLD) & (d_next > SPIKE_THRESHOLD)
    dip = (d_prev < -SPIKE_THRESHOLD) & (d_next < -SPIKE_THRESHOLD)
    bad = spike | dip  # NaN comparisons are False: series edges never flag
    _flag(flags, bad, C.QA_SPIKE_DIP)


def check_gap(obs, flags, days: DaysMetadata):
    """Sorted monthly climatological distribution: values beyond a
    > GAP_THRESHOLD gap from the median side are flagged.

    Vectorized over stations: one axis-sort per month block (NaNs sort to
    the tail, where diff is NaN and never exceeds the threshold), then the
    per-row cut levels reduce with masked max/min — the innermost gap
    (closest to the median) wins on each side, exactly as the sequential
    loop decided it."""
    for m in range(1, 13):
        sl = days.month == m
        if not sl.any():
            continue
        v = np.where(_valid(obs[:, sl], flags[:, sl]), obs[:, sl], np.nan)
        fin = np.isfinite(v)
        enough = fin.sum(axis=1) >= 30
        if not enough.any():
            continue
        med = np.nanmedian(v[enough], axis=1)
        xs = np.sort(v[enough], axis=1)       # NaNs last
        lo_side, hi_side = xs[:, :-1], xs[:, 1:]
        with np.errstate(invalid="ignore"):
            big = (hi_side - lo_side) > GAP_THRESHOLD
            below = lo_side < med[:, None]
        cut_lo = np.max(
            np.where(big & below, hi_side, -np.inf), axis=1
        ) - 1e-9
        cut_hi = np.min(
            np.where(big & ~below, lo_side, np.inf), axis=1
        ) + 1e-9
        with np.errstate(invalid="ignore"):
            bad = fin[enough] & (
                (v[enough] < cut_lo[:, None]) | (v[enough] > cut_hi[:, None])
            )
        if not bad.any():
            continue
        f = flags[np.ix_(enough, sl)]
        f[bad & (f == C.QA_OK)] = C.QA_GAP
        flags[np.ix_(enough, sl)] = f


def _kth_deviation(xs, j, la, lb, k, med):
    """k-th smallest (1-indexed) of the merged absolute-deviation arrays
    A[i] = med - xs[j-1-i] (i < la, ascending) and B[i] = xs[j+i] - med
    (i < lb, ascending), per row. Classic two-sorted-array k-select as a
    vectorized bisection: ~log2(window) take_along_axis gathers replace the
    second full sort of |x - med| in the biweight MAD (the second sort was
    ~45% of the clim-outlier wall at 4000 stn x 69 yr)."""
    L = xs.shape[-1]

    def getA(i):
        v = med - np.take_along_axis(xs, np.clip(j - 1 - i, 0, L - 1)[..., None], -1)[..., 0]
        return np.where(i < la, v, np.inf)

    def getB(i):
        v = np.take_along_axis(xs, np.clip(j + i, 0, L - 1)[..., None], -1)[..., 0] - med
        return np.where((i >= 0) & (i < lb), v, np.inf)

    lo = np.maximum(0, k - lb)
    hi = np.minimum(k, la)
    for _ in range(int(np.log2(max(int(la.max(initial=1)), 1) + 1)) + 2):
        active = lo < hi
        i = (lo + hi) // 2
        more = getA(i) < getB(k - i - 1)   # (i+1)-th A still among k smallest
        lo = np.where(active & more, i + 1, lo)
        hi = np.where(active & ~more, i, hi)
    a = np.where(lo > 0, getA(np.maximum(lo - 1, 0)), -np.inf)
    b = np.where(k - lo > 0, getB(np.maximum(k - lo - 1, 0)), -np.inf)
    return np.maximum(a, b)


def _biweight_rows(x: np.ndarray, c: float = 7.5):
    """_biweight over the last axis (identical estimator, vectorized
    NaN-median; MAD via k-select on the one sorted copy — no second sort).
    Returns (mean, std, finite_count)."""
    xs = np.sort(x, axis=-1)                     # NaNs sort to the tail
    cnt = np.isfinite(x).sum(-1)
    cc = np.maximum(cnt, 1)
    ilo, ihi = (cc - 1) // 2, cc // 2
    lo = np.take_along_axis(xs, ilo[..., None], -1)[..., 0]
    hi = np.take_along_axis(xs, ihi[..., None], -1)[..., 0]
    med = np.where(cnt > 0, 0.5 * (lo + hi), np.nan)
    # split the sorted window at the median position: deviations of the
    # lower half (reversed) and upper half are both ascending and >= 0
    j = (cc + 1) // 2
    q_lo = _kth_deviation(xs, j, j, cc - j, ilo + 1, med)
    q_hi = _kth_deviation(xs, j, j, cc - j, ihi + 1, med)
    mad = np.where(cnt > 0, 0.5 * (q_lo + q_hi), np.nan)
    mad = np.maximum(mad, 1e-6)
    u = (x - med[..., None]) / (c * mad[..., None])
    w = np.where(np.abs(u) < 1.0, (1.0 - u**2) ** 2, 0.0)
    w = np.where(np.isnan(x), 0.0, w)
    xz = np.where(np.isnan(x), 0.0, x)
    denom = np.maximum(w.sum(-1), 1e-12)
    mean = med + (w * (xz - med[..., None])).sum(-1) / denom
    var = (w * (xz - mean[..., None]) ** 2).sum(-1) / denom
    return mean, np.sqrt(np.maximum(var, 1e-12)), cnt


def check_clim_outlier(obs, flags, days: DaysMetadata):
    """|z| > 6 against a 15-day-window biweight day-of-year climatology.

    The series is first rearranged into a (S, doy, year) table so each
    day-of-year's +/-7-day circular window is a contiguous 15-doy slice of
    the padded table — the per-doy boolean gather over the full 25k-day
    axis was ~1/3 of this check's wall at the 4k-station x 69-yr scale
    (absent (doy, year) combos hold NaN, so finite counts are unchanged)."""
    S, T = obs.shape
    v = np.where(_valid(obs, flags), obs, np.nan)
    doy = days.yday
    max_doy = 366
    years = days.years
    yidx = np.searchsorted(years, days.year)
    D = np.full((S, max_doy, len(years)), np.nan, v.dtype)
    D[:, doy - 1, yidx] = v
    Dpad = np.concatenate([D[:, -7:], D, D[:, :7]], axis=1)
    clim_mean = np.full((S, max_doy + 1), np.nan, np.float32)
    clim_std = np.full((S, max_doy + 1), np.nan, np.float32)
    for d in range(1, max_doy + 1):
        x = Dpad[:, d - 1 : d + 14].reshape(S, -1)
        mean, std, n = _biweight_rows(x)
        clim_mean[:, d] = np.where(n >= 30, mean, np.nan)
        clim_std[:, d] = np.where(
            n >= 30, np.maximum(std, 0.5), np.nan
        )
    z = (v - clim_mean[:, doy]) / clim_std[:, doy]
    with np.errstate(invalid="ignore"):
        bad = np.abs(z) > ZSCORE_THRESHOLD
    _flag(flags, np.nan_to_num(bad.astype(float)).astype(bool), C.QA_CLIM_OUTLIER)


# ------------------------------------------------------------- entry points


def run_qa_non_spatial(
    tmin: np.ndarray, tmax: np.ndarray, days: DaysMetadata
) -> tuple[np.ndarray, np.ndarray]:
    """Full non-spatial QA pass. Returns (flags_tmin, flags_tmax), uint8."""
    flags_tmin = np.full(tmin.shape, C.QA_OK, np.uint8)
    flags_tmax = np.full(tmax.shape, C.QA_OK, np.uint8)

    for obs, flags in ((tmin, flags_tmin), (tmax, flags_tmax)):
        check_world_records(obs, flags)
        check_duplicate_years(obs, flags, days)
        check_duplicate_months(obs, flags, days)
        check_streaks(obs, flags)
    check_tmax_dup_tmin(tmax, tmin, flags_tmax, flags_tmin, days)
    check_internal_consistency(tmax, tmin, flags_tmax, flags_tmin)
    check_mega_consistency(tmax, tmin, flags_tmax, flags_tmin, days)
    for obs, flags in ((tmin, flags_tmin), (tmax, flags_tmax)):
        check_gap(obs, flags, days)
        check_spike_dip(obs, flags)
        check_clim_outlier(obs, flags, days)
    return flags_tmin, flags_tmax


def run_qa_spatial(
    obs: np.ndarray,
    flags: np.ndarray,
    stn_lon: np.ndarray,
    stn_lat: np.ndarray,
    days: DaysMetadata,
    n_neighbors: int = 7,
    max_dist_km: float = 75.0,
) -> np.ndarray:
    """Spatial regression + corroboration check (updates and returns flags).

    For each station-day: estimate the value from distance-weighted neighbor
    anomalies (+ target's climatology); a residual beyond
    SPATIAL_RESID_THRESHOLD that no near neighbor corroborates (all absolute
    anomaly differences > SPATIAL_CORROB_THRESHOLD) is flagged.
    """
    from topotpu.oracle.numpy_ref import haversine_km

    S, T = obs.shape
    v = np.where(_valid(obs, flags), obs, np.nan)

    # station-month climatology + anomalies (f32: an f64 clim would upcast
    # anom to ~800 MB at the 1e4-station x 25k-day production scale)
    clim = np.zeros((S, 12), np.float32)
    for m in range(12):
        sel = days.month_idx == m
        with np.errstate(invalid="ignore"):
            clim[:, m] = np.nanmean(v[:, sel], axis=1)
    anom = v - clim[:, days.month_idx]

    d = haversine_km(stn_lon[:, None], stn_lat[:, None], stn_lon[None, :], stn_lat[None, :])
    np.fill_diagonal(d, np.inf)
    order = np.argsort(d, axis=1)[:, :n_neighbors]
    ndist = np.take_along_axis(d, order, axis=1)
    w = (1.0 / np.maximum(ndist, 1.0) ** 2).astype(np.float32)
    w[ndist > max_dist_km] = 0.0

    # The estimate is a per-day masked weighted mean over a FIXED 7-neighbor
    # stencil — i.e. three sparse (S, S) @ (S, T) matmuls (numerator,
    # weight-denominator, used-neighbor count), which scipy CSR does in a
    # few seconds where the dense (S, n, T) neighbor-gather formulation
    # moved ~20 GB through one core (measured 77 s/var at 4000 stn x 69 yr;
    # this path: ~9 s/var). Masks fold in exactly as before: a neighbor
    # contributes iff its anomaly is finite AND its weight (near, non-self)
    # is positive.
    from scipy import sparse

    rows = np.repeat(np.arange(S), n_neighbors)
    W = sparse.csr_matrix(
        (w.ravel(), (rows, order.ravel())), shape=(S, S), dtype=np.float32
    )
    Wb = sparse.csr_matrix(
        ((w > 0).ravel().astype(np.float32), (rows, order.ravel())),
        shape=(S, S),
    )
    fin = np.isfinite(anom)
    az = np.where(fin, anom, 0.0).astype(np.float32)
    finf = fin.astype(np.float32)
    num = W @ az                       # sum_n w * anom_nb  (missing -> 0)
    den = W @ finf                     # sum_n w over finite neighbors
    n_used = Wb @ finf                 # count of contributing neighbors
    with np.errstate(invalid="ignore"):
        est = num / np.maximum(den, 1e-12)
        resid = anom - est
        resid[n_used < 3] = np.nan
        cand = np.abs(resid) > SPATIAL_RESID_THRESHOLD  # NaN -> False

    # Corroboration (same max_dist_km window as the estimate: distant
    # stations' anomalies are regionally coherent and would "corroborate"
    # almost anything) is only consulted where the residual test fired —
    # a sparse candidate set, so the (cand, n) neighbor diff table is tiny.
    cs, ct = np.nonzero(cand)
    if len(cs):
        nb_anom = anom[order[cs], ct[:, None]]           # (c, n)
        excl = np.isnan(nb_anom) | (ndist[cs] > max_dist_km)
        min_diff = np.min(
            np.where(excl, np.inf, np.abs(anom[cs, ct][:, None] - nb_anom)),
            axis=1,
        )
        keep = min_diff > SPATIAL_CORROB_THRESHOLD       # not corroborated
        bad = np.zeros_like(cand)
        bad[cs[keep], ct[keep]] = True
        _flag(flags, bad, C.QA_SPATIAL_REGRESS)
    return flags
