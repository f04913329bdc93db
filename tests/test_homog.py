"""PHA-equivalent homogenization: the C++ SNHT core must localize planted
steps and the network driver must attribute + remove them (and leave clean
stations untouched)."""

import numpy as np
import pytest

from topotpu.core.dates import get_days_metadata
from topotpu.homog.pha import (
    break_model,
    detect_breaks,
    homogenize_elements,
    homogenize_network,
    merge_attributions,
    monthly_means,
)
from topotpu.io.synthetic import make_world


def test_detect_breaks_single_step(rng):
    T = 240
    x = rng.normal(0, 0.3, size=(1, T)).astype(np.float32)
    x[0, 150:] += 1.2
    breaks, stats = detect_breaks(x, minseg=24)
    found = breaks[0][breaks[0] >= 0]
    assert len(found) >= 1
    assert abs(found[0] - 150) <= 3
    assert stats[0, 0] > 9.0


def test_detect_breaks_handles_nan_and_clean(rng):
    T = 240
    clean = rng.normal(0, 0.3, size=(1, T)).astype(np.float32)
    b, _ = detect_breaks(clean, minseg=24)
    assert (b[0] == -1).all()

    x = rng.normal(0, 0.3, size=(1, T)).astype(np.float32)
    x[0, 100:] += 1.0
    x[0, ::7] = np.nan  # missing months
    b, _ = detect_breaks(x, minseg=24)
    found = b[0][b[0] >= 0]
    assert len(found) >= 1 and abs(found[0] - 100) <= 4


def test_detect_two_breaks(rng):
    T = 360
    x = rng.normal(0, 0.25, size=(1, T)).astype(np.float32)
    x[0, 120:] += 1.0
    x[0, 260:] -= 1.4
    b, _ = detect_breaks(x, minseg=24)
    found = np.sort(b[0][b[0] >= 0])
    assert len(found) >= 2
    assert min(abs(found - 120)) <= 5
    assert min(abs(found - 260)) <= 5


def test_break_model_pure_step(rng):
    T = 240
    x = rng.normal(0, 0.3, size=T).astype(np.float32)
    x[150:] += 1.2
    model, step, tstat = break_model(x, 150, 0, T)
    assert model in (2, 3, 4)
    assert abs(step - 1.2) < 0.15
    assert abs(tstat) > 10  # huge amplitude relative to noise


def test_break_model_pure_trend_not_a_step(rng):
    # A linear drift: SNHT fires near the middle, but minbic must classify
    # it as the trend model (1) with zero step — the misattribution mode
    # that pure-step SNHT suffers (Menne-Williams model discrimination).
    T = 240
    x = (np.linspace(0, 2.0, T) + rng.normal(0, 0.25, T)).astype(np.float32)
    b, _ = detect_breaks(x[None, :], minseg=24)
    assert (b[0] >= 0).any(), "SNHT should fire on the drift (the trap)"
    brk = int(b[0][0])
    model, step, _ = break_model(x, brk, 0, T)
    assert model == 1
    assert step == 0.0


def test_break_model_sloped_step_unbiased(rng):
    # Step on top of a trend: the window-mean estimator smears the trend
    # into the step; the model-fitted offset must not.
    T = 240
    trend = np.linspace(0, 1.5, T)
    x = (trend + rng.normal(0, 0.25, T)).astype(np.float32)
    x[120:] += 1.0
    model, step, tstat = break_model(x, 120, 0, T)
    assert model in (3, 4)
    assert abs(step - 1.0) < 0.2, f"trend-biased step estimate {step}"
    assert abs(tstat) > 5


def test_break_model_amplitude_dependent_significance(rng):
    # Same break date and noise, two amplitudes: the tiny step's t-stat
    # must fall below the driver threshold while the large one clears it.
    T = 120
    noise = rng.normal(0, 0.5, T).astype(np.float32)
    small = noise.copy()
    small[60:] += 0.15
    big = noise.copy()
    big[60:] += 1.5
    _, _, t_small = break_model(small, 60, 0, T)
    _, _, t_big = break_model(big, 60, 0, T)
    assert abs(t_small) < 3.0 < abs(t_big)


def test_break_model_nan_tolerant(rng):
    T = 240
    x = rng.normal(0, 0.3, size=T).astype(np.float32)
    x[100:] += 1.0
    x[::6] = np.nan
    model, step, _ = break_model(x, 100, 0, T)
    assert model in (2, 3, 4)
    assert abs(step - 1.0) < 0.2


@pytest.fixture(scope="module")
def daily_network():
    rng = np.random.default_rng(31)
    ndays = 4383  # 2004-2015
    world = make_world(rng, nrows=40, ncols=40, n_stations=25, ndays=ndays)
    days = get_days_metadata("2004-01-01", "2015-12-31")
    S = world.n_stations
    daily = (
        world.stn_norm[np.arange(S)[:, None], days.month_idx[None, :]]
        + world.stn_anoms
    ).astype(np.float32)
    return world, days, daily


def test_homogenize_removes_planted_step(daily_network):
    world, days, daily = daily_network
    daily = daily.copy()
    # plant: station 3 was 1.5 C warmer before 2010-01-01 (e.g. site move)
    split = int(np.flatnonzero(days.ymd == 20100101)[0])
    daily[3, :split] += 1.5

    res = homogenize_network(
        daily, days.year, days.month, world.stn_lon, world.stn_lat,
    )
    # one break attributed to station 3 near month 72 (=6 years * 12)
    assert len(res.breakpoints[3]) >= 1
    b, est = res.breakpoints[3][0]
    assert abs(b - 72) <= 6
    assert abs(est - (-1.5)) < 0.35, f"step estimate {est}"

    # earlier segment pulled onto the reference (latest) level
    adj = res.adjustments[3]
    assert abs(adj[:60].mean() + 1.5) < 0.35
    assert abs(adj[80:].mean()) < 0.1

    # clean stations: essentially no adjustment
    others = [s for s in range(25) if s != 3]
    assert np.abs(res.adjustments[others]).max() < 0.5
    assert sum(len(res.breakpoints[s]) for s in others) <= 2

    # adjusted daily matches the truth (unstepped) series for station 3
    truth = daily[3].copy()
    truth[:split] -= 1.5
    mae = np.abs(res.adjusted_daily[3] - truth).mean()
    assert mae < 0.4


def test_homogenize_ignores_trend_contamination(daily_network):
    # A gradually drifting station (urbanization-style trend) must NOT be
    # step-adjusted: SNHT fires on the drift and the quorum attributes it,
    # but the minbic model stage classifies every pair window as trend-only
    # and refuses the step.
    world, days, daily = daily_network
    daily = daily.copy()
    drift = np.linspace(0.0, 2.5, daily.shape[1]).astype(np.float32)
    daily[5] += drift

    res = homogenize_network(
        daily, days.year, days.month, world.stn_lon, world.stn_lat,
    )
    assert len(res.breakpoints[5]) == 0, res.breakpoints[5]
    assert np.abs(res.adjustments[5]).max() < 0.01


def test_homogenize_step_on_trend(daily_network):
    # Trend AND a genuine break: the break must be found and its size
    # recovered without the trend leaking into the step estimate.
    world, days, daily = daily_network
    daily = daily.copy()
    drift = np.linspace(0.0, 1.5, daily.shape[1]).astype(np.float32)
    split = int(np.flatnonzero(days.ymd == 20100101)[0])
    daily[7] += drift
    daily[7, :split] += 1.8

    res = homogenize_network(
        daily, days.year, days.month, world.stn_lon, world.stn_lat,
    )
    assert len(res.breakpoints[7]) >= 1
    b, est = res.breakpoints[7][0]
    assert abs(b - 72) <= 6
    assert abs(est - (-1.8)) < 0.4, f"step estimate {est}"


def test_merge_attributions_rules():
    # need=4, date_tol=6, minseg=24
    args = dict(need=4, date_tol=6, minseg=24)

    # full quorum in one element: accepted there, not elsewhere
    acc, _ = merge_attributions(
        {"tmin": [(50, 4)], "tmax": []}, **args
    )
    assert acc == {"tmin": [50], "tmax": []}

    # one vote short, corroborated by a near-quorum cluster at the same
    # date in the other element: accepted in both (multi-element confirm)
    acc, _ = merge_attributions(
        {"tmin": [(50, 3)], "tmax": [(53, 3)]}, **args
    )
    assert acc == {"tmin": [50], "tmax": [53]}

    # one vote short, no corroboration: rejected
    acc, _ = merge_attributions(
        {"tmin": [(50, 3)], "tmax": [(120, 3)]}, **args
    )
    assert acc == {"tmin": [], "tmax": []}

    # two votes short is never rescued
    acc, _ = merge_attributions(
        {"tmin": [(50, 2)], "tmax": [(50, 8)]}, **args
    )
    assert acc == {"tmin": [], "tmax": [50]}

    # minseg thinning keeps the earliest of a too-close pair
    acc, _ = merge_attributions(
        {"tmin": [(50, 5), (60, 5), (90, 5)], "tmax": []}, **args
    )
    assert acc["tmin"] == [50, 90]


def test_homogenize_elements_joint_and_specific(daily_network):
    # One joint break (station move: both elements step together, sizes
    # differ) and one element-specific break (tmax-only sensor change):
    # the joint break is adjusted in both elements with per-element sizes,
    # the specific one only in tmax.
    world, days, daily = daily_network
    tmin = daily.copy()
    rng = np.random.default_rng(77)
    tmax = (daily + 8.0 + rng.normal(0, 0.3, daily.shape)).astype(np.float32)

    split = int(np.flatnonzero(days.ymd == 20100101)[0])
    tmin[4, :split] += 1.2
    tmax[4, :split] += 2.0          # same move, bigger tmax effect
    split2 = int(np.flatnonzero(days.ymd == 20070101)[0])
    tmax[9, :split2] -= 1.5         # tmax-only instrument change

    res = homogenize_elements(
        {"tmin": tmin, "tmax": tmax},
        days.year, days.month, world.stn_lon, world.stn_lat,
    )
    # joint break at station 4 found in both, per-element sizes
    b_tmin = dict(res["tmin"].breakpoints[4])
    b_tmax = dict(res["tmax"].breakpoints[4])
    assert any(abs(b - 72) <= 6 for b in b_tmin), b_tmin
    assert any(abs(b - 72) <= 6 for b in b_tmax), b_tmax
    est_tmin = [e for b, e in b_tmin.items() if abs(b - 72) <= 6][0]
    est_tmax = [e for b, e in b_tmax.items() if abs(b - 72) <= 6][0]
    assert abs(est_tmin - (-1.2)) < 0.4
    assert abs(est_tmax - (-2.0)) < 0.5

    # tmax-only break at station 9: adjusted in tmax, untouched in tmin
    assert any(abs(b - 36) <= 6 for b, _ in res["tmax"].breakpoints[9])
    assert np.abs(res["tmin"].adjustments[9]).max() < 0.5


def test_metadata_window_catches_documented_edge_step(daily_network):
    """Menne-Williams metadata windows: a documented change 12 months
    before the series end sits inside SNHT's minseg=24 guard band, so blind
    detection structurally cannot place it (and with measurement noise the
    displaced edge statistic stays under threshold) — but with a
    station-history entry the documented date is injected, confirmed by the
    break-model t-test (min_side=12), and adjusted at the EXACT month.
    Blind behavior for every other station is unchanged."""
    world, days, daily = daily_network
    rng = np.random.default_rng(55)
    noisy = (daily + rng.normal(0, 2.0, daily.shape)).astype(np.float32)
    split = int(np.flatnonzero(days.ymd == 20150101)[0])  # month 132 of 144
    amp = 0.8
    noisy[6, split:] += amp  # recent station move

    blind = homogenize_network(
        noisy, days.year, days.month, world.stn_lon, world.stn_lat,
    )
    assert len(blind.breakpoints[6]) == 0, (
        f"edge step should hide from blind SNHT; got {blind.breakpoints[6]}"
    )

    informed = homogenize_network(
        noisy, days.year, days.month, world.stn_lon, world.stn_lat,
        station_history={6: [2015 * 12 + 0]},
    )
    assert len(informed.breakpoints[6]) == 1, "documented step missed"
    b, est = informed.breakpoints[6][0]
    assert b == 132, f"must adjust at the exact documented month, got {b}"
    assert abs(est - amp) < 0.25, f"step estimate {est}"
    # adjust-to-latest: the pre-move segment is pulled UP onto the new level
    assert abs(informed.adjustments[6][:120].mean() - amp) < 0.25
    # other stations untouched by the metadata
    for s in (x for x in range(25) if x != 6):
        assert blind.breakpoints[s] == informed.breakpoints[s]


def test_metadata_window_no_phantom_adjustment(daily_network):
    """A documented change with NO step signature in the data must not be
    adjusted: injection only creates a candidate; the break-model t-test
    still gates it."""
    world, days, daily = daily_network
    res = homogenize_network(
        daily.copy(), days.year, days.month, world.stn_lon, world.stn_lat,
        station_history={2: [2008 * 12 + 5]},
    )
    assert len(res.breakpoints[2]) == 0, res.breakpoints[2]
    assert np.abs(res.adjustments[2]).max() < 0.01


def test_merge_attributions_documented():
    args = dict(need=4, date_tol=6, minseg=24)
    # sub-quorum cluster near a documented date: snapped to it and accepted
    acc, _ = merge_attributions(
        {"tmin": [(50, 1)], "tmax": []}, documented=(48,), **args
    )
    assert acc == {"tmin": [48], "tmax": [48]}
    # documented date with no cluster: injected into every element
    acc, _ = merge_attributions(
        {"tmin": [], "tmax": []}, documented=(100,), **args
    )
    assert acc == {"tmin": [100], "tmax": [100]}
    # far from any documented date: blind rules apply untouched
    acc, _ = merge_attributions(
        {"tmin": [(50, 2)], "tmax": []}, documented=(100,), **args
    )
    assert acc == {"tmin": [100], "tmax": [100]}
    # a displaced full-quorum cluster within minseg of a documented date
    # must not crowd it out of the thinning (documented date wins)
    acc, _ = merge_attributions(
        {"tmin": [(120, 8)], "tmax": []}, documented=(132,), **args
    )
    assert acc == {"tmin": [132], "tmax": [132]}


def test_parse_station_history():
    from topotpu.homog import parse_station_history

    ids = np.array([b"SYNTH00000", b"SYNTH00001", b"SYNTH00002"])
    text = """
    # station history fixture
    SYNTH00001 2010-01  site move to new enclosure
    SYNTH00001 2012-06
    SYNTH00002 1999-12  instrument swap
    UNKNOWN999 2005-03  outside this network -> ignored
    """
    out = parse_station_history(text, ids)
    assert out == {
        1: [2010 * 12 + 0, 2012 * 12 + 5],
        2: [1999 * 12 + 11],
    }
    with pytest.raises(ValueError, match="bad date"):
        parse_station_history("SYNTH00000 201001", ids)
    with pytest.raises(ValueError, match="need"):
        parse_station_history("SYNTH00000", ids)


def test_homogenize_tiny_network(rng):
    # Networks with S <= n_pairs stations must not crash predictor
    # selection (argpartition kth bound): n_pairs clamps to S-1.
    S, T = 6, 1461  # 4 years daily
    from topotpu.core.dates import get_days_metadata as gdm

    days = gdm("2012-01-01", "2015-12-31")
    daily = rng.normal(10, 3, size=(S, T)).astype(np.float32)
    res = homogenize_network(
        daily, days.year, days.month,
        rng.uniform(-105, -104, S), rng.uniform(39, 40, S),
    )
    assert res.adjusted_daily.shape == daily.shape


def test_monthly_means_sparse_guard(daily_network):
    world, days, daily = daily_network
    d = daily.copy()
    d[0, :200] = np.nan  # first months sparse
    monthly, keys = monthly_means(d, days.year, days.month)
    assert np.isnan(monthly[0, 0])
    assert len(keys) == 144
    assert np.isfinite(monthly[1]).all()


def test_no_signal_documented_date_cannot_swallow_blind_break(daily_network):
    """A documented note with NO step signature (e.g. a time-of-observation
    change) lying within minseg — but beyond date_tol — of a genuine
    full-quorum SNHT break must not suppress or displace the blind
    adjustment. Mid-series, the freely-placed SNHT position is the stronger
    evidence, so the informed result must equal the blind result exactly."""
    world, days, daily = daily_network
    rng = np.random.default_rng(55)
    for amp, sig, doff in [(1.5, 0.0, 15), (1.0, 2.0, 15), (0.9, 2.0, 18)]:
        noisy = (daily + rng.normal(0, sig, daily.shape)).astype(np.float32)
        split = int(np.flatnonzero(days.ymd == 20100101)[0])
        noisy[3, :split] += amp  # genuine break near month 72
        blind = homogenize_network(
            noisy, days.year, days.month, world.stn_lon, world.stn_lat
        )
        assert blind.breakpoints[3], "fixture must produce a blind break"
        d = 72 + doff  # documented no-signal date: date_tol < doff < minseg
        informed = homogenize_network(
            noisy, days.year, days.month, world.stn_lon, world.stn_lat,
            station_history={3: [int((2004 + d // 12) * 12 + d % 12)]},
        )
        assert informed.breakpoints[3] == blind.breakpoints[3], (
            f"amp={amp} sig={sig} d={d}: metadata changed the adjustment "
            f"{blind.breakpoints[3]} -> {informed.breakpoints[3]}"
        )


def test_merge_attributions_fallback_and_position_evidence():
    # need=4, date_tol=6, minseg=24, 144-month series
    args = dict(need=4, date_tol=6, minseg=24, n_months=144)
    # guard-band-constrained cluster (center at the 120 = n-minseg edge):
    # documented date wins, displaced candidate recorded as its fallback
    acc, fb = merge_attributions(
        {"tmin": [(120, 8)], "tmax": []}, documented=(132,), **args
    )
    assert acc == {"tmin": [132], "tmax": [132]}
    assert fb["tmin"] == {132: 120}
    # freely-placed mid-series full-quorum cluster: the blind position is
    # the evidence; the no-snap documented date yields entirely
    acc, fb = merge_attributions(
        {"tmin": [(72, 8)], "tmax": []}, documented=(87,), **args
    )
    assert acc["tmin"] == [72]
    assert fb["tmin"] == {}
    # without n_months the geometry is unknown: documented always wins
    acc, fb = merge_attributions(
        {"tmin": [(72, 8)], "tmax": []}, documented=(87,),
        need=4, date_tol=6, minseg=24,
    )
    assert acc["tmin"] == [87]
    assert fb["tmin"] == {87: 72}


def test_vote_clusters_consumes_candidates_exactly_once():
    """Greedy clustering must neither double-count a candidate into two
    clusters (inflating votes toward a false quorum) nor skip candidates
    (losing real breaks) when pair dates are 1..2*date_tol apart."""
    from topotpu.homog.pha import vote_clusters

    breaks = np.array([0, 6, 12, 20], np.int32)
    got = vote_clusters(breaks, date_tol=6)
    assert got == [(3, 2), (12, 1), (20, 1)]
    assert sum(v for _, v in got) == len(breaks)  # each counted once

    # a dense run still forms one cluster per tol-window, votes exact
    breaks = np.array([10, 11, 12, 13, 30], np.int32)
    got = vote_clusters(breaks, date_tol=6)
    assert got == [(11, 4), (30, 1)]
    assert sum(v for _, v in got) == 5
