"""CLI smoke test: the full numbered pipeline on a tiny synthetic world
(every stage chained through the artifact files, like a user would run)."""

import json

from topotpu.cli.main import main
from topotpu.core.config import TopoConfig


def test_cli_full_pipeline(tmp_path, capsys):
    cfg = TopoConfig(
        data_dir=str(tmp_path / "data"),
        start_date="2015-01-01",
        end_date="2015-12-31",
        tile_rows=24,
        tile_cols=24,
    )
    cfg_path = tmp_path / "cfg.json"
    cfg.save(cfg_path)

    rc = main(["all", "--config", str(cfg_path), "--grid", "24",
               "--stations", "40"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    stages = [x["stage"] for x in lines]
    assert stages == ["synth-data", "qa", "homog", "infill", "krig-params",
                      "interp", "mosaic", "validate"]
    by = {x["stage"]: x["result"] for x in lines}
    assert by["interp"] == {"tmin": 1, "tmax": 1}
    assert by["validate"]["tmin"]["status"] == "ok"
    assert by["validate"]["tmax"]["status"] == "ok"
    assert (tmp_path / "data" / "mosaic_tmin.h5").exists()

    # direct-to-mosaic production (the packed single-process default): the
    # engine placed tiles straight into the final mosaic on the run-global
    # pack grid — no per-tile files exist, and the mosaic carries the
    # direct layout + finalization attrs
    import h5py
    import numpy as np

    from topotpu.io.ncdf import read_var

    assert not list((tmp_path / "data" / "tiles").glob("*_tile*.h5"))
    with h5py.File(tmp_path / "data" / "mosaic_tmin.h5") as f:
        assert f["tmin"].dtype == np.int16
        assert f.attrs["layout"] == "direct"
        assert bool(f.attrs["complete"]) and bool(f.attrs["reconciled"])
        g_scale = float(f["tmin"].attrs["scale_factor"])
    # run-global int16 grid == the config pack window
    assert np.isclose(
        g_scale, (cfg.pack_temp_hi - cfg.pack_temp_lo) / 65500.0
    )
    mosaic_daily = read_var(tmp_path / "data" / "mosaic_tmin.h5", "tmin")
    mosaic_tmax = read_var(tmp_path / "data" / "mosaic_tmax.h5", "tmax")
    fin = np.isfinite(mosaic_daily)
    assert np.array_equal(fin, np.isfinite(mosaic_tmax))
    # device-side reconcile on the SHARED lattice: tmax >= tmin exactly
    # (the two-step path only promises it within a quantization step)
    assert (mosaic_tmax[fin] >= mosaic_daily[fin]).all()

    # aggregate stage: monthly/annual means from the daily mosaic (the
    # reference's distributed dataset shipped these alongside dailies)
    rc = main(["aggregate", "--config", str(cfg_path)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["stage"] == "aggregate"
    assert out["result"]["tmin"]["months"] > 0
    with h5py.File(tmp_path / "data" / "agg_tmin.h5") as f:
        assert f["monthly"].dtype == np.int16  # daily pack grid reused
        t_m = f["time_month"][...]
        n_years = f["year"].shape[0]
        mon = read_var(tmp_path / "data" / "agg_tmin.h5", "monthly")
        ann = read_var(tmp_path / "data" / "agg_tmin.h5", "annual")
    assert mon.shape[0] == len(t_m) and ann.shape[0] == n_years
    # first month's mean == numpy mean of the daily mosaic, strict-finite
    epoch = np.datetime64("1948-01-01", "D")
    with h5py.File(tmp_path / "data" / "mosaic_tmin.h5") as f:
        d_dates = epoch + f["time"][...].astype("timedelta64[D]")
    m0 = d_dates.astype("datetime64[M]") == d_dates[0].astype("datetime64[M]")
    blk = mosaic_daily[m0]
    ref0 = np.where(np.isfinite(blk).all(0), blk.mean(0), np.nan)
    assert np.array_equal(np.isfinite(ref0), np.isfinite(mon[0]))
    ok0 = np.isfinite(ref0)
    assert np.abs(mon[0] - ref0)[ok0].max() <= g_scale + 1e-6
    # annual mean == day-weighted mean of the whole first year
    y0 = d_dates.astype("datetime64[Y]") == d_dates[0].astype("datetime64[Y]")
    blk = mosaic_daily[y0]
    refy = np.where(np.isfinite(blk).all(0), blk.mean(0), np.nan)
    oky = np.isfinite(refy)
    assert np.array_equal(oky, np.isfinite(ann[0]))
    assert np.abs(ann[0] - refy)[oky].max() <= g_scale + 1e-6

    rc = main(["xval-interp", "--config", str(cfg_path)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["stage"] == "xval-interp"
    # both variables, per month and per region (the paper-table protocol)
    for var in ("tmin", "tmax"):
        r = out["result"][var]
        assert r["mae_mean"] < 1.5
        assert len(r["mae_by_month"]) == 12
        assert r["mae_by_region"]  # single global region without regions.h5
        assert r["n_stations_scored"] > 0

    rc = main(["xval-daily", "--config", str(cfg_path)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["stage"] == "xval-daily"
    for var in ("tmin", "tmax"):
        r = out["result"][var]
        assert r["mae"] < 2.5
        assert r["rmse"] >= r["mae"]
        assert len(r["mae_by_month"]) == 12
        assert r["mae_by_region"]

    # make-regions: covariate-clustered climate-division stand-in, written
    # to data_dir/regions.h5 and picked up by optim-nnghs automatically
    rc = main(["make-regions", "--config", str(cfg_path), "--n-regions", "4"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["stage"] == "make-regions"
    assert out["result"]["n_regions"] >= 2
    assert sum(out["result"]["cells_per_region"].values()) > 0

    rc = main(["optim-nnghs", "--config", str(cfg_path)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["stage"] == "optim-nnghs"
    # per-variable sweeps: each variable optimized against its OWN serial
    # DB (the reference ran mpi_optim_nstns_* once per variable)
    for v in ("tmin", "tmax"):
        assert out["result"][v]["best_k_by_region"]
        assert out["result"][v]["best_k_anom_by_region"]

    # region-raster input: quadrant labels on the run grid -> per-region k
    import h5py
    import numpy as np

    reg = np.zeros((24, 24), np.int32)
    reg[:12, 12:] = 1
    reg[12:, :12] = 2
    reg[12:, 12:] = 3
    reg_path = tmp_path / "regions.h5"
    with h5py.File(reg_path, "w") as f:
        f.create_dataset("regions", data=reg)
    rc = main(["optim-nnghs", "--config", str(cfg_path),
               "--regions", str(reg_path)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    got = set(out["result"]["tmin"]["best_k_by_region"])
    assert got <= {"0", "1", "2", "3"} and len(got) >= 2
    assert set(out["result"]["tmax"]["best_k_by_region"]) == got

    rc = main(["validate-f64", "--config", str(cfg_path)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["stage"] == "validate-f64"
    assert out["result"]["tmin"]["within_parity_bar"] is True
    assert out["result"]["tmax"]["within_parity_bar"] is True

    # point stage: ad-hoc PtInterpTair-style site interpolation must agree
    # with the gridded product at the same cells (same code path; the
    # sites ARE a tiny cell batch)
    cs = 1.0 / 120.0
    sites = [(-106.0 + cs / 2 + 7 * cs, 41.0 - cs / 2 - 5 * cs),
             (-106.0 + cs / 2 + 15 * cs, 41.0 - cs / 2 - 11 * cs)]
    # NB --points=<...> form: a leading "-106.0" would otherwise parse as
    # an option flag
    rc = main(["point", "--config", str(cfg_path),
               "--points=" + ";".join(f"{x},{y}" for x, y in sites)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["result"]["tmin"]["ok_sites"] == 2
    import csv as _csv

    with open(tmp_path / "data" / "point_tmin_normals.csv") as f:
        rows = list(_csv.reader(f))
    assert len(rows) == 3 and rows[0][2] == "norm_01"
    with h5py.File(tmp_path / "data" / "mosaic_tmin.h5") as f:
        grid_norm = f["normal"][...]
    for i, (r, c) in enumerate([(5, 7), (11, 15)]):
        got = np.array([float(v) for v in rows[1 + i][2:14]])
        np.testing.assert_allclose(got, grid_norm[:, r, c], atol=5e-3)
    assert (tmp_path / "data" / "point_tmax_daily.csv").exists()

    # full daily-coverage scan: a hole punched at an arbitrary day (NOT day
    # 0 or the midpoint the old sampled check looked at) must flip validate
    # to incomplete (runs last: it corrupts the tmin mosaic)
    from topotpu.cli.steps import step_validate
    from topotpu.io.ncdf import FILL_I16

    with h5py.File(tmp_path / "data" / "mosaic_tmin.h5", "r+") as f:
        d = f["tmin"]
        day = 17
        assert day not in (0, d.shape[0] // 2)
        sl = d[day]
        sl[sl != FILL_I16] = FILL_I16  # hole every land cell on one day
        d[day] = sl
    # deep (full-scan) validate reports the hole as lost coverage
    val = step_validate(TopoConfig.load(cfg_path), deep=True)
    assert val["tmin"]["status"] == "incomplete"
    assert val["tmin"]["daily_coverage"] < 0.01
    assert val["tmax"]["status"] == "ok"
    # the default streamed validate's disk sample hits a corrupted tile
    # (the hole spans every tile) and must REFUSE loudly, not report the
    # pre-corruption streamed stats as ok
    import pytest

    with pytest.raises(RuntimeError, match="disagrees with the product"):
        step_validate(TopoConfig.load(cfg_path))


def test_all_stage_resume(tmp_path, capsys):
    """`all` is relaunch-safe (SURVEY §5: the artifact chain is the
    checkpoint): a second identical invocation skips every completed
    stage instead of recomputing it; a stage with a missing artifact
    re-runs and CASCADES (everything downstream re-runs too); --redo
    forces a full re-run; and a mismatched world request fails loudly
    instead of silently mixing artifacts from two worlds."""
    import pytest

    cfg = TopoConfig(
        data_dir=str(tmp_path / "data"),
        # full calendar year: validate's normals criterion needs all 12
        # monthly planes representable in the span
        start_date="2015-01-01",
        end_date="2015-12-31",
        tile_rows=20,
        tile_cols=20,
    )
    cfg_path = tmp_path / "cfg.json"
    cfg.save(cfg_path)
    args = ["all", "--config", str(cfg_path), "--grid", "20",
            "--stations", "32"]

    def stage_results(rc):
        assert rc == 0
        return {
            x["stage"]: x["result"]
            for x in (json.loads(line)
                      for line in capsys.readouterr().out.splitlines())
        }

    heavy = ["synth-data", "qa", "homog", "infill", "krig-params"]
    first = stage_results(main(args))
    assert not any(
        isinstance(first[s], str) and "skipped" in first[s] for s in heavy
    )

    data = tmp_path / "data"
    artifacts = [data / "homog.h5", data / "serial_tmin.h5",
                 data / "serial_tmax.h5", data / "all_obs.h5"]
    mtimes = {a: a.stat().st_mtime_ns for a in artifacts}

    # identical relaunch: every heavy stage skips, artifacts untouched,
    # and the verification stages still run and still pass
    second = stage_results(main(args))
    for s in heavy:
        assert second[s].startswith("skipped"), (s, second[s])
    assert {a: a.stat().st_mtime_ns for a in artifacts} == mtimes
    assert second["validate"]["tmin"]["status"] == "ok"

    # cascade: a deleted mid-chain artifact re-runs that stage AND all
    # downstream stages, even though their artifacts exist
    (data / "homog.h5").unlink()
    third = stage_results(main(args))
    assert third["synth-data"].startswith("skipped")
    assert third["qa"].startswith("skipped")
    for s in ("homog", "infill", "krig-params"):
        assert not (isinstance(third[s], str)
                    and third[s].startswith("skipped")), (s, third[s])
    assert third["validate"]["tmin"]["status"] == "ok"

    # --redo: nothing skips
    redone = stage_results(main(args + ["--redo"]))
    assert not any(
        isinstance(redone[s], str) and "skipped" in redone[s] for s in heavy
    )

    # a different world into the same data_dir must fail loudly (silently
    # skipping would serve the OLD world; silently regenerating would
    # orphan downstream artifacts)
    with pytest.raises(ValueError, match="different synthetic world"):
        main(["all", "--config", str(cfg_path), "--grid", "20",
              "--stations", "48"])


def test_reconcile_cross_variable_packed(tmp_path):
    """int16-packed mosaics: midpoints outside a variable's representable
    pack range must CLIP (an unclipped cast wraps, and the first overflow
    step is the fill sentinel); sub-quantization-step crossings must be
    tolerated, not 'fixed'."""
    import h5py
    import numpy as np

    from topotpu.cli.steps import reconcile_cross_variable
    from topotpu.io.ncdf import FILL_I16, read_var

    rng = np.random.default_rng(7)
    tmin = np.clip(
        rng.normal(0, 1, (32, 4, 4)), -5, 5
    ).astype(np.float32)
    tmax = tmin + 2.0
    # a crossing whose midpoint (10.0) exceeds tmax's packed range below
    tmin[3, 1, 1], tmax[3, 1, 1] = 16.0, 4.0

    def write(path, name, data, lo, hi):
        scale = (hi - lo) / 65500.0
        off = 0.5 * (hi + lo)
        q = np.round((data - off) / scale).astype(np.int16)
        with h5py.File(path, "w") as f:
            v = f.create_dataset(name, data=q)
            v.attrs["scale_factor"] = np.float32(scale)
            v.attrs["add_offset"] = np.float32(off)
            v.attrs["_FillValue"] = FILL_I16
        return scale

    pn = tmp_path / "mosaic_tmin.h5"
    px = tmp_path / "mosaic_tmax.h5"
    s_n = write(pn, "tmin", tmin, -20.0, 20.0)
    s_x = write(px, "tmax", tmax, -8.0, 8.0)  # midpoint 10 > range top

    res = reconcile_cross_variable(pn, px, time_chunk=8)
    assert res["violations"] == 1
    a = read_var(pn, "tmin")
    b = read_var(px, "tmax")
    # clipped to tmax's representable ceiling — finite, NOT wrapped to NaN
    # or a huge negative
    assert np.isfinite(b[3, 1, 1]) and abs(b[3, 1, 1] - 8.0) < 0.01
    assert abs(a[3, 1, 1] - 10.0) < 0.01  # tmin side reaches the midpoint
    assert np.isfinite(a).all() and np.isfinite(b).all()
    # every other cell untouched beyond decode quantization — no cell was
    # "fixed" for a sub-eps packing artifact
    keep = np.ones(a.shape, bool)
    keep[3, 1, 1] = False
    np.testing.assert_allclose(a[keep], tmin[keep], atol=2 * s_n)
    np.testing.assert_allclose(b[keep], tmax[keep], atol=2 * s_x)


def test_reconcile_cross_variable(tmp_path):
    """Adversarial tmin/tmax: planted crossings are found, reconciled to the
    midpoint (mean-preserving), and everything else is untouched."""
    import h5py
    import numpy as np

    from topotpu.cli.steps import reconcile_cross_variable

    rng = np.random.default_rng(5)
    tmin = rng.normal(0, 5, (100, 8, 8)).astype(np.float32)
    tmax = tmin + 8.0
    tmin[3, 2, 2], tmax[3, 2, 2] = 10.0, 7.0    # crossing of 3.0 C
    tmax[40, 5, 1] = tmin[40, 5, 1] - 0.25      # sub-noise crossing
    tmin[7, 0, 0] = np.nan                       # masked cells stay masked
    tmax[9, 1, 1] = np.nan

    pn, px = tmp_path / "mosaic_tmin.h5", tmp_path / "mosaic_tmax.h5"
    with h5py.File(pn, "w") as f:
        f.create_dataset("tmin", data=tmin)
    with h5py.File(px, "w") as f:
        f.create_dataset("tmax", data=tmax)

    res = reconcile_cross_variable(pn, px, time_chunk=16)
    assert res["violations"] == 2
    assert abs(res["worst_crossing_C"] - 3.0) < 1e-6

    with h5py.File(pn) as f:
        a = f["tmin"][...]
    with h5py.File(px) as f:
        b = f["tmax"][...]
    assert abs(a[3, 2, 2] - 8.5) < 1e-6 and abs(b[3, 2, 2] - 8.5) < 1e-6
    fin = np.isfinite(a) & np.isfinite(b)
    assert (b[fin] >= a[fin]).all()
    assert np.isnan(a[7, 0, 0]) and np.isnan(b[9, 1, 1])
    # untouched elsewhere
    assert abs(b[50, 3, 3] - (a[50, 3, 3] + 8.0)) < 1e-6


def test_point_rejects_out_of_grid_sites(tmp_path):
    """A site outside the grid must error — rowcol() clips, so without the
    raw-index check a far-away point silently interpolates at a border
    cell."""
    import dataclasses

    import pytest

    from topotpu.cli import steps

    cfg = TopoConfig(
        data_dir=str(tmp_path / "data"),
        start_date="2015-01-01", end_date="2015-01-31",
        tile_rows=24, tile_cols=24,
    )
    steps.step_synth_data(cfg, nrows=24, ncols=24, n_stations=30)
    # synthetic worlds are centered near (-104, 40); (0, 0) is oceans away
    with pytest.raises(ValueError, match="outside the run's grid"):
        steps.step_point(cfg, [(0.0, 0.0)])


def test_mosaic_refuses_to_publish_empty(tmp_path):
    """A mosaic rerun that finds zero tile files must abort and leave any
    previously published mosaics untouched (not overwrite them with
    all-fill data)."""
    import dataclasses

    import pytest

    from topotpu.cli import steps

    cfg = TopoConfig(
        data_dir=str(tmp_path / "data"),
        start_date="2015-01-01", end_date="2015-01-31",
        tile_rows=24, tile_cols=24,
    )
    steps.step_synth_data(cfg, nrows=24, ncols=24, n_stations=30)
    (tmp_path / "data" / "tiles").mkdir()
    # stand-ins for previously published good mosaics
    for v in ("tmin", "tmax"):
        (tmp_path / "data" / f"mosaic_{v}.h5").write_bytes(b"precious")
    with pytest.raises(RuntimeError, match="no tile files"):
        steps.step_mosaic(cfg)
    for v in ("tmin", "tmax"):
        assert (tmp_path / "data" / f"mosaic_{v}.h5").read_bytes() == b"precious"
        assert not (tmp_path / "data" / f"mosaic_{v}.tmp").exists()


def test_validate_day_axis_mismatch_fails_loudly(tmp_path):
    """A stale/truncated mosaic with a shorter day axis must fail validate
    with a clear error — the shared-range streaming scan would otherwise
    read EMPTY blocks past its end and silently count the missing trailing
    days as covered (all() over an empty axis is True)."""
    import dataclasses

    import h5py
    import numpy as np
    import pytest

    from topotpu.cli.steps import step_validate
    from topotpu.core.dates import get_days_metadata
    from topotpu.io.rasters import RasterStack
    from topotpu.io.synthetic import make_world

    rng = np.random.default_rng(7)
    days = get_days_metadata("2015-01-01", "2015-02-28")
    world = make_world(rng, nrows=8, ncols=8, n_stations=10,
                       ndays=days.ndays)
    RasterStack.from_world(world).save(tmp_path / "rasters.h5")
    for var, nd in (("tmin", days.ndays), ("tmax", days.ndays - 10)):
        with h5py.File(tmp_path / f"mosaic_{var}.h5", "w") as f:
            f.create_dataset(var, data=np.zeros((nd, 8, 8), np.float32))
            for name in ("normal", "se"):
                f.create_dataset(name, data=np.zeros((12, 8, 8), np.float32))
    cfg = dataclasses.replace(
        TopoConfig(), data_dir=str(tmp_path),
        start_date="2015-01-01", end_date="2015-02-28",
    )
    with pytest.raises(RuntimeError, match="day-axis mismatch"):
        step_validate(cfg)


def test_cli_xval_infill_per_variable(tmp_path, capsys):
    """xval-infill scores BOTH variables (the reference ran one x-val job
    per variable), straight off the all-obs DB when no homog artifact
    exists."""
    cfg = TopoConfig(
        data_dir=str(tmp_path / "data"),
        start_date="2015-01-01",
        end_date="2015-12-31",
        tile_rows=24,
        tile_cols=24,
    )
    cfg_path = tmp_path / "cfg.json"
    cfg.save(cfg_path)
    rc = main(["synth-data", "--config", str(cfg_path), "--grid", "24",
               "--stations", "40"])
    assert rc == 0
    capsys.readouterr()
    rc = main(["xval-infill", "--config", str(cfg_path)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["stage"] == "xval-infill"
    for var in ("tmin", "tmax"):
        r = out["result"][var]
        assert r["n_holdout"] > 0
        # 40-station fixture: tmax carries 1.5 C iid obs noise on top of
        # the sparse-network error; this is a wiring check
        assert r["mae"] < 3.0
        assert abs(r["bias"]) < 0.5
