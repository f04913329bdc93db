"""Direct-to-mosaic production mode (TileEngine + io.ncdf.MosaicWriter):
tiles land straight in the final mosaic on a run-global int16 grid, with
manifest-based resume and device-side cross-variable reconcile. Must match
the two-step per-tile-file path within quantization."""

import dataclasses
import json

import numpy as np
import pytest

from topotpu.core.config import TopoConfig, InterpParams, MeshParams
from topotpu.core.dates import get_days_metadata
from topotpu.dist.engine import TileEngine, StationSet
from topotpu.io.ncdf import read_var
from topotpu.io.rasters import RasterStack
from topotpu.io.synthetic import make_world


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(43)
    days = get_days_metadata("2014-01-01", "2015-12-31")  # 2 years
    world = make_world(rng, nrows=48, ncols=48, n_stations=60,
                       ndays=days.ndays)
    rasters = RasterStack.from_world(world)
    nug, ps, rg = world.true_vario
    a = StationSet(
        lon=world.stn_lon, lat=world.stn_lat, elev=world.stn_elev,
        tdi=world.stn_tdi, lst=world.stn_lst, norm=world.stn_norm,
        vario=np.tile(np.array([nug, ps, rg], np.float32), (60, 12, 1)),
        valid=np.ones((60, 12), bool),
        anoms=world.stn_anoms.astype(np.float32),
    )
    # +9 C offset keeps daily tmax > tmin everywhere (anoms span a few C),
    # so the device reconcile is a no-op and parity checks stay clean
    b = dataclasses.replace(
        a, norm=a.norm + 9.0, anoms=(a.anoms * 0.85).astype(np.float32)
    )
    return world, days, rasters, a, b


def _config():
    return TopoConfig(
        start_date="2014-01-01", end_date="2015-12-31",
        tile_rows=24, tile_cols=24,   # 48x48 world -> 4 tiles
        interp=InterpParams(k_neighbors=16, max_tile_stations=64),
        mesh=MeshParams(n_devices=8),
    )


def _mosaic_paths(d):
    return {v: d / f"mosaic_{v}.h5" for v in ("tmin", "tmax")}


def _direct_engine(cfg, rasters, days, out_dir):
    out_dir.mkdir(parents=True, exist_ok=True)
    return TileEngine(cfg, rasters, days, out_dir / "tiles",
                      mosaic_paths=_mosaic_paths(out_dir))


def test_direct_matches_two_step(tmp_path, setup):
    world, days, rasters, a, b = setup
    cfg = _config()

    eng_d = _direct_engine(cfg, rasters, days, tmp_path / "direct")
    assert eng_d._direct
    assert eng_d.run_pair("tmin", "tmax", a, b, progress=False) == {
        "tmin": 4, "tmax": 4
    }
    # no per-tile files in direct mode — the mosaic IS the output
    assert not list((tmp_path / "direct" / "tiles").glob("*_tile*.h5"))

    eng_t = TileEngine(cfg, rasters, days, tmp_path / "twostep")
    assert not eng_t._direct  # no mosaic paths -> per-tile files
    eng_t.run_pair("tmin", "tmax", a, b, progress=False)

    import h5py

    from topotpu.core.grid import Tiling

    tiling = Tiling(rasters.grid, 24, 24)
    g_step = (cfg.pack_temp_hi - cfg.pack_temp_lo) / 65500.0
    for var in ("tmin", "tmax"):
        mp = tmp_path / "direct" / f"mosaic_{var}.h5"
        with h5py.File(mp) as f:
            assert f.attrs["layout"] == "direct"
            assert bool(f.attrs["complete"])
            assert bool(f.attrs["reconciled"])
            assert f.attrs["n_tiles"] == 4
            assert f[var].dtype == np.int16
        m_daily = read_var(mp, var)
        m_norm = read_var(mp, "normal")
        m_se = read_var(mp, "se")
        for ts in tiling.land_tiles(rasters.landmask):
            tf = tmp_path / "twostep" / f"{var}_tile{ts.tile_id:05d}.h5"
            sl = (slice(ts.row0, ts.row0 + ts.nrows),
                  slice(ts.col0, ts.col0 + ts.ncols))
            t_daily = read_var(tf, var)
            fin = np.isfinite(t_daily)
            assert np.array_equal(fin, np.isfinite(m_daily[(slice(None),) + sl]))
            # per-tile dynamic grid vs run-global grid: half a step of each
            with h5py.File(tf) as f:
                t_step = abs(float(f[var].attrs.get("scale_factor", 0.0)))
            eps = 0.5 * (g_step + t_step) + 1e-5
            assert (
                np.abs(m_daily[(slice(None),) + sl] - t_daily)[fin].max()
                <= eps
            )
            np.testing.assert_allclose(
                np.nan_to_num(m_norm[(slice(None),) + sl]),
                np.nan_to_num(read_var(tf, f"{var}_normal")),
                atol=5e-3,
            )
            np.testing.assert_allclose(
                np.nan_to_num(m_se[(slice(None),) + sl]),
                np.nan_to_num(read_var(tf, f"{var}_se")),
                atol=5e-3,
            )


def test_direct_resume_and_fresh_invalidation(tmp_path, setup):
    world, days, rasters, a, b = setup
    cfg = _config()

    eng = _direct_engine(cfg, rasters, days, tmp_path / "run")
    assert eng.run_pair("tmin", "tmax", a, b, progress=False)["tmin"] == 4
    before = read_var(tmp_path / "run" / "mosaic_tmin.h5", "tmin")

    # resume semantics: drop two tiles' manifest claims -> exactly those
    # tiles recompute (idempotent in-place rewrite), product unchanged
    man_path = tmp_path / "run" / "tiles" / "manifest.json"
    man = json.loads(man_path.read_text())
    dropped = [k for k in list(man["tiles"]) if k.endswith("00001")]
    assert len(dropped) == 2  # tmin_00001 + tmax_00001
    for k in dropped:
        del man["tiles"][k]
    man_path.write_text(json.dumps(man))
    eng2 = _direct_engine(cfg, rasters, days, tmp_path / "run")
    assert eng2.run_pair("tmin", "tmax", a, b, progress=False)["tmin"] == 1
    after = read_var(tmp_path / "run" / "mosaic_tmin.h5", "tmin")
    fin = np.isfinite(before)
    assert np.array_equal(fin, np.isfinite(after))
    assert np.array_equal(
        np.nan_to_num(before), np.nan_to_num(after)
    )  # same lattice -> bitwise

    # a changed pack window makes old int16 undecodable on the new grid:
    # the writer must rebuild and the engine must drop ALL manifest claims
    cfg2 = dataclasses.replace(cfg, pack_temp_lo=-80.0)
    eng3 = _direct_engine(cfg2, rasters, days, tmp_path / "run")
    assert eng3.run_pair("tmin", "tmax", a, b, progress=False)["tmin"] == 4
    rebuilt = read_var(tmp_path / "run" / "mosaic_tmin.h5", "tmin")
    assert np.allclose(
        np.nan_to_num(rebuilt), np.nan_to_num(before), atol=5e-3
    )


def test_direct_chunked_production(tmp_path, setup):
    """run_production_pair in direct mode: every chunk writes its day range
    of ONE full-span mosaic; normals land once; resume stays per-chunk."""
    world, days, rasters, a, b = setup
    cfg = _config()

    eng_c = _direct_engine(cfg, rasters, days, tmp_path / "chunked")
    assert eng_c.run_production_pair(
        "tmin", "tmax", a, b, years_per_chunk=1, progress=False
    ) == {"tmin": 8, "tmax": 8}  # 2 chunks x 4 tiles

    eng_f = _direct_engine(cfg, rasters, days, tmp_path / "fullspan")
    eng_f.run_pair("tmin", "tmax", a, b, progress=False)

    import h5py

    g_step = (cfg.pack_temp_hi - cfg.pack_temp_lo) / 65500.0
    for var in ("tmin", "tmax"):
        cp = tmp_path / "chunked" / f"mosaic_{var}.h5"
        with h5py.File(cp) as f:
            assert bool(f.attrs["complete"]) and bool(f.attrs["reconciled"])
            assert f[var].shape[0] == days.ndays  # full span, one file
        d_c = read_var(cp, var)
        d_f = read_var(tmp_path / "fullspan" / f"mosaic_{var}.h5", var)
        fin = np.isfinite(d_f)
        assert np.array_equal(fin, np.isfinite(d_c))
        # same lattice; chunked anomaly windows differ only by float-assoc
        assert np.abs(d_c - d_f)[fin].max() <= g_step + 1e-5
        np.testing.assert_allclose(
            np.nan_to_num(read_var(cp, "normal")),
            np.nan_to_num(
                read_var(tmp_path / "fullspan" / f"mosaic_{var}.h5", "normal")
            ),
            atol=1e-4,
        )

    # per-chunk resume: wipe one chunk's manifest -> only its 4 tile-pairs
    # recompute, into the same mosaic
    man = (tmp_path / "chunked" / "tiles" / "chunk_2015_2015"
           / "manifest.json")
    man.write_text(json.dumps({"tiles": {}}))
    eng_c2 = _direct_engine(cfg, rasters, days, tmp_path / "chunked")
    assert eng_c2.run_production_pair(
        "tmin", "tmax", a, b, years_per_chunk=1, progress=False
    ) == {"tmin": 4, "tmax": 4}


def test_direct_reconcile_on_device(tmp_path, setup):
    """Adversarial crossings (tmax ~ tmin - 0.5): the device-side reconcile
    must leave tmax >= tmin EXACTLY in the packed mosaic (shared lattice)
    and collapse crossings to their midpoint."""
    world, days, rasters, a, _ = setup
    bad_b = dataclasses.replace(a, norm=a.norm - 0.5)
    cfg = _config()

    eng = _direct_engine(cfg, rasters, days, tmp_path / "x")
    eng.run_pair("tmin", "tmax", a, bad_b, progress=False)
    d_min = read_var(tmp_path / "x" / "mosaic_tmin.h5", "tmin")
    d_max = read_var(tmp_path / "x" / "mosaic_tmax.h5", "tmax")
    fin = np.isfinite(d_min) & np.isfinite(d_max)
    assert fin.any()
    assert (d_max[fin] >= d_min[fin]).all()
    # crossings collapsed to a shared value (midpoint): equal after packing
    eq = d_max[fin] == d_min[fin]
    assert eq.mean() > 0.5  # -0.5 C offset: most cells crossed


def test_direct_swapped_order_skips_device_reconcile(tmp_path, setup):
    """The device reconcile enforces var_b >= var_a, so a (tmax, tmin)
    call order must NOT engage it (it would enforce tmin >= tmax); the
    mosaics complete but stay marked unreconciled for the mosaic stage's
    host reconcile pass."""
    world, days, rasters, a, b = setup
    cfg = _config()

    eng = _direct_engine(cfg, rasters, days, tmp_path / "swap")
    assert eng.run_pair("tmax", "tmin", b, a, progress=False) == {
        "tmax": 4, "tmin": 4
    }
    import h5py

    for var in ("tmin", "tmax"):
        with h5py.File(tmp_path / "swap" / f"mosaic_{var}.h5") as f:
            assert bool(f.attrs["complete"])
            assert not bool(f.attrs["reconciled"])

    # b > a everywhere (the +9 C fixture), so with the reconcile correctly
    # disabled the swapped run reproduces the normal-order values exactly
    # (same lattice, reconcile a no-op there too)
    eng_n = _direct_engine(cfg, rasters, days, tmp_path / "norm")
    eng_n.run_pair("tmin", "tmax", a, b, progress=False)
    for var in ("tmin", "tmax"):
        s = read_var(tmp_path / "swap" / f"mosaic_{var}.h5", var)
        n = read_var(tmp_path / "norm" / f"mosaic_{var}.h5", var)
        assert np.array_equal(np.isfinite(s), np.isfinite(n))
        assert np.array_equal(np.nan_to_num(s), np.nan_to_num(n))


def test_stale_direct_mosaic_does_not_mask_newer_tiles(tmp_path, setup):
    """A completed direct-mode mosaic left on disk must not short-circuit
    the mosaic stage after a LATER interp run wrote per-tile output (e.g.
    output_pack switched off for f32 archival tiles while mosaic_direct
    stays at its default True). The engine manifests record where the
    newest data lives; the mosaic stage must assemble the newer tiles."""
    import dataclasses as dc

    from topotpu.cli.steps import step_mosaic

    world, days, rasters, a, b = setup
    cfg = _config()
    d = tmp_path / "stale"
    # 1) direct run: complete+reconciled mosaics, mosaic-backed claims
    eng = _direct_engine(cfg, rasters, days, d)
    eng.run_pair("tmin", "tmax", a, b, progress=False)

    # 2) later per-tile run in the same data dir with SHIFTED values, so
    # the stale mosaic and the fresh tiles are distinguishable
    b2 = dataclasses.replace(b, norm=b.norm + 2.0)
    cfg_tiles = dc.replace(cfg, output_pack=False)
    eng2 = TileEngine(cfg_tiles, rasters, days, d / "tiles")
    assert not eng2._direct
    eng2.run_pair("tmin", "tmax", a, b2, progress=False)

    # 3) mosaic stage with the ORIGINAL config (mosaic_direct=True): must
    # rebuild from the newer tiles, not early-return on the stale attrs
    rasters.save(d / "rasters.h5")
    cfg_mos = dc.replace(cfg, data_dir=str(d))
    step_mosaic(cfg_mos)

    got = read_var(d / "mosaic_tmax.h5", "normal")
    fin = np.isfinite(got)
    assert fin.any()
    # tile normals came from b2 = b + 2.0; the stale direct mosaic held b.
    # Rebuild happened iff the mosaic tracks the shifted field.
    eng3 = _direct_engine(cfg, rasters, days, tmp_path / "ref2")
    eng3.run_pair("tmin", "tmax", a, b2, progress=False)
    ref = read_var(tmp_path / "ref2" / "mosaic_tmax.h5", "normal")
    assert np.nanmean(np.abs(got - ref)) < 0.05, (
        "mosaic stage served the stale direct mosaic instead of "
        "assembling the newer per-tile output"
    )


def test_direct_tile_done_requires_mosaic_backed_claim(tmp_path, setup):
    """In direct mode a manifest claim marks a tile done only if it points
    at THIS mosaic: a claim recorded by an earlier per-tile run does not
    put the tile's data into the mosaic, so it must be recomputed."""
    world, days, rasters, a, b = setup
    cfg = _config()
    eng = _direct_engine(cfg, rasters, days, tmp_path / "gate")
    spec = next(eng.tiling.land_tiles(rasters.landmask))
    key = eng._tile_key(spec, "tmin")

    eng.manifest["tiles"][key] = {"file": "tmin_tile00000.h5", "ts": 1.0}
    assert not eng._tile_done(spec, "tmin")
    eng.manifest["tiles"][key] = {"file": "mosaic_tmin.h5", "ts": 2.0}
    assert eng._tile_done(spec, "tmin")


def test_mode_switch_to_direct_warns_and_recomputes(tmp_path, setup, capsys):
    """Switching an existing per-tile run to direct mode must (a) keep the
    per-tile manifest claims intact (the manifest-is-checkpoint contract),
    (b) print a note that those tiles will be recomputed, and (c) actually
    recompute all of them into the fresh mosaic."""
    world, days, rasters, a, b = setup
    cfg = _config()
    d = tmp_path / "switch"
    eng_t = TileEngine(cfg, rasters, days, d / "tiles")
    eng_t.run_pair("tmin", "tmax", a, b, progress=False)
    man_before = json.loads((d / "tiles" / "manifest.json").read_text())
    assert len(man_before["tiles"]) == 8  # 4 tiles x 2 vars, tile-backed

    eng_d = _direct_engine(cfg, rasters, days, d)
    capsys.readouterr()
    out = eng_d.run_pair("tmin", "tmax", a, b, progress=False)
    assert out == {"tmin": 4, "tmax": 4}  # nothing skipped
    assert "recomputes those tiles" in capsys.readouterr().out

    man_after = json.loads((d / "tiles" / "manifest.json").read_text())
    files = {info["file"] for info in man_after["tiles"].values()}
    assert files == {"mosaic_tmin.h5", "mosaic_tmax.h5"}
    import h5py

    for var in ("tmin", "tmax"):
        with h5py.File(d / f"mosaic_{var}.h5") as f:
            assert bool(f.attrs["complete"])


def test_corrupt_mosaic_recovers_fresh(tmp_path, setup):
    """A half-written/corrupt mosaic file from a crash must be detected at
    open (unreadable -> rebuilt fresh), its stale mosaic-backed manifest
    claims dropped, and the full product rebuilt."""
    world, days, rasters, a, b = setup
    cfg = _config()
    d = tmp_path / "corrupt"
    (d / "tiles").mkdir(parents=True)
    # garbage where the mosaic should be + a manifest claiming tiles in it
    (d / "mosaic_tmin.h5").write_bytes(b"\x00" * 512)
    (d / "tiles" / "manifest.json").write_text(json.dumps({
        "tiles": {"tmin_00000": {"file": "mosaic_tmin.h5", "ts": 1.0},
                  "tmax_00000": {"file": "mosaic_tmax.h5", "ts": 1.0}}
    }))
    eng = _direct_engine(cfg, rasters, days, d)
    out = eng.run_pair("tmin", "tmax", a, b, progress=False)
    assert out == {"tmin": 4, "tmax": 4}  # nothing falsely skipped
    import h5py

    for var in ("tmin", "tmax"):
        with h5py.File(d / f"mosaic_{var}.h5") as f:
            assert bool(f.attrs["complete"])
            assert f.attrs["n_tiles"] == 4


def test_resume_open_clears_stale_complete_attrs(tmp_path, setup):
    """Resume-opening a FINALIZED mosaic (forced recompute: manifest cleared,
    mosaic kept) must pop the stale complete/reconciled attrs — a crash
    mid-rewrite would otherwise leave a half-updated mosaic that downstream
    stages accept as finished. finalize() re-stamps them on success."""
    import h5py

    from topotpu.io.ncdf import MosaicWriter

    world, days, rasters, a, b = setup
    cfg = _config()
    d = tmp_path / "re"
    eng = _direct_engine(cfg, rasters, days, d)
    eng.run_pair("tmin", "tmax", a, b, progress=False)
    with h5py.File(d / "mosaic_tmin.h5") as f:
        assert bool(f.attrs["complete"]) and bool(f.attrs["reconciled"])

    g_step = (cfg.pack_temp_hi - cfg.pack_temp_lo) / 65500.0
    g_off = 0.5 * (cfg.pack_temp_hi + cfg.pack_temp_lo)
    w = MosaicWriter(d / "mosaic_tmin.h5", "tmin", rasters.grid,
                     days.date64, g_step, g_off, 24, 24)
    assert not w.fresh  # same shape + pack grid -> resume, data kept
    w.close()
    with h5py.File(d / "mosaic_tmin.h5") as f:
        assert "complete" not in f.attrs
        assert "reconciled" not in f.attrs

    # the engine path restores completeness end-to-end: clear the manifest,
    # rerun -> all tiles rewritten in place, attrs re-stamped
    (d / "tiles" / "manifest.json").write_text(json.dumps({"tiles": {}}))
    eng2 = _direct_engine(cfg, rasters, days, d)
    assert eng2.run_pair("tmin", "tmax", a, b, progress=False)["tmin"] == 4
    with h5py.File(d / "mosaic_tmin.h5") as f:
        assert bool(f.attrs["complete"]) and bool(f.attrs["reconciled"])


def test_streamed_validate_matches_deep(tmp_path, setup):
    """The engine records write-verification stats per tile (readback
    through the HDF5 layer + raw crossvar re-check); validate's default
    mode aggregates them + samples the disk, and must agree with the full
    --deep scan on a clean product. Chunked production included (per-chunk
    stats AND across chunks)."""
    from topotpu.cli.steps import step_validate

    world, days, rasters, a, b = setup
    cfg = _config()

    for name, chunked in (("plain", False), ("chunk", True)):
        d = tmp_path / name
        eng = _direct_engine(cfg, rasters, days, d)
        if chunked:
            eng.run_production_pair("tmin", "tmax", a, b,
                                    years_per_chunk=1, progress=False)
        else:
            eng.run_pair("tmin", "tmax", a, b, progress=False)
        rasters.save(d / "rasters.h5")
        vcfg = dataclasses.replace(
            cfg, data_dir=str(d), validate_sample_frac=0.5
        )
        fast = step_validate(vcfg)
        assert fast["mode"] == "streamed"
        assert fast["deep_sampled_tiles"] >= 1
        deep = step_validate(vcfg, deep=True)
        for var in ("tmin", "tmax"):
            assert fast[var]["status"] == deep[var]["status"] == "ok"
            for key in ("normal_coverage", "se_coverage", "daily_coverage"):
                assert fast[var][key] == deep[var][key] == 1.0, (name, var, key)
        assert fast["crossvar"]["violations"] == 0
        assert deep["crossvar"]["violations"] == 0


def test_streamed_validate_falls_back_on_per_tile_runs(tmp_path, setup):
    """Per-tile layouts carry no streamed verify stats — the default
    validate must transparently run the full scan (no 'mode' marker)."""
    import dataclasses as dc

    from topotpu.cli.steps import step_mosaic, step_validate

    world, days, rasters, a, b = setup
    cfg = dc.replace(_config(), mosaic_direct=False)
    d = tmp_path / "tiles_mode"
    eng = TileEngine(cfg, rasters, days, d / "tiles")
    assert not eng._direct
    eng.run_pair("tmin", "tmax", a, b, progress=False)
    rasters.save(d / "rasters.h5")
    vcfg = dc.replace(cfg, data_dir=str(d))
    step_mosaic(vcfg)
    val = step_validate(vcfg)
    assert "mode" not in val
    assert val["tmin"]["status"] == "ok"


def test_streamed_validate_unsampled_corruption_needs_deep(tmp_path, setup):
    """Corruption in a tile the disk sample does NOT visit passes the fast
    validate (documented trade-off of the streamed mode) but must be caught
    by --deep — and corruption in a SAMPLED tile must raise loudly."""
    import h5py
    import pytest

    from topotpu.cli.steps import step_validate
    from topotpu.core.grid import Tiling
    from topotpu.io.ncdf import FILL_I16

    world, days, rasters, a, b = setup
    cfg = _config()
    d = tmp_path / "corrupt2"
    eng = _direct_engine(cfg, rasters, days, d)
    eng.run_pair("tmin", "tmax", a, b, progress=False)
    rasters.save(d / "rasters.h5")
    vcfg = dataclasses.replace(cfg, data_dir=str(d),
                               validate_sample_frac=0.3)
    tiling = Tiling(rasters.grid, cfg.tile_rows, cfg.tile_cols)
    land_tiles = list(tiling.land_tiles(rasters.landmask))
    sampled_ids = {
        ts.tile_id for ts in land_tiles
        if (ts.tile_id * 2654435761 % 2**32) / 2**32 < 0.3
    } or {land_tiles[0].tile_id}
    unsampled = [ts for ts in land_tiles if ts.tile_id not in sampled_ids]
    assert unsampled, "fixture needs at least one unsampled tile"
    ts = unsampled[0]

    def punch(tile):
        with h5py.File(d / "mosaic_tmin.h5", "r+") as f:
            dset = f["tmin"]
            sl = (slice(None), slice(tile.row0, tile.row0 + tile.nrows),
                  slice(tile.col0, tile.col0 + tile.ncols))
            blk = dset[sl]
            blk[:] = FILL_I16
            dset[sl] = blk

    punch(ts)
    fast = step_validate(vcfg)          # sample missed it: stale-ok
    assert fast["mode"] == "streamed"
    deep = step_validate(vcfg, deep=True)
    assert deep["tmin"]["daily_coverage"] < fast["tmin"]["daily_coverage"]

    # now corrupt a sampled tile: the fast path must refuse loudly
    punch(next(t for t in land_tiles if t.tile_id in sampled_ids))
    with pytest.raises(RuntimeError, match="disagrees with the product"):
        step_validate(vcfg)


def test_streamed_validate_exact_cross_chunk_coverage(tmp_path, setup,
                                                      monkeypatch):
    """Coverage across chunks is EXACT:
    cell A uncovered only in chunk 1 and cell B uncovered only in chunk 2
    must BOTH count as uncovered (the old min-over-chunks bound saw one).
    Partial chunks carry per-cell bitmaps; validate ANDs them, agrees with
    --deep exactly, and the disk sample's strict-equality check holds on a
    genuinely partial product."""
    import h5py

    from topotpu.cli.steps import step_validate
    from topotpu.core.grid import Tiling
    from topotpu.io.ncdf import FILL_I16

    world, days, rasters, a, b = setup
    cfg = _config()
    d = tmp_path / "exactcov"
    tiling = Tiling(rasters.grid, cfg.tile_rows, cfg.tile_cols)
    ts0 = next(iter(tiling.land_tiles(rasters.landmask)))
    land_t = rasters.landmask[ts0.row0:ts0.row0 + ts0.nrows,
                              ts0.col0:ts0.col0 + ts0.ncols]
    flat_land = np.flatnonzero(land_t.reshape(-1))
    cell_a, cell_b = int(flat_land[0]), int(flat_land[1])

    orig = TileEngine._write_tile_direct

    def patched(self, spec, var, result, save_manifest=True):
        # simulate the device producing an uncovered cell in ONE chunk:
        # chunk 1 misses cell A, chunk 2 misses cell B (tmin, tile ts0)
        if var == "tmin" and spec.tile_id == ts0.tile_id:
            buf = np.asarray(result.buf).copy()
            cell = cell_a if self.mosaic_t0 == 0 else cell_b
            buf[: self.days.ndays, cell] = FILL_I16
            result = result._replace(buf=buf)
        return orig(self, spec, var, result, save_manifest)

    monkeypatch.setattr(TileEngine, "_write_tile_direct", patched)
    eng = _direct_engine(cfg, rasters, days, d)
    eng.run_production_pair("tmin", "tmax", a, b, years_per_chunk=1,
                            progress=False)
    monkeypatch.setattr(TileEngine, "_write_tile_direct", orig)

    # the partial chunk entries carry bitmaps; full chunks carry none
    man1 = json.loads((d / "tiles" / "chunk_2014_2014" / "manifest.json")
                      .read_text())["tiles"]
    man2 = json.loads((d / "tiles" / "chunk_2015_2015" / "manifest.json")
                      .read_text())["tiles"]
    key = f"tmin_{ts0.tile_id:05d}"
    assert "cov_bits" in man1[key]["verify"]
    assert "cov_bits" in man2[key]["verify"]
    assert man1[key]["verify"]["covered"] == man1[key]["cells"] - 1
    for k, v in man1.items():
        if k != key and k.startswith("tmin"):
            assert "cov_bits" not in v["verify"]  # healthy tiles stay lean

    rasters.save(d / "rasters.h5")
    vcfg = dataclasses.replace(cfg, data_dir=str(d),
                               validate_sample_frac=1.0)
    fast = step_validate(vcfg)
    assert fast["mode"] == "streamed"
    deep = step_validate(vcfg, deep=True)
    # EXACT: two cells uncovered (one per chunk); min-over-chunks would
    # have claimed only one
    total_land = int(rasters.landmask.sum())
    expect = round((total_land - 2) / total_land, 4)
    assert fast["tmin"]["daily_coverage"] == expect
    assert deep["tmin"]["daily_coverage"] == expect
    assert fast["tmax"]["daily_coverage"] == 1.0


def test_fletcher32_bit_rot_raises_on_read(tmp_path, setup):
    """Product datasets carry per-chunk fletcher32 checksums (KNOWN_GAPS #7
    remainder): bytes rotted ON DISK after the streamed write-verification
    must raise at ANY read — h5py directly, the fast validate's disk
    sample, and --deep — never decode to silently wrong temperatures.
    Legitimate in-place rewrites (resume) recompute checksums and stay
    readable."""
    import h5py

    from topotpu.cli.steps import step_validate

    world, days, rasters, a, b = setup
    cfg = _config()
    d = tmp_path / "rot"
    eng = _direct_engine(cfg, rasters, days, d)
    eng.run_pair("tmin", "tmax", a, b, progress=False)
    rasters.save(d / "rasters.h5")
    mp = d / "mosaic_tmin.h5"

    with h5py.File(mp) as f:
        assert f["tmin"].fletcher32 and f["normal"].fletcher32
        # a legit engine rewrite already happened tile-by-tile above and
        # the full product reads back clean through the checksum filter
        assert f["tmin"][...].shape[0] == days.ndays
        info = f["tmin"].id.get_chunk_info(0)
        assert info.size > 0

    # rot: flip one byte of the chunk's payload behind HDF5's back
    with open(mp, "r+b") as raw:
        raw.seek(info.byte_offset + info.size // 2)
        byte = raw.read(1)
        raw.seek(-1, 1)
        raw.write(bytes([byte[0] ^ 0xFF]))

    with h5py.File(mp) as f:
        with pytest.raises(OSError):
            f["tmin"][...]
        # untouched datasets still read fine
        f["normal"][...]

    vcfg = dataclasses.replace(cfg, data_dir=str(d),
                               validate_sample_frac=1.0)
    with pytest.raises(RuntimeError, match="bit rot"):
        step_validate(vcfg)  # fast path: sampled disk read hits the rot
    with pytest.raises(RuntimeError, match="bit rot"):
        step_validate(vcfg, deep=True)
