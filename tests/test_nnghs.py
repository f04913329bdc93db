"""optim-nnghs closure into production (SURVEY §2.16 -> §2.10): the
reference's neighborhood-size optimization jobs exist to produce per-region
nnghs tables that every gridded run then CONSUMES. These tests pin the
whole loop: per-variable k masking in the paired tile step (selection at
the max size, trailing slots provably equivalent to the smaller-k solo
run), the engine's per-tile k_table + manifest audit trail, and the CLI
artifact chain (optim-nnghs writes nnghs.h5, interp applies it)."""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest

from topotpu.core.config import InterpParams, MeshParams, TopoConfig
from topotpu.core.dates import get_days_metadata
from topotpu.dist.engine import StationSet, TileEngine
from topotpu.interp.point import (
    PairTileInputs,
    VarFields,
    interp_tile,
    interp_tile_pair,
)
from topotpu.io.ncdf import read_var
from topotpu.io.synthetic import make_world, tile_inputs_from_world


def _world_inputs():
    rng = np.random.default_rng(31)
    world = make_world(rng, nrows=16, ncols=16, n_stations=40, ndays=62)
    days = get_days_metadata("2015-01-01", "2015-12-31")
    rows, cols = np.unravel_index(np.arange(256), (16, 16))
    ti_a, _ = tile_inputs_from_world(world, days.month_idx[:62], rows, cols)
    rng2 = np.random.default_rng(32)
    norm_b = np.asarray(ti_a.stn_norm) + 8.0
    vario_b = np.asarray(ti_a.stn_vario) * np.float32(1.3)
    anoms_b = (
        np.asarray(ti_a.stn_anoms) * 0.8
        + rng2.normal(0, 0.1, ti_a.stn_anoms.shape).astype(np.float32)
    )
    return ti_a, norm_b, vario_b, anoms_b


def _pair_with_k(ti_a, norm_b, vario_b, anoms_b, params):
    pair = PairTileInputs(
        geom=ti_a, b=VarFields(norm=norm_b, vario=vario_b, anoms=anoms_b)
    )
    return jax.jit(functools.partial(interp_tile_pair, params=params))(pair)


def _assert_tile_close(solo, res, atol=1e-4):
    np.testing.assert_allclose(
        np.asarray(solo.normal), np.asarray(res.normal), atol=atol
    )
    np.testing.assert_allclose(
        np.asarray(solo.se), np.asarray(res.se), atol=atol
    )
    np.testing.assert_allclose(
        np.asarray(solo.daily), np.asarray(res.daily), atol=atol
    )
    np.testing.assert_array_equal(np.asarray(solo.ok), np.asarray(res.ok))


def test_per_var_k_matches_solo_runs():
    """Pair step at k_per_var=(8,16): each variable must reproduce a solo
    run at ITS OWN k — the distance-sorted-prefix mask algebra (selection
    at 16, var A masks slots >= 8) is the whole consumption mechanism."""
    ti_a, norm_b, vario_b, anoms_b = _world_inputs()
    ti_b = ti_a._replace(stn_norm=norm_b, stn_vario=vario_b, stn_anoms=anoms_b)

    solo_a = jax.jit(
        functools.partial(
            interp_tile, params=InterpParams(k_neighbors=8, k_neighbors_anom=8)
        )
    )(ti_a)
    solo_b = jax.jit(
        functools.partial(
            interp_tile,
            params=InterpParams(k_neighbors=16, k_neighbors_anom=16),
        )
    )(ti_b)

    res_a, res_b = _pair_with_k(
        ti_a, norm_b, vario_b, anoms_b,
        InterpParams(
            k_neighbors=16, k_neighbors_anom=16,
            k_per_var=(8, 16), ka_per_var=(8, 16),
        ),
    )
    _assert_tile_close(solo_a, res_a)
    _assert_tile_close(solo_b, res_b)


def test_per_var_anom_k_only():
    """Anomaly k differing alone (the round-3 optim finding: tmin ka=16 vs
    tmax ka=32) splits the shared gain solve per group but must leave each
    variable equal to its solo run."""
    ti_a, norm_b, vario_b, anoms_b = _world_inputs()
    ti_b = ti_a._replace(stn_norm=norm_b, stn_vario=vario_b, stn_anoms=anoms_b)

    solo_a = jax.jit(
        functools.partial(
            interp_tile,
            params=InterpParams(k_neighbors=16, k_neighbors_anom=8),
        )
    )(ti_a)
    solo_b = jax.jit(
        functools.partial(
            interp_tile,
            params=InterpParams(k_neighbors=16, k_neighbors_anom=16),
        )
    )(ti_b)

    res_a, res_b = _pair_with_k(
        ti_a, norm_b, vario_b, anoms_b,
        InterpParams(
            k_neighbors=16, k_neighbors_anom=16,
            k_per_var=(16, 16), ka_per_var=(8, 16),
        ),
    )
    _assert_tile_close(solo_a, res_a)
    _assert_tile_close(solo_b, res_b)


def test_uniform_per_var_k_is_bitwise_default():
    """k_per_var equal to the config k must trace the SAME program as no
    override at all (the default path stays bitwise untouched)."""
    ti_a, norm_b, vario_b, anoms_b = _world_inputs()
    base = InterpParams(k_neighbors=16, k_neighbors_anom=16)
    res_a0, res_b0 = _pair_with_k(ti_a, norm_b, vario_b, anoms_b, base)
    res_a1, res_b1 = _pair_with_k(
        ti_a, norm_b, vario_b, anoms_b,
        dataclasses.replace(base, k_per_var=(16, 16), ka_per_var=(16, 16)),
    )
    for r0, r1 in ((res_a0, res_a1), (res_b0, res_b1)):
        np.testing.assert_array_equal(np.asarray(r0.normal), np.asarray(r1.normal))
        np.testing.assert_array_equal(np.asarray(r0.daily), np.asarray(r1.daily))


def test_k_per_var_validation():
    ti_a, norm_b, vario_b, anoms_b = _world_inputs()
    with pytest.raises(ValueError, match="k_per_var"):
        _pair_with_k(
            ti_a, norm_b, vario_b, anoms_b,
            InterpParams(k_neighbors=16, k_per_var=(24, 16)),
        )
    with pytest.raises(ValueError, match="one entry per variable"):
        _pair_with_k(
            ti_a, norm_b, vario_b, anoms_b,
            InterpParams(k_neighbors=16, k_per_var=(16,)),
        )


# ---------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def engine_setup():
    rng = np.random.default_rng(33)
    world = make_world(
        rng, nrows=48, ncols=48, n_stations=120, ndays=365, ocean_frac=0.15
    )
    days = get_days_metadata("2015-01-01", "2015-12-31")
    from topotpu.io.rasters import RasterStack

    rasters = RasterStack.from_world(world)
    nug, ps, rg = world.true_vario
    a = StationSet(
        lon=world.stn_lon, lat=world.stn_lat, elev=world.stn_elev,
        tdi=world.stn_tdi, lst=world.stn_lst, norm=world.stn_norm,
        vario=np.tile(
            np.array([nug, ps, rg], np.float32), (world.n_stations, 12, 1)
        ),
        valid=np.ones((world.n_stations, 12), bool),
        anoms=world.stn_anoms.astype(np.float32),
    )
    b = dataclasses.replace(
        a, norm=a.norm + 9.0, anoms=(a.anoms * 0.85).astype(np.float32)
    )
    return world, days, rasters, a, b


def _config(k=16):
    return TopoConfig(
        tile_rows=24, tile_cols=24,
        interp=InterpParams(k_neighbors=k, max_tile_stations=128),
        mesh=MeshParams(n_devices=8),
    )


def test_engine_k_table_applies_and_records(tmp_path, engine_setup):
    """run_pair with a k_table: per-tile optimized sizes reach the device
    program (outputs match solo runs at that k) and land in the manifest —
    the audit trail that the optimized k reached production."""
    world, days, rasters, a, b = engine_setup
    tiles = [ts.tile_id for ts in
             TileEngine(_config(), rasters, days, tmp_path / "probe")
             .tiling.land_tiles(rasters.landmask)]
    ktab = {t: {"tmin": (8, 8), "tmax": (16, 12)} for t in tiles}

    eng = TileEngine(_config(), rasters, days, tmp_path / "opt",
                     k_table=ktab)
    assert eng.run_pair("tmin", "tmax", a, b, progress=False) == {
        "tmin": len(tiles), "tmax": len(tiles)
    }
    man = json.loads((tmp_path / "opt" / "manifest.json").read_text())
    for t in tiles:
        assert man["tiles"][f"tmin_{t:05d}"]["k"] == [8, 8]
        assert man["tiles"][f"tmax_{t:05d}"]["k"] == [16, 12]

    # tmin must equal a default-config run at k=8/ka=8 (same program the
    # table requests), and DIFFER from the k=16 default — i.e. a changed
    # nnghs artifact changes the interp program.
    cfg8 = TopoConfig(
        tile_rows=24, tile_cols=24,
        interp=InterpParams(
            k_neighbors=8, k_neighbors_anom=8, max_tile_stations=128
        ),
        mesh=MeshParams(n_devices=8),
    )
    eng8 = TileEngine(cfg8, rasters, days, tmp_path / "k8")
    eng8.run("tmin", a, progress=False)
    eng16 = TileEngine(_config(), rasters, days, tmp_path / "k16")
    eng16.run("tmin", a, progress=False)

    t0 = tiles[0]
    n_opt = read_var(tmp_path / "opt" / f"tmin_tile{t0:05d}.h5", "tmin_normal")
    n_k8 = read_var(tmp_path / "k8" / f"tmin_tile{t0:05d}.h5", "tmin_normal")
    n_k16 = read_var(
        tmp_path / "k16" / f"tmin_tile{t0:05d}.h5", "tmin_normal"
    )
    np.testing.assert_allclose(
        np.nan_to_num(n_opt), np.nan_to_num(n_k8), atol=5e-3
    )
    assert np.nanmax(np.abs(n_opt - n_k16)) > 0.01


def test_engine_k_table_single_var_fallback(tmp_path, engine_setup):
    """The single-variable path (pair fallback) consumes the table too."""
    world, days, rasters, a, _ = engine_setup
    tiles = [ts.tile_id for ts in
             TileEngine(_config(), rasters, days, tmp_path / "probe")
             .tiling.land_tiles(rasters.landmask)]
    ktab = {t: {"tmin": (8, 8)} for t in tiles}
    eng = TileEngine(_config(), rasters, days, tmp_path / "solo",
                     k_table=ktab)
    eng.run("tmin", a, progress=False)
    man = json.loads((tmp_path / "solo" / "manifest.json").read_text())
    assert man["tiles"][f"tmin_{tiles[0]:05d}"]["k"] == [8, 8]

    cfg8 = TopoConfig(
        tile_rows=24, tile_cols=24,
        interp=InterpParams(
            k_neighbors=8, k_neighbors_anom=8, max_tile_stations=128
        ),
        mesh=MeshParams(n_devices=8),
    )
    eng8 = TileEngine(cfg8, rasters, days, tmp_path / "k8")
    eng8.run("tmin", a, progress=False)
    t0 = tiles[0]
    n_opt = read_var(tmp_path / "solo" / f"tmin_tile{t0:05d}.h5", "tmin_normal")
    n_k8 = read_var(tmp_path / "k8" / f"tmin_tile{t0:05d}.h5", "tmin_normal")
    np.testing.assert_allclose(
        np.nan_to_num(n_opt), np.nan_to_num(n_k8), atol=5e-3
    )


# ------------------------------------------------------------- CLI chain


def test_cli_optim_nnghs_closes_the_loop(tmp_path, capsys):
    """`all --optim-nnghs`: the optimization stage writes nnghs.h5 and the
    interp stage CONSUMES it in the same run — stage order, artifact,
    per-tile manifest k, and the interp report's nnghs block."""
    from topotpu.cli.main import main

    cfg = TopoConfig(
        data_dir=str(tmp_path / "data"),
        start_date="2015-01-01",
        end_date="2015-12-31",
        tile_rows=24,
        tile_cols=24,
        interp=InterpParams(k_neighbors=24, max_tile_stations=128),
    )
    cfg_path = tmp_path / "cfg.json"
    cfg.save(cfg_path)

    rc = main(["all", "--config", str(cfg_path), "--grid", "24",
               "--stations", "40", "--optim-nnghs", "--k-candidates", "8,16"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    stages = [x["stage"] for x in lines]
    assert stages == ["synth-data", "qa", "homog", "infill", "krig-params",
                      "optim-nnghs", "interp", "mosaic", "validate"]
    by = {x["stage"]: x["result"] for x in lines}

    import h5py

    nn = tmp_path / "data" / "nnghs.h5"
    assert by["optim-nnghs"]["artifact"] == str(nn)
    with h5py.File(nn) as f:
        ids = f["region_ids"][...]
        reg = f["regions"][...]
        k_norm = {v: f[f"k_norm_{v}"][...] for v in ("tmin", "tmax")}
        k_anom = {v: f[f"k_anom_{v}"][...] for v in ("tmin", "tmax")}
    assert reg.shape == (24, 24) and len(ids) >= 1
    for v in ("tmin", "tmax"):
        assert k_norm[v].shape == ids.shape
        assert (k_norm[v] >= 3).all() and (k_anom[v] >= 3).all()

    # interp consumed it: report block + per-tile manifest audit trail
    nb = by["interp"]["nnghs"]
    assert nb["source"] == str(nn)
    assert nb["tiles_with_optimized_k"] == 1
    man = json.loads(
        (tmp_path / "data" / "tiles" / "manifest.json").read_text()
    )
    # the recorded k must be exactly the dominant region's artifact entry
    from topotpu.io.rasters import RasterStack

    rasters = RasterStack.load(tmp_path / "data" / "rasters.h5")
    vals, counts = np.unique(reg[rasters.landmask], return_counts=True)
    i = {int(r): j for j, r in enumerate(ids)}[int(vals[counts.argmax()])]
    for v in ("tmin", "tmax"):
        assert man["tiles"][f"{v}_00000"]["k"] == [
            int(k_norm[v][i]), int(k_anom[v][i])
        ]
    assert by["validate"]["tmin"]["status"] == "ok"
