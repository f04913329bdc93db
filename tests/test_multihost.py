"""Real multi-host production: a 2-process jax.distributed run on localhost.

The reference's X1 ran `mpirun -n N` task farms across cluster nodes
(SURVEY.md §2 X1). The rebuild's DCN story is per-process strided tile
ownership + per-host manifests + a coordinator-side merge (dist/multihost.py)
— this test exercises it with two actual OS processes joined through
jax.distributed on the CPU backend, then checks disjoint coverage and that
the merged mosaic matches a single-process run.
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from topotpu.core import constants as C
from topotpu.core.config import InterpParams, MeshParams, TopoConfig
from topotpu.core.dates import get_days_metadata
from topotpu.io.ncdf import read_var
from topotpu.io.rasters import RasterStack
from topotpu.io.stndb import StationDB, write_serial_db
from topotpu.io.synthetic import make_world

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _build_artifacts(data: pathlib.Path, cfg: TopoConfig):
    """Synthetic world -> rasters.h5 + all_obs.h5 + serial DBs with true
    variogram params (bypassing qa/homog/infill, covered elsewhere)."""
    days = get_days_metadata(cfg.start_date, cfg.end_date)
    rng = np.random.default_rng(17)
    world = make_world(rng, nrows=32, ncols=32, n_stations=60,
                      ndays=days.ndays, ocean_frac=0.1)
    data.mkdir(parents=True, exist_ok=True)
    RasterStack.from_world(world).save(data / "rasters.h5")

    S = world.n_stations
    filled = (
        world.stn_norm[np.arange(S)[:, None], days.month_idx[None, :]]
        + world.stn_anoms
    ).astype(np.float32)
    attrs = {
        C.STN_ID: np.array([f"SYNTH{i:05d}" for i in range(S)]),
        C.LON: world.stn_lon, C.LAT: world.stn_lat,
        C.ELEV: world.stn_elev, C.TDI: world.stn_tdi,
        C.LST: world.stn_lst.astype(np.float32),
    }
    with StationDB.create(data / "all_obs.h5", attrs, days.date64) as db:
        db.set_obs(C.TMIN, filled)
        db.set_obs(C.TMAX, filled + 10.0)

    nug, ps, rg = world.true_vario
    vario = np.tile(np.array([nug, ps, rg], np.float32), (S, 12, 1))
    bad = np.zeros(S, bool)
    with StationDB(data / "all_obs.h5") as src:
        write_serial_db(data / "serial_tmin.h5", src, C.TMIN, filled,
                        world.stn_norm, bad, vario)
        write_serial_db(data / "serial_tmax.h5", src, C.TMAX, filled + 10.0,
                        world.stn_norm + 10.0, bad, vario)
    return world, days


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh")
    data = tmp / "data"
    cfg = TopoConfig(
        data_dir=str(data),
        start_date="2015-01-01", end_date="2015-02-28",
        tile_rows=8, tile_cols=8,
        # this rig exercises the per-tile multi-host path (tile files +
        # merge-based mosaic); the direct shard path has its own tests below
        mosaic_direct=False,
        interp=InterpParams(k_neighbors=8, k_neighbors_anom=8,
                            max_tile_stations=64),
        mesh=MeshParams(n_devices=2),
    )
    world, days = _build_artifacts(data, cfg)
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    return tmp, data, cfg, cfg_path, world, days


def _worker_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    return env


def test_two_process_interp_disjoint_and_mergeable(rig):
    tmp, data, cfg, cfg_path, world, days = rig
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "topotpu.cli", "interp",
             "--config", str(cfg_path),
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(i)],
            cwd=REPO, env=_worker_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"

    tiles = data / "tiles"
    m0 = json.loads((tiles / "manifest_p000.json").read_text())["tiles"]
    m1 = json.loads((tiles / "manifest_p001.json").read_text())["tiles"]
    assert m0 and m1, "both hosts must have produced tiles"
    assert not (set(m0) & set(m1)), "tile ownership must be disjoint"

    # every land tile x both variables is covered by exactly one host
    from topotpu.core.grid import Tiling

    rasters = RasterStack.load(data / "rasters.h5")
    tiling = Tiling(rasters.grid, cfg.tile_rows, cfg.tile_cols)
    land_ids = [t.tile_id for t in tiling.land_tiles(rasters.landmask)]
    expect = {f"{v}_{tid:05d}" for v in (C.TMIN, C.TMAX) for tid in land_ids}
    assert set(m0) | set(m1) == expect
    # strided ownership: host i owns tile_id % 2 == i
    assert all(int(k.split("_")[1]) % 2 == 0 for k in m0)
    assert all(int(k.split("_")[1]) % 2 == 1 for k in m1)
    for key, info in {**m0, **m1}.items():
        assert (tiles / info["file"]).exists()


def test_mosaic_merges_hosts_and_matches_single_process(rig, tmp_path):
    tmp, data, cfg, cfg_path, world, days = rig
    tiles = data / "tiles"
    assert (tiles / "manifest_p000.json").exists(), "run the 2-proc test first"

    from topotpu.cli import steps

    res = steps.step_mosaic(cfg)
    assert res[C.TMIN] == res[C.TMAX] > 0
    merged = json.loads((tiles / "manifest.json").read_text())["tiles"]
    m0 = json.loads((tiles / "manifest_p000.json").read_text())["tiles"]
    m1 = json.loads((tiles / "manifest_p001.json").read_text())["tiles"]
    assert merged == {**m0, **m1}

    val = steps.step_validate(cfg)
    assert val[C.TMIN]["status"] == "ok", val
    assert val[C.TMAX]["status"] == "ok", val

    # the merged product must match a single-process engine run (different
    # mesh size + independent pack grids -> tolerance ~2 int16 steps)
    from topotpu.dist.engine import StationSet, TileEngine

    rasters = RasterStack.load(data / "rasters.h5")
    nug, ps, rg = world.true_vario
    stations = StationSet(
        lon=world.stn_lon, lat=world.stn_lat, elev=world.stn_elev,
        tdi=world.stn_tdi, lst=world.stn_lst, norm=world.stn_norm,
        vario=np.tile(np.array([nug, ps, rg], np.float32),
                      (world.n_stations, 12, 1)),
        valid=np.ones((world.n_stations, 12), bool),
        anoms=world.stn_anoms.astype(np.float32),
    )
    single_cfg = dataclasses.replace(cfg, mesh=MeshParams(n_devices=8))
    eng = TileEngine(single_cfg, rasters, days, tmp_path / "single")
    eng.run(C.TMIN, stations, progress=False)

    # all three products ride the packed buffer — compare each of them
    # across the 2-process path, not just normals (round-2 review item)
    fields = {
        "normal": f"{C.TMIN}_normal", "se": f"{C.TMIN}_se", "daily": C.TMIN,
    }
    worst = dict.fromkeys(fields, 0.0)
    for key, info in json.loads((tiles / "manifest.json").read_text())["tiles"].items():
        if not key.startswith(C.TMIN):
            continue
        for field, name in fields.items():
            a = read_var(tiles / info["file"], name)
            b = read_var(tmp_path / "single" / info["file"], name)
            assert np.array_equal(np.isfinite(a), np.isfinite(b)), (
                f"{key}/{field}: masked-cell pattern differs across paths"
            )
            worst[field] = max(
                worst[field], float(np.nanmax(np.abs(a - b), initial=0.0))
            )
    for field, w in worst.items():
        assert w < 0.05, f"multi-host vs single-process {field}: {w}"


def test_two_process_chunked_production(tmp_path_factory):
    """Config-#5-style chunked production across two real processes: each
    host owns its strided tile subset within EVERY chunk, per-chunk
    per-host manifests merge cleanly, and the chunk-concatenating mosaic
    validates at full coverage."""
    tmp = tmp_path_factory.mktemp("mh_chunk")
    data = tmp / "data"
    cfg = TopoConfig(
        data_dir=str(data),
        start_date="2014-01-01", end_date="2015-12-31",  # 2 years
        tile_rows=8, tile_cols=8,
        mosaic_direct=False,  # per-tile multi-host path under test here
        interp=InterpParams(k_neighbors=8, k_neighbors_anom=8,
                            max_tile_stations=64),
        mesh=MeshParams(n_devices=2),
    )
    _build_artifacts(data, cfg)
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(cfg.to_json())

    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "topotpu.cli", "interp",
             "--config", str(cfg_path), "--chunk-years", "1",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(i)],
            cwd=REPO, env=_worker_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"

    chunk_dirs = sorted((data / "tiles").glob("chunk_*_*"))
    assert [d.name for d in chunk_dirs] == ["chunk_2014_2014",
                                            "chunk_2015_2015"]
    for d in chunk_dirs:
        m0 = json.loads((d / "manifest_p000.json").read_text())["tiles"]
        m1 = json.loads((d / "manifest_p001.json").read_text())["tiles"]
        assert m0 and m1 and not (set(m0) & set(m1))
        # strided ownership inside every chunk
        assert all(int(k.split("_")[1]) % 2 == 0 for k in m0)
        assert all(int(k.split("_")[1]) % 2 == 1 for k in m1)

    from topotpu.cli import steps

    res = steps.step_mosaic(cfg)
    assert res[C.TMIN] == res[C.TMAX] > 0
    val = steps.step_validate(cfg)
    assert val[C.TMIN]["status"] == "ok", val
    assert val[C.TMAX]["status"] == "ok", val
    assert val["crossvar"]["violations"] == 0
    # full-span day axis survived the chunk concatenation
    daily = read_var(data / "mosaic_tmin.h5", C.TMIN)
    assert daily.shape[0] == 730


def test_two_process_direct_mosaic_virtual_master(tmp_path_factory):
    """Multi-host direct-to-mosaic (round-3 review item: the old
    process_count==1 gate degraded multi-host production to per-tile files
    + a full mosaic copy pass). Each process writes its strided tile set
    straight into its own full-grid shard; the mosaic stage publishes ONE
    virtual-dataset master per variable at metadata cost — and the result
    is bitwise identical to a single-process direct run (same mesh size,
    same config-fixed pack lattice)."""
    import dataclasses as dc

    import h5py

    tmp = tmp_path_factory.mktemp("mh_direct")
    data = tmp / "data"
    cfg = TopoConfig(
        data_dir=str(data),
        start_date="2015-01-01", end_date="2015-02-28",
        tile_rows=8, tile_cols=8,
        interp=InterpParams(k_neighbors=8, k_neighbors_anom=8,
                            max_tile_stations=64),
        mesh=MeshParams(n_devices=2),
    )
    assert cfg.mosaic_direct  # production default drives this path
    world, days = _build_artifacts(data, cfg)
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(cfg.to_json())

    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "topotpu.cli", "interp",
             "--config", str(cfg_path),
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(i)],
            cwd=REPO, env=_worker_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"

    # per-process shards, finalized, with identity attrs; NO per-tile files
    for var in (C.TMIN, C.TMAX):
        for i in range(2):
            sp = data / f"mosaic_{var}_p{i:03d}.h5"
            assert sp.exists(), sp
            with h5py.File(sp) as f:
                assert f.attrs["layout"] == "direct"
                assert bool(f.attrs["complete"])
                assert int(f.attrs["process_index"]) == i
                assert int(f.attrs["process_count"]) == 2
    assert not list((data / "tiles").glob("*_tile*.h5"))

    from topotpu.cli import steps

    res = steps.step_mosaic(cfg)
    from topotpu.core.grid import Tiling

    rasters = RasterStack.load(data / "rasters.h5")
    tiling = Tiling(rasters.grid, cfg.tile_rows, cfg.tile_cols)
    n_land = sum(1 for _ in tiling.land_tiles(rasters.landmask))
    assert res[C.TMIN] == res[C.TMAX] == n_land
    for var in (C.TMIN, C.TMAX):
        with h5py.File(data / f"mosaic_{var}.h5") as f:
            assert bool(f.attrs["virtual"])
            assert bool(f.attrs["complete"])
            assert f[var].is_virtual  # metadata-only: no tile data copied

    val = steps.step_validate(cfg)
    assert val[C.TMIN]["status"] == "ok", val
    assert val[C.TMAX]["status"] == "ok", val
    assert val["crossvar"]["violations"] == 0

    # bitwise parity vs a single-process direct run: same mesh size, the
    # config-fixed run-global pack lattice, and stations loaded through the
    # SAME serial-DB path the CLI workers used (f32 norm+anom round-trips
    # are not associative, so hand-built sets would differ in the last bit)
    from topotpu.cli.steps import _station_set
    from topotpu.dist.engine import TileEngine

    sets = {
        v: _station_set(data / f"serial_{v}.h5", days)
        for v in (C.TMIN, C.TMAX)
    }
    single = tmp / "single"
    single.mkdir()
    eng = TileEngine(
        cfg, rasters, days, single / "tiles",
        mosaic_paths={v: single / f"mosaic_{v}.h5" for v in (C.TMIN, C.TMAX)},
    )
    eng.run_pair(C.TMIN, C.TMAX, sets[C.TMIN], sets[C.TMAX], progress=False)
    for var in (C.TMIN, C.TMAX):
        with h5py.File(data / f"mosaic_{var}.h5") as fm, \
             h5py.File(single / f"mosaic_{var}.h5") as fs:
            assert np.array_equal(fm[var][...], fs[var][...])
            assert np.array_equal(
                np.nan_to_num(fm["normal"][...]),
                np.nan_to_num(fs["normal"][...]),
            )
            assert np.array_equal(
                np.nan_to_num(fs["se"][...]),
                np.nan_to_num(fm["se"][...]),
            )

    # a missing shard must fail assembly loudly (resume contract), and the
    # already-published master must survive the failed re-assembly intact
    (data / f"mosaic_{C.TMIN}_p001.h5").rename(tmp / "stash.h5")
    with pytest.raises(RuntimeError, match="shard"):
        steps.step_mosaic(cfg)
    with h5py.File(data / f"mosaic_{C.TMIN}.h5") as f:
        assert bool(f.attrs["complete"])  # old master untouched (tmp+rename)


def test_two_process_chunked_direct_mosaic(tmp_path_factory):
    """Multi-host x CHUNKED x direct-to-mosaic — the exact combination a
    full-span production run on two hosts uses (the direct-VDS test above
    is unchunked and the chunked test runs per-tile).
    Each process writes per-chunk day ranges at their time offsets into its
    own FULL-SPAN shard; the mosaic stage publishes VDS masters; validate
    is green; and the masters are bitwise identical to a single-process
    chunked direct run on the same mesh size."""
    import h5py

    tmp = tmp_path_factory.mktemp("mh_chunk_direct")
    data = tmp / "data"
    cfg = TopoConfig(
        data_dir=str(data),
        start_date="2014-01-01", end_date="2015-12-31",  # 2 years
        tile_rows=8, tile_cols=8,
        interp=InterpParams(k_neighbors=8, k_neighbors_anom=8,
                            max_tile_stations=64),
        mesh=MeshParams(n_devices=2),
    )
    assert cfg.mosaic_direct  # production default drives this path
    world, days = _build_artifacts(data, cfg)
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(cfg.to_json())

    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "topotpu.cli", "interp",
             "--config", str(cfg_path), "--chunk-years", "1",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(i)],
            cwd=REPO, env=_worker_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"

    # full-span per-process shards, finalized; chunk manifests per host and
    # strided ownership inside EVERY chunk; no per-tile files anywhere
    for var in (C.TMIN, C.TMAX):
        for i in range(2):
            sp = data / f"mosaic_{var}_p{i:03d}.h5"
            assert sp.exists(), sp
            with h5py.File(sp) as f:
                assert f.attrs["layout"] == "direct"
                assert bool(f.attrs["complete"])
                assert int(f.attrs["process_count"]) == 2
                assert f[var].shape[0] == 730  # full span, not one chunk
    chunk_dirs = sorted((data / "tiles").glob("chunk_*_*"))
    assert [d.name for d in chunk_dirs] == ["chunk_2014_2014",
                                            "chunk_2015_2015"]
    for d in chunk_dirs:
        m0 = json.loads((d / "manifest_p000.json").read_text())["tiles"]
        m1 = json.loads((d / "manifest_p001.json").read_text())["tiles"]
        assert m0 and m1 and not (set(m0) & set(m1))
        assert all(int(k.split("_")[1]) % 2 == 0 for k in m0)
        assert all(int(k.split("_")[1]) % 2 == 1 for k in m1)
        assert not list(d.glob("*_tile*.h5"))

    from topotpu.cli import steps

    res = steps.step_mosaic(cfg)
    assert res[C.TMIN] == res[C.TMAX] > 0
    for var in (C.TMIN, C.TMAX):
        with h5py.File(data / f"mosaic_{var}.h5") as f:
            assert bool(f.attrs["virtual"])
            assert bool(f.attrs["complete"])
            assert f[var].is_virtual
            assert f[var].shape[0] == 730

    val = steps.step_validate(cfg)
    assert val[C.TMIN]["status"] == "ok", val
    assert val[C.TMAX]["status"] == "ok", val
    assert val["crossvar"]["violations"] == 0

    # bitwise parity vs a single-process CHUNKED direct run (same mesh
    # size, config-fixed pack lattice, serial-DB station loading)
    from topotpu.cli.steps import _station_set
    from topotpu.dist.engine import TileEngine

    rasters = RasterStack.load(data / "rasters.h5")
    sets = {
        v: _station_set(data / f"serial_{v}.h5", days)
        for v in (C.TMIN, C.TMAX)
    }
    single = tmp / "single"
    single.mkdir()
    eng = TileEngine(
        cfg, rasters, days, single / "tiles",
        mosaic_paths={v: single / f"mosaic_{v}.h5" for v in (C.TMIN, C.TMAX)},
    )
    eng.run_production_pair(C.TMIN, C.TMAX, sets[C.TMIN], sets[C.TMAX],
                            years_per_chunk=1, progress=False)
    for var in (C.TMIN, C.TMAX):
        with h5py.File(data / f"mosaic_{var}.h5") as fm, \
             h5py.File(single / f"mosaic_{var}.h5") as fs:
            assert np.array_equal(fm[var][...], fs[var][...])
            assert np.array_equal(
                np.nan_to_num(fm["normal"][...]),
                np.nan_to_num(fs["normal"][...]),
            )
            assert np.array_equal(
                np.nan_to_num(fm["se"][...]),
                np.nan_to_num(fs["se"][...]),
            )
