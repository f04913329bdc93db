"""End-to-end engine benchmark INCLUDING host IO: a 512x512 16-tile world
by default, runnable on demand on a GPU host that has h5py.

Measures what bench.py deliberately excludes: the full production path per
tile-pair (host prep -> sharded device step -> device->host fetch
-> HDF5 tile write -> manifest record) through TileEngine.run_pair, on a
synthetic world with known variogram params (QA/homog/infill are separate
stages and excluded, as in the reference's per-stage accounting of
bin/mpi_interp_tair.py). The north-star per-host rate is 43,300
variable-cells/s (2 vars x 1.3e7 land cells / 600 s — SURVEY §6).

A warm-up pass to a scratch dir pays the compile; the timed repeats then
measure steady state. Prints one JSON line per repeat plus a summary line
naming the device and the card.
"""

import argparse
import json
import pathlib
import shutil
import time

import numpy as np

NORTH_STAR_PER_HOST = 2 * 1.3e7 / 600.0


def build(grid: int, stations: int, ndays: int, seed: int = 0):
    from topotpu.dist.engine import StationSet
    from topotpu.io.rasters import RasterStack
    from topotpu.io.synthetic import make_world

    rng = np.random.default_rng(seed)
    world = make_world(rng, nrows=grid, ncols=grid, n_stations=stations,
                       ndays=ndays)
    rasters = RasterStack.from_world(world)
    S = world.n_stations
    nug, ps, rg = world.true_vario
    vario = np.tile(np.array([nug, ps, rg], np.float32), (S, 12, 1))
    a = StationSet(
        lon=world.stn_lon, lat=world.stn_lat, elev=world.stn_elev,
        tdi=world.stn_tdi, lst=world.stn_lst, norm=world.stn_norm,
        vario=vario, valid=np.ones((S, 12), bool),
        anoms=world.stn_anoms.astype(np.float32),
    )
    import dataclasses

    b = dataclasses.replace(a, norm=world.stn_norm + 9.0,
                            anoms=(world.stn_anoms * 0.85).astype(np.float32))
    return rasters, a, b


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--stations", type=int, default=1000)
    ap.add_argument("--start", default="2015-01-01")
    ap.add_argument("--end", default="2015-12-31")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="/tmp/topotpu_e2e")
    ap.add_argument("--direct", action="store_true",
                    help="direct-to-mosaic mode (the packed single-process "
                    "CLI default): tiles land straight in the final mosaic "
                    "on the run-global pack grid, reconciled on device — "
                    "measures interp+mosaic together, not interp alone")
    args = ap.parse_args()

    from bench import card, device_info, require_gpu

    devs = require_gpu()
    from topotpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from topotpu.core import constants as C
    from topotpu.core.config import TopoConfig
    from topotpu.core.dates import get_days_metadata
    from topotpu.dist.engine import TileEngine

    days = get_days_metadata(args.start, args.end)
    rasters, sa, sb = build(args.grid, args.stations, days.ndays)
    cfg = TopoConfig(data_dir=args.out)
    out = pathlib.Path(args.out)
    from topotpu.core.grid import Tiling

    # ceil-divided like the engine's tiling (floor undercounts partial
    # edge tiles: --grid 200 runs 4 tile-pairs, not 1)
    n_tiles = Tiling(rasters.grid, cfg.tile_rows, cfg.tile_cols).n_tiles
    var_cells = 2 * args.grid * args.grid

    def mosaics(d):
        if not args.direct:
            return None
        return {v: d / f"mosaic_{v}.h5" for v in (C.TMIN, C.TMAX)}

    # warm-up: pays the compile + file-cache warmup
    warm_dir = out / "warm"
    shutil.rmtree(warm_dir, ignore_errors=True)
    warm = TileEngine(cfg, rasters, days, warm_dir,
                      mosaic_paths=mosaics(warm_dir))
    t0 = time.perf_counter()
    warm.run_pair(C.TMIN, C.TMAX, sa, sb, progress=False)
    print(json.dumps({"phase": "warmup", "wall_s": round(time.perf_counter() - t0, 2),
                      "tiles": n_tiles}), flush=True)

    # Storage probe: the incl-IO rate rides the host's disk, so print its
    # rate INTO the artifact: 256 MB written + fdatasync'd through the same
    # directory the tiles use.
    import os

    def _disk_probe(mb: int = 256) -> float:
        path = out / ".disk_probe"
        blk = np.random.default_rng(0).integers(
            0, 255, 1 << 20, dtype=np.uint8
        ).tobytes()
        t = time.perf_counter()
        with open(path, "wb") as f:
            for _ in range(mb):
                f.write(blk)
            f.flush()
            os.fdatasync(f.fileno())
        dt = time.perf_counter() - t
        path.unlink()
        return mb / dt

    probe = _disk_probe()
    print(json.dumps({"phase": "disk_probe",
                      "disk_probe_MBps": round(probe, 1)}), flush=True)

    rates = []
    run_MBps = []
    for r in range(args.repeats):
        run_dir = out / f"run{r}"
        shutil.rmtree(run_dir, ignore_errors=True)
        eng = TileEngine(cfg, rasters, days, run_dir,
                         mosaic_paths=mosaics(run_dir))
        # share the warm engine's compiled steps (same static shapes), the
        # same transplant run_production_pair does across chunk engines
        eng._fns, eng._shard = warm._fns, warm._shard
        if warm._pair_fns is not None:
            eng._pair_fns, eng._shard_pair = warm._pair_fns, warm._shard_pair
        t0 = time.perf_counter()
        eng.run_pair(C.TMIN, C.TMAX, sa, sb, progress=False)
        dt = time.perf_counter() - t0
        rate = var_cells / dt
        rates.append(rate)
        written = sum(
            f.stat().st_size for f in run_dir.rglob("*") if f.is_file()
        )
        run_MBps.append(written / dt / 1e6)
        print(json.dumps({"phase": f"run{r}", "wall_s": round(dt, 2),
                          "var_cells_per_s": round(rate, 1),
                          "written_MB": round(written / 1e6, 1),
                          "effective_disk_MBps": round(run_MBps[-1], 1)},
                         ), flush=True)
    if not rates:  # --repeats 0: warm-up-only (pre-pay the compile)
        print(json.dumps({"metric": "warmup-only", "value": None,
                          "unit": "cells/sec"}), flush=True)
        return
    best = max(rates)
    mode = "direct-to-mosaic" if args.direct else "per-tile files"
    print(json.dumps({
        "metric": "variable-cells/sec end-to-end incl IO "
                  f"({args.grid}x{args.grid}, {n_tiles} tile-pairs, paired "
                  f"step, {mode}, one host)",
        "device": device_info(devs),
        "card": card(),
        "value": round(best, 1),
        "median": round(float(np.median(rates)), 1),
        "unit": "cells/sec",
        "vs_north_star_per_host": round(best / NORTH_STAR_PER_HOST, 3),
        "median_vs_north_star_per_host": round(
            float(np.median(rates)) / NORTH_STAR_PER_HOST, 3
        ),
        "disk_probe_MBps": round(probe, 1),
        "median_effective_disk_MBps": round(float(np.median(run_MBps)), 1),
    }), flush=True)


if __name__ == "__main__":
    main()
