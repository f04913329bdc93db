"""topotpu quickstart: library-level use of the interpolation engine.

Runs on whatever backend is available (a GPU when there is one; force
the CPU with JAX_PLATFORMS=cpu). Writes HDF5, so it needs h5py.

    python examples/quickstart.py
"""

import numpy as np
import jax

from topotpu.core.config import InterpParams, TopoConfig, MeshParams
from topotpu.core.dates import get_days_metadata
from topotpu.dist.engine import TileEngine, StationSet
from topotpu.io.ncdf import read_var
from topotpu.io.rasters import RasterStack
from topotpu.io.synthetic import make_world
from topotpu.interp.xval import xval_interp_normals


def main(out_dir="/tmp/topotpu_quickstart"):
    # 1. a synthetic world (stands in for DEM/TDI/LST rasters + a station DB)
    rng = np.random.default_rng(0)
    days = get_days_metadata("2015-01-01", "2015-12-31")
    world = make_world(rng, nrows=96, ncols=96, n_stations=250,
                      ndays=days.ndays, ocean_frac=0.1)

    # 2. station set: in the real pipeline this comes from the serial DB
    #    (infilled obs + fitted variogram params); here we use truth params
    nug, ps, rg = world.true_vario
    stations = StationSet(
        lon=world.stn_lon, lat=world.stn_lat, elev=world.stn_elev,
        tdi=world.stn_tdi, lst=world.stn_lst, norm=world.stn_norm,
        vario=np.tile(np.array([nug, ps, rg], np.float32),
                      (world.n_stations, 12, 1)),
        valid=np.ones((world.n_stations, 12), bool),
        anoms=world.stn_anoms.astype(np.float32),
    )

    # 3. gridded production: tiles sharded over all local devices
    cfg = TopoConfig(tile_rows=48, tile_cols=48,
                     interp=InterpParams(k_neighbors=24),
                     mesh=MeshParams())
    eng = TileEngine(cfg, RasterStack.from_world(world), days, out_dir)
    n = eng.run("tmin", stations)
    print(f"interpolated {n} tiles on {len(jax.devices())} device(s)")

    # 4. read a product back
    f = f"{out_dir}/tmin_tile00000.h5"
    normal = read_var(f, "tmin_normal")
    se = read_var(f, "tmin_se")
    print("July normal mean %.2f C, kriging SE mean %.3f C"
          % (np.nanmean(normal[6]), np.nanmean(se[6])))

    # 5. validation: leave-one-station-out scores
    sc = xval_interp_normals(
        world.stn_lon, world.stn_lat, world.stn_elev, world.stn_tdi,
        world.stn_lst, world.stn_norm, stations.vario,
        stations.valid, cfg.interp,
    )
    print("LOO x-val: MAE %.3f C, R^2 %.3f" % (sc.mae.mean(), sc.r2.mean()))


if __name__ == "__main__":
    main()
