"""Smoke test of the main path on an NVIDIA GPU.

    python chip_smoke.py           # one GPU: phases (a)-(f)
    python chip_smoke.py --four    # four GPUs: the 4-vs-1 comparison only

One process drives everything. Each phase prints its own lines; any failure
raises and the script exits non-zero. The last line of standard output is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.

(a) device      the card (nvidia-smi name and power limit), device kind,
                JAX version; refuses to run without a GPU.
(b) kernel      the CUDA kriging solve (kernels/ok_krige.cu) compiled at
                16,384 systems for k in {32, 48, 64}, against the XLA chain
                and the float64 oracle.
(c) precision   on one production tile, the cos-matmul neighbourhoods equal
                the exact-distance ones.
(d) main path   TileEngine.prepare_pair -> sharded paired step -> fetch for
                every tile of a 1024x1024 grid (64 tiles of 128x128) with
                4,000 stations, 2015, k=32, pool 512: coverage, tmax >= tmin,
                July normals vs truth, mean SE, collective-free HLO, compile
                and steady tile-pair times. The run stops at the fetched
                int16 buffers; writing the HDF5 product needs h5py.
(e) oracle      compare_f32_f64 on 2,048 cells of one production tile: f32
                through the production path on the GPU, f64 on the CPU.
(f) chip tests  the gpu-marked tests, in this process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

GRID = 1024
N_STATIONS = 4000
TILE = 128
K = 32
POOL = 512
BAR_C = 0.05  # BASELINE f32-vs-f64 bar, deg C


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return [ln.strip() for ln in out.strip().splitlines()]


def phase_device(n_expected: int):
    import jax

    devs = jax.devices()
    if jax.default_backend() != "gpu" or any(
        d.platform != "gpu" for d in devs
    ):
        sys.exit(f"chip_smoke needs GPUs; JAX found {jax.default_backend()}")
    if len(devs) < n_expected:
        sys.exit(f"needs {n_expected} GPUs, found {len(devs)}")
    phase("(a) device")
    for ln in card_lines():
        print(f"card: {ln}")
    print(f"device_kind: {devs[0].device_kind}  count: {len(devs)}")
    print(f"jax: {jax.__version__}")
    try:
        import h5py
    except ImportError:
        print("h5py: absent (product writing unavailable on this host)")
    else:
        print(f"h5py: {h5py.__version__}")
    return devs


# --------------------------------------------------------------- world
@dataclasses.dataclass
class Run:
    world: object
    days: object
    rasters: object
    a: object
    b: object


def build_run(grid: int, n_stations: int, seed: int = 11) -> Run:
    from topotpu.core.dates import get_days_metadata
    from topotpu.dist.engine import StationSet
    from topotpu.io.rasters import RasterStack
    from topotpu.io.synthetic import make_world

    days = get_days_metadata("2015-01-01", "2015-12-31")
    world = make_world(np.random.default_rng(seed), nrows=grid, ncols=grid,
                       n_stations=n_stations, ndays=days.ndays)
    nug, ps, rg = world.true_vario
    a = StationSet(
        lon=world.stn_lon, lat=world.stn_lat, elev=world.stn_elev,
        tdi=world.stn_tdi, lst=world.stn_lst, norm=world.stn_norm,
        vario=np.tile(np.array([nug, ps, rg], np.float32),
                      (n_stations, 12, 1)),
        valid=np.ones((n_stations, 12), bool),
        anoms=world.stn_anoms.astype(np.float32),
    )
    b = dataclasses.replace(a, norm=a.norm + 9.0)
    return Run(world, days, RasterStack.from_world(world), a, b)


def make_engine(run: Run, tile: int, k: int, pool: int, mesh=None):
    from topotpu.core.config import InterpParams, TopoConfig
    from topotpu.dist.engine import TileEngine

    cfg = TopoConfig(
        start_date="2015-01-01", end_date="2015-12-31",
        tile_rows=tile, tile_cols=tile,
        interp=InterpParams(k_neighbors=k, max_tile_stations=pool),
    )
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    # mosaic paths select the direct-to-mosaic step (run-global int16 grid,
    # on-device tmin <= tmax reconcile); nothing is written to them here
    eng = TileEngine(
        cfg, run.rasters, run.days, os.path.join(tmp, "tiles"), mesh=mesh,
        mosaic_paths={v: os.path.join(tmp, f"mosaic_{v}.h5")
                      for v in ("tmin", "tmax")},
    )
    assert eng._direct, "direct-to-mosaic step did not engage"
    return eng


def collectives(hlo: str) -> list[str]:
    return [c for c in ("all-reduce", "all-gather", "collective-permute",
                        "reduce-scatter", "all-to-all") if c in hlo]


# --------------------------------------------------------------- (b)
def phase_kernel(run: Run, n_sys: int = 16384, n_check: int = 64):
    import jax
    import jax.numpy as jnp

    from topotpu.geo.distance import unit_xyz
    from topotpu.geo.neighbors import select_neighbors
    from topotpu.kernels.cholesky import ok_krige_xla
    from topotpu.kernels.ok_krige import ok_krige
    from topotpu.oracle.numpy_ref import haversine_km, ok_krige_augmented

    phase("(b) kernel")
    w = run.world
    rng = np.random.default_rng(3)
    rows = rng.integers(0, w.grid.nrows, n_sys)
    cols = rng.integers(0, w.grid.ncols, n_sys)
    lon, lat = w.grid.cell_lonlat(rows, cols)
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    S = w.n_stations
    valid = np.ones(S, bool)
    valid[::7] = False  # some masked slots
    vario = np.stack([rng.uniform(0.02, 0.3, n_sys),
                      rng.uniform(0.5, 2.0, n_sys),
                      rng.uniform(20.0, 120.0, n_sys)], -1).astype(np.float32)
    stn_xyz = unit_xyz(f32(w.stn_lon), f32(w.stn_lat))
    tol_w, tol_v = 2e-3, 2e-3  # f32 solve vs f64: weights, variance/sill
    for k in (32, 48, 64):
        nbr = jax.jit(lambda lo, la, sl, sa, v: select_neighbors(
            lo, la, sl, sa, v, k=k))(f32(lon), f32(lat), f32(w.stn_lon),
                                     f32(w.stn_lat), jnp.asarray(valid))
        nbr_xyz = jnp.take(stn_xyz, nbr.idx, axis=0)
        mask = nbr.mask.at[:, k - 3:].set(False)  # inert tail slots too
        args = (nbr_xyz, nbr.dist, mask, f32(vario))
        kern = jax.jit(lambda *a: ok_krige(*a))
        compiled = kern.lower(*args).compile()
        print(f"k={k} memory_analysis: {compiled.memory_analysis()}")
        got = jax.device_get(compiled(*args))
        ref = jax.device_get(jax.jit(lambda *a: ok_krige_xla(*a))(*args))
        d_w = float(np.abs(got.weights - ref.weights).max())
        d_v = float(np.abs(got.variance - ref.variance).max())
        assert (got.ok == ref.ok).all(), "ok flags differ from XLA"
        print(f"k={k} kernel vs XLA: max|dw|={d_w:.3e} max|dvar|={d_v:.3e}")
        # float64 oracle (augmented LU system) on a sample of systems
        idx = np.asarray(nbr.idx)
        mk = np.asarray(mask)
        ow = ov = 0.0
        for i in range(n_check):
            sel = mk[i]
            s = idx[i, sel]
            dp = haversine_km(w.stn_lon[s][:, None], w.stn_lat[s][:, None],
                              w.stn_lon[s][None, :], w.stn_lat[s][None, :])
            np.fill_diagonal(dp, 0.0)
            d0 = haversine_km(lon[i], lat[i], w.stn_lon[s], w.stn_lat[s])
            nug, ps, rg = (float(x) for x in vario[i])
            _, var, lam = ok_krige_augmented(dp, d0, np.zeros(sel.sum()),
                                             nug, ps, rg, jitter_frac=1e-5)
            ow = max(ow, float(np.abs(got.weights[i, sel] - lam).max()))
            ov = max(ov, abs(float(got.variance[i]) - var) / (nug + ps))
        print(f"k={k} kernel vs f64 oracle ({n_check} systems): "
              f"max|dw|={ow:.3e} (tol {tol_w}) max|dvar|/sill={ov:.3e} "
              f"(tol {tol_v})")
        assert ow <= tol_w and ov <= tol_v, (k, ow, ov)
        assert d_w <= tol_w and d_v <= tol_v * float(vario[:, :2].sum(1).max())
        assert "topotpu_ok_krige" in compiled.as_text(), "kernel not in HLO"


# --------------------------------------------------------------- (c)
def phase_precision(run: Run, eng):
    import jax

    from topotpu.geo.distance import pairwise_great_circle_km, unit_xyz
    from topotpu.geo.neighbors import select_neighbors

    phase("(c) precision")
    spec = next(eng.tiling.land_tiles(run.rasters.landmask))
    ti = eng.prepare(spec, run.a).inputs
    k = eng.config.interp.k_neighbors
    args = (ti.cell_lon, ti.cell_lat, ti.stn_lon, ti.stn_lat,
            ti.stn_valid[:, 0])
    cos = jax.jit(lambda *x: select_neighbors(*x, k=k))(*args)
    exact = jax.jit(lambda *x: select_neighbors(
        *x, k=k, dist_matrix=pairwise_great_circle_km(*x[:4])))(*args)
    m_c, m_e = np.asarray(cos.mask), np.asarray(exact.mask)
    assert (m_c == m_e).all(), "masks differ"
    sets_c = np.sort(np.where(m_c, np.asarray(cos.idx), -1), 1)
    sets_e = np.sort(np.where(m_e, np.asarray(exact.idx), -1), 1)
    differ = np.flatnonzero((sets_c != sets_e).any(1))
    # a differing cell may only swap stations tied in f32 distance with the
    # k-th neighbour: their exact distances agree to the metric's rounding
    d_all = np.asarray(jax.jit(pairwise_great_circle_km)(*args[:4]))
    gap = 0.0
    for i in differ:
        swapped = np.setxor1d(sets_c[i], sets_e[i])
        dk = np.sort(d_all[i])[k - 1]
        gap = max(gap, float(np.abs(d_all[i, swapped] - dk).max()))
    print(f"cells: {len(m_c)}  identical neighbourhoods: "
          f"{len(m_c) - len(differ)}  differing: {len(differ)} "
          f"(max |d - d_k| of swapped stations {gap * 1e3:.1f} m)")
    assert gap <= 0.05, "neighbourhoods differ beyond an f32 distance tie"
    # what the HIGHEST pin prevents: the same selection with a default-
    # precision dot (TF32 on this card)
    cos_default = jax.jit(lambda a, b: unit_xyz(a[0], a[1]) @ unit_xyz(
        b[0], b[1]).T)((ti.cell_lon, ti.cell_lat), (ti.stn_lon, ti.stn_lat))
    loose = jax.jit(lambda *x: select_neighbors(
        *x[:5], k=k, cos_matrix=x[5]))(*args, cos_default)
    sets_l = np.sort(np.where(np.asarray(loose.mask),
                              np.asarray(loose.idx), -1), 1)
    print(f"unpinned (default-precision) cos: "
          f"{int((sets_l != sets_e).any(1).sum())} cells differ")


# --------------------------------------------------------------- (d)
def drive_pairs(eng, run: Run) -> dict:
    """Every land tile through prepare_pair -> paired step -> fetch. Returns
    decoded mosaics and times."""
    import jax

    fn = eng._get_pair_fn(True, reconcile=True)
    slot = eng._dev_slot()
    scales = eng._dev_scales(2)
    sc = np.asarray(eng._fixed_scales(2))
    g = run.rasters.grid
    nd = run.days.ndays
    tr = tc = eng.config.tile_rows
    daily = {v: np.full((nd, g.nrows, g.ncols), -32768, np.int16)
             for v in ("tmin", "tmax")}
    normal = {v: np.full((12, g.nrows, g.ncols), np.nan, np.float32)
              for v in ("tmin", "tmax")}
    se = {v: np.full((12, g.nrows, g.ncols), np.nan, np.float32)
          for v in ("tmin", "tmax")}
    specs = list(eng.tiling.land_tiles(run.rasters.landmask))
    t_compile = None
    step_s = []
    t_all = time.perf_counter()
    for n, spec in enumerate(specs):
        _, pair = eng.prepare_pair(spec, run.a, run.b)
        sharded = eng._shard_pair(pair)
        t0 = time.perf_counter()
        fut = jax.block_until_ready(fn(sharded, slot, scales))
        dt = time.perf_counter() - t0
        if n == 0:
            t_compile = dt
        else:
            step_s.append(dt)
        buf = np.asarray(fut.buf)
        r0, c0, nr, nc = spec.row0, spec.col0, spec.nrows, spec.ncols
        for j, v in enumerate(("tmin", "tmax")):
            blk = buf[j * (nd + 24):(j + 1) * (nd + 24)]
            s6 = sc[6 * j: 6 * j + 6]
            daily[v][:, r0:r0 + nr, c0:c0 + nc] = \
                blk[:nd].reshape(nd, tr, tc)[:, :nr, :nc]
            nq = blk[nd:nd + 12].reshape(12, tr, tc)[:, :nr, :nc]
            sq = blk[nd + 12:nd + 24].reshape(12, tr, tc)[:, :nr, :nc]
            ok = nq != -32768
            normal[v][:, r0:r0 + nr, c0:c0 + nc] = np.where(
                ok, nq * s6[2] + s6[3], np.nan)
            se[v][:, r0:r0 + nr, c0:c0 + nc] = np.where(
                ok, sq * s6[4] + s6[5], np.nan)
    wall = time.perf_counter() - t_all
    hlo = fn.lower(sharded, slot, scales).compile().as_text()
    return dict(daily=daily, normal=normal, se=se, hlo=hlo, n=len(specs),
                compile_s=t_compile, step_s=step_s, wall=wall)


def check_main_path(run: Run, out: dict) -> None:
    land = run.rasters.landmask
    dmin, dmax = out["daily"]["tmin"], out["daily"]["tmax"]
    cover = (dmin != -32768).all(0) & (dmax != -32768).all(0)
    assert (cover | ~land).all(), f"{int((~cover & land).sum())} cells uncovered"
    assert np.isfinite(out["normal"]["tmin"][:, land]).all(), "normals hole"
    assert (dmax[:, land] >= dmin[:, land]).all(), "tmax < tmin somewhere"
    w = run.world
    rng = np.random.default_rng(5)
    rr, cc = np.nonzero(land)
    pick = rng.choice(len(rr), min(8192, len(rr)), replace=False)
    rr, cc = rr[pick], cc[pick]
    lon, lat = w.grid.cell_lonlat(rr, cc)
    true_jul = w.true_normal(lon, lat, w.elev[rr, cc], w.tdi[rr, cc],
                             w.lst[6, rr, cc], 7)
    mae = float(np.abs(out["normal"]["tmin"][6, rr, cc] - true_jul).mean())
    se_mean = float(np.nanmean(out["se"]["tmin"]))
    print(f"tiles: {out['n']}  July normals MAE vs truth: {mae:.4f} C "
          f"(< 0.3)  mean SE: {se_mean:.4f} (0.1..0.8)")
    assert mae < 0.3, mae
    assert 0.1 < se_mean < 0.8, se_mean
    coll = collectives(out["hlo"])
    print(f"collectives in the compiled pair program: {coll or 'none'}")
    assert not coll, coll


def phase_main(run: Run, eng, card: str) -> dict:
    phase("(d) main path")
    out = drive_pairs(eng, run)
    check_main_path(run, out)
    st = np.asarray(out["step_s"]) * 1e3
    print(f"compile + first tile-pair: {out['compile_s']:.3f} s  [{card}]")
    print(f"steady tile-pair device step: median {np.median(st):.3f} ms "
          f"(min {st.min():.3f}, max {st.max():.3f}, n={len(st)})  [{card}]")
    print(f"all {out['n']} tile-pairs incl. host prep and fetch: "
          f"{out['wall']:.3f} s  [{card}]")
    return out


# --------------------------------------------------------------- (e)
def phase_oracle(run: Run, eng, n_cells: int = 2048) -> None:
    from topotpu.interp.f64check import compare_f32_f64
    from topotpu.interp.point import TileInputs

    phase("(e) oracle")
    spec = next(eng.tiling.land_tiles(run.rasters.landmask))
    ti = eng.prepare(spec, run.a).inputs
    cells = set(TileInputs._fields[:6])
    sub = TileInputs(*(np.asarray(v)[:n_cells] if f in cells
                       else np.asarray(v) for f, v in zip(TileInputs._fields, ti)))
    t0 = time.perf_counter()
    rep = compare_f32_f64(sub, eng.config.interp,
                          day_valid=eng.layout.day_valid)
    print(f"cells compared: {rep['n_compared']} (12 months x {n_cells})  "
          f"ok flips: {rep['ok_flip_rate']}  ({time.perf_counter() - t0:.1f} s)")
    for key in ("normal", "se", "daily"):
        print(f"{key}: rmse {rep[key]['rmse']:.5f} C  max {rep[key]['max']:.5f} C"
              f"  (bar {BAR_C} C rmse)")
        assert rep[key]["rmse"] <= BAR_C, (key, rep[key])


# --------------------------------------------------------------- (f)
def phase_tests() -> None:
    import pytest

    phase("(f) chip tests")
    # only the files that hold gpu-marked tests: the rest of the suite is
    # the CPU suite, and some of it needs h5py
    tests = pathlib.Path(__file__).resolve().parent / "tests"
    files = sorted(str(f) for f in tests.glob("test_*.py")
                   if "pytest.mark.gpu" in f.read_text())
    assert files, "no gpu-marked tests found"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", *files])
    assert rc == 0, f"gpu-marked tests failed (pytest exit {rc})"


# --------------------------------------------------------------- --four
def phase_four(devs, card: str) -> None:
    from topotpu.dist.mesh import make_mesh

    phase("(d) main path on four GPUs vs one")
    run = build_run(GRID, N_STATIONS)
    eng4 = make_engine(run, TILE, K, POOL, mesh=make_mesh(4, devices=devs))
    eng1 = make_engine(run, TILE, K, POOL, mesh=make_mesh(1, devices=devs))
    out4 = drive_pairs(eng4, run)
    check_main_path(run, out4)
    out1 = drive_pairs(eng1, run)
    worst = 0
    bitwise = True
    for v in ("tmin", "tmax"):
        d4 = out4["daily"][v].astype(np.int32)
        d1 = out1["daily"][v].astype(np.int32)
        worst = max(worst, int(np.abs(d4 - d1).max()))
        bitwise &= bool((d4 == d1).all())
        bitwise &= bool(np.array_equal(out4["normal"][v], out1["normal"][v],
                                       equal_nan=True))
    print(f"4-GPU vs 1-GPU mosaics: max daily difference {worst} int16 "
          f"step(s); bitwise equal: {bitwise}")
    assert worst <= 1, worst
    st4 = np.median(out4["step_s"]) * 1e3
    st1 = np.median(out1["step_s"]) * 1e3
    print(f"steady tile-pair device step: 4 GPUs {st4:.3f} ms, "
          f"1 GPU {st1:.3f} ms  [{card}]")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU vs 1-GPU main-path comparison")
    args = ap.parse_args()

    devs = phase_device(4 if args.four else 1)
    from topotpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = card_lines()[0]
    if args.four:
        phase_four(devs[:4], card)
        count = 4
    else:
        from topotpu.dist.mesh import make_mesh

        run = build_run(GRID, N_STATIONS)
        eng = make_engine(run, TILE, K, POOL,
                          mesh=make_mesh(1, devices=devs[:1]))
        phase_kernel(run)
        phase_precision(run, eng)
        phase_main(run, eng, card)
        phase_oracle(run, eng)
        phase_tests()
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))


if __name__ == "__main__":
    main()
