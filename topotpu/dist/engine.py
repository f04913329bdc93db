"""Production tile engine: host orchestration around the SPMD device step.

Parity target: the reference's gridded-production driver
``bin/mpi_interp_tair.py`` (SURVEY.md §3.1) — rank 0 queueing tiles, workers
interpolating cells, a dedicated writer rank serializing netCDF output —
plus its idempotent-restart behavior (SURVEY.md §5: a crashed run is resumed
by re-queuing tiles whose output is missing).

The same machinery on one host with accelerators:

* the worker pool is ONE jitted SPMD program over the device mesh
  (``dist.mesh.sharded_interp_tile``) — tiles stream through it;
* the writer rank becomes a writer THREAD: the main thread prepares host
  inputs and dispatches device steps, a dedicated thread drains fetched
  buffers to HDF5 (the reference's rank-1 writer, in-process), and a
  bounded queue keeps up to PIPELINE_DEPTH tiles in flight — so the
  fetch+write path overlaps BOTH device compute and the next tiles' host
  prep;
* restart = a JSON manifest + atomic tile files: every completed tile is
  recorded after its os.replace; on resume, completed tiles are skipped.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Iterator

import jax
import numpy as np

from topotpu.core.config import TopoConfig
from topotpu.core.dates import DaysMetadata
from topotpu.core.grid import Tiling, TileSpec
from topotpu.interp.point import (
    TileInputs,
    MonthLayout,
    month_layout,
    group_days_by_month,
    ungroup_days,
)
from topotpu.io.rasters import RasterStack
from topotpu.utils.status import StatusCheck


@dataclasses.dataclass
class StationSet:
    """Host-side station arrays for one variable (the serial DB contents)."""

    lon: np.ndarray      # (S,)
    lat: np.ndarray
    elev: np.ndarray
    tdi: np.ndarray
    lst: np.ndarray      # (S, 12)
    norm: np.ndarray     # (S, 12)
    vario: np.ndarray    # (S, 12, 3)
    valid: np.ndarray    # (S, 12) bool
    anoms: np.ndarray    # (S, ndays) calendar order, serially complete

    @property
    def n(self) -> int:
        return self.lon.shape[0]


@dataclasses.dataclass
class TileTask:
    spec: TileSpec
    inputs: TileInputs
    pool_idx: np.ndarray  # (S_pool,) indices into the full station set


class TileEngine:
    def __init__(
        self,
        config: TopoConfig,
        rasters: RasterStack,
        days: DaysMetadata,
        out_dir: str | pathlib.Path,
        mesh=None,
        margin_km: float = 250.0,
        ctx=None,
        mosaic_paths: dict[str, pathlib.Path] | None = None,
        k_table: dict | None = None,
    ):
        from topotpu.dist.multihost import MultihostContext

        self.config = config
        self.rasters = rasters
        self.days = days
        self.layout: MonthLayout = month_layout(days)
        self.out_dir = pathlib.Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.tiling = Tiling(rasters.grid, config.tile_rows, config.tile_cols)
        self.margin_km = margin_km
        # station-pool cap accounting (see _tile_task): total in-tile
        # stations dropped by max_tile_stations across the run — nonzero
        # means silent accuracy loss at tile edges; surfaced once as a
        # warning and queryable by drivers/tests
        self.pool_in_tile_dropped = 0
        self._pool_cap_warned = False
        # multi-host: each process owns a strided tile subset and its own
        # manifest file (single-writer by disjointness; merged at mosaic)
        self.ctx = ctx or MultihostContext()
        self.manifest_path = self.out_dir / self.ctx.manifest_name()
        self.manifest = self._load_manifest()

        if mesh is None:
            from topotpu.dist.mesh import make_mesh

            # local devices only: in a multi-host job each process runs its
            # own SPMD program over its own devices; tiles never span hosts
            local = jax.local_devices()
            n_dev = config.mesh.n_devices or len(local)
            # mesh size must divide the padded cell count
            cells = config.tile_rows * config.tile_cols
            while cells % n_dev:
                n_dev -= 1
            mesh = make_mesh(n_dev, devices=local)
        self.mesh = mesh

        from topotpu.dist.mesh import (
            shard_tile_inputs,
            sharded_interp_tile,
            sharded_interp_tile_flat,
        )

        # two compiled variants: month-shared station validity (detected per
        # run from the station set; saves 11 of 12 top_k selections) or not.
        # Packed mode uses the single-buffer output (FlatTileResult): the
        # whole tile product leaves the device as ONE int16 array, one
        # device->host copy per tile.
        self._flat = bool(config.output_pack)
        # Direct-to-mosaic mode: writer thread places tiles straight into
        # the final mosaic on the run-global pack grid (io.ncdf.MosaicWriter
        # docstring has the full story). Requires the packed path and
        # knowing the mosaic paths. Multi-host keeps the single-writer-per-
        # file discipline by giving each process its OWN mosaic shard
        # (mosaic_<var>_pNNN.h5) over its strided tile set; the mosaic
        # stage concatenates the shards into one virtual (VDS) master at
        # metadata cost only — no tile-copy pass (round-3 review item: the
        # process_count==1 gate silently degraded multi-host production to
        # the per-tile path + full mosaic copy).
        self.mosaic_paths = dict(mosaic_paths or {})
        self._direct = bool(
            self._flat and config.mosaic_direct and self.mosaic_paths
        )
        self._mosaic: dict = {}       # var -> open MosaicWriter
        self._mosaic_fresh: set = set()  # vars whose mosaic was (re)created
        self._slot_dev = None         # device slot_of_day, uploaded once
        self._scales_dev: dict = {}   # n_vars -> device fixed pack scales
        self._mosaic_owned = True     # chunk sub-engines borrow the parent's
        self.mosaic_t0 = 0            # time offset (chunked production)
        self._full_dates = None       # parent's full calendar for chunk subs
        if self._flat:
            self._fns = {
                flag: sharded_interp_tile_flat(
                    mesh, config.interp, flag, fixed=self._direct
                )
                for flag in (False, True)
            }
        else:
            self._fns = {
                flag: sharded_interp_tile(mesh, config.interp, flag)
                for flag in (False, True)
            }
        self._fn = self._fns[False]
        self._shard = lambda ti: shard_tile_inputs(mesh, ti)
        self._pair_fns: dict | None = None  # built lazily by run_pair
        # optim-nnghs consumption (SURVEY §2.16): tile_id -> {var: (k_norm,
        # k_anom)} from the nnghs.h5 artifact (cli/steps.py builds it from
        # the tile's dominant region). Tiles absent from the table use the
        # config k; distinct k combinations each compile one program
        # (regions are few, so combos are few).
        self.k_table = k_table
        self._var_fns: dict = {}  # (shared, params) -> single-var tile fn

    def _get_pair_fn(self, shared: bool, reconcile: bool = False,
                     params=None):
        from topotpu.dist.mesh import (
            shard_pair_inputs,
            sharded_interp_tile_pair_flat,
        )

        if self._pair_fns is None:
            self._pair_fns = {}
            self._shard_pair = lambda p: shard_pair_inputs(self.mesh, p)
        key = (shared, reconcile, self._direct, params)
        if key not in self._pair_fns:
            self._pair_fns[key] = sharded_interp_tile_pair_flat(
                self.mesh, params or self.config.interp, shared,
                fixed=self._direct, reconcile=reconcile,
            )
        return self._pair_fns[key]

    # -------------------------------------------- optimized-k (optim-nnghs)
    def _params_for(self, spec: TileSpec, *vars_):
        """Per-tile InterpParams override from the optim-nnghs table, or
        None for the config defaults. Neighbor selection runs once at the
        max size over the variables; each variable's solve masks its own
        trailing slots (interp/point.py k_per_var)."""
        if not self.k_table:
            return None
        ent = self.k_table.get(spec.tile_id)
        if not ent:
            return None
        base = self.config.interp
        ks, kas = [], []
        for v in vars_:
            kn, ka = ent.get(v, (base.k_neighbors, base.k_neighbors_anom))
            ks.append(int(kn))
            kas.append(int(ka))
        k_sel = max(ks + kas)
        return dataclasses.replace(
            base, k_neighbors=k_sel, k_neighbors_anom=max(kas),
            k_per_var=tuple(ks), ka_per_var=tuple(kas),
        )

    def _manifest_k(self, spec: TileSpec, var: str):
        """[k_norm, k_anom] this tile+variable actually ran with, for the
        manifest (the audit trail that the optimized k reached production),
        or None when the config default applied."""
        if not self.k_table:
            return None
        ent = self.k_table.get(spec.tile_id)
        if not ent or var not in ent:
            return None
        return [int(ent[var][0]), int(ent[var][1])]

    # ------------------------------------------------- direct-mosaic output
    def _fixed_scales(self, n_vars: int = 1) -> np.ndarray:
        """Run-global int16 pack grid (config pack bounds): (6*n_vars,) f32
        of per-plane (scale, offset) — dailies and normals on the temperature
        window, se on [0, pack_se_hi]. Passed to the device step as a jit
        ARGUMENT, so runs with different bounds share one compiled program."""
        cfg = self.config
        d_scale = (cfg.pack_temp_hi - cfg.pack_temp_lo) / 65500.0
        d_off = 0.5 * (cfg.pack_temp_hi + cfg.pack_temp_lo)
        s_scale = cfg.pack_se_hi / 65500.0
        s_off = 0.5 * cfg.pack_se_hi
        one = np.array(
            [d_scale, d_off, d_scale, d_off, s_scale, s_off], np.float32
        )
        return np.tile(one, n_vars)

    def _mosaic_path(self, var: str) -> pathlib.Path:
        """The file THIS process writes: the final mosaic single-process,
        or this host's shard (mosaic_<var>_pNNN.h5) in a multi-host run."""
        path = self.mosaic_paths[var]
        if self.ctx.process_count > 1:
            return path.with_name(
                f"{path.stem}_p{self.ctx.process_index:03d}{path.suffix}"
            )
        return path

    def _open_mosaic(self, var: str):
        """Open/create the direct-mode mosaic for ``var``. MAIN thread only,
        before the pipeline starts (the writer thread then has exclusive
        use); a recreated (fresh) mosaic invalidates manifest entries that
        claimed tiles the old file held."""
        if var in self._mosaic:
            return self._mosaic[var]
        from topotpu.io.ncdf import MosaicWriter

        sc = self._fixed_scales()
        dates = (
            self._full_dates if self._full_dates is not None
            else self.days.date64
        )
        w = MosaicWriter(
            self._mosaic_path(var), var, self.rasters.grid, dates,
            float(sc[0]), float(sc[1]),
            self.config.tile_rows, self.config.tile_cols,
            compress=self.config.output_compress,
        )
        if w.fresh:
            self._mosaic_fresh.add(var)
            self._drop_manifest_var(var)
            n_tile_claims = sum(
                1 for k in self.manifest["tiles"] if k.startswith(var + "_")
            )
            if n_tile_claims:
                print(
                    f"[engine] NOTE: starting a fresh direct-mode mosaic for "
                    f"{var} while the manifest holds {n_tile_claims} completed "
                    f"per-tile claims; direct mode recomputes those tiles "
                    f"into the mosaic (to reuse the tile files instead, run "
                    f"the mosaic stage with mosaic_direct=false)",
                    flush=True,
                )
        self._mosaic[var] = w
        return w

    def _drop_manifest_var(self, var: str) -> None:
        """Invalidate manifest claims for ``var`` whose data lived in the
        just-recreated mosaic. Claims that point at per-tile files are NOT
        dropped — those files still exist on disk and remain valid state
        for a per-tile resume or a tile-merge mosaic pass (mode switches
        must not silently destroy the manifest-is-checkpoint contract)."""
        mosaic_name = self._mosaic_path(var).name
        stale = [
            k for k, info in self.manifest["tiles"].items()
            if k.startswith(var + "_") and info.get("file") == mosaic_name
        ]
        for k in stale:
            del self.manifest["tiles"][k]
        if stale:
            self._save_manifest()

    def _close_mosaics(self, reconciled: bool = False,
                       finalize: bool = True) -> None:
        """``finalize=False`` (error path): release the HDF5 handles without
        stamping ``complete`` — the manifest keeps the resume state."""
        if not self._mosaic_owned:
            return
        if finalize and self._mosaic:
            # multi-host: each shard records ITS OWN tile count + identity;
            # the mosaic stage checks all shards are present and complete
            # before assembling the virtual master
            n_land = sum(
                1 for t in self.tiling.land_tiles(self.rasters.landmask)
                if self.ctx.owns_tile(t.tile_id)
            )
            for w in self._mosaic.values():
                w.finalize(
                    n_land, reconciled=reconciled,
                    process_index=self.ctx.process_index,
                    process_count=self.ctx.process_count,
                )
        for w in self._mosaic.values():
            w.close()
        self._mosaic.clear()

    # files below this size skip writeback pacing (test-size tiles: the
    # per-file fdatasync latency would dominate, and small runs never hit
    # the dirty-page throttle that pacing exists to avoid)
    PACE_MIN_BYTES = 8 << 20

    @classmethod
    def _pace_writeback(cls, path: pathlib.Path) -> None:
        """Flush a finished tile file to disk and drop its page cache.

        At production scale the engine writes tens of GB of tiles; left to
        the kernel, dirty pages accumulate to the vm.dirty_ratio throttle
        and then EVERY write in the writer thread stalls behind bulk
        writeback (measured on the 4096^2 run: 1.5 -> 0.7 tile-pairs/s
        decay after ~15 GB written, halving sustained throughput).
        fdatasync paces the writer at the disk's true sustained rate —
        which the fetch/compute stages overlap — and FADV_DONTNEED keeps
        the page cache for work that reads, not for data nothing will
        touch until mosaic."""
        import os

        try:
            if path.stat().st_size < cls.PACE_MIN_BYTES:
                return
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fdatasync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        except (AttributeError, OSError):
            pass
        finally:
            os.close(fd)

    _prefetch_warned = False  # class-wide: warn once per process, not per tile

    def _try_prefetch(self, *arrays) -> None:
        """Best-effort async device->host copy. A failure here only costs
        the compute/transfer overlap (every fetch silently becomes
        synchronous), so it must not kill the run — but that is a real
        performance regression, so the FIRST failure is logged (round-2
        review item: silent contextlib.suppress hid the fallback)."""
        try:
            for a in arrays:
                a.copy_to_host_async()
        except Exception as e:  # noqa: BLE001 — optimization guard only
            if not TileEngine._prefetch_warned:
                TileEngine._prefetch_warned = True
                import sys

                print(
                    f"topotpu: host-copy prefetch unavailable ({e!r}); "
                    "device->host fetches fall back to synchronous "
                    "(throughput will drop; correctness unaffected)",
                    file=sys.stderr, flush=True,
                )

    def _dispatch(self, task: TileTask, fn=None):
        """Launch the device step for one tile (async) and start the
        device->host copy so the transfer overlaps the next tile's compute.
        ``fn`` overrides the engine-default compiled step (per-tile
        optimized-k programs)."""
        fn = fn or self._fn
        if self._flat:
            slot = self._dev_slot()
            if self._direct:
                fut = fn(self._shard(task.inputs), slot,
                         self._dev_scales())
            else:
                fut = fn(self._shard(task.inputs), slot)
            self._try_prefetch(fut.buf, fut.scales)
            return fut
        return fn(self._shard(task.inputs))

    def _get_var_fn(self, shared: bool, params):
        """Single-variable tile step compiled for a per-tile InterpParams
        override (optim-nnghs single-var fallback path)."""
        from topotpu.dist.mesh import (
            sharded_interp_tile,
            sharded_interp_tile_flat,
        )

        key = (shared, params)
        if key not in self._var_fns:
            if self._flat:
                self._var_fns[key] = sharded_interp_tile_flat(
                    self.mesh, params, shared, fixed=self._direct
                )
            else:
                self._var_fns[key] = sharded_interp_tile(
                    self.mesh, params, shared
                )
        return self._var_fns[key]

    def _dev_slot(self):
        """slot_of_day uploaded ONCE per engine instead of per tile."""
        if self._slot_dev is None:
            import jax.numpy as jnp

            self._slot_dev = jnp.asarray(self.layout.slot_of_day, jnp.int32)
        return self._slot_dev

    def _dev_scales(self, n_vars: int = 1):
        """Run-global fixed pack scales uploaded once per (engine, n_vars)."""
        if n_vars not in self._scales_dev:
            import jax.numpy as jnp

            self._scales_dev[n_vars] = jnp.asarray(
                self._fixed_scales(n_vars)
            )
        return self._scales_dev[n_vars]

    # ------------------------------------------------------------- manifest
    def _load_manifest(self) -> dict:
        if self.manifest_path.exists():
            return json.loads(self.manifest_path.read_text())
        return {"tiles": {}}

    def _record_tile(self, key: str, info: dict, save: bool = True):
        """``save=False`` defers the manifest file write so a multi-entry
        update (e.g. both variables of a pair) costs one serialization; the
        entry not yet on disk merely stays pending across a crash, and the
        write is idempotent."""
        self.manifest["tiles"][key] = info
        if save:
            self._save_manifest()

    def _save_manifest(self):
        tmp = self.manifest_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.manifest, indent=0))
        tmp.replace(self.manifest_path)

    def _tile_key(self, spec: TileSpec, var: str) -> str:
        return f"{var}_{spec.tile_id:05d}"

    def _tile_file(self, spec: TileSpec, var: str) -> pathlib.Path:
        return self.out_dir / f"{var}_tile{spec.tile_id:05d}.h5"

    def _tile_done(self, spec: TileSpec, var: str) -> bool:
        """Manifest + data-presence check. Direct mode holds data inside
        the mosaic (whose _open_mosaic freshness check already invalidated
        mosaic-backed claims if the file was lost), so a claim counts only
        if it points at THIS mosaic — a claim recorded by an earlier
        per-tile run does not put the tile's data into the mosaic.
        Per-tile mode checks the tile file on disk."""
        info = self.manifest["tiles"].get(self._tile_key(spec, var))
        if info is None:
            return False
        if self._direct:
            return info.get("file") == self._mosaic_path(var).name
        return self._tile_file(spec, var).exists()

    def pending_tiles(self, var: str) -> Iterator[TileSpec]:
        for ts in self.tiling.land_tiles(self.rasters.landmask):
            if not self.ctx.owns_tile(ts.tile_id):
                continue
            if self._tile_done(ts, var):
                continue
            yield ts

    # ------------------------------------------------------------- host prep
    def prepare(self, spec: TileSpec, stations: StationSet) -> TileTask:
        import jax.numpy as jnp

        cfg = self.config
        tr, tc = cfg.tile_rows, cfg.tile_cols
        elev, tdi, lst, mask = self.rasters.tile_view(
            spec.row0, spec.col0, spec.nrows, spec.ncols
        )

        def pad2(a, fill=0.0):
            out = np.full((tr, tc), fill, a.dtype)
            out[: spec.nrows, : spec.ncols] = a
            return out

        rows = np.arange(tr)[:, None].repeat(tc, 1) + spec.row0
        cols = np.arange(tc)[None, :].repeat(tr, 0) + spec.col0
        lon, lat = self.rasters.grid.cell_lonlat(rows.ravel(), cols.ravel())

        cell_mask = np.zeros((tr, tc), bool)
        cell_mask[: spec.nrows, : spec.ncols] = mask

        # station pool: inside the tile bbox + margin, nearest-first cap
        g = self.rasters.grid
        lat_c = g.lat0 - (spec.row0 + spec.nrows / 2) * g.cellsize
        lon_c = g.lon0 + (spec.col0 + spec.ncols / 2) * g.cellsize
        deg_margin_lat = self.margin_km / 111.32
        deg_margin_lon = self.margin_km / (111.32 * max(np.cos(np.deg2rad(lat_c)), 0.2))
        lat_lo = g.lat0 - (spec.row0 + spec.nrows) * g.cellsize - deg_margin_lat
        lat_hi = g.lat0 - spec.row0 * g.cellsize + deg_margin_lat
        lon_lo = g.lon0 + spec.col0 * g.cellsize - deg_margin_lon
        lon_hi = g.lon0 + (spec.col0 + spec.ncols) * g.cellsize + deg_margin_lon
        in_box = (
            (stations.lat >= lat_lo)
            & (stations.lat <= lat_hi)
            & (stations.lon >= lon_lo)
            & (stations.lon <= lon_hi)
        )
        cand = np.flatnonzero(in_box)
        cap = self.config.interp.max_tile_stations
        if len(cand) > cap:
            d2 = (stations.lon[cand] - lon_c) ** 2 + (stations.lat[cand] - lat_c) ** 2
            kept = cand[np.argsort(d2)[:cap]]
            # Accuracy guard: the cap keeps the NEAREST-TO-TILE-CENTER
            # stations, so a cap smaller than the tile's own station count
            # silently strips edge cells of their local neighborhoods —
            # measured on a 10k-station probe grid (one whole-domain tile,
            # cap 512): normals MAE 0.22 -> 0.94 C, daily tmax up to 9.9 C.
            # Dropping an IN-TILE station is the tell (margin stations are
            # legitimately expendable in dense networks).
            lat_ilo = g.lat0 - (spec.row0 + spec.nrows) * g.cellsize
            lat_ihi = g.lat0 - spec.row0 * g.cellsize
            lon_ilo = g.lon0 + spec.col0 * g.cellsize
            lon_ihi = g.lon0 + (spec.col0 + spec.ncols) * g.cellsize
            in_tile = (
                (stations.lat >= lat_ilo) & (stations.lat <= lat_ihi)
                & (stations.lon >= lon_ilo) & (stations.lon <= lon_ihi)
            )
            n_dropped = int(in_tile[cand].sum()) - int(in_tile[kept].sum())
            if n_dropped > 0:
                self.pool_in_tile_dropped += n_dropped
                if not self._pool_cap_warned:
                    self._pool_cap_warned = True
                    print(
                        f"[engine] WARNING: tile {spec.tile_id}: station-pool "
                        f"cap max_tile_stations={cap} drops {n_dropped} "
                        f"stations located INSIDE the tile (of "
                        f"{int(in_tile[cand].sum())} in-tile, {len(cand)} "
                        "candidates) — edge cells lose their local "
                        "neighborhoods and accuracy degrades silently. Use "
                        "smaller tiles or raise interp.max_tile_stations "
                        "above the densest tile's station count.",
                        flush=True,
                    )
            cand = kept
        S = cap
        pool = np.zeros(S, np.int64)
        pool[: len(cand)] = cand
        pool_valid = np.zeros((S, 12), bool)
        pool_valid[: len(cand)] = stations.valid[cand]

        anoms_grouped = group_days_by_month(
            stations.anoms[pool].astype(np.float32), self.layout
        )  # (S, 12, dpm)

        dt = np.float32
        ti = TileInputs(
            cell_lon=jnp.asarray(lon, dt),
            cell_lat=jnp.asarray(lat, dt),
            cell_elev=jnp.asarray(pad2(elev).ravel(), dt),
            cell_tdi=jnp.asarray(pad2(tdi).ravel(), dt),
            cell_lst=jnp.asarray(
                np.stack([pad2(lst[m]) for m in range(12)], -1).reshape(-1, 12), dt
            ),
            cell_mask=jnp.asarray(cell_mask.ravel()),
            stn_lon=jnp.asarray(stations.lon[pool], dt),
            stn_lat=jnp.asarray(stations.lat[pool], dt),
            stn_elev=jnp.asarray(stations.elev[pool], dt),
            stn_tdi=jnp.asarray(stations.tdi[pool], dt),
            stn_lst=jnp.asarray(stations.lst[pool], dt),
            stn_norm=jnp.asarray(stations.norm[pool], dt),
            stn_vario=jnp.asarray(stations.vario[pool], dt),
            stn_valid=jnp.asarray(pool_valid),
            stn_anoms=jnp.asarray(np.moveaxis(anoms_grouped, 1, 0), dt),
        )
        return TileTask(spec=spec, inputs=ti, pool_idx=pool)

    # ------------------------------------------------------------- writing
    def _write_tile_direct(
        self, spec: TileSpec, var: str, result, save_manifest: bool = True
    ) -> None:
        """Direct mode: place the fetched buffer's planes straight into the
        final mosaic (all tiles share the run-global int16 grid, so the
        daily slab is written raw — zero decode or requantization). Normals
        and se land as f32 (decoded from 24 small planes) to keep the mosaic
        dataset layout identical to the assembled two-step one; a chunked
        run writes them only from its first chunk (identical across chunks:
        they derive from the full-period station normals)."""
        from topotpu.io.ncdf import FILL_I16

        cfg = self.config
        tr, tc = cfg.tile_rows, cfg.tile_cols
        nr, nc = spec.nrows, spec.ncols
        ndays = self.days.ndays

        buf = np.asarray(result.buf)
        sc = np.asarray(result.scales)
        daily = buf[:ndays].reshape(ndays, tr, tc)[:, :nr, :nc]
        nq = buf[ndays : ndays + 12].reshape(12, tr, tc)[:, :nr, :nc]
        okm = nq != FILL_I16
        normal = se = None
        if self.mosaic_t0 == 0:
            sq = buf[ndays + 12 : ndays + 24].reshape(12, tr, tc)[:, :nr, :nc]
            normal = np.where(
                okm, nq.astype(np.float32) * float(sc[2]) + float(sc[3]),
                np.nan,
            )
            se = np.where(
                okm, sq.astype(np.float32) * float(sc[4]) + float(sc[5]),
                np.nan,
            )
        w = self._mosaic[var]  # opened by run/run_pair on the main thread
        w.write_tile(spec.row0, spec.col0, daily, normal, se,
                     t0=self.mosaic_t0)
        land = self.rasters.landmask[
            spec.row0 : spec.row0 + nr, spec.col0 : spec.col0 + nc
        ]
        # Streamed verification (a full post-hoc validate re-reads the whole
        # product, 29 GB at north-star scale): read the region straight back through the HDF5
        # dataset while its pages are still cached (the fdatasync +
        # FADV_DONTNEED pacing below drops them), count covered land cells
        # and record them in the manifest. step_validate consumes these
        # stats plus a sampled deep re-scan instead of re-reading
        # everything; --deep restores the full scan. This verifies the
        # full write->HDF5->read round trip (layout/offset/day-axis bugs —
        # validate's real target), not physical disk integrity.
        raw_back = w.read_tile_raw(spec.row0, spec.col0, nr, nc,
                                   t0=self.mosaic_t0, nt=daily.shape[0])
        cov_cells = (raw_back != FILL_I16).all(0) & land
        covered = int(cov_cells.sum())
        verify = {"covered": covered}
        if covered < int(land.sum()):
            # Exact cross-chunk coverage: record WHICH land cells this
            # chunk covered (2 KB bitmap per 128x128 tile) so chunked
            # validate can AND bitmaps across chunks instead of
            # min-bounding counts — different cells missing in different
            # chunks are counted exactly (closes KNOWN_GAPS r4 #6).
            # Fully-covered tiles skip the bitmap entirely, so healthy
            # production manifests don't grow at all.
            import base64

            verify["cov_bits"] = base64.b64encode(
                np.packbits(cov_cells.reshape(-1)).tobytes()
            ).decode()
        if normal is not None:
            nb, sb = w.read_monthly_back(spec.row0, spec.col0, nr, nc)
            verify["normal"] = int((np.isfinite(nb).all(0) & land).sum())
            verify["se"] = int((np.isfinite(sb).all(0) & land).sum())
        self._pace_writeback(w.path)
        kinfo = self._manifest_k(spec, var)
        self._record_tile(
            self._tile_key(spec, var),
            {
                "file": w.path.name,
                "cells": int(land.sum()),
                "ok_cells": int(okm.all(0).sum()),
                "verify": verify,
                "ts": time.time(),
                **({"k": kinfo} if kinfo else {}),
            },
            save=save_manifest,
        )
        return raw_back

    def _write_tile_flat(
        self, spec: TileSpec, var: str, result, save_manifest: bool = True
    ) -> None:
        """Write a FlatTileResult: slice the one fetched int16 buffer straight
        into HDF5 datasets — no host decode/pack/reorder pass at all."""
        from topotpu.io.ncdf import FILL_I16, TileWriter

        if self._direct:
            return self._write_tile_direct(spec, var, result, save_manifest)
        cfg = self.config
        tr, tc = cfg.tile_rows, cfg.tile_cols
        nr, nc = spec.nrows, spec.ncols
        ndays = self.days.ndays

        buf = np.asarray(result.buf)        # (ndays + 24, C) int16, one fetch
        sc = np.asarray(result.scales)      # (6,) f32
        daily = buf[:ndays].reshape(ndays, tr, tc)[:, :nr, :nc]
        normal = buf[ndays : ndays + 12].reshape(12, tr, tc)[:, :nr, :nc]
        se = buf[ndays + 12 : ndays + 24].reshape(12, tr, tc)[:, :nr, :nc]
        okm = normal != FILL_I16  # device ok already folds in the land mask

        land = self.rasters.landmask[
            spec.row0 : spec.row0 + nr, spec.col0 : spec.col0 + nc
        ]
        sub = self.rasters.grid.subgrid(spec.row0, spec.col0, nr, nc)
        with TileWriter(
            self._tile_file(spec, var), sub, self.days.date64,
            pack=True, compress=self.config.output_compress,
        ) as w:
            w.write_daily_prepacked(
                var, daily, float(sc[0]), float(sc[1]), long_name=f"daily {var}"
            )
            w.write_monthly_prepacked(
                f"{var}_normal", normal, float(sc[2]), float(sc[3]),
                long_name="monthly normal",
            )
            w.write_monthly_prepacked(
                f"{var}_se", se, float(sc[4]), float(sc[5]),
                long_name="kriging standard error",
            )
        self._pace_writeback(self._tile_file(spec, var))
        kinfo = self._manifest_k(spec, var)
        self._record_tile(
            self._tile_key(spec, var),
            {
                "file": self._tile_file(spec, var).name,
                "cells": int(land.sum()),
                "ok_cells": int(okm.all(0).sum()),
                "ts": time.time(),
                **({"k": kinfo} if kinfo else {}),
            },
            save=save_manifest,
        )

    def _write_tile(self, spec: TileSpec, var: str, result) -> None:
        if hasattr(result, "buf"):  # FlatTileResult (packed production mode)
            return self._write_tile_flat(spec, var, result)
        from topotpu.io.ncdf import TileWriter

        cfg = self.config
        tr, tc = cfg.tile_rows, cfg.tile_cols
        nr, nc = spec.nrows, spec.ncols

        normal = np.asarray(result.normal).reshape(12, tr, tc)[:, :nr, :nc]
        se = np.asarray(result.se).reshape(12, tr, tc)[:, :nr, :nc]
        ok = np.asarray(result.ok).reshape(12, tr, tc)[:, :nr, :nc]
        daily_g = np.asarray(result.daily)  # (12, C, dpm), f32 or int16
        daily = ungroup_days(daily_g.transpose(1, 0, 2), self.layout)
        daily = daily.reshape(tr, tc, -1).transpose(2, 0, 1)[:, :nr, :nc]

        land = self.rasters.landmask[
            spec.row0 : spec.row0 + nr, spec.col0 : spec.col0 + nc
        ]
        okm = ok & land[None, :, :]
        normal = np.where(okm, normal, np.nan)
        se = np.where(okm, se, np.nan)

        sub = self.rasters.grid.subgrid(spec.row0, spec.col0, nr, nc)
        with TileWriter(
            self._tile_file(spec, var), sub, self.days.date64,
            pack=self.config.output_pack, compress=self.config.output_compress,
        ) as w:
            if daily.dtype == np.int16:  # device-packed path
                daily[:, ~okm.all(0)] = np.int16(-32768)
                w.write_daily_prepacked(
                    var, daily,
                    float(result.daily_scale), float(result.daily_offset),
                    long_name=f"daily {var}",
                )
            else:
                daily = np.where(okm.all(0)[None, :, :], daily, np.nan)
                w.write_daily(var, daily, long_name=f"daily {var}")
            w.write_monthly(f"{var}_normal", normal, long_name="monthly normal")
            w.write_monthly(f"{var}_se", se, long_name="kriging standard error")
        self._pace_writeback(self._tile_file(spec, var))
        kinfo = self._manifest_k(spec, var)
        self._record_tile(
            self._tile_key(spec, var),
            {
                "file": self._tile_file(spec, var).name,
                "cells": int(land.sum()),
                "ok_cells": int(okm.all(0).sum()),
                "ts": time.time(),
                **({"k": kinfo} if kinfo else {}),
            },
        )

    # --------------------------------------------------- pipelined run core
    PIPELINE_DEPTH = 3  # per-stage queue bound (tiles in flight per stage)

    def _pipelined(self, pending, step, write, status) -> int:
        """Three-stage tile pipeline shared by run and run_pair.

        main thread   step(spec) -> (spec, fut): host prep + async dispatch
        fetch thread  jax.device_get(fut): blocks on device compute + the
                      device->host transfer (GIL released, so the overlap
                      is real)
        write thread  write(spec, host_result): HDF5 files + manifest

        The stages map onto the run's three distinct resources (host CPU,
        device+link, disk), so each tile's transfer overlaps both the next
        tile's prep/compute and the previous tile's file write. Only the
        write thread touches files — the single-writer-per-file and
        single-manifest-writer discipline of the reference's dedicated MPI
        writer rank (SURVEY §3.1), kept as threads in one process.

        A stage failure aborts the run: upstream stops, queued work is
        discarded (those tiles stay pending in the manifest for a resume),
        and the first exception re-raises here.

        Failure detection (config.stall_timeout_s > 0): a device transfer
        that never completes and never errors blocks the fetch thread
        forever inside an uncancellable ``jax.device_get``. No exception
        means the error path above never fires, so a daemon watchdog tracks
        the last pipeline progress event (a dispatch returning, a fetch
        landing, a write completing) and calls ``_on_stall`` once nothing
        has moved for the timeout. The default action hard-exits 75
        (EX_TEMPFAIL): the blocked call cannot be cancelled, so a clean
        in-process recovery is impossible by construction — the manifest
        (saved per completed tile) plus stage-level resume make `relaunch
        the same command` the cheap, correct recovery, and a distinct exit
        code lets a wrapper loop do that unattended."""
        import queue
        import threading

        q_fetch: queue.Queue = queue.Queue(maxsize=self.PIPELINE_DEPTH)
        q_write: queue.Queue = queue.Queue(maxsize=self.PIPELINE_DEPTH)
        n_done = 0
        errs: list[BaseException] = []
        progress_t = [time.monotonic()]  # single-writer-per-slot, GIL-atomic
        finished = threading.Event()

        def fetcher():
            while True:
                item = q_fetch.get()
                if item is None:
                    q_write.put(None)
                    return
                if errs:
                    continue  # drain so upstream put() unblocks
                spec, fut = item
                try:
                    host = jax.device_get(fut)
                    progress_t[0] = time.monotonic()
                    q_write.put((spec, host))
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    errs.append(e)

        def writer():
            nonlocal n_done
            while True:
                item = q_write.get()
                if item is None:
                    return
                if errs:
                    continue
                spec, host = item
                try:
                    write(spec, host)
                    n_done += 1
                    progress_t[0] = time.monotonic()
                    status.tick()
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    errs.append(e)

        stall_s = int(getattr(self.config, "stall_timeout_s", 0) or 0)

        def watchdog():
            poll = max(1.0, min(15.0, stall_s / 4.0))
            while not finished.wait(poll):
                idle = time.monotonic() - progress_t[0]
                if idle > stall_s:
                    self._on_stall(idle)
                    return

        threads = [
            threading.Thread(target=fetcher, name="tile-fetcher"),
            threading.Thread(target=writer, name="tile-writer"),
        ]
        if stall_s > 0:
            threads.append(threading.Thread(
                target=watchdog, name="tile-watchdog", daemon=True
            ))
        for t in threads:
            t.start()
        try:
            for spec in pending:
                if errs:
                    break
                q_fetch.put(step(spec))
                progress_t[0] = time.monotonic()  # dispatch (incl compile)
        finally:
            q_fetch.put(None)
            # join the workers FIRST: a wedged fetch thread blocks this join
            # forever, and that is exactly the window the watchdog guards —
            # only signal it once the pipeline has genuinely drained
            for t in threads:
                if t.daemon:
                    continue  # the watchdog exits via the event below
                t.join()
            finished.set()
        if errs:
            raise errs[0]
        return n_done

    def _on_stall(self, idle_s: float) -> None:
        """Watchdog action (injectable for tests): the wedged fetch cannot be
        cancelled, so print a loud diagnosis and exit 75 (EX_TEMPFAIL) —
        the manifest keeps every completed tile and a relaunch of the same
        command resumes (stage-level skip + per-tile manifest skip)."""
        import os
        import sys

        print(
            f"[engine] FATAL: no tile-pipeline progress for {idle_s:.0f}s "
            f"(> stall_timeout_s={self.config.stall_timeout_s}) — an "
            "in-flight device transfer never completed (the blocked "
            "device_get never errors). Exiting 75 so a wrapper can "
            "relaunch; the manifest resume makes the relaunch cheap.",
            flush=True,
        )
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(75)

    # ------------------------------------------------------- production run
    def run_production(
        self,
        var: str,
        stations: StationSet,
        years_per_chunk: int = 4,
        progress: bool = True,
    ) -> int:
        """Config #5 driver: the full multi-decade span in fixed-size year
        chunks (uniform chunks share one compiled shape; the device daily
        buffer stays ~years_per_chunk*31*12*C floats instead of the whole
        1948-2016 span). Each chunk gets its own engine rooted at
        out_dir/chunk_YYYY_YYYY with independent manifest resume; the mosaic
        step concatenates chunk time axes (direct mode: each chunk writes
        its day range of the ONE full-span mosaic at its time offset)."""
        n_done = 0
        if self._direct:
            self._open_mosaic(var)  # full-span file, parent's calendar
        try:
            for sub, day_sel in self._iter_chunk_engines(years_per_chunk):
                n_done += sub.run(
                    var,
                    dataclasses.replace(
                        stations, anoms=stations.anoms[:, day_sel]
                    ),
                    progress=progress,
                )
        except BaseException:
            self._close_mosaics(finalize=False)
            raise
        self._close_mosaics(reconciled=False)
        return n_done

    def _iter_chunk_engines(self, years_per_chunk: int):
        """Yield ``(sub_engine, day_sel)`` per fixed-size year chunk — the
        scaffolding shared by run_production and run_production_pair. The
        chunk's calendar is clamped to the configured span so a start/end
        date not aligned to year boundaries keeps the sliced anomaly axis
        and the chunk calendar the same length. The parent's compiled
        single-var steps are transplanted onto each sub (same static shapes
        when the chunk has the same dpm; else the jit cache recompiles
        once)."""
        from topotpu.core.dates import get_days_metadata

        years = self.days.years
        for c0 in range(0, len(years), years_per_chunk):
            span = years[c0 : c0 + years_per_chunk]
            d0 = max(np.datetime64(f"{span[0]}-01-01"), self.days.date64[0])
            d1 = min(np.datetime64(f"{span[-1]}-12-31"), self.days.date64[-1])
            sub_days = get_days_metadata(str(d0), str(d1))
            day_sel = (
                (self.days.year >= span[0]) & (self.days.year <= span[-1])
            )
            sub = self._chunk_engine(span, sub_days, day_sel)
            sub._fns = self._fns
            sub._shard = self._shard
            sub._var_fns = self._var_fns  # shared dict: chunk compiles reuse
            yield sub, day_sel

    def _chunk_engine(self, span, sub_days, day_sel) -> "TileEngine":
        """A per-chunk sub-engine rooted at its own manifest dir. Direct
        mode: the chunk borrows the parent's open full-span mosaics and
        writes at its day offset; a parent-side fresh rebuild invalidates
        the chunk's manifest claims too."""
        sub = TileEngine(
            self.config,
            self.rasters,
            sub_days,
            self.out_dir / f"chunk_{span[0]}_{span[-1]}",
            mesh=self.mesh,
            margin_km=self.margin_km,
            ctx=self.ctx,
            mosaic_paths=self.mosaic_paths,
            k_table=self.k_table,
        )
        if self._direct:
            sub._mosaic = self._mosaic
            sub._mosaic_owned = False
            sub._full_dates = self.days.date64
            sub.mosaic_t0 = int(np.flatnonzero(day_sel)[0])
            for v in self._mosaic_fresh:
                sub._drop_manifest_var(v)
        return sub

    # ----------------------------------------------------------- paired run
    @staticmethod
    def _pairable(a: StationSet, b: StationSet) -> bool:
        """The paired step shares neighborhoods across variables, which is
        only sound when both variables see the same station geometry and
        per-month validity (true for the standard pipeline: one network,
        serially-complete after infill)."""
        return (
            a.n == b.n
            and np.array_equal(a.lon, b.lon)
            and np.array_equal(a.lat, b.lat)
            and np.array_equal(a.elev, b.elev)
            and np.array_equal(a.valid, b.valid)
        )

    def prepare_pair(self, spec: TileSpec, a: StationSet, b: StationSet):
        """Host prep for the two-variable step: var A's full TileInputs plus
        var B's station fields gathered over the SAME pool."""
        import jax.numpy as jnp

        from topotpu.interp.point import PairTileInputs, VarFields

        task = self.prepare(spec, a)
        pool = task.pool_idx
        anoms_b = group_days_by_month(
            b.anoms[pool].astype(np.float32), self.layout
        )
        bf = VarFields(
            norm=jnp.asarray(b.norm[pool], np.float32),
            vario=jnp.asarray(b.vario[pool], np.float32),
            anoms=jnp.asarray(np.moveaxis(anoms_b, 1, 0), np.float32),
        )
        return task, PairTileInputs(geom=task.inputs, b=bf)

    def _write_tile_pair(
        self, spec: TileSpec, var_a: str, var_b: str, result
    ) -> None:
        """Split the one fetched two-variable buffer and write both files."""
        from topotpu.interp.point import FlatTileResult

        n_rows = self.days.ndays + 24
        buf = np.asarray(result.buf)    # one fetch for both variables
        sc = np.asarray(result.scales)
        from topotpu.core import constants as _C

        will_verify = self._direct and (var_a, var_b) == (_C.TMIN, _C.TMAX)
        raw_a = self._write_tile_flat(
            spec, var_a, FlatTileResult(buf=buf[:n_rows], scales=sc[:6]),
            save_manifest=False,  # one manifest serialization per pair
        )
        raw_b = self._write_tile_flat(
            spec, var_b, FlatTileResult(buf=buf[n_rows:], scales=sc[6:]),
            save_manifest=not will_verify,
        )
        if will_verify and raw_a is not None and raw_b is not None:
            # streamed cross-variable re-check on the READBACK (shared
            # run-global lattice: raw compare, see step_validate's direct
            # branch for the b >= a - 1 identity, valid only in (tmin,
            # tmax) call order); recorded per pair so validate's fast path
            # needs no second pass over the product
            from topotpu.io.ncdf import FILL_I16

            both = (raw_a != FILL_I16) & (raw_b != FILL_I16)
            viol = int((both & (
                raw_b.astype(np.int32) < raw_a.astype(np.int32) - 1
            )).sum())
            pairs = int(both.sum())
            for v in (var_a, var_b):
                info = self.manifest["tiles"].get(self._tile_key(spec, v))
                if info is not None:
                    info.setdefault("verify", {}).update(
                        viol=viol, pairs=pairs
                    )
            self._save_manifest()

    def run_pair(
        self,
        var_a: str,
        var_b: str,
        stations_a: StationSet,
        stations_b: StationSet,
        progress: bool = True,
    ) -> dict:
        """Interpolate BOTH variables per tile in one device pass.

        The reference runs a full gridded pass per variable
        (bin/mpi_interp_tair.py once for tmin, once for tmax); here the
        second variable shares the tile's neighborhoods, GWR gains, daily
        scatter, host prep and the single fetch, paying only its
        kriging solve + matmul slice. Falls back to two sequential runs
        when the station sets differ or packed output is disabled.
        Returns per-variable tile counts {var_a: n, var_b: n} (they can
        differ on the fallback path when one variable resumes further
        along than the other)."""
        if not (self._flat and self._pairable(stations_a, stations_b)):
            return {
                var_a: self.run(var_a, stations_a, progress),
                var_b: self.run(var_b, stations_b, progress),
            }
        shared = bool(
            np.all(stations_a.valid == stations_a.valid[:, :1])
        )
        # Direct mode reconciles daily tmin<=tmax ON DEVICE: with the
        # run-global shared pack grid both variables quantize the collapsed
        # midpoint to the same int16 lattice point, so the mosaic stage's
        # whole reconcile pass vanishes. The device kernel enforces
        # var_b >= var_a, so gate it on the actual (tmin, tmax) call order —
        # any other pairing leaves the mosaics marked unreconciled and the
        # mosaic stage's direct branch applies the host reconcile instead.
        from topotpu.core import constants as _C

        reconcile = self._direct and (var_a, var_b) == (_C.TMIN, _C.TMAX)
        fn = self._get_pair_fn(shared, reconcile=reconcile)
        if self._direct:
            for v in (var_a, var_b):
                self._open_mosaic(v)
        slot = self._dev_slot()
        pending = [
            ts
            for ts in self.tiling.land_tiles(self.rasters.landmask)
            if self.ctx.owns_tile(ts.tile_id)
            and not all(self._tile_done(ts, v) for v in (var_a, var_b))
        ]
        status = StatusCheck(
            total=len(pending), unit="tiles", enabled=progress,
            items_per=2 * self.config.tile_rows * self.config.tile_cols,
        )
        fixed = self._dev_scales(2) if self._direct else None

        def step(spec):
            task, pair = self.prepare_pair(spec, stations_a, stations_b)
            p_spec = self._params_for(spec, var_a, var_b)
            fn_spec = fn if p_spec is None else self._get_pair_fn(
                shared, reconcile=reconcile, params=p_spec
            )
            if fixed is not None:
                fut = fn_spec(self._shard_pair(pair), slot, fixed)
            else:
                fut = fn_spec(self._shard_pair(pair), slot)
            self._try_prefetch(fut.buf, fut.scales)
            return task.spec, fut

        try:
            n_done = self._pipelined(
                pending, step,
                lambda spec, fut: self._write_tile_pair(
                    spec, var_a, var_b, fut
                ),
                status,
            )
        except BaseException:
            self._close_mosaics(finalize=False)
            raise
        self._close_mosaics(reconciled=reconcile)
        return {var_a: n_done, var_b: n_done}

    def run_production_pair(
        self,
        var_a: str,
        var_b: str,
        stations_a: StationSet,
        stations_b: StationSet,
        years_per_chunk: int = 4,
        progress: bool = True,
    ) -> dict:
        """Chunked multi-decade production for both variables at once; same
        chunking/resume semantics as run_production. Returns per-variable
        tile counts summed over chunks."""
        n_done = {var_a: 0, var_b: 0}
        if self._direct:
            for v in (var_a, var_b):
                self._open_mosaic(v)
        try:
            for sub, day_sel in self._iter_chunk_engines(years_per_chunk):
                if self._pair_fns is not None:
                    sub._pair_fns = self._pair_fns
                    sub._shard_pair = self._shard_pair
                chunk_done = sub.run_pair(
                    var_a,
                    var_b,
                    dataclasses.replace(
                        stations_a, anoms=stations_a.anoms[:, day_sel]
                    ),
                    dataclasses.replace(
                        stations_b, anoms=stations_b.anoms[:, day_sel]
                    ),
                    progress=progress,
                )
                for v, c in chunk_done.items():
                    n_done[v] += c
                if sub._pair_fns is not None:
                    self._pair_fns = sub._pair_fns
                    self._shard_pair = sub._shard_pair
        except BaseException:
            self._close_mosaics(finalize=False)
            raise
        # each chunk's run_pair reconciled its day range on device — unless
        # the sets aren't pairable (every chunk then fell back to two single
        # runs; anoms slicing never changes geometry/validity, so checking
        # the full sets here decides it for all chunks) or the call order
        # isn't (tmin, tmax); the mosaic stage's direct branch
        # host-reconciles unreconciled pairs
        from topotpu.core import constants as _C

        self._close_mosaics(
            reconciled=self._pairable(stations_a, stations_b)
            and (var_a, var_b) == (_C.TMIN, _C.TMAX)
        )
        return n_done

    # ------------------------------------------------------------- main loop
    def run(self, var: str, stations: StationSet, progress: bool = True) -> int:
        """Interpolate all pending tiles for one variable. Returns #tiles."""
        shared = bool(np.all(stations.valid == stations.valid[:, :1]))
        self._fn = self._fns[shared]
        if self._direct:
            self._open_mosaic(var)  # main thread, before the writer starts
        pending = list(self.pending_tiles(var))
        status = StatusCheck(
            total=len(pending), unit="tiles", enabled=progress,
            items_per=self.config.tile_rows * self.config.tile_cols,
        )

        def step(spec):
            task = self.prepare(spec, stations)
            p_spec = self._params_for(spec, var)
            fn_spec = None if p_spec is None else self._get_var_fn(
                shared, p_spec
            )
            return task.spec, self._dispatch(task, fn=fn_spec)

        try:
            n_done = self._pipelined(
                pending, step,
                lambda spec, fut: self._write_tile(spec, var, fut),
                status,
            )
        except BaseException:
            self._close_mosaics(finalize=False)
            raise
        # single-variable runs carry no cross-variable reconcile; the mosaic
        # stage's direct branch applies the host reconcile pass when both
        # variables' mosaics exist unreconciled
        self._close_mosaics(reconciled=False)
        return n_done
