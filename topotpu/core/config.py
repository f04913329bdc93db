"""Typed pipeline configuration.

Parity target: the reference's ``TwxConfig`` INI/env-var path config
(SURVEY.md §5 "Config/flag system"). Rebuilt as one frozen dataclass covering
paths, grid spec, static kernel sizes, and mesh shape — everything a pipeline
stage needs, serializable to/from JSON.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

from topotpu.core.grid import CELLSIZE_30ARCSEC


@dataclasses.dataclass(frozen=True)
class InterpParams:
    """Static-shape interpolation parameters (the SURVEY §7 commitment:
    fixed-size padded neighborhoods; masks fold into weights)."""

    k_neighbors: int = 32          # kriging/GWR neighborhood size (padded max)
    k_neighbors_anom: int = 32     # GWR daily-anomaly neighborhood size
    # Per-variable overrides for the multi-variable tile step (the paired
    # tmin+tmax production path): one entry per variable in step order.
    # This is how the optim-nnghs artifact reaches production (SURVEY
    # §2.16: the reference's mpi_optim_nstns_{norms,anoms} tables are
    # CONSUMED by every gridded run, not just reported): the engine selects
    # neighbors once at k_neighbors = max over variables, and each
    # variable's kriging/GWR masks the trailing slots beyond its own k —
    # top_k output is distance-sorted, so the first k_v slots ARE the
    # k_v-neighborhood and masked slots are provably inert (tested).
    # None = every variable uses k_neighbors / k_neighbors_anom.
    k_per_var: tuple | None = None     # per-variable kriging k
    ka_per_var: tuple | None = None    # per-variable anomaly (GWR daily) k
    max_tile_stations: int = 512   # per-tile station pool (padded)
    min_neighbors: int = 3         # below this a cell is flagged, not solved
    # Covariate sets are FIXED by design, not configurable: the normals
    # trend uses (1, elev, tdi, lst_month) and the anomaly GWR uses
    # (1, elev, local_x, local_y) — see interp/point.py. The variogram
    # params are fit to residuals of exactly the trend design
    # (interp/params.py), so changing one without the other silently breaks
    # the kriging model; a knob here would be a footgun, not flexibility.
    weight_kernel: str = "bisquare"  # distance kernel for GWR/param interp
    ridge: float = 1e-6            # normal-equation ridge for f32 conditioning
    chol_jitter: float = 1e-5      # kriging matrix jitter (fraction of sill)
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class VariogramParams:
    n_bins: int = 15               # empirical variogram distance bins
    max_dist_frac: float = 0.5     # bin span as a fraction of max pair distance
    gn_iters: int = 50             # Gauss-Newton iterations for WLS fit
    k_fit_neighbors: int = 64      # moving-window neighborhood for per-station fit
    model: str = "exponential"


@dataclasses.dataclass(frozen=True)
class PPCAParams:
    n_components: int = 12
    n_neighbors: int = 24          # correlated predictor stations per target
    max_iters: int = 200
    tol: float = 1e-5
    min_var_ratio: float = 0.05    # variance floor on imputed values
    batch_size: int = 32           # target stations per device batch


@dataclasses.dataclass(frozen=True)
class MeshParams:
    """Device-mesh shape for the shard_map tile engine (replaces the
    reference's mpi4py task farm, SURVEY.md X1). The sharded axis name is
    dist.mesh.CELL_AXIS; production is host-write-bound, so there is no
    tile-batching knob (the device finishes a tile ~20x faster than the
    host writes one)."""

    n_devices: int = 0             # 0 = use all local devices


@dataclasses.dataclass(frozen=True)
class TopoConfig:
    data_dir: str = "data"
    start_date: str = "1948-01-01"
    end_date: str = "2016-12-31"
    cellsize: float = CELLSIZE_30ARCSEC
    tile_rows: int = 128
    tile_cols: int = 128
    # int16 packing does the real size reduction; gzip on packed data buys
    # ~18% size for ~5x write time on a 1-core host (measured: 2.7k vs
    # 12.8k cells/s end-to-end) — default off, raise for archival runs.
    output_compress: int = 0   # tile gzip level; 0 = fastest writes
    output_pack: bool = True   # int16 scale/offset packing
    # Direct-to-mosaic production: the engine's writer thread places each
    # finished tile straight into the final mosaic file on a RUN-GLOBAL
    # int16 grid (the pack_* bounds below), skipping per-tile files and the
    # whole mosaic copy/requantization pass. Multi-host runs write one
    # full-grid shard per process (single HDF5 writer per file preserved);
    # the mosaic stage publishes a virtual-dataset master over the shards.
    mosaic_direct: bool = True
    # validate: fraction of land tiles the fast (streamed-stats) validate
    # re-reads from disk as an independent spot check; --deep scans all.
    validate_sample_frac: float = 0.1
    # Failure detection (SURVEY §5): seconds of zero tile-pipeline progress
    # after which the engine declares the run wedged (a device transfer
    # that never completes leaves the process blocked forever in an
    # uncancellable device_get) and exits hard with code 75 (EX_TEMPFAIL)
    # so a wrapper loop can relaunch; stage-level + tile-manifest resume
    # make the relaunch cheap. 0 = disabled. Must comfortably exceed the
    # worst first-compile wall — there are no progress events while the
    # first tile compiles.
    stall_timeout_s: int = 0
    # Run-global int16 pack window for daily values and normals, in C.
    # Physical-extreme margins (world records are approx -89/+57 C): the
    # 160 C span quantizes at 160/65500 ~= 2.4e-3 C — half-step error
    # 1.2e-3 C, far inside every accuracy bar. Values outside clip.
    pack_temp_lo: float = -90.0
    pack_temp_hi: float = 70.0
    pack_se_hi: float = 32.0   # kriging-se pack window is [0, pack_se_hi]
    interp: InterpParams = dataclasses.field(default_factory=InterpParams)
    variogram: VariogramParams = dataclasses.field(default_factory=VariogramParams)
    ppca: PPCAParams = dataclasses.field(default_factory=PPCAParams)
    mesh: MeshParams = dataclasses.field(default_factory=MeshParams)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TopoConfig":
        raw: dict[str, Any] = json.loads(text)
        return cls(
            **{
                **raw,
                "interp": InterpParams(**_tup(raw.get("interp", {}))),
                "variogram": VariogramParams(**raw.get("variogram", {})),
                "ppca": PPCAParams(**raw.get("ppca", {})),
                "mesh": MeshParams(**raw.get("mesh", {})),
            }
        )

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "TopoConfig":
        return cls.from_json(pathlib.Path(path).read_text())

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(self.to_json())


def _tup(d: dict) -> dict:
    # drop removed knobs (covariate sets, kernel choice) from old config
    # files; tuple-ify any remaining list-valued fields for the frozen
    # dataclass
    d = {k: v for k, v in d.items()
         if k not in ("trend_covariates", "anom_covariates", "use_pallas")}
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
