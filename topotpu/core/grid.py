"""Grid and tiling specification.

Parity target: the 30-arcsecond CONUS output grid + fixed tiling of the
reference's gridded production step (SURVEY.md §2.15, tiling classes in
``twx/interp/`` + ``bin/mpi_interp_tair.py``).

Design: tiles are the unit of device work. A tile is a fixed
(tile_rows x tile_cols) block of cells — static shapes so every tile compiles
once. Partial edge tiles are padded and masked, never shape-specialized.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np

# 30 arc-seconds in degrees — the reference's production resolution.
CELLSIZE_30ARCSEC = 1.0 / 120.0

# CONUS bounding box used by the reference dataset (approx; configurable).
CONUS_BOUNDS = (-125.0, 24.0, -66.5, 51.0)  # (lon_min, lat_min, lon_max, lat_max)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """A north-up regular lon/lat grid.

    ``lon0``/``lat0`` are the *centers* of the upper-left cell. Row index
    increases southward (image order), matching GDAL/netCDF conventions the
    reference's rasters use.
    """

    lon0: float
    lat0: float
    cellsize: float
    nrows: int
    ncols: int

    @classmethod
    def from_bounds(cls, lon_min, lat_min, lon_max, lat_max, cellsize=CELLSIZE_30ARCSEC):
        ncols = int(math.ceil((lon_max - lon_min) / cellsize))
        nrows = int(math.ceil((lat_max - lat_min) / cellsize))
        return cls(
            lon0=lon_min + cellsize / 2.0,
            lat0=lat_max - cellsize / 2.0,
            cellsize=cellsize,
            nrows=nrows,
            ncols=ncols,
        )

    @classmethod
    def conus_30arcsec(cls) -> "GridSpec":
        return cls.from_bounds(*CONUS_BOUNDS)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def ncells(self) -> int:
        return self.nrows * self.ncols

    def cell_lonlat(self, rows: np.ndarray, cols: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        lon = self.lon0 + np.asarray(cols) * self.cellsize
        lat = self.lat0 - np.asarray(rows) * self.cellsize
        return lon, lat

    def rowcol(self, lon: np.ndarray, lat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Nearest cell indices for points, clipped to the grid."""
        rows = np.round((self.lat0 - np.asarray(lat)) / self.cellsize).astype(int)
        cols = np.round((np.asarray(lon) - self.lon0) / self.cellsize).astype(int)
        return (
            np.clip(rows, 0, self.nrows - 1),
            np.clip(cols, 0, self.ncols - 1),
        )

    def lonlat_grids(self) -> tuple[np.ndarray, np.ndarray]:
        """Full (nrows, ncols) lon and lat center grids."""
        cols = np.arange(self.ncols)
        rows = np.arange(self.nrows)
        lon = (self.lon0 + cols * self.cellsize)[None, :].repeat(self.nrows, axis=0)
        lat = (self.lat0 - rows * self.cellsize)[:, None].repeat(self.ncols, axis=1)
        return lon, lat

    def subgrid(self, row0: int, col0: int, nrows: int, ncols: int) -> "GridSpec":
        return GridSpec(
            lon0=self.lon0 + col0 * self.cellsize,
            lat0=self.lat0 - row0 * self.cellsize,
            cellsize=self.cellsize,
            nrows=nrows,
            ncols=ncols,
        )


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """One fixed-size tile of a parent grid.

    ``nrows``/``ncols`` are the *valid* extents; device arrays are padded to
    (tile_rows, tile_cols) of the parent Tiling so all tiles share one compiled
    shape (static-shape commitment, SURVEY.md §7).
    """

    tile_id: int
    row0: int
    col0: int
    nrows: int
    ncols: int
    pad_rows: int
    pad_cols: int

    @property
    def padded_shape(self) -> tuple[int, int]:
        return (self.nrows + self.pad_rows, self.ncols + self.pad_cols)


@dataclasses.dataclass(frozen=True)
class Tiling:
    grid: GridSpec
    tile_rows: int = 128
    tile_cols: int = 128

    @property
    def n_tile_rows(self) -> int:
        return (self.grid.nrows + self.tile_rows - 1) // self.tile_rows

    @property
    def n_tile_cols(self) -> int:
        return (self.grid.ncols + self.tile_cols - 1) // self.tile_cols

    @property
    def n_tiles(self) -> int:
        return self.n_tile_rows * self.n_tile_cols

    def tile(self, tile_id: int) -> TileSpec:
        tr, tc = divmod(tile_id, self.n_tile_cols)
        row0 = tr * self.tile_rows
        col0 = tc * self.tile_cols
        nrows = min(self.tile_rows, self.grid.nrows - row0)
        ncols = min(self.tile_cols, self.grid.ncols - col0)
        return TileSpec(
            tile_id=tile_id,
            row0=row0,
            col0=col0,
            nrows=nrows,
            ncols=ncols,
            pad_rows=self.tile_rows - nrows,
            pad_cols=self.tile_cols - ncols,
        )

    def tiles(self) -> Iterator[TileSpec]:
        for tid in range(self.n_tiles):
            yield self.tile(tid)

    def land_tiles(self, landmask: np.ndarray) -> Iterator[TileSpec]:
        """Tiles containing at least one land cell (the reference iterates a
        land mask the same way — ocean tiles are skipped entirely)."""
        assert landmask.shape == self.grid.shape
        for ts in self.tiles():
            block = landmask[ts.row0 : ts.row0 + ts.nrows, ts.col0 : ts.col0 + ts.ncols]
            if block.any():
                yield ts


