"""Multi-host (DCN) scale-out: partitioned tile production across processes.

Parity target: the reference ran its mpi4py task farm across cluster nodes
(SURVEY.md §2 X1 — rank 0 handing out tile ids over send/recv, a writer
rank serializing output). The translation keeps the *shape* of that design
but moves the parallelism boundaries to where accelerator hosts put them:

* **within a host**: one SPMD program over the local device mesh — see
  ``dist.mesh``; zero collectives in the hot path (stations replicated).
* **across hosts (DCN)**: tiles are *statically* partitioned by
  ``tile_id % process_count`` — no dynamic master/worker queue, because the
  per-tile cost is uniform (fixed padded shapes) so static striding balances
  within one tile's work, and it keeps hosts fully independent: no
  coordinator process, no cross-host messages in the steady state. Each
  host runs its own TileEngine over its own tile subset with its own
  manifest file (``manifest_pNNN.json``) — the single-writer discipline the
  reference enforced with a writer rank falls out of disjoint file sets.
* **merge**: the mosaic stage (coordinator-only) unions per-host manifests
  and reads every host's tile files off the shared filesystem.

``jax.distributed`` provides process identity and a startup barrier; the
production path never moves device data across hosts.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterable, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from topotpu.dist.mesh import CELL_AXIS


@dataclasses.dataclass(frozen=True)
class MultihostContext:
    """Process identity for a (possibly single-process) production job."""

    process_index: int = 0
    process_count: int = 1

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0

    def owns_tile(self, tile_id: int) -> bool:
        return tile_id % self.process_count == self.process_index

    def manifest_name(self) -> str:
        if self.process_count == 1:
            return "manifest.json"
        return f"manifest_p{self.process_index:03d}.json"


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> MultihostContext:
    """Wire up jax.distributed and return this process's context.

    Pass all three explicitly (GPU hosts and CPU/localhost test rigs
    have no cluster metadata to auto-configure from). A
    (num_processes or 1) == 1 call skips jax.distributed entirely — the
    single-process path must not require a coordination service.
    """
    if (num_processes or 1) == 1 and coordinator_address is None:
        return MultihostContext()
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return MultihostContext(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
    )


def partition_tiles(tiles: Iterable, ctx: MultihostContext) -> list:
    """Strided static partition of TileSpecs: tile_id % count == index."""
    return [t for t in tiles if ctx.owns_tile(t.tile_id)]


def local_mesh(n_devices: int = 0) -> Mesh:
    """Per-host mesh over this process's local devices only. The engine's
    hot path is collective-free; cross-host traffic stays on the
    filesystem, so the device mesh never spans DCN."""
    devices = jax.local_devices()
    if n_devices:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (CELL_AXIS,))


def merge_manifests(out_dir: str | pathlib.Path) -> dict:
    """Union per-host manifests into the canonical manifest.json
    (coordinator-only, run at mosaic time). Disjoint by construction —
    overlapping tile keys would mean two hosts claimed one tile, so that
    is asserted, not papered over."""
    out_dir = pathlib.Path(out_dir)
    merged: dict = {"tiles": {}}
    parts = sorted(out_dir.glob("manifest_p*.json"))
    for p in parts:
        part = json.loads(p.read_text())
        overlap = set(part["tiles"]) & set(merged["tiles"])
        assert not overlap, f"tile(s) claimed by two hosts: {sorted(overlap)}"
        merged["tiles"].update(part["tiles"])
    if parts:
        tmp = out_dir / "manifest.json.tmp"
        tmp.write_text(json.dumps(merged, indent=0))
        tmp.replace(out_dir / "manifest.json")
    elif (out_dir / "manifest.json").exists():
        merged = json.loads((out_dir / "manifest.json").read_text())
    return merged


def barrier(name: str = "topotpu") -> None:
    """Cross-host sync point (end of a stage). No-op single-process."""
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


# --- legacy helpers (kept for API stability) --------------------------------


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Deprecated: use init_multihost (returns the process context)."""
    init_multihost(coordinator_address, num_processes, process_id)


def global_mesh() -> Mesh:
    """1-D cells mesh over every chip in the job (all hosts). Not used by
    the production engine (which is per-host by design, see module doc) —
    provided for experiments that want one cross-host SPMD program."""
    return Mesh(np.array(jax.devices()), (CELL_AXIS,))


def is_coordinator() -> bool:
    return jax.process_index() == 0
