"""Device mesh + SPMD tile interpolation.

Parity target: the reference's entire distributed backend — the mpi4py
master/worker task farm of ``bin/mpi_*.py`` (SURVEY.md §2 X1: rank 0 hands
out tile ids over send/recv, rank 1 writes, ranks >=2 loop work items).

Replacement (SURVEY.md §2 parallelism checklist):

* one ``jax.sharding.Mesh`` over all local devices, single axis ``cells``;
* a tile's cell batch is sharded over that axis with ``shard_map``; the
  station pool, being tiny (~KBs), is **replicated** on every device, so the
  hot path has ZERO cross-device collectives by construction — the
  reference's embarrassingly parallel station farm, with the parallelism
  *inside* one XLA program instead of across MPI ranks;
* multi-host (DCN) scale-out would wrap the same program in
  ``jax.distributed.initialize`` + a global mesh; tiles simply shard a
  bigger cell axis.

The writer rank's job (serializing netCDF output) becomes the host-side
``TileEngine`` loop in ``topotpu.dist.engine``.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from topotpu.core.config import InterpParams
from topotpu.interp.point import TileInputs, interp_tile

CELL_AXIS = "cells"

# TileInputs fields whose leading axis is the cell batch (sharded); all other
# fields are station-pool arrays (replicated).
_CELL_FIELDS = ("cell_lon", "cell_lat", "cell_elev", "cell_tdi", "cell_lst", "cell_mask")


def make_mesh(n_devices: int = 0, devices=None) -> Mesh:
    """1-D mesh over local devices; ``cells`` is the sharded axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (CELL_AXIS,))


def tile_input_specs() -> TileInputs:
    """PartitionSpecs per TileInputs field (cells sharded, stations replicated)."""
    return TileInputs(
        **{
            f: P(CELL_AXIS) if f in _CELL_FIELDS else P()
            for f in TileInputs._fields
        }
    )


def sharded_interp_tile(
    mesh: Mesh, params: InterpParams, shared_validity: bool = False,
    pack_daily: bool = False,
):
    """Build the jitted SPMD tile-interpolation step for a mesh.

    Returns ``fn(TileInputs) -> TileResult`` where cell-batch inputs must have
    leading dim divisible by mesh size (the engine pads tiles so this holds).
    Each device computes its cell shard against the replicated station pool —
    no collectives are emitted in the hot path (asserted in tests by
    inspecting the compiled HLO).
    """
    in_specs = tile_input_specs()
    out_specs = _result_specs()

    fn = shard_map(
        functools.partial(
            interp_tile, params=params, shared_validity=shared_validity,
            pack_daily=pack_daily,
            mesh_axis=CELL_AXIS if pack_daily else None,
        ),
        mesh=mesh,
        in_specs=(in_specs,),  # one positional arg: the TileInputs pytree
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_interp_tile_flat(
    mesh: Mesh, params: InterpParams, shared_validity: bool = False,
    fixed: bool = False,
):
    """SPMD production step with the single-buffer int16 output.

    Same sharding story as sharded_interp_tile; the only collectives are the
    six scalar pmin/pmax reductions for the pack scales. The (ndays+24, C)
    buffer keeps the cell axis sharded so each device quantizes and reorders
    its own shard. Returns ``fn(TileInputs, slot_of_day) -> FlatTileResult``
    where slot_of_day is the (ndays,) calendar->grouped-slot map (replicated).

    ``fixed``: quantize on a caller-supplied run-global int16 grid instead —
    the returned fn takes a third (6,) f32 ``fixed_scales`` argument
    (replicated), and the program emits ZERO collectives (the pmin/pmax
    pair of the dynamic path were the only ones). Used by the engine's
    direct-to-mosaic mode, where every tile must share one lattice."""
    from topotpu.interp.point import FlatTileResult, interp_tile_flat

    fn = shard_map(
        functools.partial(
            interp_tile_flat, params=params,
            shared_validity=shared_validity,
            mesh_axis=None if fixed else CELL_AXIS,
        )
        if not fixed else
        functools.partial(
            _flat_fixed_adapter, params=params,
            shared_validity=shared_validity,
        ),
        mesh=mesh,
        in_specs=(tile_input_specs(), P()) + ((P(),) if fixed else ()),
        out_specs=FlatTileResult(buf=P(None, CELL_AXIS), scales=P()),
        check_vma=False,
    )
    return jax.jit(fn)


def _flat_fixed_adapter(inputs, slot_of_day, fixed_scales, *, params,
                        shared_validity):
    from topotpu.interp.point import interp_tile_flat

    return interp_tile_flat(
        inputs, slot_of_day, params, shared_validity=shared_validity,
        mesh_axis=None, fixed_scales=fixed_scales,
    )


def pair_input_specs():
    """PartitionSpecs for PairTileInputs: var A's TileInputs as usual; var
    B's station fields replicated like every other station-pool array."""
    from topotpu.interp.point import PairTileInputs, VarFields

    return PairTileInputs(
        geom=tile_input_specs(),
        b=VarFields(norm=P(), vario=P(), anoms=P()),
    )


def sharded_interp_tile_pair_flat(
    mesh: Mesh, params: InterpParams, shared_validity: bool = False,
    fixed: bool = False, reconcile: bool = False,
):
    """SPMD production step for BOTH variables at once (tmin + tmax).

    Same collective-free sharding story; neighborhoods, GWR gains and the
    daily scatter are computed once and shared across the two variables
    (interp.point._interp_tile_multi), and the whole two-variable product
    leaves the device as ONE flat int16 buffer (one fetch).
    Returns ``fn(PairTileInputs, slot_of_day) -> FlatTileResult`` with
    buf (2*(ndays+24), C) and scales (12,).

    ``fixed``: run-global pack grid — the fn takes a third (12,) f32
    ``fixed_scales`` argument and emits zero collectives (see
    sharded_interp_tile_flat). ``reconcile``: device-side daily tmin<=tmax
    midpoint fix (interp_tile_pair_flat; var A must be tmin)."""
    from topotpu.interp.point import FlatTileResult, interp_tile_pair_flat

    fn = shard_map(
        functools.partial(
            interp_tile_pair_flat, params=params,
            shared_validity=shared_validity,
            mesh_axis=None if fixed else CELL_AXIS,
            reconcile=reconcile,
        )
        if not fixed else
        functools.partial(
            _pair_fixed_adapter, params=params,
            shared_validity=shared_validity, reconcile=reconcile,
        ),
        mesh=mesh,
        in_specs=(pair_input_specs(), P()) + ((P(),) if fixed else ()),
        out_specs=FlatTileResult(buf=P(None, CELL_AXIS), scales=P()),
        check_vma=False,
    )
    return jax.jit(fn)


def _pair_fixed_adapter(pair, slot_of_day, fixed_scales, *, params,
                        shared_validity, reconcile):
    from topotpu.interp.point import interp_tile_pair_flat

    return interp_tile_pair_flat(
        pair, slot_of_day, params, shared_validity=shared_validity,
        mesh_axis=None, fixed_scales=fixed_scales, reconcile=reconcile,
    )


def shard_pair_inputs(mesh: Mesh, pair):
    """device_put a PairTileInputs with the engine's shardings (the SAME
    pair_input_specs the compiled program's in_specs use — one source of
    truth, so the host-side layout cannot silently diverge from it)."""
    from topotpu.interp.point import PairTileInputs, VarFields

    b_specs = pair_input_specs().b
    return PairTileInputs(
        geom=shard_tile_inputs(mesh, pair.geom),
        b=VarFields(
            *(
                jax.device_put(v, NamedSharding(mesh, s))
                for v, s in zip(pair.b, b_specs)
            )
        ),
    )


def _result_specs():
    from topotpu.interp.point import TileResult

    # every TileResult array field has the cell axis at position 1:
    # (12, C, ...); the pack scale/offset scalars are replicated (they are
    # global pmin/pmax reductions in packed mode, constants otherwise)
    return TileResult(
        normal=P(None, CELL_AXIS),
        se=P(None, CELL_AXIS),
        ok=P(None, CELL_AXIS),
        daily=P(None, CELL_AXIS, None),
        vario=P(None, CELL_AXIS, None),
        daily_scale=P(),
        daily_offset=P(),
    )


def shard_tile_inputs(mesh: Mesh, ti: TileInputs) -> TileInputs:
    """device_put with the engine's shardings (cells split, stations replicated)."""
    specs = tile_input_specs()
    return TileInputs(
        *(
            jax.device_put(v, NamedSharding(mesh, s))
            for v, s in zip(ti, specs)
        )
    )
