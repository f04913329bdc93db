"""float64 end-to-end validation mode (SURVEY.md §7 "f32 vs f64").

The production device path is float32 with nugget+jitter conditioning;
kriging systems go ill-conditioned when the fitted nugget approaches zero
and the correlation range dwarfs the neighborhood window (all neighbors
nearly perfectly correlated -> covariance matrix nearly singular). Per-kernel
f64 parity lives in the numpy oracles (topotpu/oracle/); this module closes
the loop END-TO-END: run the complete tile path (neighbor selection -> GWR
trend -> variogram-param interpolation -> kriging solve -> daily GWR) under
``jax.experimental.enable_x64`` on CPU and quantify the f32 error against it.

Parity framing: the reference did everything in float64 (numpy/R defaults),
so "f32 vs f64 end-to-end" IS "rebuild vs reference numerics" for the solve
chain; the BASELINE bar is 0.05 C RMSE.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np

from topotpu.core.config import InterpParams
from topotpu.interp.point import TileInputs, TileResult, interp_tile


def _cast_inputs(ti: TileInputs, dtype) -> TileInputs:
    """Cast float fields; leave bool masks alone."""
    return TileInputs(
        *(
            np.asarray(v, dtype) if np.issubdtype(np.asarray(v).dtype, np.floating)
            else np.asarray(v)
            for v in ti
        )
    )


def run_tile_f64(ti: TileInputs, params: InterpParams) -> TileResult:
    """The full tile interpolation in float64 on the CPU backend.

    Unpacked; everything else — including neighbor selection and the SPD
    kriging reduction — is the same code the device runs, traced at f64
    (float64 inputs take the XLA kriging chain on every platform).
    """
    params64 = dataclasses.replace(params, dtype="float64")
    cpu = jax.devices("cpu")[0]  # the reference side always runs on the CPU
    with jax.enable_x64(True), jax.default_device(cpu):
        ti64 = jax.tree.map(lambda x: jax.device_put(x), _cast_inputs(ti, np.float64))
        fn = jax.jit(functools.partial(interp_tile, params=params64))
        res = fn(ti64)
        return TileResult(*(np.asarray(v) for v in res))


def compare_f32_f64(
    ti: TileInputs, params: InterpParams, day_valid=None
) -> dict:
    """Run the tile path at f32 on the default device (the production
    path, kernels included) and at f64 on the CPU; report error statistics.

    Only cells both paths mark ok are compared (conditioning differences can
    legitimately flip min_neighbors/solve-failure flags on the boundary; the
    flip rate is reported separately).

    ``day_valid``: the MonthLayout's (12, dpm) real-day mask. Padded month
    slots carry daily = normal + zero anomaly on BOTH paths, so including
    them (the default when the layout is unknown) dilutes the daily RMSE
    toward the smaller normals error — pass the mask whenever the calendar
    is available so the 0.05 C parity bar judges real days only."""
    f32 = jax.jit(functools.partial(interp_tile, params=params))(
        _cast_inputs(ti, np.float32)
    )
    f64 = run_tile_f64(ti, params)

    ok32 = np.asarray(f32.ok)
    ok64 = np.asarray(f64.ok)
    both = ok32 & ok64

    def stats(a, b, mask):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        d = (a - b)[mask]
        if d.size == 0:
            return {"rmse": 0.0, "max": 0.0}
        return {
            "rmse": float(np.sqrt((d**2).mean())),
            "max": float(np.abs(d).max()),
        }

    dshape = np.asarray(f32.daily).shape  # (12, C, dpm)
    if day_valid is not None:
        dmask = both[:, :, None] & np.asarray(day_valid)[:, None, :]
    else:
        dmask = both[:, :, None] & np.ones(dshape, bool)
    out = {
        "normal": stats(f32.normal, f64.normal, both),
        "se": stats(f32.se, f64.se, both),
        "daily": stats(f32.daily, f64.daily, dmask),
        "ok_flip_rate": float((ok32 != ok64).mean()),
        "n_compared": int(both.sum()),
    }
    return out
