"""The year-batched daily application (one scatter + one dot over every
month and variable, taken when station validity is month-invariant) against
the per-month loop (gather-einsum for dpm <= 64, scatter + dot above) on the
same geometry: the same anomalies up to float32 summation order."""

import numpy as np
import jax
import pytest

from topotpu.core.config import InterpParams
from topotpu.core.dates import get_days_metadata
from topotpu.interp.point import (
    PairTileInputs,
    VarFields,
    interp_tile,
    interp_tile_pair,
)
from topotpu.io.synthetic import make_world, tile_inputs_from_world

SPANS = {31: ("2015-01-01", "2015-12-31"), 124: ("2012-01-01", "2015-12-31")}


@pytest.mark.parametrize("n_vars", [1, 2])
@pytest.mark.parametrize("dpm", [31, 124])
def test_year_batched_daily_matches_month_loop(dpm, n_vars):
    days = get_days_metadata(*SPANS[dpm])
    world = make_world(np.random.default_rng(dpm + n_vars), nrows=16,
                       ncols=16, n_stations=40, ndays=days.ndays)
    rows, cols = np.unravel_index(np.arange(64), (16, 16))
    ti, layout = tile_inputs_from_world(world, days.month_idx, rows, cols)
    assert layout.dpm == dpm
    params = InterpParams(k_neighbors=12, k_neighbors_anom=8)
    if n_vars == 1:
        step = lambda shared: jax.jit(  # noqa: E731
            lambda t: (interp_tile(t, params, shared_validity=shared),))(ti)
    else:
        pair = PairTileInputs(geom=ti, b=VarFields(
            norm=ti.stn_norm + 9.0, vario=ti.stn_vario,
            anoms=ti.stn_anoms * 0.85))
        step = lambda shared: jax.jit(  # noqa: E731
            lambda p: interp_tile_pair(p, params, shared_validity=shared))(pair)
    batched, looped = step(True), step(False)
    for rb, rl in zip(batched, looped):
        np.testing.assert_array_equal(np.asarray(rb.ok), np.asarray(rl.ok))
        np.testing.assert_allclose(np.asarray(rb.normal),
                                   np.asarray(rl.normal), atol=1e-5)
        np.testing.assert_allclose(np.asarray(rb.daily), np.asarray(rl.daily),
                                   atol=1e-4)
