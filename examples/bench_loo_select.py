"""A/B bench: station-LOO neighbor selection at reference network scale.

Measures, on a GPU, exactly what the identity-exclusion change to
``select_neighbors`` swapped: the old exact-trig (S, S) threshold-LOO
program vs the new cos-matmul identity-LOO program, at S=10,000 / k=64
(the krig-params stage geometry of config #7), plus the full new-path
``build_krig_params`` wall at the same scale.

Timing protocol: everything under jit, arrays as jit args, first-call wall
= compile + run, steady state with ``block_until_ready``.

Usage: python examples/bench_loo_select.py [--stations 10000] [--k 64]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from bench import card, require_gpu  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stations", type=int, default=10000)
    ap.add_argument("--k", type=int, default=64)
    args = ap.parse_args()

    require_gpu()
    print(f'{{"card": "{card()}"}}', flush=True)
    import jax
    import jax.numpy as jnp

    from topotpu.geo.neighbors import select_neighbors

    S, k = args.stations, args.k
    rng = np.random.default_rng(0)
    lon = jnp.asarray(rng.uniform(-125, -66, S), jnp.float32)
    lat = jnp.asarray(rng.uniform(24, 50, S), jnp.float32)
    valid = jnp.asarray(np.ones(S, bool))

    def readback(res):
        return jax.block_until_ready(res)

    def time_program(name, fn):
        t0 = time.perf_counter()
        out = fn(lon, lat, valid)
        readback(out)
        t_first = time.perf_counter() - t0
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            readback(fn(lon, lat, valid))
            runs.append(time.perf_counter() - t0)
        print(
            f'{{"program": "{name}", "S": {S}, "k": {k}, '
            f'"first_call_s": {t_first:.2f}, '
            f'"steady_s": {float(np.median(runs)):.4f}}}',
            flush=True,
        )
        return out

    @jax.jit
    def old_threshold(lo, la, va):
        return select_neighbors(lo, la, lo, la, va, k=k, exclude_self_km=1e-3)

    @jax.jit
    def new_identity(lo, la, va):
        return select_neighbors(
            lo, la, lo, la, va, k=k, exclude_idx=jnp.arange(lo.shape[0])
        )

    old = time_program("loo_select_old_threshold", old_threshold)
    new = time_program("loo_select_new_identity", new_identity)

    # same neighborhoods (membership + order) on hardware, not just CPU
    same = bool(
        np.array_equal(np.asarray(old.idx), np.asarray(new.idx))
        and np.array_equal(np.asarray(old.mask), np.asarray(new.mask))
    )
    dmax = float(np.abs(np.asarray(old.dist) - np.asarray(new.dist)).max())
    print(f'{{"neighborhoods_identical": {str(same).lower()}, '
          f'"dist_max_abs_diff_km": {dmax:.6f}}}', flush=True)

    # full new-path stage program at network scale (what config #7 runs)
    from topotpu.core.config import InterpParams, VariogramParams
    from topotpu.interp.params import build_krig_params

    elev = jnp.asarray(rng.uniform(0, 3000, S), jnp.float32)
    tdi = jnp.asarray(rng.uniform(-1, 1, S), jnp.float32)
    lst = jnp.asarray(rng.normal(10, 5, (S, 12)), jnp.float32)
    norm = jnp.asarray(rng.normal(8, 6, (S, 12)), jnp.float32)
    vm = jnp.asarray(np.ones((S, 12), bool))
    t0 = time.perf_counter()
    res = build_krig_params(
        lon, lat, elev, tdi, lst, norm, vm,
        VariogramParams(), InterpParams(),
    )
    ok = float(np.asarray(res.ok).mean())
    wall = time.perf_counter() - t0
    print(f'{{"program": "build_krig_params_new", "S": {S}, '
          f'"wall_12mo_incl_compile_s": {wall:.2f}, "ok_frac": {ok:.3f}}}',
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
