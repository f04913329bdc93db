"""Device-step benchmark: variable-cells/sec of the paired tmin+tmax tile
step (12 kriged monthly normals + kriging variance and 365 daily GWR values
for BOTH variables, interp.point.interp_tile_pair) on one GPU.

One step is one production tile: 128x128 = 16,384 cells against a
512-station pool (config #8's geometry), the shape TileEngine dispatches.
Times with ``block_until_ready`` after a warm-up; compile time is reported
separately as set-up. Fails when JAX finds no GPU: a CPU number is not this
system's speed.

Prints ONE JSON line naming the device, the card and its power limit.
"""

import json
import subprocess
import sys
import time

import numpy as np


def require_gpu():
    """The JAX devices, or exit non-zero when the first is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {devs[0].platform} devices")
    return devs


def card() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def device_info(devs) -> dict:
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _trace_summary(log_dir) -> dict:
    """Aggregate a jax.profiler perfetto trace into {event name: total ms},
    top events first. It adds up every event of the trace, host waits
    included (ROADMAP A2 replaces it with a device-plane reduction)."""
    import gzip
    import pathlib

    files = sorted(
        pathlib.Path(log_dir).glob("plugins/profile/*/*.trace.json.gz")
    )
    if not files:
        return {"error": f"no trace.json.gz produced under {log_dir}"}
    with gzip.open(files[-1], "rt") as f:
        trace = json.load(f)
    by_name: dict[str, float] = {}
    total = 0.0
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        name = ev.get("name", "?")
        by_name[name] = by_name.get(name, 0.0) + ev["dur"] / 1e3  # us -> ms
        total += ev["dur"] / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:15])
    return {
        "trace_file": str(files[-1]),
        "total_event_ms": total,
        "top_events_ms": top,
    }


def paired_step(n_cells: int = 16384, n_stations: int = 512, k: int = 32,
                seed: int = 0):
    """(jitted paired step, device-resident PairTileInputs) for one square
    synthetic tile of ``n_cells`` cells over ``n_stations`` stations."""
    import jax

    from topotpu.core.config import InterpParams
    from topotpu.core.dates import get_days_metadata
    from topotpu.interp.point import PairTileInputs, VarFields, interp_tile_pair
    from topotpu.io.synthetic import make_world, tile_inputs_from_world

    side = int(round(np.sqrt(n_cells)))
    rng = np.random.default_rng(seed)
    world = make_world(rng, nrows=side, ncols=side, n_stations=n_stations,
                       ndays=365)
    days = get_days_metadata("2015-01-01", "2015-12-31")
    rows, cols = np.unravel_index(np.arange(side * side), (side, side))
    ti, _ = tile_inputs_from_world(world, days.month_idx, rows, cols)
    pair = PairTileInputs(
        geom=ti,
        b=VarFields(norm=ti.stn_norm + 9.0, vario=ti.stn_vario,
                    anoms=ti.stn_anoms * 0.85),
    )
    params = InterpParams(k_neighbors=k)
    # synthetic stations are valid in all months -> one neighborhood
    # selection (the engine detects the same condition in production)
    fn = jax.jit(lambda p: interp_tile_pair(p, params, shared_validity=True))
    return fn, jax.device_put(pair)


def time_step(fn, pair, n_iter: int = 10) -> dict:
    """Compile+first-run seconds and steady per-step milliseconds."""
    import jax

    t0 = time.perf_counter()
    res_a, res_b = jax.block_until_ready(fn(pair))
    compile_s = time.perf_counter() - t0
    assert np.isfinite(np.asarray(res_a.normal)).all()
    assert np.isfinite(np.asarray(res_b.normal)).all()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        res = fn(pair)
    jax.block_until_ready(res)
    return {"compile_s": compile_s,
            "step_ms": (time.perf_counter() - t0) / n_iter * 1e3}


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=16384)
    ap.add_argument("--stations", type=int, default=512)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--trace-dir", default=None,
                    help="also capture a jax.profiler trace of two steps "
                         "into this directory and summarise it")
    args = ap.parse_args()

    devs = require_gpu()
    from topotpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    fn, pair = paired_step(args.cells, args.stations, args.k)
    t = time_step(fn, pair)
    trace = None
    if args.trace_dir:
        import jax

        from topotpu.utils.profiling import device_trace

        with device_trace(args.trace_dir):
            jax.block_until_ready([fn(pair) for _ in range(2)])
        trace = _trace_summary(args.trace_dir)
    print(json.dumps({
        "metric": "variable-cells/sec of the paired tmin+tmax tile step "
                  f"({args.cells} cells, pool {args.stations}, k={args.k}, "
                  "365 days, one device)",
        "value": 2 * args.cells / (t["step_ms"] / 1e3),
        "unit": "var-cells/s",
        "step_ms": t["step_ms"],
        "compile_s": t["compile_s"],
        "card": card(),
        "device": device_info(devs),
        **({"trace": trace} if trace else {}),
    }))


if __name__ == "__main__":
    main()
