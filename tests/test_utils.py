import io
import json

import numpy as np

from topotpu.io.ushcn import compare_adjustments, parse_ushcn_monthly
from topotpu.utils.profiling import Timer
from topotpu.utils.status import StatusCheck


def test_status_check_reports_rate():
    out = io.StringIO()
    sc = StatusCheck(total=4, unit="tiles", items_per=100, out=out)
    for _ in range(4):
        sc.tick()
    text = out.getvalue()
    assert "4/4 tiles" in text
    assert "cells/s" in text
    assert sc.elapsed > 0


def test_timer_report():
    t = Timer()
    with t.scope("a"):
        sum(range(1000))
    with t.scope("b"):
        pass
    rep = json.loads(t.report(n_cells=100))
    assert set(rep["scopes"]) == {"a", "b"}
    assert rep["cells_per_sec"] > 0


def test_ushcn_compare_adjustments():
    sid = "USH00011084"
    line = f"{sid} 2010" + "".join(f"{500 + m:6d}   " for m in range(12))
    ushcn = parse_ushcn_monthly(line)
    ours = np.array([[5.0 + m / 100 + 0.1 for m in range(12)]])  # +0.1 off
    rmse = compare_adjustments(ours, np.array([2010]), ushcn, sid)
    assert abs(rmse - 0.1) < 1e-6
    assert np.isnan(compare_adjustments(ours, np.array([2010]), ushcn, "NOPE"))
    # no overlapping years
    assert np.isnan(
        compare_adjustments(ours, np.array([1999]), ushcn, sid)
    )


def test_device_trace_captures_and_summarizes(tmp_path):
    """bench.py --trace-dir path: device_trace must produce a perfetto
    trace that _trace_summary can aggregate into an event-time breakdown
    (keeps the hook exercised)."""
    import jax
    import jax.numpy as jnp

    from topotpu.utils.profiling import device_trace

    @jax.jit
    def f(x):
        return (x @ x).sum()

    x = jnp.ones((256, 256), jnp.float32)
    jax.block_until_ready(f(x))  # compile outside the trace
    with device_trace(tmp_path):
        jax.block_until_ready(f(x))

    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "bench", pathlib.Path(__file__).resolve().parent.parent / "bench.py"
    )
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    summary = bench._trace_summary(tmp_path)
    assert "error" not in summary, summary
    assert summary["total_event_ms"] > 0
    assert summary["top_events_ms"]
