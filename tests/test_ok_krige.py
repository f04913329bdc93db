"""Choice, layout and padding rules of the fused kriging solve
(kernels/ok_krige.py). The CUDA kernel itself runs only on a GPU (tests
marked ``gpu``); everything around it is checked here against the XLA chain
(kernels/cholesky.py::ok_krige_xla)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from topotpu.geo.distance import unit_xyz
from topotpu.kernels.cholesky import ok_krige_xla
from topotpu.kernels.ok_krige import MAX_K, TARGET, ok_krige


def _systems(B, k, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    lon = -100.0 + rng.uniform(0, 1.5, (B, k))
    lat = 40.0 + rng.uniform(0, 1.0, (B, k))
    xyz = np.asarray(unit_xyz(lon, lat))
    dist = rng.uniform(1.0, 90.0, (B, k))
    mask = rng.uniform(size=(B, k)) > 0.15
    vario = np.stack([rng.uniform(0.02, 0.3, B), rng.uniform(0.5, 2.0, B),
                      rng.uniform(20.0, 120.0, B)], -1)
    return tuple(jnp.asarray(a, dtype) if a.dtype != bool else jnp.asarray(a)
                 for a in (xyz, dist, mask, vario))


def _cuda_hlo(args):
    return jax.jit(ok_krige).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()


def test_cpu_lowering_is_the_xla_chain():
    args = _systems(24, 40)
    got = jax.jit(ok_krige)(*args)
    want = jax.jit(ok_krige_xla)(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert TARGET not in jax.jit(ok_krige).lower(*args).as_text()


@pytest.mark.parametrize("k", [8, 48, MAX_K])
def test_cuda_lowering_calls_kernel_with_row_major_operands(k):
    """Lowered for CUDA the solve is one custom call on (B, k, 3) xyz,
    (B, k) dist and float mask, (B, 3) vario -> (B, k), (B,), (B,)."""
    hlo = _cuda_hlo(_systems(24, k))
    assert hlo.count(TARGET) == 1
    call = next(ln for ln in hlo.splitlines() if TARGET in ln)
    for t in (f"tensor<24x{k}x3xf32>", f"tensor<24x{k}xf32>",
              "tensor<24x3xf32>", "tensor<24xf32>"):
        assert t in call, (t, call)
    assert "cholesky" not in hlo.lower()


@pytest.mark.parametrize("case", ["k_above_max", "float64"])
def test_outside_kernel_range_takes_xla_chain(case):
    if case == "k_above_max":
        args = _systems(8, MAX_K + 8)
        assert TARGET not in _cuda_hlo(args)
    else:
        with jax.enable_x64(True):
            args = _systems(8, 16, dtype=np.float64)
            assert TARGET not in _cuda_hlo(args)
            got = ok_krige(*args)
            assert got.weights.dtype == jnp.float64


def test_masked_padding_slots_are_inert():
    """The kernel pads k up to 32 or 64 with identity rows; the same
    padding in the XLA chain leaves weights and variance unchanged."""
    xyz, dist, mask, vario = _systems(16, 20)
    pad = lambda a: jnp.concatenate(  # noqa: E731
        [a, jnp.zeros(a.shape[:1] + (12,) + a.shape[2:], a.dtype)], axis=1)
    ref = ok_krige_xla(xyz, dist, mask, vario)
    got = ok_krige_xla(pad(xyz), pad(dist), pad(mask), vario)
    np.testing.assert_allclose(np.asarray(got.weights[:, :20]),
                               np.asarray(ref.weights), atol=1e-6)
    assert not np.asarray(got.weights[:, 20:]).any()
    np.testing.assert_allclose(np.asarray(got.variance),
                               np.asarray(ref.variance), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.ok), np.asarray(ref.ok))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [16, 32, 48, MAX_K])
def test_cuda_kernel_matches_xla_chain(gpu, k):
    args = jax.device_put(_systems(2048, k, seed=k), gpu)
    got = jax.device_get(jax.jit(ok_krige)(*args))
    want = jax.device_get(jax.jit(ok_krige_xla)(*args))
    np.testing.assert_array_equal(got.ok, want.ok)
    np.testing.assert_allclose(got.weights, want.weights, atol=2e-3)
    np.testing.assert_allclose(got.variance, want.variance, atol=5e-3)
    assert not got.weights[~np.asarray(args[2])].any()
