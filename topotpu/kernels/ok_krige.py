"""Ordinary-kriging solve: the fused CUDA kernel on the GPU, XLA elsewhere.

``ok_krige`` replaces the XLA chain pair distances -> (B, k, k) covariance
in device memory -> batched Cholesky -> two triangular solves
(``kernels/cholesky.py::ok_krige_xla``) with one warp per system
(``ok_krige.cu``): the covariance is assembled and factored in registers and
only the (B, k) weights are written back.

The choice is made per lowering platform with ``lax.platform_dependent``:
a step lowered for CUDA calls the kernel, any other platform (the CPU test
suite, the float64 oracle run) gets the XLA chain. The kernel covers
k <= 64 (every neighbourhood size the pipeline selects); larger k and
non-float32 inputs take the XLA chain on every platform.

The shared library is built from ``ok_krige.cu`` with ``nvcc`` at first use
in a process that has a GPU, into ``kernels/_build/`` (listed in
``.gitignore``). A build or registration failure raises: a GPU run never
falls back to the XLA chain silently.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from topotpu.kernels.cholesky import OKSolution, ok_krige_xla

MAX_K = 64
TARGET = "topotpu_ok_krige"
_SRC = pathlib.Path(__file__).with_name("ok_krige.cu")
_BUILD_DIR = pathlib.Path(__file__).with_name("_build")


def _gpu_present() -> bool:
    try:
        return bool(jax.devices("gpu"))
    except RuntimeError:
        return False


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("ok_krige: nvcc not found (set CUDA_HOME or PATH)")


def build_library() -> pathlib.Path:
    """Compile ``ok_krige.cu`` for sm_90a; the output name carries the
    source hash, so an edited kernel is never served from a stale build."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libok_krige_{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", str(tmp), str(_SRC),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"ok_krige: nvcc failed ({proc.returncode}):\n{proc.stderr}"
        )
    tmp.replace(out)
    return out


@functools.cache
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(str(build_library()))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.TopotpuOkKrige), platform="CUDA"
    )


def _ok_krige_cuda(nbr_xyz, dist, mask, vario, jitter_frac, min_neighbors):
    lead = dist.shape[:-1]
    k = dist.shape[-1]
    out_types = (
        jax.ShapeDtypeStruct(lead + (k,), jnp.float32),
        jax.ShapeDtypeStruct(lead, jnp.float32),
        jax.ShapeDtypeStruct(lead, jnp.float32),
    )
    w, var, ok = jax.ffi.ffi_call(TARGET, out_types)(
        nbr_xyz, dist, mask.astype(jnp.float32), vario,
        jitter_frac=np.float32(jitter_frac),
        min_neighbors=np.int32(min_neighbors),
    )
    return OKSolution(weights=w, variance=var, ok=ok > 0.5)


def ok_krige(
    nbr_xyz: jnp.ndarray,
    dist: jnp.ndarray,
    mask: jnp.ndarray,
    vario: jnp.ndarray,
    jitter_frac: float = 1e-5,
    min_neighbors: int = 3,
) -> OKSolution:
    """Ordinary-kriging weights, variance and solvable flag.

    nbr_xyz (..., k, 3) unit-sphere neighbor coordinates, dist (..., k) km
    to the prediction point, mask (..., k), vario (..., 3) nugget/psill/range
    per system.
    """
    xla = functools.partial(
        ok_krige_xla, jitter_frac=jitter_frac, min_neighbors=min_neighbors
    )
    if dist.dtype != jnp.float32 or dist.shape[-1] > MAX_K:
        return xla(nbr_xyz, dist, mask, vario)
    if _gpu_present():
        _register()
    cuda = functools.partial(
        _ok_krige_cuda, jitter_frac=jitter_frac, min_neighbors=min_neighbors
    )
    return lax.platform_dependent(
        nbr_xyz, dist, mask, vario, cuda=cuda, default=xla
    )
