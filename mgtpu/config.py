"""Global configuration for mgtpu.

The reference framework (JuliaInv/Multigrid.jl) is {Float32,Float64,ComplexF32,
ComplexF64}-generic (reference: src/Multigrid.jl:19-20, MGdef.jl:91-116).  We keep
the same four value types.  float64/complex128 require `jax_enable_x64`; the
production path is f32 hierarchies with f64 (or double-single) residuals for
refinement and host-side scipy f64 for verification.
"""
from __future__ import annotations

import os

import jax
import numpy as np

_X64_ENABLED = False

# Precision of every float32 matrix product on the solve path.  XLA:GPU may
# otherwise run f32 products in TF32 (about three decimal digits), which
# would cap the coarsest solve, the Krylov projections and the Vanka block
# solves near 1e-3 relative error.
HIGHEST = jax.lax.Precision.HIGHEST


# Persistent XLA compilation cache.  Where JAX_COMPILATION_CACHE_DIR is set,
# JAX reads it itself and nothing is set here; otherwise the cache lives at
# this one fixed path inside the checkout (listed in .gitignore), so every
# process started from the checkout hits the same cache.
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".xla_cache")


def _enable_compile_cache() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    os.makedirs(COMPILE_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compile_cache()


def enable_x64() -> None:
    """Enable float64/complex128 support in JAX (call before tracing)."""
    global _X64_ENABLED
    if not _X64_ENABLED:
        jax.config.update("jax_enable_x64", True)
        _X64_ENABLED = True


def supported_dtypes():
    return (np.float32, np.float64, np.complex64, np.complex128)


def real_dtype(dtype) -> np.dtype:
    return np.zeros((), dtype=dtype).real.dtype


def is_complex(dtype) -> bool:
    return np.issubdtype(np.dtype(dtype), np.complexfloating)


def single_variant(dtype) -> np.dtype:
    """Single-precision companion of a dtype.

    Mirrors the reference's `toSingle` (Vanka.jl:34-42): Vanka block inverses are
    always stored in single precision.
    """
    d = np.dtype(dtype)
    if d == np.float64:
        return np.dtype(np.float32)
    if d == np.complex128:
        return np.dtype(np.complex64)
    return d
