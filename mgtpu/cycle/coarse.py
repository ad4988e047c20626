"""Coarsest-grid solvers (device, jittable).

The reference factorises the coarsest operator with sparse LU (UMFPACK,
reference src/Multigrid/MGsetup.jl:350) or falls back to a one-shot
Jacobi-preconditioned FGMRES (MGcycle.jl:152-168).  Sparse triangular solves
are inherently sequential and a poor fit for the device; coarse grids are small
by construction, so the idiomatic equivalent is a *dense* replicated LU whose
batched triangular solves run on-device (SURVEY.md §2 native-component
checklist item 4).  DD / Schur / direct-solver coarsest options plug in via
the same `solve(b)` protocol from mgtpu.solvers / mgtpu.dd.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import scipy.sparse as sp


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["lu", "piv"], meta_fields=[])
@dataclass(frozen=True)
class DenseLU:
    """Replicated dense LU of the coarsest operator."""
    lu: jax.Array
    piv: jax.Array

    def solve(self, b: jax.Array) -> jax.Array:
        return jsl.lu_solve((self.lu, self.piv), b)

    def solve_adjoint(self, b: jax.Array) -> jax.Array:
        # A^H x = b  <=>  x = lu_solve with trans=2 (conjugate transpose)
        return jsl.lu_solve((self.lu, self.piv), b, trans=2)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["d", "ell_idx", "ell_val"],
                   meta_fields=["inner"])
@dataclass(frozen=True)
class IterativeCoarse:
    """One-shot Jacobi-preconditioned FGMRES coarsest solve.

    Equivalent of the reference's coarseSolveType == "GMRES" escape hatch
    (MGcycle.jl:152-168: 10 inner iterations, 1 restart, loose tol).
    """
    d: jax.Array
    ell_idx: jax.Array
    ell_val: jax.Array
    inner: int

    def solve(self, b: jax.Array) -> jax.Array:
        from .relax import fgmres_relaxation
        from ..ops.ell import ell_matvec

        squeeze = b.ndim == 1
        bb = b[:, None] if squeeze else b
        mv = lambda v: ell_matvec(self.ell_idx, self.ell_val, v)
        dcol = self.d[:, None]
        x = fgmres_relaxation(mv, lambda r: dcol * r, bb,
                              jnp.zeros_like(bb), self.inner)
        return x[:, 0] if squeeze else x

    def solve_adjoint(self, b: jax.Array) -> jax.Array:
        raise NotImplementedError("transpose the hierarchy instead")


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=[], meta_fields=["factor", "n", "dtype_name"])
@dataclass(frozen=True)
class SparseLUCoarse:
    """Host sparse-LU coarsest solve through `jax.pure_callback`.

    The reference factorises ANY coarsest size with UMFPACK — a host CPU
    solve (reference src/Multigrid/MGsetup.jl:350, MGcycle.jl:146-150).
    This is the same design point: when the coarsest level is too large for
    a replicated dense inverse/LU (O(nc^2) device memory), the cycle calls
    back to a scipy SuperLU factorization on the host.  One host round-trip
    per cycle against an O(nnz) factor —
    the escape hatch for AMG hierarchies that bottom out at 1e5 dofs.

    solve(b): b is (n,) or (n, m) [flat engine convention].
    """
    factor: object          # scipy.sparse.linalg.SuperLU (f64/c128)
    n: int
    dtype_name: str

    def _call(self, b: jax.Array, trans: str) -> jax.Array:
        def cb(bh):
            out = self.factor.solve(np.asarray(bh, self.factor.U.dtype),
                                    trans=trans)
            return out.astype(bh.dtype)
        return jax.pure_callback(
            cb, jax.ShapeDtypeStruct(b.shape, b.dtype), b, vmap_method="sequential")

    def solve(self, b: jax.Array) -> jax.Array:
        return self._call(b, "N")

    def solve_adjoint(self, b: jax.Array) -> jax.Array:
        return self._call(b, "H")


def sparse_lu_from_scipy(A: sp.spmatrix, dtype=None) -> SparseLUCoarse:
    """Factor A with SuperLU on the host (f64/c128 — scipy's splu types).

    COLAMD ordering + partial pivoting; the factor stays host-side and the
    device pays one callback round-trip per coarse solve."""
    from scipy.sparse.linalg import splu
    fdt = np.complex128 if np.iscomplexobj(A.data) else np.float64
    fac = splu(A.tocsc().astype(fdt))
    return SparseLUCoarse(fac, int(A.shape[0]),
                          str(np.dtype(dtype or A.dtype)))


def dense_lu_from_scipy(A: sp.spmatrix, dtype=None) -> DenseLU:
    """Factorize on the host (LAPACK getrf), ship L/U + pivots to the device.

    Only the triangular solves run on the device (batched trsm); factoring
    on the host keeps the device LU's transient memory out of setup for
    coarse grids in the 10k-100k range and costs nothing in the solve path.
    """
    import scipy.linalg as sla

    n = A.shape[0]
    if n > 70000:
        raise ValueError(
            f"coarsest grid has {n} unknowns — too large for a replicated "
            "dense LU. Use more levels, or coarse_solve_type='GMRES' / a "
            "DD/Schur coarsest solver.")
    Ad = np.asarray(A.todense())
    if dtype is not None:
        Ad = Ad.astype(dtype)
    lu, piv = sla.lu_factor(Ad)
    return DenseLU(jnp.asarray(lu), jnp.asarray(piv))


def iterative_coarse_from_scipy(A: sp.spmatrix, omega, inner: int = 10,
                                dtype=None) -> IterativeCoarse:
    from ..ops.ell import ell_from_scipy
    d = np.asarray(omega / A.diagonal())
    if dtype is not None:
        d = d.astype(dtype)
    E = ell_from_scipy(A.tocsr(), dtype=dtype)
    return IterativeCoarse(jnp.asarray(d), E.indices, E.values, int(inner))
