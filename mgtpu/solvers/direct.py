"""Direct solver tier (the reference's ParallelJuliaSolver equivalent).

The reference factorises with UMFPACK and offers three triangular-solve
backends, the native one OpenMP-parallel over {factorizations x RHS}
(reference: src/ParallelJuliaSolver/parallelJuliaSolver.jl:48-238 +
deps/src/parLU.cpp).  Sparse triangular solves are sequential and hostile to
a wide device, so the device tier is:

 * `DirectSolver` — one system, factor once / solve many, A and A^H solves,
   all four value types, fac/solve counters:
     - backend "dense": on-device dense LU (jax.scipy.linalg.lu_factor) with
       batched RHS triangular solves — the idiomatic device form for the sizes a
       coarsest grid or subdomain reaches;
     - backend "host":  scipy splu on the host for matrices too large to
       densify, bridged into jit via pure_callback when needed.
 * `BatchedDenseLU` — many small systems factored and solved as one batched
   device program (vmapped LU): the device counterpart of the reference's
   OpenMP loop over num_LUs x num_rhs (parLU.cpp:122-190).  Used by the
   Schwarz subdomain tier.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["lu", "piv"], meta_fields=[])
@dataclass(frozen=True)
class _DenseFactor:
    lu: jax.Array
    piv: jax.Array


@jax.jit
def _dense_solve(f: _DenseFactor, b):
    return jsl.lu_solve((f.lu, f.piv), b)


@jax.jit
def _dense_solve_adj(f: _DenseFactor, b):
    return jsl.lu_solve((f.lu, f.piv), b, trans=2)


class DirectSolver:
    """Factor-once/solve-many direct solver with counters.

    API parity with the reference's AbstractSolver surface
    (setup/solve/clear/copy, nFac/facTime/nSolve/solveTime —
    parallelJuliaSolver.jl:48-60,89-105).
    """

    def __init__(self, backend: str = "dense", dtype=None,
                 dense_limit: int = 8192):
        if backend not in ("dense", "host"):
            raise ValueError("backend must be 'dense' or 'host'")
        self.backend = backend
        self.dtype = dtype
        self.dense_limit = dense_limit
        self.factor = None
        self.n_fac = 0
        self.fac_time = 0.0
        self.n_solve = 0
        self.solve_time = 0.0

    # -- lifecycle ---------------------------------------------------------
    def setup(self, A: sp.spmatrix) -> "DirectSolver":
        t0 = time.perf_counter()
        A = sp.csr_matrix(A)
        if self.dtype is not None:
            A = A.astype(self.dtype)
        if self.backend == "dense":
            if A.shape[0] > self.dense_limit:
                raise ValueError(
                    f"dense backend refuses n={A.shape[0]} > dense_limit="
                    f"{self.dense_limit}; use backend='host'")
            lu, piv = jsl.lu_factor(jnp.asarray(A.todense()))
            self.factor = _DenseFactor(lu, piv)
        else:
            self.factor = spla.splu(A.tocsc())
            self._A_conj = A.conj().tocsc()  # for adjoint solves
        self.n_fac += 1
        self.fac_time += time.perf_counter() - t0
        return self

    def clear(self) -> None:
        self.factor = None

    def copy(self) -> "DirectSolver":
        return DirectSolver(self.backend, self.dtype, self.dense_limit)

    @property
    def is_setup(self) -> bool:
        return self.factor is not None

    # -- solves ------------------------------------------------------------
    def solve(self, b, transpose: bool = False):
        """x with A x = b, or A^H x = b when transpose (reference doTranspose)."""
        t0 = time.perf_counter()
        if self.backend == "dense":
            b = jnp.asarray(b)
            if self.dtype is not None:
                b = b.astype(self.dtype)
            x = (_dense_solve_adj if transpose else _dense_solve)(self.factor, b)
        else:
            bh = np.asarray(b)
            if not transpose:
                x = self.factor.solve(bh)
            else:
                # A^H x = b  <=>  conj(A^T) x = b  <=>  A^T conj(x) = conj(b)
                x = np.conj(self.factor.solve(np.conj(bh), trans="T"))
        self.n_solve += 1
        self.solve_time += time.perf_counter() - t0
        return x

    def solve_linear_system(self, A, b, x=None, transpose: bool = False):
        """Lazy-setup solve (reference solveLinearSystem!,
        parallelJuliaSolver.jl:89-105)."""
        if not self.is_setup:
            self.setup(A)
        return self.solve(b, transpose)

    # -- coarse-solver protocol (plugs into the jitted MG cycle) -----------
    def setup_coarse(self, A: sp.spmatrix, mesh=None):
        if self.backend != "dense":
            raise ValueError("only the dense backend can run inside the "
                             "jitted cycle")
        self.setup(A)
        from ..cycle.coarse import DenseLU
        return DenseLU(self.factor.lu, self.factor.piv)


# ---------------------------------------------------------------------------
# batched small dense factorizations (Schwarz subdomains, Vanka-style tiers)
# ---------------------------------------------------------------------------

@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["lu", "piv"], meta_fields=[])
@dataclass(frozen=True)
class BatchedDenseLU:
    """LU of a batch of equally-sized dense systems, solved in one program."""
    lu: jax.Array    # (nb, k, k)
    piv: jax.Array   # (nb, k)

    def solve(self, B: jax.Array) -> jax.Array:
        """B: (nb, k, m) -> X: (nb, k, m)."""
        return _batched_solve(self.lu, self.piv, B)

    def solve_adjoint(self, B: jax.Array) -> jax.Array:
        return _batched_solve_adj(self.lu, self.piv, B)


@jax.jit
def _batched_factor(A: jax.Array):
    lu, piv = jax.vmap(jsl.lu_factor)(A)
    return lu, piv


@jax.jit
def _batched_solve(lu, piv, B):
    return jax.vmap(lambda l, p, b: jsl.lu_solve((l, p), b))(lu, piv, B)


@jax.jit
def _batched_solve_adj(lu, piv, B):
    return jax.vmap(lambda l, p, b: jsl.lu_solve((l, p), b, trans=2))(lu, piv, B)


def batched_dense_lu(blocks: np.ndarray) -> BatchedDenseLU:
    """Factor (nb, k, k) dense blocks on device."""
    lu, piv = _batched_factor(jnp.asarray(blocks))
    return BatchedDenseLU(lu, piv)
