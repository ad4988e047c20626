"""ELL (padded fixed-width row) sparse matrix — the universal device format.

Device replacement for the reference's CSC-transposed storage + OpenMP
adjoint SpMV (reference: src/Multigrid/SpMatMul.jl:4-26 backed by ParSpMatVec's
C kernel).  The reference stores A transposed in CSC — i.e. CSR of A — and
row-parallelises the product; the device analog is a row-padded (ELL) layout
with static shapes so XLA can vectorise the gather+reduce, and multiple
right-hand sides batched in a trailing dimension (SpMM), mirroring the
reference's first-class multi-RHS design (MGdef.jl:163-176).

Padding entries use column 0 with value 0 (always safe).  Row width is padded
to a multiple of ``pad_k`` for layout friendliness.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..config import HIGHEST


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["indices", "values"],
                   meta_fields=["shape"])
@dataclass(frozen=True)
class ELL:
    indices: jax.Array        # (n_rows, K) int32
    values: jax.Array         # (n_rows, K) dtype
    shape: tuple[int, int]

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nnz(self) -> int:
        # padded size; true nnz tracked on host at setup time
        return int(self.indices.shape[0] * self.indices.shape[1])

    def matvec(self, x: jax.Array) -> jax.Array:
        return ell_matvec(self.indices, self.values, x)

    def to_scipy(self) -> sp.csr_matrix:
        n, k = self.indices.shape
        rows = np.repeat(np.arange(n), k)
        cols = np.asarray(self.indices).ravel()
        vals = np.asarray(self.values).ravel()
        A = sp.coo_matrix((vals, (rows, cols)), shape=self.shape)
        A.sum_duplicates()
        return A.tocsr()

    def astype(self, dtype) -> "ELL":
        return ELL(self.indices, self.values.astype(dtype), self.shape)


def ell_arrays_from_scipy(A: sp.spmatrix, dtype=None, pad_k: int = 4):
    """HOST ELL layout (numpy idx/val, shape) from a scipy sparse matrix.

    Kept in numpy so callers that need true f64 values (ops/df32.py hi/lo
    splitting) are not truncated by jnp.asarray under jax_enable_x64=False
    (JAX's default)."""
    A = A.tocsr()
    A.sum_duplicates()
    n, m = A.shape
    counts = np.diff(A.indptr)
    kmax = int(counts.max()) if n > 0 else 0
    K = max(pad_k, int(-(-kmax // pad_k) * pad_k))
    idx = np.zeros((n, K), dtype=np.int32)
    val = np.zeros((n, K), dtype=dtype if dtype is not None else A.dtype)
    # vectorised fill: position of each nnz within its row
    within = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    rows = np.repeat(np.arange(n), counts)
    idx[rows, within] = A.indices
    val[rows, within] = A.data.astype(val.dtype)
    return idx, val, (int(n), int(m))


def ell_from_scipy(A: sp.spmatrix, dtype=None, pad_k: int = 4) -> ELL:
    """Build an ELL device matrix from a scipy sparse matrix."""
    idx, val, shape = ell_arrays_from_scipy(A, dtype, pad_k)
    return ELL(jnp.asarray(idx), jnp.asarray(val), shape)


@jax.jit
def ell_matvec(indices: jax.Array, values: jax.Array, x: jax.Array) -> jax.Array:
    """y = A @ x for ELL A; x is (n_cols,) or (n_cols, m)."""
    n, K = indices.shape
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    xg = jnp.take(x, indices.reshape(-1), axis=0).reshape(n, K, x.shape[1])
    y = jnp.einsum("nk,nkm->nm", values, xg,
                   preferred_element_type=values.dtype, precision=HIGHEST)
    return y[:, 0] if squeeze else y


def ell_rows(indices: jax.Array, values: jax.Array, rows: jax.Array):
    """Gather (idx, val) of a set of rows — used by block smoothers."""
    return jnp.take(indices, rows, axis=0), jnp.take(values, rows, axis=0)
