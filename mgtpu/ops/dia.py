"""DIA (offset-diagonal / stencil) sparse matrix — the structured fast path.

Operators from tensor-product discretizations on regular meshes (and all their
Galerkin full-weighting coarsenings) are banded with a small static set of
offsets: 9 diagonals in 2D, 27 in 3D.  Storing them diagonal-wise turns SpMV
into shift-multiply-accumulate — elementwise work with unit-stride memory
access and zero gathers (vs. the reference's
row-gather CSR SpMV, src/Multigrid/SpMatMul.jl:4-26).

Layout: ``data[d, i] = A[i, i + offsets[d]]`` (zero where out of range).
Offsets are static metadata so the SpMV unrolls into ``ndiags`` fused slices.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["data"],
                   meta_fields=["offsets", "shape"])
@dataclass(frozen=True)
class DIA:
    data: jax.Array              # (ndiags, n)
    offsets: tuple[int, ...]     # static
    shape: tuple[int, int]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0] * self.data.shape[1])

    def matvec(self, x: jax.Array) -> jax.Array:
        return dia_matvec(self.data, self.offsets, x)

    def to_scipy(self) -> sp.csr_matrix:
        n = self.shape[0]
        data = np.asarray(self.data)
        rows, cols, vals = [], [], []
        for d, off in enumerate(self.offsets):
            i = np.arange(max(0, -off), min(n, n - off))
            rows.append(i)
            cols.append(i + off)
            vals.append(data[d, i])
        A = sp.coo_matrix((np.concatenate(vals),
                           (np.concatenate(rows), np.concatenate(cols))),
                          shape=self.shape)
        return A.tocsr()

    def astype(self, dtype) -> "DIA":
        return DIA(self.data.astype(dtype), self.offsets, self.shape)


def dia_from_scipy(A: sp.spmatrix, dtype=None, max_diags: int = 64) -> DIA | None:
    """Convert to DIA if the matrix is square and has few occupied diagonals.

    Returns None when the matrix is not profitably banded (callers fall back
    to ELL).
    """
    if A.shape[0] != A.shape[1]:
        return None
    Ad = A.tocoo()
    offs = np.unique(Ad.col.astype(np.int64) - Ad.row.astype(np.int64))
    if len(offs) > max_diags:
        return None
    n = A.shape[0]
    dt = dtype if dtype is not None else A.dtype
    data = np.zeros((len(offs), n), dtype=dt)
    pos = np.searchsorted(offs, Ad.col.astype(np.int64) - Ad.row.astype(np.int64))
    np.add.at(data, (pos, Ad.row), Ad.data.astype(dt))
    return DIA(jnp.asarray(data), tuple(int(o) for o in offs),
               (int(n), int(n)))


@functools.partial(jax.jit, static_argnames=("offsets",))
def dia_matvec(data: jax.Array, offsets: tuple[int, ...], x: jax.Array) -> jax.Array:
    """y = A @ x via shift-and-accumulate over the static diagonal set."""
    n = data.shape[1]
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    xp = jnp.pad(x, ((lo, hi), (0, 0)))
    y = jnp.zeros((n, x.shape[1]), dtype=data.dtype)
    for d, off in enumerate(offsets):
        xs = jax.lax.dynamic_slice_in_dim(xp, lo + off, n, axis=0)
        y = y + data[d][:, None] * xs
    return y[:, 0] if squeeze else y
