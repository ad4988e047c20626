"""Cross-grid stencils: structured operators between different node grids.

Face-staggered systems (elasticity, Stokes) couple fields living on DIFFERENT
grids — face-j velocity grids and the cell-centered pressure grid.  Each block
A[ci, cj] of such an operator is still a stencil: the entry at output node r
(on ci's grid) reads input nodes r + d (on cj's grid) for a small static set
of per-axis shifts d.  Stored grid-form, the block SpMV is the same
shift-multiply-accumulate as the square GridStencil — zero gathers,
unit-stride reads — just with different input/output extents.

Decomposition is done on COORDINATES (row/col unraveled per axis), not flat
offsets, so there is no wrap-around aliasing to guard against.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["coeff"],
                   meta_fields=["offsets", "out_grid", "in_grid"])
@dataclass(frozen=True)
class CrossGridStencil:
    """coeff[k, *r] = A[flat(r), flat(r + offsets[k])] on the output grid.

    Grid axis order: slowest mesh dim first (grid view of a dim-0-fastest
    flat vector).  Entries that would read outside the input grid do not
    exist in A, so their coefficients are zero and the zero-padded window
    reads are exact.
    """
    coeff: jax.Array                       # (ndiags, *out_grid)
    offsets: tuple[tuple[int, ...], ...]   # per diag, per grid axis
    out_grid: tuple[int, ...]
    in_grid: tuple[int, ...]

    @property
    def dtype(self):
        return self.coeff.dtype

    @property
    def shape(self) -> tuple[int, int]:
        return (int(np.prod(self.out_grid)), int(np.prod(self.in_grid)))

    @property
    def nnz(self) -> int:
        return int(self.coeff.size)

    def matvec(self, x: jax.Array) -> jax.Array:
        """x: (..., *in_grid) -> (..., *out_grid)."""
        return cross_stencil_matvec(self.coeff, self.offsets,
                                    self.in_grid, x)

    def to_scipy(self) -> sp.csr_matrix:
        no, ni = self.shape
        g = len(self.out_grid)
        strides_in = np.ones(g, dtype=np.int64)
        for a in range(g - 2, -1, -1):
            strides_in[a] = strides_in[a + 1] * self.in_grid[a + 1]
        coeff = np.asarray(self.coeff).reshape(len(self.offsets), no)
        rows, cols, vals = [], [], []
        idx = np.arange(no)
        coords = np.stack(np.unravel_index(idx, self.out_grid), axis=1)
        for k, off in enumerate(self.offsets):
            tgt = coords + np.asarray(off)
            ok = np.all((tgt >= 0) & (tgt < np.asarray(self.in_grid)), axis=1)
            rows.append(idx[ok])
            cols.append((tgt[ok] * strides_in).sum(axis=1))
            vals.append(coeff[k, ok])
        A = sp.coo_matrix((np.concatenate(vals),
                           (np.concatenate(rows), np.concatenate(cols))),
                          shape=(no, ni))
        A.sum_duplicates()
        return A.tocsr()

    def astype(self, dtype) -> "CrossGridStencil":
        return CrossGridStencil(self.coeff.astype(dtype), self.offsets,
                                self.out_grid, self.in_grid)


def cross_stencil_from_csr(A: sp.spmatrix, out_nodes, in_nodes,
                           dtype=None, max_shift: int = 2,
                           device: bool = True) -> CrossGridStencil:
    """Extract the cross-grid stencil of a block operator.

    out_nodes/in_nodes: per-mesh-dim extents, dim 0 fastest.  Raises
    ValueError when any entry's per-axis shift exceeds max_shift.
    device=False keeps the coefficients as numpy (host-side splitting, e.g.
    the df32 double-single construction).
    """
    out_nodes = [int(v) for v in np.asarray(out_nodes).ravel()]
    in_nodes = [int(v) for v in np.asarray(in_nodes).ravel()]
    no, ni = int(np.prod(out_nodes)), int(np.prod(in_nodes))
    if A.shape != (no, ni):
        raise ValueError("block size does not match the node grids")
    out_grid = tuple(reversed(out_nodes))
    in_grid = tuple(reversed(in_nodes))

    Ac = A.tocoo()
    rc = np.stack(np.unravel_index(Ac.row, out_grid), axis=1)
    cc = np.stack(np.unravel_index(Ac.col, in_grid), axis=1)
    d = cc - rc
    if d.size and int(np.abs(d).max()) > max_shift:
        raise ValueError("block entry shift exceeds the stencil radius")
    offs, pos = np.unique(d, axis=0, return_inverse=True) if d.size else (
        np.zeros((0, len(out_grid)), dtype=np.int64), np.zeros(0, np.int64))
    dt = dtype if dtype is not None else Ac.dtype
    coeff = np.zeros((max(len(offs), 1), no), dtype=dt)
    np.add.at(coeff, (pos, Ac.row), Ac.data.astype(dt))
    offsets = (tuple(tuple(int(v) for v in o) for o in offs)
               if len(offs) else ((0,) * len(out_grid),))
    cg = coeff.reshape((-1,) + out_grid)
    return CrossGridStencil(jnp.asarray(cg) if device else cg,
                            offsets, out_grid, in_grid)


@functools.partial(jax.jit, static_argnames=("offsets", "in_grid"))
def cross_stencil_matvec(coeff, offsets, in_grid, x):
    """y = A x; x (..., *in_grid) -> (..., *out_grid)."""
    g = coeff.ndim - 1
    out_grid = coeff.shape[1:]
    nb = x.ndim - g
    lo = [max(0, -min(off[a] for off in offsets)) for a in range(g)]
    hi = [max(0, max(off[a] + out_grid[a] - in_grid[a] for off in offsets))
          for a in range(g)]
    pad = [(0, 0)] * nb + [(lo[a], hi[a]) for a in range(g)]
    xp = jnp.pad(x, pad)
    y = jnp.zeros(x.shape[:nb] + out_grid, dtype=jnp.result_type(coeff, x))
    for k, off in enumerate(offsets):
        st = [0] * nb + [lo[a] + off[a] for a in range(g)]
        sz = list(x.shape[:nb]) + list(out_grid)
        y = y + coeff[k] * jax.lax.dynamic_slice(xp, st, sz)
    return y
