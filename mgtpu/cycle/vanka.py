"""Cell-wise Vanka block smoothers (device apply, jittable).

Device equivalent of the reference's native Vanka tier (reference:
src/Multigrid/Vanka.jl:294-496 + deps/src/Vanka.c/h): cell-wise block
relaxation for staggered face(+pressure) systems, swept by 2^dim cell colors
(red-black family) so that updates within a color touch disjoint variables.

Instead of the reference's OpenMP loop over cells with per-cell CSR row walks,
all cells of one color are processed as a single batched tensor contraction:
block residuals are computed from pre-gathered ELL rows (one gather of x),
multiplied by the precomputed block inverses (batched small GEMMs),
and scattered back disjointly.  Variants (reference Vanka.jl:13-17):

 * "vanka"        — FULL_VANKA_RB: colored sweep; with scalar damping the
                    reference diagonalises the velocity block before inversion
                    (Vanka.jl:333-334); we reproduce that.
 * "econ-vanka"   — ECON_VANKA_RB: velocity diagonal scaled by 1/w.
 * "vanka-lex"    — lexicographic sequential sweep (fori_loop).
 * "vanka-add"    — additive, boundary-weighted, overlapping scatter-add.
 * "kaczmarz-vanka" — cell-wise block Kaczmarz: t = inv((A A^H)_cc) r_c,
                    x += A_c^H t (reference Vanka.h:185-259).

Block inverses are stored in single precision exactly like the reference
(`toSingle`, Vanka.jl:34-42,296) and promoted on use.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..config import HIGHEST


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["idx", "dinv", "rows_idx", "rows_val"],
                   meta_fields=["variant"])
@dataclass(frozen=True)
class VankaRelax:
    idx: jax.Array        # (ncolors, L, bs) int32 variable ids per cell (0-pad)
    dinv: jax.Array       # (ncolors, L, bs, bs) block inverses (0 on padding)
    rows_idx: jax.Array   # (ncolors, L, bs, K) ELL column ids of the block rows
    rows_val: jax.Array   # (ncolors, L, bs, K) ELL values of the block rows
    variant: str

    @property
    def ncolors(self) -> int:
        return self.idx.shape[0]


def _block_residual(x, b, idx_c, rows_idx_c, rows_val_c):
    """r_cell = b[idx] - A[idx, :] x for all cells of one color, batched.

    x: (n, m);  returns (L, bs, m).
    """
    L, bs, K = rows_idx_c.shape
    xg = jnp.take(x, rows_idx_c.reshape(-1), axis=0).reshape(L, bs, K, x.shape[1])
    ax = jnp.einsum("lbk,lbkm->lbm", rows_val_c, xg,
                    preferred_element_type=x.dtype, precision=HIGHEST)
    return jnp.take(b, idx_c.reshape(-1), axis=0).reshape(L, bs, x.shape[1]) - ax


def vanka_sweep(x, b, vr: VankaRelax, num_it: int):
    """num_it Vanka sweeps. x, b are (n, m)."""
    if vr.variant in ("vanka", "econ-vanka"):
        return _colored_sweep(x, b, vr, num_it)
    if vr.variant == "vanka-add":
        return _additive_sweep(x, b, vr, num_it)
    if vr.variant == "vanka-lex":
        return _lex_sweep(x, b, vr, num_it)
    if vr.variant == "kaczmarz-vanka":
        return _kaczmarz_cell_sweep(x, b, vr, num_it)
    raise ValueError(f"unknown Vanka variant {vr.variant}")


def _colored_sweep(x, b, vr, num_it):
    for _ in range(num_it):
        for c in range(vr.ncolors):
            r = _block_residual(x, b, vr.idx[c], vr.rows_idx[c], vr.rows_val[c])
            u = jnp.einsum("lij,ljm->lim", vr.dinv[c].astype(x.dtype), r,
                           precision=HIGHEST)
            x = x.at[vr.idx[c].reshape(-1)].add(u.reshape(-1, x.shape[1]))
    return x


def _additive_sweep(x, b, vr, num_it):
    # single color group holding ALL cells; overlapping face updates accumulate
    # (the additive variant weights interior faces by 1/2 at setup —
    # reference Vanka.jl:339-353)
    y = x
    for _ in range(num_it):
        r = _block_residual(y, b, vr.idx[0], vr.rows_idx[0], vr.rows_val[0])
        u = jnp.einsum("lij,ljm->lim", vr.dinv[0].astype(x.dtype), r,
                       precision=HIGHEST)
        x = x.at[vr.idx[0].reshape(-1)].add(u.reshape(-1, x.shape[1]))
    return x


def _lex_sweep(x, b, vr, num_it):
    idx, dinv = vr.idx[0], vr.dinv[0].astype(x.dtype)
    rows_idx, rows_val = vr.rows_idx[0], vr.rows_val[0]
    L = idx.shape[0]

    def cell_update(l, xc):
        ri = rows_idx[l]                      # (bs, K)
        rv = rows_val[l]
        xg = jnp.take(xc, ri.reshape(-1), axis=0).reshape(*ri.shape, xc.shape[1])
        ax = jnp.einsum("bk,bkm->bm", rv, xg, precision=HIGHEST)
        r = jnp.take(b, idx[l], axis=0) - ax
        u = jnp.matmul(dinv[l], r, precision=HIGHEST)
        return xc.at[idx[l]].add(u)

    for _ in range(num_it):
        x = jax.lax.fori_loop(0, L, cell_update, x)
    return x


def _kaczmarz_cell_sweep(x, b, vr, num_it):
    # block Kaczmarz: correction lives in row space: x += A_c^H (D r_c)
    for _ in range(num_it):
        for c in range(vr.ncolors):
            r = _block_residual(x, b, vr.idx[c], vr.rows_idx[c], vr.rows_val[c])
            t = jnp.einsum("lij,ljm->lim", vr.dinv[c].astype(x.dtype), r,
                           precision=HIGHEST)
            contrib = jnp.einsum("lbk,lbm->lbkm", vr.rows_val[c].conj(), t,
                                 precision=HIGHEST)
            L, bs, K = vr.rows_idx[c].shape
            x = x.at[vr.rows_idx[c].reshape(-1)].add(
                contrib.reshape(L * bs * K, x.shape[1]))
    return x
