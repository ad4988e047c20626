"""Hybrid (domain-decomposed) row Kaczmarz smoother (device apply, jittable).

Device equivalent of the reference's native hybrid Kaczmarz kernel
(reference: src/Multigrid/parRelax.jl:8-79 + deps/src/parRelax.h:7-43): the row
set is partitioned into lexicographic subdomains; domains are swept in
parallel, rows sequentially *within* each domain.  Damping is
omega / ||a_row||^2; the update direction is the conjugated row.

On the device the domain axis is the parallel axis: step i of the sequential loop
processes row i of every domain at once (one batched gather + scatter-add).
Cross-domain collisions on overlapping columns accumulate deterministically
via scatter-add (the reference's OpenMP kernel races benignly on the same
entries — SURVEY.md §5 race notes).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..config import HIGHEST
from ..models.mesh import RegularMesh
from ..ops.ell import ELL, ell_from_scipy
from ..dd import indices as dd_indices


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["arr", "mask", "invd", "ell_idx", "ell_val"],
                   meta_fields=["num_domains", "num_it", "omega"])
@dataclass(frozen=True)
class KaczmarzRelax:
    arr: jax.Array       # (max_len, ndomains) int32 row ids (0 where padded)
    mask: jax.Array      # (max_len, ndomains) of {0,1} in the value dtype
    invd: jax.Array      # (n,) omega / ||a_row||^2
    ell_idx: jax.Array   # (n, K) ELL columns of A
    ell_val: jax.Array   # (n, K) ELL values of A
    num_domains: tuple[int, ...]
    num_it: int
    omega: float


def setup_hybrid_kaczmarz(A: sp.spmatrix, mesh: RegularMesh, num_domains,
                          index_fn, omega: float, num_it: int,
                          dtype=None) -> KaczmarzRelax:
    """Build the Kaczmarz smoother state (reference parRelax.jl:39-47).

    index_fn is one of the dd.indices per-variable-layout index functions
    (nodal / cell-centered / faces +- pressure).
    """
    A = A.tocsr()
    dt = dtype if dtype is not None else A.dtype
    row_norms = np.asarray(A.multiply(A.conj()).sum(axis=1)).ravel().real
    invd = (omega / np.maximum(row_norms, 1e-300)).astype(
        np.zeros((), dt).real.dtype)
    arr = dd_indices.indices_of_cells_array(
        mesh, np.zeros(len(num_domains), dtype=np.int64),
        np.asarray(num_domains), index_fn)
    mask = (arr >= 0).astype(dt)
    arr = np.where(arr >= 0, arr, 0).astype(np.int32)
    E = ell_from_scipy(A, dtype=dt)
    return KaczmarzRelax(jnp.asarray(arr), jnp.asarray(mask), jnp.asarray(invd),
                         E.indices, E.values,
                         tuple(int(d) for d in num_domains), int(num_it),
                         float(omega))


def kaczmarz_sweep(x: jax.Array, b: jax.Array, kz: KaczmarzRelax,
                   num_it: int | None = None) -> jax.Array:
    """num_it hybrid Kaczmarz sweeps over all domains. x, b are (n, m)."""
    num_it = kz.num_it if num_it is None else num_it
    max_len, ndom = kz.arr.shape
    K = kz.ell_idx.shape[1]
    m = x.shape[1]

    def row_step(i, xc):
        rows = kz.arr[i]                          # (ndom,)
        msk = kz.mask[i]                          # (ndom,)
        ri = jnp.take(kz.ell_idx, rows, axis=0)   # (ndom, K)
        rv = jnp.take(kz.ell_val, rows, axis=0)
        xg = jnp.take(xc, ri.reshape(-1), axis=0).reshape(ndom, K, m)
        ax = jnp.einsum("dk,dkm->dm", rv, xg, precision=HIGHEST)
        inner = (jnp.take(b, rows, axis=0) - ax)
        inner = inner * (jnp.take(kz.invd, rows) * msk)[:, None]
        contrib = rv.conj()[:, :, None] * inner[:, None, :]   # (ndom, K, m)
        return xc.at[ri.reshape(-1)].add(contrib.reshape(ndom * K, m))

    for _ in range(num_it):
        x = jax.lax.fori_loop(0, max_len, row_step, x)
    return x


def make_kaczmarz_precond(kz: KaczmarzRelax):
    """Preconditioner closure: r -> num_it Kaczmarz sweeps on A x = r from 0.

    Equivalent of getHybridKaczmarzPrecond (reference parRelax.jl:49-59).
    """
    def prec(r):
        squeeze = r.ndim == 1
        rr = r[:, None] if squeeze else r
        x = kaczmarz_sweep(jnp.zeros_like(rr), rr, kz)
        return x[:, 0] if squeeze else x
    return prec
