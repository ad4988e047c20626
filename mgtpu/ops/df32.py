"""Double-single (two-float32) compensated residuals for refinement.

The mixed-precision refinement driver (solvers/mg_solver.solve_mg_refined,
mirroring the reference's shim at SolveFuncs.jl:52-58) only needs ONE
high-precision operation per iteration — the fine residual r = b - A x —
so this module provides it in double-single arithmetic, with no need for jax
x64 or a float64 copy of the operator: every high-precision
number is an (hi, lo) pair of f32 with value hi + lo (~49-bit mantissa,
|lo| <= ulp(hi)/2), computed with error-free transformations:

 * two_sum   (Knuth): exact a + b = s + e with 6 f32 flops, branch-free
 * split/two_prod (Dekker): exact a * b = p + e without FMA

The residual runs entirely on native f32 ops (~2-3x one f32 SpMV) and
carries ~1e-13 relative accuracy — far below the 1e-8 target even for
kappa ~ 1e4 operators.  Operator coefficients come from the ORIGINAL f64
matrix, split once at setup into (hi, lo) pairs over the constant-interior
stencil structure (ops/grid_stencil.ConstGridStencil), so refinement
converges to the true operator's solution, not its f32 rounding.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

__all__ = ["two_sum", "two_prod", "DFConstStencil", "df_const_from_csr",
           "df_residual", "df_accumulate",
           "DFGridStencil", "df_dense_from_csr", "df_residual_dense",
           "DFBlockOperator", "df_block_from_csr", "df_residual_block",
           "df_residual_any", "df_accumulate_tree"]


# NOTE on compiler safety: the transforms below need every product and sum
# rounded as written — no algebraic rewrite of (a + b) - a -> b, and no FMA
# contraction that skips the rounding of p = a*b.  As compiled by XLA:GPU
# on an H100 they stay exact: two_prod, two_sum and two_sum(s, -p) match
# float64 on 4M random pairs, and the 257^3 residual matches the host f64
# residual to 7.5e-15 ||b|| (chip_smoke.py re-checks the residual on every
# run).  If a toolchain breaks this, wrap the split and the product in
# jax.lax.optimization_barrier.


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly (Knuth, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


_SPLIT = np.float32(4097.0)        # 2**12 + 1 for f32 (24-bit mantissa)


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker, no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_accumulate(x_hi, x_lo, z):
    """(x_hi + x_lo) + z in double-single; z is a plain f32 correction."""
    s, e = two_sum(x_hi, z)
    lo = x_lo + e
    # renormalize so |lo| stays at ulp(hi) level
    hi, e2 = two_sum(s, lo)
    return hi, e2


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["const_hi", "const_lo", "strips_hi",
                                "strips_lo"],
                   meta_fields=["offsets", "grid", "boxes"])
@dataclass(frozen=True)
class DFConstStencil:
    """Constant-interior stencil with double-single (hi, lo) coefficients."""
    const_hi: jax.Array
    const_lo: jax.Array
    strips_hi: tuple
    strips_lo: tuple
    offsets: tuple
    grid: tuple
    boxes: tuple


def df_const_from_csr(A: sp.spmatrix, node_counts) -> DFConstStencil:
    """Split an f64 operator into df32 constant-interior stencil form.

    Raises ValueError when A is not a constant-interior grid stencil
    (callers fall back to the emulated-f64 path).
    """
    from .grid_stencil import grid_stencil_from_csr, compress_grid_stencil
    gs = grid_stencil_from_csr(A.astype(np.float64), node_counts,
                               dtype=np.float64, device=False)
    cs = compress_grid_stencil(gs, device=False)   # keep true f64 on host
    if cs is None:
        raise ValueError("operator is not constant-interior")

    def pair(a):
        a = np.asarray(a, np.float64)
        hi = a.astype(np.float32)
        lo = (a - hi.astype(np.float64)).astype(np.float32)
        return jnp.asarray(hi), jnp.asarray(lo)

    c_hi, c_lo = pair(cs.const)
    s_hi, s_lo = zip(*(pair(s) for s in cs.strips)) if cs.strips else ((), ())
    return DFConstStencil(c_hi, c_lo, tuple(s_hi), tuple(s_lo),
                          cs.offsets, cs.grid, cs.boxes)


@functools.partial(jax.jit, static_argnames=())
def df_residual(dfA: DFConstStencil, b_hi, b_lo, x_hi, x_lo):
    """r = b - A (x_hi + x_lo) in double-single; fields (.., *grid).

    Same disjoint-region assembly as the f32 const-stencil matvec (two
    boundary slabs per axis + constant interior), with a compensated
    accumulation per region: head products are error-free (two_prod /
    two_sum) and cross terms c_hi*x_lo + c_lo*x_hi ride in the low word.
    """
    offsets, grid, boxes = dfA.offsets, dfA.grid, dfA.boxes
    g = len(grid)
    nb = x_hi.ndim - g
    lo_pad = [max(0, -min(off[a] for off in offsets)) for a in range(g)]
    hi_pad = [max(0, max(off[a] for off in offsets)) for a in range(g)]
    pad = [(0, 0)] * nb + [(lo_pad[a], hi_pad[a]) for a in range(g)]
    xhp = jnp.pad(x_hi, pad)
    xlp = jnp.pad(x_lo, pad)

    def region(start, size, c_hi, c_lo):
        sl = tuple([slice(None)] * nb +
                   [slice(s, s + z) for s, z in zip(start, size)])
        s = b_hi[sl]
        e = b_lo[sl]
        for k, off in enumerate(offsets):
            st = [0] * nb + [lo_pad[a] + start[a] + off[a] for a in range(g)]
            sz = list(x_hi.shape[:nb]) + list(size)
            xs_hi = jax.lax.dynamic_slice(xhp, st, sz)
            xs_lo = jax.lax.dynamic_slice(xlp, st, sz)
            ch, cl = c_hi[k], c_lo[k]
            p, pe = two_prod(ch, xs_hi)
            cross = ch * xs_lo + cl * xs_hi + pe
            s, e2 = two_sum(s, -p)
            e = e + (e2 - cross)
        hi, lo = two_sum(s, e)
        return hi, lo

    def assemble(a, start, size):
        if a == g:
            return region(start, size, dfA.const_hi, dfA.const_lo)
        (lo_s, lo_z) = boxes[2 * a]
        (hi_s, hi_z) = boxes[2 * a + 1]
        w = lo_z[a]
        mid_start, mid_size = list(start), list(size)
        mid_start[a] = start[a] + w
        mid_size[a] = size[a] - 2 * w
        mid = assemble(a + 1, mid_start, mid_size)
        low = region(lo_s, lo_z, dfA.strips_hi[2 * a],
                     dfA.strips_lo[2 * a])
        high = region(hi_s, hi_z, dfA.strips_hi[2 * a + 1],
                      dfA.strips_lo[2 * a + 1])
        ax = nb + a
        return (jnp.concatenate([low[0], mid[0], high[0]], axis=ax),
                jnp.concatenate([low[1], mid[1], high[1]], axis=ax))

    return assemble(0, [0] * g, list(grid))


# ---------------------------------------------------------------------------
# dense (variable-coefficient) and block (systems) double-single residuals
# ---------------------------------------------------------------------------

def _split_pair(a):
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["coeff_hi", "coeff_lo"],
                   meta_fields=["offsets", "grid"])
@dataclass(frozen=True)
class DFGridStencil:
    """Dense variable-coefficient stencil with double-single coefficients.

    Covers operators whose coefficients vary in the interior (no
    constant-interior compression): coeff_[hi|lo] are (ndiags, *grid), and
    the compensated residual is one shifted multiply-add chain — it also
    shards like any cycle stencil (parallel/sharded_solve.py builds its
    padded embedding from this form)."""
    coeff_hi: jax.Array
    coeff_lo: jax.Array
    offsets: tuple
    grid: tuple


def df_dense_from_csr(A, node_counts, pad_grid=None) -> DFGridStencil:
    """Split an f64 operator into dense df32 stencil form (host-side),
    optionally zero-padded to `pad_grid` for the sharded embedding."""
    from .grid_stencil import grid_stencil_from_csr
    gs = grid_stencil_from_csr(A, node_counts, dtype=np.float64, device=False)
    coeff = np.asarray(gs.coeff, np.float64)
    grid = gs.grid
    if pad_grid is not None:
        pad = [(0, 0)] + [(0, p - g) for p, g in zip(pad_grid, grid)]
        coeff = np.pad(coeff, pad)
        grid = tuple(pad_grid)
    hi, lo = _split_pair(coeff)
    return DFGridStencil(hi, lo, gs.offsets, grid)


def df_residual_dense(dfA: DFGridStencil, b_hi, b_lo, x_hi, x_lo):
    """r = b - A (x_hi + x_lo) in double-single on (.., *grid) fields.

    Same compensated accumulation as df_residual (error-free head products,
    cross terms in the low word) but over the dense stencil."""
    from .grid_stencil import _shift
    g = len(dfA.grid)
    s, e = b_hi, b_lo
    for k, off in enumerate(dfA.offsets):
        xs_hi, xs_lo = x_hi, x_lo
        for a, da in enumerate(off):
            if da:
                ax_h = xs_hi.ndim - g + a
                xs_hi = _shift(xs_hi, ax_h, da, dfA.grid[a])
                xs_lo = _shift(xs_lo, ax_h, da, dfA.grid[a])
        ch, cl = dfA.coeff_hi[k], dfA.coeff_lo[k]
        p, pe = two_prod(ch, xs_hi)
        cross = ch * xs_lo + cl * xs_hi + pe
        s, e2 = two_sum(s, -p)
        e = e + (e2 - cross)
    return two_sum(s, e)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["coeff_hi", "coeff_lo"],
                   meta_fields=["pairs", "offsets", "out_grids", "in_grids"])
@dataclass(frozen=True)
class DFBlockOperator:
    """Face-staggered block operator with double-single coefficients.

    Per stored block (ci, cj): coeff_[hi|lo][b] is (ndiags_b, *out_grid_b)
    in the cross-grid stencil layout (ops/cross_stencil.py).  Fields are
    tuples of per-component (m, *grid_c) arrays — the systems engine's block
    fields — so mixed elasticity certifies TRUE 1e-8 residuals from an f32
    hierarchy without jax x64."""
    coeff_hi: tuple
    coeff_lo: tuple
    pairs: tuple
    offsets: tuple        # per block: tuple of per-axis shifts
    out_grids: tuple
    in_grids: tuple


def df_block_from_csr(A, n_cells, with_pressure: bool) -> DFBlockOperator:
    """Split an f64 staggered operator into df32 block stencil form."""
    from .cross_stencil import cross_stencil_from_csr
    from ..cycle.systems_grid import face_component_grids
    import scipy.sparse as ssp
    n = [int(v) for v in np.asarray(n_cells).ravel()]
    dim = len(n)
    grids, offs = face_component_grids(n, with_pressure)
    A = ssp.csr_matrix(A).astype(np.float64)
    if A.shape[0] != offs[-1]:
        raise ValueError("operator size does not match the staggered layout")
    nodes = []
    for j in range(dim):
        s = list(n)
        s[j] += 1
        nodes.append(s)
    if with_pressure:
        nodes.append(list(n))
    pairs, c_hi, c_lo, offsets, ogs, igs = [], [], [], [], [], []
    for ci in range(len(grids)):
        Ai = A[offs[ci]:offs[ci + 1]].tocsc()
        for cj in range(len(grids)):
            blk = Ai[:, offs[cj]:offs[cj + 1]].tocsr()
            if blk.nnz == 0:
                continue
            S = cross_stencil_from_csr(blk, nodes[ci], nodes[cj],
                                       dtype=np.float64, device=False)
            hi, lo = _split_pair(S.coeff)
            pairs.append((ci, cj))
            c_hi.append(hi)
            c_lo.append(lo)
            offsets.append(S.offsets)
            ogs.append(S.out_grid)
            igs.append(S.in_grid)
    return DFBlockOperator(tuple(c_hi), tuple(c_lo), tuple(pairs),
                           tuple(offsets), tuple(ogs), tuple(igs))


def df_residual_block(dfB: DFBlockOperator, b_hi, b_lo, x_hi, x_lo):
    """r = b - A (x_hi + x_lo) on block fields (tuples of (m, *grid_c))."""
    s = list(b_hi)
    e = list(b_lo)
    for i, (ci, cj) in enumerate(dfB.pairs):
        offsets = dfB.offsets[i]
        out_grid, in_grid = dfB.out_grids[i], dfB.in_grids[i]
        xh, xl = x_hi[cj], x_lo[cj]
        g = len(out_grid)
        nb = xh.ndim - g
        lo = [max(0, -min(off[a] for off in offsets)) for a in range(g)]
        hi = [max(0, max(off[a] + out_grid[a] - in_grid[a]
                         for off in offsets)) for a in range(g)]
        pad = [(0, 0)] * nb + [(lo[a], hi[a]) for a in range(g)]
        xhp = jnp.pad(xh, pad)
        xlp = jnp.pad(xl, pad)
        for k, off in enumerate(offsets):
            st = [0] * nb + [lo[a] + off[a] for a in range(g)]
            sz = list(xh.shape[:nb]) + list(out_grid)
            xs_hi = jax.lax.dynamic_slice(xhp, st, sz)
            xs_lo = jax.lax.dynamic_slice(xlp, st, sz)
            ch, cl = dfB.coeff_hi[i][k], dfB.coeff_lo[i][k]
            p, pe = two_prod(ch, xs_hi)
            cross = ch * xs_lo + cl * xs_hi + pe
            s[ci], e2 = two_sum(s[ci], -p)
            e[ci] = e[ci] + (e2 - cross)
    out = [two_sum(sc, ec) for sc, ec in zip(s, e)]
    return tuple(h for h, _ in out), tuple(l for _, l in out)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["indices", "values_hi", "values_lo"],
                   meta_fields=["shape"])
@dataclass(frozen=True)
class DFEll:
    """ELL operator with double-single (hi, lo) values — the df32 form for
    UNSTRUCTURED (AMG) operators, where no grid/stencil layout exists.
    Row-shardable: gathers read the replicated operand, every other op is
    row-local (parallel/sharded_amg.py)."""
    indices: jax.Array       # (n, K) int32 (padding: index 0 / value 0)
    values_hi: jax.Array     # (n, K) f32
    values_lo: jax.Array     # (n, K) f32
    shape: tuple


def df_ell_from_csr(A: sp.spmatrix) -> DFEll:
    """Split an f64 CSR operator into df32 ELL form.

    The hi/lo split happens in NUMPY before any device transfer: with
    jax_enable_x64=False (JAX's default) a jnp.asarray of the
    f64 values would silently truncate to f32 and leave values_lo == 0,
    voiding the compensated-residual certification."""
    from .ell import ell_arrays_from_scipy
    A = sp.csr_matrix(A)
    idx, v64, shape = ell_arrays_from_scipy(A, dtype=np.float64)
    v_hi = v64.astype(np.float32)
    v_lo = (v64 - v_hi.astype(np.float64)).astype(np.float32)
    return DFEll(jnp.asarray(idx), jnp.asarray(v_hi), jnp.asarray(v_lo),
                 tuple(shape))


def df_residual_ell(dfA: DFEll, b_hi, b_lo, x_hi, x_lo):
    """r = b - A (x_hi + x_lo) in double-single; vectors are (n, m).

    Compensated accumulation over the K ELL slots (statically unrolled —
    K is the padded row width, <= a few tens for AMG levels)."""
    idx = dfA.indices
    n, K = idx.shape
    s, e = b_hi, b_lo
    for k in range(K):
        j = idx[:, k]                      # padding is index 0 / value 0
        xs_hi, xs_lo = jnp.take(x_hi, j, axis=0), jnp.take(x_lo, j, axis=0)
        ch = dfA.values_hi[:, k:k + 1]
        cl = dfA.values_lo[:, k:k + 1]
        p, pe = two_prod(ch, xs_hi)
        cross = ch * xs_lo + cl * xs_hi + pe
        s, e2 = two_sum(s, -p)
        e = e + (e2 - cross)
    return two_sum(s, e)


def df_residual_any(op, b_hi, b_lo, x_hi, x_lo):
    """Dispatch over the df32 operator forms."""
    if isinstance(op, DFConstStencil):
        return df_residual(op, b_hi, b_lo, x_hi, x_lo)
    if isinstance(op, DFGridStencil):
        return df_residual_dense(op, b_hi, b_lo, x_hi, x_lo)
    if isinstance(op, DFEll):
        return df_residual_ell(op, b_hi, b_lo, x_hi, x_lo)
    return df_residual_block(op, b_hi, b_lo, x_hi, x_lo)


def df_accumulate_tree(x_hi, x_lo, z):
    """df_accumulate over arrays or tuples of component fields."""
    if isinstance(x_hi, tuple):
        out = [df_accumulate(h, l, zz) for h, l, zz in zip(x_hi, x_lo, z)]
        return tuple(h for h, _ in out), tuple(l for _, l in out)
    return df_accumulate(x_hi, x_lo, z)
