"""Multi-chip solve drivers for UNSTRUCTURED (flat ELL/DIA) hierarchies —
the sharded tier for SA-AMG / classical-AMG operators.

The reference's distributed tier handles ANY sparse operator by extracting
row blocks per worker (reference src/DomainDecomposition/DDParallel.jl:5-66).
The device-mesh equivalent is GSPMD row partitioning: every level's ELL
rows (indices + values), the transfer rows, and the smoother diagonals are
sharded over a 1D `jax.sharding.Mesh` axis, while the iterate vectors stay
REPLICATED.  Each ELL matvec then gathers only from a replicated operand
(row-local compute, zero communication) and the single collective per level
application is the all-gather XLA inserts to re-replicate the row-sharded
result — the standard 1D-partition SpMV pattern.  Norm reductions lower to
local sums (replicated operands), so a whole V-cycle costs one all-gather
per operator application over the interconnect.

The cycle itself is the SAME `recursive_cycle` the single-chip flat engine
runs — sharding annotations change the partitioning, not the math — so
iterates match the single-chip solver bitwise-modulo-reduction-order and
iteration counts are identical (pinned by tests/test_sharded_amg.py).

Drivers: `ShardedAMGSolver.cycle` (one V/W/F/K cycle), `.solve_refined`
(df32-certified refinement to true f64 tolerance in ONE device program),
`.solve_fgmres` (MG-preconditioned flexible GMRES).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..cycle.cycle import recursive_cycle
from ..cycle.coarse import DenseLU, IterativeCoarse
from ..cycle.relax import DiagRelax, ChebyshevRelax
from ..ops.ell import ELL
from ..ops.dia import DIA
from ..ops.df32 import DFEll, df_ell_from_csr, df_residual_ell, df_accumulate
from ..setup.hierarchy import Hierarchy, Level

__all__ = ["ShardedAMGSolver", "shard_flat_hierarchy"]


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["inner"], meta_fields=["nc"])
class _PaddedCoarse:
    """Replicated coarsest solve on row-padded vectors: slice the true nc
    rows, solve, zero-pad back (pad rows are identically zero throughout
    the padded cycle)."""
    def __init__(self, inner, nc):
        self.inner = inner
        self.nc = nc

    def solve(self, b):
        x = self.inner.solve(b[:self.nc])
        return jnp.pad(x, ((0, b.shape[0] - self.nc), (0, 0)))


def _pad_rows(a, np_rows):
    return jnp.pad(a, ((0, np_rows - a.shape[0]),) + ((0, 0),) * (a.ndim - 1))


def shard_flat_hierarchy(hier: Hierarchy, mesh: Mesh,
                         axis: str = "x") -> Hierarchy:
    """Re-place a flat hierarchy with row-sharded, row-padded operators.

    Every level's row count pads up to a multiple of the mesh axis (GSPMD
    needs divisible shardings; padded ELL rows are index-0/value-0 no-ops
    and padded vector rows stay identically zero through relaxation,
    residual, transfers, and coarse correction).  DIA levels convert to
    ELL — the general gather form is the distribution-friendly layout; a
    banded sharded path is a possible later optimisation.  Pointwise
    smoother diagonals shard with their rows; the coarsest solver stays
    replicated behind a slice/pad adapter.
    """
    ndev = mesh.shape[axis]
    rows = NamedSharding(mesh, P(axis, None))
    vec = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    pad_n = lambda n: -(-n // ndev) * ndev

    def put(x, s):
        return jax.device_put(x, s)

    def shard_op(op):
        if op is None:
            return None
        if isinstance(op, DIA):
            from ..ops.ell import ell_from_scipy
            op = ell_from_scipy(op.to_scipy(), dtype=op.dtype)
        if isinstance(op, ELL):
            np_r = pad_n(op.indices.shape[0])
            # shape meta reports PADDED extents: the cycle engine sizes its
            # coarse zero vectors from R.shape[0] and every vector in the
            # padded cycle carries the padded row count
            return ELL(put(_pad_rows(op.indices, np_r), rows),
                       put(_pad_rows(op.values, np_r), rows),
                       (np_r, pad_n(op.shape[1])))
        raise ValueError(f"cannot shard operator type {type(op).__name__}")

    def shard_relax(rx, np_r):
        if rx is None:
            return None
        if isinstance(rx, DiagRelax):
            return DiagRelax(put(_pad_rows(rx.d, np_r), vec))
        if isinstance(rx, ChebyshevRelax):
            return ChebyshevRelax(put(_pad_rows(rx.d, np_r), vec),
                                  rx.lam_max)
        raise ValueError(
            f"sharded AMG supports pointwise relaxations only, got "
            f"{type(rx).__name__} (same restriction as the reference's "
            "SA-AMG, SA-AMG.jl:27-31)")

    def shard_coarse(c, nc):
        if isinstance(c, DenseLU):
            c = DenseLU(put(c.lu, repl), put(c.piv, repl))
        elif isinstance(c, IterativeCoarse):
            c = IterativeCoarse(put(c.d, repl), put(c.ell_idx, repl),
                                put(c.ell_val, repl), c.inner)
        return _PaddedCoarse(c, nc)

    levels = tuple(Level(shard_op(l.A), shard_op(l.P), shard_op(l.R),
                         shard_relax(l.relax, pad_n(l.A.shape[0])))
                   for l in hier.levels)
    nc = hier.levels[-1].A.shape[0]
    return Hierarchy(levels, shard_coarse(hier.coarse, nc))


@functools.partial(jax.jit, static_argnames=("cfg", "max_iter"))
def _refined_loop_ell(cfg, hier, dfA, b_hi, b_lo, xh, xl, tol, max_iter):
    """Whole df32 refinement loop in one (sharded) device program — the
    flat-ELL counterpart of parallel/sharded_solve._sharded_refined_loop."""
    res0 = jnp.sqrt(jnp.sum(b_hi * b_hi))
    resvec = jnp.zeros((max_iter + 1,), jnp.float32)

    def cond(carry):
        _, _, _, it, res, _ = carry
        ok = jnp.logical_and(res >= tol * jnp.maximum(res0, 1e-38),
                             res < 1e3 * jnp.maximum(res0, 1e-38))
        return jnp.logical_and(it < max_iter, ok)

    def body(carry):
        xh, xl, rh, it, res, rv = carry
        z = recursive_cycle(cfg, hier, rh, jnp.zeros_like(rh), x_zero=True)
        xh, xl = df_accumulate(xh, xl, z)
        rh, rl = df_residual_ell(dfA, b_hi, b_lo, xh, xl)
        res = jnp.sqrt(jnp.sum(rh * rh))
        rv = rv.at[it + 1].set(res)
        return (xh, xl, rh, it + 1, res, rv)

    rh0, _ = df_residual_ell(dfA, b_hi, b_lo, xh, xl)
    res_init = jnp.sqrt(jnp.sum(rh0 * rh0))
    resvec = resvec.at[0].set(res_init)
    xh, xl, _, iters, res, resvec = jax.lax.while_loop(
        cond, body, (xh, xl, rh0, jnp.int32(0), res_init, resvec))
    return xh, xl, iters, res, res0, resvec


class ShardedAMGSolver:
    """Sharded end-to-end solvers over one flat (AMG) hierarchy.

    Built from an `MGState` whose device hierarchy is the flat engine
    (SA-AMG / classical AMG — `sa_amg_setup(A, cfg, rp)` without a mesh,
    or `classical_amg_setup`); iterates/counts match the single-chip flat
    engine exactly.
    """

    def __init__(self, state, mesh: Mesh, axis: str = "x"):
        from ..cycle.grid_cycle import GridHierarchy
        cfg = state.config
        if isinstance(state.hier, GridHierarchy):
            raise ValueError("state uses the structured grid engine — use "
                             "ShardedGridSolver (parallel/sharded_solve.py)")
        if np.dtype(cfg.dtype) != np.float32:
            raise ValueError("sharded AMG refinement assumes a float32 "
                             "hierarchy (df32 residual certifies ~1e-13)")
        self.state = state
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        self.hier = shard_flat_hierarchy(state.hier, mesh, axis)
        self.n_true = int(state.hier.levels[0].A.shape[0])
        ndev = mesh.shape[axis]
        self.n_pad = -(-self.n_true // ndev) * ndev
        A_hi = state.A_input if getattr(state, "A_input", None) is not None \
            else state.As[0]
        dfA = df_ell_from_csr(A_hi)
        rows = NamedSharding(mesh, P(axis, None))
        self.dfA = DFEll(
            jax.device_put(_pad_rows(dfA.indices, self.n_pad), rows),
            jax.device_put(_pad_rows(dfA.values_hi, self.n_pad), rows),
            jax.device_put(_pad_rows(dfA.values_lo, self.n_pad), rows),
            (self.n_pad, self.n_pad))
        self._repl = NamedSharding(mesh, P())
        self._cycle = jax.jit(functools.partial(recursive_cycle, cfg),
                              static_argnames=())

    def _to_dev(self, v, dtype):
        v = np.asarray(v, dtype)
        squeeze = v.ndim == 1
        v2 = v[:, None] if squeeze else v
        v2 = np.pad(v2, ((0, self.n_pad - v2.shape[0]), (0, 0)))
        return jax.device_put(jnp.asarray(v2), self._repl), squeeze

    def cycle(self, b, x=None):
        """One multigrid cycle on replicated (n, m) operands."""
        b2, squeeze = self._to_dev(b, self.cfg.dtype)
        x2 = jnp.zeros_like(b2) if x is None else self._to_dev(x, self.cfg.dtype)[0]
        y = self._cycle(self.hier, b2, x2)
        y = np.asarray(y)[:self.n_true]
        return y[:, 0] if squeeze else y

    def solve_refined(self, b, x=None, tol: float = 1e-8,
                      max_iter: int | None = None):
        """Sharded mixed-precision refinement to true (f64-certified) tol."""
        cfg = self.cfg
        if max_iter is None:
            max_iter = cfg.max_outer_iter
        b64 = np.asarray(b, np.float64)
        bh, squeeze = self._to_dev(b64.astype(np.float32), np.float32)
        bl, _ = self._to_dev(
            (b64 - b64.astype(np.float32).astype(np.float64)
             ).astype(np.float32), np.float32)
        if x is None:
            xh, xl = jnp.zeros_like(bh), jnp.zeros_like(bl)
        else:
            x64 = np.asarray(x, np.float64)
            xh, _ = self._to_dev(x64.astype(np.float32), np.float32)
            xl, _ = self._to_dev(
                (x64 - x64.astype(np.float32).astype(np.float64)
                 ).astype(np.float32), np.float32)
        xh, xl, iters, res, res0, resvec = _refined_loop_ell(
            cfg, self.hier, self.dfA, bh, bl, xh, xl, jnp.float32(tol),
            int(max_iter))
        iters = int(iters)
        x_np = (np.asarray(xh, np.float64)
                + np.asarray(xl, np.float64))[:self.n_true]
        if squeeze:
            x_np = x_np[:, 0]
        return x_np, {"iters": iters,
                      "relres": float(res) / max(float(res0), 1e-300),
                      "resvec": np.asarray(resvec)[:iters + 1]}

    def solve_fgmres(self, b, tol: float = 1e-8, max_iter: int = 30,
                     restart: int | None = None):
        """MG-preconditioned FGMRES on sharded operands (f32 arithmetic)."""
        from ..krylov.fgmres import fgmres
        cfg = self.cfg
        bv, squeeze = self._to_dev(b, cfg.dtype)
        A = self.hier.levels[0].A

        def prec(r):
            return recursive_cycle(cfg, self.hier, r, jnp.zeros_like(r),
                                   x_zero=True)

        x, info = fgmres(A.matvec, bv, restart=restart or 10,
                         max_iter=max_iter, tol=tol, prec=prec)
        x = np.asarray(x)[:self.n_true]
        return (x[:, 0] if squeeze else x), info
