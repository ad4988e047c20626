"""Stand-alone multigrid solve driver + preconditioner closures.

Equivalent of the reference's SolveFuncs layer (src/Multigrid/SolveFuncs.jl):
`solve_mg` iterates cycles with a relative-tolerance stop and per-cycle
convergence-factor reporting (SolveFuncs.jl:3-39); `get_mg_preconditioner`
wraps one cycle as an operator for Krylov methods, including the
mixed-precision shim that runs a lower-precision cycle inside a higher
precision outer iteration (SolveFuncs.jl:43-63).
"""
from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..setup.hierarchy import MGState
from ..cycle.cycle import make_cycle_fn

__all__ = ["solve_mg", "get_mg_preconditioner", "get_afun", "solve_mg_jit",
           "solve_mg_refined"]


def _as_2d(v):
    v = jnp.asarray(v)
    return (v[:, None], True) if v.ndim == 1 else (v, False)


def _cycle_runtime(cfg, hier):
    """Engine-specific vector runtime for the solve loop.

    The grid engine keeps solve-loop state in (m, *grid) form, converting
    once at the loop boundary instead of every cycle (the flat (n, m) <->
    grid conversion is a transpose).
    Returns (to_internal, to_flat, cycle_fn, matvec).  Internal "vectors" are
    arrays, or tuples of per-component fields for the systems engine — use
    the _v* helpers below for arithmetic on them.
    """
    from ..cycle.grid_cycle import GridHierarchy, grid_cycle_jit
    from ..ops.grid_stencil import flat_to_grid, grid_to_flat
    if isinstance(hier, GridHierarchy):
        grid = hier.fine_grid
        return (lambda v: flat_to_grid(v, grid), grid_to_flat,
                lambda h, b, x, xz=False: grid_cycle_jit(cfg, h, b, x, xz),
                hier.levels[0].A.matvec)

    from ..cycle.systems_grid import (SystemsGridHierarchy,
                                      systems_grid_cycle_jit,
                                      block_to_fields, fields_to_block)
    if isinstance(hier, SystemsGridHierarchy):
        grids = hier.fine_grids
        return (lambda v: block_to_fields(v, grids), fields_to_block,
                lambda h, b, x, xz=False:
                    systems_grid_cycle_jit(cfg, h, b, x, xz),
                hier.levels[0].A.matvec)

    cycle = make_cycle_fn(cfg)
    return (lambda v: v, lambda v: v, cycle, hier.levels[0].A.matvec)


def _vsub(a, b):
    if isinstance(a, tuple):
        return tuple(x - y for x, y in zip(a, b))
    return a - b


def _vadd(a, b):
    if isinstance(a, tuple):
        return tuple(x + y for x, y in zip(a, b))
    return a + b


def _vnorm(a) -> float:
    if isinstance(a, tuple):
        return float(jnp.sqrt(sum(jnp.real(jnp.sum(jnp.abs(x) ** 2))
                                  for x in a)))
    return float(jnp.linalg.norm(a))


def _vastype(a, dtype):
    if isinstance(a, tuple):
        return tuple(x.astype(dtype) for x in a)
    return a.astype(dtype)


def _vzeros(a, dtype=None):
    if isinstance(a, tuple):
        return tuple(jnp.zeros_like(x, dtype=dtype) for x in a)
    return jnp.zeros_like(a, dtype=dtype)


def get_afun(A_dev):
    """Matvec closure over a device matrix (reference getAfun, SolveFuncs.jl:65-71)."""
    return A_dev.matvec


def solve_mg(state: MGState, b, x=None, verbose: bool = False):
    """Iterate cycles until ||r||/||r0|| < relative_tol or max_outer_iter.

    Returns (x, info) with info = {"iters", "relres", "resvec"}.  Per-cycle
    convergence factors are printed in verbose mode exactly like the
    reference's driver (SolveFuncs.jl:31-33).
    """
    t0 = time.perf_counter()
    cfg = state.config
    hier = state.hier
    b2, squeeze = _as_2d(jnp.asarray(b, dtype=cfg.dtype))
    x2 = (jnp.zeros_like(b2) if x is None
          else _as_2d(jnp.asarray(x, dtype=cfg.dtype))[0])
    nrhs = b2.shape[1]
    to_internal, to_flat, cycle, matvec = _cycle_runtime(cfg, hier)
    bv, xv = to_internal(b2), to_internal(x2)

    res0 = _vnorm(_vsub(bv, matvec(xv))) if _vnorm(xv) > 0 else _vnorm(bv)
    res = res0
    resvec = [res0]
    iters = 0
    for count in range(cfg.max_outer_iter):
        xv = cycle(hier, bv, xv)
        res_prev = res
        res = _vnorm(_vsub(bv, matvec(xv)))
        resvec.append(res)
        iters += 1
        if verbose:
            print(f"Cycle {count + 1} done with relres: {res / res0:.3e}. "
                  f"Convergence factor: {res / max(res_prev, 1e-300):.3f}")
        if res / max(res0, 1e-300) < cfg.relative_tol:
            break
        if not np.isfinite(res) or res > 1e3 * max(res0, 1e-300):
            break              # diverging (see the device-loop guards)
    state.n_iter += iters * nrhs
    state.time_solve += time.perf_counter() - t0
    x2 = to_flat(xv)
    x_out = x2[:, 0] if squeeze else x2
    return x_out, {"iters": iters, "relres": res / max(res0, 1e-300),
                   "resvec": np.array(resvec)}


def solve_mg_jit(state: MGState, b, x=None, num_cycles: int | None = None):
    """Fully-jitted fixed-cycle-count solve (no host syncs) for benchmarking."""
    cfg = state.config
    hier = state.hier
    b2, squeeze = _as_2d(jnp.asarray(b, dtype=cfg.dtype))
    x2 = (jnp.zeros_like(b2) if x is None
          else _as_2d(jnp.asarray(x, dtype=cfg.dtype))[0])
    n = cfg.max_outer_iter if num_cycles is None else num_cycles
    to_internal, to_flat, cycle, _ = _cycle_runtime(cfg, hier)

    @jax.jit
    def run(hier, b2, x2):
        bv, xv = to_internal(b2), to_internal(x2)
        for _ in range(n):
            xv = cycle(hier, bv, xv)
        return to_flat(xv)

    x2 = run(hier, b2, x2)
    return x2[:, 0] if squeeze else x2


def _high_precision_fine_op(state: MGState, outer_dtype):
    """Fine-level matvec at the outer (higher) precision, cached on the state."""
    key = ("_hi_op", np.dtype(outer_dtype).name)
    cached = getattr(state, "_hi_op_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    # refine against the ORIGINAL-precision operator when available — the
    # hierarchy's fine matrix was cast to the (low) cycle dtype at setup, and
    # refinement cannot recover accuracy the stored operator lost
    A_host = state.A_input if getattr(state, "A_input", None) is not None \
        else state.As[0]
    from ..cycle.grid_cycle import GridHierarchy
    from ..cycle.systems_grid import (SystemsGridHierarchy,
                                      block_operator_from_csr)
    if isinstance(state.hier, GridHierarchy):
        from ..ops.grid_stencil import make_grid_stencil
        # nodal or cell-centered, whichever matches the operator size
        grid = state.hier.fine_grid
        nodes = list(reversed(grid))
        op = make_grid_stencil(A_host, nodes, dtype=outer_dtype,
                               max_shift=(min(grid) - 1) // 2 if min(grid) < 7
                               else 3).matvec
    elif isinstance(state.hier, SystemsGridHierarchy):
        op = block_operator_from_csr(A_host, list(state.meshes[0].n),
                                     state.config.mixed,
                                     dtype=outer_dtype).matvec
    else:
        from ..setup.hierarchy import _to_device_matrix
        op = _to_device_matrix(A_host, np.dtype(outer_dtype).type).matvec
    state._hi_op_cache = (key, op)
    return op


def _cast_hier(hier, dtype):
    """Cast every floating leaf of a hierarchy pytree to `dtype`."""
    def cast(a):
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating):
            return a.astype(dtype)
        return a
    return jax.tree_util.tree_map(cast, hier)


def _df32_residual_op(state: MGState):
    """Double-single residual operator for the fine level, or None.

    Built from the ORIGINAL-precision matrix (A_input): constant-interior
    form where the operator compresses, dense-stencil form for
    variable-coefficient scalar operators, and the block form for the
    staggered systems engine (mixed elasticity to TRUE 1e-8 without x64).
    The compensated two-float32 residual (ops/df32.py) certifies 1e-8 from
    an f32 hierarchy without jax x64 or an f64 copy of the operator.
    """
    cached = getattr(state, "_df32_op_cache", None)
    if cached is not None:
        return cached[0]
    op = None
    if not np.issubdtype(np.dtype(state.config.dtype), np.complexfloating):
        from ..cycle.grid_cycle import GridHierarchy
        from ..cycle.systems_grid import SystemsGridHierarchy
        from ..ops.df32 import (df_const_from_csr, df_dense_from_csr,
                                df_block_from_csr)
        A_host = state.A_input if getattr(state, "A_input", None) \
            is not None else state.As[0]
        if isinstance(state.hier, GridHierarchy):
            nodes = list(reversed(state.hier.fine_grid))
            try:
                op = df_const_from_csr(sp.csr_matrix(A_host), nodes)
            except ValueError:
                try:
                    op = df_dense_from_csr(sp.csr_matrix(A_host), nodes)
                except ValueError:
                    op = None
        elif isinstance(state.hier, SystemsGridHierarchy):
            # meshes can be absent on exotic states: op stays None and the
            # refined loop takes the safe f64 outer path — a DFEll here
            # would meet tuple block-field vectors and fail at trace time
            if state.meshes:
                try:
                    op = df_block_from_csr(A_host, list(state.meshes[0].n),
                                           state.config.mixed)
                except ValueError:
                    op = None
        else:
            # flat (ELL/DIA) engine — unstructured AMG hierarchies.  Without
            # this form, with jax x64 OFF, the f64 outer residual silently
            # truncates to f32 and the solve floors at ~1e-7 — the same
            # df32-ELL machinery the sharded tiers use
            # (parallel/sharded_amg.py).
            from ..ops.df32 import df_ell_from_csr
            try:
                op = df_ell_from_csr(sp.csr_matrix(A_host))
            except Exception:              # noqa: BLE001 — fall back to f64
                op = None
    state._df32_op_cache = (op,)
    return op


def solve_mg_refined(state: MGState, b, x=None, tol: float = 1e-8,
                     max_iter: int | None = None, outer_dtype=None,
                     cycle_dtype=None, device_loop: bool = True,
                     fmg: bool = False, verbose: bool = False):
    """Mixed-precision iterative refinement: x += Cycle_low(b - A x |_high).

    The residual is computed at `outer_dtype` (default: float64/complex128)
    with the low-precision hierarchy cycle as the correction — the driver
    form of the reference's mixed-precision preconditioning shim
    (SolveFuncs.jl:52-58).  Reaches outer-precision accuracy (e.g. 1e-8
    relative residuals from an f32 hierarchy) at roughly one high-precision
    SpMV extra per cycle.

    cycle_dtype optionally runs the correction cycle BELOW the hierarchy
    precision (e.g. ``jnp.bfloat16``: half the smoother memory traffic);
    refinement restores outer-precision
    accuracy at the cost of a slightly weaker per-iteration contraction.

    device_loop=True compiles the whole refinement loop into ONE program
    (`lax.while_loop`) — a host-synced loop pays a dispatch and a host
    round trip per iteration, which can exceed a small cycle itself.
    """
    t0 = time.perf_counter()
    cfg = state.config
    hier = state.hier
    if outer_dtype is None:
        outer_dtype = (np.complex128 if np.issubdtype(np.dtype(cfg.dtype),
                                                      np.complexfloating)
                       else np.float64)
    if max_iter is None:
        max_iter = cfg.max_outer_iter
    cd = np.dtype(cycle_dtype) if cycle_dtype is not None \
        else np.dtype(cfg.dtype)
    hier_lo = _cast_hier(hier, cd) if cd != np.dtype(cfg.dtype) else hier

    to_internal, to_flat, cycle, _ = _cycle_runtime(cfg, hier)
    squeeze = np.ndim(b) == 1
    nrhs = 1 if squeeze else np.shape(b)[-1]

    # df32 residual: only for FLOAT32 hierarchies (its ~1e-13 attainable
    # accuracy would silently cap a true-f64 hierarchy below tol<1e-13), and
    # independent of `verbose` so the numeric path never changes with logging
    # (verbose reporting happens from resvec after the device loop).
    df_op = (_df32_residual_op(state)
             if device_loop
             and np.dtype(state.config.dtype) == np.float32
             and not np.issubdtype(np.dtype(outer_dtype), np.complexfloating)
             else None)
    if df_op is not None:
        # double-single residual path: split b/x from their f64 HOST values
        # (without jax x64 a device f64 silently truncates to f32 and the
        # low words would be lost)
        b_np = np.asarray(b, dtype=np.float64)
        b_hi = b_np.astype(np.float32)
        b_lo = (b_np - b_hi.astype(np.float64)).astype(np.float32)
        bh2, _ = _as_2d(jnp.asarray(b_hi))
        bl2, _ = _as_2d(jnp.asarray(b_lo))
        if x is None:
            xh2, xl2 = jnp.zeros_like(bh2), jnp.zeros_like(bl2)
        else:
            x_np = np.asarray(x, dtype=np.float64)
            x_hi = x_np.astype(np.float32)
            x_lo = (x_np - x_hi.astype(np.float64)).astype(np.float32)
            xh2, _ = _as_2d(jnp.asarray(x_hi))
            xl2, _ = _as_2d(jnp.asarray(x_lo))
        xh, xl, iters, res, res0, resvec = _refined_device_loop_df32(
            cfg, hier_lo, df_op, to_internal(bh2), to_internal(bl2),
            to_internal(xh2), to_internal(xl2), jnp.float32(tol),
            int(max_iter), cd, bool(fmg and x is None))
        iters = int(iters)
        res, res0 = float(res), float(res0)
        resvec = np.asarray(resvec)[:iters + 1]
        if verbose:
            _print_resvec(resvec)
        x_np = (np.asarray(to_flat(xh), np.float64)
                + np.asarray(to_flat(xl), np.float64))
        state.n_iter += iters * nrhs
        state.time_solve += time.perf_counter() - t0
        x_out = x_np[:, 0] if squeeze else x_np
        return x_out, {"iters": iters, "relres": res / max(res0, 1e-300),
                       "resvec": resvec}
    b2, squeeze = _as_2d(jnp.asarray(b, dtype=outer_dtype))
    x2 = (jnp.zeros_like(b2) if x is None
          else _as_2d(jnp.asarray(x, dtype=outer_dtype))[0])
    matvec_hi = _high_precision_fine_op(state, outer_dtype)
    bv = to_internal(b2)
    xv = to_internal(x2)
    if device_loop:
        xv, iters, res, res0, resvec = _refined_device_loop(
            cfg, hier_lo, matvec_hi, bv, xv,
            jnp.asarray(tol, jnp.result_type(float)), int(max_iter), cd)
        iters = int(iters)
        res, res0 = float(res), float(res0)
        resvec = np.asarray(resvec)[:iters + 1]
        if verbose:
            _print_resvec(resvec)
    else:
        res0 = _vnorm(bv)
        res = res0
        resvec = [res0]
        iters = 0
        for count in range(max_iter):
            r = _vsub(bv, matvec_hi(xv))
            res_prev, res = res, _vnorm(r)
            if count > 0:
                resvec.append(res)
                if verbose:
                    print(f"Refined cycle {count} relres: {res / res0:.3e}. "
                          f"Factor: {res / max(res_prev, 1e-300):.3f}")
            if res / max(res0, 1e-300) < tol:
                break
            z = cycle(hier_lo, _vastype(r, cd), _vzeros(r, cd), True)
            xv = _vadd(xv, _vastype(z, outer_dtype))
            iters += 1
        resvec = np.array(resvec)
    state.n_iter += iters * b2.shape[1]
    state.time_solve += time.perf_counter() - t0
    x2 = to_flat(xv)
    x_out = x2[:, 0] if squeeze else x2
    return x_out, {"iters": iters, "relres": res / max(res0, 1e-300),
                   "resvec": resvec}


def _print_resvec(resvec):
    """Per-iteration convergence report from a completed device loop.

    Keeps verbose mode on the SAME numeric path as silent mode — the device
    loop records resvec and we print after, instead of switching to a
    host-synced loop just to log.
    """
    res0 = max(float(resvec[0]), 1e-300)
    for k in range(1, len(resvec)):
        print(f"Refined cycle {k} relres: {resvec[k] / res0:.3e}. "
              f"Factor: {resvec[k] / max(float(resvec[k - 1]), 1e-300):.3f}")


@functools.partial(jax.jit, static_argnames=("cfg", "matvec_hi",
                                             "max_iter", "cd"))
def _refined_device_loop(cfg, hier_lo, matvec_hi, bv, xv, tol, max_iter, cd):
    """Whole refinement loop on device: one dispatch, tol checked in-loop.

    `tol` is traced (new tolerances don't recompile); `max_iter` shapes
    resvec so it stays static.  `matvec_hi` is a closure and therefore a
    static argument — reuse of the `state._hi_op_cache` entry is load-bearing
    for avoiding recompiles across calls (a regenerated closure, e.g. after
    `replace_matrix_in_hierarchy`, recompiles once by design)."""
    from ..cycle.grid_cycle import GridHierarchy, grid_cycle
    from ..cycle.systems_grid import SystemsGridHierarchy, systems_grid_cycle
    from ..cycle.cycle import recursive_cycle

    # correction cycles always start from a zero guess: x_zero skips the
    # r = b - A*0 entry matvec at every level (grid_cycle docstring)
    if isinstance(hier_lo, GridHierarchy):
        cyc = lambda h, b, x: grid_cycle(cfg, h, b, x, x_zero=True)
    elif isinstance(hier_lo, SystemsGridHierarchy):
        cyc = lambda h, b, x: systems_grid_cycle(cfg, h, b, x, x_zero=True)
    else:
        cyc = lambda h, b, x: recursive_cycle(cfg, h, b, x, x_zero=True)

    def sq_norm(v):
        if isinstance(v, tuple):
            return sum(jnp.real(jnp.sum(jnp.abs(t) ** 2)) for t in v)
        return jnp.real(jnp.sum(jnp.abs(v) ** 2))

    outer = (bv[0] if isinstance(bv, tuple) else bv).dtype
    res0 = jnp.sqrt(sq_norm(bv))
    resvec = jnp.zeros((max_iter + 1,), res0.dtype)

    def cond(carry):
        x, r, it, res, _ = carry
        # divergence guard: an f32 cycle on kappa*eps > 1 operators can blow
        # up unboundedly; stop once the residual exceeds 1e3x the start so
        # callers see relres > 1 instead of overflow garbage
        ok = jnp.logical_and(res >= tol * jnp.maximum(res0, 1e-300),
                             res < 1e3 * jnp.maximum(res0, 1e-300))
        return jnp.logical_and(it < max_iter, ok)

    def body(carry):
        x, r, it, res, rv = carry
        z = cyc(hier_lo, _vastype(r, cd), _vzeros(r, cd))
        x = _vadd(x, _vastype(z, outer))
        r = _vsub(bv, matvec_hi(x))
        res = jnp.sqrt(sq_norm(r))
        rv = rv.at[it + 1].set(res)
        return (x, r, it + 1, res, rv)

    r_init = _vsub(bv, matvec_hi(xv))
    res_init = jnp.sqrt(sq_norm(r_init))
    resvec = resvec.at[0].set(res_init)
    x, _, iters, res, resvec = jax.lax.while_loop(
        cond, body, (xv, r_init, jnp.int32(0), res_init, resvec))
    return x, iters, res, res0, resvec


@functools.partial(jax.jit, static_argnames=("cfg", "max_iter", "cd",
                                              "use_fmg"))
def _refined_device_loop_df32(cfg, hier_lo, df_op, b_hi, b_lo, xh, xl,
                              tol, max_iter, cd, use_fmg=False):
    """Refinement loop with a double-single (two-f32) fine residual.

    One device dispatch for the whole solve; the compensated residual
    (ops/df32.py) keeps ~1e-13 effective residual precision from f32
    arithmetic.  Fields are grid arrays (scalar
    engine) or tuples of component fields (systems engine — mixed
    elasticity certifies TRUE 1e-8 without x64); df_residual_any picks the
    matching compensated operator form.  use_fmg seeds x with one full
    multigrid pass (scalar grid engine only).
    """
    from ..cycle.grid_cycle import GridHierarchy, grid_cycle, grid_fmg
    from ..cycle.systems_grid import SystemsGridHierarchy, systems_grid_cycle
    from ..ops.df32 import df_residual_any, df_accumulate_tree

    if isinstance(hier_lo, SystemsGridHierarchy):
        cyc = lambda r: systems_grid_cycle(cfg, hier_lo, _vastype(r, cd),
                                           _vzeros(r, cd), x_zero=True)
    elif isinstance(hier_lo, GridHierarchy):
        cyc = lambda r: grid_cycle(cfg, hier_lo, r.astype(cd),
                                   jnp.zeros_like(r, dtype=cd), x_zero=True)
    else:
        # flat (ELL/DIA) engine: vectors stay (n, m)
        from ..cycle.cycle import recursive_cycle
        cyc = lambda r: recursive_cycle(cfg, hier_lo, r.astype(cd),
                                        jnp.zeros_like(r, dtype=cd),
                                        x_zero=True)

    def sq_norm(v):
        if isinstance(v, tuple):
            return sum(jnp.sum(t * t) for t in v)
        return jnp.sum(v * v)

    if use_fmg and isinstance(hier_lo, GridHierarchy):
        z = grid_fmg(cfg, hier_lo, b_hi.astype(cd)).astype(jnp.float32)
        xh, xl = df_accumulate_tree(xh, xl, z)

    res0 = jnp.sqrt(sq_norm(b_hi))
    resvec = jnp.zeros((max_iter + 1,), jnp.float32)

    def cond(carry):
        xh, xl, rh, it, res, _ = carry
        ok = jnp.logical_and(res >= tol * jnp.maximum(res0, 1e-38),
                             res < 1e3 * jnp.maximum(res0, 1e-38))
        return jnp.logical_and(it < max_iter, ok)

    def body(carry):
        xh, xl, rh, it, res, rv = carry
        z = cyc(rh)
        xh, xl = df_accumulate_tree(xh, xl, _vastype(z, jnp.float32))
        rh, rl = df_residual_any(df_op, b_hi, b_lo, xh, xl)
        res = jnp.sqrt(sq_norm(rh))
        rv = rv.at[it + 1].set(res)
        return (xh, xl, rh, it + 1, res, rv)

    rh0, _ = df_residual_any(df_op, b_hi, b_lo, xh, xl)
    res_init = jnp.sqrt(sq_norm(rh0))
    resvec = resvec.at[0].set(res_init)
    xh, xl, _, iters, res, resvec = jax.lax.while_loop(
        cond, body, (xh, xl, rh0, jnp.int32(0), res_init, resvec))
    return xh, xl, iters, res, res0, resvec


def get_mg_preconditioner(state: MGState, outer_dtype=None):
    """One-cycle-from-zero preconditioner closure (SolveFuncs.jl:43-63).

    When outer_dtype differs from the hierarchy dtype, the cycle runs in the
    hierarchy's (lower) precision inside the higher-precision outer Krylov
    iteration — the reference's mixed-precision shim (SolveFuncs.jl:52-58).
    """
    cfg = state.config
    hier = state.hier
    cycle = make_cycle_fn(cfg)
    mixed = outer_dtype is not None and np.dtype(outer_dtype) != np.dtype(cfg.dtype)

    def prec(r):
        r2, squeeze = _as_2d(r)
        rl = r2.astype(cfg.dtype) if mixed else r2
        z = cycle(hier, rl, jnp.zeros_like(rl), True)
        if mixed:
            z = z.astype(outer_dtype)
        return z[:, 0] if squeeze else z

    return prec


# ---------------------------------------------------------------------------
# Krylov-wrapped solves (reference SolveFuncs.jl:74-133)
# ---------------------------------------------------------------------------

def _krylov_setup(state: MGState, b, x0):
    """Engine-aware Krylov operands.

    For the grid engine the whole Krylov iteration runs on (m, *grid) fields
    (zero conversions per preconditioner application, and the
    mixed-precision residual matvec at the outer dtype stays a stencil apply);
    the flat path keeps the reference's (n, m) column convention.
    """
    cfg = state.config
    hier = state.hier
    b2, squeeze = _as_2d(jnp.asarray(b))
    x2 = (jnp.zeros_like(b2) if x0 is None
          else _as_2d(jnp.asarray(x0))[0])

    from ..cycle.grid_cycle import GridHierarchy, grid_cycle_jit
    if isinstance(hier, GridHierarchy):
        from ..ops.grid_stencil import flat_to_grid, grid_to_flat
        grid = hier.fine_grid
        bv, xv = flat_to_grid(b2, grid), flat_to_grid(x2, grid)
        mixed = np.dtype(b2.dtype) != np.dtype(cfg.dtype)
        matvec = (_high_precision_fine_op(state, b2.dtype) if mixed
                  else hier.levels[0].A.matvec)

        def prec(r):
            rl = r.astype(cfg.dtype) if mixed else r
            z = grid_cycle_jit(cfg, hier, rl, jnp.zeros_like(rl), True)
            return z.astype(r.dtype) if mixed else z

        def to_flat(Xv):
            X2 = grid_to_flat(Xv)
            return X2[:, 0] if squeeze else X2

        return cfg, bv, xv, matvec, prec, to_flat, True

    from ..cycle.systems_grid import (SystemsGridHierarchy,
                                      systems_grid_cycle_jit,
                                      block_to_fields, fields_to_block)
    if isinstance(hier, SystemsGridHierarchy):
        # block-field cycle wrapped for the column-layout Krylov loop (the
        # preconditioner application dominates; pytree-native Krylov operands
        # are future work)
        grids = hier.fine_grids
        mixed = np.dtype(b2.dtype) != np.dtype(cfg.dtype)
        op = (_high_precision_fine_op(state, b2.dtype) if mixed
              else hier.levels[0].A.matvec)

        def matvec(v2):
            return fields_to_block(op(block_to_fields(v2, grids)))

        def prec(r2):
            rl = r2.astype(cfg.dtype) if mixed else r2
            rf = block_to_fields(rl, grids)
            zf = systems_grid_cycle_jit(cfg, hier, rf,
                                        tuple(jnp.zeros_like(t)
                                              for t in rf), True)
            z = fields_to_block(zf)
            return z.astype(r2.dtype) if mixed else z

        def to_flat(X2):
            return X2[:, 0] if squeeze else X2

        return cfg, b2, x2, matvec, prec, to_flat, False

    matvec = hier.levels[0].A.matvec
    prec = get_mg_preconditioner(state, outer_dtype=b2.dtype)

    def to_flat(X2):
        return X2[:, 0] if squeeze else X2

    return cfg, b2, x2, matvec, prec, to_flat, False


def solve_cg_mg(state: MGState, b, x0=None, verbose: bool = False,
                block: bool = False):
    """MG-preconditioned CG (reference solveCG_MG, SolveFuncs.jl:103-116).

    block=True uses the shared-Krylov-space block CG for multiple RHS — the
    reference's blockCG dispatch (SolveFuncs.jl:109-114)."""
    from ..krylov.cg import pcg
    from ..krylov.block import block_pcg
    t0 = time.perf_counter()
    cfg, bv, xv, matvec, prec, to_flat, lead = _krylov_setup(state, b, x0)
    nrhs = bv.shape[0] if lead else (bv.shape[1] if bv.ndim > 1 else 1)
    fn = block_pcg if (block and nrhs > 1) else pcg
    x, info = fn(matvec, bv, prec=prec, x0=xv, tol=cfg.relative_tol,
                 max_iter=cfg.max_outer_iter, batch_leading=lead)
    if verbose:
        print(f"solve_cg_mg: {int(info['iters'])} iters, relres "
              f"{float(jnp.max(info['relres'])):.3e}")
    state.n_iter += int(info["iters"]) * info["relres"].size
    state.time_solve += time.perf_counter() - t0
    return to_flat(x), info


def solve_bicgstab_mg(state: MGState, b, x0=None, verbose: bool = False,
                      block: bool = False):
    """MG-preconditioned BiCGSTAB (reference solveBiCGSTAB_MG,
    SolveFuncs.jl:85-99).  block=True uses the shared-space Bl-BiCGSTAB
    (reference blockBiCGSTB dispatch, SolveFuncs.jl:91-96)."""
    from ..krylov.bicgstab import bicgstab
    from ..krylov.block import block_bicgstab
    t0 = time.perf_counter()
    cfg, bv, xv, matvec, prec, to_flat, lead = _krylov_setup(state, b, x0)
    nrhs = bv.shape[0] if lead else (bv.shape[1] if bv.ndim > 1 else 1)
    fn = block_bicgstab if (block and nrhs > 1) else bicgstab
    x, info = fn(matvec, bv, prec=prec, x0=xv, tol=cfg.relative_tol,
                 max_iter=cfg.max_outer_iter, batch_leading=lead)
    if verbose:
        print(f"solve_bicgstab_mg: {int(info['iters'])} iters, relres "
              f"{float(jnp.max(info['relres'])):.3e}")
    state.n_iter += int(info["iters"]) * info["relres"].size
    state.time_solve += time.perf_counter() - t0
    return to_flat(x), info


def solve_gmres_mg(state: MGState, b, x0=None, flexible: bool = True,
                   inner: int = 5, verbose: bool = False, block: bool = False):
    """MG-preconditioned restarted (F)GMRES (reference solveGMRES_MG,
    SolveFuncs.jl:120-133). block=True uses the reference's shared-Krylov-space
    block variant for multiple RHS."""
    from ..krylov.fgmres import fgmres, block_fgmres
    t0 = time.perf_counter()
    cfg, bv, xv, matvec, prec, to_flat, lead = _krylov_setup(state, b, x0)
    nrhs = bv.shape[0] if lead else bv.shape[1]
    fn = block_fgmres if (block and nrhs > 1) else fgmres
    x, info = fn(matvec, bv, restart=inner, prec=prec, x0=xv,
                 tol=cfg.relative_tol, max_iter=cfg.max_outer_iter,
                 flexible=flexible, verbose=verbose, batch_leading=lead)
    state.n_iter += int(info["iters"]) * nrhs
    state.time_solve += time.perf_counter() - t0
    return to_flat(x), info
