"""Grid-form multigrid cycle — the structured zero-gather engine.

Numerically identical to the flat cycle (mgtpu.cycle.cycle) on geometric
full-weighting hierarchies, but every operation is expressed on the node grid:

 * level operators are `GridStencil`s (shift-multiply-accumulate SpMV),
 * P/R are applied matrix-free as separable [0.5, 1, 0.5] tensor-product
   smoothing + stride-2 up/down-sampling (exactly the operators fw_interp
   builds, reference GeometricTransferOperators.jl:22-46, including the
   boundary rows, because zero-padded smoothing truncates the same way),
 * the coarsest solve is one dense matmul with a precomputed inverse (the
   replicated form of the reference's coarsest LU, MGsetup.jl:350: one
   (nc x nc) @ (nc x m) product per cycle instead of two sequential
   triangular solves).

Fields are (m, *grid) with the fastest mesh axis last and contiguous, so
every smoother and residual is a fused elementwise loop over the grid and
the transfers need no gathers.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import scipy.sparse as sp

from ..config import HIGHEST
from ..ops.grid_stencil import (GridStencil, make_grid_stencil,
                                flat_to_grid, grid_to_flat, _interleave)
from .relax import fgmres_relaxation

__all__ = [
    "GridLevel", "GridHierarchy", "DenseInverse", "GridIterativeCoarse",
    "FWTransfer",
    "grid_dense_inverse_from_scipy",
    "grid_restrict", "grid_prolong", "grid_cycle", "build_grid_hierarchy",
]


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["A", "d", "P1"], meta_fields=["lam"])
@dataclass(frozen=True)
class GridLevel:
    A: GridStencil
    d: jax.Array | None      # pointwise relax diagonal, grid-shaped
    P1: object | None        # FWTransfer / Stride2Transfer (None: coarsest)
    lam: float | None = None  # spec(D^-1 A) bound (chebyshev smoothing)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["inv"], meta_fields=["grid"])
@dataclass(frozen=True)
class DenseInverse:
    """Replicated dense inverse of the coarsest operator (one matmul/solve)."""
    inv: jax.Array           # (nc, nc)
    grid: tuple[int, ...]

    def solve(self, bg: jax.Array) -> jax.Array:
        """bg: (m, *grid) -> (m, *grid)."""
        m = bg.shape[0]
        xf = jnp.matmul(bg.reshape(m, -1), self.inv.T, precision=HIGHEST)
        return xf.reshape((m,) + self.grid)


@functools.partial(jax.jit, static_argnames=("n", "shift_rel"))
def _dense_inverse_device(rows, cols, data, n, shift_rel):
    """COO -> dense (+ optional relative diagonal shift) + LU + invert, all
    on device.  Returns (inv, err): err is the max identity residual
    |A inv - I| over a 256-column stride sample — the host uses it to decide
    whether an UNSHIFTED inverse is trustworthy (the shift must
    not perturb well-conditioned nonsingular coarsest operators).

    The inverse comes from lu_solve against the identity: the n-RHS
    triangular solves are blocked, matrix-rate work at setup, whereas
    per-cycle single-RHS triangular solves are sequential and
    latency-bound — so the factorization is a setup-time device step and
    the cycle keeps the one-matmul solve."""
    Ad = jnp.zeros((n, n), dtype=data.dtype).at[rows, cols].add(data)
    if shift_rel:
        sh = shift_rel * jnp.max(jnp.sum(jnp.abs(Ad), axis=0))
        Ad = Ad + sh * jnp.eye(n, dtype=Ad.dtype)
    lu, piv = jsl.lu_factor(Ad)
    inv = jsl.lu_solve((lu, piv), jnp.eye(n, dtype=Ad.dtype))
    cols_s = jnp.arange(0, n, max(1, n // 256))
    eye_s = (cols_s[None, :] == jnp.arange(n)[:, None]).astype(inv.dtype)
    err = jnp.max(jnp.abs(jnp.matmul(Ad, inv[:, cols_s], precision=HIGHEST)
                          - eye_s))
    return inv, err


def grid_dense_inverse_from_scipy(A_c: sp.spmatrix, grid_c,
                                  dtype) -> DenseInverse:
    """Device-built dense inverse for large coarsest levels (reference bar:
    UMFPACK factors ANY coarsest size, MGsetup.jl:350).

    No O(nc^3) host inversion.  The plain inverse is tried first; only if
    its sampled identity residual is non-finite or large (near-singular
    coarsest, e.g. a Neumann constant nullspace) is the reference's AMG
    coarsest regularization applied (SA-AMG.jl:63), widened to 1e-6 in
    single precision where a 1e-8 relative perturbation of the diagonal
    underflows f32 addition."""
    Ac = A_c.tocoo()
    args = (jnp.asarray(Ac.row), jnp.asarray(Ac.col),
            jnp.asarray(Ac.data.astype(dtype)))
    n = int(A_c.shape[0])
    inv, err = _dense_inverse_device(*args, n, 0.0)
    tol = 1e-2 if np.finfo(np.dtype(dtype)).eps > 1e-10 else 1e-6
    if not np.isfinite(float(err)) or float(err) > tol:
        shift_rel = 1e-6 if np.finfo(np.dtype(dtype)).eps > 1e-10 else 1e-8
        inv, _ = _dense_inverse_device(*args, n, shift_rel)
    return DenseInverse(inv, tuple(grid_c))


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=[], meta_fields=["factor", "grid"])
@dataclass(frozen=True)
class GridSparseLU:
    """Host SuperLU coarsest solve, grid form (see cycle/coarse.py:
    SparseLUCoarse — the reference's UMFPACK design point for coarsest
    levels beyond the replicated-dense budget, MGsetup.jl:350)."""
    factor: object          # scipy SuperLU (f64/c128)
    grid: tuple[int, ...]

    def solve(self, bg: jax.Array) -> jax.Array:
        m = bg.shape[0]
        bf = bg.reshape(m, -1)

        def cb(bh):
            out = self.factor.solve(
                np.asarray(bh, self.factor.U.dtype).T).T
            return out.astype(bh.dtype)
        xf = jax.pure_callback(
            cb, jax.ShapeDtypeStruct(bf.shape, bf.dtype), bf,
            vmap_method="sequential")
        return xf.reshape((m,) + self.grid)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["A", "d"], meta_fields=["inner"])
@dataclass(frozen=True)
class GridIterativeCoarse:
    """Jacobi-preconditioned one-shot FGMRES coarsest solve, grid form
    (reference MGcycle.jl:152-168 escape hatch)."""
    A: GridStencil
    d: jax.Array
    inner: int

    def solve(self, bg: jax.Array) -> jax.Array:
        return fgmres_relaxation(self.A.matvec, lambda r: self.d * r,
                                 bg, jnp.zeros_like(bg), self.inner)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["levels", "coarse"], meta_fields=[])
@dataclass(frozen=True)
class GridHierarchy:
    levels: tuple            # GridLevel per level (coarsest included, d=None ok)
    coarse: DenseInverse | GridIterativeCoarse

    @property
    def fine_grid(self) -> tuple[int, ...]:
        return self.levels[0].A.grid


# ---------------------------------------------------------------------------
# tensor-product full-weighting transfers
#
# The separable [0.5, 1, 0.5] smooth + resample along one grid axis is three
# strided multiply-adds per point: XLA fuses each axis pass into one loop.
# A dense per-axis matmul with the 1D fw_interp factor (f_a x c_a) computes
# the same operator at f_a * c_a multiply-adds per line; only the sharded
# tier keeps that form (parallel/grid_sharded.py), because its zero-padded
# factors keep the pad region of a padded embedding inert.
# ---------------------------------------------------------------------------

@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=[], meta_fields=["fine"])
@dataclass(frozen=True)
class FWTransfer:
    """Full-weighting P = kron of the 1D fw_interp factors, matrix-free.

    fine: per grid axis, the fine extent of a coarsened axis or None for an
    axis that is not coarsened (semicoarsening).  An odd extent coarsens
    every other node; an even extent keeps the last node as an identity
    tail (setup/transfers.fw_interp_1d)."""
    fine: tuple

    def restrict(self, r):
        """R r = 0.5^dim P^T r on (m, *fine_grid) fields."""
        y = r
        for a, n in enumerate(self.fine):
            if n is not None:
                y = _fw_restrict_axis(y, 1 + a, n)
        return (0.5 ** sum(n is not None for n in self.fine)) * y

    def prolong(self, xc):
        """P xc on (m, *coarse_grid) fields."""
        y = xc
        for a, n in enumerate(self.fine):
            if n is not None:
                y = _fw_prolong_axis(y, 1 + a, n)
        return y


def _sl(x, axis, start, stop, step=1):
    return jax.lax.slice_in_dim(x, start, stop, step, axis=axis)


def _fw_restrict_axis(x, axis: int, n: int):
    """P1^T x along `axis`: out[i] = x[2i] + (x[2i-1] + x[2i+1]) / 2."""
    if n % 2 == 0:                       # identity tail on the last node
        return jnp.concatenate([_fw_restrict_axis(_sl(x, axis, 0, n - 1),
                                                  axis, n - 1),
                                _sl(x, axis, n - 1, n)], axis=axis)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (1, 1)
    xp = jnp.pad(x, pad)                 # xp[k] = x[k - 1]
    return (_sl(xp, axis, 1, n + 1, 2)
            + 0.5 * (_sl(xp, axis, 0, n, 2) + _sl(xp, axis, 2, n + 2, 2)))


def _fw_prolong_axis(xc, axis: int, n: int):
    """P1 xc along `axis`: coarse nodes inject, midpoints average."""
    c = xc.shape[axis]
    if n % 2 == 0:                       # identity tail on the last node
        return jnp.concatenate([_fw_prolong_axis(_sl(xc, axis, 0, c - 1),
                                                 axis, n - 1),
                                _sl(xc, axis, c - 1, c)], axis=axis)
    mid = 0.5 * (_sl(xc, axis, 0, c - 1) + _sl(xc, axis, 1, c))
    return _interleave(xc, mid, axis)


def _axis_matmul(x: jax.Array, W: jax.Array, axis: int) -> jax.Array:
    """Contract `axis` of x with W (in, out) at full f32 precision."""
    xl = jnp.moveaxis(x, axis, -1)
    y = jnp.matmul(xl, W, precision=HIGHEST)
    return jnp.moveaxis(y, -1, axis)


def grid_restrict(rg: jax.Array, P1) -> jax.Array:
    """R r; rg is (m, *fine_grid).

    P1 is an FWTransfer (geometric full weighting, R = 0.5^dim P^T), a
    Stride2Transfer (matrix-dependent prolongator, R = P^H — the SA
    convention), or the sharded tier's tuple of padded per-axis dense
    factors."""
    if not isinstance(P1, tuple):
        return P1.restrict(rg)
    y = rg
    nc = 0
    for a, W in enumerate(P1):
        if W is None:                 # semicoarsening: axis not coarsened
            continue
        nc += 1
        y = _axis_matmul(y, W, 1 + a)
    return (0.5 ** nc) * y


def grid_prolong(xc: jax.Array, P1) -> jax.Array:
    """P xc; xc is (m, *coarse_grid)."""
    if not isinstance(P1, tuple):
        return P1.prolong(xc)
    y = xc
    for a, W in enumerate(P1):
        if W is None:
            continue
        y = _axis_matmul(y, W.T, 1 + a)
    return y


# ---------------------------------------------------------------------------
# cycle
# ---------------------------------------------------------------------------

def _grid_smooth(cfg, lvl: GridLevel, r, x, b, nu: int):
    if nu <= 0:
        return x
    if cfg.relax_type == "jac-gmres":
        return fgmres_relaxation(lvl.A.matvec, lambda v: lvl.d * v, r, x, nu,
                                 axis_name=cfg.axis_name)
    if cfg.relax_type == "chebyshev":
        from .relax import chebyshev_smooth
        return chebyshev_smooth(lvl.A.matvec, lvl.d, lvl.lam,
                                cfg.cheby_degree * nu, cfg.cheby_frac,
                                r, x, b)
    if cfg.relax_type == "chebyshev4":
        from .relax import chebyshev4_smooth
        return chebyshev4_smooth(lvl.A.matvec, lvl.d, lvl.lam,
                                 cfg.cheby_degree * nu, r, x)
    if cfg.relax_type == "line-jacobi":
        from .relax import line_smooth
        return line_smooth(lvl.A.matvec, lvl.d, r, x, b, nu)
    # jacobi / spai: x += d .* r with the residual refreshed between sweeps
    for _ in range(nu - 1):
        x = x + lvl.d * r
        r = b - lvl.A.matvec(x)
    return x + lvl.d * r


def grid_cycle(cfg, gh: GridHierarchy, b, x, level: int = 0,
               ctype: str | None = None, x_zero: bool = False):
    """One multigrid cycle on grid fields b, x of shape (m, *grid_level).

    `x_zero` (static) declares the incoming iterate to be exactly zero —
    true for EVERY coarse-level entry inside a cycle and for the correction
    cycles of the refined drivers.  The entry residual is then b itself, so
    the r = b - A*0 matvec is skipped (XLA cannot fold A@0: the stencil
    coefficients are runtime arrays).  One matvec saved per level per
    cycle.  Results are bitwise-identical (A@0 is exact zeros;
    tests/test_xzero.py pins it)."""
    ctype = cfg.cycle_type if ctype is None else ctype
    nlev = len(gh.levels)
    if level == nlev - 1:
        return gh.coarse.solve(b)

    lvl = gh.levels[level]
    matvec = lvl.A.matvec
    with jax.named_scope(f"gmg_level{level}"):
        r = b if x_zero else b - matvec(x)
        x = _grid_smooth(cfg, lvl, r, x, b, cfg.nu_pre[level])
        r = b - matvec(x) if cfg.nu_pre[level] > 0 or not x_zero else b
        bc = grid_restrict(r, lvl.P1)
        if level == nlev - 2:
            with jax.named_scope("gmg_coarsest"):
                xc = gh.coarse.solve(bc)
        elif ctype == "K":
            coarse_mv = gh.levels[level + 1].A.matvec
            prec = lambda v: grid_cycle(cfg, gh, v, jnp.zeros_like(v),
                                        level + 1, "K", x_zero=True)
            xc = fgmres_relaxation(coarse_mv, prec, bc, jnp.zeros_like(bc),
                                   cfg.kcycle_inner,
                                   axis_name=cfg.axis_name)
        else:
            xc = grid_cycle(cfg, gh, bc, jnp.zeros_like(bc), level + 1,
                            ctype, x_zero=True)
            if ctype == "W":
                xc = grid_cycle(cfg, gh, bc, xc, level + 1, "W")
            elif ctype == "F":
                xc = grid_cycle(cfg, gh, bc, xc, level + 1, "V")

        x = x + grid_prolong(xc, lvl.P1)
        r = b - matvec(x)
        x = _grid_smooth(cfg, lvl, r, x, b, cfg.nu_post[level])
    return x


@functools.partial(jax.jit, static_argnums=(0, 4))
def grid_cycle_jit(cfg, gh: GridHierarchy, b, x, x_zero: bool = False):
    """Jitted single cycle on grid fields (m, *grid)."""
    return grid_cycle(cfg, gh, b, x, x_zero=x_zero)


def _cubic_prolong_axis(xc, axis: int):
    """1D cubic solution prolongation along `axis` onto the odd fine grid.

    Coarse nodes inject; midpoints interpolate cubically through the four
    nearest coarse nodes ([-1, 9, 9, -1]/16 interior; one-sided
    [5, 15, -5, 1]/16 at the ends; linear when fewer than 4 coarse nodes).
    Classical FMG needs the SOLUTION transferred at higher order than the
    correction transfers to reach discretization accuracy in one pass
    (Brandt); full-weighting's linear midpoints lose two orders."""
    c = xc.shape[axis]
    at = lambda i, j: _sl(xc, axis, i, j)
    if c < 4:
        return _interleave(xc, 0.5 * (at(0, c - 1) + at(1, c)), axis)
    first = (5.0 * at(0, 1) + 15.0 * at(1, 2) - 5.0 * at(2, 3)
             + at(3, 4)) / 16.0
    inner = (9.0 * (at(1, c - 2) + at(2, c - 1))
             - (at(0, c - 3) + at(3, c))) / 16.0
    last = (5.0 * at(c - 1, c) + 15.0 * at(c - 2, c - 1)
            - 5.0 * at(c - 3, c - 2) + at(c - 4, c - 3)) / 16.0
    return _interleave(xc, jnp.concatenate([first, inner, last], axis=axis),
                       axis)


def _cubic_prolong(xc, fine_grid):
    """Per-axis cubic solution prolongation (m, *coarse) -> (m, *fine)."""
    y = xc
    for a, nf in enumerate(fine_grid):
        if y.shape[1 + a] == nf:          # axis not coarsened (semicoarsening)
            continue
        assert nf % 2 == 1 and nf == 2 * y.shape[1 + a] - 1
        y = _cubic_prolong_axis(y, 1 + a)
    return y


def grid_fmg(cfg, gh: GridHierarchy, b, n_cycles: int = 1):
    """Full multigrid (nested iteration): solve coarsest-first, prolongating
    each level's solution as the next finer level's initial guess, with
    `n_cycles` cycles of polishing per level.

    One FMG pass costs ~(1 + 2^-d + 4^-d + ...) cycles.  The SOLUTION moves
    between levels with cubic interpolation (classical FMG requirement —
    with the linear full-weighting prolongation the initial guess only saved
    ~1 refined iteration); corrections inside the polishing cycles keep the
    standard transfers.  The reference has no FMG driver; exposed via
    solve_mg_refined(fmg=True).
    """
    nlev = len(gh.levels)
    bs = [b]
    for l in range(nlev - 1):
        bs.append(grid_restrict(bs[-1], gh.levels[l].P1))
    x = gh.coarse.solve(bs[-1])
    for l in range(nlev - 2, -1, -1):
        fine_grid = gh.levels[l].A.grid
        if isinstance(gh.levels[l].P1, FWTransfer):
            x = _cubic_prolong(x, fine_grid)
        else:
            x = grid_prolong(x, gh.levels[l].P1)   # matrix-dependent: keep
        for _ in range(n_cycles):
            x = grid_cycle(cfg, gh, bs[l], x, level=l)
    return x


def grid_cycle_flat(cfg, gh: GridHierarchy, b2, x2, ctype: str | None = None,
                    x_zero: bool = False):
    """Flat (n, m) boundary adapter around grid_cycle."""
    grid = gh.fine_grid
    xg = grid_cycle(cfg, gh, flat_to_grid(b2, grid), flat_to_grid(x2, grid),
                    0, ctype, x_zero=x_zero)
    return grid_to_flat(xg)


# ---------------------------------------------------------------------------
# construction from a host hierarchy
# ---------------------------------------------------------------------------

_GRID_RELAX = ("jacobi", "spai", "jac-gmres", "chebyshev", "chebyshev4",
               "line-jacobi")
_DENSE_INV_MAX = 16384
_HOST_INV_MAX = 4096      # host f64 inverse (pinv-safe) below this
# replicated-dense budget: 20480^2 f32 = 1.7 GB for the factor; the old
# 32768 cap meant a 4.3 GB inverse with ~13 GB LU transients
_DENSE_LU_MAX = 20480


def _checked_inverse(Ad: np.ndarray) -> np.ndarray:
    """Plain inverse with a residual check, pseudo-inverse fallback.

    Neumann-type operators reach the coarsest level exactly singular
    (constant nullspace) and need the minimal-norm pinv; for the regular
    (shifted) case LU inversion is ~10x cheaper than the SVD."""
    n = Ad.shape[0]
    try:
        with np.errstate(all="ignore"):
            inv = np.linalg.inv(Ad)
        # kappa ~ |A| |A^-1| must be far from 1/eps, else the nullspace
        # (e.g. Neumann constants) leaks huge components into the inverse
        # and only the minimal-norm pinv is safe
        kappa = float(np.abs(Ad).max()) * float(np.abs(inv).max()) * n
        # residual check on a column sample (a full n^3 check would cost as
        # much as the inversion itself at SA coarse sizes)
        cols = (np.arange(n) if n <= 512
                else np.random.RandomState(0).choice(n, 256, replace=False))
        eye = np.zeros((n, len(cols)), dtype=Ad.dtype)
        eye[cols, np.arange(len(cols))] = 1.0
        err = float(np.abs(Ad @ inv[:, cols] - eye).max())
        if np.isfinite(inv).all() and kappa < 1e12 and err < 1e-6:
            return inv
    except np.linalg.LinAlgError:
        pass
    return np.linalg.pinv(Ad, rcond=1e-12)


def build_grid_hierarchy(state, relax_states) -> GridHierarchy:
    """Build the grid engine for an MGState when eligible; raises ValueError
    otherwise (callers fall back to the flat ELL/DIA hierarchy)."""
    cfg = state.config
    if cfg.transfer_type not in ("full-weighting", "semicoarsening"):
        raise ValueError("grid engine needs scalar full-weighting or "
                         "semicoarsening transfers")
    if cfg.relax_type not in _GRID_RELAX:
        raise ValueError("grid engine supports pointwise relaxations only")
    if not state.meshes or len(state.meshes) < state.num_levels:
        raise ValueError("grid engine needs per-level meshes")
    if cfg.coarse_solve not in ("lu", "gmres") or state.coarse_solver is not None:
        raise ValueError("grid engine supports lu/gmres coarsest solves")

    from ..setup import transfers as tr

    gs_cache = getattr(state, "_gs_cache", None) or {}
    levels = []
    for l in range(state.num_levels):
        mesh = state.meshes[l]
        nodes = [int(v) + 1 for v in np.asarray(mesh.n).ravel()]
        gs_host = gs_cache.get(l)
        if gs_host is not None and gs_host.grid == tuple(reversed(nodes)):
            # stencil-form coefficients already produced by the structured
            # RAP at setup — skip the CSR re-extraction
            from ..ops.grid_stencil import compress_grid_stencil, GridStencil
            gnp = GridStencil(np.asarray(gs_host.coeff, dtype=cfg.dtype),
                              gs_host.offsets, gs_host.grid)
            A = compress_grid_stencil(gnp)
            if A is None:
                A = GridStencil(jnp.asarray(gnp.coeff), gnp.offsets, gnp.grid)
        else:
            A = make_grid_stencil(state.As[l], nodes, dtype=cfg.dtype)
        d = None
        P1 = None
        if l < state.num_levels - 1:
            from ..setup.hierarchy import _resolve_relax
            rs = _resolve_relax(relax_states[l])
            from .relax import LineRelax, AltLineRelax
            if isinstance(rs, (LineRelax, AltLineRelax)):
                d = rs                       # line state rides in the d slot
            elif hasattr(rs, "d"):
                d = jnp.asarray(rs.d).reshape(A.grid)
            else:
                raise ValueError("grid engine needs a diagonal relax state")
            # per-axis 1D full-weighting factors; verify their Kronecker
            # product is exactly the hierarchy's stored prolongation so the
            # matrix-free transfers are faithful to the host setup
            # (mg_setup's own full-weighting transfers are these factors BY
            # construction — the kron re-assembly is skipped for them, it is
            # the dominant 3D setup cost).  Under semicoarsening an axis
            # whose extent does not shrink is not coarsened.
            nodes_c = [int(v) + 1
                       for v in np.asarray(state.meshes[l + 1].n).ravel()]
            p1s = [tr.fw_interp_1d(nn)[0] if nn != ncn else None
                   for nn, ncn in zip(nodes, nodes_c)]
            if not getattr(state, "_fw_separable", False):
                K = None
                for ax, pm in enumerate(p1s):
                    if pm is None:
                        pm = sp.identity(nodes[ax], format="csr")
                    K = pm if K is None else sp.kron(pm, K, format="csr")
                # shape check first: scipy's != returns a plain bool for
                # mismatched shapes, which has no .nnz — the ValueError must
                # still fire so the flat-engine fallback engages
                if (K.shape != state.Ps[l].shape
                        or (K != state.Ps[l]).nnz != 0):
                    raise ValueError("hierarchy transfers are not the "
                                     "separable full-weighting factors")
            P1 = FWTransfer(tuple(None if p is None else nn
                                  for p, nn in zip(reversed(p1s),
                                                   reversed(nodes))))
            lam = getattr(rs, "lam_max", None)
        else:
            lam = None
        levels.append(GridLevel(A, d, P1, lam))

    A_c = state.As[-1]
    grid_c = levels[-1].A.grid
    if cfg.coarse_solve == "gmres":
        rp = state.relax_param
        omega = rp if np.isscalar(rp) else 1.0
        d_c = jnp.asarray((omega / A_c.diagonal()).astype(cfg.dtype)
                          ).reshape(grid_c)
        coarse = GridIterativeCoarse(levels[-1].A, d_c,
                                     cfg.gmres_coarse_inner)
    elif A_c.shape[0] <= _HOST_INV_MAX:
        # Invert at float64 on host, then cast (f64 factorization error is far
        # below the f32 storage rounding).  Neumann-type operators reach the
        # coarsest level exactly singular (constant nullspace); a plain
        # inverse of those sprays rounding into all directions, so use the
        # pseudo-inverse (minimal-norm coarse solve) when affordable — in the
        # cycle the inverse is ONE matmul, the cheapest coarse application.
        Ad = np.asarray(A_c.astype(
            np.complex128 if np.iscomplexobj(A_c.data) else np.float64
        ).todense())
        inv = _checked_inverse(Ad)
        coarse = DenseInverse(jnp.asarray(inv.astype(cfg.dtype)), grid_c)
    elif A_c.shape[0] > _DENSE_LU_MAX:
        # beyond the replicated-dense budget (O(nc^2) device memory):
        # host SuperLU behind the same solve() protocol
        from scipy.sparse.linalg import splu
        fdt = np.complex128 if np.iscomplexobj(A_c.data) else np.float64
        coarse = GridSparseLU(splu(A_c.tocsc().astype(fdt)), tuple(grid_c))
    else:
        # large coarsest: device-built inverse (LU + n-RHS solve on
        # the device) — no O(nc^3) host inversion
        coarse = grid_dense_inverse_from_scipy(A_c, grid_c, cfg.dtype)
    return GridHierarchy(tuple(levels), coarse)
