"""Pointwise relaxation and FGMRES-accelerated smoothing (device, jittable).

Equivalents of the reference's `relax` sweep (src/Multigrid/MGcycle.jl:122-136)
and the preallocated-memory `FGMRES_relaxation` used both as the "Jac-GMRES"
smoother and as the K-cycle accelerator (src/Multigrid/FGMRES.jl:40-126).

The reference's FGMRES_relaxation builds the Krylov basis
Z = [M r0, (M A) M r0, (M A)^2 M r0, ...] and minimises ||r0 - A Z t|| through
a symmetrised normal-equations projection solved with pinv.  Here the same
subspace is built with a statically unrolled loop (inner is small: 1-2 for
smoothing, 2 for K-cycles, 10 for the iterative coarsest solve) and the
projection is solved in one shot — mathematically identical, jit-friendly, and
free of the reference's per-step early exit (which only triggers at residuals
far below smoothing tolerances).

Multiple right-hand sides use the reference's block-diagonal trick
(FGMRES.jl:51-53): the m RHS are flattened into one n*m system sharing a
single Krylov subspace.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..config import HIGHEST


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["d"], meta_fields=[])
@dataclass(frozen=True)
class DiagRelax:
    """Damped Jacobi / SPAI(0) diagonal preconditioner: x += d .* r."""
    d: jax.Array  # (n,)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["d"], meta_fields=["lam_max"])
@dataclass(frozen=True)
class ChebyshevRelax:
    """Chebyshev polynomial smoother state: Jacobi diagonal + spectral bound.

    A smoother the reference does not have: a degree-k Chebyshev
    polynomial in D^-1 A damps the upper spectrum [frac*lam, lam] far more per
    matvec than damped Jacobi, uses NO dot products (no psum in the sharded
    cycle), and keeps the whole cycle a fixed linear operator (CG-safe,
    unlike the Jac-GMRES smoother)."""
    d: jax.Array        # (n,) inverse diagonal (undamped)
    lam_max: float      # upper bound on spec(D^-1 A), with safety factor


def chebyshev4_smooth(matvec, d, lam_max, degree: int, r, x):
    """Fourth-kind Chebyshev smoothing (Lottes; see "Optimal Polynomial
    Smoothers for Parallel AMG", arXiv:2407.09848): damps the whole interval
    (0, lam_max] with no lower-bound parameter — unlike the first-kind
    recurrence there is no `frac` to tune.  One matvec per degree; `r` is the
    incoming residual b - A x.
    """
    z = (4.0 / (3.0 * lam_max)) * (d * r)
    x = x + z
    for k in range(2, degree + 1):
        r = r - matvec(z)
        z = ((2.0 * k - 3.0) / (2.0 * k + 1.0)) * z + \
            ((8.0 * k - 4.0) / ((2.0 * k + 1.0) * lam_max)) * (d * r)
        x = x + z
    return x


def chebyshev_smooth(matvec, d, lam_max, degree: int, frac: float,
                     r, x, b):
    """Degree-`degree` Chebyshev smoothing on [frac*lam, 1.02*lam].

    Saad, Iterative Methods, Alg. 12.1, with M = D^-1 folded in; `r` is the
    incoming residual b - A x (callers have it), so each degree costs exactly
    one matvec.  Shapes: grid fields or (n, m) columns — `d` must broadcast.
    """
    lo = frac * lam_max
    hi = 1.02 * lam_max
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    p = (1.0 / theta) * (d * r)
    x = x + p
    for _ in range(degree - 1):
        r = b - matvec(x)
        w = d * r
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        p = (rho_new * rho) * p + (2.0 * rho_new / delta) * w
        x = x + p
        rho = rho_new
    return x


def relax_diag(matvec, r, x, b, d, num_it: int):
    """num_it sweeps of x += d.*r with the residual refreshed between sweeps.

    The residual is NOT refreshed after the final sweep (callers recompute),
    matching the reference sweep structure.
    """
    dcol = d[:, None] if x.ndim == 2 else d
    for _ in range(num_it - 1):
        x = x + dcol * r
        r = b - matvec(x)
    return x + dcol * r


def normal_equations(AZ, r):
    """Gram matrix AZ^H AZ and projection AZ^H r of a minimal-residual
    step, at full f32 precision."""
    AZh = AZ.conj().T
    return (jnp.matmul(AZh, AZ, precision=HIGHEST),
            jnp.matmul(AZh, r, precision=HIGHEST))


def fgmres_relaxation(matvec, prec, r0, x0, inner: int,
                      axis_name: str | None = None):
    """Minimal-residual correction over the preconditioned Krylov subspace.

    Returns x0 + Z t where t = argmin ||r0 - (A Z) t||_2 over the flattened
    n*m block system.  `prec` is applied to r0 first, then to each successive
    A z (reference FGMRES.jl:82-95).

    `axis_name`: when the operands are PARTITIONED row blocks inside a
    shard_map region (parallel/part_amg.py), the Gram matrix G = (AZ)^H AZ
    and projection RHS c = (AZ)^H r0 are per-device partial sums; a psum
    over the mesh axis restores the global inner products, so every device
    solves the identical (inner x inner) projection and the correction
    matches the single-chip algebra to reduction-order rounding.  Padded
    rows contribute exact zeros (zero matrix rows, zero RHS).
    """
    # operands may be plain arrays or pytrees of per-component fields (the
    # systems engine's block fields); ravel_pytree makes the Krylov algebra
    # layout-agnostic and is a plain reshape for the array case
    from jax.flatten_util import ravel_pytree
    r0f, unravel = ravel_pytree(r0)
    zs, azs = [], []
    w = r0
    for j in range(inner):
        z = prec(r0 if j == 0 else w)
        w = matvec(z)
        zs.append(ravel_pytree(z)[0])
        azs.append(ravel_pytree(w)[0])
    Z = jnp.stack(zs, axis=1)      # (n*m, inner)
    AZ = jnp.stack(azs, axis=1)    # (n*m, inner)
    G, c = normal_equations(AZ, r0f)
    if axis_name is not None:      # partitioned rows: globalise the Gram
        G = jax.lax.psum(G, axis_name)
        c = jax.lax.psum(c, axis_name)
    # Tikhonov-regularised Hermitian solve instead of pinv: numerically
    # equivalent for this PSD Gram system (the regularisation damps exactly
    # the directions pinv's rtol would truncate) and free of an SVD inside
    # the refinement `lax.while_loop` (reference FGMRES.jl:95 uses pinv on
    # the host).
    k = G.shape[0]
    reg = (8 * k) * jnp.finfo(G.dtype).eps * (jnp.trace(G).real / k + 1e-30)
    t = jnp.linalg.solve(G + reg * jnp.eye(k, dtype=G.dtype), c)
    corr = unravel(jnp.matmul(Z, t, precision=HIGHEST))
    return jax.tree_util.tree_map(lambda a, b: a + b, x0, corr)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["alpha", "pivot", "cprime"],
                   meta_fields=["axis", "omega"])
@dataclass(frozen=True)
class LineRelax:
    """Damped line-Jacobi smoother state: x += omega * T^-1 r, with T the
    tridiagonal part of A along one grid axis.

    Point smoothers stall on anisotropic operators (eps*u_xx + u_yy under
    full coarsening); solving whole lines along the strong axis restores
    h-independent smoothing.  The reference has no line smoother.

    Parallel solve: the Thomas factorisation is sequential, but its PIVOTS
    depend only on the matrix, so they are precomputed on host at setup;
    per application only first-order LINEAR recurrences remain, which run as
    log-depth doubling scans along the line axis (_scan_linear):
        forward:  y_i = alpha_i y_{i-1} + pivot_i r_i
        backward: x_i = y_i - cprime_i x_{i+1}

    alpha  = -pivot * sub   (grid-shaped, zero at line starts)
    pivot  = 1 / (diag - sub * cprime_{i-1})
    cprime = super * pivot  (zero at line ends)
    axis   = grid axis of the lines; omega = damping.
    """
    alpha: jax.Array
    pivot: jax.Array
    cprime: jax.Array
    axis: int
    omega: float


def _shifted(v, d, axis, reverse, fill):
    """Element i-d (forward) or i+d (reverse) of v, out-of-range -> fill.

    Pure static pad+slice: XLA fuses it into the surrounding elementwise
    work."""
    n = v.shape[axis]
    pads = [(0, 0)] * v.ndim
    pads[axis] = (0, d) if reverse else (d, 0)
    vp = jnp.pad(v, pads, constant_values=fill)
    idx = [slice(None)] * v.ndim
    idx[axis] = slice(d, d + n) if reverse else slice(0, n)
    return vp[tuple(idx)]


def _scan_linear(alpha, beta, axis, reverse=False):
    """y_i = alpha_i y_{i-1} + beta_i along `axis` (reverse: i+1 -> i).

    Hillis-Steele doubling with STATIC shifted adds: after step d, element
    i carries the recurrence composed over the last 2d terms; log2(n)
    steps of (2 mul + 1 fma) full-array passes, expressed as pad/slice +
    elementwise in the stencil layout so XLA keeps one layout end to end
    and fuses the chain."""
    n = alpha.shape[axis]
    a, y = alpha, beta
    d = 1
    while d < n:
        a_prev = _shifted(a, d, axis, reverse, 1)
        y_prev = _shifted(y, d, axis, reverse, 0)
        y = a * y_prev + y
        a = a * a_prev
        d *= 2
    return y


def line_solve(lr: LineRelax, r):
    """T^-1 r for grid fields r of shape (.., *grid)."""
    ax = r.ndim - (lr.alpha.ndim - lr.axis)
    beta = lr.pivot * r
    y = _scan_linear(jnp.broadcast_to(lr.alpha, beta.shape), beta, ax)
    return _scan_linear(jnp.broadcast_to(-lr.cprime, y.shape), y, ax,
                        reverse=True)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["lines"], meta_fields=[])
@dataclass(frozen=True)
class AltLineRelax:
    """Alternating-direction line Jacobi: one damped T_axis^-1 correction
    per grid axis per smoothing step, residual refreshed between
    directions (ADI-style smoothing, Brandt's guide §3.3).

    A SINGLE line axis (or one semicoarsening axis) only helps where that
    axis carries the strong coupling; operators whose anisotropy direction
    varies over the domain (e.g. a(x)*u_xx + u_yy with a jumping 100 ->
    0.01) stall under either.  Alternating over all grid axes smooths every
    region along its own strong direction.  The reference has no line
    smoothers at all."""
    lines: tuple  # one LineRelax per grid axis


def line_smooth(matvec, lr, r, x, b, nu: int):
    """nu sweeps of x += omega * T^-1 r with refreshed residuals.

    `lr` is a LineRelax (one axis) or AltLineRelax (cycle through all
    axes each sweep).  The residual is NOT refreshed after the final
    correction (callers recompute), matching relax_diag's contract."""
    corrs = lr.lines if isinstance(lr, AltLineRelax) else (lr,)
    steps = [c for _ in range(nu) for c in corrs]
    if not steps:                      # nu == 0: total, like relax_diag
        return x
    for c in steps[:-1]:
        x = x + c.omega * line_solve(c, r)
        r = b - matvec(x)
    return x + steps[-1].omega * line_solve(steps[-1], r)
