"""Preconditioned conjugate gradients (device, jittable, batched RHS).

Replaces the reference's outer dependency on KrylovMethods.cg/blockCG
(reference: src/Multigrid/SolveFuncs.jl:103-116).  Multiple right-hand sides
are solved as independent batched recurrences: every scalar of classical PCG
(alpha, beta, rho) becomes a per-column vector, which vectorises perfectly on
the VPU.  Converged columns are frozen by masking, so the loop is a single
`lax.while_loop` with no host synchronisation.

Operand layouts (see krylov._layout): legacy (n, m) columns, or leading-batch
(m, *space) fields with `batch_leading=True` — the grid engine's native
form.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ._layout import Layout


def _safe_div(num, den):
    return num / jnp.where(den == 0, 1, den)


def pcg(matvec, b, prec=None, x0=None, tol: float = 1e-6, max_iter: int = 100,
        batch_leading: bool = False):
    """Solve A x = b (A HPD) with preconditioned CG.

    b: (n,), (n, m), or (m, *space) with batch_leading.  Returns (x, info)
    with info = dict(iters, relres (m,), resvec (max_iter+1, m)).
    """
    squeeze = b.ndim == 1 and not batch_leading
    B = b[:, None] if squeeze else b
    X0 = (jnp.zeros_like(B) if x0 is None
          else (x0[:, None] if squeeze else x0))
    M = (lambda r: r) if prec is None else prec
    lay = Layout(B, batch_leading)

    X, resvec, iters = _pcg_loop(matvec, M, B, X0, tol, max_iter, lay)
    bnorm = jnp.maximum(lay.norm(B), 1e-300)
    info = {"iters": iters, "relres": resvec[iters] / bnorm, "resvec": resvec}
    return (X[:, 0] if squeeze else X), info


def _pcg_loop(matvec, M, B, X0, tol, max_iter, lay):
    bnorm = jnp.maximum(lay.norm(B), 1e-300)
    R0 = B - matvec(X0)
    Z0 = M(R0)
    P0 = Z0
    rz0 = lay.dot(R0, Z0)
    resvec = jnp.zeros((max_iter + 1, lay.nbatch), dtype=bnorm.dtype)
    resvec = resvec.at[0].set(lay.norm(R0))

    def cond(state):
        k, X, R, Z, P, rz, resvec, active = state
        return jnp.logical_and(k < max_iter, jnp.any(active))

    def body(state):
        k, X, R, Z, P, rz, resvec, active = state
        AP = matvec(P)
        alpha = _safe_div(rz, lay.dot(P, AP))
        alpha = jnp.where(active, alpha, 0)
        X = X + lay.scale(P, alpha)
        R = R - lay.scale(AP, alpha)
        rn = lay.norm(R)
        resvec = resvec.at[k + 1].set(rn)
        active = jnp.logical_and(active, rn / bnorm >= tol)
        Z = M(R)
        rz_new = lay.dot(R, Z)
        beta = jnp.where(active, _safe_div(rz_new, rz), 0)
        P = Z + lay.scale(P, beta)
        return (k + 1, X, R, Z, P, rz_new, resvec, active)

    active0 = resvec[0] / bnorm >= tol
    k, X, *_rest, resvec, _ = jax.lax.while_loop(
        cond, body, (0, X0, R0, Z0, P0, rz0, resvec, active0))
    return X, resvec, k
