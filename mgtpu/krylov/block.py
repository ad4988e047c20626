"""Shared-Krylov-space block CG and block BiCGSTAB (device, jittable).

The reference dispatches multi-RHS solves to KrylovMethods.blockCG /
blockBiCGSTB (reference src/Multigrid/SolveFuncs.jl:91-96,109-114,126-131):
all right-hand sides share ONE Krylov space, so information gathered for any
column accelerates every column — fewer iterations than the independent
batched recurrences in krylov.cg / krylov.bicgstab whenever the RHS are
related, at the price of m x m Gram solves per iteration.

Shape: the m x m coefficient blocks (alpha, beta) act on the RHS axis —
each application is one skinny matmul (Layout.mix), and the Gram matrices
are (m, n) @ (n, m) contractions, all at full f32 precision.  The m x m solves use a
Tikhonov-guarded explicit solve (converged/dependent columns make the Gram
blocks singular; the guard is the block analog of per-column freezing).

 * block_pcg       — O'Leary block CG (D. O'Leary, LAA 29, 1980).
 * block_bicgstab  — Bl-BiCGSTAB (El Guennouni, Jbilou, Sadok, ETNA 16,
                     2003), preconditioner applied in the same positions as
                     krylov.bicgstab.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ._layout import Layout

__all__ = ["block_pcg", "block_bicgstab"]


def _guarded_solve(G, Y):
    """Solve G S = Y for the m x m coefficient block, with a relative ridge
    so converged (near-dependent) columns do not blow up the block step."""
    m = G.shape[0]
    scale = jnp.maximum(jnp.max(jnp.abs(G)), 1e-300)
    eps = jnp.asarray(1e-7 if G.dtype in (jnp.complex64, jnp.float32)
                      else 1e-14, dtype=jnp.real(G).dtype)
    Gr = G + (eps * scale) * jnp.eye(m, dtype=G.dtype)
    return jnp.linalg.solve(Gr, Y)


def block_pcg(matvec, b, prec=None, x0=None, tol: float = 1e-6,
              max_iter: int = 100, batch_leading: bool = False):
    """Block preconditioned CG: solve A X = B (A HPD) with one shared space.

    b: (n, m) or (m, *space) with batch_leading.  Returns (x, info) with
    info = dict(iters, relres (m,), resvec (max_iter+1, m)).
    """
    B = b
    X0 = jnp.zeros_like(B) if x0 is None else x0
    M = (lambda r: r) if prec is None else prec
    lay = Layout(B, batch_leading)

    bnorm = jnp.maximum(lay.norm(B), 1e-300)
    R0 = B - matvec(X0)
    Z0 = M(R0)
    P0 = Z0
    S0 = lay.gram(R0, Z0)
    resvec = jnp.zeros((max_iter + 1, lay.nbatch), dtype=bnorm.dtype)
    resvec = resvec.at[0].set(lay.norm(R0))

    def cond(state):
        k, X, R, P, S, resvec = state
        return jnp.logical_and(k < max_iter,
                               jnp.max(resvec[k] / bnorm) >= tol)

    def body(state):
        k, X, R, P, S, resvec = state
        Q = matvec(P)
        alpha = _guarded_solve(lay.gram(P, Q), S)
        X = X + lay.mix(P, alpha)
        R = R - lay.mix(Q, alpha)
        resvec = resvec.at[k + 1].set(lay.norm(R))
        Z = M(R)
        S_new = lay.gram(R, Z)
        beta = _guarded_solve(S, S_new)
        P = Z + lay.mix(P, beta)
        return (k + 1, X, R, P, S_new, resvec)

    k, X, *_r, resvec = jax.lax.while_loop(
        cond, body, (0, X0, R0, P0, S0, resvec))
    info = {"iters": k, "relres": resvec[k] / bnorm, "resvec": resvec}
    return X, info


def block_bicgstab(matvec, b, prec=None, x0=None, tol: float = 1e-6,
                   max_iter: int = 100, batch_leading: bool = False):
    """Bl-BiCGSTAB: solve A X = B (general A) with one shared block space.

    Same preconditioning positions as krylov.bicgstab (M applied to the
    search block and the stabilisation block); omega is the scalar
    trace-minimising stabilisation of the block variant.
    """
    B = b
    X0 = jnp.zeros_like(B) if x0 is None else x0
    M = (lambda r: r) if prec is None else prec
    lay = Layout(B, batch_leading)

    bnorm = jnp.maximum(lay.norm(B), 1e-300)
    R0 = B - matvec(X0)
    Rhat = R0
    P0 = R0
    resvec = jnp.zeros((max_iter + 1, lay.nbatch), dtype=bnorm.dtype)
    resvec = resvec.at[0].set(lay.norm(R0))

    def cond(state):
        k, X, R, P, resvec = state
        return jnp.logical_and(k < max_iter,
                               jnp.max(resvec[k] / bnorm) >= tol)

    def body(state):
        k, X, R, P, resvec = state
        Ph = M(P)
        V = matvec(Ph)
        G = lay.gram(Rhat, V)
        alpha = _guarded_solve(G, lay.gram(Rhat, R))
        S = R - lay.mix(V, alpha)
        Sh = M(S)
        T = matvec(Sh)
        ts = jnp.sum(T.conj() * S)
        tt = jnp.maximum(jnp.real(jnp.sum(T.conj() * T)), 1e-300)
        omega = ts / tt
        X = X + lay.mix(Ph, alpha) + omega * Sh
        R = S - omega * T
        resvec = resvec.at[k + 1].set(lay.norm(R))
        beta = _guarded_solve(G, -lay.gram(Rhat, T))
        P = R + lay.mix(P - omega * V, beta)
        return (k + 1, X, R, P, resvec)

    k, X, *_r, resvec = jax.lax.while_loop(
        cond, body, (0, X0, R0, P0, resvec))
    info = {"iters": k, "relres": resvec[k] / bnorm, "resvec": resvec}
    return X, info
