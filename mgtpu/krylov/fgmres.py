"""(Flexible) restarted GMRES (device inner cycle, jittable; batched RHS).

Replaces KrylovMethods.fgmres/blockFGMRES used by the reference drivers
(reference: src/Multigrid/SolveFuncs.jl:120-133, MGcycle.jl:152-168).

Design: the inner Arnoldi cycle of `restart` steps is statically unrolled and
compiles to one XLA program (restart is small: 2-10 for MG-preconditioned
solves); the outer restart loop runs on host with one device sync per restart,
mirroring how the reference drives its host-side Krylov package around the
device cycle.  Right preconditioning: flexible stores Z_i = M(v_i) and
corrects with Z y; non-flexible corrects with M(V y).

Multiple right-hand sides come in two flavors, like the reference:
 * batched (default): independent per-column Arnoldi recurrences, vectorised.
 * block_fgmres: the reference's block-diagonal trick (FGMRES.jl:51-53) —
   the m RHS share one Krylov space over the flattened n*m system.

Operands are legacy (n, m) columns or leading-batch (m, *space) fields with
`batch_leading=True` (see krylov._layout).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HIGHEST
from ._layout import Layout


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _fgmres_cycle(matvec, prec, restart: int, batch_leading: bool, X, B):
    """One restart cycle for all columns; returns updated X and residuals."""
    lay = Layout(B, batch_leading)
    m = lay.nbatch
    R = B - matvec(X)
    beta = lay.norm(R)
    inv_beta = 1.0 / jnp.where(beta == 0, 1, beta)
    V = [lay.scale(R, inv_beta.astype(B.dtype))]
    Z = []
    H = jnp.zeros((restart + 1, restart, m), dtype=B.dtype)
    for i in range(restart):
        z = prec(V[i])
        Z.append(z)
        w = matvec(z)
        # modified Gram-Schmidt, batched per column
        for l in range(i + 1):
            h = lay.dot(V[l], w)
            H = H.at[l, i].set(h)
            w = w - lay.scale(V[l], h)
        hnorm = lay.norm(w)
        H = H.at[i + 1, i].set(hnorm.astype(B.dtype))
        inv_h = (1.0 / jnp.where(hnorm == 0, 1, hnorm)).astype(B.dtype)
        V.append(lay.scale(w, inv_h))
    # least squares min || beta e1 - H y || per column
    Hb = jnp.transpose(H, (2, 0, 1))                      # (m, k+1, k)
    e1 = jnp.zeros((m, restart + 1), dtype=B.dtype).at[:, 0].set(
        beta.astype(B.dtype))
    # normal equations on the small (k+1) x k system, regularised pinv
    G = jnp.einsum("mki,mkj->mij", Hb.conj(), Hb, precision=HIGHEST)
    c = jnp.einsum("mki,mk->mi", Hb.conj(), e1, precision=HIGHEST)
    # pinv tolerates happy breakdown (rank-deficient H on exact convergence)
    y = jnp.einsum("mij,mj->mi", jnp.linalg.pinv(G, rtol=1e-12), c,
                   precision=HIGHEST)
    Zs = jnp.stack(Z, axis=-1)
    if batch_leading:
        X = X + jnp.einsum("m...k,mk->m...", Zs, y, precision=HIGHEST)
    else:
        X = X + jnp.einsum("nmk,mk->nm", Zs, y, precision=HIGHEST)
    Rn = B - matvec(X)
    return X, lay.norm(Rn)


def fgmres(matvec, b, restart: int = 5, prec=None, x0=None, tol: float = 1e-6,
           max_iter: int = 10, flexible: bool = True, verbose: bool = False,
           batch_leading: bool = False):
    """Restarted (F)GMRES: max_iter outer restarts of `restart` inner steps."""
    squeeze = b.ndim == 1 and not batch_leading
    B = b[:, None] if squeeze else b
    X = (jnp.zeros_like(B) if x0 is None
         else (x0[:, None] if squeeze else x0))
    M = (lambda r: r) if prec is None else prec
    lay = Layout(B, batch_leading)
    if not flexible:
        # right-preconditioned standard GMRES: solve (A M) u = r, x += M u.
        # Closures built once so the jitted inner cycle is traced once.
        prec_mv = lambda v: matvec(M(v))
        identity = lambda v: v

    bnorm = float(jnp.max(lay.norm(B)))
    bnorm = max(bnorm, 1e-300)
    resvec = [np.asarray(lay.norm(B - matvec(X)))]
    iters = 0
    for outer in range(max_iter):
        if flexible:
            X, rn = _fgmres_cycle(matvec, M, restart, batch_leading, X, B)
        else:
            Xp, rn = _fgmres_cycle(prec_mv, identity, restart, batch_leading,
                                   jnp.zeros_like(X), B - matvec(X))
            X = X + M(Xp)
            rn = lay.norm(B - matvec(X))
        iters += 1
        resvec.append(np.asarray(rn))
        rel = float(jnp.max(rn)) / bnorm
        if verbose:
            print(f"fgmres restart {outer + 1}: relres {rel:.3e}")
        if rel < tol:
            break
    info = {"iters": iters, "relres": rel, "resvec": np.array(resvec)}
    return (X[:, 0] if squeeze else X), info


def block_fgmres(matvec, b, restart: int = 5, prec=None, x0=None,
                 tol: float = 1e-6, max_iter: int = 10, flexible: bool = True,
                 verbose: bool = False, batch_leading: bool = False):
    """Block FGMRES via the reference's flattened block-diagonal system trick
    (FGMRES.jl:51-53): all RHS share a single Krylov space of n*m vectors."""
    if batch_leading:
        # the whole (m, *space) field is ONE Krylov vector: batch of size 1
        def blk_mv(v):
            return matvec(v[0])[None]
        blk_prec = None if prec is None else (lambda v: prec(v[0])[None])
        x0b = None if x0 is None else x0[None]
        xb, info = fgmres(blk_mv, b[None], restart, blk_prec, x0b,
                          tol, max_iter, flexible, verbose, batch_leading=True)
        return xb[0], info

    n, m = b.shape

    def flat_mv(v):
        return matvec(v.reshape(n, m)).reshape(n * m, -1)

    flat_prec = None
    if prec is not None:
        flat_prec = lambda v: prec(v.reshape(n, m)).reshape(n * m, -1)
    x0f = None if x0 is None else x0.reshape(n * m, 1)
    xf, info = fgmres(flat_mv, b.reshape(n * m, 1), restart, flat_prec, x0f,
                      tol, max_iter, flexible, verbose)
    return xf.reshape(n, m), info
