"""Operand-layout abstraction for the Krylov methods.

Two layouts:
 * legacy columns: operands are (n,) / (n, m) with RHS on axis 1 — the
   reference's KrylovMethods convention.
 * leading batch: operands are (m, *space) with the RHS batch first and the
   spatial axes free to be grid fields.  The grid multigrid
   engine runs Krylov solves in this layout so that its grid fields never
   pay a flat (n, m) <-> grid transpose inside the iteration.

All per-RHS scalars (alpha, beta, rho, residual norms) are (m,) in both
layouts.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..config import HIGHEST


class Layout:
    """dot/norm/scale over the spatial axes of one operand layout."""

    def __init__(self, B, batch_leading: bool):
        self.batch_leading = batch_leading
        if batch_leading:
            self.nbatch = B.shape[0]
            self._axes = tuple(range(1, B.ndim))
            self._expand = (slice(None),) + (None,) * (B.ndim - 1)
        else:
            self.nbatch = B.shape[1]
            self._axes = (0,)
            self._expand = (None, slice(None))

    def dot(self, a, b):
        """Per-RHS inner product <a, b> -> (m,)."""
        return jnp.sum(a.conj() * b, axis=self._axes)

    def norm(self, a):
        """Per-RHS 2-norm -> (m,) real."""
        return jnp.sqrt(jnp.real(jnp.sum(a.conj() * a, axis=self._axes)))

    def scale(self, v, s):
        """v * s with s (m,) broadcast over the spatial axes."""
        return v * s[self._expand]

    # -- block (shared-Krylov-space) primitives --------------------------
    def gram(self, a, b):
        """Block inner product a^H b -> (m, m)."""
        if self.batch_leading:
            af = a.reshape(self.nbatch, -1)
            bf = b.reshape(self.nbatch, -1)
            return jnp.matmul(af.conj(), bf.T, precision=HIGHEST)
        return jnp.matmul(a.conj().T, b, precision=HIGHEST)

    def mix(self, v, S):
        """Column mixing: sum_i v_i S[i, j] -> j-th output RHS.

        The m x m coefficient matrices of block Krylov methods act on the
        RHS axis; spatially this is one skinny matmul."""
        if self.batch_leading:
            vf = v.reshape(self.nbatch, -1)
            return jnp.matmul(S.T, vf, precision=HIGHEST).reshape(v.shape)
        return jnp.matmul(v, S, precision=HIGHEST)
