"""Double-single (two-float32) residual arithmetic (ops/df32.py).

The refinement driver certifies 1e-8 from an f32 hierarchy, without jax
x64, through a compensated two-f32 fine residual.  These tests pin the
error-free transforms and the full residual against numpy float64.
"""
import numpy as np
import jax.numpy as jnp
import scipy.sparse as sp

from mgtpu import get_regular_mesh, get_mg_param, mg_setup
from mgtpu.models.operators import (nodal_laplacian_matrix,
                                    nodal_div_sig_grad_matrix)
from mgtpu.ops.df32 import (two_sum, two_prod, df_const_from_csr,
                            df_residual, df_accumulate)


def _split64(v):
    hi = np.asarray(v, np.float64).astype(np.float32)
    lo = (np.asarray(v, np.float64) - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def test_error_free_transforms():
    rng = np.random.RandomState(3)
    a = (rng.rand(512).astype(np.float32) * 4e6).astype(np.float32)
    b = rng.rand(512).astype(np.float32)
    s, e = two_sum(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) + b.astype(np.float64)
    assert np.abs((np.asarray(s, np.float64) + np.asarray(e, np.float64))
                  - exact).max() == 0.0
    p, pe = two_prod(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    assert np.abs((np.asarray(p, np.float64) + np.asarray(pe, np.float64))
                  - exact).max() == 0.0


def test_df_residual_matches_f64():
    n = 24
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    # non-f32-representable coefficients (variable sigma would break the
    # const-interior structure; use an irrational diagonal shift instead)
    L = nodal_laplacian_matrix(M)
    L = (L + np.pi * 1e-1 * sp.identity(L.shape[0])).tocsr()
    N = n + 1
    dfA = df_const_from_csr(L, [N, N])
    # the low words must be nonzero (this guards the f64->f32 truncation
    # pitfall in the compression path)
    assert float(np.abs(np.asarray(dfA.const_lo)).max()) > 0

    rng = np.random.RandomState(5)
    x64 = rng.rand(N * N)
    b64 = rng.rand(N * N)
    xh, xl = _split64(x64)
    bh, bl = _split64(b64)
    rh, rl = df_residual(dfA,
                         jnp.asarray(bh.reshape(1, N, N)),
                         jnp.asarray(bl.reshape(1, N, N)),
                         jnp.asarray(xh.reshape(1, N, N)),
                         jnp.asarray(xl.reshape(1, N, N)))
    got = np.asarray(rh, np.float64).ravel() + np.asarray(rl, np.float64).ravel()
    ref = b64 - L.astype(np.float64) @ x64
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 1e-12
    # and it must beat the plain-f32 residual by orders of magnitude
    plain = (bh - (L.astype(np.float32) @ xh)).astype(np.float64)
    rel_plain = np.abs(plain - ref).max() / np.abs(ref).max()
    assert rel < 1e-4 * rel_plain


def test_df_accumulate_exact():
    rng = np.random.RandomState(7)
    x64 = rng.rand(300)
    z = rng.rand(300).astype(np.float32)
    xh, xl = _split64(x64)
    ah, al = df_accumulate(jnp.asarray(xh), jnp.asarray(xl), jnp.asarray(z))
    got = np.asarray(ah, np.float64) + np.asarray(al, np.float64)
    ref = x64 + z.astype(np.float64)
    assert np.abs(got - ref).max() < 1e-13


def test_refined_solve_uses_df32_and_certifies():
    from mgtpu.solvers.mg_solver import solve_mg_refined, _df32_residual_op
    n = 64
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-3 * abs(L).sum(axis=0).max() * sp.identity(L.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=4, relax_type="jacobi", relax_param=0.8,
                           nu_pre=1, nu_post=1, dtype=np.float32)
    state = mg_setup(L, M, cfg, rp)
    assert _df32_residual_op(state) is not None
    b = np.random.RandomState(1).rand(L.shape[0])
    x, info = solve_mg_refined(state, b, tol=1e-9, max_iter=40)
    true_rr = (np.linalg.norm(b - state.A_input.astype(np.float64)
                              @ np.asarray(x, np.float64))
               / np.linalg.norm(b))
    assert true_rr < 2e-9
    assert info["relres"] < 1e-9


def test_refined_after_replace_matrix_targets_new_operator():
    """replace_matrix/transpose must invalidate the cached refined-solve
    operators, or refinement converges against the stale matrix."""
    from mgtpu.solvers.mg_solver import solve_mg_refined
    from mgtpu import replace_matrix_in_hierarchy
    n = 48
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    L1 = nodal_laplacian_matrix(M)
    L1 = (L1 + 1e-3 * abs(L1).sum(axis=0).max()
          * sp.identity(L1.shape[0])).tocsr()
    L2 = (2.5 * L1).tocsr()          # same pattern, different values
    cfg, rp = get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                           nu_pre=1, nu_post=1, dtype=np.float32)
    state = mg_setup(L1, M, cfg, rp)
    b = np.random.RandomState(2).rand(L1.shape[0])
    x1, _ = solve_mg_refined(state, b, tol=1e-9, max_iter=40)  # warm caches
    replace_matrix_in_hierarchy(state, L2)
    x2, info = solve_mg_refined(state, b, tol=1e-9, max_iter=40)
    tr = (np.linalg.norm(b - L2.astype(np.float64) @ np.asarray(x2, np.float64))
          / np.linalg.norm(b))
    assert tr < 2e-9


def test_refined_complex_falls_back_to_high_precision_loop():
    """Complex operators skip df32 (real-only) and still certify via the
    emulated complex128 residual path."""
    from mgtpu.solvers.mg_solver import solve_mg_refined, _df32_residual_op
    n = 32
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    L = nodal_laplacian_matrix(M)
    # complex-shifted Laplacian (Helmholtz-type)
    Lc = (L + (1e-2 + 5e-3j) * abs(L).sum(axis=0).max()
          * sp.identity(L.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                           nu_pre=1, nu_post=1, dtype=np.complex64)
    state = mg_setup(Lc, M, cfg, rp)
    b = (np.random.RandomState(3).rand(Lc.shape[0])
         + 1j * np.random.RandomState(4).rand(Lc.shape[0]))
    x, info = solve_mg_refined(state, b, tol=1e-8, max_iter=40)
    true_rr = (np.linalg.norm(b - state.A_input.astype(np.complex128)
                              @ np.asarray(x, np.complex128))
               / np.linalg.norm(b))
    assert true_rr < 2e-8


def test_f64_hierarchy_reaches_below_df32_cap():
    """A float64 hierarchy must NOT route through the
    df32 residual (attainable accuracy ~1e-13); tol=1e-14 has to be reachable
    with the true-f64 residual path, and verbose must not change the path."""
    from mgtpu.solvers.mg_solver import solve_mg_refined, _df32_residual_op
    n = 48
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-2 * sp.identity(L.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                           nu_pre=2, nu_post=2, dtype=np.float64,
                           max_outer_iter=60)
    state = mg_setup(L, M, cfg, rp)
    b = L @ np.random.RandomState(5).rand(L.shape[0])
    b /= np.linalg.norm(b)
    x, info = solve_mg_refined(state, b, tol=1e-14)
    tr = np.linalg.norm(b - L @ np.asarray(x, np.float64)) / np.linalg.norm(b)
    assert tr < 1e-13, tr
    # verbose run follows the same numeric path (device loop + post-print)
    x2, info2 = solve_mg_refined(state, b, tol=1e-10, verbose=True)
    tr2 = np.linalg.norm(b - L @ np.asarray(x2, np.float64)) / np.linalg.norm(b)
    assert tr2 < 1e-9, tr2


def test_refined_variable_coefficient_uses_dense_df32():
    """Variable-coefficient (non-const-interior) scalar operators certify
    through the DENSE df32 stencil instead of falling back to emulated f64
   ."""
    from mgtpu.solvers.mg_solver import solve_mg_refined, _df32_residual_op
    from mgtpu.ops.df32 import DFGridStencil
    n = 48
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    rng = np.random.RandomState(11)
    sig = np.exp(0.5 * rng.randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-4 * abs(A).sum(axis=0).max() * sp.identity(A.shape[0])
         ).tocsr()
    cfg, rp = get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                           nu_pre=2, nu_post=2, dtype=np.float32,
                           max_outer_iter=60)
    state = mg_setup(A, M, cfg, rp)
    op = _df32_residual_op(state)
    assert isinstance(op, DFGridStencil)
    b = A @ rng.rand(A.shape[0])
    b /= np.linalg.norm(b)
    x, info = solve_mg_refined(state, b, tol=1e-8)
    tr = (np.linalg.norm(b - A.astype(np.float64) @ np.asarray(x, np.float64))
          / np.linalg.norm(b))
    assert tr < 1e-8, tr


def test_df_ell_split_survives_x64_disabled():
    """df_ell_from_csr must split hi/lo in numpy BEFORE device transfer:
    under jax_enable_x64=False (JAX's default) a jnp.asarray of f64 values silently truncates to
    f32, leaving values_lo == 0 and voiding the sharded-AMG df32
    certification (code-review r3)."""
    import jax
    from mgtpu.ops.df32 import df_ell_from_csr, df_residual_ell
    rng = np.random.RandomState(3)
    n = 120
    A = (sp.random(n, n, 0.06, random_state=rng, format="csr")
         + sp.identity(n)).astype(np.float64)
    A.data *= (1.0 + 1e-9 * rng.rand(A.nnz))     # not f32-representable
    with jax.enable_x64(False):
        dfA = df_ell_from_csr(A)
        lo = float(jnp.abs(dfA.values_lo).max())
        assert lo > 0.0, "low-order split lost (values_lo == 0)"
        x64 = rng.rand(n, 1)
        b64 = rng.rand(n, 1)
        xh, xl = _split64(x64)
        bh, bl = _split64(b64)
        rh, rl = df_residual_ell(dfA, jnp.asarray(bh), jnp.asarray(bl),
                                 jnp.asarray(xh), jnp.asarray(xl))
        r = np.asarray(rh, np.float64) + np.asarray(rl, np.float64)
    r64 = b64 - A @ x64
    err = np.abs(r - r64).max() / np.abs(r64).max()
    assert err < 1e-12, err
