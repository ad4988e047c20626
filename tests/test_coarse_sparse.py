"""Host SuperLU coarsest solver (cycle/coarse.py:SparseLUCoarse,
grid_cycle.py:GridSparseLU) — the reference's UMFPACK design point
(reference src/Multigrid/MGsetup.jl:350) for coarsest levels beyond the
replicated-dense device budget.

Covers: direct exactness (flat + grid form, real + complex, adjoint),
engine conformance (cycle iterates with the sparse-LU coarsest match the
dense-LU cycle), and the convergence contract (solve_mg reaches tol with a
capped dense budget so the sparse path is actually exercised end-to-end).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp

from mgtpu import get_mg_param, get_regular_mesh, mg_setup, solve_mg
from mgtpu.models.operators import nodal_laplacian_matrix


def _spd(n, seed=0, dtype=np.float64):
    rng = np.random.RandomState(seed)
    A = sp.random(n, n, density=5.0 / n, random_state=rng, format="csr")
    A = (A + A.T + 4.0 * sp.identity(n)).tocsr().astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        B = sp.random(n, n, density=5.0 / n, random_state=rng, format="csr")
        A = (A + 1j * (B - B.T)).tocsr().astype(dtype)
    return A


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_sparse_lu_exact(dtype):
    from mgtpu.cycle.coarse import sparse_lu_from_scipy
    from scipy.sparse.linalg import spsolve
    n = 200
    A = _spd(n, dtype=dtype)
    slu = sparse_lu_from_scipy(A, dtype=dtype)
    rng = np.random.RandomState(1)
    b = rng.rand(n, 3).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        b = b + 1j * rng.rand(n, 3)
    x = np.asarray(slu.solve(jnp.asarray(b)))
    xref = spsolve(A.tocsc(), b)
    assert np.abs(x - xref).max() < 1e-10 * np.abs(xref).max()
    # single-vector form
    x1 = np.asarray(slu.solve(jnp.asarray(b[:, 0])))
    assert np.abs(x1 - xref[:, 0]).max() < 1e-10 * np.abs(xref).max()
    # adjoint: A^H x = b
    xa = np.asarray(slu.solve_adjoint(jnp.asarray(b)))
    ra = A.conj().T @ xa - b
    assert np.abs(ra).max() < 1e-10 * np.abs(b).max()


def test_grid_sparse_lu_matches_dense_inverse():
    """Grid-form host LU == device dense inverse on the same operator."""
    from mgtpu.cycle.grid_cycle import (GridSparseLU,
                                        grid_dense_inverse_from_scipy)
    from scipy.sparse.linalg import splu
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [16, 16])
    L = nodal_laplacian_matrix(M)
    # shift scaled to the operator: at h = 1/16 the diagonal is ~1e3, so an
    # absolute 1e-2 shift left kappa ~ 2e5; this one gives kappa ~ 100
    L = (L + 1e-2 * abs(L).sum(axis=0).max()
         * sp.identity(L.shape[0])).tocsr().astype(np.float32)
    grid = (17, 17)
    slu = GridSparseLU(splu(L.tocsc().astype(np.float64)), grid)
    den = grid_dense_inverse_from_scipy(L, grid, np.float32)
    bg = jnp.asarray(np.random.RandomState(2).rand(2, *grid)
                     .astype(np.float32))
    xs = np.asarray(slu.solve(bg), np.float64)
    xd = np.asarray(den.solve(bg), np.float64)
    # f32 dense-inverse path error ~ eps * kappa(A)
    assert np.abs(xs - xd).max() / np.abs(xd).max() < 1e-4


def test_dense_inverse_unshifted_when_regular():
    """The diagonal shift must not perturb well-conditioned
    operators — the unshifted inverse must pass the probe and be exact to
    rounding; a singular (Neumann) operator must still produce a usable
    (shift-regularized) solve."""
    from mgtpu.cycle.grid_cycle import grid_dense_inverse_from_scipy
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [12, 12])
    L = nodal_laplacian_matrix(M)
    n = L.shape[0]
    Lr = (L + 0.5 * sp.identity(n)).tocsr().astype(np.float32)
    den = grid_dense_inverse_from_scipy(Lr, (13, 13), np.float32)
    I_err = np.abs(np.asarray(Lr.todense(), np.float64)
                   @ np.asarray(den.inv, np.float64) - np.eye(n)).max()
    # an UNSHIFTED f32 inverse of this well-conditioned operator is exact
    # to ~1e-5; the 1e-6 relative shift alone would push the identity
    # residual to ~1e-4 * ||A||, so this bound also proves no shift leaked
    assert I_err < 2e-5
    # singular case: pure Neumann Laplacian (constant nullspace)
    Ls = L.tocsr().astype(np.float32)
    dens = grid_dense_inverse_from_scipy(Ls, (13, 13), np.float32)
    b = np.random.RandomState(3).rand(1, 13, 13).astype(np.float32)
    b -= b.mean()                      # range of A
    x = np.asarray(dens.solve(jnp.asarray(b)))[0].ravel()
    r = b.ravel() - (Ls @ x.astype(np.float64)).astype(np.float64)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-2


def test_gmg_with_sparse_coarsest_converges(monkeypatch):
    """End-to-end: cap the dense budget so the grid engine's coarsest goes
    through the host SuperLU callback; conformance vs the dense-LU cycle
    and the standard convergence contract."""
    import mgtpu.cycle.grid_cycle as gc
    import mgtpu.setup.hierarchy as hm
    from mgtpu.cycle.grid_cycle import grid_cycle
    from mgtpu.ops.grid_stencil import flat_to_grid

    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [64, 64])
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(0).max() * sp.identity(L.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=2, relax_type="jacobi", relax_param=0.8,
                           nu_pre=1, nu_post=1, dtype=np.float32,
                           max_outer_iter=25, relative_tol=1e-6)
    st_dense = mg_setup(L, M, cfg, rp)

    # coarsest is 33^2 = 1089 > capped budget -> GridSparseLU
    monkeypatch.setattr(gc, "_DENSE_INV_MAX", 64)
    monkeypatch.setattr(gc, "_HOST_INV_MAX", 128)
    monkeypatch.setattr(gc, "_DENSE_LU_MAX", 256)
    monkeypatch.setattr(hm, "_DENSE_COARSE_MAX", 256)
    st_sparse = mg_setup(L, M, cfg, rp)
    assert isinstance(st_sparse.hier.coarse, gc.GridSparseLU)

    b = jnp.asarray(np.random.RandomState(0).rand(L.shape[0], 1)
                    .astype(np.float32))
    bg = flat_to_grid(b, st_dense.hier.fine_grid)
    x_d = grid_cycle(cfg, st_dense.hier, bg, jnp.zeros_like(bg))
    x_s = grid_cycle(cfg, st_sparse.hier, bg, jnp.zeros_like(bg))
    # conformance: host f64 LU vs device f32/f64 dense path, same cycle
    assert (np.abs(np.asarray(x_s) - np.asarray(x_d)).max()
            / np.abs(np.asarray(x_d)).max()) < 1e-4

    # convergence contract: within 2x of the dense-coarsest driver's final
    # relres (both sit at the f32 cycle accuracy floor here)
    b1 = np.asarray(b[:, 0], np.float64)
    _, res_d = solve_mg(st_dense, b1)
    _, res_s = solve_mg(st_sparse, b1)
    last = lambda r: float(np.asarray(
        r["relres"] if hasattr(r, "keys") else r).ravel()[-1])
    assert last(res_s) < max(2.0 * last(res_d), 1e-6)
