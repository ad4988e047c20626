"""Chebyshev polynomial smoother (no reference analog).

A degree-k Chebyshev polynomial in D^-1 A damps the upper spectrum far more
per matvec than damped Jacobi, with no dot products (sharded-cycle friendly)
and a fixed linear cycle operator (CG-safe).
"""
import numpy as np
import pytest
import scipy.sparse as sp

from mgtpu import get_regular_mesh, get_mg_param, mg_setup
from mgtpu.models.operators import nodal_laplacian_matrix
from mgtpu.solvers.mg_solver import solve_mg, solve_mg_refined


def _poisson(n):
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(axis=0).max() * sp.identity(L.shape[0])).tocsr()
    return M, L


@pytest.mark.slow
def test_chebyshev_gmg_convergence_contract():
    """Beats the reference's Jacobi contract (relres < 0.005 in <=5 cycles,
    testGMG.jl:55) on the same configuration class."""
    M, L = _poisson(128)
    cfg, rp = get_mg_param(levels=4, relax_type="chebyshev", nu_pre=1,
                           nu_post=1, max_outer_iter=5, relative_tol=1e-10)
    state = mg_setup(L, M, cfg, rp)
    b = L @ np.random.RandomState(0).rand(L.shape[0])
    b /= np.linalg.norm(b)
    x, info = solve_mg(state, b)
    assert info["resvec"][min(5, len(info["resvec"]) - 1)] < 0.005
    # per-cycle contraction should be clearly better than damped Jacobi (~0.33)
    rv = info["resvec"]
    factors = rv[1:] / rv[:-1]
    assert np.median(factors) < 0.15


def test_chebyshev_grid_matches_flat_engine():
    M, L = _poisson(32)
    b = np.random.RandomState(1).rand(L.shape[0], 2)
    xs = []
    for engine in ("grid", "flat"):
        cfg, rp = get_mg_param(levels=3, relax_type="chebyshev", nu_pre=1,
                               nu_post=2, engine=engine, max_outer_iter=3,
                               relative_tol=1e-30)
        state = mg_setup(L, M, cfg, rp)
        from mgtpu.cycle.grid_cycle import GridHierarchy
        if engine == "grid":
            assert isinstance(state.hier, GridHierarchy)
        x, _ = solve_mg(state, b)
        xs.append(np.asarray(x))
    np.testing.assert_allclose(xs[0], xs[1], rtol=1e-9, atol=1e-11)


@pytest.mark.slow
def test_chebyshev_refined_beats_jacobi_iterations():
    M, L = _poisson(128)
    b = L @ np.random.RandomState(2).rand(L.shape[0])
    b /= np.linalg.norm(b)
    iters = {}
    for rt, kw in (("jacobi", dict(relax_param=0.8)),
                   ("chebyshev", dict(cheby_degree=2))):
        cfg, rp = get_mg_param(levels=5, relax_type=rt, nu_pre=1, nu_post=1,
                               dtype=np.float32, **kw)
        state = mg_setup(L, M, cfg, rp)
        x, info = solve_mg_refined(state, b, tol=1e-8, max_iter=40)
        true_rr = (np.linalg.norm(b - state.A_input.astype(np.float64)
                                  @ np.asarray(x, np.float64))
                   / np.linalg.norm(b))
        assert true_rr < 2e-8
        iters[rt] = info["iters"]
    assert iters["chebyshev"] < 0.7 * iters["jacobi"]


@pytest.mark.slow
def test_chebyshev4_converges():
    """Fourth-kind Chebyshev (arXiv:2407.09848): no lower-bound parameter,
    same iteration counts as the tuned first-kind on the model problem."""
    M, L = _poisson(128)
    cfg, rp = get_mg_param(levels=5, relax_type="chebyshev4", cheby_degree=2,
                           nu_pre=1, nu_post=1, dtype=np.float32)
    state = mg_setup(L, M, cfg, rp)
    b = L @ np.random.RandomState(4).rand(L.shape[0])
    b /= np.linalg.norm(b)
    x, info = solve_mg_refined(state, b, tol=1e-8, max_iter=40)
    true_rr = (np.linalg.norm(b - state.A_input.astype(np.float64)
                              @ np.asarray(x, np.float64))
               / np.linalg.norm(b))
    assert true_rr < 2e-8
    assert info["iters"] <= 9


@pytest.mark.slow
def test_fmg_initial_guess():
    """solve_mg_refined(fmg=True): full-multigrid initial guess converges to
    the same certified accuracy in no more iterations."""
    M, L = _poisson(128)
    cfg, rp = get_mg_param(levels=5, relax_type="chebyshev", cheby_degree=2,
                           nu_pre=1, nu_post=1, dtype=np.float32)
    state = mg_setup(L, M, cfg, rp)
    b = L @ np.random.RandomState(6).rand(L.shape[0])
    b /= np.linalg.norm(b)
    x0, i0 = solve_mg_refined(state, b, tol=1e-8, max_iter=40)
    x1, i1 = solve_mg_refined(state, b, tol=1e-8, max_iter=40, fmg=True)
    for x in (x0, x1):
        tr = (np.linalg.norm(b - state.A_input.astype(np.float64)
                             @ np.asarray(x, np.float64)) / np.linalg.norm(b))
        assert tr < 2e-8
    assert i1["iters"] <= i0["iters"]


def test_cubic_fmg_halves_refined_iterations_on_smooth_rhs():
    """ROADMAP r1 item 4: classical FMG needs higher-order SOLUTION
    interpolation.  With the cubic inter-level transfer the FMG seed cuts
    refined iterations ~2x on discretization-representative (smooth) RHS;
    rough RHS gain is marginal by nature."""
    from mgtpu.solvers.mg_solver import solve_mg_refined
    n = 128
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(0).max() * sp.identity(L.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=4, relax_type="jacobi", relax_param=0.8,
                           nu_pre=1, nu_post=1, dtype=np.float32,
                           max_outer_iter=40)
    st = mg_setup(L, M, cfg, rp)
    nn = n + 1
    xx, yy = np.meshgrid(np.linspace(0, 1, nn), np.linspace(0, 1, nn))
    b = L @ (np.sin(2 * np.pi * xx) * np.sin(3 * np.pi * yy)).reshape(-1)
    x1, i1 = solve_mg_refined(st, b, tol=1e-8, fmg=False)
    x2, i2 = solve_mg_refined(st, b, tol=1e-8, fmg=True)
    tr = np.linalg.norm(b - L.astype(np.float64) @ x2) / np.linalg.norm(b)
    assert tr < 1e-8
    assert i2["iters"] <= i1["iters"] - 4, (i1["iters"], i2["iters"])
