"""Semicoarsening transfers (transfer_type="semicoarsening"): coarsen only
the strongly coupled axes, re-detected per level from the stencil.  The
robust-MG answer to anisotropy at depth; the reference
has no semicoarsening."""
import numpy as np
import pytest
import scipy.sparse as sp

from mgtpu import get_regular_mesh, get_mg_param, mg_setup, solve_mg
from mgtpu.cycle.grid_cycle import GridHierarchy


def _aniso(n, eps_x, shift=1e-2):
    """eps_x * u_xx + u_yy on an n x n node mesh (mesh dim 0 = x fastest)."""
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    nn = n + 1
    ex = np.ones(nn)
    T = sp.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1])
    eye = sp.identity(nn)
    A = (eps_x * sp.kron(eye, T) + sp.kron(T, eye)) * (n ** 2)
    return M, (A + shift * sp.identity(nn * nn)).tocsr()


def test_isotropic_reduces_to_full_coarsening():
    M, A = _aniso(64, 1.0)
    cfg_s, rp = get_mg_param(levels=4, relax_type="jacobi", relax_param=0.8,
                             nu_pre=2, nu_post=2,
                             transfer_type="semicoarsening",
                             dtype=np.float64, relative_tol=1e-8,
                             max_outer_iter=30)
    cfg_f, _ = get_mg_param(levels=4, relax_type="jacobi", relax_param=0.8,
                            nu_pre=2, nu_post=2, dtype=np.float64,
                            relative_tol=1e-8, max_outer_iter=30)
    st_s = mg_setup(A, M, cfg_s, rp)
    st_f = mg_setup(A, M, cfg_f, rp)
    assert [tuple(l.A.grid) for l in st_s.hier.levels] == \
           [tuple(l.A.grid) for l in st_f.hier.levels]
    b = A @ np.random.RandomState(0).rand(A.shape[0])
    b /= np.linalg.norm(b)
    _, i_s = solve_mg(st_s, b)
    _, i_f = solve_mg(st_f, b)
    assert i_s["iters"] == i_f["iters"]


@pytest.mark.parametrize("eps", [100.0, 0.01])
def test_strong_anisotropy_converges_with_point_jacobi(eps):
    """eps = 100 / 0.01: semicoarsening + POINT Jacobi is h-robust where
    full coarsening + Jacobi stalls; anisotropy re-balances at depth so
    deeper levels switch back to full coarsening automatically."""
    M, A = _aniso(128, eps)
    cfg, rp = get_mg_param(levels=5, relax_type="jacobi", relax_param=0.8,
                           nu_pre=2, nu_post=2,
                           transfer_type="semicoarsening",
                           dtype=np.float64, relative_tol=1e-8,
                           max_outer_iter=25)
    st = mg_setup(A, M, cfg, rp)
    assert isinstance(st.hier, GridHierarchy)
    grids = [tuple(l.A.grid) for l in st.hier.levels]
    # level 0 -> 1 must coarsen ONLY the strong axis
    strong_axis = 1 if eps > 1 else 0          # grid axes: (y, x)
    weak_axis = 1 - strong_axis
    assert grids[1][strong_axis] < grids[0][strong_axis]
    assert grids[1][weak_axis] == grids[0][weak_axis]
    b = A @ np.random.RandomState(1).rand(A.shape[0])
    b /= np.linalg.norm(b)
    x, info = solve_mg(st, b)
    assert info["relres"] < 1e-8
    assert info["iters"] <= 15


@pytest.mark.slow
def test_eps100_513_grid_contract():
    """Done-criterion: eps=100 anisotropy at 513^2 nodes,
    grid-engine semicoarsened hierarchy converging to 1e-8."""
    M, A = _aniso(512, 100.0)
    cfg, rp = get_mg_param(levels=6, relax_type="jacobi", relax_param=0.8,
                           nu_pre=2, nu_post=2,
                           transfer_type="semicoarsening",
                           dtype=np.float64, relative_tol=1e-8,
                           max_outer_iter=25)
    st = mg_setup(A, M, cfg, rp)
    assert isinstance(st.hier, GridHierarchy)
    b = A @ np.random.RandomState(2).rand(A.shape[0])
    b /= np.linalg.norm(b)
    x, info = solve_mg(st, b)
    assert info["relres"] < 1e-8
    assert info["iters"] <= 15


@pytest.mark.slow
def test_semicoarsening_with_line_smoother():
    """Pairing with the line smoother (both tools cover anisotropy; together
    they handle mixed-strength operators)."""
    M, A = _aniso(128, 0.01)
    cfg, rp = get_mg_param(levels=4, relax_type="line-jacobi",
                           relax_param=0.9, nu_pre=1, nu_post=1,
                           transfer_type="semicoarsening",
                           dtype=np.float64, relative_tol=1e-8,
                           max_outer_iter=25)
    st = mg_setup(A, M, cfg, rp)
    b = A @ np.random.RandomState(3).rand(A.shape[0])
    b /= np.linalg.norm(b)
    x, info = solve_mg(st, b)
    assert info["relres"] < 1e-8
    assert info["iters"] <= 15
