"""Line-Jacobi smoother (scan-based tridiagonal solves; no reference analog).

Point smoothers stall on anisotropic operators under full coarsening; line
relaxation along the strong axis restores multigrid efficiency.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp

from mgtpu import get_regular_mesh, get_mg_param, mg_setup
from mgtpu.solvers.mg_solver import solve_mg
from mgtpu.cycle.relax import line_solve
from mgtpu.setup.smoothers import line_prec


def _aniso(n, eps):
    """eps*u_xx + u_yy on the (n+1)^2 node grid (5-point, Dirichlet-type)."""
    N = n + 1
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N, N)) * (n ** 2)
    I = sp.identity(N)
    A = eps * sp.kron(I, T) + sp.kron(T, I)
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    return M, sp.csr_matrix(A)


@pytest.mark.slow
def test_line_solve_exact_tridiagonal():
    """T^-1 via associative scans == scipy solve on the pure-line operator."""
    n = 32
    M, A = _aniso(n, 1.0)
    lr = line_prec(A, M, 1.0, dtype=np.float64, axis=1)
    # build T: tridiagonal part of A along grid axis 1 (lines over columns)
    N = n + 1
    T = sp.lil_matrix(A.shape)
    for i in range(A.shape[0]):
        for off in (-1, 0, 1):
            j = i + off
            if 0 <= j < A.shape[0] and (i // N) == (j // N):
                T[i, j] = A[i, j]
    T = sp.csr_matrix(T)
    rng = np.random.RandomState(0)
    r = rng.rand(A.shape[0])
    x_ref = sp.linalg.spsolve(T.tocsc(), r)
    rg = jnp.asarray(r.reshape(1, N, N))
    x = np.asarray(line_solve(lr, rg)).reshape(-1)
    np.testing.assert_allclose(x, x_ref, rtol=1e-9, atol=1e-10)


@pytest.mark.slow
def test_line_jacobi_beats_point_jacobi_on_anisotropy():
    n = 64
    eps = 100.0
    M, A = _aniso(n, eps)
    b = A @ np.random.RandomState(1).rand(A.shape[0])
    b /= np.linalg.norm(b)

    res = {}
    for rt, rp in (("jacobi", 0.8), ("line-jacobi", 1.0)):
        cfg, rpv = get_mg_param(levels=4, relax_type=rt, relax_param=rp,
                                nu_pre=1, nu_post=1, max_outer_iter=8,
                                relative_tol=1e-12)
        st = mg_setup(A, M, cfg, rpv)
        x, info = solve_mg(st, b)
        res[rt] = info["relres"]
    # strong coupling along x (eps*u_xx): lines must be auto-detected there
    assert res["line-jacobi"] < 5e-3
    assert res["line-jacobi"] < 1e-2 * res["jacobi"]


@pytest.mark.slow
def test_line_jacobi_isotropic_still_converges():
    n = 64
    M, A = _aniso(n, 1.0)
    b = A @ np.random.RandomState(2).rand(A.shape[0])
    b /= np.linalg.norm(b)
    # isotropic problems want damping (omega ~ 0.8), like point Jacobi
    cfg, rp = get_mg_param(levels=4, relax_type="line-jacobi", relax_param=0.8,
                           nu_pre=1, nu_post=1, max_outer_iter=8,
                           relative_tol=1e-12)
    st = mg_setup(A, M, cfg, rp)
    x, info = solve_mg(st, b)
    assert info["relres"] < 1e-4


def _mixed_strength(n):
    """a(x)*u_xx + u_yy with a = 100 on the left half, 0.01 on the right:
    the strong-coupling axis VARIES over the domain (x-lines needed left,
    y-lines right) — one line axis or one semicoarsening axis cannot cover
    both regions."""
    N = n + 1
    a_edge = np.where(np.arange(N - 1) < (N - 1) // 2, 100.0, 0.01)
    D = sp.diags([-1.0, 1.0], [0, 1], shape=(N - 1, N))   # 1D edge diff
    Tx = (D.T @ sp.diags(a_edge) @ D) * (n ** 2)
    Ty = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N, N)) * (n ** 2)
    A = sp.kron(sp.identity(N), Tx) + sp.kron(Ty, sp.identity(N))
    # tiny shift for definiteness (pure-Neumann-like rows at ends of D)
    A = A + 1e-6 * abs(A).sum(0).max() * sp.identity(A.shape[0])
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    return M, sp.csr_matrix(A)


@pytest.mark.slow
def test_alternating_lines_mixed_strength_contract():
    """Contract: mixed-strength anisotropy (strong axis
    varies over the domain).  Alternating-direction lines restore MG
    efficiency; point Jacobi and the single auto-detected line axis stall."""
    n = 64
    M, A = _mixed_strength(n)
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    b /= np.linalg.norm(b)

    res = {}
    for key, rt, rp in (("point", "jacobi", 0.8),
                        ("one-axis", "line-jacobi", 0.9),
                        ("alt", "line-jacobi", {"axis": "alt",
                                                "omega": 0.9})):
        cfg, rpv = get_mg_param(levels=4, relax_type=rt, relax_param=rp,
                                nu_pre=1, nu_post=1, max_outer_iter=14,
                                relative_tol=1e-12, dtype=np.float64)
        st = mg_setup(A, M, cfg, rpv)
        x, info = solve_mg(st, b)
        res[key] = info["relres"]
    # measured factors/iter: alt 0.34, one-axis 0.42, point 0.62
    assert res["alt"] < 1e-6
    assert res["alt"] < 1e-2 * res["point"]
    assert res["alt"] < 1e-1 * res["one-axis"]


@pytest.mark.slow
def test_line_jacobi_3d():
    """Lines along the strong axis of a 3D anisotropic operator (the scan
    machinery is axis-generic; pin it on a 3D grid, on every axis)."""
    n = 16
    N = n + 1
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N, N)) * (n ** 2)
    I = sp.identity(N)
    M = get_regular_mesh([0.0, 1.0] * 3, [n, n, n])
    for strong_kron in range(3):
        # strong coupling on one axis: eps=50 on term `strong_kron`
        # (kron order z,y,x -> grid axes (z, y, x))
        terms = []
        for k in range(3):
            w = 50.0 if k == strong_kron else 1.0
            mats = [I, I, I]
            mats[k] = T
            terms.append(w * sp.kron(sp.kron(mats[0], mats[1]), mats[2]))
        A = sp.csr_matrix(sum(terms))
        cfg, rp = get_mg_param(levels=3, relax_type="line-jacobi",
                               relax_param=1.0, nu_pre=1, nu_post=1,
                               max_outer_iter=10, relative_tol=1e-12,
                               dtype=np.float64)
        st = mg_setup(A, M, cfg, rp)
        b = A @ np.random.RandomState(5).rand(A.shape[0])
        b /= np.linalg.norm(b)
        x, info = solve_mg(st, b)
        assert info["relres"] < 5e-4, (strong_kron, info["relres"])
