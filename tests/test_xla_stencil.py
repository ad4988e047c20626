"""XLA paths that replaced the hand-written kernels: 3D constant-interior
stencil matvec, 3D zero-guess cycles and the doubling line solve, each
against a plain scipy reference."""
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import jax.numpy as jnp

from mgtpu import get_mg_param, get_regular_mesh, mg_setup
from mgtpu.cycle.relax import line_solve
from mgtpu.models.operators import nodal_laplacian_matrix
from mgtpu.ops.grid_stencil import (ConstGridStencil, flat_to_grid,
                                    grid_to_flat, make_grid_stencil)
from mgtpu.setup.smoothers import line_prec


def _tridiag(n, lo, mid, hi):
    return sp.diags([lo * np.ones(n - 1), mid * np.ones(n), hi * np.ones(n - 1)],
                    [-1, 0, 1])


def _operator_3d(points, cells):
    """7-point nodal Laplacian, or a 27-point anisotropic Q1 finite-element
    Laplacian (sum over axes j of w_j K_j x M x M), on a node grid of
    `cells` + 1."""
    M = get_regular_mesh([0.0, 1.0] * 3, list(cells))
    if points == 7:
        A = nodal_laplacian_matrix(M)
    else:
        nodes = [c + 1 for c in cells]
        # distinct axis weights keep every one of the 27 entries nonzero
        K = [_tridiag(n, -1.0, 2.0, -1.0) * w
             for w, n in zip((1.0, 1.37, 2.48), nodes)]
        Mm = [_tridiag(n, 1.0, 4.0, 1.0) / 6.0 for n in nodes]

        def fac(k, j):
            return K[k] if k == j else Mm[k]
        # flat index has mesh dim 0 fastest: kron order dim 2, 1, 0
        A = sum(sp.kron(sp.kron(fac(2, j), fac(1, j)), fac(0, j))
                for j in range(3))
    return M, sp.csr_matrix(A + 0.1 * sp.identity(A.shape[0]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("cells", [(8, 8, 8), (7, 10, 13)])
@pytest.mark.parametrize("points", [7, 27])
def test_const_matvec_3d_matches_scipy(points, cells, m, dtype):
    M, A = _operator_3d(points, cells)
    nodes = [c + 1 for c in cells]
    S = make_grid_stencil(A, nodes, dtype=dtype)
    assert isinstance(S, ConstGridStencil)
    assert len(S.offsets) == points
    x = np.random.RandomState(m).rand(A.shape[0], m).astype(dtype)
    y_ref = A.astype(np.float64) @ x.astype(np.float64)
    y = np.asarray(S.matvec(jnp.asarray(x)), np.float64)
    # grid-form input takes the same path without the flat conversion
    yg = np.asarray(grid_to_flat(S.matvec(flat_to_grid(jnp.asarray(x),
                                                       S.grid))), np.float64)
    tol = 1e-12 if dtype == np.float64 else 2e-6
    scale = np.abs(y_ref).max()
    assert np.abs(y - y_ref).max() / scale < tol
    assert np.abs(yg - y_ref).max() / scale < tol


@pytest.mark.parametrize("relax", ["jacobi", "spai", "chebyshev"])
def test_grid_engine_xzero_bitwise_3d(relax):
    """A zero-guess cycle skips the r = b - A*0 matvec per level; on the
    3D constant-interior levels the result must stay bitwise identical."""
    from mgtpu.cycle.grid_cycle import grid_cycle
    M = get_regular_mesh([0.0, 1.0] * 3, [16, 16, 16])
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(0).max() * sp.identity(L.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=3, relax_type=relax, relax_param=0.8,
                           nu_pre=1, nu_post=1, dtype=np.float32)
    st = mg_setup(L, M, cfg, rp)
    assert isinstance(st.hier.levels[0].A, ConstGridStencil)
    b = flat_to_grid(jnp.asarray(
        np.random.RandomState(4).rand(L.shape[0], 2).astype(np.float32)),
        st.hier.fine_grid)
    z = jnp.zeros_like(b)
    x_ref = np.asarray(grid_cycle(cfg, st.hier, b, z))
    x_opt = np.asarray(grid_cycle(cfg, st.hier, b, z, x_zero=True))
    assert np.array_equal(x_ref, x_opt)


def _line_reference(A, grid, axis, r):
    """Solve T x = r with T the tridiagonal part of A along grid `axis`,
    one scipy banded solve per line."""
    g = len(grid)
    strides = [int(np.prod(grid[a + 1:])) for a in range(g)]
    s = strides[axis]
    n = A.shape[0]
    idx = np.arange(n)
    pos = np.unravel_index(idx, grid)[axis]
    diag = A.diagonal()
    sup = np.zeros(n)
    sub = np.zeros(n)
    has_up = pos < grid[axis] - 1
    has_dn = pos > 0
    sup[has_up] = np.asarray(A[idx[has_up], idx[has_up] + s]).ravel()
    sub[has_dn] = np.asarray(A[idx[has_dn], idx[has_dn] - s]).ravel()
    D, U, Lw, R = (np.moveaxis(v.reshape(grid), axis, -1)
                   for v in (diag, sup, sub, r))
    X = np.empty_like(R)
    for line in np.ndindex(*D.shape[:-1]):
        ab = np.zeros((3, grid[axis]))
        ab[0, 1:] = U[line][:-1]
        ab[1] = D[line]
        ab[2, :-1] = Lw[line][1:]
        X[line] = sla.solve_banded((1, 1), ab, R[line])
    return np.moveaxis(X, -1, axis).reshape(-1)


@pytest.mark.parametrize("dim,axis", [(2, 0), (2, 1), (3, 0), (3, 1), (3, 2)])
def test_doubling_line_solve_matches_banded(dim, axis):
    cells = [10, 13, 9][:dim]
    M = get_regular_mesh([0.0, 1.0] * dim, cells)
    rng = np.random.RandomState(axis)
    A = nodal_laplacian_matrix(M).tocsr()
    # variable line coefficients: a random positive diagonal scaling
    Dg = sp.diags(rng.rand(A.shape[0]) + 0.5)
    A = sp.csr_matrix(Dg @ A @ Dg + sp.identity(A.shape[0]))
    lr = line_prec(A, M, 1.0, dtype=np.float64, axis=axis)
    grid = tuple(reversed([c + 1 for c in cells]))
    r = rng.rand(A.shape[0])
    x = np.asarray(line_solve(lr, jnp.asarray(r.reshape((1,) + grid))))
    x_ref = _line_reference(A, grid, axis, r)
    np.testing.assert_allclose(x.reshape(-1), x_ref, rtol=1e-10, atol=1e-12)
