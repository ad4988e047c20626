"""Grid-form (zero-gather) engine: conformance against the flat engine.

The grid engine must be numerically identical to the flat ELL/DIA cycle on
structured full-weighting hierarchies: same stencil application, same
transfers (matrix-free separable FW == fw_interp matrices), same coarse
solve up to factorization rounding.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp

from mgtpu import get_mg_param, mg_setup, get_regular_mesh
from mgtpu.cycle.cycle import recursive_cycle
from mgtpu.cycle.grid_cycle import (GridHierarchy, grid_restrict,
                                    grid_prolong, build_grid_hierarchy)
from mgtpu.ops.grid_stencil import (grid_stencil_from_csr, flat_to_grid,
                                    grid_to_flat)
from mgtpu.models.operators import (nodal_laplacian_matrix,
                                    nodal_div_sig_grad_matrix)
from mgtpu.solvers.mg_solver import solve_mg


def _poisson(n, dim=2, dtype=np.float64):
    dom = [0.0, 1.0] * dim
    M = get_regular_mesh(dom, [n] * dim)
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(axis=0).max() * sp.identity(L.shape[0])).tocsr()
    return M, L.astype(dtype)


@pytest.mark.parametrize("dim,n", [(2, 16), (3, 8)])
def test_grid_stencil_matvec_matches_scipy(dim, n):
    M, L = _poisson(n, dim)
    nodes = [n + 1] * dim
    S = grid_stencil_from_csr(L, nodes)
    x = np.random.rand(L.shape[0], 3)
    y = np.asarray(S.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, L @ x, rtol=1e-12, atol=1e-12)
    # round-trip representation
    assert abs(S.to_scipy() - L).max() < 1e-14


def test_grid_stencil_rejects_unstructured():
    A = sp.random(50, 50, density=0.2, format="csr") + 10 * sp.identity(50)
    with pytest.raises(ValueError):
        grid_stencil_from_csr(A, [50])


@pytest.mark.parametrize("dim,n", [(2, 16), (3, 8)])
def test_grid_transfers_match_fw_matrices(dim, n):
    M, L = _poisson(n, dim)
    cfg, rp = get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                           nu_pre=1, nu_post=1, dtype=np.float64,
                           engine="flat")
    state = mg_setup(L, M, cfg, rp)
    cfg_g, _ = get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                            nu_pre=1, nu_post=1, dtype=np.float64,
                            engine="grid")
    st_g = mg_setup(L, M, cfg_g, rp)
    P1 = st_g.hier.levels[0].P1
    grid_f = tuple(reversed([n + 1] * dim))
    rng = np.random.RandomState(3)
    r = rng.rand(L.shape[0], 2)
    rg = flat_to_grid(jnp.asarray(r), grid_f)
    bc = np.asarray(grid_to_flat(grid_restrict(rg, P1)))
    np.testing.assert_allclose(bc, state.Rs[0] @ r, rtol=1e-12, atol=1e-13)
    nc = state.Rs[0].shape[0]
    xc = rng.rand(nc, 2)
    grid_c = tuple(reversed([n // 2 + 1] * dim))
    xf = np.asarray(grid_to_flat(grid_prolong(
        flat_to_grid(jnp.asarray(xc), grid_c), P1)))
    np.testing.assert_allclose(xf, state.Ps[0] @ xc, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("relax", ["jacobi", "spai", "jac-gmres"])
@pytest.mark.parametrize("ctype", ["V", "W", "F", "K"])
def test_grid_cycle_matches_flat_cycle(relax, ctype):
    M, L = _poisson(32, 2)
    mk = lambda engine: get_mg_param(
        levels=3, relax_type=relax, relax_param=0.8, nu_pre=1, nu_post=1,
        cycle_type=ctype, dtype=np.float64, engine=engine)
    cfg_f, rp = mk("flat")
    cfg_g, _ = mk("grid")
    st_f = mg_setup(L, M, cfg_f, rp)
    st_g = mg_setup(L, M, cfg_g, rp)
    assert isinstance(st_g.hier, GridHierarchy)
    assert not isinstance(st_f.hier, GridHierarchy)
    b = np.random.rand(L.shape[0], 2)
    x0 = np.zeros_like(b)
    xf = np.asarray(recursive_cycle(cfg_f, st_f.hier, jnp.asarray(b),
                                    jnp.asarray(x0)))
    xg = np.asarray(recursive_cycle(cfg_g, st_g.hier, jnp.asarray(b),
                                    jnp.asarray(x0)))
    np.testing.assert_allclose(xg, xf, rtol=1e-9, atol=1e-11)


def test_grid_engine_3d_and_multirhs_convergence():
    M, L = _poisson(16, 3)
    cfg, rp = get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                           nu_pre=2, nu_post=2, max_outer_iter=18,
                           relative_tol=1e-9, dtype=np.float64, engine="grid")
    state = mg_setup(L, M, cfg, rp)
    b = np.random.rand(L.shape[0], 3)
    b /= np.linalg.norm(b, axis=0)
    x, info = solve_mg(state, b)
    assert info["relres"] < 1e-9
    np.testing.assert_allclose(np.asarray(L @ np.asarray(x)), b,
                               atol=5e-9)


def test_grid_engine_gmres_coarse_and_divsiggrad():
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [32, 32])
    sig = np.exp(np.random.randn(32 * 32))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-4 * abs(A).sum(axis=0).max() * sp.identity(A.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=3, relax_type="spai", nu_pre=2, nu_post=2,
                           max_outer_iter=15, relative_tol=1e-8,
                           coarse_solve="GMRES", dtype=np.float64,
                           engine="grid")
    state = mg_setup(A, M, cfg, rp)
    assert isinstance(state.hier, GridHierarchy)
    b = np.random.rand(A.shape[0])
    b /= np.linalg.norm(b)
    x, info = solve_mg(state, b)
    # the 10-step FGMRES coarsest solve is inexact, so the outer iteration
    # floors well above machine precision (reference contract for the GMRES
    # coarsest is 5e-3, testGMGRAPforPoisson.jl:40)
    assert info["relres"] < 1e-3


def test_grid_engine_even_grid_eligible():
    # even node counts use the identity-tail 1D factors (fw_interp_1d) via the
    # dense transfer matmuls, so the grid engine applies to them too
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [15, 15])
    L = nodal_laplacian_matrix(M)
    L = (L + 0.01 * sp.identity(L.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=2, relax_type="jacobi", relax_param=0.8,
                           max_outer_iter=12, relative_tol=1e-8,
                           dtype=np.float64)
    state = mg_setup(L, M, cfg, rp)
    assert isinstance(state.hier, GridHierarchy)
    b = np.random.rand(L.shape[0])
    b /= np.linalg.norm(b)
    x, info = solve_mg(state, b)
    assert info["relres"] < 1e-8


def test_grid_engine_fallback_and_force():
    # a long-range coupling breaks the stencil decomposition -> auto falls
    # back to the flat engine; engine="grid" refuses
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [16, 16])
    L = nodal_laplacian_matrix(M)
    L = (L + 0.01 * sp.identity(L.shape[0])).tolil()
    L[0, L.shape[0] // 2] = 0.3
    L[L.shape[0] // 2, 0] = 0.3
    L = L.tocsr()
    cfg, rp = get_mg_param(levels=2, relax_type="jacobi", relax_param=0.8,
                           dtype=np.float64)
    state = mg_setup(L, M, cfg, rp)
    assert not isinstance(state.hier, GridHierarchy)
    cfg_g, rp = get_mg_param(levels=2, relax_type="jacobi", relax_param=0.8,
                             dtype=np.float64, engine="grid")
    with pytest.raises(ValueError):
        mg_setup(L, M, cfg_g, rp)


def test_grid_engine_used_by_default_on_structured():
    M, L = _poisson(32, 2)
    cfg, rp = get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                           dtype=np.float32)
    state = mg_setup(L, M, cfg, rp)
    assert isinstance(state.hier, GridHierarchy)


@pytest.mark.parametrize("dim,n", [(2, 16), (3, 8)])
def test_const_stencil_compression_exact(dim, n):
    from mgtpu.ops.grid_stencil import compress_grid_stencil, ConstGridStencil
    M, L = _poisson(n, dim)
    S = grid_stencil_from_csr(L, [n + 1] * dim)
    C = compress_grid_stencil(S)
    assert isinstance(C, ConstGridStencil)
    x = np.random.rand(L.shape[0], 2)
    np.testing.assert_allclose(np.asarray(C.matvec(jnp.asarray(x))),
                               L @ x, rtol=1e-12, atol=1e-12)
    assert abs(C.to_scipy() - L).max() < 1e-13
    # grid-form input too
    xg = flat_to_grid(jnp.asarray(x), S.grid)
    np.testing.assert_allclose(np.asarray(grid_to_flat(C.matvec(xg))),
                               L @ x, rtol=1e-12, atol=1e-12)


def test_const_stencil_rejects_variable_coefficients():
    from mgtpu.ops.grid_stencil import compress_grid_stencil
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [16, 16])
    sig = np.exp(np.random.randn(16 * 16))
    A = nodal_div_sig_grad_matrix(M, sig).tocsr()
    S = grid_stencil_from_csr(A, [17, 17])
    assert compress_grid_stencil(S) is None


def test_const_compression_active_in_hierarchy():
    from mgtpu.ops.grid_stencil import ConstGridStencil
    M, L = _poisson(32, 2)
    cfg, rp = get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                           dtype=np.float64, engine="grid")
    state = mg_setup(L, M, cfg, rp)
    # constant-coefficient problem: every level compresses (incl. Galerkin
    # coarsenings, whose boundary deviations stay within the 2-node band)
    for lvl in state.hier.levels:
        assert isinstance(lvl.A, ConstGridStencil)


def test_mixed_precision_refinement_reaches_f64_accuracy():
    from mgtpu.solvers.mg_solver import solve_mg_refined
    M, L = _poisson(64, 2)
    cfg, rp = get_mg_param(levels=4, relax_type="jacobi", relax_param=0.8,
                           nu_pre=1, nu_post=1, max_outer_iter=40,
                           dtype=np.float32)
    state = mg_setup(L, M, cfg, rp)
    b = np.random.rand(L.shape[0])
    b /= np.linalg.norm(b)
    # plain f32 cycling floors near 1e-7; refinement must go below 1e-10
    x, info = solve_mg_refined(state, b, tol=1e-10)
    assert info["relres"] < 1e-10
    assert np.linalg.norm(L @ np.asarray(x, dtype=np.float64) - b) < 2e-10
    # flat engine path too
    cfg_f, rp_f = get_mg_param(levels=4, relax_type="jacobi", relax_param=0.8,
                               nu_pre=1, nu_post=1, max_outer_iter=40,
                               dtype=np.float32, engine="flat")
    state_f = mg_setup(L, M, cfg_f, rp_f)
    xf, info_f = solve_mg_refined(state_f, b, tol=1e-10)
    assert info_f["relres"] < 1e-10


def test_grid_engine_complex_shifted_laplacian():
    """Complex shifted Laplacian (Helmholtz-like): grid engine matches flat
    and converges — the reference is {VAL}-generic over ComplexF32/F64."""
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [32, 32])
    L = nodal_laplacian_matrix(M).astype(np.complex128)
    n = L.shape[0]
    L = (L + (0.05 + 0.05j) * abs(L).sum(axis=0).max()
         * sp.identity(n)).tocsr()
    mk = lambda engine: get_mg_param(levels=3, relax_type="jacobi",
                                     relax_param=0.8, nu_pre=1, nu_post=1,
                                     max_outer_iter=25, relative_tol=1e-9,
                                     dtype=np.complex128, engine=engine)
    cfg_g, rp = mk("grid")
    cfg_f, _ = mk("flat")
    st_g = mg_setup(L, M, cfg_g, rp)
    st_f = mg_setup(L, M, cfg_f, rp)
    assert isinstance(st_g.hier, GridHierarchy)
    b = (np.random.rand(n, 2) + 1j * np.random.rand(n, 2))
    xg = np.asarray(recursive_cycle(cfg_g, st_g.hier, jnp.asarray(b),
                                    jnp.zeros_like(jnp.asarray(b))))
    xf = np.asarray(recursive_cycle(cfg_f, st_f.hier, jnp.asarray(b),
                                    jnp.zeros_like(jnp.asarray(b))))
    np.testing.assert_allclose(xg, xf, rtol=1e-9, atol=1e-11)
    x, info = solve_mg(st_g, b)
    assert info["relres"] < 1e-9
    # complex refinement from a complex64 hierarchy
    from mgtpu.solvers.mg_solver import solve_mg_refined
    cfg_c, rp_c = get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                               nu_pre=1, nu_post=1, max_outer_iter=40,
                               dtype=np.complex64)
    st_c = mg_setup(L, M, cfg_c, rp_c)
    assert isinstance(st_c.hier, GridHierarchy)
    xr, rinfo = solve_mg_refined(st_c, b[:, 0], tol=1e-10)
    assert rinfo["relres"] < 1e-10
    assert np.linalg.norm(L @ np.asarray(xr) - b[:, 0]) < 1e-8


def _kron_factors(factors):
    K = factors[0]
    for f in factors[1:]:
        K = sp.kron(K, f, format="csr")
    return K


@pytest.mark.parametrize("grid,coarsen", [
    ((17, 17), (True, True)),
    ((9, 9, 9), (True, True, True)),
    ((17, 12), (True, False)),            # semicoarsening
    ((16, 17), (True, True)),             # even extent: identity tail
    ((9, 7, 16), (True, False, True)),
])
def test_fw_transfer_matches_scipy(grid, coarsen):
    """Strided full-weighting transfers == scipy R r and P x with the
    fw_interp_1d factors (identity on an uncoarsened axis)."""
    from mgtpu.cycle.grid_cycle import FWTransfer
    from mgtpu.setup.transfers import fw_interp_1d
    facs = [fw_interp_1d(n)[0] if c else sp.identity(n, format="csr")
            for n, c in zip(grid, coarsen)]
    P = _kron_factors(facs)                 # grid axis 0 is the slowest
    R = (0.5 ** sum(coarsen)) * P.T
    cgrid = tuple(f.shape[1] for f in facs)
    T = FWTransfer(tuple(n if c else None for n, c in zip(grid, coarsen)))
    rng = np.random.RandomState(len(grid))
    r = rng.rand(2, *grid)
    bc = np.asarray(grid_restrict(jnp.asarray(r), T)).reshape(2, -1)
    np.testing.assert_allclose(bc, (R @ r.reshape(2, -1).T).T,
                               rtol=1e-13, atol=1e-14)
    xc = rng.rand(2, *cgrid)
    xf = np.asarray(grid_prolong(jnp.asarray(xc), T)).reshape(2, -1)
    np.testing.assert_allclose(xf, (P @ xc.reshape(2, -1).T).T,
                               rtol=1e-13, atol=1e-14)


def _cubic_factor(nf):
    """Dense 1D cubic solution prolongation (nf x nc), the FMG reference."""
    nc = (nf - 1) // 2 + 1
    P = np.zeros((nf, nc))
    P[np.arange(0, nf, 2), np.arange(nc)] = 1.0
    w_int = np.array([-1.0, 9.0, 9.0, -1.0]) / 16.0
    w_lo = np.array([5.0, 15.0, -5.0, 1.0]) / 16.0
    for m in range(nc - 1):
        r = 2 * m + 1
        if nc < 4:
            P[r, m:m + 2] = 0.5
        elif m == 0:
            P[r, 0:4] = w_lo
        elif m == nc - 2:
            P[r, nc - 4:nc] = w_lo[::-1]
        else:
            P[r, m - 1:m + 3] = w_int
    return P


@pytest.mark.parametrize("nf", [5, 9, 33])
def test_cubic_prolong_matches_matrix(nf):
    from mgtpu.cycle.grid_cycle import _cubic_prolong
    Pc = _cubic_factor(nf)
    xc = np.random.RandomState(nf).rand(2, Pc.shape[1], Pc.shape[1])
    got = np.asarray(_cubic_prolong(jnp.asarray(xc), (nf, nf)))
    ref = np.einsum("ia,mab,jb->mij", Pc, xc, Pc)
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-14)
