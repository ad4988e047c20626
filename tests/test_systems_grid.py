"""Systems grid engine (staggered elasticity/Stokes): conformance vs the
flat engine and convergence contracts."""
import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp

from mgtpu import get_mg_param, mg_setup, solve_mg, solve_cg_mg, get_regular_mesh
from mgtpu.cycle.cycle import recursive_cycle
from mgtpu.cycle.systems_grid import (SystemsGridHierarchy,
                                      block_operator_from_csr,
                                      block_to_fields, fields_to_block)
from mgtpu.models.operators import (linear_elasticity_operator,
                                    linear_elasticity_operator_mixed)


def _opnorm1(A):
    return abs(A).sum(axis=0).max()


def _elasticity(n, dim=2, mixed=False):
    dom = [0.0, 1.0] * dim
    M = get_regular_mesh(dom, [n] * dim)
    mu = np.ones(M.num_cells)
    lam = np.ones(M.num_cells)
    if mixed:
        A = linear_elasticity_operator_mixed(M, mu, lam)
    else:
        A = linear_elasticity_operator(M, mu, lam)
    A = (A + 1e-3 * _opnorm1(A) * sp.identity(A.shape[0])).tocsr()
    return M, A


@pytest.mark.parametrize("dim,n,mixed", [(2, 8, False), (2, 8, True),
                                         (3, 8, False), (3, 8, True)])
def test_block_operator_matvec_matches_scipy(dim, n, mixed):
    M, A = _elasticity(n, dim, mixed)
    op = block_operator_from_csr(A, [n] * dim, mixed)
    x = np.random.rand(A.shape[0], 2)
    xs = block_to_fields(jnp.asarray(x), op.grids)
    y = np.asarray(fields_to_block(op.matvec(xs)))
    np.testing.assert_allclose(y, A @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("relax,mixed", [
    pytest.param("spai", False, marks=pytest.mark.slow),
    ("jacobi", False),
    pytest.param("vanka", True, marks=pytest.mark.slow),
    ("econ-vanka", True),
    ("vanka-add", True)])
@pytest.mark.parametrize("ctype", ["V", "W", "K"])
def test_systems_grid_cycle_matches_flat(relax, mixed, ctype):
    M, A = _elasticity(16, 2, mixed)
    rp = 0.75 if relax != "econ-vanka" else 2.0
    mk = lambda engine: get_mg_param(
        levels=3, relax_type=relax, relax_param=rp, nu_pre=1, nu_post=1,
        cycle_type=ctype, dtype=np.float64, engine=engine,
        transfer_type="systems-faces-mixed" if mixed else "systems-faces")
    cfg_f, _ = mk("flat")
    cfg_g, _ = mk("grid")
    st_f = mg_setup(A, M, cfg_f, rp)
    st_g = mg_setup(A, M, cfg_g, rp)
    assert isinstance(st_g.hier, SystemsGridHierarchy)
    assert not isinstance(st_f.hier, SystemsGridHierarchy)
    b = np.random.rand(A.shape[0], 2)
    x0 = np.zeros_like(b)
    xf = np.asarray(recursive_cycle(cfg_f, st_f.hier, jnp.asarray(b),
                                    jnp.asarray(x0)))
    xg = np.asarray(recursive_cycle(cfg_g, st_g.hier, jnp.asarray(b),
                                    jnp.asarray(x0)))
    np.testing.assert_allclose(xg, xf, rtol=1e-6, atol=1e-9)


@pytest.mark.slow
def test_systems_grid_3d_mixed_vanka_cycle_matches_flat():
    M, A = _elasticity(8, 3, True)
    mk = lambda engine: get_mg_param(
        levels=2, relax_type="vanka", relax_param=0.75, nu_pre=1, nu_post=1,
        dtype=np.float64, engine=engine,
        transfer_type="systems-faces-mixed")
    cfg_f, _ = mk("flat")
    cfg_g, _ = mk("grid")
    st_f = mg_setup(A, M, cfg_f, 0.75)
    st_g = mg_setup(A, M, cfg_g, 0.75)
    assert isinstance(st_g.hier, SystemsGridHierarchy)
    b = np.random.rand(A.shape[0], 1)
    xf = np.asarray(recursive_cycle(cfg_f, st_f.hier, jnp.asarray(b),
                                    jnp.zeros_like(jnp.asarray(b))))
    xg = np.asarray(recursive_cycle(cfg_g, st_g.hier, jnp.asarray(b),
                                    jnp.zeros_like(jnp.asarray(b))))
    np.testing.assert_allclose(xg, xf, rtol=1e-6, atol=1e-9)


def test_systems_grid_convergence_contract_elasticity():
    """Reference testGMGRAPforElasticity contract on the grid engine:
    < 0.05 standalone (5 cycles), < 0.01 with CG."""
    M, A = _elasticity(64, 2, False)
    cfg, rp = get_mg_param(levels=4, max_outer_iter=5, relative_tol=1e-10,
                           relax_type="spai", relax_param=0.75,
                           nu_pre=2, nu_post=2,
                           transfer_type="systems-faces", engine="grid")
    state = mg_setup(A, M, cfg, rp)
    assert isinstance(state.hier, SystemsGridHierarchy)
    B = A @ np.random.rand(A.shape[0], 2)
    B = B / np.linalg.norm(B)
    X, info = solve_mg(state, B)
    assert np.linalg.norm(A @ np.asarray(X) - B) < 0.05
    X, _ = solve_cg_mg(state, B)
    assert np.linalg.norm(A @ np.asarray(X) - B) < 0.01


def test_systems_grid_convergence_mixed_vanka():
    """Reference testGMGRAPforElasticityVanka contract on the grid engine."""
    M, A = _elasticity(32, 2, True)
    cfg, rp = get_mg_param(levels=3, max_outer_iter=10, relative_tol=1e-10,
                           relax_type="VankaFaces", relax_param=0.75,
                           nu_pre=1, nu_post=1,
                           transfer_type="SystemsFacesMixedLinear",
                           engine="grid")
    state = mg_setup(A, M, cfg, rp)
    assert isinstance(state.hier, SystemsGridHierarchy)
    b = A @ np.random.rand(A.shape[0])
    b = b / np.linalg.norm(b)
    x, info = solve_mg(state, b)
    assert np.linalg.norm(A @ np.asarray(x) - b) < 0.05


def test_systems_grid_refined_solve():
    from mgtpu.solvers.mg_solver import solve_mg_refined
    M, A = _elasticity(32, 2, False)
    cfg, rp = get_mg_param(levels=3, max_outer_iter=40,
                           relax_type="spai", relax_param=0.75,
                           nu_pre=2, nu_post=2,
                           transfer_type="systems-faces", dtype=np.float32)
    state = mg_setup(A, M, cfg, rp)
    assert isinstance(state.hier, SystemsGridHierarchy)
    b = np.random.rand(A.shape[0])
    b /= np.linalg.norm(b)
    x, info = solve_mg_refined(state, b, tol=1e-9)
    assert info["relres"] < 1e-9
    assert np.linalg.norm(A @ np.asarray(x, dtype=np.float64) - b) < 2e-9


@pytest.mark.slow
def test_systems_grid_refined_uses_df32_block_residual():
    """Mixed elasticity certifies TRUE 1e-8 from an f32
    hierarchy through the df32 BLOCK residual (no emulated-f64 SpMV)."""
    from mgtpu.solvers.mg_solver import solve_mg_refined, _df32_residual_op
    from mgtpu.ops.df32 import DFBlockOperator
    M, A = _elasticity(32, 2, True)
    cfg, rp = get_mg_param(levels=3, max_outer_iter=40, relax_type="vanka",
                           relax_param=0.75, nu_pre=1, nu_post=1,
                           transfer_type="systems-faces-mixed",
                           dtype=np.float32)
    state = mg_setup(A, M, cfg, rp)
    assert isinstance(state.hier, SystemsGridHierarchy)
    op = _df32_residual_op(state)
    assert isinstance(op, DFBlockOperator)
    rng = np.random.RandomState(7)
    b = A @ rng.rand(A.shape[0])
    b /= np.linalg.norm(b)
    x, info = solve_mg_refined(state, b, tol=1e-8)
    tr = (np.linalg.norm(b - A.astype(np.float64) @ np.asarray(x, np.float64))
          / np.linalg.norm(b))
    assert tr < 1e-8, tr


def test_df32_block_residual_matches_f64():
    from mgtpu.ops.df32 import df_block_from_csr, df_residual_block
    from mgtpu.cycle.systems_grid import face_component_grids
    M, A = _elasticity(16, 2, True)
    grids, offs = face_component_grids([16, 16], True)
    dfB = df_block_from_csr(A, [16, 16], True)
    rng = np.random.RandomState(8)
    x64 = rng.rand(A.shape[0])
    b64 = rng.rand(A.shape[0])

    def split_fields(v):
        hi = v.astype(np.float32)
        lo = (v - hi.astype(np.float64)).astype(np.float32)
        return (block_to_fields(jnp.asarray(hi)[:, None], grids),
                block_to_fields(jnp.asarray(lo)[:, None], grids))

    bh, bl = split_fields(b64)
    xh, xl = split_fields(x64)
    rh, rl = df_residual_block(dfB, bh, bl, xh, xl)
    r = (np.asarray(fields_to_block(rh), np.float64)
         + np.asarray(fields_to_block(rl), np.float64))[:, 0]
    r_ref = b64 - A.astype(np.float64) @ x64
    scale = max(np.abs(r_ref).max(), 1e-30)
    assert np.abs(r - r_ref).max() / scale < 1e-12
