"""Every float32 contraction on the cycle and Krylov paths pins its precision.

XLA:GPU may run a float32 dot_general with default precision in TF32 (about
three decimal digits), which would silently cap the coarsest solve, the
Krylov projections, the Vanka block solves and the ELL SpMV.  These tests
trace each step and require HIGHEST on every dot_general with f32 operands.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from mgtpu import get_mg_param, get_regular_mesh, mg_setup
from mgtpu.models.operators import (linear_elasticity_operator_mixed,
                                    nodal_div_sig_grad_matrix,
                                    nodal_laplacian_matrix)

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _f32_dots(jaxpr, out):
    """(precision, operand avals) of every f32 dot_general, sub-jaxprs too."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
                v.aval.dtype == jnp.float32 for v in eqn.invars):
            out.append((eqn.params["precision"],
                        [str(v.aval) for v in eqn.invars]))
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if hasattr(sub, "eqns"):
                    _f32_dots(sub, out)
                elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                    _f32_dots(sub.jaxpr, out)
    return out


def _poisson2d(n=32):
    M = get_regular_mesh([0.0, 1.0] * 2, [n, n])
    L = nodal_laplacian_matrix(M)
    return M, (L + 1e-4 * abs(L).sum(0).max()
               * sp.identity(L.shape[0])).tocsr()


def _grid_cycle(relax, ctype):
    from mgtpu.cycle.grid_cycle import GridHierarchy, grid_cycle
    from mgtpu.ops.grid_stencil import flat_to_grid
    M, L = _poisson2d()
    cfg, rp = get_mg_param(levels=3, relax_type=relax, relax_param=0.8,
                           nu_pre=1, nu_post=1, cycle_type=ctype,
                           dtype=np.float32)
    st = mg_setup(L, M, cfg, rp)
    assert isinstance(st.hier, GridHierarchy)
    b = flat_to_grid(jnp.ones((L.shape[0], 2), jnp.float32),
                     st.hier.fine_grid)
    return jax.make_jaxpr(lambda h, bb: grid_cycle(cfg, h, bb,
                                                   jnp.zeros_like(bb)))(
        st.hier, b)


def _flat_sa_kcycle():
    from mgtpu.cycle.cycle import recursive_cycle
    from mgtpu.setup.sa_amg import sa_amg_setup
    M = get_regular_mesh([0.0, 1.0] * 2, [24, 24])
    sig = np.exp(np.random.RandomState(2).randn(24 * 24))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=3, relax_type="jac-gmres", nu_pre=1,
                           nu_post=1, cycle_type="K", dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp)
    b = jnp.ones((A.shape[0], 1), jnp.float32)
    return jax.make_jaxpr(lambda h, bb: recursive_cycle(
        cfg, h, bb, jnp.zeros_like(bb)))(st.hier, b)


def _vanka(engine):
    M = get_regular_mesh([0.0, 1.0] * 2, [16, 16])
    mu = np.ones(M.num_cells)
    A = linear_elasticity_operator_mixed(M, mu, mu)
    A = (A + 1e-3 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=3, relax_type="VankaFaces",
                           relax_param=0.75, nu_pre=1, nu_post=1,
                           dtype=np.float32, engine=engine,
                           transfer_type="SystemsFacesMixedLinear")
    st = mg_setup(A, M, cfg, rp)
    b = jnp.ones((A.shape[0], 1), jnp.float32)
    if engine == "flat":
        from mgtpu.cycle.cycle import recursive_cycle
        return jax.make_jaxpr(lambda h, bb: recursive_cycle(
            cfg, h, bb, jnp.zeros_like(bb)))(st.hier, b)
    from mgtpu.cycle.systems_grid import (block_to_fields,
                                          systems_grid_cycle)
    bf = block_to_fields(b, st.hier.fine_grids)
    return jax.make_jaxpr(lambda h, bb: systems_grid_cycle(
        cfg, h, bb, tuple(jnp.zeros_like(t) for t in bb)))(st.hier, bf)


def _block_cg():
    from mgtpu.krylov.block import block_pcg
    M, L = _poisson2d(16)
    from mgtpu.ops.grid_stencil import make_grid_stencil
    S = make_grid_stencil(L, [17, 17], dtype=np.float32)
    B = jnp.ones((4, 17, 17), jnp.float32)
    return jax.make_jaxpr(lambda bb: block_pcg(
        S.matvec, bb, max_iter=3, batch_leading=True)[0])(B)


def _fgmres():
    from mgtpu.krylov.fgmres import _fgmres_cycle
    M, L = _poisson2d(16)
    from mgtpu.ops.grid_stencil import make_grid_stencil
    S = make_grid_stencil(L, [17, 17], dtype=np.float32)
    B = jnp.ones((2, 17, 17), jnp.float32)
    return jax.make_jaxpr(lambda bb: _fgmres_cycle(
        S.matvec, lambda r: 0.5 * r, 3, True, jnp.zeros_like(bb), bb))(B)


def _sharded_grid():
    from jax.sharding import Mesh
    from mgtpu.parallel.grid_sharded import make_grid_sharded_cycle
    M, L = _poisson2d()
    cfg, rp = get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                           nu_pre=1, nu_post=1, dtype=np.float32)
    st = mg_setup(L, M, cfg, rp)
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    gh, cycle, to_grid, _ = make_grid_sharded_cycle(st, mesh)
    b = to_grid(np.ones((L.shape[0], 1), np.float32))
    return jax.make_jaxpr(lambda h, bb: cycle(h, bb, jnp.zeros_like(bb)))(
        gh, b)


CASES = {
    "grid_v_jacobi": lambda: _grid_cycle("jacobi", "V"),
    "grid_k_jac_gmres": lambda: _grid_cycle("jac-gmres", "K"),
    "flat_sa_k_jac_gmres": _flat_sa_kcycle,
    "systems_vanka": lambda: _vanka("grid"),
    "flat_vanka": lambda: _vanka("flat"),
    "block_cg": _block_cg,
    "fgmres": _fgmres,
    "sharded_grid": _sharded_grid,
}


@pytest.mark.parametrize("case", list(CASES))
def test_f32_contractions_pinned_highest(case):
    dots = _f32_dots(CASES[case]().jaxpr, [])
    assert dots, f"{case}: traced no f32 dot_general"
    loose = [d for d in dots if d[0] != HIGHEST]
    assert not loose, f"{case}: unpinned f32 contractions {loose}"
