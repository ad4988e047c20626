"""Zero-initial-guess cycle specialization (x_zero): bitwise parity.

x_zero=True declares the incoming iterate exactly zero, letting every engine
skip the r = b - A*0 entry matvec (one matvec saved per level per cycle — on
the bench hierarchy ~1/3 of the coarse sub-cycle cost).
A@0 is exact zeros, so results must be BITWISE identical, not just close.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from mgtpu import get_mg_param, mg_setup, get_regular_mesh
from mgtpu.models.operators import nodal_laplacian_matrix


def _state2d(relax, ctype="V", **kw):
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [32, 32])
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(0).max() * sp.identity(L.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=3, relax_type=relax, relax_param=0.8,
                           nu_pre=1, nu_post=1, cycle_type=ctype,
                           dtype=np.float32, **kw)
    return mg_setup(L, M, cfg, rp), L


@pytest.mark.parametrize("relax,ctype", [
    ("jacobi", "V"), ("jacobi", "W"), ("jacobi", "F"),
    ("chebyshev", "V"), ("jac-gmres", "V"), ("jac-gmres", "K")])
def test_grid_engine_xzero_bitwise(relax, ctype):
    from mgtpu.cycle.grid_cycle import grid_cycle, GridHierarchy
    from mgtpu.ops.grid_stencil import flat_to_grid
    st, L = _state2d(relax, ctype)
    assert isinstance(st.hier, GridHierarchy)
    b = flat_to_grid(jnp.asarray(
        np.random.RandomState(0).rand(L.shape[0], 2).astype(np.float32)),
        st.hier.fine_grid)
    z = jnp.zeros_like(b)
    x_ref = np.asarray(grid_cycle(st.config, st.hier, b, z))
    x_opt = np.asarray(grid_cycle(st.config, st.hier, b, z, x_zero=True))
    assert np.array_equal(x_ref, x_opt)


def test_grid_engine_xzero_nu_pre0():
    from mgtpu.cycle.grid_cycle import grid_cycle
    from mgtpu.ops.grid_stencil import flat_to_grid
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [32, 32])
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(0).max() * sp.identity(L.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                           nu_pre=0, nu_post=2, dtype=np.float32)
    st = mg_setup(L, M, cfg, rp)
    b = flat_to_grid(jnp.asarray(
        np.random.RandomState(1).rand(L.shape[0], 1).astype(np.float32)),
        st.hier.fine_grid)
    z = jnp.zeros_like(b)
    x_ref = np.asarray(grid_cycle(cfg, st.hier, b, z))
    x_opt = np.asarray(grid_cycle(cfg, st.hier, b, z, x_zero=True))
    assert np.array_equal(x_ref, x_opt)


def test_flat_engine_xzero_bitwise():
    from mgtpu.cycle.cycle import recursive_cycle
    from mgtpu.setup.sa_amg import sa_amg_setup
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [24, 24])
    from mgtpu.models.operators import nodal_div_sig_grad_matrix
    sig = np.exp(np.random.RandomState(2).randn(24 * 24))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    for relax, ctype in (("spai", "V"), ("jac-gmres", "K")):
        cfg, rp = get_mg_param(levels=3, relax_type=relax, nu_pre=1,
                               nu_post=1, cycle_type=ctype, dtype=np.float32)
        st = sa_amg_setup(A, cfg, rp)
        b = jnp.asarray(np.random.RandomState(3)
                        .rand(A.shape[0], 1).astype(np.float32))
        z = jnp.zeros_like(b)
        x_ref = np.asarray(recursive_cycle(cfg, st.hier, b, z))
        x_opt = np.asarray(recursive_cycle(cfg, st.hier, b, z, x_zero=True))
        assert np.array_equal(x_ref, x_opt), (relax, ctype)


def test_systems_engine_xzero_bitwise():
    from mgtpu.cycle.systems_grid import (systems_grid_cycle,
                                          block_to_fields)
    from mgtpu.models.operators import linear_elasticity_operator_mixed
    Me = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [16, 16])
    mu = np.ones(Me.num_cells)
    Ae = linear_elasticity_operator_mixed(Me, mu, mu)
    Ae = (Ae + 1e-3 * abs(Ae).sum(0).max() * sp.identity(Ae.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=3, relax_type="VankaFaces",
                           relax_param=0.75, nu_pre=1, nu_post=1,
                           dtype=np.float32,
                           transfer_type="SystemsFacesMixedLinear")
    st = mg_setup(Ae, Me, cfg, rp)
    b = block_to_fields(jnp.asarray(
        np.random.RandomState(5).rand(Ae.shape[0], 1).astype(np.float32)),
        st.hier.fine_grids)
    z = tuple(jnp.zeros_like(t) for t in b)
    x_ref = systems_grid_cycle(cfg, st.hier, b, z)
    x_opt = systems_grid_cycle(cfg, st.hier, b, z, x_zero=True)
    for a, c in zip(x_ref, x_opt):
        assert np.array_equal(np.asarray(a), np.asarray(c))
