"""Device-parallel AMG setup kernels (setup/device_agg.py): validity,
determinism, and convergence parity vs the sequential greedy path
(SURVEY §7 steps 6-7; reference SA-AMG.jl:119-211, coloring.jl:13-97)."""
import numpy as np
import pytest
import scipy.sparse as sp

from mgtpu import get_mg_param, get_regular_mesh, solve_mg
from mgtpu.models.operators import nodal_div_sig_grad_matrix
from mgtpu.setup.sa_amg import sa_amg_setup, strength_matrix
from mgtpu.setup.classical_amg import (classical_amg_setup,
                                       strength_matrix_classical)
from mgtpu.setup.device_agg import device_aggregation, pmis_coloring


def _op(n, rough=1.0, seed=0):
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    rng = np.random.RandomState(seed)
    L = nodal_div_sig_grad_matrix(M, np.exp(rough * rng.randn(n * n)))
    return (L + 1e-4 * abs(L).sum(0).max()
            * sp.identity(L.shape[0])).tocsr()


def _iters(st, L, b):
    x, res = solve_mg(st, b)
    return int(res["iters"]), float(np.asarray(res["relres"]).ravel()[-1])


def test_device_aggregation_valid_and_deterministic():
    L = _op(64)
    S = strength_matrix(L, 0.4)
    a1 = device_aggregation(S)
    a2 = device_aggregation(S)
    assert np.array_equal(a1, a2)
    assert (a1 >= 0).all()
    roots = np.unique(a1)
    # every aggregate label is a root labelled by itself
    assert np.array_equal(a1[roots], roots)
    # sane coarsening ratio for a 9-point strength graph
    ratio = L.shape[0] / len(roots)
    assert 2.0 < ratio < 9.5


def test_sa_device_convergence_parity(monkeypatch):
    """Cycle counts within +1 of the greedy aggregation;
    operator complexity within 2x (the measured trade: ~25% fewer cycles
    for ~40% more per-cycle work)."""
    L = _op(128)
    cfg, rp = get_mg_param(levels=5, relax_type="jacobi", relax_param=0.8,
                           nu_pre=2, nu_post=1, dtype=np.float64,
                           max_outer_iter=50, relative_tol=1e-8)
    b = L @ np.random.RandomState(1).rand(L.shape[0])
    b /= np.linalg.norm(b)
    monkeypatch.setenv("MGTPU_AGG", "greedy")
    st_g = sa_amg_setup(L, cfg, rp)
    it_g, rr_g = _iters(st_g, L, b)
    monkeypatch.setenv("MGTPU_AGG", "device")
    st_d = sa_amg_setup(L, cfg, rp)
    it_d, rr_d = _iters(st_d, L, b)
    assert rr_d < 1e-8 or rr_d <= rr_g
    assert it_d <= it_g + 1
    opc_g = sum(a.nnz for a in st_g.As) / st_g.As[0].nnz
    opc_d = sum(a.nnz for a in st_d.As) / st_d.As[0].nnz
    assert opc_d < 2.0 * opc_g


def test_pmis_coloring_contract():
    L = _op(64)
    S = strength_matrix_classical(L, 0.25)
    col = pmis_coloring(S)
    assert np.array_equal(col, pmis_coloring(S))   # deterministic
    assert set(np.unique(col)) <= {0, 1}
    # every F node with strong neighbors has a strong C neighbor (the
    # direct-interpolation requirement PMIS guarantees by construction)
    indptr, indices = S.indptr, S.indices
    for i in np.where(col == 0)[0]:
        nb = indices[indptr[i]:indptr[i + 1]]
        nb = nb[nb != i]
        assert len(nb) == 0 or np.any(col[nb] == 1)
    # no two adjacent C nodes should both dominate: C fraction is sane
    assert 0.15 < col.mean() < 0.6


def _op3d(n, nz, rough=1.0, seed=3):
    M = get_regular_mesh([0.0, 1.0] * 3, [n, n, nz])
    rng = np.random.RandomState(seed)
    L = nodal_div_sig_grad_matrix(M, np.exp(rough * rng.randn(n * n * nz)))
    return (L + 1e-4 * abs(L).sum(0).max()
            * sp.identity(L.shape[0])).tocsr()


def _pmis_vs_commonc(L, levels):
    """PMIS convergence contract vs the common-C reference path:
    SAME 1e-8 target, cycle count within ~30% of common-C, and an
    operator-complexity ceiling — a PMIS regression that doubles cycles or
    blows up coarse-level stencils must FAIL here."""
    cfg, rp = get_mg_param(levels=levels, relax_type="jacobi",
                           relax_param=0.8, nu_pre=2, nu_post=1,
                           dtype=np.float64, max_outer_iter=60,
                           relative_tol=1e-8)
    b = L @ np.random.RandomState(1).rand(L.shape[0])
    b /= np.linalg.norm(b)
    st_c = classical_amg_setup(L, cfg, rp, coarsening="common-c")
    it_c, rr_c = _iters(st_c, L, b)
    st_p = classical_amg_setup(L, cfg, rp, coarsening="pmis")
    it_p, rr_p = _iters(st_p, L, b)
    assert rr_p < 1e-8, (rr_p, rr_c)
    assert it_p <= 1.35 * it_c + 1, (it_p, it_c)
    opc_c = sum(a.nnz for a in st_c.As) / st_c.As[0].nnz
    opc_p = sum(a.nnz for a in st_p.As) / st_p.As[0].nnz
    assert opc_p <= max(1.5 * opc_c, opc_c + 0.5), (opc_p, opc_c)


def test_classical_pmis_contract_2d():
    _pmis_vs_commonc(_op(64), levels=4)


@pytest.mark.slow
def test_classical_pmis_contract_3d_rough():
    _pmis_vs_commonc(_op3d(16, 12), levels=3)
