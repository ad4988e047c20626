"""Partitioned-iterate sharded AMG tier (parallel/part_amg.py).

Contracts:
 * iterate/iteration-count parity with the single-chip flat engine,
 * per-device iterate memory = n/ndev + halo with halo << n/ndev,
 * refined solve certifies a TRUE f64 residual at tol,
 * Chebyshev (reduction-free) smoothing is supported,
 * the replicated-iterate restriction of ShardedAMGSolver is gone: no
   full-vector all-gather except the (small) coarsest solve.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from mgtpu import get_mg_param, get_regular_mesh
from mgtpu.cycle.cycle import make_cycle_fn
from mgtpu.models.operators import nodal_div_sig_grad_matrix
from mgtpu.setup.sa_amg import sa_amg_setup
from mgtpu.parallel.part_amg import PartitionedAMGSolver, partition_plan


def _mesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.sharding.Mesh(np.array(devs[:8]), ("x",))


def _divsiggrad(n, seed=1):
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    sig = np.exp(np.random.RandomState(seed).randn(n * n))
    A = nodal_div_sig_grad_matrix(M, sig)
    return (A + 1e-8 * abs(A).sum(0).max()
            * sp.identity(A.shape[0])).tocsr()


def test_partition_plan_remap_exact():
    """The remapped ELL + halo plan reproduces A @ x exactly (host check
    of the index algebra, no devices involved)."""
    A = _divsiggrad(20)
    ndev, n = 8, A.shape[0]
    p = -(-n // ndev)
    idx3, val3, dists, sends, H = partition_plan(A, ndev, p, p, np.float64)
    x = np.random.RandomState(0).rand(n)
    xp = np.pad(x, (0, ndev * p - n))
    blocks = xp.reshape(ndev, p)
    y = np.zeros((ndev, p))
    for s in range(ndev):
        halo = []
        for d, send in zip(dists, sends):
            t = (s - d) % ndev
            halo.append(blocks[t][send[t]])
        xf = np.concatenate([blocks[s]] + halo) if halo else blocks[s]
        y[s] = (val3[s] * xf[idx3[s]]).sum(axis=1)
    assert np.allclose(y.reshape(-1)[:n], A @ x, rtol=1e-12, atol=1e-12)


def test_cycle_parity_vs_single_chip():
    mesh = _mesh8()
    A = _divsiggrad(48)
    cfg, rp = get_mg_param(levels=3, relax_type="spai", dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp)
    solver = PartitionedAMGSolver(st, mesh)
    b = np.random.RandomState(2).rand(A.shape[0]).astype(np.float32)
    cyc = make_cycle_fn(cfg)
    b2 = jnp.asarray(b[:, None])
    x_ref = np.asarray(cyc(st.hier, b2, jnp.zeros_like(b2)))[:, 0]
    x_part = solver.cycle(b)
    err = np.abs(x_part - x_ref).max() / np.abs(x_ref).max()
    assert err < 1e-5


def test_refined_solve_certified_and_iteration_parity():
    mesh = _mesh8()
    A = _divsiggrad(48)
    cfg, rp = get_mg_param(levels=3, relax_type="spai", dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp)
    solver = PartitionedAMGSolver(st, mesh)
    b64 = A @ np.random.RandomState(3).rand(A.shape[0])
    b64 /= np.linalg.norm(b64)
    x, info = solver.solve_refined(b64, tol=1e-8, max_iter=40)
    rr = np.linalg.norm(b64 - A.astype(np.float64) @ x)
    assert rr < 1e-7
    # iteration parity with the single-chip refined driver
    from mgtpu.solvers.mg_solver import solve_mg_refined
    _, ref = solve_mg_refined(st, b64, tol=1e-8, max_iter=40)
    assert abs(info["iters"] - ref["iters"]) <= 1


def test_chebyshev_smoother_supported():
    mesh = _mesh8()
    A = _divsiggrad(40)
    cfg, rp = get_mg_param(levels=3, relax_type="chebyshev",
                           cheby_degree=2, nu_pre=1, nu_post=1,
                           dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp)
    solver = PartitionedAMGSolver(st, mesh)
    b64 = A @ np.random.RandomState(4).rand(A.shape[0])
    b64 /= np.linalg.norm(b64)
    x, info = solver.solve_refined(b64, tol=1e-8, max_iter=60)
    assert np.linalg.norm(b64 - A.astype(np.float64) @ x) < 1e-7


def test_memory_scales_with_devices():
    """The partitioned tier's scaling claim: per-device vector rows are
    ceil(n/ndev) and the halo is a small fraction of the local block."""
    mesh = _mesh8()
    A = _divsiggrad(48)
    cfg, rp = get_mg_param(levels=3, relax_type="spai", dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp)
    solver = PartitionedAMGSolver(st, mesh)
    rows = solver.local_vector_rows()
    assert rows[0] == -(-A.shape[0] // 8)
    comm = solver.comm_entries_per_cycle()
    # hand-computed fine-level bound: the 9-point
    # operator on the 49x49 grid has row bandwidth 50, so a contiguous
    # block of rows references at most 50 off-block columns per side
    assert comm[0]["A"]["halo_entries"] <= 2 * 50
    assert comm[0]["A"]["halo_entries"] >= 49   # at least one grid line


def test_unsupported_configs_raise():
    mesh = _mesh8()
    A = _divsiggrad(30)
    cfg, rp = get_mg_param(levels=3, relax_type="spai", dtype=np.float64)
    st = sa_amg_setup(A, cfg, rp)
    with pytest.raises(ValueError, match="float32"):
        PartitionedAMGSolver(st, mesh)


def test_kcycle_jacgmres_parity_vs_single_chip():
    """K-cycle + Jac-GMRES smoothing fully partitioned:
    the FGMRES projections psum their Gram inner products over the mesh
    axis, so iterates match the single-chip flat engine and the refined
    iteration count is identical."""
    mesh = _mesh8()
    A = _divsiggrad(48)
    cfg, rp = get_mg_param(levels=3, relax_type="jac-gmres",
                           relax_param=1.0, nu_pre=1, nu_post=1,
                           cycle_type="K", dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp)
    solver = PartitionedAMGSolver(st, mesh)
    b = np.random.RandomState(7).rand(A.shape[0]).astype(np.float32)
    cyc = make_cycle_fn(cfg)
    b2 = jnp.asarray(b[:, None])
    x_ref = np.asarray(cyc(st.hier, b2, jnp.zeros_like(b2)))[:, 0]
    x_part = solver.cycle(b)
    err = np.abs(x_part - x_ref).max() / np.abs(x_ref).max()
    assert err < 1e-4
    # refined-solve iteration parity end-to-end
    from mgtpu.solvers.mg_solver import solve_mg_refined
    b64 = A @ np.random.RandomState(8).rand(A.shape[0])
    b64 /= np.linalg.norm(b64)
    x, info = solver.solve_refined(b64, tol=1e-8, max_iter=40)
    assert np.linalg.norm(b64 - A.astype(np.float64) @ x) < 1e-7
    _, ref = solve_mg_refined(st, b64, tol=1e-8, max_iter=40)
    assert abs(info["iters"] - ref["iters"]) <= 1


def test_sparse_lu_coarsest_supported():
    """SparseLUCoarse (host SuperLU) coarsest inside the partitioned cycle
    (the reference's UMFPACK coarsest has no dense-size
    limit, MGsetup.jl:350)."""
    from mgtpu.cycle.coarse import sparse_lu_from_scipy
    from mgtpu.setup.hierarchy import Hierarchy
    mesh = _mesh8()
    A = _divsiggrad(48)
    cfg, rp = get_mg_param(levels=3, relax_type="spai", dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp)
    # swap the coarsest for the host-SuperLU form on BOTH sides of the
    # parity check
    st.hier = Hierarchy(st.hier.levels,
                        sparse_lu_from_scipy(st.As[-1], dtype=np.float32))
    solver = PartitionedAMGSolver(st, mesh)
    b = np.random.RandomState(9).rand(A.shape[0]).astype(np.float32)
    cyc = make_cycle_fn(cfg)
    b2 = jnp.asarray(b[:, None])
    x_ref = np.asarray(cyc(st.hier, b2, jnp.zeros_like(b2)))[:, 0]
    x_part = solver.cycle(b)
    err = np.abs(x_part - x_ref).max() / np.abs(x_ref).max()
    assert err < 1e-5


def test_gmres_coarsest_fully_partitioned():
    """coarse_solve='gmres' (IterativeCoarse) inside the partitioned cycle:
    the coarsest FGMRES runs on PartELL with psum'ed projections — the only
    coarsest with NO replication (reference escape hatch MGcycle.jl:152-168,
    distributed)."""
    mesh = _mesh8()
    A = _divsiggrad(48)
    cfg, rp = get_mg_param(levels=3, relax_type="spai",
                           coarse_solve="gmres", dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp)
    from mgtpu.cycle.coarse import IterativeCoarse
    assert isinstance(st.hier.coarse, IterativeCoarse)
    solver = PartitionedAMGSolver(st, mesh)
    from mgtpu.parallel.part_amg import PartIterativeCoarse
    assert isinstance(solver.coarse, PartIterativeCoarse)
    b = np.random.RandomState(15).rand(A.shape[0]).astype(np.float32)
    cyc = make_cycle_fn(cfg)
    b2 = jnp.asarray(b[:, None])
    x_ref = np.asarray(cyc(st.hier, b2, jnp.zeros_like(b2)))[:, 0]
    x_part = solver.cycle(b)
    err = np.abs(x_part - x_ref).max() / np.abs(x_ref).max()
    # looser than the LU-coarsest parity: the inner=10 FGMRES projection
    # solves NORMAL equations in f32 (condition number squared), so psum'ed
    # partial Gram sums vs one matmul legitimately differ at ~1e-3
    assert err < 5e-3
    # the meaningful contract: refined-solve parity with single-chip.  The
    # inner=10 Jacobi-FGMRES coarsest is LOOSE by design (the reference's
    # escape hatch), so on this rough-sigma problem the refinement floor is
    # ~2.6e-7 on one chip too — assert the partitioned tier reaches the
    # same floor, not an absolute 1e-8
    from mgtpu.solvers.mg_solver import solve_mg_refined
    b64 = A @ np.random.RandomState(16).rand(A.shape[0])
    b64 /= np.linalg.norm(b64)
    x, info = solver.solve_refined(b64, tol=1e-6, max_iter=60)
    rr = np.linalg.norm(b64 - A.astype(np.float64) @ x)
    _, ref = solve_mg_refined(st, b64, tol=1e-6, max_iter=60)
    assert rr < 2.0 * max(float(ref["relres"]), 1e-9)
    assert abs(info["iters"] - ref["iters"]) <= 2
    # and the comm accounting reports the coarsest halo
    comm = solver.comm_entries_per_cycle()
    assert "coarse_gmres" in comm[2]


def test_part_amg_3d_rough_coefficients():
    """3D stress shape: rough-coefficient div-sigma-grad
    at 20^3, cycle parity + certified refined solve."""
    mesh = _mesh8()
    M = get_regular_mesh([0.0, 1.0] * 3, [20, 20, 20])
    sig = np.exp(np.random.RandomState(11).randn(20 ** 3))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=3, relax_type="spai", dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp)
    solver = PartitionedAMGSolver(st, mesh)
    b = np.random.RandomState(12).rand(A.shape[0]).astype(np.float32)
    cyc = make_cycle_fn(cfg)
    b2 = jnp.asarray(b[:, None])
    x_ref = np.asarray(cyc(st.hier, b2, jnp.zeros_like(b2)))[:, 0]
    x_part = solver.cycle(b)
    assert np.abs(x_part - x_ref).max() / np.abs(x_ref).max() < 1e-4
    b64 = A @ np.random.RandomState(13).rand(A.shape[0])
    b64 /= np.linalg.norm(b64)
    x, info = solver.solve_refined(b64, tol=1e-8, max_iter=60)
    assert np.linalg.norm(b64 - A.astype(np.float64) @ x) < 1e-7
    # 3D surface/volume: a 21^3 block sliced into 8 slabs of ~1159 rows
    # (~2.6 z-planes of 441) needs ~2 plane-sized halos per neighbor pair
    comm = solver.comm_entries_per_cycle()
    rows = solver.local_vector_rows()[0]
    assert comm[0]["A"]["halo_entries"] <= 2 * (21 * 21 + 2 * 21 + 2)
    assert comm[0]["A"]["halo_entries"] < rows


def test_multi_distance_halo_plan_device_exact():
    """A plan with >2 ring distances by construction:
    couplings at row offsets ~1.5*p and ~2.5*p force |distances| >= 4; the
    remapped device matvec through shard_map stays exact."""
    from jax.sharding import PartitionSpec as P
    from mgtpu.parallel.part_amg import PartELL
    mesh = _mesh8()
    ndev, p = 8, 50
    n = ndev * p
    rng = np.random.RandomState(21)
    diags = [(0, 4.0), (1, -1.0), (-1, -1.0),
             (75, -0.5), (-75, -0.5), (125, -0.25), (-125, -0.25)]
    A = sp.csr_matrix(sum(sp.diags(np.full(n - abs(o), v), o,
                                   shape=(n, n)) for o, v in diags))
    idx3, val3, dists, sends, H = partition_plan(A, ndev, p, p, np.float32)
    assert len(dists) >= 4          # 1, 2, 3 and their ring complements
    ops = PartELL(jnp.asarray(idx3), jnp.asarray(val3),
                  tuple(jnp.asarray(s) for s in sends),
                  (p, p + H), dists, ndev, "x")
    x = rng.rand(n, 1).astype(np.float32)

    def body(op_dev, xb):
        op = jax.tree_util.tree_map(lambda a: a[0], op_dev)
        return op.matvec(xb)

    y = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("x"), P("x")),
        out_specs=P("x"), check_vma=False))(
            ops, jnp.asarray(x.reshape(ndev, p, 1)).reshape(n, 1))
    assert np.allclose(np.asarray(y)[:, 0], A @ x[:, 0],
                       rtol=1e-5, atol=1e-5)
