"""Smoke run of mgtpu's solve path on NVIDIA GPUs, at deployment size.

    python chip_smoke.py           # one GPU: four solve phases + reference checks
    python chip_smoke.py --multi   # four GPUs: sharded 4097^2 solve vs one GPU

Every phase goes through the public API (`mg_setup` / `sa_amg_setup` ->
`solve_mg_refined`), prints one line with its setup time, solve time,
iteration count and TRUE relative residual (the returned x certified on the
host against the original operator in scipy float64), and checks that its
iterate lives on the GPU.  The f32 contractions of the cycle and the
double-single residual are compared with float64 references on the same
inputs.  The script exits non-zero when JAX finds no GPU or when any phase
fails; only a run in which every phase passed prints the final JSON line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
import traceback

import numpy as np

TOL = 1e-8                # certified true relative residual of every solve
CONTRACTION_TOL = 1e-5    # f32 rounding; a TF32 product would show ~1e-3
DF32_TOL = 1e-12          # double-single residual vs the host f64 residual
PLATFORM = "gpu"          # platform every iterate must live on


def _require_gpu():
    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: JAX backend is {jax.default_backend()!r}; "
                 "this script runs on a GPU only")
    return jax.devices()


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def _shifted(A, rel):
    import scipy.sparse as sp
    return (A + rel * abs(A).sum(axis=0).max()
            * sp.identity(A.shape[0])).tocsr()


def _rhs(A, seed):
    b = A @ np.random.RandomState(seed).rand(A.shape[0])
    return b / np.linalg.norm(b)


def _true_relres(state, b, x) -> float:
    A = state.A_input.astype(np.float64)
    return float(np.linalg.norm(b - A @ np.asarray(x, np.float64))
                 / np.linalg.norm(b))


def _max_rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _check_on_device(state, b):
    """One jitted cycle from zero; its output must live on the GPU."""
    from mgtpu.solvers.mg_solver import solve_mg_jit
    z = solve_mg_jit(state, np.asarray(b, np.float32), num_cycles=1)
    plats = {d.platform for d in z.devices()}
    assert plats == {PLATFORM}, f"iterate lives on {plats}"
    assert bool(np.isfinite(np.asarray(z)).all()), "non-finite cycle output"


def _solve(name, state, b, setup_s, max_iter):
    """Refined solve twice (first call compiles), certify, report."""
    from mgtpu.solvers.mg_solver import solve_mg_refined
    t0 = time.perf_counter()
    solve_mg_refined(state, b, tol=TOL, max_iter=max_iter)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = solve_mg_refined(state, b, tol=TOL, max_iter=max_iter)
    solve_s = time.perf_counter() - t0
    rr = _true_relres(state, b, x)
    _check_on_device(state, b)
    print(f"phase {name}: setup_s={setup_s:.3f} solve_s={solve_s:.4f} "
          f"first_solve_s={first_s:.3f} iters={info['iters']} "
          f"true_relres={rr:.3e}", flush=True)
    assert rr <= TOL, f"{name}: true relres {rr:.3e} > {TOL}"
    return x, info


def _report(name, err, tol):
    print(f"check {name}: max_rel_err={err:.3e} (limit {tol:.0e})",
          flush=True)
    assert err <= tol, f"{name}: {err:.3e} > {tol:.0e}"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def poisson3d(n=256, levels=6):
    """3D nodal Laplacian, Chebyshev(3) V(1,0), plus the df32 residual."""
    import jax.numpy as jnp
    from mgtpu import get_mg_param, get_regular_mesh, mg_setup
    from mgtpu.cycle.grid_cycle import GridHierarchy
    from mgtpu.models.operators import nodal_laplacian_matrix
    from mgtpu.ops.df32 import df_const_from_csr, df_residual
    from mgtpu.ops.grid_stencil import flat_to_grid, grid_to_flat

    M = get_regular_mesh([0.0, 1.0] * 3, [n] * 3)
    L = _shifted(nodal_laplacian_matrix(M), 1e-4)
    b = _rhs(L, 1)
    cfg, rp = get_mg_param(levels=levels, relax_type="chebyshev",
                           cheby_degree=3, nu_pre=1, nu_post=0,
                           dtype=np.float32)
    t0 = time.perf_counter()
    st = mg_setup(L, M, cfg, rp)
    setup_s = time.perf_counter() - t0
    assert isinstance(st.hier, GridHierarchy)
    x, _ = _solve(f"poisson3d_{n + 1}", st, b, setup_s, 60)

    # double-single residual at the solution (where b - A x cancels to
    # ~1e-8 ||b||) against the host float64 residual
    grid = st.hier.fine_grid
    dfA = df_const_from_csr(st.A_input, [n + 1] * 3)

    def split(v):
        hi = v.astype(np.float32)
        lo = (v - hi.astype(np.float64)).astype(np.float32)
        return (flat_to_grid(jnp.asarray(hi)[:, None], grid),
                flat_to_grid(jnp.asarray(lo)[:, None], grid))

    rh, rl = df_residual(dfA, *split(b), *split(np.asarray(x, np.float64)))
    r = (np.asarray(grid_to_flat(rh), np.float64)
         + np.asarray(grid_to_flat(rl), np.float64))[:, 0]
    r_ref = b - st.A_input.astype(np.float64) @ np.asarray(x, np.float64)
    err = float(np.linalg.norm(r - r_ref) / np.linalg.norm(b))
    print(f"check df32_residual_{n + 1}: err/||b||={err:.3e} "
          f"err/||r||={np.linalg.norm(r - r_ref) / np.linalg.norm(r_ref):.3e}"
          f" (limit {DF32_TOL:.0e})", flush=True)
    assert err <= DF32_TOL, f"df32 residual {err:.3e} > {DF32_TOL:.0e}"


def poisson2d(n=4096, levels=7):
    """2D nodal Laplacian, Jacobi V(1,1); transfers and coarsest vs f64."""
    import jax
    import jax.numpy as jnp
    from mgtpu import get_mg_param, get_regular_mesh, mg_setup
    from mgtpu.cycle.grid_cycle import (DenseInverse, GridHierarchy,
                                        grid_prolong, grid_restrict)
    from mgtpu.models.operators import nodal_laplacian_matrix
    from mgtpu.setup.transfers import fw_interp_1d

    M = get_regular_mesh([0.0, 1.0] * 2, [n] * 2)
    L = _shifted(nodal_laplacian_matrix(M), 1e-4)
    b = _rhs(L, 2)
    cfg, rp = get_mg_param(levels=levels, relax_type="jacobi",
                           relax_param=0.8, nu_pre=1, nu_post=1,
                           dtype=np.float32)
    t0 = time.perf_counter()
    st = mg_setup(L, M, cfg, rp)
    setup_s = time.perf_counter() - t0
    assert isinstance(st.hier, GridHierarchy)
    assert max(st.hier.coarse.grid) <= 65, st.hier.coarse.grid
    _solve(f"poisson2d_{n + 1}", st, b, setup_s, 80)

    rng = np.random.RandomState(3)
    N = n + 1
    P1 = fw_interp_1d(N)[0].astype(np.float64)      # (N, c) scipy
    c = P1.shape[1]
    lvl0 = st.hier.levels[0]
    r = rng.rand(1, N, N).astype(np.float32)
    got = jax.jit(grid_restrict)(jnp.asarray(r), lvl0.P1)
    ref = 0.25 * (P1.T @ (P1.T @ r[0].astype(np.float64)).T).T
    _report(f"restrict_{N}", _max_rel_err(got[0], ref), CONTRACTION_TOL)
    xc = rng.rand(1, c, c).astype(np.float32)
    got = jax.jit(grid_prolong)(jnp.asarray(xc), lvl0.P1)
    ref = (P1 @ (P1 @ xc[0].astype(np.float64)).T).T
    _report(f"prolong_{N}", _max_rel_err(got[0], ref), CONTRACTION_TOL)
    coarse = st.hier.coarse
    assert isinstance(coarse, DenseInverse)
    bc = rng.rand(1, *coarse.grid).astype(np.float32)
    got = jax.jit(DenseInverse.solve)(coarse, jnp.asarray(bc))
    ref = np.asarray(coarse.inv, np.float64) @ bc.reshape(-1).astype(
        np.float64)
    _report(f"coarsest_inverse_{coarse.inv.shape[0]}",
            _max_rel_err(np.asarray(got).reshape(-1), ref), CONTRACTION_TOL)


def sa_amg(n=1024, levels=4):
    """SA-AMG (flat ELL engine) on rough DivSigGrad, K-cycle, Jac-GMRES."""
    import jax
    import jax.numpy as jnp
    from mgtpu import get_mg_param, get_regular_mesh
    from mgtpu.cycle.grid_cycle import GridHierarchy
    from mgtpu.cycle.relax import normal_equations
    from mgtpu.models.operators import nodal_div_sig_grad_matrix
    from mgtpu.setup.sa_amg import sa_amg_setup

    M = get_regular_mesh([0.0, 1.0] * 2, [n] * 2)
    sig = np.exp(np.random.RandomState(4).randn(n * n))
    A = _shifted(nodal_div_sig_grad_matrix(M, sig), 1e-8)
    b = _rhs(A, 5)
    cfg, rp = get_mg_param(levels=levels, relax_type="jac-gmres",
                           relax_param=1.0, nu_pre=1, nu_post=1,
                           cycle_type="K", dtype=np.float32)
    t0 = time.perf_counter()
    st = sa_amg_setup(A, cfg, rp)
    setup_s = time.perf_counter() - t0
    assert not isinstance(st.hier, GridHierarchy)    # flat ELL engine
    _solve(f"sa_amg_{n + 1}", st, b, setup_s, 300)

    # one FGMRES Gram product over two Krylov directions of this operator
    rng = np.random.RandomState(6)
    mv = st.hier.levels[0].A.matvec
    z = jnp.asarray(rng.rand(A.shape[0], 2).astype(np.float32))
    AZ = jnp.stack([mv(z[:, 0]), mv(z[:, 1])], axis=1)
    r = jnp.asarray(rng.rand(A.shape[0]).astype(np.float32))
    G, cv = jax.jit(normal_equations)(AZ, r)
    AZ64 = np.asarray(AZ, np.float64)
    _report("fgmres_gram", _max_rel_err(G, AZ64.T @ AZ64), CONTRACTION_TOL)
    _report("fgmres_projection",
            _max_rel_err(cv, AZ64.T @ np.asarray(r, np.float64)),
            CONTRACTION_TOL)


def vanka(n=256, levels=5):
    """Mixed elasticity with Vanka smoothing on the systems engine."""
    from mgtpu import get_mg_param, get_regular_mesh, mg_setup
    from mgtpu.cycle.systems_grid import SystemsGridHierarchy
    from mgtpu.models.operators import linear_elasticity_operator_mixed

    M = get_regular_mesh([0.0, 1.0] * 2, [n] * 2)
    mu = np.ones(M.num_cells)
    A = _shifted(linear_elasticity_operator_mixed(M, mu, mu), 1e-3)
    b = _rhs(A, 7)
    cfg, rp = get_mg_param(levels=levels, relax_type="VankaFaces",
                           relax_param=0.75, nu_pre=1, nu_post=1,
                           dtype=np.float32,
                           transfer_type="SystemsFacesMixedLinear")
    t0 = time.perf_counter()
    st = mg_setup(A, M, cfg, rp)
    setup_s = time.perf_counter() - t0
    assert isinstance(st.hier, SystemsGridHierarchy)
    _solve(f"vanka_{n}", st, b, setup_s, 100)


def multi(n=4096, levels=7, ndev=4):
    """Sharded refined solve on an ndev-GPU 1D mesh vs the one-GPU solve."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from mgtpu import get_mg_param, get_regular_mesh, mg_setup
    from mgtpu.models.operators import nodal_laplacian_matrix
    from mgtpu.parallel.sharded_solve import make_sharded_refined_solver

    devs = jax.devices()
    assert len(devs) >= ndev, f"{len(devs)} devices, need {ndev}"
    M = get_regular_mesh([0.0, 1.0] * 2, [n] * 2)
    L = _shifted(nodal_laplacian_matrix(M), 1e-4)
    b = _rhs(L, 2)
    cfg, rp = get_mg_param(levels=levels, relax_type="jacobi",
                           relax_param=0.8, nu_pre=1, nu_post=1,
                           dtype=np.float32)
    t0 = time.perf_counter()
    st = mg_setup(L, M, cfg, rp)
    setup_s = time.perf_counter() - t0
    _, info1 = _solve(f"poisson2d_{n + 1}_1gpu", st, b, setup_s, 80)

    # the 1D mesh follows the algorithm (slabs of the slowest grid axis);
    # every card reaches every other at the same rate
    mesh = Mesh(np.array(devs[:ndev]), ("x",))
    t0 = time.perf_counter()
    solver = make_sharded_refined_solver(st, mesh)
    shard_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver.solve_refined(b, tol=TOL, max_iter=80)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = solver.solve_refined(b, tol=TOL, max_iter=80)
    solve_s = time.perf_counter() - t0
    rr = _true_relres(st, b, x)
    bv, _ = solver.to_grid(b.astype(np.float32))
    z = solver.cycle(solver.gh, bv, jnp.zeros_like(bv))
    spans = len(z.sharding.device_set)
    print(f"phase poisson2d_{n + 1}_{ndev}gpu: setup_s={shard_s:.3f} "
          f"solve_s={solve_s:.4f} first_solve_s={first_s:.3f} "
          f"iters={info['iters']} true_relres={rr:.3e} "
          f"iters_1gpu={info1['iters']} iterate_devices={spans}",
          flush=True)
    assert spans == ndev, f"iterate spans {spans} devices, not {ndev}"
    assert {d.platform for d in z.sharding.device_set} == {PLATFORM}
    assert rr <= TOL, f"sharded true relres {rr:.3e} > {TOL}"
    assert abs(info["iters"] - info1["iters"]) <= 1, \
        (info["iters"], info1["iters"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded solve phase")
    args = ap.parse_args(argv)
    devs = _require_gpu()
    import jax
    print(f"card: {_card()}", flush=True)
    print(f"jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}",
          flush=True)
    phases = [multi] if args.multi else [poisson3d, poisson2d, sa_amg, vanka]
    failed = []
    t_all = time.perf_counter()
    for phase in phases:
        try:
            phase()
        except Exception:                          # noqa: BLE001
            traceback.print_exc()
            print(f"phase {phase.__name__}: FAILED", flush=True)
            failed.append(phase.__name__)
        gc.collect()
    print(f"wall_s={time.perf_counter() - t_all:.1f}", flush=True)
    if failed:
        sys.exit(f"chip_smoke: failed phases: {', '.join(failed)}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
