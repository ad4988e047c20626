"""Benchmark: mgtpu's solve paths on one NVIDIA GPU.

    python bench.py

Headline metric (BASELINE.md protocol): time per V-cycle on a 1024^2
Poisson problem (1025^2 nodes, ~5.2M nnz fine level), float32, 6-level
Galerkin hierarchy, Jacobi V(1,1), dense coarsest solve, grid stencil engine.
Sections add the 3D, SA-AMG, K-cycle, Vanka, line-smoother, multi-RHS and
flat-engine paths, setup times and certified time-to-1e-8.

Timing: two jitted chains of k1 and k2 dependent cycles, each forced to
completion by pulling a scalar to the host; the slope (t2 - t1) / (k2 - k1)
cancels the fixed dispatch cost (_chain_timer).

vs_baseline reports the speedup against the numerically identical V-cycle
executed with scipy CSR matvecs on this machine's CPU — the reference's own
platform class (an OpenMP CPU solver; the reference publishes no numbers).

Every section runs inside try/except; a failure records the exception under
detail.errors and the section's metrics stay null.  Prints the full-detail
JSON line, then a compact headline JSON as the final line.  Exits non-zero
when JAX finds no GPU.
"""
import json
import time
import traceback

import numpy as np


def _host_vcycle(state, b, x):
    """scipy-CSR V-cycle numerically identical to the device cycle (Jacobi)."""
    import scipy.sparse.linalg as spla
    cfg = state.config
    As, Ps, Rs = state.As, state.Ps, state.Rs
    if not hasattr(state, "_host_lu"):
        state._host_lu = spla.splu(As[-1].astype(np.float64).tocsc())

    def cycle(level, bb, xx):
        A = As[level]
        if level == len(As) - 1:
            return state._host_lu.solve(bb.astype(np.float64)).astype(bb.dtype)
        d = (state.relax_param / A.diagonal())[:, None]
        for _ in range(cfg.nu_pre[level]):
            xx = xx + d * (bb - A @ xx)
        r = bb - A @ xx
        bc = Rs[level] @ r
        xc = cycle(level + 1, bc, np.zeros((Rs[level].shape[0], bb.shape[1]),
                                           dtype=bb.dtype))
        xx = xx + Ps[level] @ xc
        for _ in range(cfg.nu_post[level]):
            xx = xx + d * (bb - A @ xx)
        return xx

    return cycle(0, b, x)


def _chain_timer(cycle, hier, b, x0, ks=(4, 54), reps=3):
    """Per-cycle time from the slope between two dependent-cycle chains.

    One program (dynamic trip count) runs k chained cycles and returns a
    scalar; pulling it to the host forces completion.  The k2-vs-k1 slope
    cancels the fixed dispatch and host round-trip cost.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def run(hier, b, x, k):
        x = lax.fori_loop(0, k, lambda i, xx: cycle(hier, b, xx), x)
        # scalar pulled to host forces completion
        return (sum(jnp.sum(t) for t in x) if isinstance(x, tuple)
                else jnp.sum(x))

    for k in ks:                       # compile + warm
        float(run(hier, b, x0, k))
    times = {k: [] for k in ks}
    for _ in range(reps):
        for k in ks:
            t0 = time.perf_counter()
            float(run(hier, b, x0, k))
            times[k].append(time.perf_counter() - t0)
    t1, t2 = min(times[ks[0]]), min(times[ks[1]])
    return (t2 - t1) / (ks[1] - ks[0]) * 1e3


def main():
    import os
    import subprocess
    import sys
    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"bench: JAX backend is {jax.default_backend()!r}; "
                 "the benchmark runs on a GPU only")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    T0 = time.perf_counter()
    errors = {}
    R = {}                  # section results; missing key -> metric null

    def section(name, fn):
        """Run one metric section with fault isolation."""
        try:
            fn()
        except Exception:                          # noqa: BLE001
            tb = traceback.format_exc().strip().split("\n")
            errors[name] = " | ".join(tb[-2:])[-400:]

    # the refinement metric needs REAL float64 residuals (without x64, f64
    # casts silently stay f32 and the 1e-8 claim would be fiction)
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import scipy.sparse as sp
    from mgtpu import get_mg_param, mg_setup, get_regular_mesh, make_cycle_fn
    from mgtpu.cycle.cycle import recursive_cycle
    from mgtpu.models.operators import nodal_laplacian_matrix

    n = 1024
    levels = 6
    dtype = np.float32
    rng = np.random.RandomState(0)

    def sec_setup2d():
        M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
        L = nodal_laplacian_matrix(M)
        L = (L + 1e-4 * abs(L).sum(axis=0).max()
             * sp.identity(L.shape[0])).tocsr()
        cfg, rp = get_mg_param(levels=levels, max_outer_iter=20,
                               relative_tol=1e-6, relax_type="jacobi",
                               relax_param=0.8, nu_pre=1, nu_post=1,
                               dtype=dtype)
        # setup cost: min over calls (steady state — the jInv workflow
        # re-setups per inversion iteration, MGsetup.jl:226-270; one-time XLA
        # compiles land in the persistent cache).
        t0 = time.perf_counter()
        state = mg_setup(L, M, cfg, rp)
        R["setup2_cold"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = mg_setup(L, M, cfg, rp)
        R["setup2"] = min(R["setup2_cold"], time.perf_counter() - t0)
        R.update(M=M, L=L, cfg=cfg, state=state)

    def sec_replace():
        from mgtpu import replace_matrix_in_hierarchy
        state, L = R["state"], R["L"]
        L_alt = (1.7 * L).tocsr()
        replace_s = None
        # sequence ends on L so the state solves the ORIGINAL operator again
        for A_new in (L_alt, L, L_alt, L):
            t0 = time.perf_counter()
            replace_matrix_in_hierarchy(state, A_new)
            dt = time.perf_counter() - t0
            replace_s = dt if replace_s is None else min(replace_s, dt)
        R["replace_s"] = replace_s

    def sec_headline():
        from mgtpu.cycle.grid_cycle import grid_cycle
        from mgtpu.ops.grid_stencil import flat_to_grid
        state, L, cfg = R["state"], R["L"], R["cfg"]
        b64 = L @ rng.rand(L.shape[0])
        b64 /= np.linalg.norm(b64)
        b = jnp.asarray(b64.astype(dtype))[:, None]
        bg = flat_to_grid(b, state.hier.fine_grid)
        R.update(b64=b64, b=b, bg=bg, grid_cycle=grid_cycle,
                 flat_to_grid=flat_to_grid)
        R["dev_ms"] = _chain_timer(
            lambda h, bb, xx: grid_cycle(cfg, h, bb, xx),
            state.hier, bg, jnp.zeros_like(bg))

    def sec_relres():
        state, cfg, b, b64, L = (R["state"], R["cfg"], R["b"], R["b64"],
                                 R["L"])
        cyc = make_cycle_fn(cfg)
        x = jnp.zeros_like(b)
        for _ in range(20):
            x = cyc(state.hier, b, x)
        R["relres"] = float(np.linalg.norm(
            b64 - L.astype(np.float64)
            @ np.asarray(x[:, 0], dtype=np.float64)))

    def sec_refined():
        # time-to-1e-8: mixed-precision iterative refinement around the f32
        # cycle (BASELINE.md end-to-end protocol).  The residual runs in
        # double-single (two-float32) compensated arithmetic (ops/df32.py),
        # which carries ~1e-13 accuracy, so the 1e-8 claim is certified
        # against the ORIGINAL f64 operator.
        from mgtpu.solvers.mg_solver import solve_mg_refined, \
            _df32_residual_op
        from mgtpu.ops.df32 import df_residual, df_accumulate
        state, cfg, bg, b64 = R["state"], R["cfg"], R["bg"], R["b64"]
        grid_cycle = R["grid_cycle"]
        dfA = _df32_residual_op(state)
        b_lo = jnp.asarray(
            (np.asarray(bg, np.float64)
             - np.asarray(bg, np.float64).astype(np.float32))
            .astype(np.float32))
        R["b_lo"] = b_lo

        def refined_iter(h, bb, carry):
            xh, xl, rh = carry
            z = grid_cycle(cfg, h, rh, jnp.zeros_like(rh), x_zero=True)
            xh, xl = df_accumulate(xh, xl, z)
            rh, _ = df_residual(dfA, bb, b_lo, xh, xl)
            return (xh, xl, rh)

        z0 = jnp.zeros_like(bg)
        R["z0"] = z0
        R["refined_ms"] = _chain_timer(refined_iter, state.hier, bg,
                                       (z0, z0, bg), ks=(2, 22), reps=3)
        xr, rinfo = solve_mg_refined(state, b64, tol=1e-8)
        R["iters_1e8"] = int(rinfo["iters"])
        # certify: true residual of the returned iterate vs the f64 operator
        R["true_rr"] = float(np.linalg.norm(
            b64 - state.A_input.astype(np.float64)
            @ np.asarray(xr, np.float64)))

    def sec_cheb():
        # Chebyshev(3) V(1,0) smoothing: no dot products, a fixed linear
        # operator; the fewest refined iterations of the smoother sweep on
        # this problem
        from mgtpu.solvers.mg_solver import solve_mg_refined, \
            _df32_residual_op
        from mgtpu.ops.df32 import df_residual, df_accumulate
        L, M, bg, b64, b_lo, z0 = (R["L"], R["M"], R["bg"], R["b64"],
                                   R["b_lo"], R["z0"])
        grid_cycle = R["grid_cycle"]
        cfg_c, rp_c = get_mg_param(levels=levels, relax_type="chebyshev",
                                   cheby_degree=3, nu_pre=1, nu_post=0,
                                   dtype=dtype)
        st_c = mg_setup(L, M, cfg_c, rp_c)
        dfA_c = _df32_residual_op(st_c)

        def refined_iter_c(h, bb, carry):
            xh, xl, rh = carry
            z = grid_cycle(cfg_c, h, rh, jnp.zeros_like(rh), x_zero=True)
            xh, xl = df_accumulate(xh, xl, z)
            rh, _ = df_residual(dfA_c, bb, b_lo, xh, xl)
            return (xh, xl, rh)

        R["refined_c_ms"] = _chain_timer(refined_iter_c, st_c.hier, bg,
                                         (z0, z0, bg), ks=(2, 22), reps=3)
        xc_r, cinfo = solve_mg_refined(st_c, b64, tol=1e-8)
        R["iters_c"] = int(cinfo["iters"])
        R["true_rr_c"] = float(np.linalg.norm(
            b64 - st_c.A_input.astype(np.float64)
            @ np.asarray(xc_r, np.float64)))
        # FMG + Chebyshev COMPOSITION (measured together
        # on the bench path): one cubic-interpolation FMG pass seeds the
        # refinement; time-to-1e-8 = fmg_pass + iters_fmg * refined-iter
        from mgtpu.cycle.grid_cycle import grid_fmg
        xf_r, finfo = solve_mg_refined(st_c, b64, tol=1e-8, fmg=True)
        R["iters_c_fmg"] = int(finfo["iters"])
        R["true_rr_c_fmg"] = float(np.linalg.norm(
            b64 - st_c.A_input.astype(np.float64)
            @ np.asarray(xf_r, np.float64)))
        R["fmg_pass_ms"] = _chain_timer(
            lambda h, bb, xx: grid_fmg(cfg_c, h, 0.5 * bb + 0.5 * xx),
            st_c.hier, bg, bg, ks=(2, 22), reps=2)

    def sec_vanka():
        # mixed-elasticity Vanka cycle (systems grid engine), the reference's
        # hardest smoother path (testGMGRAPforElasticityVanka workload)
        from mgtpu.cycle.systems_grid import (SystemsGridHierarchy,
                                              systems_grid_cycle,
                                              block_to_fields)
        from mgtpu.models.operators import linear_elasticity_operator_mixed
        Me = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [128, 128])
        mu = np.ones(Me.num_cells)
        Ae = linear_elasticity_operator_mixed(Me, mu, mu)
        Ae = (Ae + 1e-3 * abs(Ae).sum(axis=0).max()
              * sp.identity(Ae.shape[0])).tocsr()
        cfg_e, rp_e = get_mg_param(levels=4, relax_type="VankaFaces",
                                   relax_param=0.75, nu_pre=1, nu_post=1,
                                   dtype=dtype,
                                   transfer_type="SystemsFacesMixedLinear")
        st_e = mg_setup(Ae, Me, cfg_e, rp_e)
        assert isinstance(st_e.hier, SystemsGridHierarchy)
        be = block_to_fields(jnp.asarray(
            rng.rand(Ae.shape[0], 1).astype(dtype)), st_e.hier.fine_grids)
        # long chains: a short cycle needs a long slope window
        R["vanka_ms"] = _chain_timer(
            lambda h, bb, xx: systems_grid_cycle(cfg_e, h, bb, xx),
            st_e.hier, be, tuple(jnp.zeros_like(t) for t in be), ks=(4, 104),
            reps=2)

    def sec_sa():
        # structured SA-AMG on rough coefficients (reference headline AMG)
        from mgtpu.setup.sa_amg import sa_amg_setup
        from mgtpu.models.operators import nodal_div_sig_grad_matrix
        grid_cycle, flat_to_grid = R["grid_cycle"], R["flat_to_grid"]
        Ms = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [512, 512])
        sig = np.exp(rng.randn(512 * 512))
        As = nodal_div_sig_grad_matrix(Ms, sig)
        As = (As + 1e-8 * abs(As).sum(0).max()
              * sp.identity(As.shape[0])).tocsr()
        cfg_s, rp_s = get_mg_param(levels=4, relax_type="spai", dtype=dtype)
        st_s = sa_amg_setup(As, cfg_s, rp_s, mesh=Ms)
        bs = flat_to_grid(jnp.asarray(
            rng.rand(As.shape[0], 1).astype(dtype)), st_s.hier.fine_grid)
        R["sa_ms"] = _chain_timer(
            lambda h, bb, xx: grid_cycle(cfg_s, h, bb, xx),
            st_s.hier, bs, jnp.zeros_like(bs), ks=(2, 22))

    def sec_3d():
        # 3D Poisson 128^3 (BASELINE protocol: 2D AND 3D end-to-end)
        from mgtpu.solvers.mg_solver import solve_mg_refined
        grid_cycle, flat_to_grid = R["grid_cycle"], R["flat_to_grid"]
        M3 = get_regular_mesh([0.0, 1.0] * 3, [128, 128, 128])
        L3 = nodal_laplacian_matrix(M3)
        L3 = (L3 + 1e-4 * abs(L3).sum(axis=0).max()
              * sp.identity(L3.shape[0])).tocsr()
        cfg3, rp3 = get_mg_param(levels=5, relax_type="jacobi",
                                 relax_param=0.8, nu_pre=1, nu_post=1,
                                 dtype=dtype)
        t0 = time.perf_counter()
        st3 = mg_setup(L3, M3, cfg3, rp3)
        R["setup3_cold"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        st3 = mg_setup(L3, M3, cfg3, rp3)
        R["setup3"] = min(R["setup3_cold"], time.perf_counter() - t0)
        bg3 = flat_to_grid(jnp.asarray(
            rng.rand(L3.shape[0], 1).astype(dtype)), st3.hier.fine_grid)
        R["cycle3_ms"] = _chain_timer(
            lambda h, bb, xx: grid_cycle(cfg3, h, bb, xx),
            st3.hier, bg3, jnp.zeros_like(bg3), ks=(2, 22), reps=2)
        b3_64 = L3 @ rng.rand(L3.shape[0])
        b3_64 /= np.linalg.norm(b3_64)
        xr3, rinfo3 = solve_mg_refined(st3, b3_64, tol=1e-8, max_iter=40)
        R["iters3_1e8"] = int(rinfo3["iters"])
        R["true_rr3"] = float(np.linalg.norm(
            b3_64 - L3.astype(np.float64) @ np.asarray(xr3, np.float64)))
        # per-iteration cost of the SAME df32 refined loop (2D pattern:
        # sec_refined) -> 3D time-to-TRUE-1e-8 = refined3_ms * iters3
        from mgtpu.solvers.mg_solver import _df32_residual_op
        from mgtpu.ops.df32 import df_residual, df_accumulate
        dfA3 = _df32_residual_op(st3)
        b3_lo = jnp.asarray(
            (np.asarray(bg3, np.float64)
             - np.asarray(bg3, np.float64).astype(np.float32))
            .astype(np.float32))

        def refined3_iter(h, bb, carry):
            xh, xl, rh = carry
            z = grid_cycle(cfg3, h, rh, jnp.zeros_like(rh), x_zero=True)
            xh, xl = df_accumulate(xh, xl, z)
            rh, _ = df_residual(dfA3, bb, b3_lo, xh, xl)
            return (xh, xl, rh)

        z03 = jnp.zeros_like(bg3)
        R["refined3_ms"] = _chain_timer(refined3_iter, st3.hier, bg3,
                                        (z03, z03, bg3), ks=(2, 12), reps=2)
        # 3D fine-level SpMV throughput (XLA's fused stencil loop); the
        # rescale keeps the chained iterates finite (||A|| ~ 1e5 here)
        sc3 = np.float32(1.0 / abs(L3).sum(axis=0).max())
        R["mv3_ms"] = _chain_timer(
            lambda h, bb, xx: sc3 * h.levels[0].A.matvec(xx),
            st3.hier, bg3, bg3, ks=(2, 22), reps=2)
        R["gnnz3"] = st3.As[0].nnz * 1e3 / R["mv3_ms"] / 1e9

    def sec_3d_cheb():
        # 3D cheb3 V(1,0): about half the refined iterations of jacobi
        # V(1,1) (11 vs 22-23) at a slightly higher per-iteration cost
        from mgtpu.solvers.mg_solver import solve_mg_refined, \
            _df32_residual_op
        from mgtpu.ops.df32 import df_residual, df_accumulate
        grid_cycle, flat_to_grid = R["grid_cycle"], R["flat_to_grid"]
        M3 = get_regular_mesh([0.0, 1.0] * 3, [128, 128, 128])
        L3 = nodal_laplacian_matrix(M3)
        L3 = (L3 + 1e-4 * abs(L3).sum(axis=0).max()
              * sp.identity(L3.shape[0])).tocsr()
        cfg3c, rp3c = get_mg_param(levels=5, relax_type="chebyshev",
                                   cheby_degree=3, nu_pre=1, nu_post=0,
                                   dtype=dtype)
        st3c = mg_setup(L3, M3, cfg3c, rp3c)
        b3c = L3 @ np.random.RandomState(8).rand(L3.shape[0])
        b3c /= np.linalg.norm(b3c)
        xr, rinfo = solve_mg_refined(st3c, b3c, tol=1e-8, max_iter=40)
        R["iters3c"] = int(rinfo["iters"])
        R["true_rr3c"] = float(np.linalg.norm(
            b3c - L3.astype(np.float64) @ np.asarray(xr, np.float64)))
        dfA3 = _df32_residual_op(st3c)
        bg3 = flat_to_grid(jnp.asarray(
            b3c.astype(np.float32))[:, None], st3c.hier.fine_grid)
        b3_lo = flat_to_grid(jnp.asarray(
            (b3c - b3c.astype(np.float32).astype(np.float64))
            .astype(np.float32))[:, None], st3c.hier.fine_grid)

        def refined3c_iter(h, bb, carry):
            xh, xl, rh = carry
            z = grid_cycle(cfg3c, h, rh, jnp.zeros_like(rh), x_zero=True)
            xh, xl = df_accumulate(xh, xl, z)
            rh, _ = df_residual(dfA3, bb, b3_lo, xh, xl)
            return (xh, xl, rh)

        z03 = jnp.zeros_like(bg3)
        R["refined3c_ms"] = _chain_timer(refined3c_iter, st3c.hier, bg3,
                                         (z03, z03, bg3), ks=(2, 12), reps=2)

    def sec_kcycle():
        # K-cycle as ONE device program.  SA-AMG K-cycle with Jac-GMRES relax on the rough-coefficient 512^2 problem (the
        # reference's K-cycle workload, testSAforDivSigGrad.jl:80-83):
        # slope-timed per-cycle cost + steady-state refined-solve wall.
        from mgtpu.setup.sa_amg import sa_amg_setup
        from mgtpu.solvers.mg_solver import solve_mg_refined
        from mgtpu.models.operators import nodal_div_sig_grad_matrix
        grid_cycle, flat_to_grid = R["grid_cycle"], R["flat_to_grid"]
        Mk = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [512, 512])
        sigk = np.exp(np.random.RandomState(3).randn(512 * 512))
        Ak = nodal_div_sig_grad_matrix(Mk, sigk)
        Ak = (Ak + 1e-8 * abs(Ak).sum(0).max()
              * sp.identity(Ak.shape[0])).tocsr()
        cfg_k, rp_k = get_mg_param(levels=4, relax_type="jac-gmres",
                                   relax_param=1.0, nu_pre=1, nu_post=1,
                                   cycle_type="K", dtype=dtype)
        st_k = sa_amg_setup(Ak, cfg_k, rp_k, mesh=Mk)
        bk = flat_to_grid(jnp.asarray(
            rng.rand(Ak.shape[0], 1).astype(dtype)), st_k.hier.fine_grid)
        R["kcycle_ms"] = _chain_timer(
            lambda h, bb, xx: grid_cycle(cfg_k, h, bb, xx),
            st_k.hier, bk, jnp.zeros_like(bk), ks=(2, 12), reps=2)
        bk64 = Ak @ np.random.RandomState(4).rand(Ak.shape[0])
        bk64 /= np.linalg.norm(bk64)
        best = None
        # max_iter 70: this rough-sigma problem contracts at ~0.75/cycle
        # (the plain-V spai solve needs 50 iterations, sec_agg)
        for _ in range(2):                         # steady state: min of 2
            t0 = time.perf_counter()
            _, kinfo = solve_mg_refined(st_k, bk64, tol=1e-8, max_iter=70)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        iters = int(kinfo["iters"])
        relres = float(kinfo["relres"])
        R["kcycle_iters"] = iters
        R["kcycle_relres"] = float(f"{relres:.3e}")
        # cap-hit guard: a solve that stopped at max_iter without reaching
        # tol must NOT be reported as time-to-1e-8
        R["kcycle_solve_s"] = best if relres <= 1e-8 else None
        R["kcycle_wall_s"] = best

    def sec_line():
        # line smoother on the anisotropic configuration it exists for:
        # 257^2 eps=100, point-Jacobi cycle vs line-Jacobi cycle (doubling
        # scan tridiagonal solves)
        nl = 256
        Nl = nl + 1
        eps = 100.0
        T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1],
                     shape=(Nl, Nl)) * (nl ** 2)
        Il = sp.identity(Nl)
        Al = sp.csr_matrix(eps * sp.kron(Il, T) + sp.kron(T, Il))
        Ml = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [nl, nl])
        grid_cycle, flat_to_grid = R["grid_cycle"], R["flat_to_grid"]
        bl = np.random.RandomState(0).rand(Al.shape[0], 1).astype(dtype)
        out = {}
        for tag, rt, rp_l in (("point", "jacobi", 0.8),
                              ("line_doubling", "line-jacobi", 1.0)):
            try:
                cfg_l, rpv = get_mg_param(levels=4, relax_type=rt,
                                          relax_param=rp_l, nu_pre=1,
                                          nu_post=1, dtype=dtype)
                st_l = mg_setup(Al, Ml, cfg_l, rpv)
                blg = flat_to_grid(jnp.asarray(bl), st_l.hier.fine_grid)
                # long chains: these cycles are short
                out[tag] = round(_chain_timer(
                    lambda h, bb, xx: grid_cycle(cfg_l, h, bb, xx),
                    st_l.hier, blg, jnp.zeros_like(blg),
                    ks=(4, 104), reps=2), 4)
            except Exception:                      # noqa: BLE001
                out[tag] = None
        R["line_ms"] = out

    def sec_agg():
        # device (MIS-2) vs greedy aggregation decided on WALL-CLOCK
        # time-to-1e-8, not cycle count.  NO mesh is passed: with a mesh SA takes the structured-
        # aggregation path and the greedy/device choice never engages —
        # the knob only exists for unstructured operators (ELL engine).
        import os as _os
        from mgtpu.setup.sa_amg import sa_amg_setup
        from mgtpu.solvers.mg_solver import solve_mg_refined
        from mgtpu.models.operators import nodal_div_sig_grad_matrix
        Ma = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [512, 512])
        siga = np.exp(np.random.RandomState(5).randn(512 * 512))
        Aa = nodal_div_sig_grad_matrix(Ma, siga)
        Aa = (Aa + 1e-8 * abs(Aa).sum(0).max()
              * sp.identity(Aa.shape[0])).tocsr()
        ba = Aa @ np.random.RandomState(6).rand(Aa.shape[0])
        ba /= np.linalg.norm(ba)
        out = {}
        for agg in ("greedy", "device"):
            _os.environ["MGTPU_AGG"] = agg
            try:
                cfg_a, rp_a = get_mg_param(levels=4, relax_type="spai",
                                           dtype=dtype)
                t0 = time.perf_counter()
                st_a = sa_amg_setup(Aa, cfg_a, rp_a)
                setup_s = time.perf_counter() - t0
                best = None
                for _ in range(2):
                    t0 = time.perf_counter()
                    _, ainfo = solve_mg_refined(st_a, ba, tol=1e-8,
                                                max_iter=60)
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
                opc = sum(a.nnz for a in st_a.As) / st_a.As[0].nnz
                out[agg] = {"solve_s": round(best, 3),
                            "setup_s": round(setup_s, 3),
                            "iters": int(ainfo["iters"]),
                            "op_complexity": round(opc, 2)}
            except Exception:                      # noqa: BLE001
                out[agg] = None
        _os.environ.pop("MGTPU_AGG", None)
        R["agg_ab"] = out

    def sec_m8():
        # multi-RHS throughput (block cycles first-class, ref FGMRES.jl:51)
        grid_cycle, flat_to_grid = R["grid_cycle"], R["flat_to_grid"]
        state, L, cfg = R["state"], R["L"], R["cfg"]
        bg8 = flat_to_grid(jnp.asarray(
            rng.rand(L.shape[0], 8).astype(dtype)), state.hier.fine_grid)
        R["m8_ms"] = _chain_timer(
            lambda h, bb, xx: grid_cycle(cfg, h, bb, xx),
            state.hier, bg8, jnp.zeros_like(bg8), ks=(2, 22), reps=2)

    def sec_host():
        # host (CPU, scipy CSR) baseline: same cycle, float32 (vs_baseline)
        state, b64 = R["state"], R["b64"]
        bh = b64.astype(dtype)[:, None]
        xh = np.zeros_like(bh)
        xh = _host_vcycle(state, bh, xh)   # warm (splu factor)
        xh = np.zeros_like(bh)
        t0 = time.perf_counter()
        n_host = 3
        for _ in range(n_host):
            xh = _host_vcycle(state, bh, xh)
        R["host_ms"] = (time.perf_counter() - t0) / n_host * 1e3

    def sec_flat():
        # the flat (ELL/DIA) engine, for the record
        L, M, b = R["L"], R["M"], R["b"]
        cfg_f, rp_f = get_mg_param(levels=levels, relax_type="jacobi",
                                   relax_param=0.8, nu_pre=1, nu_post=1,
                                   dtype=dtype, engine="flat")
        state_f = mg_setup(L, M, cfg_f, rp_f)
        R["flat_ms"] = _chain_timer(
            lambda h, bb, xx: recursive_cycle(cfg_f, h, bb, xx),
            state_f.hier, b, jnp.zeros_like(b), ks=(2, 6), reps=2)

    for name, fn in (("setup2d", sec_setup2d), ("replace", sec_replace),
                     ("headline", sec_headline), ("poisson3d", sec_3d),
                     ("relres", sec_relres), ("refined", sec_refined),
                     ("cheb", sec_cheb), ("agg_ab", sec_agg),
                     ("line", sec_line), ("vanka", sec_vanka),
                     ("sa_amg", sec_sa), ("poisson3d_cheb", sec_3d_cheb),
                     ("kcycle", sec_kcycle), ("multirhs", sec_m8),
                     ("host_baseline", sec_host), ("flat_engine", sec_flat)):
        section(name, fn)

    def sec_comm():
        # comm-volume accounting on an 8-device virtual CPU mesh, in a child
        # process held to the CPU (it never opens the GPU)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r_ = subprocess.run(
            [sys.executable,
             os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tools", "comm_volume.py")],
            capture_output=True, timeout=600, env=env, text=True)
        R["comm"] = json.loads(r_.stdout.strip().splitlines()[-1])

    section("comm_volume", sec_comm)

    def r(v, nd=4):
        return None if v is None else round(v, nd)

    g = R.get
    dev_ms, host_ms = g("dev_ms"), g("host_ms")
    state = g("state")
    hier_nnz = (None if state is None
                else int(sum(a.nnz for a in state.As)))
    result = {
        "metric": "poisson2d_1024_gmg_vcycle_time",
        "value": r(dev_ms),
        "unit": "ms",
        "vs_baseline": (None if dev_ms is None or host_ms is None
                        else round(host_ms / dev_ms, 2)),
        "detail": {
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())},
            "card": card,
            "engine": None if state is None else type(state.hier).__name__,
            "fine_nnz": None if state is None else int(state.As[0].nnz),
            "hierarchy_nnz": hier_nnz,
            "host_cpu_vcycle_ms": r(host_ms, 3),
            "flat_engine_vcycle_ms": r(g("flat_ms"), 3),
            "relres_after_20_cycles": g("relres"),
            "elasticity_vanka_cycle_ms": r(g("vanka_ms")),
            "sa_amg_512_cycle_ms": r(g("sa_ms")),
            "refined_iter_ms": r(g("refined_ms")),
            "iters_to_relres_1e-8": g("iters_1e8"),
            "time_to_1e-8_jacobi_ms":
                (None if g("refined_ms") is None or g("iters_1e8") is None
                 else round(R["refined_ms"] * R["iters_1e8"], 3)),
            "true_relres_f64_certified":
                (None if g("true_rr") is None
                 else float(f"{R['true_rr']:.3e}")),
            "cheb_refined_iter_ms": r(g("refined_c_ms")),
            "cheb_iters_to_1e-8": g("iters_c"),
            "time_to_1e-8_ms":
                (None if g("refined_c_ms") is None or g("iters_c") is None
                 else round(R["refined_c_ms"] * R["iters_c"], 3)),
            "cheb_true_relres_f64":
                (None if g("true_rr_c") is None
                 else float(f"{R['true_rr_c']:.3e}")),
            "fmg_pass_ms": r(g("fmg_pass_ms")),
            "cheb_fmg_iters_to_1e-8": g("iters_c_fmg"),
            "time_to_1e-8_fmg_ms":
                (None if None in (g("fmg_pass_ms"), g("iters_c_fmg"),
                                  g("refined_c_ms"))
                 else round(R["fmg_pass_ms"]
                            + R["refined_c_ms"] * R["iters_c_fmg"], 3)),
            "fmg_true_relres_f64":
                (None if g("true_rr_c_fmg") is None
                 else float(f"{R['true_rr_c_fmg']:.3e}")),
            "gnnz_per_s": (None if dev_ms is None or hier_nnz is None
                           else round(hier_nnz * 4 * 1e3 / dev_ms / 1e9, 2)),
            "poisson3d_128_vcycle_ms": r(g("cycle3_ms")),
            "poisson3d_matvec_ms": r(g("mv3_ms")),
            "poisson3d_gnnz_per_s": r(g("gnnz3"), 2),
            "poisson3d_iters_to_1e-8": g("iters3_1e8"),
            "poisson3d_refined_iter_ms": r(g("refined3_ms")),
            "poisson3d_time_to_1e-8_ms":
                (None if g("refined3_ms") is None or g("iters3_1e8") is None
                 else round(R["refined3_ms"] * R["iters3_1e8"], 3)),
            "poisson3d_true_relres_f64":
                (None if g("true_rr3") is None
                 else float(f"{R['true_rr3']:.3e}")),
            "poisson3d_cheb_iters_to_1e-8": g("iters3c"),
            "poisson3d_cheb_refined_iter_ms": r(g("refined3c_ms")),
            "poisson3d_time_to_1e-8_cheb_ms":
                (None if g("refined3c_ms") is None or g("iters3c") is None
                 else round(R["refined3c_ms"] * R["iters3c"], 3)),
            "poisson3d_cheb_true_relres_f64":
                (None if g("true_rr3c") is None
                 else float(f"{R['true_rr3c']:.3e}")),
            "vcycle_8rhs_ms_per_rhs": r(None if g("m8_ms") is None
                                        else R["m8_ms"] / 8),
            "kcycle_512_sa_cycle_ms": r(g("kcycle_ms")),
            "kcycle_512_solve_1e-8_s": r(g("kcycle_solve_s"), 3),
            "kcycle_512_solve_wall_s": r(g("kcycle_wall_s"), 3),
            "kcycle_512_relres": g("kcycle_relres"),
            "kcycle_512_iters": g("kcycle_iters"),
            "line_257_cycle_ms": g("line_ms"),
            "agg_greedy_vs_device": g("agg_ab"),
            "comm_bytes_per_cycle": g("comm"),
            "setup_2d_1024_s": r(g("setup2"), 2),
            "setup_3d_128_s": r(g("setup3"), 2),
            "setup_2d_cold_s": r(g("setup2_cold"), 2),
            "setup_3d_cold_s": r(g("setup3_cold"), 2),
            "replace_matrix_s": r(g("replace_s"), 3),
            "bench_wall_s": round(time.perf_counter() - T0, 1),
            "errors": errors or None,
            # vs_baseline divides by a 1-THREAD scipy CSR cycle on this host
            # (the reference's platform class is an OpenMP CPU solver; an
            # 8-thread comparator would be roughly 8x smaller)
            "vs_baseline_note": "single-thread scipy CPU comparator",
        },
    }
    result["detail"]["utc"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                            time.gmtime())
    print(json.dumps(result))

    d = result["detail"]
    compact = {
        "metric": result["metric"],
        "value": result["value"],
        "unit": "ms",
        "vs_baseline": result["vs_baseline"],
        "detail": {
            "device": d["device"],
            "card": d["card"],
            "engine": d["engine"],
            "gnnz_per_s": d["gnnz_per_s"],
            "host_cpu_vcycle_ms": d["host_cpu_vcycle_ms"],
            "relres20": d["relres_after_20_cycles"],
            "time_to_1e-8_ms": d["time_to_1e-8_ms"],
            "time_to_1e-8_fmg_ms": d["time_to_1e-8_fmg_ms"],
            "vanka_cycle_ms": d["elasticity_vanka_cycle_ms"],
            "sa_512_cycle_ms": d["sa_amg_512_cycle_ms"],
            "p3d_vcycle_ms": d["poisson3d_128_vcycle_ms"],
            "p3d_matvec_ms": d["poisson3d_matvec_ms"],
            "p3d_time_to_1e-8_ms": d["poisson3d_time_to_1e-8_ms"],
            "p3d_time_to_1e-8_cheb_ms": d["poisson3d_time_to_1e-8_cheb_ms"],
            "m8_ms_per_rhs": d["vcycle_8rhs_ms_per_rhs"],
            "kcycle_ms": d["kcycle_512_sa_cycle_ms"],
            "kcycle_solve_1e-8_s": d["kcycle_512_solve_1e-8_s"],
            "kcycle_iters": d["kcycle_512_iters"],
            "kcycle_relres": d["kcycle_512_relres"],
            "line_ms": d["line_257_cycle_ms"],
            "agg_ab": d["agg_greedy_vs_device"],
            "setup2_s": d["setup_2d_1024_s"],
            "setup3_s": d["setup_3d_128_s"],
            "wall_s": d["bench_wall_s"],
            "n_errors": 0 if not errors else len(errors),
        },
    }
    print(json.dumps(compact))


if __name__ == "__main__":
    main()
