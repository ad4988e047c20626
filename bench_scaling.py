"""Multi-device scaling harness (BASELINE.md protocol item 3).

Runs the sharded GMG cycle at increasing device counts and reports per-cycle
time and parallel efficiency, for both distributed tiers:

 * shard_map  — hand-written slab sharding + ppermute halo exchange
   (parallel/sharded.py)
 * gspmd      — NamedSharding-annotated cycle, XLA-inserted collectives,
   slab or pencil mesh (parallel/grid_sharded.py)

On real multi-GPU hardware this measures true interconnect scaling; on a single host
it can still be exercised with virtual devices
(`XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
python bench_scaling.py`) to validate the communication pattern — virtual-
device timings share one set of host cores and are NOT a bandwidth statement.

Prints one JSON line per (tier, device-count).
"""
import json
import time

import numpy as np


def _chain(run, state0, ks=(2, 12), reps=3):
    import jax.numpy as jnp
    for k in ks:
        run(state0, k)
    times = {k: [] for k in ks}
    for _ in range(reps):
        for k in ks:
            t0 = time.perf_counter()
            run(state0, k)
            times[k].append(time.perf_counter() - t0)
    return (min(times[ks[1]]) - min(times[ks[0]])) / (ks[1] - ks[0])


def main(n=1024, levels=6):
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    from jax.sharding import Mesh
    from mgtpu import get_mg_param, mg_setup, get_regular_mesh
    from mgtpu.models.operators import nodal_laplacian_matrix
    from mgtpu.parallel.sharded import make_sharded_solver
    from mgtpu.parallel.grid_sharded import make_grid_sharded_cycle

    devs = jax.devices()
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(axis=0).max() * sp.identity(L.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=levels, relax_type="jacobi",
                           relax_param=0.8, nu_pre=1, nu_post=1,
                           dtype=np.float32)
    state = mg_setup(L, M, cfg, rp)
    nnz = sum(a.nnz for a in state.As)
    rng = np.random.RandomState(0)
    b = rng.rand(L.shape[0], 1).astype(np.float32)

    counts = [d for d in (1, 2, 4, 8) if d <= len(devs)]
    base = {}
    for tier in ("gspmd", "shard_map"):
        for D in counts:
            try:
                if tier == "gspmd":
                    mesh = Mesh(np.array(devs[:D]), ("x",))
                    gh, cycle, to_grid, _ = make_grid_sharded_cycle(
                        state, mesh)
                    bg = to_grid(b)
                    x0 = jnp.zeros_like(bg)

                    def run(s, k, cycle=cycle, gh=gh, bg=bg):
                        x = s
                        for _ in range(k):
                            x = cycle(gh, bg, x)
                        return float(jnp.sum(jnp.abs(x)))
                else:
                    mesh = Mesh(np.array(devs[:D]), ("x",))
                    mg, step_fn, to_grid, _ = make_sharded_solver(
                        state, mesh, dtype=np.float32)
                    bg = to_grid(b)
                    x0 = jnp.zeros_like(bg)

                    def run(s, k, step_fn=step_fn, mg=mg, bg=bg):
                        x = s
                        for _ in range(k):
                            x, rn = step_fn(mg, bg, x)
                        return float(rn)
                t = _chain(run, x0)
            except Exception as e:   # tier/shape not applicable at this D
                print(json.dumps({"tier": tier, "devices": D,
                                  "error": str(e)[:120]}))
                continue
            base.setdefault(tier, t)
            eff = base[tier] / (t * 1)      # strong scaling: t1 / (tD * 1)
            print(json.dumps({
                "tier": tier, "devices": D,
                "cycle_ms": round(t * 1e3, 3),
                "speedup_vs_1dev": round(base[tier] / t, 2),
                "gnnz_per_s": round(nnz / t / 1e9, 2),
            }))

    # end-to-end sharded refined solve (df32-certified to true 1e-8): the
    # solve-to-completion contract, one device dispatch per full solve
    from mgtpu.parallel.sharded_solve import make_sharded_refined_solver
    b64 = rng.rand(L.shape[0])
    for D in counts:
        try:
            mesh = Mesh(np.array(devs[:D]), ("x",))
            solver = make_sharded_refined_solver(state, mesh)
            x, info = solver.solve_refined(b64, tol=1e-8)   # warm compile
            reps = []
            for _ in range(3):
                t0 = time.perf_counter()
                x, info = solver.solve_refined(b64, tol=1e-8)
                reps.append(time.perf_counter() - t0)
            tr = float(np.linalg.norm(b64 - L.astype(np.float64) @ x)
                       / np.linalg.norm(b64))
        except Exception as e:
            print(json.dumps({"tier": "refined_solve", "devices": D,
                              "error": str(e)[:120]}))
            continue
        print(json.dumps({
            "tier": "refined_solve", "devices": D,
            "solve_to_1e-8_ms": round(min(reps) * 1e3, 3),
            "iters": int(info["iters"]),
            "true_relres_f64": tr,
        }))


if __name__ == "__main__":
    main()
