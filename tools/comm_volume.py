"""Comm-volume accounting for the sharded tiers.

Compiles each sharded tier's cycle for an 8-device virtual CPU mesh and
counts the bytes its COLLECTIVES move per cycle, straight from the
post-SPMD compiled HLO.  This quantifies (for example) the
replicated-iterate AMG tier's all-gather cost and compares communication
structure across tiers without GPUs; it is not a scaling measurement.

Method: `jit(...).lower(args).compile().as_text()` gives the per-partition
HLO module; every `all-reduce` / `all-gather` / `collective-permute` /
`reduce-scatter` / `all-to-all` instruction's RESULT shape is the data that
lands on each device for that collective.  One V-cycle is fully unrolled
(no while loops), so static instruction counts ARE per-cycle counts.

Prints one JSON object; bench.py runs this as a CPU-only subprocess (it
never opens a GPU).
"""
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2,
                "u16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
                "u64": 8, "c64": 8, "c128": 16}

_COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
                "reduce-scatter", "all-to-all")


def _shape_bytes(s: str) -> int:
    """Total bytes of every typed array literal in an HLO shape string
    (handles tuples: sums the components)."""
    total = 0
    for m in re.finditer(r"(\w+)\[([0-9,]*)\]", s):
        dt, dims = m.groups()
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Per-device bytes moved by collectives in one execution of the module
    (async pairs counted once via the -start instruction)."""
    out = {op: {"count": 0, "bytes": 0} for op in _COLLECTIVES}
    pat = re.compile(
        r"=\s+([^=]+?)\s+(" + "|".join(_COLLECTIVES) + r")(-start)?\(")
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue
        m = pat.search(line)
        if not m:
            continue
        shape, op, _ = m.groups()
        out[op]["count"] += 1
        out[op]["bytes"] += _shape_bytes(shape)
    out = {k: v for k, v in out.items() if v["count"]}
    out["total_bytes_per_device"] = sum(v["bytes"] for v in out.values())
    return out


def _mesh(ndev=8):
    devs = jax.devices()[:ndev]
    return jax.sharding.Mesh(np.array(devs), ("x",))


def tier_grid2d(mesh, n=64, levels=4):
    """Slab-sharded scalar grid GMG cycle (parallel/grid_sharded.py)."""
    import jax.numpy as jnp
    from mgtpu import get_mg_param, mg_setup, get_regular_mesh
    from mgtpu.models.operators import nodal_laplacian_matrix
    from mgtpu.parallel.grid_sharded import make_grid_sharded_cycle
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(axis=0).max()
         * sp.identity(L.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=levels, relax_type="jacobi",
                           relax_param=0.8, nu_pre=1, nu_post=1,
                           dtype=np.float32)
    st = mg_setup(L, M, cfg, rp)
    gh, cycle, to_grid, _ = make_grid_sharded_cycle(st, mesh)
    b = to_grid(np.random.RandomState(0).rand(L.shape[0], 1)
                .astype(np.float32))
    x = jnp.zeros_like(b)
    hlo = cycle.lower(gh, b, x).compile().as_text()
    return collective_bytes(hlo), int(sum(a.nnz for a in st.As))


def tier_shardmap(mesh, n=64, levels=4):
    """shard_map + ppermute halo-exchange tier (parallel/sharded.py) —
    the explicitly-scheduled stencil path (one cycle + psum residual)."""
    import jax.numpy as jnp
    from mgtpu.parallel.sharded import make_sharded_solver
    import __graft_entry__ as ge
    st = ge._poisson_state(n, levels, np.float32)
    mg, step_fn, to_grid, _ = make_sharded_solver(st, mesh)
    b = to_grid(np.random.RandomState(0).rand(st.As[0].shape[0])
                .astype(np.float32))
    x = jnp.zeros_like(b)
    hlo = step_fn.lower(mg, b, x).compile().as_text()
    return collective_bytes(hlo), int(sum(a.nnz for a in st.As))


def tier_amg(mesh, n=64, levels=3):
    """Row-sharded ELL AMG tier with replicated iterates
    (parallel/sharded_amg.py) — expected to be all-gather dominated."""
    import jax.numpy as jnp
    from mgtpu import get_mg_param
    from mgtpu.setup.sa_amg import sa_amg_setup
    from mgtpu.models.operators import nodal_div_sig_grad_matrix
    from mgtpu import get_regular_mesh
    from mgtpu.parallel.sharded_amg import ShardedAMGSolver
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    sig = np.exp(np.random.RandomState(1).randn(n * n))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=levels, relax_type="spai",
                           dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp)
    solver = ShardedAMGSolver(st, mesh)
    b2, _ = solver._to_dev(np.random.RandomState(2).rand(A.shape[0]),
                           np.float32)
    x2 = jnp.zeros_like(b2)
    hlo = solver._cycle.lower(solver.hier, b2, x2).compile().as_text()
    return collective_bytes(hlo), int(sum(a.nnz for a in st.As))


def tier_part_amg(mesh, n=64, levels=3):
    """Partitioned-iterate AMG tier (parallel/part_amg.py): halo ppermutes
    only — the fix for the replicated tier's all-gather cost."""
    import jax.numpy as jnp
    from mgtpu import get_mg_param
    from mgtpu.setup.sa_amg import sa_amg_setup
    from mgtpu.models.operators import nodal_div_sig_grad_matrix
    from mgtpu import get_regular_mesh
    from mgtpu.parallel.part_amg import PartitionedAMGSolver
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    sig = np.exp(np.random.RandomState(1).randn(n * n))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=levels, relax_type="spai",
                           dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp)
    solver = PartitionedAMGSolver(st, mesh)
    b2, _ = solver._to_dev(np.random.RandomState(2).rand(A.shape[0]),
                           np.float32)
    x2 = jnp.zeros_like(b2)
    hlo = solver._cycle_sm.lower(solver.levels, solver.coarse, b2,
                                 x2).compile().as_text()
    return collective_bytes(hlo), int(sum(a.nnz for a in st.As))


def tier_part_kcycle(mesh, n=64, levels=3):
    """Partitioned K-cycle with Jac-GMRES smoothing (r5): quantifies the
    psum cost of the globalised FGMRES projections — each projection adds
    one (inner x inner + inner*m) all-reduce on top of the halo ppermutes."""
    import jax.numpy as jnp
    from mgtpu import get_mg_param
    from mgtpu.setup.sa_amg import sa_amg_setup
    from mgtpu.models.operators import nodal_div_sig_grad_matrix
    from mgtpu import get_regular_mesh
    from mgtpu.parallel.part_amg import PartitionedAMGSolver
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    sig = np.exp(np.random.RandomState(1).randn(n * n))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    cfg, rp = get_mg_param(levels=levels, relax_type="jac-gmres",
                           relax_param=1.0, nu_pre=1, nu_post=1,
                           cycle_type="K", dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp)
    solver = PartitionedAMGSolver(st, mesh)
    b2, _ = solver._to_dev(np.random.RandomState(2).rand(A.shape[0]),
                           np.float32)
    x2 = jnp.zeros_like(b2)
    hlo = solver._cycle_sm.lower(solver.levels, solver.coarse, b2,
                                 x2).compile().as_text()
    return collective_bytes(hlo), int(sum(a.nnz for a in st.As))


def main():
    mesh = _mesh()
    out = {"ndev": 8, "note": ("per-device bytes moved by collectives in "
                               "ONE compiled cycle (post-SPMD HLO), "
                               "8-device virtual CPU mesh")}
    for name, fn in (("grid2d_gspmd", tier_grid2d),
                     ("stencil_shardmap", tier_shardmap),
                     ("amg_replicated_iterates", tier_amg),
                     ("amg_partitioned_iterates", tier_part_amg),
                     ("amg_partitioned_kcycle", tier_part_kcycle)):
        try:
            acct, nnz = fn(mesh)
            if acct is not None:
                acct["hierarchy_nnz"] = nnz
                acct["bytes_per_nnz"] = round(
                    acct["total_bytes_per_device"] / max(nnz, 1), 3)
            out[name] = acct
        except Exception as e:                     # noqa: BLE001
            out[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
