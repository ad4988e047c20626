"""Multi-chip sharded geometric multigrid (shard_map over a device mesh).

The distributed execution tier (SURVEY.md §5): every non-coarsest level is
slab-sharded along the last grid dimension; halo planes move between devices with
`ppermute`, overlapped by XLA with the local stencil work; inter-level
transfers stay slab-local (coarse slab = half the fine slab, one halo plane);
the coarsest level is gathered once (`all_gather`) and solved with the
replicated dense LU on every chip — no communication on the way back except
the slab slice.  Norms use `psum`.  This replaces the reference's
master-centric Distributed scatter/gather (DDParallel.jl) with an
all-to-all-free neighbor exchange.

Scope: scalar full-weighting GMG hierarchies (the framework's headline
configuration) with damped-Jacobi relaxation, odd per-dim node counts
(2^k + 1 grids).  Built FROM an existing host MGState so the sharded cycle is
numerically the same hierarchy as the single-chip path.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..setup.hierarchy import MGState
from .stencil import (StencilLevel, TransferPlan, stencil_from_banded,
                      make_transfer_plan, stencil_matvec_local,
                      stencil_matvec_overlapped, exchange_halo,
                      restrict_local, prolong_local)

__all__ = ["ShardedMG", "build_sharded_mg", "make_sharded_cycle",
           "make_sharded_solver"]


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["coeff", "d", "masks", "ds_map"],
                   meta_fields=["di", "dj", "plan", "slab"])
@dataclass(frozen=True)
class ShardedLevel:
    coeff: jax.Array       # (ndiags, NJp, NI) — shard axis 1
    d: jax.Array           # (NJp, NI)         — shard axis 0
    masks: jax.Array       # (noffs, NI)       — replicated
    ds_map: jax.Array      # (NIc,) I-axis downsample map — replicated
    di: tuple
    dj: tuple
    plan: TransferPlan     # static (hashable)
    slab: int              # rows per device at this level


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["levels", "lu", "piv"],
                   meta_fields=["nu_pre", "nu_post", "coarse_nj", "n_nodes0"])
@dataclass(frozen=True)
class ShardedMG:
    levels: tuple          # ShardedLevel per non-coarsest level
    lu: jax.Array          # replicated dense LU of the coarsest operator
    piv: jax.Array
    nu_pre: tuple
    nu_post: tuple
    coarse_nj: int         # true J-extent of the coarsest grid
    n_nodes0: tuple        # fine-grid node counts


def build_sharded_mg(state: MGState, num_devices: int,
                     dtype=np.float32) -> ShardedMG:
    """Re-express a host GMG hierarchy in sharded stencil form."""
    import jax.scipy.linalg as jsl
    cfg = state.config
    if cfg.transfer_type != "full-weighting":
        raise ValueError("sharded path currently covers scalar full-weighting "
                         "hierarchies")
    nlev = state.num_levels
    rp = state.relax_param if np.isscalar(state.relax_param) else 1.0
    n_nodes = [tuple(int(v) + 1 for v in m.n) for m in state.meshes]

    # slab sizes: the COARSEST grid drives the padding; every finer level's
    # slab doubles so inter-level transfers stay slab-aligned
    njs = [nn[-1] for nn in n_nodes]
    slab_coarsest = int(-(-njs[-1] // num_devices))
    slabs = [0] * (nlev - 1)
    slabs[nlev - 2] = 2 * slab_coarsest
    for l in range(nlev - 3, -1, -1):
        slabs[l] = 2 * slabs[l + 1]
    for l in range(nlev - 1):
        assert slabs[l] * num_devices >= njs[l]

    levels = []
    for l in range(nlev - 1):
        st = stencil_from_banded(state.As[l], n_nodes[l], rp, dtype=dtype)
        NJp = slabs[l] * num_devices
        pad = NJp - st.shape[0]
        coeff = jnp.pad(st.coeff, ((0, 0), (0, pad), (0, 0)))
        d = jnp.pad(st.d, ((0, pad), (0, 0)))
        plan, masks, ds_map = make_transfer_plan(n_nodes[l])
        levels.append(ShardedLevel(coeff, d, jnp.asarray(masks, dtype),
                                   jnp.asarray(ds_map, np.int32),
                                   st.di, st.dj, plan, slabs[l]))

    A_c = np.asarray(state.As[-1].todense()).astype(dtype)
    lu, piv = jsl.lu_factor(jnp.asarray(A_c))
    return ShardedMG(tuple(levels), lu, piv, cfg.nu_pre, cfg.nu_post,
                     njs[-1], n_nodes[0])


def _relax(lvl: ShardedLevel, x, b, nu, axis):
    d = lvl.d[:, :, None]
    for _ in range(nu):
        r = b - stencil_matvec_overlapped(lvl.coeff, lvl.di, lvl.dj, x, axis)
        x = x + d * r
    return x


def _sharded_vcycle(mg: ShardedMG, b, x, level, axis):
    lvl = mg.levels[level]
    mv = lambda v: stencil_matvec_overlapped(lvl.coeff, lvl.di, lvl.dj, v,
                                             axis)
    with jax.named_scope(f"smg_level{level}"):
        x = _relax(lvl, x, b, mg.nu_pre[level], axis)
        r = b - mv(x)
        Sc = lvl.slab // 2
        bc = restrict_local(exchange_halo(r, axis), lvl.plan, lvl.masks,
                            lvl.ds_map, Sc)
        if level == len(mg.levels) - 1:
            with jax.named_scope("smg_coarsest"):
                # gather the true coarsest system, solve replicated, re-slice
                gathered = jax.lax.all_gather(bc, axis)          # (D, Sc, NIc, m)
                D = gathered.shape[0]
                m = gathered.shape[-1]
                NIc = lvl.plan.NIc
                flat = gathered.reshape(D * Sc, NIc, m)[: mg.coarse_nj]
                rhs = flat.reshape(mg.coarse_nj * NIc, m)
                import jax.scipy.linalg as jsl
                xc_flat = jsl.lu_solve((mg.lu, mg.piv), rhs)
                grid = jnp.pad(xc_flat.reshape(mg.coarse_nj, NIc, m),
                               ((0, D * Sc - mg.coarse_nj), (0, 0), (0, 0)))
                dev = jax.lax.axis_index(axis)
                xc = jax.lax.dynamic_slice_in_dim(grid, dev * Sc, Sc, axis=0)
        else:
            xc = jnp.zeros_like(bc)
            xc = _sharded_vcycle(mg, bc, xc, level + 1, axis)
        x = x + prolong_local(xc, lvl.plan, lvl.masks, lvl.ds_map, axis,
                              lvl.slab)
        x = _relax(lvl, x, b, mg.nu_post[level], axis)
    return x


def make_sharded_cycle(mesh: Mesh, axis: str = "x"):
    """Jitted sharded V-cycle: (ShardedMG, b_grid, x_grid) -> x_grid.

    b/x are (NJp, NI, m) grids sharded on axis 0 of `mesh[axis]`.
    """
    def cycle(mg, b, x):
        fn = shard_map(
            lambda mg_, b_, x_: _sharded_vcycle(mg_, b_, x_, 0, axis),
            mesh=mesh,
            in_specs=(_mg_specs(mg, axis), P(axis), P(axis)),
            out_specs=P(axis))
        return fn(mg, b, x)

    return jax.jit(cycle)


def make_sharded_solver(state: MGState, mesh: Mesh, axis: str = "x",
                        dtype=np.float32):
    """Full sharded MG solve step: returns (mg, step_fn, to_grid, from_grid).

    step_fn(mg, b_grid, x_grid) runs one V-cycle and the residual norm
    (psum-reduced) — the framework's 'training step' for the multichip dryrun.
    """
    ndev = mesh.shape[axis]
    mg = build_sharded_mg(state, ndev, dtype=dtype)
    NI = mg.levels[0].plan.NI
    NJ = mg.n_nodes0[-1]
    NJp = mg.levels[0].slab * ndev
    cycle = make_sharded_cycle(mesh, axis)

    def to_grid(v_flat):
        v = jnp.asarray(v_flat, dtype=mg.levels[0].d.dtype)
        squeeze = v.ndim == 1
        if squeeze:
            v = v[:, None]
        g = v.reshape(NJ, NI, v.shape[1])
        return jnp.pad(g, ((0, NJp - NJ), (0, 0), (0, 0)))

    def from_grid(g):
        return g[:NJ].reshape(NJ * NI, g.shape[-1])

    @jax.jit
    def step_fn(mg, b_grid, x_grid):
        x_grid = cycle(mg, b_grid, x_grid)
        # residual norm via the sharded operator (psum inside shard_map)
        def res(mg_, b_, x_):
            lvl = mg_.levels[0]
            r = b_ - stencil_matvec_overlapped(lvl.coeff, lvl.di, lvl.dj,
                                               x_, axis)
            return jnp.sqrt(jax.lax.psum(jnp.sum(jnp.abs(r) ** 2), axis))

        rn = shard_map(res, mesh=mesh,
                       in_specs=(_mg_specs(mg, axis), P(axis), P(axis)),
                       out_specs=P())(mg, b_grid, x_grid)
        return x_grid, rn

    return mg, step_fn, to_grid, from_grid


def _mg_specs(mg: ShardedMG, axis: str):
    return ShardedMG(tuple(
        ShardedLevel(P(None, axis), P(axis), P(), P(), l.di, l.dj, l.plan,
                     l.slab)
        for l in mg.levels),
        P(), P(), mg.nu_pre, mg.nu_post, mg.coarse_nj, mg.n_nodes0)
