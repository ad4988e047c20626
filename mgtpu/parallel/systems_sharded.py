"""Multi-chip face-staggered systems multigrid via GSPMD auto-partitioning.

The scalar distributed tier (parallel/sharded.py) hand-writes its halo
exchange with shard_map + ppermute.  The systems engine
(cycle/systems_grid.py) is built entirely from ops GSPMD partitions well —
static shifts (cross stencils), windowed tensor contractions (Vanka), and
per-axis dense matmuls (transfers) — so its multi-chip form is the
"annotate shardings, let XLA insert the collectives" recipe: every component
field and every grid-shaped hierarchy leaf is sharded along the SLOWEST grid
axis of a 1D device mesh; the ±1 window shifts become collective-permute
halo exchanges between devices, and the replicated coarse dense solve needs no
communication (reference analog: the coarsest LU is always global,
MGsetup.jl:350).

Staggered grids mix extents n and n+1 along every axis, and XLA shards only
evenly-divisible dimensions, so the sharded hierarchy is a ZERO-PADDED
embedding along the sharded axis: cell-extents round up to C (a multiple of
the device count), face-extents to C + D.  The padding is inert by
construction — padded stencil coefficients, smoother diagonals, Vanka block
inverses and color masks are all zero, so every field's pad region stays
identically zero through the cycle and the restriction/prolongation factors
(zero-padded rows/columns) never move data in or out of it.  The unpadded
cycle result is therefore reproduced exactly (tests/test_systems_sharded.py
checks 1e-12 agreement on a virtual CPU mesh, mirroring how the reference
tests its Distributed tier with local processes,
test/DomainDecomposition/testDDParallel_Poisson.jl:2-6).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..cycle.systems_grid import (SystemsGridHierarchy, SystemsGridLevel,
                                  BlockGridOperator, BlockDenseInverse,
                                  GridVanka, systems_grid_cycle,
                                  block_to_fields, fields_to_block)
from ..ops.cross_stencil import CrossGridStencil

__all__ = ["pad_systems_hierarchy", "make_systems_sharded_cycle"]


def _cell_grid_of(grids) -> tuple:
    """Cell extents per grid axis = min over components (faces add 1 only
    along their own axis)."""
    return tuple(min(g[k] for g in grids) for k in range(len(grids[0])))


def _pad_axis0(a, new0, axis=0):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, new0 - a.shape[axis])
    return jnp.pad(a, pad) if new0 != a.shape[axis] else a


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["inner"], meta_fields=["pad_grids",
                                                       "true_grids"])
@dataclass(frozen=True)
class PaddedBlockCoarse:
    """Replicated coarse dense solve on the unpadded embedding."""
    inner: BlockDenseInverse
    pad_grids: tuple
    true_grids: tuple

    def solve(self, bs_field):
        sl = [b[(slice(None),) + tuple(slice(0, e) for e in g)]
              for b, g in zip(bs_field, self.true_grids)]
        xs = self.inner.solve(tuple(sl))
        return tuple(_pad_axis0(x, pg[0], axis=1)
                     for x, pg in zip(xs, self.pad_grids))


def pad_systems_hierarchy(gh: SystemsGridHierarchy, D: int
                          ) -> tuple[SystemsGridHierarchy, tuple]:
    """Zero-padded embedding of a systems hierarchy with every component's
    sharded-axis (grid axis 0) extent divisible by D.

    Returns (padded hierarchy, padded fine grids)."""
    def pad_grids_of(grids):
        cg0 = _cell_grid_of(grids)[0]
        C = -(-cg0 // D) * D
        out = []
        for g in grids:
            e = g[0]
            out.append((C if e == cg0 else C + D,) + tuple(g[1:]))
        return tuple(out)

    def pad_level(lvl: SystemsGridLevel, pgrids, pgrids_c):
        grids = lvl.A.grids
        sts = []
        for (ci, cj), s in zip(lvl.A.pairs, lvl.A.stencils):
            coeff = _pad_axis0(s.coeff, pgrids[ci][0], axis=1)
            sts.append(CrossGridStencil(coeff, s.offsets,
                                        pgrids[ci], pgrids[cj]))
        A = BlockGridOperator(tuple(sts), lvl.A.pairs, pgrids)
        d = (tuple(_pad_axis0(di, pg[0], axis=0)
                   for di, pg in zip(lvl.d, pgrids))
             if lvl.d is not None else None)
        vanka = None
        if lvl.vanka is not None:
            gv = lvl.vanka
            Ccells = min(pg[0] for pg in pgrids)       # padded cell extent
            cellg = (Ccells,) + tuple(gv.cell_grid[1:])
            vanka = GridVanka(_pad_axis0(gv.dinv, Ccells, axis=2),
                              _pad_axis0(gv.masks, Ccells, axis=1),
                              gv.slots, cellg, gv.variant)
        P1 = R1 = None
        if lvl.P1 is not None:
            P1, R1 = [], []
            for c, (pfacs, rfacs) in enumerate(zip(lvl.P1, lvl.R1)):
                # axis-0 factors act on this component's sharded extents at
                # the fine and coarse levels; later axes are untouched.
                # P factors are (fine, coarse), R factors (coarse, fine).
                pf0 = _pad_axis0(_pad_axis0(pfacs[0], pgrids[c][0], axis=0),
                                 pgrids_c[c][0], axis=1)
                rf0 = _pad_axis0(_pad_axis0(rfacs[0], pgrids_c[c][0], axis=0),
                                 pgrids[c][0], axis=1)
                P1.append((pf0,) + tuple(pfacs[1:]))
                R1.append((rf0,) + tuple(rfacs[1:]))
            P1, R1 = tuple(P1), tuple(R1)
        return SystemsGridLevel(A, d, vanka, P1, R1)

    pad_per_level = [pad_grids_of(lvl.A.grids) for lvl in gh.levels]
    levels = []
    for l, lvl in enumerate(gh.levels):
        pg_c = pad_per_level[l + 1] if l + 1 < len(gh.levels) else None
        levels.append(pad_level(lvl, pad_per_level[l], pg_c))
    coarse = PaddedBlockCoarse(gh.coarse, pad_per_level[-1],
                               gh.levels[-1].A.grids)
    return (SystemsGridHierarchy(tuple(levels), coarse), pad_per_level[0])


def _field_shardings(mesh: Mesh, grids, axis: str):
    return tuple(NamedSharding(mesh, P(None, axis, *(None,) * (len(g) - 1)))
                 for g in grids)


def _shard_hierarchy(gh: SystemsGridHierarchy, mesh: Mesh, axis: str
                     ) -> SystemsGridHierarchy:
    repl = NamedSharding(mesh, P())

    def put(a, *spec):
        return jax.device_put(a, NamedSharding(mesh, P(*spec)))

    levels = []
    for lvl in gh.levels:
        sts = [CrossGridStencil(
            put(s.coeff, None, axis, *(None,) * (len(s.out_grid) - 1)),
            s.offsets, s.out_grid, s.in_grid) for s in lvl.A.stencils]
        A = BlockGridOperator(tuple(sts), lvl.A.pairs, lvl.A.grids)
        d = (tuple(put(di, axis, *(None,) * (di.ndim - 1)) for di in lvl.d)
             if lvl.d is not None else None)
        vanka = None
        if lvl.vanka is not None:
            gv = lvl.vanka
            nc = len(gv.cell_grid)
            vanka = GridVanka(put(gv.dinv, None, None, axis,
                                  *(None,) * (nc - 1)),
                              put(gv.masks, None, axis, *(None,) * (nc - 1)),
                              gv.slots, gv.cell_grid, gv.variant)
        P1 = (tuple(tuple(jax.device_put(W, repl) for W in facs)
                    for facs in lvl.P1) if lvl.P1 is not None else None)
        R1 = (tuple(tuple(jax.device_put(W, repl) for W in facs)
                    for facs in lvl.R1) if lvl.R1 is not None else None)
        levels.append(SystemsGridLevel(A, d, vanka, P1, R1))
    coarse = PaddedBlockCoarse(
        BlockDenseInverse(jax.device_put(gh.coarse.inner.inv, repl),
                          gh.coarse.inner.grids),
        gh.coarse.pad_grids, gh.coarse.true_grids)
    return SystemsGridHierarchy(tuple(levels), coarse)


def make_systems_sharded_cycle(state, mesh: Mesh, axis: str = "x"):
    """(gh_sharded, cycle_fn, to_fields, from_fields) for a systems MGState.

    cycle_fn(gh, b_fields, x_fields) runs one cycle with all fields sharded
    along `axis` over the padded embedding; GSPMD inserts the halo
    collective-permutes.  to_fields/from_fields convert flat (n, m) vectors
    to/from sharded padded block fields.
    """
    cfg = state.config
    gh = state.hier
    if not isinstance(gh, SystemsGridHierarchy):
        raise ValueError("state does not use the systems grid engine")
    D = mesh.shape[axis]
    gh_pad, pgrids = pad_systems_hierarchy(gh, D)
    gh_sh = _shard_hierarchy(gh_pad, mesh, axis)
    true_grids = gh.fine_grids
    fsh = _field_shardings(mesh, pgrids, axis)

    def to_fields(b2):
        fs = block_to_fields(jnp.asarray(b2, dtype=cfg.dtype), true_grids)
        padded = tuple(_pad_axis0(f, pg[0], axis=1)
                       for f, pg in zip(fs, pgrids))
        return tuple(jax.device_put(f, s) for f, s in zip(padded, fsh))

    def from_fields(xs):
        sl = tuple(x[(slice(None),) + tuple(slice(0, e) for e in g)]
                   for x, g in zip(xs, true_grids))
        return fields_to_block(sl)

    cycle = jax.jit(lambda gh_, b_, x_, xz=False:
                    systems_grid_cycle(cfg, gh_, b_, x_, x_zero=xz),
                    static_argnums=(3,),
                    out_shardings=fsh)
    return gh_sh, cycle, to_fields, from_fields
