"""Multi-chip scalar grid-engine multigrid via GSPMD auto-partitioning.

Complementary to the hand-written slab tier (parallel/sharded.py, shard_map +
ppermute over a 1D mesh): this variant shards the SAME single-chip hierarchy
(cycle/grid_cycle.py) over a 1D or 2D device mesh with `NamedSharding`
annotations and lets XLA insert the halo collective-permutes.  A 2D (pencil)
decomposition keeps the surface-to-volume ratio — and therefore the halo
traffic per device — bounded as the device count grows, which a slab
decomposition cannot do.

Grid extents are 2^k + 1 (odd), so as in parallel/systems_sharded.py the
sharded hierarchy is a ZERO-PADDED embedding: every sharded grid axis rounds
up to a multiple of its mesh-axis size.  Padded stencil coefficients and
smoother diagonals are zero, so the pad region stays identically zero through
the cycle, and the transfers become per-axis dense 1D factors with zero
rows/columns in the pad (applied as full-precision matmuls), so no data
crosses the pad boundary.  Sharded levels use the dense-stencil form (the
constant-interior compression's region concatenation partitions poorly;
coefficient reads are the price of sharding).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..cycle.grid_cycle import (GridHierarchy, GridLevel, DenseInverse,
                                grid_cycle)
from ..ops.grid_stencil import (GridStencil, ConstGridStencil, flat_to_grid,
                                grid_to_flat)
from ..setup.transfers import fw_interp_1d

__all__ = ["make_grid_sharded_cycle", "pad_grid_hierarchy",
           "PaddedDenseInverse"]


def _pad_to(a, targets, axes):
    pad = [(0, 0)] * a.ndim
    for t, ax in zip(targets, axes):
        pad[ax] = (0, t - a.shape[ax])
    if all(p == (0, 0) for p in pad):
        return a
    return jnp.pad(a, pad)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["inner"], meta_fields=["pad_grid"])
@dataclass(frozen=True)
class PaddedDenseInverse:
    """Replicated dense coarse solve on the unpadded embedding.

    `inner` is any replicated grid-form coarse with .solve/.grid."""
    inner: DenseInverse
    pad_grid: tuple

    def solve(self, bg):
        sl = bg[(slice(None),) + tuple(slice(0, e) for e in self.inner.grid)]
        xg = self.inner.solve(sl)
        return _pad_to(xg, self.pad_grid, range(1, xg.ndim))


def pad_grid_hierarchy(gh: GridHierarchy, divs: tuple[int, ...]
                       ) -> GridHierarchy:
    """Zero-padded embedding: grid axis a of every level rounds up to a
    multiple of divs[a] (1 = unsharded axis)."""
    def pad_extents(grid):
        return tuple(-(-g // d) * d for g, d in zip(grid, divs))

    if not isinstance(gh.coarse, DenseInverse):
        raise ValueError("sharded grid engine needs the dense coarse inverse")

    levels = []
    for l, lvl in enumerate(gh.levels):
        A = lvl.A
        if isinstance(A, ConstGridStencil):
            A = A.to_dense_stencil()
        pg = pad_extents(A.grid)
        g = len(pg)
        Ap = GridStencil(_pad_to(A.coeff, pg, range(1, g + 1)), A.offsets, pg)
        d = (_pad_to(lvl.d, pg, range(g)) if lvl.d is not None else None)
        P1 = None
        if lvl.P1 is not None:
            pgc = pad_extents(gh.levels[l + 1].A.grid)
            # per-axis factors are (fine, coarse): zero rows/cols in the pad
            P1 = tuple(None if n is None else
                       _pad_to(jnp.asarray(fw_interp_1d(n)[0].toarray(),
                                           dtype=Ap.dtype), (pf, pc), (0, 1))
                       for n, pf, pc in zip(lvl.P1.fine, pg, pgc))
        levels.append(GridLevel(Ap, d, P1, lvl.lam))

    coarse = PaddedDenseInverse(gh.coarse, pad_extents(gh.coarse.grid))
    return GridHierarchy(tuple(levels), coarse)


def make_grid_sharded_cycle(state, mesh: Mesh, axes=("x",)):
    """(gh_sharded, cycle_fn, to_grid, from_grid) for a scalar grid MGState.

    `axes` names the mesh axes sharding the leading grid axes (one = slab,
    two = pencil decomposition).  cycle_fn(gh, b, x) runs one cycle on
    (m, *padded_grid) fields; GSPMD inserts the halo exchanges.
    """
    cfg = state.config
    gh = state.hier
    if not isinstance(gh, GridHierarchy):
        raise ValueError("state does not use the scalar grid engine")
    g = len(gh.fine_grid)
    divs = tuple(mesh.shape[a] for a in axes) + (1,) * (g - len(axes))
    gh_pad = pad_grid_hierarchy(gh, divs)

    def spec(lead_none: int):
        return NamedSharding(mesh, P(*((None,) * lead_none + tuple(axes)
                                       + (None,) * (g - len(axes)))))

    fsh = spec(1)                                  # fields (m, *grid)
    repl = NamedSharding(mesh, P())

    def shard_level(lvl: GridLevel) -> GridLevel:
        A = GridStencil(jax.device_put(lvl.A.coeff, spec(1)),
                        lvl.A.offsets, lvl.A.grid)
        d = (jax.device_put(lvl.d, spec(0)) if lvl.d is not None else None)
        P1 = (tuple(None if W is None else jax.device_put(W, repl)
                    for W in lvl.P1)
              if lvl.P1 is not None else None)
        return GridLevel(A, d, P1, lvl.lam)

    levels = tuple(shard_level(l) for l in gh_pad.levels)
    inner_repl = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, repl), gh_pad.coarse.inner)
    coarse = PaddedDenseInverse(inner_repl, gh_pad.coarse.pad_grid)
    gh_sh = GridHierarchy(levels, coarse)
    true_grid = gh.fine_grid
    pad_grid = levels[0].A.grid

    def to_grid(b2):
        bg = flat_to_grid(jnp.asarray(b2, dtype=cfg.dtype), true_grid)
        bg = _pad_to(bg, pad_grid, range(1, bg.ndim))
        return jax.device_put(bg, fsh)

    def from_grid(xg):
        sl = xg[(slice(None),) + tuple(slice(0, e) for e in true_grid)]
        return grid_to_flat(sl)

    cycle = jax.jit(lambda gh_, b_, x_, xz=False:
                    grid_cycle(cfg, gh_, b_, x_, x_zero=xz),
                    static_argnums=(3,),
                    out_shardings=fsh)
    return gh_sh, cycle, to_grid, from_grid
