"""Grid-form multigrid engine for face-staggered systems (elasticity/Stokes).

The flat engine treats the staggered system as one big ELL matrix — every
SpMV, transfer and Vanka sweep is a gather.  Here the system keeps its
block structure: each unknown component (face-j velocities, optional
cell-centered pressure) lives on its own node grid, operator blocks are
`CrossGridStencil`s (shift-multiply-accumulate between grids), transfers are
per-component per-axis dense 1D matmuls (the Systems.jl composites,
reference src/Multigrid/Systems.jl:33-76, verified block-by-block against the
assembled operators at setup), and the cell-wise Vanka smoother becomes pure
shift arithmetic: every Vanka block slot of every cell is a ±1 window of a
component field, so gathering block residuals, applying the batched block
inverses and scattering corrections are all windowed tensor ops — zero
gathers anywhere in the cycle.

Fields are tuples of per-component (m, *grid) arrays (a pytree) — "block
fields".  Flat (n, m) vectors are converted once at the solve-loop boundary.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..config import HIGHEST
from ..ops.cross_stencil import CrossGridStencil, cross_stencil_from_csr
from .grid_cycle import _axis_matmul

__all__ = [
    "BlockGridOperator", "SystemsGridLevel", "SystemsGridHierarchy",
    "GridVanka", "build_systems_grid_hierarchy",
    "block_to_fields", "fields_to_block",
]


# ---------------------------------------------------------------------------
# component geometry
# ---------------------------------------------------------------------------

def face_component_grids(n, with_pressure: bool):
    """Per-component grid shapes (grid-axis order) for face-staggered fields
    on an n-cell mesh, plus the flat offsets of each component block."""
    n = [int(v) for v in np.asarray(n).ravel()]
    dim = len(n)
    grids = []
    for j in range(dim):
        s = list(n)
        s[j] += 1
        grids.append(tuple(reversed(s)))
    if with_pressure:
        grids.append(tuple(reversed(n)))
    sizes = [int(np.prod(g)) for g in grids]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return tuple(grids), offsets


def block_to_fields(x2, grids):
    """(n, m) flat -> tuple of (m, *grid_c) component fields."""
    out = []
    off = 0
    for g in grids:
        sz = int(np.prod(g))
        out.append(x2[off:off + sz].T.reshape((x2.shape[1],) + g))
        off += sz
    return tuple(out)


def fields_to_block(xs):
    """tuple of (m, *grid_c) -> (n, m) flat."""
    m = xs[0].shape[0]
    return jnp.concatenate([x.reshape(m, -1) for x in xs], axis=1).T


def _tsub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _tadd(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _tzeros(a, dtype=None):
    return tuple(jnp.zeros_like(x, dtype=dtype) for x in a)


# ---------------------------------------------------------------------------
# block operator
# ---------------------------------------------------------------------------

@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["stencils"], meta_fields=["pairs", "grids"])
@dataclass(frozen=True)
class BlockGridOperator:
    stencils: tuple                     # CrossGridStencil per stored block
    pairs: tuple                        # (ci, cj) per stored block
    grids: tuple                        # per-component grid shapes

    @property
    def dtype(self):
        return self.stencils[0].dtype

    @property
    def shape(self):
        nt = sum(int(np.prod(g)) for g in self.grids)
        return (nt, nt)

    @property
    def nnz(self) -> int:
        return sum(s.nnz for s in self.stencils)

    def matvec(self, xs):
        """xs: tuple of (m, *grid_c) -> same structure."""
        m = xs[0].shape[0]
        ys = [jnp.zeros((m,) + g, dtype=jnp.result_type(self.dtype, xs[0]))
              for g in self.grids]
        for (ci, cj), S in zip(self.pairs, self.stencils):
            ys[ci] = ys[ci] + S.matvec(xs[cj])
        return tuple(ys)


def block_operator_from_csr(A: sp.spmatrix, n_cells, with_pressure: bool,
                            dtype=None) -> BlockGridOperator:
    """Split A into component blocks and extract each as a cross stencil."""
    n = [int(v) for v in np.asarray(n_cells).ravel()]
    dim = len(n)
    grids, offs = face_component_grids(n, with_pressure)
    if A.shape[0] != offs[-1]:
        raise ValueError("operator size does not match the staggered layout")
    A = A.tocsr()
    pairs, stencils = [], []
    nodes = []
    for j in range(dim):
        s = list(n)
        s[j] += 1
        nodes.append(s)
    if with_pressure:
        nodes.append(list(n))
    for ci in range(len(grids)):
        Ai = A[offs[ci]:offs[ci + 1]].tocsc()
        for cj in range(len(grids)):
            blk = Ai[:, offs[cj]:offs[cj + 1]].tocsr()
            if blk.nnz == 0:
                continue
            S = cross_stencil_from_csr(blk, nodes[ci], nodes[cj], dtype=dtype)
            pairs.append((ci, cj))
            stencils.append(S)
    return BlockGridOperator(tuple(stencils), tuple(pairs), grids)


# ---------------------------------------------------------------------------
# grid-form Vanka smoother
# ---------------------------------------------------------------------------

@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["dinv", "masks"],
                   meta_fields=["slots", "cell_grid", "variant"])
@dataclass(frozen=True)
class GridVanka:
    """Cell-wise Vanka in grid form.

    dinv:  (bs, bs, *cell_grid) weighted block inverses (single precision,
           reference Vanka.jl:296), cell grid contiguous in memory.
    masks: (ncolors, *cell_grid) 0/1 color masks (per-axis cell parity,
           reference cellColor Vanka.c:34-83); one all-ones "color" for the
           additive variant.
    slots: per block slot, (component index, per-grid-axis window offset) —
           slot s of cell r is component comp[s] at node r + off[s].
    """
    dinv: jax.Array
    masks: jax.Array
    slots: tuple
    cell_grid: tuple
    variant: str


def vanka_slots(dim: int, with_pressure: bool):
    """Slot table matching vanka_cell_indices' ordering: (low_j, high_j) per
    axis j, then pressure.  Offsets are in grid-axis order."""
    slots = []
    for j in range(dim):
        off_hi = [0] * dim
        off_hi[dim - 1 - j] = 1         # +1 along mesh axis j = grid axis dim-1-j
        slots.append((j, (0,) * dim))
        slots.append((j, tuple(off_hi)))
    if with_pressure:
        slots.append((dim, (0,) * dim))
    return tuple(slots)


def _window(x, start, size):
    """x[..., start:start+size] per grid axis (static)."""
    nb = x.ndim - len(size)
    idx = (slice(None),) * nb + tuple(
        slice(s, s + z) for s, z in zip(start, size))
    return x[idx]


def grid_vanka_sweep(op: BlockGridOperator, gv: GridVanka, xs, bs_field,
                     num_it: int):
    """num_it colored (or additive) Vanka sweeps on block fields."""
    cg = gv.cell_grid
    dt = xs[0].dtype
    dinv = gv.dinv.astype(dt)
    for _ in range(num_it):
        for c in range(gv.masks.shape[0]):
            r = _tsub(bs_field, op.matvec(xs))
            # gather block residual slots: windows of component residuals
            rs = jnp.stack([_window(r[comp], off, cg)
                            for comp, off in gv.slots], axis=1)  # (m, bs, *cg)
            u = jnp.einsum("ij...,mj...->mi...", dinv, rs, precision=HIGHEST)
            u = u * gv.masks[c]
            xs = list(xs)
            for s, (comp, off) in enumerate(gv.slots):
                nb = 1
                idx = (slice(None),) * nb + tuple(
                    slice(o, o + z) for o, z in zip(off, cg))
                xs[comp] = xs[comp].at[idx].add(u[:, s])
            xs = tuple(xs)
    return xs


def build_grid_vanka(A, mesh, w, with_pressure, variant, dtype, prec_dtype):
    from ..setup.smoothers import vanka_block_inverses
    if variant not in ("vanka", "econ-vanka", "vanka-add"):
        raise ValueError(f"grid Vanka does not support variant {variant}")
    I, colors, dinv = vanka_block_inverses(A, mesh, w, with_pressure,
                                           variant, dtype=dtype)
    n = [int(v) for v in np.asarray(mesh.n).ravel()]
    dim = mesh.dim
    cell_grid = tuple(reversed(n))
    ncells, bsz = I.shape
    # (ncells, bs, bs) -> (bs, bs, *cell_grid); flat cell index is dim-0
    # fastest, i.e. C-order on the reversed grid
    dinv_g = np.transpose(dinv, (1, 2, 0)).reshape((bsz, bsz) + cell_grid)
    if variant == "vanka-add":
        masks = np.ones((1,) + cell_grid, dtype=prec_dtype)
    else:
        ncolors = 2 ** dim
        masks = np.zeros((ncolors,) + cell_grid, dtype=prec_dtype)
        colors_g = colors.reshape(cell_grid)
        for c in range(ncolors):
            masks[c] = (colors_g == c)
    return GridVanka(jnp.asarray(dinv_g.astype(prec_dtype)),
                     jnp.asarray(masks), vanka_slots(dim, with_pressure),
                     cell_grid, variant)


# ---------------------------------------------------------------------------
# hierarchy + cycle
# ---------------------------------------------------------------------------

@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["A", "d", "vanka", "P1", "R1"], meta_fields=[])
@dataclass(frozen=True)
class SystemsGridLevel:
    A: BlockGridOperator
    d: tuple | None          # per-component pointwise relax diagonals
    vanka: GridVanka | None
    P1: tuple | None         # per component: per-axis dense (f_a, c_a)
    R1: tuple | None         # per component: per-axis dense (c_a, f_a)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["inv"], meta_fields=["grids"])
@dataclass(frozen=True)
class BlockDenseInverse:
    inv: jax.Array
    grids: tuple

    def solve(self, bs_field):
        bf = fields_to_block(bs_field)          # (n, m)
        xf = jnp.matmul(self.inv, bf, precision=HIGHEST)
        return block_to_fields(xf, self.grids)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["levels", "coarse"], meta_fields=[])
@dataclass(frozen=True)
class SystemsGridHierarchy:
    levels: tuple
    coarse: BlockDenseInverse

    @property
    def fine_grids(self) -> tuple:
        return self.levels[0].A.grids


def systems_restrict(rs, R1):
    """R r per component: per-axis 1D restriction matmuls, scaled 0.5^dim."""
    out = []
    dim = len(R1[0])
    for r, facs in zip(rs, R1):
        y = r
        for a, W in enumerate(facs):
            y = _axis_matmul(y, W.T, 1 + a)
        out.append((0.5 ** dim) * y)
    return tuple(out)


def systems_prolong(xcs, P1):
    """P xc per component."""
    out = []
    for xc, facs in zip(xcs, P1):
        y = xc
        for a, W in enumerate(facs):
            y = _axis_matmul(y, W.T, 1 + a)
        out.append(y)
    return tuple(out)


def _systems_smooth(cfg, lvl: SystemsGridLevel, r, xs, bs_field, nu: int):
    if nu <= 0:
        return xs
    if lvl.vanka is not None:
        return grid_vanka_sweep(lvl.A, lvl.vanka, xs, bs_field, nu)
    for _ in range(nu - 1):
        xs = _tadd(xs, tuple(d * ri for d, ri in zip(lvl.d, r)))
        r = _tsub(bs_field, lvl.A.matvec(xs))
    return _tadd(xs, tuple(d * ri for d, ri in zip(lvl.d, r)))


def systems_grid_cycle(cfg, gh: SystemsGridHierarchy, b, x, level: int = 0,
                       ctype: str | None = None, x_zero: bool = False):
    """One cycle on block fields b, x (tuples of (m, *grid_c)).

    `x_zero` (static): the incoming iterate is exactly zero (coarse-level
    entries) — skip the r = b - A*0 matvec (see grid_cycle)."""
    ctype = cfg.cycle_type if ctype is None else ctype
    nlev = len(gh.levels)
    if level == nlev - 1:
        return gh.coarse.solve(b)

    lvl = gh.levels[level]
    with jax.named_scope(f"smg_sys_level{level}"):
        r = b if x_zero else _tsub(b, lvl.A.matvec(x))
        x = _systems_smooth(cfg, lvl, r, x, b, cfg.nu_pre[level])

        r = (_tsub(b, lvl.A.matvec(x))
             if cfg.nu_pre[level] > 0 or not x_zero else b)
        bc = systems_restrict(r, lvl.R1)
        if level == nlev - 2:
            xc = gh.coarse.solve(bc)
        elif ctype == "K":
            # K-cycle: 2-step FGMRES on the coarse level preconditioned by
            # the recursive cycle (reference MGcycle.jl:72-76), on block
            # fields via the pytree-aware fgmres_relaxation
            from .relax import fgmres_relaxation
            coarse_mv = gh.levels[level + 1].A.matvec
            prec = lambda v: systems_grid_cycle(cfg, gh, v, _tzeros(v),
                                                level + 1, "K", x_zero=True)
            xc = fgmres_relaxation(coarse_mv, prec, bc, _tzeros(bc),
                                   cfg.kcycle_inner,
                                   axis_name=cfg.axis_name)
        else:
            xc = systems_grid_cycle(cfg, gh, bc, _tzeros(bc), level + 1,
                                    ctype, x_zero=True)
            if ctype == "W":
                xc = systems_grid_cycle(cfg, gh, bc, xc, level + 1, "W")
            elif ctype == "F":
                xc = systems_grid_cycle(cfg, gh, bc, xc, level + 1, "V")

        x = _tadd(x, systems_prolong(xc, lvl.P1))

        r = _tsub(b, lvl.A.matvec(x))
        x = _systems_smooth(cfg, lvl, r, x, b, cfg.nu_post[level])
    return x


@functools.partial(jax.jit, static_argnums=(0, 4))
def systems_grid_cycle_jit(cfg, gh, b, x, x_zero: bool = False):
    return systems_grid_cycle(cfg, gh, b, x, x_zero=x_zero)


def systems_grid_cycle_flat(cfg, gh: SystemsGridHierarchy, b2, x2,
                            ctype: str | None = None,
                            x_zero: bool = False):
    grids = gh.fine_grids
    xg = systems_grid_cycle(cfg, gh, block_to_fields(b2, grids),
                            block_to_fields(x2, grids), 0, ctype,
                            x_zero=x_zero)
    return fields_to_block(xg)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

_SYS_RELAX = ("jacobi", "spai", "vanka", "econ-vanka", "vanka-add")
_DENSE_INV_MAX = 16384


def _component_transfer_factors(n, with_pressure, dtype):
    """Per-component per-grid-axis dense 1D P and R factors + kron check data
    (reference Systems.jl:33-76 composites)."""
    from ..setup import transfers as tr
    n = [int(v) for v in np.asarray(n).ravel()]
    dim = len(n)
    comps = []
    for j in range(dim):
        facs = []
        for k in range(dim):        # mesh axis order
            if k == j:
                P1, _ = tr.prolongation_nodes_1d(n[k])
                R1, _ = tr.node_fw_restriction_1d(n[k])
            else:
                P1, _ = tr.prolongation_cells_1d(n[k])
                R1, _ = tr.restriction_cells_1d(n[k])
            facs.append((P1, R1))
        comps.append(facs)
    if with_pressure:
        facs = []
        for k in range(dim):
            P1, _ = tr.prolongation_cells_1d(n[k])
            R1, _ = tr.restriction_cells_1d(n[k])
            facs.append((P1, R1))
        comps.append(facs)
    P1s, R1s, Pkron, Rkron = [], [], [], []
    for facs in comps:
        pk, rk = facs[0][0], facs[0][1]
        for P1, R1 in facs[1:]:
            pk = sp.kron(P1, pk, format="csr")
            rk = sp.kron(R1, rk, format="csr")
        Pkron.append(pk)
        Rkron.append(rk)
        # grid-axis order = reversed mesh axes
        P1s.append(tuple(jnp.asarray(np.asarray(f[0].todense(), dtype=dtype))
                         for f in reversed(facs)))
        R1s.append(tuple(jnp.asarray(np.asarray(f[1].todense(), dtype=dtype))
                         for f in reversed(facs)))
    return tuple(P1s), tuple(R1s), Pkron, Rkron


def build_systems_grid_hierarchy(state, relax_states) -> SystemsGridHierarchy:
    """Build the systems grid engine when eligible; ValueError otherwise."""
    from ..config import single_variant

    cfg = state.config
    if cfg.transfer_type not in ("systems-faces", "systems-faces-mixed"):
        raise ValueError("systems grid engine needs staggered transfers")
    if cfg.relax_type not in _SYS_RELAX:
        raise ValueError(f"systems grid engine: unsupported relaxation "
                         f"{cfg.relax_type}")
    if not state.meshes or len(state.meshes) < state.num_levels:
        raise ValueError("systems grid engine needs per-level meshes")
    if cfg.coarse_solve != "lu" or state.coarse_solver is not None:
        raise ValueError("systems grid engine supports the lu coarsest only")

    from ..setup.hierarchy import _per_level_relax_param
    with_p = cfg.mixed
    rp_arr = _per_level_relax_param(state.relax_param, state.num_levels)
    levels = []
    for l in range(state.num_levels):
        mesh = state.meshes[l]
        n = [int(v) for v in np.asarray(mesh.n).ravel()]
        A = block_operator_from_csr(state.As[l], n, with_p, dtype=cfg.dtype)
        d = vanka = P1 = R1 = None
        if l < state.num_levels - 1:
            if cfg.relax_type in ("jacobi", "spai"):
                from ..setup.hierarchy import _resolve_relax
                rs = _resolve_relax(relax_states[l])
                grids, offs = face_component_grids(n, with_p)
                dd = np.asarray(rs.d)
                d = tuple(jnp.asarray(dd[offs[c]:offs[c + 1]].reshape(g))
                          for c, g in enumerate(grids))
            else:
                vanka = build_grid_vanka(
                    state.As[l], mesh, rp_arr[l], with_p, cfg.relax_type,
                    np.dtype(cfg.dtype), single_variant(np.dtype(cfg.dtype)))
            P1, R1, Pk, Rk = _component_transfer_factors(n, with_p, cfg.dtype)
            # verify the factored transfers ARE the assembled hierarchy ones
            Pfull = sp.block_diag(Pk, format="csr")
            Rfull = sp.block_diag(Rk, format="csr")
            if (Pfull != state.Ps[l]).nnz != 0:
                raise ValueError("hierarchy P is not the Systems.jl factored "
                                 "composite")
            if ((0.5 ** mesh.dim) * Rfull != state.Rs[l]).nnz != 0:
                raise ValueError("hierarchy R is not the Systems.jl factored "
                                 "composite")
        levels.append(SystemsGridLevel(A, d, vanka, P1, R1))

    A_c = state.As[-1]
    if A_c.shape[0] > _DENSE_INV_MAX:
        raise ValueError("coarsest system too large for a dense inverse")
    Ad = np.asarray(A_c.astype(
        np.complex128 if np.iscomplexobj(A_c.data) else np.float64).todense())
    if A_c.shape[0] <= 4096:
        from .grid_cycle import _checked_inverse
        inv = _checked_inverse(Ad)
    else:
        shift = 1e-8 * np.abs(Ad).sum(axis=0).max()
        inv = np.linalg.inv(Ad + shift * np.eye(Ad.shape[0], dtype=Ad.dtype))
    coarse = BlockDenseInverse(jnp.asarray(inv.astype(cfg.dtype)),
                               levels[-1].A.grids)
    return SystemsGridHierarchy(tuple(levels), coarse)
