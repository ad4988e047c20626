"""Matrix-free stencil form of structured GMG levels (the sharded fast path).

On a regular mesh every GMG level operator (original discretization and all
its full-weighting Galerkin coarsenings) is a 9-point (2D) / 27-point (3D)
stencil with variable coefficients.  For multi-chip execution we shard fields
by SLABS along the last grid dimension; slab-local application needs exactly
one halo plane from each neighbor, exchanged with `ppermute` — the
device-mesh replacement for the reference's shared-memory row-parallel SpMV
(ParSpMatVec) and its master-centric Distributed tier (SURVEY.md §5).

Grid layout: a flat vector x (dim-0 fastest) is viewed as G[j, i] = x[i + j*NI]
where j indexes the last mesh dimension (J axis, sharded) and i the flattened
remaining dimensions (I axis, local).  Stencil offsets decompose as
off = dj*NI + di with dj in {-1,0,1}; application is: for each dj, take the
dj-shifted plane from the halo-extended slab and accumulate the di-shifted,
coefficient-weighted contributions — pure VPU shift/multiply/add work.

Transfers are the matrix-free tensor-product full-weighting pair on odd node
counts (2^k + 1 grids), factored as S_J o S_I with S_* the separable
[0.5, 1, 0.5] smoothing along the sharded / local axes:
    P  = S_J(S_I(upsample(xc)))
    R  = 0.5^dim * downsample(S_J(S_I(xf)))
which reproduces exactly the operators mgtpu.setup.transfers.fw_interp builds
(interior and boundary) for odd sizes, so the sharded cycle matches the
single-chip Galerkin hierarchy.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["coeff", "d"],
                   meta_fields=["di", "dj", "shape"])
@dataclass(frozen=True)
class StencilLevel:
    """One level: variable stencil coefficients + Jacobi diagonal, grid form.

    coeff: (ndiags, NJ, NI) with coeff[k, j, i] = A[row(j,i), row(j,i)+off_k];
    d:     (NJ, NI) damped-Jacobi inverse diagonal;
    di/dj: static per-diagonal offset decomposition; shape = (NJ, NI).
    """
    coeff: jax.Array
    d: jax.Array
    di: tuple[int, ...]
    dj: tuple[int, ...]
    shape: tuple[int, int]


def stencil_from_banded(A: sp.spmatrix, n_nodes, omega: float,
                        dtype=np.float32) -> StencilLevel:
    """Extract the grid-form stencil of a banded operator on an n_nodes grid.

    n_nodes: per-dim node counts (i1 fastest).  NI = prod(n_nodes[:-1]),
    NJ = n_nodes[-1].
    """
    n_nodes = [int(v) for v in np.asarray(n_nodes).ravel()]
    NI = int(np.prod(n_nodes[:-1]))
    NJ = n_nodes[-1]
    A = A.tocoo()
    off_all = A.col.astype(np.int64) - A.row.astype(np.int64)
    offs = np.unique(off_all)
    dj = np.round(offs / NI).astype(np.int64)
    di = offs - dj * NI
    if np.any(np.abs(dj) > 1):
        raise ValueError("operator is not a 1-plane-halo stencil on this grid")
    coeff = np.zeros((len(offs), NJ * NI), dtype=dtype)
    pos = np.searchsorted(offs, off_all)
    np.add.at(coeff, (pos, A.row), A.data.astype(dtype))
    coeff = coeff.reshape(len(offs), NJ, NI)
    diag = A.tocsr().diagonal()
    d = (omega / diag).astype(dtype).reshape(NJ, NI)
    return StencilLevel(jnp.asarray(coeff), jnp.asarray(d),
                        tuple(int(v) for v in di), tuple(int(v) for v in dj),
                        (NJ, NI))


def _shift_i(x, di):
    """In-plane shift along the flattened I axis: y[.., i, :] = x[.., i+di, :]
    with zero fill (callers mask flattened-axis wrap-around)."""
    if di == 0:
        return x
    pad = [(0, 0)] * x.ndim
    if di > 0:
        pad[-2] = (0, di)
        return jnp.pad(x, pad)[..., di:, :]
    pad[-2] = (-di, 0)
    return jnp.pad(x, pad)[..., :di, :]


def stencil_matvec_local(coeff_loc, di, dj, x_halo):
    """y = A x on a halo-extended slab.

    coeff_loc: (ndiags, S, NI); x_halo: (S+2, NI, m); returns (S, NI, m).
    """
    S, NI = coeff_loc.shape[1], coeff_loc.shape[2]
    y = jnp.zeros((S, NI, x_halo.shape[-1]), dtype=x_halo.dtype)
    for k in range(len(di)):
        plane = jax.lax.dynamic_slice_in_dim(x_halo, 1 + dj[k], S, axis=0)
        y = y + coeff_loc[k][:, :, None] * _shift_i(plane, di[k])
    return y


def stencil_matvec_overlapped(coeff_loc, di, dj, x_loc, axis_name: str):
    """y = A x on a slab with the halo exchange SPLIT OFF the interior
    dependency (compute-comm overlap).

    `exchange_halo` + `stencil_matvec_local` makes every output row depend
    on the ppermute, serialising the transfer before compute.  Here the
    interior rows [1, S-1) read only local planes, so XLA's latency-hiding
    scheduler is free to run the transfer behind the interior stencil
    work; only the two edge rows wait for their neighbor plane.  Per
    element the multiply-add sequence is identical to the fused form, so
    the result is bitwise equal (pinned by the conformance tests).
    """
    S = coeff_loc.shape[1]
    if S < 2:
        # at S == 1 the edge-row windows below ([:2], [S-2:]) would read a
        # duplicated local plane instead of the neighbor/zero halo —
        # silently wrong edge rows.  Level plans keep slabs
        # >= 2 planes (slab_coarsest); fall back to the fused exchange,
        # which is correct for any S.
        return stencil_matvec_local(coeff_loc, di, dj,
                                    exchange_halo(x_loc, axis_name))
    ndev = jax.lax.axis_size(axis_name)
    down = [(i, i + 1) for i in range(ndev - 1)]
    up = [(i + 1, i) for i in range(ndev - 1)]
    from_left = jax.lax.ppermute(x_loc[-1:], axis_name, down)
    from_right = jax.lax.ppermute(x_loc[:1], axis_name, up)
    y_int = stencil_matvec_local(coeff_loc[:, 1:S - 1], di, dj, x_loc)
    y_top = stencil_matvec_local(
        coeff_loc[:, 0:1], di, dj,
        jnp.concatenate([from_left, x_loc[:2]], axis=0))
    y_bot = stencil_matvec_local(
        coeff_loc[:, S - 1:S], di, dj,
        jnp.concatenate([x_loc[S - 2:], from_right], axis=0))
    return jnp.concatenate([y_top, y_int, y_bot], axis=0)


def exchange_halo(x_loc, axis_name: str):
    """x_loc: (S, NI, m) slab -> (S+2, NI, m) with neighbor halo planes.

    Edge devices receive zero planes (ppermute drops non-participating
    targets), matching the zero-extended global grid boundary.
    """
    ndev = jax.lax.axis_size(axis_name)
    down = [(i, i + 1) for i in range(ndev - 1)]    # my last plane -> right
    up = [(i + 1, i) for i in range(ndev - 1)]      # my first plane -> left
    from_left = jax.lax.ppermute(x_loc[-1:], axis_name, down)
    from_right = jax.lax.ppermute(x_loc[:1], axis_name, up)
    return jnp.concatenate([from_left, x_loc, from_right], axis=0)


# ---------------------------------------------------------------------------
# matrix-free tensor-product full-weighting transfers (grid form)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TransferPlan:
    """Static (hashable) plan for matrix-free P/R between a fine grid and its
    coarse one: in-plane smoothing offsets/weights and grid extents.  The
    validity masks and the I-axis downsample map are ARRAYS and live in the
    level pytree's data fields (see parallel.sharded.ShardedLevel)."""
    offsets: tuple
    NI: int
    NIc: int
    NJ: int
    NJc: int
    dim: int


def make_transfer_plan(n_nodes) -> TransferPlan:
    n_nodes = [int(v) for v in np.asarray(n_nodes).ravel()]
    if any((nd - 1) % 2 for nd in n_nodes):
        raise ValueError("matrix-free transfers need odd node counts per dim")
    inplane = n_nodes[:-1]
    NI = int(np.prod(inplane))
    idx = np.arange(NI)
    coords, rem = [], idx.copy()
    for nd in inplane:
        coords.append(rem % nd)
        rem = rem // nd
    coords = np.stack(coords, axis=1) if inplane else np.zeros((1, 0), np.int64)
    strides = np.concatenate([[1], np.cumprod(inplane[:-1])]).astype(np.int64) \
        if inplane else np.array([1])
    combos = [((), 1.0, np.ones(NI, dtype=bool))]
    for d in range(len(inplane)):
        new = []
        for steps, w, mask in combos:
            for s, ws in ((-1, 0.5), (0, 1.0), (1, 0.5)):
                if s == -1:
                    m2 = mask & (coords[:, d] >= 1)
                elif s == 1:
                    m2 = mask & (coords[:, d] <= inplane[d] - 2)
                else:
                    m2 = mask
                new.append((steps + (s,), w * ws, m2))
        combos = new
    offsets = tuple((int(sum(s * strides[d] for d, s in enumerate(steps))),
                     float(w)) for steps, w, _ in combos)
    masks = np.stack([m for _, _, m in combos]).astype(np.float32)

    nc_inplane = [(nd - 1) // 2 + 1 for nd in inplane]
    NIc = int(np.prod(nc_inplane)) if nc_inplane else 1
    ds = np.zeros(NIc, dtype=np.int64)
    cidx = np.arange(NIc)
    for d, ncd in enumerate(nc_inplane):
        cstride = int(np.prod(nc_inplane[:d]))
        fstride = int(np.prod(inplane[:d]))
        coord = (cidx // cstride) % ncd
        ds += 2 * coord * fstride
    plan = TransferPlan(offsets, NI, NIc, n_nodes[-1],
                        (n_nodes[-1] - 1) // 2 + 1, len(n_nodes))
    return plan, masks, ds


def smooth_inplane(x, plan: TransferPlan, masks):
    """S_I: in-plane [0.5,1,0.5]^(x)(dim-1) smoothing, fully local.
    x: (..., NI, m)."""
    y = jnp.zeros_like(x)
    for k, (off, w) in enumerate(plan.offsets):
        y = y + w * (_shift_i(x, off) * masks[k][..., :, None])
    return y


def smooth_j(x_halo):
    """S_J: [0.5, 1, 0.5] along the sharded J axis on a halo-extended slab.
    x_halo: (S+2, NI, m) -> (S, NI, m)."""
    S = x_halo.shape[0] - 2
    return (0.5 * x_halo[:S] + x_halo[1:S + 1] + 0.5 * x_halo[2:])


def restrict_local(xf_halo, plan: TransferPlan, masks, ds_map, S_coarse: int):
    """R xf on a slab: smooth then downsample both axes; scale 0.5^dim.
    xf_halo: (Sf+2, NI, m) with Sf = 2*S_coarse; returns (S_coarse, NIc, m)."""
    y = smooth_j(smooth_inplane(xf_halo, plan, masks))     # (Sf, NI, m)
    yj = y[0::2][:S_coarse]                                # aligned: fine 2c
    out = jnp.take(yj, ds_map, axis=1)
    return (0.5 ** plan.dim) * out


def prolong_local(xc_loc, plan: TransferPlan, masks, ds_map,
                  axis_name: str, Sf: int):
    """P xc on a slab: upsample both axes then smooth (needs one fine-halo
    exchange).  xc_loc: (Sc, NIc, m); returns (Sf, NI, m) with Sf = 2*Sc."""
    Sc = xc_loc.shape[0]
    m = xc_loc.shape[-1]
    up = jnp.zeros((2 * Sc, plan.NI, m), dtype=xc_loc.dtype)
    up = up.at[0::2, ds_map, :].set(xc_loc)
    up_halo = exchange_halo(up, axis_name)
    return smooth_j(smooth_inplane(up_halo, plan, masks))[:Sf]
