"""Grid-form stencil operator — the zero-gather structured fast path.

Operators from tensor-product discretizations on regular meshes (and all their
full-weighting Galerkin coarsenings) are stencils whose offsets decompose
per mesh axis: off = sum_a d_a * stride_a with small |d_a|.  Stored in grid
form — ``coeff[k, ..., j, i] = A[row(j,i), row(j,i) + off_k]`` on the
multi-dimensional node grid — the SpMV becomes shift-multiply-accumulate
along the grid axes: unit-stride elementwise work with zero gathers, which
XLA fuses into one loop per stencil apply (the grid layout
``(m, ..., NJ, NI)`` keeps the fastest mesh axis contiguous in memory).

This is the structured replacement for the reference's row-parallel CSC-
transposed SpMV (reference src/Multigrid/SpMatMul.jl:4-26 backed by
ParSpMatVec's OpenMP C kernel): same contract (y = A x, multi-RHS batched),
hardware-shaped layout.

Grid axis order: the flat vector has mesh dim 0 fastest (x[i1 + n1*i2 + ...]),
so the grid view is ``x.reshape(*reversed(node_counts))`` — grid axis -1 is
mesh dim 0.  Batched right-hand sides lead: fields are (m, *grid).
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["coeff"],
                   meta_fields=["offsets", "grid"])
@dataclass(frozen=True)
class GridStencil:
    """Variable-coefficient stencil on a node grid.

    coeff:   (ndiags, *grid) — coeff[k] holds A[row, row+off_k] per node
             (zero where the entry does not exist, e.g. at boundaries).
    offsets: per-diagonal tuple of per-grid-axis shifts (slowest axis first,
             matching the grid axis order).  Static metadata.
    grid:    node grid shape (slowest mesh dim first).
    """
    coeff: jax.Array
    offsets: tuple[tuple[int, ...], ...]
    grid: tuple[int, ...]

    @property
    def dtype(self):
        return self.coeff.dtype

    @property
    def shape(self) -> tuple[int, int]:
        n = int(np.prod(self.grid))
        return (n, n)

    @property
    def nnz(self) -> int:
        return int(self.coeff.size)

    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A @ x.

        Accepts grid-form fields (..., *grid) — including a leading batch
        dim — or flat vectors (n,) / (n, m) which are converted at the
        boundary (prefer grid form in hot loops: the conversion is a
        transpose).
        """
        g = len(self.grid)
        if x.ndim <= 2 and (g != x.ndim or x.shape != self.grid):
            # flat vector(s): (n,) or (n, m)
            squeeze = x.ndim == 1
            x2 = x[:, None] if squeeze else x
            xg = flat_to_grid(x2, self.grid)
            yg = grid_stencil_matvec(self.coeff, self.offsets, xg)
            y = grid_to_flat(yg)
            return y[:, 0] if squeeze else y
        return grid_stencil_matvec(self.coeff, self.offsets, x)

    def to_scipy(self) -> sp.csr_matrix:
        """Stencil -> CSR via scipy's DIA container.

        A grid stencil IS a DIA matrix (one linear diagonal per offset), and
        scipy's C dia_tocsr is ~5x faster than assembling COO coordinates and
        canonicalising — this sits on the setup/replace_matrix hot path.
        Explicit zeros are dropped by the conversion (callers previously ran
        eliminate_zeros to the same effect)."""
        n = int(np.prod(self.grid))
        g = len(self.grid)
        strides = [int(np.prod(self.grid[a + 1:])) for a in range(g)]
        coeff = np.asarray(self.coeff)
        lin = [int(sum(d * s for d, s in zip(off, strides)))
               for off in self.offsets]
        order = np.argsort(lin)
        data = np.zeros((len(lin), n), dtype=coeff.dtype)
        for j, k in enumerate(order):
            off = self.offsets[k]
            # keep only the in-box band (a boundary-crossing linear index
            # would alias the wrapped grid row in DIA form)
            sl = tuple(slice(max(0, -d), self.grid[a] - max(0, d))
                       for a, d in enumerate(off))
            ck = np.zeros(self.grid, dtype=coeff.dtype)
            ck[sl] = coeff[(k,) + sl]
            flat = ck.reshape(-1)
            o = lin[k]
            if o >= 0:
                data[j, o:] = flat[:n - o] if o else flat
            else:
                data[j, :n + o] = flat[-o:]
        A = sp.dia_matrix((data, np.asarray(lin)[order]), shape=(n, n))
        return A.tocsr()

    def astype(self, dtype) -> "GridStencil":
        return GridStencil(self.coeff.astype(dtype), self.offsets, self.grid)


def flat_to_grid(x2: jax.Array, grid: tuple[int, ...]) -> jax.Array:
    """(n, m) flat columns -> (m, *grid) batched grid fields."""
    return x2.T.reshape((x2.shape[1],) + tuple(grid))


def grid_to_flat(xg: jax.Array) -> jax.Array:
    """(m, *grid) -> (n, m)."""
    return xg.reshape(xg.shape[0], -1).T


def make_grid_stencil(A: sp.spmatrix, node_counts, dtype=None,
                      max_shift: int = 2, width: int = 2):
    """Extract + constant-interior-compress in one host pass.

    Returns a device-backed ConstGridStencil when the coefficients are
    constant away from the boundary band, else a GridStencil.  All analysis
    happens on the HOST copy, before the single device push.
    """
    gs = grid_stencil_from_csr(A, node_counts, dtype=dtype,
                               max_shift=max_shift, device=False)
    cs = compress_grid_stencil(gs, width=width)
    if cs is not None:
        return cs
    return GridStencil(jnp.asarray(gs.coeff), gs.offsets, gs.grid)


def grid_stencil_from_csr(A: sp.spmatrix, node_counts,
                          dtype=None, max_shift: int = 2,
                          device: bool = True) -> GridStencil:
    """Extract the grid-form stencil of A on a node grid.

    node_counts: per-mesh-dim node counts, dim 0 fastest (= jInv/mesh
    convention).  Raises ValueError when A is not a tensor-product stencil
    with per-axis shifts within ``max_shift`` — callers fall back to the
    general flat path.  device=False keeps the coefficients as numpy (for
    host-side analysis before the single device push).
    """
    node_counts = [int(v) for v in np.asarray(node_counts).ravel()]
    n = int(np.prod(node_counts))
    if A.shape != (n, n):
        raise ValueError("operator size does not match the node grid")
    dim = len(node_counts)
    strides = np.concatenate([[1], np.cumprod(node_counts[:-1])]).astype(np.int64)

    # map every representable offset to its per-axis decomposition; prefer the
    # smallest shift radius that covers the matrix (radius 1 stays unambiguous
    # down to 3-node grids, where radius 2 aliases)
    Ac = A.tocoo()
    # difference of two in-range indices cannot overflow the index dtype;
    # skipping the int64 upcast avoids two full-nnz copies on big 3D levels
    if Ac.col.dtype == Ac.row.dtype and n <= np.iinfo(Ac.col.dtype).max:
        off_all = Ac.col - Ac.row
    else:
        off_all = Ac.col.astype(np.int64) - Ac.row.astype(np.int64)
    offs = np.unique(off_all)

    decomp: dict[int, tuple[int, ...]] = {}
    last_err = None
    for radius in range(1, max_shift + 1):
        cand: dict[int, tuple[int, ...]] = {}
        ambiguous = False
        for combo in itertools.product(range(-radius, radius + 1), repeat=dim):
            off = int(sum(c * s for c, s in zip(combo, strides)))
            if off in cand:
                ambiguous = True
                break
            # grid axis order is reversed (slowest mesh dim first)
            cand[off] = tuple(reversed(combo))
        if ambiguous:
            last_err = "ambiguous stencil decomposition (grid too small)"
            break
        decomp = cand
        if all(int(o) in decomp for o in offs):
            break
        last_err = "matrix offsets exceed the stencil shift radius"
    if not decomp:
        raise ValueError(last_err)
    offsets = []
    for off in offs:
        d = decomp.get(int(off))
        if d is None:
            raise ValueError(f"matrix offset {off} is not a grid stencil shift")
        offsets.append(d)

    dt = dtype if dtype is not None else Ac.dtype
    coeff = np.zeros((len(offs), n), dtype=dt)
    pos = np.searchsorted(offs, off_all)
    # (pos, row) pairs are unique for a deduplicated sparse matrix, so plain
    # assignment replaces np.add.at (which is ~10x slower)
    coeff[pos, Ac.row] = Ac.data.astype(dt, copy=False)
    grid = tuple(reversed(node_counts))
    # entries that would shift across a grid boundary cannot exist in a true
    # grid stencil; verify so wrap-around never aliases silently
    coeff = coeff.reshape((len(offs),) + grid)
    for k, off in enumerate(offsets):
        for a, da in enumerate(off):
            if da == 0:
                continue
            sl = [slice(None)] * len(grid)
            sl[a] = slice(grid[a] - da, None) if da > 0 else slice(0, -da)
            if np.any(coeff[(k,) + tuple(sl)]):
                raise ValueError("stencil entry crosses the grid boundary")
    return GridStencil(jnp.asarray(coeff) if device else coeff,
                       tuple(offsets), grid)


def _shift(x: jax.Array, axis: int, d: int, size: int) -> jax.Array:
    """y[..., i, ...] = x[..., i + d, ...] with zero fill, along `axis`."""
    if d == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (max(0, -d), max(0, d))
    xp = jnp.pad(x, pad)
    start = [0] * x.ndim
    start[axis] = max(0, -d) + d
    return jax.lax.dynamic_slice(xp, start,
                                 [xp.shape[i] if i != axis else size
                                  for i in range(x.ndim)])


@functools.partial(jax.jit, static_argnames=("offsets",))
def grid_stencil_matvec(coeff: jax.Array,
                        offsets: tuple[tuple[int, ...], ...],
                        x: jax.Array) -> jax.Array:
    """y = A x for grid fields x of shape (..., *grid)."""
    g = coeff.ndim - 1
    grid = coeff.shape[1:]
    y = jnp.zeros(x.shape[:-g] + grid, dtype=jnp.result_type(coeff, x))
    for k, off in enumerate(offsets):
        xs = x
        for a, da in enumerate(off):
            xs = _shift(xs, xs.ndim - g + a, da, grid[a])
        y = y + coeff[k] * xs
    return y


def structured_fw_rap(gs: GridStencil, axes=None) -> GridStencil:
    """Galerkin RAP under separable full-weighting transfers on odd grids,
    computed axis-by-axis on the stencil coefficient arrays.

    A_c = R A P with P = kron of 1D [0.5, 1, 0.5] interpolations
    (setup/transfers.fw_interp) and R = 0.5^dim P^T factorises per axis:
    coarsening one axis maps offset s to t with
      Ac_t[.., I, ..] += 0.5 * w(u) * w(v) * A_s[.., 2I+u, ..],
    v = u + s - 2t, u, v in {-1,0,1} — pure stride-2 numpy views.  Boundary
    truncation of the 1D factors is reproduced exactly by zero padding, so
    the result matches the sparse triple product to rounding (tests pin it
    to 1e-13); two scipy SpGEMMs per level become ~30 strided elementwise
    passes.  Host-side, numpy in/out.
    """
    coeff = np.asarray(gs.coeff)
    offsets = [tuple(o) for o in gs.offsets]
    if any(abs(d) > 1 for o in offsets for d in o):
        raise ValueError("structured RAP needs a +-1 stencil")
    grid = list(gs.grid)
    W = {-1: 0.5, 0: 1.0, 1: 0.5}
    # axes: grid-axis indices to coarsen (None = all) — per-axis
    # semicoarsening just skips the uncoarsened axes' passes
    for a in (range(len(grid)) if axes is None else axes):
        F = grid[a]
        if (F - 1) % 2:
            raise ValueError("structured RAP needs odd extents per axis")
        C = (F - 1) // 2 + 1
        pad = [(0, 0)] * coeff.ndim
        pad[1 + a] = (1, 1)
        cp = np.pad(coeff, pad)
        out: dict = {}
        for k, off in enumerate(offsets):
            s = off[a]
            ck = cp[k]
            for u in (-1, 0, 1):
                for v in (-1, 0, 1):
                    if (u + s - v) % 2:
                        continue
                    t = (u + s - v) // 2
                    if abs(t) > 1:
                        continue
                    sl = [slice(None)] * ck.ndim
                    sl[a] = slice(u + 1, u + 2 * C, 2)
                    contrib = (0.5 * W[u] * W[v]) * ck[tuple(sl)]
                    noff = off[:a] + (t,) + off[a + 1:]
                    if noff in out:
                        out[noff] += contrib
                    else:
                        out[noff] = contrib
        offsets = sorted(out.keys())
        grid[a] = C
        coeff = np.stack([out[o] for o in offsets], axis=0)
    return GridStencil(coeff, tuple(offsets), tuple(grid))


# ---------------------------------------------------------------------------
# stride-2 grid transfers (matrix-dependent prolongators, e.g. smoothed
# aggregation with block-2^dim aggregates on a grid)
# ---------------------------------------------------------------------------

@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["coeff"],
                   meta_fields=["offsets", "fine_grid", "coarse_grid"])
@dataclass(frozen=True)
class Stride2Transfer:
    """Prolongation whose column of fine node f is the aggregate c with
    f = 2c + delta for a small static set of per-axis deltas:
    ``coeff[k, *f] = P[flat(f), flat((f - offsets[k]) / 2)]``.

    Covers any matrix-dependent P over stride-2 grid coarsening (tentative
    and smoothed aggregation operators on block-2^dim aggregates).  With
    U the stride-2 upsampling (coarse c lands on fine 2c, zeros between) —
    a strided interleave, no arithmetic — the transfers are shifts and
    multiplies only:
      prolong:  y = sum_k coeff_k * shift(U xc, offsets[k])
      restrict: rc = U^T sum_k shift(conj(coeff_k) * r, offsets[k])
    restrict is exactly the adjoint P^H (the SA convention R = P',
    reference SA-AMG.jl:49).
    """
    coeff: jax.Array                       # (ndiags, *fine_grid)
    offsets: tuple[tuple[int, ...], ...]
    fine_grid: tuple[int, ...]
    coarse_grid: tuple[int, ...]

    @property
    def dtype(self):
        return self.coeff.dtype

    @property
    def shape(self) -> tuple[int, int]:
        return (int(np.prod(self.fine_grid)), int(np.prod(self.coarse_grid)))

    def prolong(self, xc: jax.Array) -> jax.Array:
        """xc: (..., *coarse_grid) -> (..., *fine_grid)."""
        return _stride2_prolong(self.coeff, self.offsets,
                                self.fine_grid, xc)

    def restrict(self, r: jax.Array) -> jax.Array:
        """P^H r: (..., *fine_grid) -> (..., *coarse_grid)."""
        return _stride2_restrict(self.coeff, self.offsets,
                                 self.coarse_grid, r)

    def astype(self, dtype) -> "Stride2Transfer":
        return Stride2Transfer(self.coeff.astype(dtype), self.offsets,
                               self.fine_grid, self.coarse_grid)


def stride2_transfer_from_scipy(P: sp.spmatrix, fine_nodes, coarse_nodes,
                                dtype=None, max_delta: int = 3):
    """Extract a Stride2Transfer from an assembled prolongation matrix.

    fine_nodes/coarse_nodes: per-mesh-dim extents (dim 0 fastest).  Raises
    ValueError when some entry's delta = f - 2c exceeds max_delta per axis.
    """
    fine_nodes = [int(v) for v in np.asarray(fine_nodes).ravel()]
    coarse_nodes = [int(v) for v in np.asarray(coarse_nodes).ravel()]
    nf, nc = int(np.prod(fine_nodes)), int(np.prod(coarse_nodes))
    if P.shape != (nf, nc):
        raise ValueError("prolongation size does not match the node grids")
    fg = tuple(reversed(fine_nodes))
    cg = tuple(reversed(coarse_nodes))
    Pc = P.tocoo()
    fcoord = np.stack(np.unravel_index(Pc.row, fg), axis=1)
    ccoord = np.stack(np.unravel_index(Pc.col, cg), axis=1)
    d = fcoord - 2 * ccoord
    if d.size and int(np.abs(d).max()) > max_delta:
        raise ValueError("prolongation entry outside the stride-2 stencil")
    offs, pos = np.unique(d, axis=0, return_inverse=True)
    dt = dtype if dtype is not None else Pc.dtype
    coeff = np.zeros((len(offs), nf), dtype=dt)
    np.add.at(coeff, (pos, Pc.row), Pc.data.astype(dt))
    return Stride2Transfer(jnp.asarray(coeff.reshape((-1,) + fg)),
                           tuple(tuple(int(v) for v in o) for o in offs),
                           fg, cg)


def _interleave(even, odd, axis: int):
    """[e0, o0, e1, o1, ...] along `axis`; len(even) is len(odd) or
    len(odd) + 1 (then the last element is even's)."""
    k = odd.shape[axis]
    head = jnp.stack([jax.lax.slice_in_dim(even, 0, k, axis=axis), odd],
                     axis=axis + 1)
    head = head.reshape(odd.shape[:axis] + (2 * k,) + odd.shape[axis + 1:])
    if even.shape[axis] == k:
        return head
    return jnp.concatenate(
        [head, jax.lax.slice_in_dim(even, k, even.shape[axis], axis=axis)],
        axis=axis)


def _upsample2(x, axis: int, n: int):
    """Stride-2 upsampling along `axis`: out[2c] = x[c], zeros between,
    cut or zero-padded to length n."""
    y = _interleave(x, jnp.zeros_like(x), axis)
    c2 = y.shape[axis]
    if n <= c2:
        return jax.lax.slice_in_dim(y, 0, n, axis=axis)
    pad = [(0, 0)] * y.ndim
    pad[axis] = (0, n - c2)
    return jnp.pad(y, pad)


def _subsample2(x, axis: int, c: int):
    """Stride-2 subsampling along `axis` (the adjoint of _upsample2)."""
    return jax.lax.slice_in_dim(x, 0, 2 * c - 1, stride=2, axis=axis)


@functools.partial(jax.jit, static_argnames=("offsets", "fine_grid"))
def _stride2_prolong(coeff, offsets, fine_grid, xc):
    g = len(fine_grid)
    nb = xc.ndim - g
    up = xc
    for a in range(g):
        up = _upsample2(up, nb + a, fine_grid[a])
    y = jnp.zeros(xc.shape[:nb] + fine_grid, dtype=jnp.result_type(coeff, xc))
    for k, off in enumerate(offsets):
        xs = up
        for a, da in enumerate(off):
            xs = _shift(xs, nb + a, -da, fine_grid[a])
        y = y + coeff[k] * xs
    return y


@functools.partial(jax.jit, static_argnames=("offsets", "coarse_grid"))
def _stride2_restrict(coeff, offsets, coarse_grid, r):
    g = len(coarse_grid)
    nb = r.ndim - g
    fine_grid = coeff.shape[1:]
    s = jnp.zeros(r.shape[:nb] + tuple(fine_grid),
                  dtype=jnp.result_type(coeff, r))
    for k, off in enumerate(offsets):
        w = coeff[k].conj() * r
        for a, da in enumerate(off):
            w = _shift(w, nb + a, da, fine_grid[a])
        s = s + w
    for a in range(g):
        s = _subsample2(s, nb + a, coarse_grid[a])
    return s


# ---------------------------------------------------------------------------
# constant-interior compression
# ---------------------------------------------------------------------------

@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["const", "strips"],
                   meta_fields=["offsets", "grid", "boxes"])
@dataclass(frozen=True)
class ConstGridStencil:
    """Stencil whose coefficients are constant away from the grid boundary.

    Constant-coefficient discretizations (Poisson, shifted Laplacians, ...)
    and ALL their full-weighting Galerkin coarsenings deviate from a constant
    interior stencil only within a 2-node band at the grid boundary.  Storing
    one scalar per diagonal plus the boundary-band corrections removes the
    dominant HBM traffic of the stencil SpMV (the (ndiags, *grid) coefficient
    read) — the apply reads x once, writes y once, and touches O(surface)
    correction data.

    const:  (ndiags,) interior coefficients.
    strips: per boundary box, (ndiags, *box_size) actual coefficients on the
            box (zeros where the matrix entry does not exist).
    boxes:  per strip, (start, size) index boxes — a disjoint cover of the
            boundary band, two slabs per grid axis with each axis's slabs
            trimmed to the interior of the earlier axes (the assembly order
            the matvec's region concatenation relies on).
    """
    const: jax.Array
    strips: tuple
    offsets: tuple[tuple[int, ...], ...]
    grid: tuple[int, ...]
    boxes: tuple

    @property
    def dtype(self):
        return self.const.dtype

    @property
    def shape(self) -> tuple[int, int]:
        n = int(np.prod(self.grid))
        return (n, n)

    @property
    def nnz(self) -> int:
        # logical stencil size (for operator-complexity accounting)
        return int(len(self.offsets) * np.prod(self.grid))

    def matvec(self, x: jax.Array) -> jax.Array:
        g = len(self.grid)
        if x.ndim <= 2 and (g != x.ndim or x.shape != self.grid):
            squeeze = x.ndim == 1
            x2 = x[:, None] if squeeze else x
            yg = const_grid_stencil_matvec(
                self.const, self.strips, self.offsets, self.grid, self.boxes,
                flat_to_grid(x2, self.grid))
            y = grid_to_flat(yg)
            return y[:, 0] if squeeze else y
        return const_grid_stencil_matvec(self.const, self.strips,
                                         self.offsets, self.grid, self.boxes,
                                         x)

    def to_dense_stencil(self) -> GridStencil:
        nd = len(self.offsets)
        coeff = np.tile(np.asarray(self.const).reshape(
            (nd,) + (1,) * len(self.grid)), (1,) + self.grid)
        for (start, size), strip in zip(self.boxes, self.strips):
            sl = tuple(slice(s, s + z) for s, z in zip(start, size))
            coeff[(slice(None),) + sl] = np.asarray(strip)
        return GridStencil(jnp.asarray(coeff), self.offsets, self.grid)

    def to_scipy(self) -> sp.csr_matrix:
        return self.to_dense_stencil().to_scipy()

    def astype(self, dtype) -> "ConstGridStencil":
        return ConstGridStencil(self.const.astype(dtype),
                                tuple(s.astype(dtype) for s in self.strips),
                                self.offsets, self.grid, self.boxes)


def compress_grid_stencil(gs: GridStencil, width: int = 2,
                          rtol: float = 1e-13,
                          device: bool = True) -> ConstGridStencil | None:
    """Compress to constant-interior form, or None when not applicable.

    device=False keeps const/strips as numpy at the ORIGINAL dtype — jnp
    conversion would silently truncate f64 coefficients to f32 when x64 is
    off, which matters to callers that split them (ops/df32.py)."""
    grid = gs.grid
    dim = len(grid)
    if any(n < 3 * width for n in grid):
        return None
    coeff = np.asarray(gs.coeff)
    center = tuple(n // 2 for n in grid)
    c = coeff[(slice(None),) + center]
    delta = coeff - c.reshape((-1,) + (1,) * dim)
    interior = (slice(None),) + tuple(slice(width, n - width) for n in grid)
    scale = max(float(np.abs(coeff).max()), 1e-300)
    if float(np.abs(delta[interior]).max()) > rtol * scale:
        return None

    boxes, strips = [], []
    conv = jnp.asarray if device else np.asarray
    for a in range(dim):
        start = [0] * dim
        size = list(grid)
        for prev in range(a):       # stay disjoint from earlier axes' slabs
            start[prev] = width
            size[prev] = grid[prev] - 2 * width
        for s0 in (0, grid[a] - width):
            st, sz = list(start), list(size)
            st[a], sz[a] = s0, width
            boxes.append((tuple(st), tuple(sz)))
            sl = tuple(slice(b, b + z) for b, z in zip(st, sz))
            strips.append(conv(coeff[(slice(None),) + sl]))
    return ConstGridStencil(conv(c), tuple(strips), gs.offsets,
                            grid, tuple(boxes))


@functools.partial(jax.jit, static_argnames=("offsets", "grid", "boxes"))
def const_grid_stencil_matvec(const, strips, offsets, grid, boxes, x):
    """y = A x for a constant-interior stencil; x is (..., *grid).

    The output is assembled from disjoint regions — two boundary slabs per
    axis plus the constant-coefficient interior — concatenated along each
    axis, so every region is written exactly once (a scatter-add of the
    boundary corrections would read-modify-write the full output per slab,
    costing more than the coefficient traffic it saves).  XLA fuses each
    region's pad/slice/multiply-add chain into one loop fusion.  Writing the
    slabs in place over one full-grid constant pass instead measured no
    faster on an H100 (PERF.md).
    """
    g = len(grid)
    nb = x.ndim - g
    dt = jnp.result_type(const, x)
    lo = [max(0, -min(off[a] for off in offsets)) for a in range(g)]
    hi = [max(0, max(off[a] for off in offsets)) for a in range(g)]
    pad = [(0, 0)] * nb + [(lo[a], hi[a]) for a in range(g)]
    xp = jnp.pad(x, pad)

    def apply_box(start, size, coeffs):
        acc = jnp.zeros(x.shape[:nb] + tuple(size), dtype=dt)
        for k, off in enumerate(offsets):
            st = [0] * nb + [lo[a] + start[a] + off[a] for a in range(g)]
            sz = list(x.shape[:nb]) + list(size)
            acc = acc + coeffs[k] * jax.lax.dynamic_slice(xp, st, sz)
        return acc

    def assemble(a, start, size):
        if a == g:                       # fully-trimmed interior region
            return apply_box(start, size, const)
        (lo_start, lo_size), lo_strip = boxes[2 * a], strips[2 * a]
        (hi_start, hi_size), hi_strip = boxes[2 * a + 1], strips[2 * a + 1]
        w = lo_size[a]
        mid_start, mid_size = list(start), list(size)
        mid_start[a] = start[a] + w
        mid_size[a] = size[a] - 2 * w
        mid = assemble(a + 1, mid_start, mid_size)
        low = apply_box(lo_start, lo_size, lo_strip)
        high = apply_box(hi_start, hi_size, hi_strip)
        return jnp.concatenate([low, mid, high], axis=nb + a)

    return assemble(0, [0] * g, list(grid))
