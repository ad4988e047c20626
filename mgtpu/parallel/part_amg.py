"""Partitioned-iterate multi-chip tier for unstructured (flat ELL) AMG
hierarchies — memory and bandwidth scale WITH devices.

The r3 sharded AMG tier (parallel/sharded_amg.py) row-shards operators but
keeps every iterate REPLICATED: one all-gather of the FULL vector per
operator application, so neither memory nor comm volume shrinks as devices
are added (measured 3.2 bytes/nnz/cycle vs 0.17 for the halo-exchange
stencil tier — tools/comm_volume.py).  The reference's distributed tier
keeps subdomain state on the owning worker and ships only
O(subdomain)-sized data per solve (reference
src/DomainDecomposition/DDParallel.jl:29-63,105).

This tier is the device-mesh equivalent: every level's rows AND every
iterate are partitioned into contiguous blocks over a 1D mesh axis, and
each operator application exchanges only the REMOTE ENTRIES its local rows
actually reference — a precomputed, static halo:

 * setup (host): for each level operator (A, P, R), find each shard's
   referenced off-shard columns, group them by owning shard, and express
   the exchange as per-ring-distance `ppermute` steps with setup-padded
   static sizes (XLA needs static shapes; distances with zero traffic on
   every device are dropped — for mesh-ordered AMG hierarchies only
   neighbor distances survive).  Local ELL column indices are remapped
   into the concatenated [local block | halo_d1 | halo_d2 | ...] layout,
   so the device-side apply is gather-free beyond the standard ELL take.
 * device: the whole cycle runs inside ONE shard_map region; vectors are
   (n/ndev, m) per device everywhere, collectives are the halo ppermutes
   plus one psum per norm, and only the coarsest solve gathers a full
   (small) vector for the replicated dense LU.

The cycle itself is the SAME `recursive_cycle` as single-chip — `PartELL`
just implements `matvec` with the halo exchange inlined — so iterates
match the single-chip flat engine to reduction-order rounding and
iteration counts are identical (pinned by tests/test_part_amg.py).

Smoothers: pointwise (jacobi/SPAI), Chebyshev (degree-k, NO runtime dot
products), and Jac-GMRES — whose FGMRES projection psums its Gram inner
products over the mesh axis (cycle/relax.py::fgmres_relaxation axis_name,
threaded through MGConfig.axis_name), so K-cycles and Krylov smoothing run
fully partitioned with single-chip iteration parity (the reference's
distributed tier hands each worker an arbitrary inner solver,
DDParallel.jl:29-63, and its K-cycle machinery has no serial assumption,
MGcycle.jl:72-76 + FGMRES.jl:40-126).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..cycle.cycle import recursive_cycle
from ..cycle.coarse import DenseLU, SparseLUCoarse, IterativeCoarse
from ..cycle.relax import DiagRelax, ChebyshevRelax
from ..ops.df32 import df_accumulate, df_residual_ell, DFEll
from ..ops.ell import ELL, ell_matvec, ell_arrays_from_scipy
from ..setup.hierarchy import Hierarchy, Level

__all__ = ["PartitionedAMGSolver", "PartELL", "partition_plan"]


def _halo_concat(x, send_idx, dists, ndev, axis):
    """[x_loc | recv_d1 | recv_d2 | ...]: one ppermute per ring distance.

    send_idx[i] (S_i,) holds the LOCAL rows this device ships to the
    device `dists[i]` ahead on the ring; the receiver's remapped column
    indices point at the concatenation offsets, so no unpack/scatter is
    needed (the sender emits entries in the receiver's expected order —
    both sides of the plan come from the same sorted needed-set)."""
    parts = [x]
    for d, sidx in zip(dists, send_idx):
        buf = jnp.take(x, sidx, axis=0)
        perm = [(t, (t + d) % ndev) for t in range(ndev)]
        parts.append(jax.lax.ppermute(buf, axis_name=axis, perm=perm))
    return jnp.concatenate(parts, axis=0) if len(parts) > 1 else x


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["indices", "values", "send_idx"],
                   meta_fields=["shape", "dists", "ndev", "axis"])
@dataclass(frozen=True)
class PartELL:
    """Row-block-local ELL operator with a static halo-exchange plan.

    Shapes are LOCAL (per device, inside shard_map): indices/values are
    (p_rows, K) after the leading device axis is stripped; `shape` reports
    (p_rows, p_cols + halo) so the cycle engine sizes coarse vectors
    locally.  Padded ELL slots are local index 0 / value 0 (always safe);
    padded send slots ship row 0 (receivers never reference them)."""
    indices: jax.Array        # (ndev, p, K) at build; (p, K) in-region
    values: jax.Array
    send_idx: tuple           # per distance: (ndev, S_d) / (S_d,) in-region
    shape: tuple[int, int]
    dists: tuple
    ndev: int
    axis: str

    @property
    def dtype(self):
        return self.values.dtype

    def halo(self, x):
        return _halo_concat(x, self.send_idx, self.dists, self.ndev,
                            self.axis)

    def matvec(self, x):
        return ell_matvec(self.indices, self.values, self.halo(x))


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["lu", "piv"],
                   meta_fields=["nc", "p", "ndev", "axis"])
@dataclass(frozen=True)
class PartDenseLU:
    """Replicated dense coarsest solve on partitioned vectors: all-gather
    the (small) coarse RHS, solve everywhere, keep the local slice.  The
    reference analog: the coarsest LU is always global (MGsetup.jl:350)."""
    lu: jax.Array
    piv: jax.Array
    nc: int
    p: int
    ndev: int
    axis: str

    def solve(self, b_loc):
        bf = jax.lax.all_gather(b_loc, self.axis, axis=0, tiled=True)
        x = DenseLU(self.lu, self.piv).solve(bf[:self.nc])
        x = jnp.pad(x, ((0, self.ndev * self.p - self.nc), (0, 0)))
        s = jax.lax.axis_index(self.axis)
        return jax.lax.dynamic_slice_in_dim(x, s * self.p, self.p, axis=0)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=[],
                   meta_fields=["factor", "nc", "p", "ndev", "axis"])
@dataclass(frozen=True)
class PartSparseLU:
    """Replicated host-SuperLU coarsest solve on partitioned vectors:
    all-gather the coarse RHS, one `pure_callback` into the host factor
    (cycle/coarse.py::SparseLUCoarse design point), keep the local slice."""
    factor: object          # scipy.sparse.linalg.SuperLU (f64/c128)
    nc: int
    p: int
    ndev: int
    axis: str

    def solve(self, b_loc):
        bf = jax.lax.all_gather(b_loc, self.axis, axis=0, tiled=True)
        b = bf[:self.nc]

        def cb(bh):
            out = self.factor.solve(np.asarray(bh, self.factor.U.dtype))
            return out.astype(bh.dtype)

        def do(bb):
            return jax.pure_callback(
                cb, jax.ShapeDtypeStruct(bb.shape, bb.dtype), bb,
                vmap_method="sequential")

        # the gathered RHS is identical on every device — run the host
        # factor ONCE (device 0) and broadcast via psum, instead of ndev
        # serialized host solves per coarsest visit
        s = jax.lax.axis_index(self.axis)
        x = jax.lax.cond(s == 0, do, lambda bb: jnp.zeros_like(bb), b)
        x = jax.lax.psum(x, self.axis)
        x = jnp.pad(x, ((0, self.ndev * self.p - self.nc), (0, 0)))
        return jax.lax.dynamic_slice_in_dim(x, s * self.p, self.p, axis=0)


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["A", "d"], meta_fields=["inner", "axis"])
@dataclass(frozen=True)
class PartIterativeCoarse:
    """Jacobi-preconditioned one-shot FGMRES coarsest solve on PARTITIONED
    vectors (reference MGcycle.jl:152-168 escape hatch, distributed): the
    coarsest operator is a PartELL with its own halo plan and the FGMRES
    projection psums its Gram inner products over the mesh axis — the only
    coarsest option with NO replication at all (no all-gather)."""
    A: PartELL              # (ndev, ...) at build; local inside shard_map
    d: jax.Array            # (ndev, p) at build; (p,) in-region
    inner: int
    axis: str

    def solve(self, b_loc):
        from ..cycle.relax import fgmres_relaxation
        dcol = self.d[:, None]
        return fgmres_relaxation(self.A.matvec, lambda r: dcol * r,
                                 b_loc, jnp.zeros_like(b_loc), self.inner,
                                 axis_name=self.axis)


def _ell_with_mask(A: sp.csr_matrix, dtype):
    idx, val, shape = ell_arrays_from_scipy(A, dtype=dtype)
    counts = np.diff(A.indptr)
    mask = np.arange(idx.shape[1])[None, :] < counts[:, None]
    return idx, val, mask, shape


def partition_plan(A: sp.csr_matrix, ndev: int, p_r: int, p_c: int, dtype):
    """Host-side halo plan for one operator with row blocks of p_r and
    column-side vector blocks of p_c.

    Returns (idx3 (ndev, p_r, K) remapped, val3, dists, sends, H) where
    sends[i] is the (ndev, S_i) per-device LOCAL send list for ring
    distance dists[i] and H = sum S_i is the per-device halo length."""
    A = sp.csr_matrix(A)
    idx, val, mask, (n_r, _) = _ell_with_mask(A, dtype)
    K = idx.shape[1]
    Nr = p_r * ndev
    pad = ((0, Nr - n_r), (0, 0))
    idx3 = np.pad(idx, pad).reshape(ndev, p_r, K)
    val3 = np.pad(val, pad).reshape(ndev, p_r, K)
    mask3 = np.pad(mask, pad).reshape(ndev, p_r, K)

    # needed[s][t]: sorted unique columns shard s reads from owner t
    needed = [[None] * ndev for _ in range(ndev)]
    for s in range(ndev):
        cols = idx3[s][mask3[s]]
        own = cols // p_c
        for t in np.unique(own):
            if t != s:
                needed[s][int(t)] = np.unique(cols[own == t])

    dists = sorted({(s - t) % ndev
                    for s in range(ndev) for t in range(ndev)
                    if needed[s][t] is not None})
    sends, offs, H = [], {}, 0
    for d in dists:
        S_d = max(len(needed[(t + d) % ndev][t])
                  if needed[(t + d) % ndev][t] is not None else 0
                  for t in range(ndev))
        send = np.zeros((ndev, S_d), np.int32)
        for t in range(ndev):
            nl = needed[(t + d) % ndev][t]
            if nl is not None:
                send[t, :len(nl)] = nl - t * p_c
        sends.append(send)
        offs[d] = H
        H += S_d

    new_idx = np.zeros_like(idx3)
    for s in range(ndev):
        cols = idx3[s]
        own = cols // p_c
        out = np.where(own == s, cols - s * p_c, 0)
        for d in dists:
            t = (s - d) % ndev
            nl = needed[s][t]
            if nl is None:
                continue
            sel = own == t
            out[sel] = p_c + offs[d] + np.searchsorted(nl, cols[sel])
        new_idx[s] = np.where(mask3[s], out, 0)
    return new_idx, val3, tuple(dists), sends, H


def _pad_vec_blocks(v: np.ndarray, ndev: int, p: int):
    return np.pad(v, ((0, ndev * p - v.shape[0]),) + ((0, 0),) * (v.ndim - 1))


class PartitionedAMGSolver:
    """End-to-end multi-chip solver over one flat (AMG) hierarchy with
    PARTITIONED iterates: per-device memory = n/ndev + halo per level.

    Built from an `MGState` whose device hierarchy is the flat engine
    (`sa_amg_setup(A, cfg, rp)` without a mesh, or `classical_amg_setup`).
    `comm_entries_per_cycle()` reports the setup-derived halo traffic.
    """

    def __init__(self, state, mesh: Mesh, axis: str = "x"):
        from ..cycle.grid_cycle import GridHierarchy
        cfg = state.config
        if isinstance(state.hier, GridHierarchy):
            raise ValueError("state uses the structured grid engine — use "
                             "ShardedGridSolver (parallel/sharded_solve.py)")
        if cfg.relax_type not in ("jacobi", "spai", "chebyshev",
                                  "chebyshev4", "jac-gmres"):
            raise ValueError(
                "partitioned AMG supports pointwise smoothers "
                "(jacobi/spai/chebyshev/jac-gmres); Vanka/Kaczmarz states "
                "are not partitioned — use ShardedAMGSolver")
        if np.dtype(cfg.dtype) != np.float32:
            raise ValueError("partitioned AMG refinement assumes a float32 "
                             "hierarchy (df32 residual certifies ~1e-13)")
        self.state = state
        self.cfg = cfg
        # the cycle traced inside shard_map needs psum-aware FGMRES
        # projections (jac-gmres smoothing, K-cycles): axis_name tells
        # fgmres_relaxation to globalise its Gram inner products
        cyc_cfg = dataclasses.replace(cfg, axis_name=axis)
        self.mesh = mesh
        self.axis = axis
        ndev = mesh.shape[axis]
        self.ndev = ndev
        nlev = len(state.As)
        self.p = [-(-A.shape[0] // ndev) for A in state.As]
        self.n_true = int(state.As[0].shape[0])

        rows3 = NamedSharding(mesh, P(axis))     # leading device axis
        repl = NamedSharding(mesh, P())
        put = jax.device_put

        self._comm = {}
        levels = []
        for l, lvl in enumerate(state.hier.levels):
            A_l = state.As[l].astype(cfg.dtype)
            ai, av, ad, asends, aH = partition_plan(
                A_l, ndev, self.p[l], self.p[l], cfg.dtype)
            ops = {"A": (ai, av, ad, asends, aH, self.p[l])}
            if l < nlev - 1:
                # hierarchy convention: P maps coarse->fine (rows fine),
                # R maps fine->coarse (rows coarse)
                pi, pv, pd, psends, pH = partition_plan(
                    sp.csr_matrix(state.Ps[l]).astype(cfg.dtype), ndev,
                    self.p[l], self.p[l + 1], cfg.dtype)
                ri, rv, rd, rsends, rH = partition_plan(
                    sp.csr_matrix(state.Rs[l]).astype(cfg.dtype), ndev,
                    self.p[l + 1], self.p[l], cfg.dtype)
                ops["P"] = (pi, pv, pd, psends, pH, self.p[l + 1])
                ops["R"] = (ri, rv, rd, rsends, rH, self.p[l])
            self._comm[l] = {k: {"halo_entries": v[4],
                                 "dists": list(v[2])}
                             for k, v in ops.items()}

            def mk(key, p_rows):
                i3, v3, dd, ss, H, pc = ops[key]
                return PartELL(put(jnp.asarray(i3), rows3),
                               put(jnp.asarray(v3), rows3),
                               tuple(put(jnp.asarray(s), rows3)
                                     for s in ss),
                               (p_rows, pc + H), dd, ndev, axis)

            A_op = mk("A", self.p[l])
            P_op = mk("P", self.p[l]) if "P" in ops else None
            R_op = mk("R", self.p[l + 1]) if "R" in ops else None
            relax = self._shard_relax(lvl.relax, l, rows3)
            levels.append(Level(A_op, P_op, R_op, relax))

        coarse = state.hier.coarse
        nc = state.As[-1].shape[0]
        self.levels = tuple(levels)
        # dense/sparse LU coarsests are replicated pytrees (spec P());
        # the iterative coarsest is itself partitioned (spec P(axis)) and
        # its leading device axis is stripped inside the region like the
        # level operators'
        coarse_strip = False
        if isinstance(coarse, DenseLU):
            self.coarse = PartDenseLU(put(coarse.lu, repl),
                                      put(coarse.piv, repl),
                                      nc, self.p[-1], ndev, axis)
        elif isinstance(coarse, SparseLUCoarse):
            # host-SuperLU escape hatch for coarsest levels beyond the
            # replicated-dense budget (reference: UMFPACK factors ANY
            # coarsest size, MGsetup.jl:350) — gather the small coarse RHS,
            # one pure_callback to the host factor, keep the local slice
            self.coarse = PartSparseLU(coarse.factor, nc, self.p[-1],
                                       ndev, axis)
        elif isinstance(coarse, IterativeCoarse):
            # fully-partitioned coarsest: FGMRES over the PartELL coarsest
            # operator, projections psum'ed — zero replication.  The level
            # loop already built the coarsest A as a PartELL with exactly
            # these (matrix, p, dtype) — reuse it instead of recomputing
            # the halo plan and holding a second device copy
            A_c = levels[-1].A
            d_np = _pad_vec_blocks(np.asarray(coarse.d, cfg.dtype), ndev,
                                   self.p[-1]).reshape(ndev, self.p[-1])
            self.coarse = PartIterativeCoarse(
                A_c, put(jnp.asarray(d_np), rows3), coarse.inner, axis)
            self._comm[nlev - 1]["coarse_gmres"] = dict(
                self._comm[nlev - 1]["A"])
            coarse_strip = True
        else:
            raise ValueError(
                f"partitioned AMG supports dense-LU, host-SuperLU, or "
                f"FGMRES coarsest solves; got {type(coarse).__name__}")

        # df32 fine operator for certified refinement: same plan machinery,
        # hi/lo split on HOST f64 values (jnp.asarray without x64 would
        # silently truncate — BASELINE.md pitfall)
        A_hi = state.A_input if getattr(state, "A_input", None) is not None \
            else state.As[0]
        di, dv64, dd, dsends, dH = partition_plan(
            sp.csr_matrix(A_hi), ndev, self.p[0], self.p[0], np.float64)
        v_hi = dv64.astype(np.float32)
        v_lo = (dv64 - v_hi.astype(np.float64)).astype(np.float32)
        self._df = (put(jnp.asarray(di), rows3),
                    put(jnp.asarray(v_hi), rows3),
                    put(jnp.asarray(v_lo), rows3),
                    tuple(put(jnp.asarray(s), rows3) for s in dsends))
        self._df_dists = dd
        self._comm[0]["df_residual"] = {"halo_entries": dH,
                                        "dists": list(dd)}

        def cycle_body(levels_dev, coarse_, b, x):
            levels_loc = jax.tree_util.tree_map(lambda a: a[0], levels_dev)
            if coarse_strip:
                coarse_ = jax.tree_util.tree_map(lambda a: a[0], coarse_)
            hier = Hierarchy(levels_loc, coarse_)
            return recursive_cycle(cyc_cfg, hier, b, x)

        self._coarse_spec = P(axis) if coarse_strip else P()
        self._coarse_strip = coarse_strip
        self._cycle_sm = jax.jit(shard_map(
            cycle_body, mesh=mesh,
            in_specs=(P(axis), self._coarse_spec, P(axis), P(axis)),
            out_specs=P(axis), check_vma=False))
        self.cyc_cfg = cyc_cfg
        self._refined_cache = {}

    def _build_refined(self, max_iter: int):
        """Jitted sharded refinement program for one (static) max_iter."""
        if max_iter in self._refined_cache:
            return self._refined_cache[max_iter]
        cfg, mesh, axis, ndev = self.cyc_cfg, self.mesh, self.axis, self.ndev
        ddists = self._df_dists

        def refined_body(levels_dev, coarse_, df_dev, b_hi, b_lo, xh, xl,
                         tol):
            levels_loc = jax.tree_util.tree_map(lambda a: a[0], levels_dev)
            if self._coarse_strip:
                coarse_ = jax.tree_util.tree_map(lambda a: a[0], coarse_)
            hier = Hierarchy(levels_loc, coarse_)
            didx, dvh, dvl = df_dev[0][0], df_dev[1][0], df_dev[2][0]
            dsidx = tuple(s[0] for s in df_dev[3])
            m = b_hi.shape[1]

            def df_res(xh_, xl_):
                # ONE exchange ships hi and lo stacked along the rhs axis
                both = jnp.concatenate([xh_, xl_], axis=1)
                bf = _halo_concat(both, dsidx, ddists, ndev, axis)
                dfA = DFEll(didx, dvh, dvl, (didx.shape[0], bf.shape[0]))
                return df_residual_ell(dfA, b_hi, b_lo, bf[:, :m],
                                       bf[:, m:])

            def norm(v):
                return jnp.sqrt(jax.lax.psum(jnp.sum(v * v), axis))

            res0 = norm(b_hi)
            resvec = jnp.zeros((max_iter + 1,), jnp.float32)

            def cond(carry):
                _, _, _, it, res, _ = carry
                ok = jnp.logical_and(
                    res >= tol * jnp.maximum(res0, 1e-38),
                    res < 1e3 * jnp.maximum(res0, 1e-38))
                return jnp.logical_and(it < max_iter, ok)

            def body(carry):
                xh_, xl_, rh, it, res, rv = carry
                z = recursive_cycle(cfg, hier, rh, jnp.zeros_like(rh),
                                    x_zero=True)
                xh_, xl_ = df_accumulate(xh_, xl_, z)
                rh, _ = df_res(xh_, xl_)
                res = norm(rh)
                rv = rv.at[it + 1].set(res)
                return (xh_, xl_, rh, it + 1, res, rv)

            rh0, _ = df_res(xh, xl)
            res_i = norm(rh0)
            resvec = resvec.at[0].set(res_i)
            xh, xl, _, iters, res, resvec = jax.lax.while_loop(
                cond, body, (xh, xl, rh0, jnp.int32(0), res_i, resvec))
            return xh, xl, iters, res, res0, resvec

        fn = jax.jit(shard_map(
            refined_body, mesh=mesh,
            in_specs=(P(axis), self._coarse_spec, P(axis), P(axis), P(axis),
                      P(axis), P(axis), P()),
            out_specs=(P(axis), P(axis), P(), P(), P(), P()),
            check_vma=False))
        self._refined_cache[max_iter] = fn
        return fn

    def _shard_relax(self, rx, l, rows3):
        p = self.p[l]
        ndev = self.ndev

        def blocks(v):
            v = np.asarray(v)
            return jnp.asarray(_pad_vec_blocks(v, ndev, p)
                               .reshape(ndev, p))

        put = jax.device_put
        if rx is None:                     # coarsest level has no smoother
            return None
        if isinstance(rx, DiagRelax):
            return DiagRelax(put(blocks(rx.d), rows3))
        if isinstance(rx, ChebyshevRelax):
            return ChebyshevRelax(put(blocks(rx.d), rows3), rx.lam_max)
        raise ValueError(f"unsupported relax type {type(rx).__name__}")

    # -- driver surface -----------------------------------------------------

    def _to_dev(self, v, dtype):
        v = np.asarray(v, dtype)
        squeeze = v.ndim == 1
        v2 = v[:, None] if squeeze else v
        v2 = _pad_vec_blocks(v2, self.ndev, self.p[0])
        sh = NamedSharding(self.mesh, P(self.axis, None))
        return jax.device_put(jnp.asarray(v2), sh), squeeze

    def cycle(self, b, x=None):
        """One multigrid cycle; accepts/returns host (n,) or (n, m)."""
        b2, squeeze = self._to_dev(b, self.cfg.dtype)
        x2 = (jnp.zeros_like(b2) if x is None
              else self._to_dev(x, self.cfg.dtype)[0])
        y = self._cycle_sm(self.levels, self.coarse, b2, x2)
        y = np.asarray(y)[:self.n_true]
        return y[:, 0] if squeeze else y

    def solve_refined(self, b, x=None, tol: float = 1e-8,
                      max_iter: int | None = None):
        """Partitioned mixed-precision refinement to true (f64-certified)
        tolerance — the whole loop is ONE sharded device program."""
        cfg = self.cfg
        if max_iter is None:
            max_iter = cfg.max_outer_iter
        b64 = np.asarray(b, np.float64)
        bh, squeeze = self._to_dev(b64.astype(np.float32), np.float32)
        bl, _ = self._to_dev(
            (b64 - b64.astype(np.float32).astype(np.float64))
            .astype(np.float32), np.float32)
        if x is None:
            xh, xl = jnp.zeros_like(bh), jnp.zeros_like(bl)
        else:
            x64 = np.asarray(x, np.float64)
            xh, _ = self._to_dev(x64.astype(np.float32), np.float32)
            xl, _ = self._to_dev(
                (x64 - x64.astype(np.float32).astype(np.float64))
                .astype(np.float32), np.float32)
        fn = self._build_refined(int(max_iter))
        xh, xl, iters, res, res0, resvec = fn(
            self.levels, self.coarse, self._df, bh, bl, xh, xl,
            jnp.float32(tol))
        iters = int(iters)
        x_np = (np.asarray(xh, np.float64)
                + np.asarray(xl, np.float64))[:self.n_true]
        if squeeze:
            x_np = x_np[:, 0]
        return x_np, {"iters": iters,
                      "relres": float(res) / max(float(res0), 1e-300),
                      "resvec": np.asarray(resvec)[:iters + 1]}

    def comm_entries_per_cycle(self) -> dict:
        """Setup-derived halo sizes (entries shipped per operator apply per
        device) — the scaling story in numbers: halo << n/ndev."""
        return self._comm

    def local_vector_rows(self) -> dict:
        """Per-device iterate rows per level (= ceil(n_l/ndev); the memory
        claim `n/ndev + halo`)."""
        return {l: self.p[l] for l in range(len(self.p))}
