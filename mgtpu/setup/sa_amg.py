"""Smoothed-Aggregation AMG setup (host-side).

Equivalent of the reference's SA-AMG.jl (standard smoothed aggregation with
Galerkin RAP, after Treister & Yavneh SISC 37(1) 2015 — the code version
implements the standard SA variant; see SURVEY.md item 2):

 * strength-of-connection: rows of -A scaled by their largest off-diagonal,
   unit diagonal, thresholded, symmetrised (reference SA-AMG.jl:88-116).
   Like the reference, the *pattern* used for neighborhood aggregation is the
   full symmetrised sparsity; the threshold only zeroes weak values, which
   affects the pass-3 affinity scores.
 * greedy neighborhood aggregation in three passes with hub-node deferral
   (degree > 3x average) and affinity-scored adoption of leftover nodes
   (reference SA-AMG.jl:119-211) for small levels; large levels use the
   device-parallel MIS-2 label-propagation kernel (setup/device_agg.py).
 * tentative prolongator P0 -> smoothed P = (I - (4/3 / rho) D A) P0 with
   D the level's diagonal preconditioner and rho estimated by
   min(opnorm_1, opnorm_inf) (reference SA-AMG.jl:44-47).
 * R = P^H, Galerkin RAP, coarsest Tikhonov shift 1e-8*||A||_1
   (reference SA-AMG.jl:50,63).
"""
from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp

from .hierarchy import (MGConfig, MGState, _per_level_relax_param,
                        _setup_relax, _RelaxThunk, build_device_hierarchy)

__all__ = ["sa_amg_setup", "get_aggregation", "strength_matrix",
           "neighborhood_aggregation", "aggregation_to_tentative_p",
           "sparsify_non_galerkin"]


def strength_matrix(A: sp.spmatrix, theta: float) -> sp.csr_matrix:
    """Symmetrised strength-of-connection matrix (values thresholded,
    pattern kept)."""
    S = sp.csr_matrix(-A.real) if np.iscomplexobj(A.data if hasattr(A, 'data') else A) else (-A).tocsr()
    S = S.astype(np.float64)
    S.sum_duplicates()
    mm = 1e-16 * max(S.data.max(), 1e-300) if S.nnz else 1e-16
    n = S.shape[0]
    counts = np.diff(S.indptr)
    rows = np.repeat(np.arange(n), counts)
    rowmax = np.full(n, mm)
    np.maximum.at(rowmax, rows, S.data)
    S.data = S.data / rowmax[rows]
    S.setdiag(1.0)
    S.data[S.data < theta] = 0.0
    return (S + S.T).tocsr()


def neighborhood_aggregation(S: sp.csr_matrix, tau: float = 3.0) -> np.ndarray:
    """Greedy neighborhood aggregation; returns aggr[i] = root node of i's
    aggregate (reference SA-AMG.jl:119-211 semantics, 0-based)."""
    n = S.shape[0]
    indptr, indices, data = S.indptr, S.indices, S.data
    aggr = np.zeros(n, dtype=np.int64) - 1        # -1: unaggregated
    counts = np.diff(indptr)
    avg = counts.mean() if n else 0.0
    hub = counts > tau * avg
    agg_size = np.zeros(n, dtype=np.int64)

    # pass 1: seed aggregates at non-hub nodes with fully-free neighborhoods
    for k in range(n):
        if hub[k]:
            continue
        nbrs = indices[indptr[k]:indptr[k + 1]]
        if np.any(aggr[nbrs] >= 0):
            continue
        sel = nbrs[~hub[nbrs]]
        aggr[sel] = k
        agg_size[k] = len(sel)

    # pass 2: hubs with untouched neighborhoods seed their own aggregates
    for k in range(n):
        if not hub[k]:
            continue
        nbrs = indices[indptr[k]:indptr[k + 1]]
        if np.any(aggr[nbrs] >= 0):
            continue
        aggr[nbrs] = k
        agg_size[k] = len(nbrs)

    # pass 3: leftover nodes adopt the neighboring aggregate with the best
    # mean affinity (sum of strength values into the aggregate / its size)
    for k in range(n):
        if aggr[k] >= 0:
            continue
        lo, hi = indptr[k], indptr[k + 1]
        nbrs = indices[lo:hi]
        vals = data[lo:hi]
        roots = aggr[nbrs]
        ok = roots >= 0
        if not np.any(ok):
            # isolated: become its own singleton aggregate
            aggr[k] = k
            agg_size[k] += 1
            continue
        scores = {}
        for r, v in zip(roots[ok], vals[ok]):
            scores[r] = scores.get(r, 0.0) + v
        best = max(scores, key=lambda r: scores[r] / max(agg_size[r], 1))
        aggr[k] = best      # adopted; does not grow the seed neighborhood
    return aggr


def aggregation_to_tentative_p(aggr: np.ndarray) -> sp.csr_matrix:
    """Unit tentative prolongator from an aggregate-root labelling
    (reference aggrArray2P, SA-AMG.jl:213-224)."""
    n = len(aggr)
    roots = np.unique(aggr)
    root2col = -np.ones(n, dtype=np.int64)
    root2col[roots] = np.arange(len(roots))
    cols = root2col[aggr]
    if np.any(cols < 0):
        raise RuntimeError("nodes without aggregates")
    return sp.csr_matrix((np.ones(n), (np.arange(n), cols)),
                         shape=(n, len(roots)))


def get_aggregation(A: sp.spmatrix, theta: float,
                    method: str = "auto") -> sp.csr_matrix:
    """P0, or identity when the level is too small to coarsen
    (reference SA-AMG.jl:78-86: n <= 100 stops).

    method: "auto" = the greedy host sweep (native C++ kernel when built,
    else numpy — identical outputs), the reference's own convergence
    contract (SA-AMG.jl:119-211).  Device MIS-2 converges in FEWER
    iterations (20 vs 50 on 512^2 rough sigma) at 1.37x the operator
    complexity; which wins the single-setup-single-solve total on the GPU
    is not measured yet (bench.py section agg_ab).  "device" opts
    into the MIS-2 label-propagation kernel (setup/device_agg.py) for
    many-solves-per-setup workflows; MGTPU_AGG overrides for A/B runs.
    """
    import os
    n = A.shape[0]
    if n <= 100:
        return sp.identity(n, format="csr")
    S = strength_matrix(A, theta)
    method = os.environ.get("MGTPU_AGG", method).lower()
    if method == "device":
        from .device_agg import device_aggregation
        aggr = device_aggregation(S)
    else:
        from ..utils import native
        aggr = native.aggregate(S)
        if aggr is None:
            aggr = neighborhood_aggregation(S)
    return aggregation_to_tentative_p(aggr)


def structured_tentative_p(node_counts):
    """Block-2^dim tentative prolongator on a node grid.

    Aggregates are per-axis index pairs {2c, 2c+1} (trailing singleton on odd
    extents) — the structured counterpart of the reference's greedy
    neighborhood aggregation, chosen so the smoothed prolongator stays a
    stride-2 grid stencil and the whole SA hierarchy runs on the zero-gather
    grid engine.  Returns (P0, coarse_counts).
    """
    node_counts = [int(v) for v in np.asarray(node_counts).ravel()]
    ncs = [(nn + 1) // 2 for nn in node_counts]
    strides_c = np.concatenate([[1], np.cumprod(ncs[:-1])]).astype(np.int64)
    n = int(np.prod(node_counts))
    idx = np.arange(n)
    cols = np.zeros(n, dtype=np.int64)
    rem = idx
    for a, nn in enumerate(node_counts):
        coord = rem % nn
        rem = rem // nn
        cols += (coord // 2) * strides_c[a]
    P0 = sp.csr_matrix((np.ones(n), (idx, cols)),
                       shape=(n, int(np.prod(ncs))))
    return P0, ncs


def _rho_estimate(M: sp.spmatrix) -> float:
    """Cheap spectral-radius bound: min of the operator 1- and inf-norms."""
    Mabs = abs(M)
    n1 = Mabs.sum(axis=0).max()
    ninf = Mabs.sum(axis=1).max()
    return float(min(n1, ninf))


def sparsify_non_galerkin(A_g: sp.csr_matrix, A_fine: sp.csr_matrix,
                          P0: sp.csr_matrix,
                          filtering_param: float = 0.0,
                          pattern_distance: int = 1) -> sp.csr_matrix:
    """Sparsified non-Galerkin coarse operator.

    After Treister & Yavneh, *Non-Galerkin Multigrid based on Sparsified
    Smoothed Aggregation*, SISC 37(1) 2015 (the paper the reference cites but
    whose sparsification its code does not implement — SURVEY.md item 2):
    the smoothed-prolongator Galerkin product P^T A P densifies with each
    level; restrict it to the aggregate-adjacency pattern (P0^T |A_g| P0-like,
    here: entries whose aggregates touch in the tentative pattern) plus an
    optional magnitude filter, and LUMP each removed off-diagonal entry into
    the two diagonals it connects.  Lumping preserves row sums (the action on
    the constant near-nullspace) and symmetry.

    filtering_param theta in [0, ~0.2]: additionally drop retained entries
    with |a_ij| < theta * sqrt(|a_ii a_jj|) — the reference's dormant
    FilteringParam (MGdef.jl:112), functional here.
    """
    A_g = A_g.tocsr()
    # sparsity target: distance-1 aggregate adjacency — aggregates coupled
    # through at least one fine-level entry (the tentative-Galerkin pattern
    # P0^T |A| P0, much sparser than the smoothed-P Galerkin pattern)
    pat = (abs(P0).T @ abs(A_fine) @ abs(P0)).tocsr()
    pat.data[:] = 1.0
    for _ in range(pattern_distance - 1):
        pat = (pat @ pat).tocsr()      # aggregate-graph distance-k adjacency
        pat.data[:] = 1.0

    keep = A_g.multiply(pat).tocsr()
    removed = (A_g - keep).tocsr()

    if filtering_param > 0.0:
        d = np.abs(keep.diagonal())
        coo = keep.tocoo()
        weak = (np.abs(coo.data) <
                filtering_param * np.sqrt(d[coo.row] * d[coo.col]))
        weak &= coo.row != coo.col
        if weak.any():
            removed = (removed + sp.coo_matrix(
                (coo.data[weak], (coo.row[weak], coo.col[weak])),
                shape=A_g.shape)).tocsr()
            coo.data[weak] = 0.0
            keep = sp.coo_matrix((coo.data, (coo.row, coo.col)),
                                 shape=A_g.shape).tocsr()
            keep.eliminate_zeros()

    # diagonal lumping of the removed mass: a_ii += sum_j removed_ij
    lump = np.asarray(removed.sum(axis=1)).ravel()
    return (keep + sp.diags(lump)).tocsr()


def sa_amg_setup(A: sp.spmatrix, cfg: MGConfig, relax_param=1.0,
                 coarse_solver=None, verbose: bool = False,
                 non_galerkin: bool = False, mesh=None) -> MGState:
    """Build a smoothed-aggregation hierarchy (reference SA_AMGsetup,
    SA-AMG.jl:8-76).

    non_galerkin=True enables the Treister-Yavneh sparsified coarse operators
    (off by default to match the reference code's standard-SA behavior); the
    filtering threshold comes from cfg.filtering_param.

    When the matrix lives on a regular `mesh` (nodal or cell-centered), pass
    it: aggregation switches to structured block-2^dim aggregates so every
    level stays a grid stencil and the smoothed transfers stay stride-2 grid
    stencils — the whole SA cycle then runs on the zero-gather grid engine
    (no gathers, unlike the ELL path the irregular aggregation requires).
    """
    t_all = time.perf_counter()
    # keep the ORIGINAL-precision operator: the refined drivers certify
    # against it (A_input).  Building the df32/f64 residual from the
    # f32-cast As[0] instead capped every flat-engine "certified" solve at
    # the OPERATOR's rounding (~5e-8 true relres, measured r5)
    A_orig = sp.csr_matrix(A)
    A = A_orig.astype(cfg.dtype)
    if cfg.relax_type not in ("jacobi", "jac-gmres", "spai",
                              "chebyshev", "chebyshev4"):
        raise ValueError("SA-AMG supports pointwise relaxations only "
                         "(same as the reference, SA-AMG.jl:27-31); "
                         "chebyshev counts — it is diagonal-based")
    structured_nodes = None
    if mesh is not None and cfg.engine in ("auto", "grid"):
        ncells = [int(v) for v in np.asarray(mesh.n).ravel()]
        for nodes in ([v + 1 for v in ncells], ncells):
            if int(np.prod(nodes)) == A.shape[0]:
                structured_nodes = nodes
                break
    rp_arr = _per_level_relax_param(relax_param, cfg.levels)
    As, Ps, Rs, relax_states = [A], [], [], []
    host_diags = []
    nn_levels = [structured_nodes]
    cop = A.nnz
    levels = cfg.levels
    for l in range(cfg.levels - 1):
        t0 = time.perf_counter()
        A_l = As[l]
        if structured_nodes is not None:
            if A_l.shape[0] <= 100:
                P0 = sp.identity(A_l.shape[0], format="csr")
            else:
                P0, nc_nodes = structured_tentative_p(nn_levels[l])
        else:
            P0 = get_aggregation(A_l, cfg.strong_conn_param)
        if P0.shape[0] == P0.shape[1]:
            if verbose:
                print(f"sa_amg_setup: stopped coarsening at level {l}")
            levels = l + 1
            break
        relax_states.append(_RelaxThunk(A_l, cfg, rp_arr[l], None))
        # prolongator-smoothing diagonal, computed on HOST from the host
        # operator (no device round trip during setup)
        from . import smoothers as sm
        if cfg.relax_type == "spai":
            d = sm.spai_diag(A_l, rp_arr[l]).astype(cfg.dtype)
        else:
            d = sm.jacobi_diag(A_l, rp_arr[l]).astype(cfg.dtype)
        host_diags.append(d)
        DA = sp.diags(d) @ A_l
        c = (4.0 / 3.0) / max(_rho_estimate(DA), 1e-300)
        P = (P0 - c * (DA @ P0)).tocsr()
        R = P.conj().T.tocsr()
        Ps.append(P)
        Rs.append(R)
        if structured_nodes is not None:
            nn_levels.append(nc_nodes)
        A_c = (R @ A_l @ P).tocsr().astype(cfg.dtype)
        if non_galerkin:
            # non_galerkin may be an int: the aggregate-graph pattern distance
            # (1 = tightest/sparsest, 2 = keep distance-2 couplings)
            A_c = sparsify_non_galerkin(A_c, A_l, P0, cfg.filtering_param,
                                        pattern_distance=int(non_galerkin))
        As.append(A_c)
        cop += A_c.nnz
        if verbose:
            print(f"sa_amg_setup: level {l} ({A_l.shape[0]} dofs -> "
                  f"{A_c.shape[0]}) took {time.perf_counter() - t0:.3f}s")
    from dataclasses import replace as _replace
    cfg = _replace(cfg, levels=levels, nu_pre=cfg.nu_pre[:levels],
                   nu_post=cfg.nu_post[:levels])
    if verbose:
        print(f"sa_amg_setup: operator complexity = {cop / As[0].nnz:.3f}")
    # coarsest-level Tikhonov regularisation (reference SA-AMG.jl:63)
    shift = 1e-8 * abs(As[-1]).sum(axis=1).max()
    As[-1] = (As[-1] + shift * sp.identity(As[-1].shape[0])).tocsr()

    state = MGState(cfg, relax_param, As, Ps, Rs,
                    meshes=([mesh] if mesh is not None else []),
                    A_input=A_orig, coarse_solver=coarse_solver)
    if structured_nodes is not None:
        try:
            state.hier = _structured_sa_hierarchy(state, nn_levels,
                                                  host_diags, verbose)
        except ValueError:
            # tiny coarse grids can defeat the stencil decomposition; the
            # matrices are still valid — fall back to the flat engine
            state.hier = build_device_hierarchy(state, relax_states, verbose)
    else:
        state.hier = build_device_hierarchy(state, relax_states, verbose)
    state.time_setup += time.perf_counter() - t_all
    return state


def _structured_sa_hierarchy(state: MGState, nn_levels, host_diags,
                             verbose: bool = False):
    """GridHierarchy for the structured-aggregation SA path: grid-stencil
    level operators + stride-2 smoothed-prolongator transfers."""
    import jax.numpy as jnp
    from ..cycle.grid_cycle import (GridLevel, GridHierarchy, DenseInverse,
                                    GridIterativeCoarse)
    from ..ops.grid_stencil import (make_grid_stencil,
                                    stride2_transfer_from_scipy)

    cfg = state.config
    nlev = state.num_levels
    levels = []
    for l in range(nlev):
        # smoothed-aggregation coarse stencils densify with depth (radius
        # grows ~1 per level, like the reference's Galerkin products);
        # let the extractor escalate within what the grid can disambiguate
        radius = min(2 + l, (min(nn_levels[l]) - 1) // 2, 6)
        try:
            A_st = make_grid_stencil(state.As[l], nn_levels[l],
                                     dtype=cfg.dtype,
                                     max_shift=max(radius, 1))
        except ValueError:
            # the coarsest operator's stencil is only ever applied by the
            # gmres-coarse escape hatch and the K-cycle — with a dense-LU
            # coarsest and V/W/F cycles the cycle never touches it
            if (l == nlev - 1 and cfg.coarse_solve == "lu"
                    and cfg.cycle_type != "K"):
                levels.append(GridLevel(None, None, None))
                continue
            raise
        d = P1 = None
        if l < nlev - 1:
            d = jnp.asarray(host_diags[l].astype(cfg.dtype)).reshape(
                A_st.grid)
            P1 = stride2_transfer_from_scipy(state.Ps[l], nn_levels[l],
                                             nn_levels[l + 1],
                                             dtype=cfg.dtype,
                                             max_delta=max(radius + 1, 3))
        levels.append(GridLevel(A_st, d, P1))
    A_c = state.As[-1]
    grid_c = tuple(reversed([int(v) for v in nn_levels[nlev - 1]]))
    if cfg.coarse_solve == "gmres":
        rp = state.relax_param
        omega = rp if np.isscalar(rp) else 1.0
        d_c = jnp.asarray((omega / A_c.diagonal()).astype(cfg.dtype)
                          ).reshape(grid_c)
        coarse = GridIterativeCoarse(levels[-1].A, d_c,
                                     cfg.gmres_coarse_inner)
    elif A_c.shape[0] <= 4096:
        Ad = np.asarray(A_c.astype(
            np.complex128 if np.iscomplexobj(A_c.data) else np.float64
        ).todense())
        inv = np.linalg.pinv(Ad, rcond=1e-12)
        coarse = DenseInverse(jnp.asarray(inv.astype(cfg.dtype)), grid_c)
    else:
        from ..cycle.grid_cycle import (_DENSE_LU_MAX, GridSparseLU,
                                        grid_dense_inverse_from_scipy)
        if A_c.shape[0] > _DENSE_LU_MAX:
            # beyond the replicated-dense budget (O(nc^2) device memory):
            # host SuperLU behind the same solve() protocol — same rule as
            # build_grid_hierarchy, so aggressive-coarsening SA setups
            # cannot OOM the chip on a 10^5-dof coarsest
            from scipy.sparse.linalg import splu
            fdt = np.complex128 if np.iscomplexobj(A_c.data) else np.float64
            coarse = GridSparseLU(splu(A_c.tocsc().astype(fdt)),
                                  tuple(grid_c))
        else:
            # device-built shifted inverse (reference coarsest shift,
            # SA-AMG.jl:63): LU + n-RHS solve on the device at setup, one
            # matmul in-cycle — no host O(nc^3) inversion
            coarse = grid_dense_inverse_from_scipy(A_c, grid_c, cfg.dtype)
    if verbose:
        print("sa_amg_setup: structured aggregation on the grid engine")
    return GridHierarchy(tuple(levels), coarse)
