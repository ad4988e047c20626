"""Multigrid hierarchy: configuration, setup, and lifecycle.

Equivalent of the reference's MGparam + MGsetup layer (src/Multigrid/MGdef.jl:91-116,
MGsetup.jl:7-138) redesigned functionally for an accelerator:

 * `MGConfig` — immutable, hashable solver configuration (the static part that
   shapes the compiled cycle): levels, cycle type, relaxation, per-level sweep
   counts, transfer family, coarse solver choice.  Mirrors getMGparam's
   parameter set (MGdef.jl:149-161).
 * `Hierarchy` — immutable device pytree of per-level operators, transfers and
   smoother states, plus the coarsest solver.  This is what jitted cycles
   consume; rebuilding it is cheap because the heavy data stays in host CSR
   form inside `MGState`.
 * `MGState` — host-side handle bundling config + host matrices + device
   hierarchy; supports the reference's lifecycle surface: replace_matrix
   (MGsetup.jl:226-270), transpose (MGsetup.jl:274-318), copy/clear
   (MGdef.jl:138-145,179-210).

Unlike the reference there is no preallocated CYCLEmem/FGMRESmem: XLA owns
buffers; changing the number of right-hand sides simply retraces the jitted
cycle for the new (n, nrhs) shape — the functional analog of
adjustMemoryForNumRHS (MGsetup.jl:166-223).
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..models.mesh import RegularMesh, get_regular_mesh
from ..ops.dia import DIA, dia_from_scipy
from ..ops.ell import ELL, ell_from_scipy
from ..cycle.coarse import dense_lu_from_scipy, iterative_coarse_from_scipy
from ..cycle.relax import DiagRelax

# Replicated-dense coarsest budget: beyond this the L/U (or inverse) factor
# alone is O(nc^2) device memory (20480^2 f32 = 1.7 GB; the old 70000 cap
# would have shipped a 19.6 GB factor).  Larger coarsest levels
# fall through to the host SuperLU callback (cycle/coarse.py:SparseLUCoarse).
_DENSE_COARSE_MAX = 20480
from . import transfers as tr
from . import smoothers as sm

__all__ = [
    "MGConfig", "get_mg_param", "Level", "Hierarchy", "MGState",
    "OperatorConstructor", "mg_setup", "transpose_hierarchy",
    "replace_matrix_in_hierarchy", "copy_solver", "clear",
]

VANKA_TYPES = ("vanka", "econ-vanka", "vanka-lex", "vanka-add", "kaczmarz-vanka")

# reference relaxType spellings accepted as aliases
_RELAX_ALIASES = {
    "Jac": "jacobi", "Jac-GMRES": "jac-gmres", "SPAI": "spai",
    "VankaFaces": "vanka", "EconVankaFaces": "econ-vanka",
    "VankaFacesLex": "vanka-lex", "VankaFacesAdd": "vanka-add",
    "hybridKaczmarzNodal": "hybrid-kaczmarz",
    "hybridVankaFacesKaczmarz": "kaczmarz-vanka",
    "Cheb": "chebyshev", "Chebyshev": "chebyshev",
    "Cheb4": "chebyshev4", "Chebyshev4": "chebyshev4",
    "LineJac": "line-jacobi",
}
_TRANSFER_ALIASES = {
    "FullWeighting": "full-weighting",
    "SemiCoarsening": "semicoarsening",
    "SystemsFacesLinear": "systems-faces",
    "SystemsFacesMixedLinear": "systems-faces-mixed",
}
_COARSE_ALIASES = {"NoMUMPS": "lu", "Julia": "lu", "MUMPS": "lu", "GMRES": "gmres",
                   "BiCGSTAB": "gmres"}


@dataclass(frozen=True, eq=True)
class MGConfig:
    """Static multigrid configuration (hashable: shapes the compiled cycle)."""
    levels: int = 3
    max_outer_iter: int = 20
    relative_tol: float = 1e-6
    relax_type: str = "spai"
    nu_pre: tuple[int, ...] = ()     # per level; filled by get_mg_param
    nu_post: tuple[int, ...] = ()
    cycle_type: str = "V"
    coarse_solve: str = "lu"         # "lu" | "gmres" | "external"
    strong_conn_param: float = 0.4
    filtering_param: float = 0.0
    transfer_type: str = "full-weighting"
    dtype: Any = np.float64
    kcycle_inner: int = 2
    gmres_coarse_inner: int = 10
    engine: str = "auto"             # "auto" | "grid" | "flat"
    cheby_degree: int = 3            # polynomial degree per chebyshev sweep
    cheby_frac: float = 0.25         # smoothing interval [frac*lam, lam]
    # mesh-axis name for cycles traced INSIDE a shard_map region with
    # PARTITIONED iterates: FGMRES projections (jac-gmres smoothing,
    # K-cycles) psum their Gram inner products over this axis so every
    # device solves the same global projection (parallel/part_amg.py sets
    # it; None = single-device/replicated semantics, the default)
    axis_name: str | None = None

    @property
    def mixed(self) -> bool:
        return self.transfer_type == "systems-faces-mixed"


def get_mg_param(levels: int = 3, max_outer_iter: int = 20,
                 relative_tol: float = 1e-6, relax_type: str = "spai",
                 relax_param=1.0, nu_pre=2, nu_post=2, cycle_type: str = "V",
                 coarse_solve: str = "lu", strong_conn_param: float = 0.4,
                 filtering_param: float = 0.0,
                 transfer_type: str = "full-weighting",
                 dtype=np.float64, engine: str = "auto",
                 cheby_degree: int = 3,
                 cheby_frac: float = 0.25) -> tuple[MGConfig, Any]:
    """Configuration constructor mirroring getMGparam (MGdef.jl:149-161).

    Returns (config, relax_param); sweep counts may be ints or per-level
    sequences/callables (reference relaxPre/relaxPost are per-level functions,
    MGdef.jl:98-99).
    """
    relax_type = _RELAX_ALIASES.get(relax_type, relax_type)
    transfer_type = _TRANSFER_ALIASES.get(transfer_type, transfer_type)
    coarse_solve = _COARSE_ALIASES.get(coarse_solve, coarse_solve)

    def to_tuple(v):
        if callable(v):
            return tuple(int(v(l)) for l in range(levels))
        if np.isscalar(v):
            return (int(v),) * levels
        return tuple(int(x) for x in v)

    cfg = MGConfig(levels=levels, max_outer_iter=max_outer_iter,
                   relative_tol=relative_tol, relax_type=relax_type,
                   nu_pre=to_tuple(nu_pre), nu_post=to_tuple(nu_post),
                   cycle_type=cycle_type, coarse_solve=coarse_solve,
                   strong_conn_param=strong_conn_param,
                   filtering_param=filtering_param,
                   transfer_type=transfer_type, dtype=np.dtype(dtype).type,
                   engine=engine, cheby_degree=cheby_degree,
                   cheby_frac=cheby_frac)
    return cfg, relax_param


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["A", "P", "R", "relax"], meta_fields=[])
@dataclass(frozen=True)
class Level:
    A: Any                 # ELL | DIA
    P: Any                 # ELL | None (coarsest)
    R: Any                 # ELL | None
    relax: Any             # DiagRelax | VankaRelax | KaczmarzRelax | None


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["levels", "coarse"], meta_fields=[])
@dataclass(frozen=True)
class Hierarchy:
    levels: tuple          # Level per level, coarsest included (P/R/relax None)
    coarse: Any            # DenseLU | IterativeCoarse | external solver pytree


@dataclass
class OperatorConstructor:
    """PDE re-discretization callback (reference multilevelOperatorConstructor,
    MGdef.jl:31-46): get_operator(mesh, param) -> scipy matrix;
    restrict_params(mesh_fine, mesh_coarse, param, level) -> coarse param."""
    param: Any
    get_operator: Callable
    restrict_params: Callable | None = None

    def operator(self, mesh):
        if self.restrict_params is None:
            return self.get_operator(mesh)
        return self.get_operator(mesh, self.param)

    def restricted(self, mesh_f, mesh_c, level):
        if self.restrict_params is None:
            return self
        new_param = self.restrict_params(mesh_f, mesh_c, self.param, level)
        return OperatorConstructor(new_param, self.get_operator,
                                   self.restrict_params)


@dataclass
class MGState:
    """Host-side solver handle (the mutable shell around the device pytree)."""
    config: MGConfig
    relax_param: Any
    As: list            # host CSR per level (the operator itself, row-major)
    Ps: list            # host CSR prolongations (coarse -> fine)
    Rs: list            # host CSR restrictions (fine -> coarse)
    meshes: list
    hier: Hierarchy | None = None
    A_input: Any = None            # fine operator at its ORIGINAL precision
    coarse_solver: Any = None      # external coarse solver template, if any
    do_transpose: int = 0
    nnz_per_level: list = field(default_factory=list)
    # observability counters (reference MGWrapper.jl:16-18)
    time_setup: float = 0.0
    time_solve: float = 0.0
    n_iter: int = 0

    @property
    def num_levels(self) -> int:
        return len(self.As)

    def operator_complexity(self) -> float:
        return sum(a.nnz for a in self.As) / max(self.As[0].nnz, 1)


def _semicoarsen_axes(gs, theta: float = 0.25) -> list:
    """Per-MESH-axis coarsening flags: coarsen axes whose pure-axis coupling
    is within `theta` of the strongest (the robust-MG semicoarsening rule).
    gs: host grid stencil of the level operator."""
    coeff = np.asarray(gs.coeff)
    dim = len(gs.grid)
    strength = np.zeros(dim)
    for k, off in enumerate(gs.offsets):
        nz = [a for a, d in enumerate(off) if d != 0]
        if len(nz) == 1 and abs(off[nz[0]]) == 1:
            ga = nz[0]
            strength[dim - 1 - ga] = max(strength[dim - 1 - ga],
                                         float(np.abs(coeff[k]).mean()))
    smax = strength.max() if dim else 0.0
    return [bool(sv >= theta * smax and sv > 0) for sv in strength]


def hierarchy_exists(state: MGState | None) -> bool:
    return state is not None and state.hier is not None and len(state.As) > 0


class _LazySparseList:
    """Per-level transfer matrices, materialised on first access.

    The flat kron P/R assembly is only needed by the flat-engine fallback,
    the scipy-RAP lifecycle fallback, and tests — the grid engine applies
    transfers from the 1D factors directly.  Deferring the kron removes the
    dominant host assembly cost of 3D setup.  Entries are sparse matrices or
    0-arg thunks producing one."""

    def __init__(self):
        self._items = []

    def append(self, item):
        self._items.append(item)

    def __getitem__(self, i):
        it = self._items[i]
        if callable(it):
            it = self._items[i] = it()
        return it

    def __setitem__(self, i, value):
        self._items[i] = value

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return (self[i] for i in range(len(self._items)))


# ---------------------------------------------------------------------------
# relaxation setup dispatch (reference getRelaxPrec, MGsetup.jl:142-160)
# ---------------------------------------------------------------------------

def _setup_relax(A: sp.spmatrix, cfg: MGConfig, relax_param, mesh):
    rt = cfg.relax_type
    if rt in ("jacobi", "jac-gmres"):
        return sm.jacobi_prec(A, relax_param, dtype=cfg.dtype)
    if rt == "spai":
        return sm.spai_prec(A, relax_param, dtype=cfg.dtype)
    if rt in ("chebyshev", "chebyshev4"):
        return sm.chebyshev_prec(A, relax_param, dtype=cfg.dtype)
    if rt == "line-jacobi":
        return sm.line_prec(A, mesh, relax_param, dtype=cfg.dtype)
    if rt in VANKA_TYPES:
        return sm.setup_vanka(A, mesh, relax_param, cfg.mixed, rt,
                              dtype=cfg.dtype)
    if rt == "hybrid-kaczmarz":
        from ..cycle.kaczmarz import setup_hybrid_kaczmarz
        from ..dd.indices import nodal_indices_of_box
        opts = relax_param  # KaczmarzOptions-like mapping
        return setup_hybrid_kaczmarz(
            A, mesh, opts["num_domains"],
            opts.get("index_fn", nodal_indices_of_box),
            opts.get("omega", 0.8), opts.get("num_it", 1), dtype=cfg.dtype)
    raise ValueError(f"unknown relaxation type: {rt}")


class _RelaxThunk:
    """Deferred relaxation setup.

    The grid engines rebuild smoother state in grid form (and the systems
    engine recomputes Vanka block inverses itself), so the flat tables are
    only materialised when the flat path is actually taken — Vanka table
    packing is the dominant setup cost for staggered systems.
    """

    def __init__(self, *args):
        self._args = args
        self._val = None

    def resolve(self):
        if self._val is None:
            self._val = _setup_relax(*self._args)
            self._args = None
        return self._val


def _resolve_relax(rs):
    return rs.resolve() if isinstance(rs, _RelaxThunk) else rs


def _per_level_relax_param(relax_param, levels: int):
    if isinstance(relax_param, (list, tuple)) and not np.isscalar(relax_param):
        if len(relax_param) == levels and all(
                np.isscalar(v) or isinstance(v, tuple) for v in relax_param):
            return list(relax_param)
    return [relax_param] * levels


# ---------------------------------------------------------------------------
# device hierarchy construction (shared with the AMG setups)
# ---------------------------------------------------------------------------

def _to_device_matrix(A: sp.spmatrix, dtype, prefer_dia: bool = True):
    if prefer_dia:
        D = dia_from_scipy(A, dtype=dtype, max_diags=40)
        if D is not None and D.data.size <= 3 * A.nnz:
            return D
    return ell_from_scipy(A.tocsr(), dtype=dtype)


def _setup_coarse(state: MGState, verbose: bool = False):
    """Factorise / prepare the coarsest solver (reference defineCoarsestAinv,
    MGsetup.jl:323-355)."""
    cfg = state.config
    A_c = state.As[-1]
    if state.coarse_solver is not None:
        mesh_c = state.meshes[-1] if state.meshes else None
        return state.coarse_solver.setup_coarse(A_c, mesh_c)
    if cfg.coarse_solve == "gmres":
        rp = _per_level_relax_param(state.relax_param, cfg.levels)[-1]
        omega = rp if np.isscalar(rp) else 1.0
        return iterative_coarse_from_scipy(A_c, omega,
                                           inner=cfg.gmres_coarse_inner,
                                           dtype=cfg.dtype)
    if A_c.shape[0] > _DENSE_COARSE_MAX:
        # beyond the replicated-dense budget: host sparse LU behind the same
        # solve() protocol (the reference's UMFPACK design point,
        # MGsetup.jl:350) — O(nnz) factor instead of O(nc^2) device memory
        from ..cycle.coarse import sparse_lu_from_scipy
        if verbose:
            print(f"_setup_coarse: nc={A_c.shape[0]} > {_DENSE_COARSE_MAX}, "
                  "using host SuperLU coarsest")
        return sparse_lu_from_scipy(A_c, dtype=cfg.dtype)
    return dense_lu_from_scipy(A_c, dtype=cfg.dtype)


def build_device_hierarchy(state: MGState, relax_states: list,
                           verbose: bool = False) -> Hierarchy:
    cfg = state.config
    nlev = state.num_levels
    # grid engine (zero-gather matrix-free cycle) whenever the hierarchy is a
    # structured full-weighting one — the flat ELL/DIA path stays as the
    # general fallback (AMG, staggered systems, block smoothers)
    if cfg.engine in ("auto", "grid"):
        try:
            if cfg.transfer_type in ("systems-faces", "systems-faces-mixed"):
                from ..cycle.systems_grid import build_systems_grid_hierarchy
                gh = build_systems_grid_hierarchy(state, relax_states)
            else:
                from ..cycle.grid_cycle import build_grid_hierarchy
                gh = build_grid_hierarchy(state, relax_states)
            if verbose:
                print("build_device_hierarchy: using the grid stencil engine")
            return gh
        except ValueError as e:
            if cfg.engine == "grid":
                raise ValueError(f"engine='grid' not applicable: {e}") from e
    # Kaczmarz/Vanka relaxations embed their own row tables; ELL for those
    # levels avoids storing the operator twice in incompatible layouts.
    prefer_dia = cfg.relax_type in ("jacobi", "jac-gmres", "spai")
    levels = []
    for l in range(nlev):
        A_dev = _to_device_matrix(state.As[l], cfg.dtype, prefer_dia)
        if l < nlev - 1:
            P_dev = ell_from_scipy(state.Ps[l].tocsr(), dtype=cfg.dtype)
            R_dev = ell_from_scipy(state.Rs[l].tocsr(), dtype=cfg.dtype)
            levels.append(Level(A_dev, P_dev, R_dev,
                                _resolve_relax(relax_states[l])))
        else:
            levels.append(Level(A_dev, None, None, None))
    coarse = _setup_coarse(state, verbose)
    return Hierarchy(tuple(levels), coarse)


# ---------------------------------------------------------------------------
# geometric multigrid setup (reference MGsetup, MGsetup.jl:7-138)
# ---------------------------------------------------------------------------

def mg_setup(A_or_ctor, mesh: RegularMesh, cfg: MGConfig, relax_param=None,
             coarse_solver=None, verbose: bool = False) -> MGState:
    """Build a geometric hierarchy by Galerkin RAP or re-discretization.

    `A_or_ctor` is the operator itself as a scipy sparse matrix (row-major
    semantics: we compute A @ x; the reference's transposed-CSC storage is an
    artifact of its CPU SpMV and is not reproduced) or an OperatorConstructor
    for the re-discretization path.
    """
    t_all = time.perf_counter()
    if relax_param is None:
        relax_param = 1.0
    geometric = isinstance(A_or_ctor, OperatorConstructor)
    if geometric:
        ctor = A_or_ctor
        A = sp.csr_matrix(ctor.operator(mesh))
    else:
        ctor = None
        A = sp.csr_matrix(A_or_ctor)
    A_input = A
    A = A.astype(cfg.dtype)

    rp_arr = _per_level_relax_param(relax_param, cfg.levels)
    As, meshes, relax_states = [A], [mesh], []
    Ps, Rs = _LazySparseList(), _LazySparseList()
    n = np.asarray(mesh.n)
    cop = A.nnz
    dim = mesh.dim
    levels = cfg.levels
    _gs_cache: dict = {}

    for l in range(cfg.levels - 1):
        t0 = time.perf_counter()
        A_l = As[l]
        sc_axes = None                   # mesh-axis coarsening flags (semi)
        if cfg.transfer_type == "semicoarsening":
            # coarsen only the STRONGLY coupled axes (classic robust-MG
            # rule; the reference has no semicoarsening — this pairs with
            # the line smoother for anisotropy at depth, ROADMAP item)
            from ..ops.grid_stencil import grid_stencil_from_csr
            gs_f = _gs_cache.get(l)
            if gs_f is None:
                try:
                    gs_f = grid_stencil_from_csr(A_l, list(n + 1),
                                                 device=False)
                except ValueError as e:
                    raise ValueError(
                        "transfer_type='semicoarsening' needs a grid-stencil "
                        f"operator (strong-axis detection): {e}") from e
                _gs_cache[l] = gs_f
            sc_axes = _semicoarsen_axes(gs_f)
            p1s, nc1s = [], []
            for a, nd in enumerate(n + 1):
                nd = int(nd)
                if sc_axes[a] and nd % 2 == 1 and nd >= 5:
                    P1, c1 = tr.fw_interp_1d(nd)
                else:
                    sc_axes[a] = False
                    P1, c1 = sp.identity(nd, format="csr"), nd
                p1s.append(P1)
                nc1s.append(c1)
            if not any(sc_axes):
                if verbose:
                    print(f"mg_setup: stopped coarsening at level {l}")
                levels = l + 1
                break
            nc = np.asarray(nc1s, dtype=np.int64) - 1
            d_c = int(sum(sc_axes))
            P_entry = (lambda ms=tuple(p1s): tr._kron_nd(list(ms)))
            R_entry = (lambda ms=tuple(p1s), d=d_c:
                       ((0.5 ** d) * tr._kron_nd(list(ms)).T).tocsr())
        elif cfg.transfer_type == "full-weighting":
            # build only the cheap 1D factors now; the flat kron P/R (needed
            # by the flat fallback and scipy-RAP lifecycle fallback only) is
            # deferred via _LazySparseList — the grid engine never reads it
            p1s, nc1s = zip(*(tr.fw_interp_1d(int(nd), geometric)
                              for nd in (n + 1)))
            nc = np.asarray(nc1s, dtype=np.int64) - 1
            if all(m.shape[0] == m.shape[1] for m in p1s):
                if verbose:
                    print(f"mg_setup: stopped coarsening at level {l}")
                levels = l + 1
                break
            P_entry = (lambda ms=tuple(p1s): tr._kron_nd(list(ms)))
            # R = 0.5^dim P^T: the Galerkin scaling that matches geometric
            # stencil scaling (reference MGsetup.jl:61,72)
            R_entry = (lambda ms=tuple(p1s), d=dim:
                       ((0.5 ** d) * tr._kron_nd(list(ms)).T).tocsr())
        elif cfg.transfer_type in ("systems-faces", "systems-faces-mixed"):
            P, R, nc = tr.linear_operators_systems_faces(list(n), cfg.mixed)
            if P.shape[0] == P.shape[1]:
                if verbose:
                    print(f"mg_setup: stopped coarsening at level {l}")
                levels = l + 1
                break
            P_entry = P.tocsr()
            R_entry = ((0.5 ** dim) * R).tocsr()
        else:
            raise ValueError(f"unknown transfer type {cfg.transfer_type}")

        relax_states.append(_RelaxThunk(A_l, cfg, rp_arr[l], meshes[l]))
        Ps.append(P_entry)
        Rs.append(R_entry)
        mesh_c = get_regular_mesh(meshes[l].domain, nc)
        meshes.append(mesh_c)
        if ctor is None:
            A_c = None
            if cfg.transfer_type in ("full-weighting", "semicoarsening"):
                # structured stencil RAP: two scipy SpGEMMs -> ~30 strided
                # numpy passes on the grid-form coefficients (which the grid
                # engine reuses via the cache below)
                from ..ops.grid_stencil import (grid_stencil_from_csr,
                                                structured_fw_rap)
                try:
                    gs_f = _gs_cache.get(l)
                    if gs_f is None:
                        gs_f = grid_stencil_from_csr(A_l, list(n + 1),
                                                     device=False)
                        _gs_cache[l] = gs_f
                    dim_g = len(gs_f.grid)
                    rap_axes = (None if sc_axes is None else
                                tuple(dim_g - 1 - a
                                      for a, c in enumerate(sc_axes) if c))
                    gs_c = structured_fw_rap(gs_f, axes=rap_axes)
                    _gs_cache[l + 1] = gs_c
                    A_c = gs_c.to_scipy().tocsr()
                    A_c.eliminate_zeros()   # boundary non-entries
                except ValueError:
                    A_c = None
            if A_c is None:
                A_c = (Rs[l] @ A_l @ Ps[l]).tocsr()
        else:
            ctor = ctor.restricted(meshes[l], mesh_c, l)
            A_c = sp.csr_matrix(ctor.operator(mesh_c))
        A_c = A_c.astype(cfg.dtype)
        As.append(A_c)
        cop += A_c.nnz
        if verbose:
            print(f"mg_setup: level {l} ({int(np.prod(n))} cells) took "
                  f"{time.perf_counter() - t0:.3f}s")
        n = np.asarray(nc)

    cfg = replace(cfg, levels=levels,
                  nu_pre=cfg.nu_pre[:levels], nu_post=cfg.nu_post[:levels])
    if verbose:
        print(f"mg_setup: operator complexity = {cop / As[0].nnz:.3f}")

    state = MGState(cfg, relax_param, As, Ps, Rs, meshes,
                    A_input=A_input, coarse_solver=coarse_solver)
    state._gs_cache = {k: v for k, v in _gs_cache.items()
                       if v.coeff.dtype == np.dtype(cfg.dtype)} \
        if _gs_cache else {}
    # full-weighting transfers built above ARE the separable fw_interp
    # factors; the grid engine can skip re-verifying them by kron assembly.
    # Matrix path only: the geometric (ctor) path builds fw_interp with
    # geometric=True, which returns identity factors for even node extents —
    # those differ from the geometric=False factors build_grid_hierarchy
    # re-derives, so the kron verification must run there.
    state._fw_separable = (cfg.transfer_type in ("full-weighting",
                                                 "semicoarsening")
                           and not geometric)
    t0 = time.perf_counter()
    state.hier = build_device_hierarchy(state, relax_states, verbose)
    if verbose:
        print(f"mg_setup: coarsest {cfg.coarse_solve} ({As[-1].shape[0]} dofs) "
              f"in {time.perf_counter() - t0:.3f}s")
    state.time_setup += time.perf_counter() - t_all
    state.do_transpose = 0
    return state


# ---------------------------------------------------------------------------
# lifecycle (reference MGsetup.jl:226-318, MGdef.jl:138-210)
# ---------------------------------------------------------------------------

def replace_matrix_in_hierarchy(state: MGState, A: sp.spmatrix,
                                verbose: bool = False) -> MGState:
    """Re-setup for a new matrix with the same sparsity/geometry, reusing the
    existing transfers (reference replaceMatrixInHierarchy, MGsetup.jl:226-270)."""
    state._gs_cache = {}        # host stencil cache is stale for the new matrix
    state._hi_op_cache = None   # ... as are the refined-solve operator caches
    state._df32_op_cache = None
    cfg = state.config
    t_all = time.perf_counter()
    rp_arr = _per_level_relax_param(state.relax_param, cfg.levels)
    As = [sp.csr_matrix(A).astype(cfg.dtype)]
    state.A_input = sp.csr_matrix(A)
    relax_states = []
    cop = As[0].nnz
    # structured stencil RAP when the stored transfers are the separable
    # full-weighting factors (the steady-state jInv path re-setups per
    # inversion iteration, MGsetup.jl:226-270 — the two scipy SpGEMMs per
    # level dominate otherwise); the rebuilt grid stencils seed _gs_cache so
    # build_device_hierarchy skips re-extraction too
    use_rap = (cfg.transfer_type == "full-weighting"
               and getattr(state, "_fw_separable", False) and state.meshes)
    for l in range(state.num_levels - 1):
        mesh_l = state.meshes[l] if state.meshes else None
        relax_states.append(_RelaxThunk(As[l], cfg, rp_arr[l], mesh_l))
        A_c = None
        if use_rap:
            from ..ops.grid_stencil import (grid_stencil_from_csr,
                                            structured_fw_rap)
            try:
                gs_f = state._gs_cache.get(l)
                if gs_f is None:
                    n_l = np.asarray(state.meshes[l].n)
                    gs_f = grid_stencil_from_csr(As[l], list(n_l + 1),
                                                 device=False)
                    state._gs_cache[l] = gs_f
                gs_c = structured_fw_rap(gs_f)
                state._gs_cache[l + 1] = gs_c
                A_c = gs_c.to_scipy().tocsr().astype(cfg.dtype)
                A_c.eliminate_zeros()
            except ValueError:
                use_rap = False
                A_c = None
        if A_c is None:
            A_c = (state.Rs[l] @ As[l] @ state.Ps[l]).tocsr().astype(cfg.dtype)
        As.append(A_c)
        cop += A_c.nnz
    if verbose:
        print(f"replace_matrix: operator complexity = {cop / As[0].nnz:.3f}")
    state.As = As
    state.hier = build_device_hierarchy(state, relax_states, verbose)
    state.do_transpose = 0
    state._hi_op_cache = None
    state.time_setup += time.perf_counter() - t_all
    return state


def transpose_hierarchy(state: MGState, verbose: bool = False) -> MGState:
    """Flip the hierarchy to solve A^H x = b (reference transposeHierarchy,
    MGsetup.jl:274-318): conjugate-transpose every level, swap P/R, re-derive
    smoothers, refactor the coarsest."""
    state._gs_cache = {}        # host stencil cache is stale for A^H
    state._hi_op_cache = None   # ... as are the refined-solve operator caches
    state._df32_op_cache = None
    if state.config.relax_type not in ("jacobi", "jac-gmres", "spai"):
        raise NotImplementedError(
            "transpose is supported for pointwise relaxations only "
            "(same restriction as the reference, MGsetup.jl:288-291)")
    t_all = time.perf_counter()
    state.As = [a.conj().T.tocsr() for a in state.As]
    if state.A_input is not None:
        state.A_input = state.A_input.conj().T.tocsr()
    new_Ps = [r.conj().T.tocsr() for r in state.Rs]
    new_Rs = [p.conj().T.tocsr() for p in state.Ps]
    state.Ps, state.Rs = new_Ps, new_Rs
    cfg = state.config
    rp_arr = _per_level_relax_param(state.relax_param, cfg.levels)
    relax_states = []
    for l in range(state.num_levels - 1):
        mesh_l = state.meshes[l] if state.meshes else None
        relax_states.append(_RelaxThunk(state.As[l], cfg, rp_arr[l], mesh_l))
    state.hier = build_device_hierarchy(state, relax_states, verbose)
    state.do_transpose = (state.do_transpose + 1) % 2
    state._hi_op_cache = None
    state.time_setup += time.perf_counter() - t_all
    return state


def copy_solver(state: MGState) -> MGState:
    """Clone configuration without the setup (reference copySolver,
    MGdef.jl:138-145)."""
    return MGState(state.config, state.relax_param, [], [], [], [],
                   coarse_solver=state.coarse_solver)


def clear(state: MGState) -> None:
    """Drop hierarchy + factorizations (reference clear!/destroyCoarsestLU,
    MGdef.jl:179-206). Device buffers are freed by GC once unreferenced."""
    state.As, state.Ps, state.Rs, state.meshes = [], [], [], []
    state.hier = None
