"""mgtpu — a GPU-native multigrid solver framework (JAX/XLA).

Built from scratch with the capability surface of JuliaInv/Multigrid.jl
(see SURVEY.md at the repo root): geometric multigrid on regular meshes
(Galerkin RAP or re-discretization), smoothed-aggregation and classical AMG,
V/W/F/K cycles with first-class multiple right-hand sides, Jacobi/SPAI/
FGMRES-smoothed/Vanka/Kaczmarz relaxation, staggered-grid transfers for
elasticity/Stokes systems, dense-LU or iterative coarsest solves, Krylov
wrappers, overlapping Schwarz domain decomposition, and multi-chip sharding
over a `jax.sharding.Mesh`.
"""

from .config import enable_x64
from .models.mesh import (RegularMesh, get_regular_mesh,
                          get_cell_centered_grid, get_nodal_grid)
from .setup.hierarchy import (MGConfig, get_mg_param, mg_setup, MGState,
                              Hierarchy, Level, OperatorConstructor,
                              transpose_hierarchy, replace_matrix_in_hierarchy,
                              copy_solver, clear, hierarchy_exists)
from .solvers.mg_solver import (solve_mg, solve_mg_jit, solve_mg_refined,
                                get_mg_preconditioner,
                                get_afun, solve_cg_mg, solve_bicgstab_mg,
                                solve_gmres_mg)
from .solvers.wrappers import MGSolver, SAAMGSolver, ClassicalAMGSolver
from .solvers.direct import DirectSolver, batched_dense_lu
from .solvers.schur import SchurComplementSolver
from .setup.sa_amg import sa_amg_setup
from .setup.classical_amg import classical_amg_setup
from .krylov.cg import pcg
from .krylov.fgmres import fgmres, block_fgmres
from .krylov.bicgstab import bicgstab
from .cycle.cycle import recursive_cycle, make_cycle_fn

__version__ = "0.1.0"
