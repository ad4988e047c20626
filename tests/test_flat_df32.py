"""Flat-engine (ELL) df32 certified refinement — regression for the r5 find.

sa/classical_amg_setup used to cast the input operator to the hierarchy
dtype and DISCARD the original, so _df32_residual_op fell back to the
f32-rounded As[0]: without x64 the refined solve silently certified against
the ROUNDED operator and the true residual floored at the operator's own
rounding (~5e-8 measured).  Now the setups keep A_input and the flat
engine gets the same df32-ELL compensated residual the sharded tiers use.
"""
import numpy as np
import scipy.sparse as sp
import jax

from mgtpu import get_mg_param, get_regular_mesh
from mgtpu.models.operators import nodal_div_sig_grad_matrix
from mgtpu.setup.sa_amg import sa_amg_setup
from mgtpu.setup.classical_amg import classical_amg_setup
from mgtpu.solvers.mg_solver import solve_mg_refined, _df32_residual_op


def _problem(n=96):
    M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    sig = np.exp(np.random.RandomState(3).randn(n * n))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    return A, b / np.linalg.norm(b)


def test_flat_engine_df32_operator_is_original_precision():
    A, _ = _problem()
    cfg, rp = get_mg_param(levels=3, relax_type="spai", dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp)
    from mgtpu.ops.df32 import DFEll
    op = _df32_residual_op(st)
    assert isinstance(op, DFEll)
    # the low words must carry the f64-vs-f32 rounding of the ORIGINAL
    # operator — all-zero lo means the original precision was discarded
    assert float(np.abs(np.asarray(op.values_lo)).max()) > 0.0
    assert st.A_input is not None
    assert st.A_input.dtype == np.float64


def test_flat_refined_true_1e8_with_x64():
    """Same contract under the suite's x64 config (the df32 branch is
    x64-independent by construction — both paths must certify)."""
    A, b = _problem()
    for setup in (sa_amg_setup, classical_amg_setup):
        cfg, rp = get_mg_param(levels=3, relax_type="spai",
                               dtype=np.float32)
        st = setup(A, cfg, rp)
        x, info = solve_mg_refined(st, b, tol=1e-8, max_iter=80)
        rr = np.linalg.norm(b - A.astype(np.float64) @ x)
        assert rr < 1.5e-8, (setup.__name__, rr, info["iters"])


def test_flat_refined_true_1e8_without_x64():
    """JAX's default is x64 OFF — certify in a subprocess (the
    suite's conftest enables x64 process-wide)."""
    import subprocess
    import sys
    import os
    code = """
import numpy as np, scipy.sparse as sp
import jax
jax.config.update("jax_platforms", "cpu")
assert not jax.config.read("jax_enable_x64")
from mgtpu import get_mg_param, get_regular_mesh
from mgtpu.models.operators import nodal_div_sig_grad_matrix
from mgtpu.setup.sa_amg import sa_amg_setup
from mgtpu.solvers.mg_solver import solve_mg_refined
n = 96
M = get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
sig = np.exp(np.random.RandomState(3).randn(n * n))
A = nodal_div_sig_grad_matrix(M, sig)
A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
b = A @ np.random.RandomState(4).rand(A.shape[0])
b /= np.linalg.norm(b)
cfg, rp = get_mg_param(levels=3, relax_type="spai", dtype=np.float32)
st = sa_amg_setup(A, cfg, rp)
x, info = solve_mg_refined(st, b, tol=1e-8, max_iter=80)
rr = np.linalg.norm(b - A.astype(np.float64) @ x)
assert rr < 1.5e-8, rr
print("TRUE_RR_OK", rr)
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=420, env=env,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout[-800:] + r.stderr[-800:]
    assert "TRUE_RR_OK" in r.stdout
