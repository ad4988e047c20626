"""Slope-timed XLA stencil kernels and grid transfers against a copy, one GPU.

    python tools/measure_kernels.py

Times, with bench.py's slope method, at deployment sizes:
  * device-to-device copies (read + write) of a 257^3 float32 field and of
    flat 128 MiB and 512 MiB buffers; the fastest is the bandwidth every
    stencil number is compared with;
  * the constant-interior stencil matvec at 257^3 (7-point fine level and a
    27-point Galerkin-form stencil), and the 27-point Galerkin level 129^3;
  * the fine-level Jacobi sweep + residual pair at 257^3;
  * the scalar full-weighting transfers (restrict + prolong at the fine
    level, and one whole V-cycle) at 4097^2 and 257^3, in the strided form
    the library uses and in the dense per-axis matmul form.
Each stencil time comes with its compulsory bytes and their share of the
copy's bandwidth.  Prints the card and one JSON line, and writes the JSON to
chiprun_out/measure_kernels.json.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    if jax.default_backend() != "gpu":
        sys.exit("measure_kernels: no GPU backend")
    from bench import _chain_timer
    from mgtpu import get_mg_param, get_regular_mesh, mg_setup
    from mgtpu.cycle.grid_cycle import (GridHierarchy, GridLevel, grid_cycle,
                                        grid_prolong, grid_restrict)
    from mgtpu.models.operators import nodal_laplacian_matrix
    from mgtpu.ops.grid_stencil import ConstGridStencil
    from mgtpu.setup.transfers import fw_interp_1d

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    out = {"card": card, "jax": jax.__version__,
           "device_kind": jax.devices()[0].device_kind}

    def state(n, dim, levels):
        M = get_regular_mesh([0.0, 1.0] * dim, [n] * dim)
        L = nodal_laplacian_matrix(M)
        L = (L + 1e-4 * abs(L).sum(axis=0).max()
             * sp.identity(L.shape[0])).tocsr()
        cfg, rp = get_mg_param(levels=levels, relax_type="jacobi",
                               relax_param=0.8, nu_pre=1, nu_post=1,
                               dtype=np.float32)
        return cfg, mg_setup(L, M, cfg, rp)

    def field(grid, seed):
        return jnp.asarray(np.random.RandomState(seed)
                           .rand(1, *grid).astype(np.float32))

    def share(nbytes, ms):
        return nbytes / (ms * 1e-3) / out["copy_GBps"] / 1e9

    ks = (10, 110)
    cfg3, st3 = state(256, 3, 6)
    A0 = st3.hier.levels[0].A
    grid = A0.grid
    npts = int(np.prod(grid))
    x = field(grid, 0)
    one = jnp.float32(1.0)
    # read + write copies: the 257^3 field itself, and flat power-of-two
    # buffers (aligned rows); the fastest is the bandwidth reference
    copies = {}
    for tag, v in (("257^3", x),
                   ("flat_2^25", jnp.ones((1 << 25,), jnp.float32)),
                   ("flat_2^27", jnp.ones((1 << 27,), jnp.float32))):
        ms = _chain_timer(lambda h, b, u: u * h, one, v, v, ks=ks)
        copies[tag] = {"ms": ms, "GBps": 8 * v.size / (ms * 1e-3) / 1e9}
        print(f"copy {tag}: {ms:.4f} ms, {copies[tag]['GBps']:.1f} GB/s",
              flush=True)
    out["copies"] = copies
    out["copy_GBps"] = max(c["GBps"] for c in copies.values())

    def matvec_row(name, A, xin):
        n = int(np.prod(A.grid))
        sc = jnp.float32(1.0 / float(np.abs(np.asarray(A.const)).sum()))
        t = _chain_timer(lambda h, b, v: sc * h.matvec(v), A, xin, xin,
                         ks=ks)
        out[name] = {"ms": t, "bytes": 8 * n, "copy_share": share(8 * n, t)}
        print(f"{name}: {t:.4f} ms, {out[name]['copy_share']:.3f} of copy",
              flush=True)

    assert isinstance(A0, ConstGridStencil) and len(A0.offsets) == 7
    matvec_row("matvec7_257", A0, x)
    A1 = st3.hier.levels[1].A
    assert isinstance(A1, ConstGridStencil) and len(A1.offsets) == 27
    matvec_row("matvec27_129_galerkin", A1, field(A1.grid, 1))
    # 27-point constant-interior stencil on the 257^3 grid: the fine level's
    # box structure with a full 3x3x3 offset set (timing needs the shape,
    # not the values)
    offs = tuple(itertools.product((-1, 0, 1), repeat=3))
    c27 = np.random.RandomState(2).rand(27).astype(np.float32)
    A27 = ConstGridStencil(
        jnp.asarray(c27),
        tuple(jnp.broadcast_to(jnp.asarray(c27).reshape((27, 1, 1, 1)),
                               (27,) + tuple(sz)) for _, sz in A0.boxes),
        offs, grid, A0.boxes)
    matvec_row("matvec27_257", A27, x)

    d0 = st3.hier.levels[0].d
    b = field(grid, 3)

    def jac_res(h, bb, carry):
        xx, rr = carry
        xx = xx + d0 * rr
        return xx, bb - h.matvec(xx)

    t = _chain_timer(jac_res, A0, b, (x, b), ks=ks)
    out["jacobi_residual_257"] = {"ms": t, "bytes": 24 * npts,
                                  "copy_share": share(24 * npts, t)}
    print(f"jacobi+residual 257^3: {t:.4f} ms, "
          f"{out['jacobi_residual_257']['copy_share']:.3f} of copy",
          flush=True)

    def dense_levels(gh):
        levels = []
        for lvl in gh.levels:
            P1 = lvl.P1
            if P1 is not None:
                P1 = tuple(None if n is None else jnp.asarray(
                    fw_interp_1d(n)[0].toarray(), dtype=jnp.float32)
                    for n in P1.fine)
            levels.append(GridLevel(lvl.A, lvl.d, P1, lvl.lam))
        return GridHierarchy(tuple(levels), gh.coarse)

    def transfers(tag, cfg, st):
        gh = st.hier
        ghd = dense_levels(gh)
        g0 = gh.levels[0].A.grid
        xf = field(g0, 4)
        row = {}
        for form, h in (("strided", gh), ("matmul", ghd)):
            P1 = h.levels[0].P1
            row[f"rp_{form}_ms"] = _chain_timer(
                lambda hh, bb, v: grid_prolong(grid_restrict(v, hh), hh),
                P1, xf, xf, ks=ks)
            row[f"vcycle_{form}_ms"] = _chain_timer(
                lambda hh, bb, v: grid_cycle(cfg, hh, bb, v), h, xf,
                jnp.zeros_like(xf), ks=(2, 22))
        out[f"transfers_{tag}"] = row
        print(f"transfers {tag}: {json.dumps(row)}", flush=True)

    transfers("257^3", cfg3, st3)
    del st3, A27
    cfg2, st2 = state(4096, 2, 7)
    transfers("4097^2", cfg2, st2)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "measure_kernels.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
