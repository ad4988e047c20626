"""Process-level contracts: the compile-cache location and chip_smoke.py's
refusal to run without a GPU.  Each case runs a fresh interpreter."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_update, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_update, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=240, env=env, cwd=ROOT)


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set over it; without
    it the cache sits at one fixed, git-ignored path in the checkout."""
    code = ("import jax, mgtpu, mgtpu.config as c; "
            "print(jax.config.jax_compilation_cache_dir); "
            "print(c.COMPILE_CACHE_DIR)")
    if env_dir:
        r = _run(["-c", code], {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    else:
        r = _run(["-c", code], {}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr[-800:]
    used, default = r.stdout.split("\n")[:2]
    if env_dir:
        assert used == str(tmp_path)
    else:
        assert used == default == os.path.join(ROOT, ".xla_cache")
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".xla_cache/" in f.read().split()


@pytest.mark.parametrize("args", [[], ["--multi"]])
def test_chip_smoke_refuses_cpu(args):
    r = _run([os.path.join(ROOT, "chip_smoke.py")] + args, {})
    assert r.returncode != 0
    assert "gpu" in r.stderr.lower()
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
