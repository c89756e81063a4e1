"""Persistent compilation cache rules (utils/compcache.py).

Each rule is checked in a fresh interpreter: JAX initializes its cache once
per process, so only a new process shows where compiled programs land.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from nbody_tpu.utils import compcache

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import os, sys
from pathlib import Path
import jax
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
from nbody_tpu.utils import compcache
if len(sys.argv) > 1:
    compcache.REPO_CACHE_DIR = Path(sys.argv[1])
print("DIR", compcache.enable_compilation_cache())
import jax.numpy as jnp
jax.jit(lambda x: x * 3.0 + 1.0)(jnp.ones(8)).block_until_ready()
"""


def _probe(tmp_path, env_dir=None, repo_dir=None):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    args = [sys.executable, "-c", _PROBE]
    if repo_dir is not None:
        args.append(str(repo_dir))
    out = subprocess.run(args, env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split("DIR ", 1)[1].split()[0]


def test_env_dir_is_used_and_no_other_is_set(tmp_path):
    env_dir = tmp_path / "from_env"
    repo_dir = tmp_path / "repo_cache"
    used = _probe(tmp_path, env_dir=env_dir, repo_dir=repo_dir)
    assert used == str(env_dir)
    assert any(env_dir.iterdir()), "no compiled program landed in the env dir"
    assert not repo_dir.exists()


def test_default_is_fixed_in_checkout_path(tmp_path):
    repo_dir = tmp_path / "repo_cache"
    used = _probe(tmp_path, repo_dir=repo_dir)
    assert used == str(repo_dir)
    assert any(repo_dir.iterdir()), "no compiled program landed in the cache"


def test_fixed_path_is_inside_the_checkout_and_ignored():
    assert compcache.REPO_CACHE_DIR == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize("env", ["NBODY_COMPCACHE", "HOME", "XDG_CACHE_HOME"])
def test_cache_dir_ignores_other_environment(monkeypatch, tmp_path, env):
    """Only JAX_COMPILATION_CACHE_DIR moves the cache: the old directory
    override and the home-directory default are gone."""
    import jax
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv(env, str(tmp_path / "elsewhere"))
    try:
        assert compcache.enable_compilation_cache() == str(
            compcache.REPO_CACHE_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert not (tmp_path / "elsewhere").exists()
