"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR, else one fixed path."""

import json
import os
import subprocess
import sys

from tabmat_tpu import _config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# compile one program with caching forced on, then report where JAX put it
PROBE = """
import json, os, jax
import tabmat_tpu
from tabmat_tpu import _config
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.jit(lambda x: x * 3.0 + 1.0)(jax.numpy.arange(7.0)).block_until_ready()
print(json.dumps({"dir": jax.config.jax_compilation_cache_dir,
                  "default": _config.default_compilation_cache_dir()}))
"""


def _probe(env_updates):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_updates, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", PROBE], capture_output=True, text=True, timeout=300,
        env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_env_dir_is_used_and_only_it(tmp_path):
    cache = tmp_path / "jaxcache"
    got = _probe({"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert got["dir"] == str(cache)
    assert any(cache.iterdir()), "the compiled program was not cached there"


def test_unset_env_uses_fixed_in_checkout_path():
    got = _probe({})
    assert got["dir"] == got["default"] == os.path.join(REPO, ".jax_cache")
    assert os.path.isdir(got["dir"])


def test_default_path_is_stable_across_processes():
    first, second = _probe({}), _probe({})
    assert first["dir"] == second["dir"]
    assert str(os.getpid()) not in first["dir"]


def test_default_path_sits_beside_the_package():
    path = _config.default_compilation_cache_dir()
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(_config.__file__)))
    assert path == os.path.join(pkg_parent, ".jax_cache")


def test_cache_dir_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_opt_out_sets_no_cache_dir(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(TABMAT_TPU_NO_COMPILATION_CACHE="1", JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, tabmat_tpu; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "None"
