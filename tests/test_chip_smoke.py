"""chip_smoke.py refuses to run without a GPU, and the compile cache goes
where JAX_COMPILATION_CACHE_DIR says or else to <repo>/.jax_cache."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        # the script by itself, without the rest of the repository
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, env=_env(), cwd=os.path.dirname(script),
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("first", ["jax", "corticall_tpu"])
def test_compile_cache_defaults_to_repo(first):
    second = "corticall_tpu" if first == "jax" else "jax"
    code = (f"import {first}, {second}, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_honours_env(tmp_path):
    code = ("import corticall_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=300,
                       env=_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(tmp_path)
