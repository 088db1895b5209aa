"""Platform predicate, compile-cache placement, and chip_smoke.py off the card."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from kaptive_tpu.platform import default_platform, on_gpu, platform_of

REPO = Path(__file__).resolve().parent.parent


def test_platform_of_known_devices():
    assert platform_of(jax.devices("cpu")[0]) == "cpu"
    assert platform_of("gpu") == "gpu"
    assert default_platform() == "cpu" and on_gpu() is False


def test_unknown_platform_raises():
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        platform_of("rocm")


def _run(code: str, env_extra: dict, cwd=REPO, script=None):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO), **env_extra})
    args = [sys.executable, script] if script else [sys.executable, "-c", code]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_location(tmp_path, from_env):
    cache = tmp_path / "jax_cache"
    code = (
        "import jax, jax.numpy as jnp, kaptive_tpu\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()\n"
    )
    r = _run(code if from_env else code.split("jax.config.update")[0],
             {"JAX_COMPILATION_CACHE_DIR": str(cache)} if from_env else {})
    assert r.returncode == 0, r.stderr
    where = r.stdout.strip().splitlines()[0]
    if from_env:
        assert where == str(cache)
        assert any(cache.iterdir()), "no compile-cache entry under JAX_COMPILATION_CACHE_DIR"
    else:
        assert where == str(REPO / ".jax_cache")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """Under JAX_PLATFORMS=cpu, or copied away from the repo, it must exit
    non-zero and never print an ok result."""
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    r = _run("", {"PYTHONPATH": ""}, cwd=script.parent, script=str(script))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
