"""Process-level settings of the package and the chip smoke script.

Each case starts a fresh interpreter, because the settings under test are
made once, when `dcora_tpu` is first imported.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _python(code: str, env_update: dict, cwd: str = REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k, v in env_update.items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_matmul_precision_highest_without_x64():
    """f32 matmuls stay at full precision (no TF32) with f64 disabled."""
    out = _python(
        "import json, jax, dcora_tpu; print(json.dumps(["
        "jax.config.jax_default_matmul_precision, "
        "jax.config.jax_enable_x64]))",
        {"DCORA_TPU_X64": "0"})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == ["highest", False]


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(from_env, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins; otherwise <checkout>/.jax_cache."""
    want = str(tmp_path / "cache") if from_env else \
        os.path.join(REPO, ".jax_cache")
    out = _python(
        "import jax, dcora_tpu; print(jax.config.jax_compilation_cache_dir)",
        {"JAX_COMPILATION_CACHE_DIR": want if from_env else None,
         "DCORA_JAX_CACHE": None})
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == want


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    """No CPU fallback: on a CPU-only machine, or copied out of the repo,
    chip_smoke.py exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
