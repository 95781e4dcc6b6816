"""Test configuration: CPU backend with a virtual 8-device mesh, f64.

The suite runs on the CPU even where a GPU is present (the chip path is
exercised by chip_smoke.py), so the platform is pinned before any
computation runs.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

@pytest.fixture(scope="session")
def data_dir():
    """Generated test datasets (dcora_tpu.datasets), so the suite runs
    self-contained."""
    from dcora_tpu.datasets import DATA_CACHE, ensure_test_datasets

    return ensure_test_datasets(DATA_CACHE)


@pytest.fixture()
def require_dataset(data_dir):
    """Skip the test when a dataset file has no generator."""

    def _check(name: str) -> str:
        p = os.path.join(data_dir, name)
        if not os.path.exists(p):
            pytest.skip(f"dataset {name} not available")
        return p

    return _check
