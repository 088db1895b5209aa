"""Test configuration: a virtual 8-device CPU mesh, and the ``gpu`` fixture.

Mirrors the reference's test strategy (synthetic in-memory fixtures,
``/root/reference/tests``) and adds multi-device sharding tests on the CPU
backend per SURVEY.md §4: sharded results must equal single-device results.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``).  Tests marked ``gpu`` need
an NVIDIA GPU: they request the :func:`gpu` fixture, which skips them when
JAX finds none (decided per test, never at import, so every pytest-xdist
worker collects the same tests).  On a GPU machine run them with
``python -m pytest tests/ -m gpu``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no interpret mode)")
    return devices[0]
