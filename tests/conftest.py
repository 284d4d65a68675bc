"""Test configuration.

Tests run on the CPU (``JAX_PLATFORMS=cpu`` unless set otherwise) with
8 virtual devices, so the sharding tests have a mesh to run on.  Tests
that need a GPU carry the ``gpu`` marker and skip elsewhere; run them on
a GPU machine with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_chip_smoke.py``.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

jax.config.update("jax_enable_x64", False)


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_gpu(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/test_chip_smoke.py")


def _build_native_lib():
    """Build the optional C++ preprocessing library if a toolchain exists
    (the .so is not committed; tests that need it skip when absent)."""
    import shutil
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lib = os.path.join(root, "native", "libgnn_native.so")
    if os.path.exists(lib) or shutil.which("make") is None \
            or shutil.which("g++") is None:
        return
    subprocess.run(["make", "-C", os.path.join(root, "native")],
                   check=False, capture_output=True)


_build_native_lib()
