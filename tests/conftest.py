"""Test configuration: JAX on a virtual 8-device CPU mesh by default.

Must set the environment before jax is imported anywhere. An explicit
JAX_PLATFORMS wins, so the card tests (tests/test_chip.py, marker ``gpu``)
can run on a GPU.
"""

import importlib.util
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
# parity tests compare float32 matmuls with NumPy references, so a float32
# dot must not run at reduced precision (TF32 on NVIDIA cards)
os.environ["JAX_DEFAULT_MATMUL_PRECISION"] = "highest"

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_default_matmul_precision", "highest")

import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = pathlib.Path("/root/reference")
EXAMPLE01 = REFERENCE / "examples" / "01test_MLP3_compare_multithread_cuda_decode_phn"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX finds none")


@pytest.fixture(scope="session")
def example01():
    if not EXAMPLE01.exists():
        pytest.skip("reference example 01 not available")
    return EXAMPLE01


@pytest.fixture(scope="session")
def chip_smoke():
    """The repo-root chip_smoke.py script, imported as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
