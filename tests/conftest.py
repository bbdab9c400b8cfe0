"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators by forcing the
host platform to expose 8 devices (SURVEY.md §4).  Must run before jax
initializes, hence the env mutation at module import.  Tests that need a
GPU carry the `gpu` marker and take the `gpu_device` fixture, which skips
them here; the fixture, not import time, decides whether a GPU exists.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

from pathlib import Path

import numpy as np
import pytest

DATA = Path(__file__).parent / "data"
GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def mouse_prefix() -> str:
    return str(DATA / "plink")


@pytest.fixture(scope="session")
def mouse_pheno() -> str:
    return str(DATA / "pheno")


@pytest.fixture(scope="session")
def mouse_geno(mouse_prefix):
    from gmat_tpu.io.bed import read_plink

    return read_plink(mouse_prefix)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none (as on the
    CPU-only test runner, where `JAX_PLATFORMS=cpu`)."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU; run on the card with "
                    "`python -m pytest -m gpu` without JAX_PLATFORMS=cpu")
    return devices[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(2026)
