"""Test harness config: CPU backend with 8 virtual devices.

Tests run on CPU so float64 eigendecompositions are exact and a virtual
8-device mesh exercises the multi-device sharding paths without the
hardware (SURVEY.md §4).  Must run before jax initializes its backends.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")  # wins over an exported JAX_PLATFORMS
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)
