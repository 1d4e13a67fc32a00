"""Test configuration: force an 8-device virtual CPU mesh for sharding tests.

Must run before the first ``import jax`` anywhere in the test session so the
host platform is split into 8 virtual devices (the multi-device dry-run
model of a GPU mesh).

The tests marked ``gpu`` need the card and skip here; they run on the GPU
with ``JEFFERSON_TESTS_ON_DEVICE=1 python -m pytest tests/ -m gpu``, which
leaves the platform JAX boots alone.
"""

import os

if os.environ.get("JEFFERSON_TESTS_ON_DEVICE") != "1":
    # Force CPU even when the ambient environment would boot an
    # accelerator: the suite runs on an 8-device virtual CPU mesh.
    # jax.config wins over an earlier JAX_PLATFORMS, so it is set too.
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from jefferson_tpu import EngineConfig, synthetic_database


@pytest.fixture(scope="session")
def config():
    return EngineConfig()

@pytest.fixture(scope="session")
def db(config):
    return synthetic_database(config)


@pytest.fixture(scope="session")
def castanets(config):
    """A deterministic test signal: noise bursts + tones, ~1.2 s mono."""
    rng = np.random.default_rng(42)
    n = 54_000
    t = np.arange(n) / config.sample_rate
    sig = 0.25 * np.sin(2 * np.pi * 440.0 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3.0 * t))
    bursts = (rng.standard_normal(n) * (rng.random(n) > 0.995)).astype(np.float64)
    sig = sig + 0.3 * np.convolve(bursts, np.exp(-np.arange(256) / 32.0), mode="same")
    return (0.5 * sig / np.max(np.abs(sig))).astype(np.float32)


@pytest.fixture
def gpu():
    """The GPU devices, or a skip: tests that only mean something on the
    card take this fixture (and the ``gpu`` marker)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JEFFERSON_TESTS_ON_DEVICE=1 -m gpu)")
    return devs
