"""Shared test fixtures: tiny model configs (cached params so the three
per-arch smoke tests don't re-init), seeded PRNG keys, a deterministic
4-channel fake hash model for engine/allocator tests, and the ``slow``
marker registration."""
import functools

import jax
import numpy as np
import pytest

from repro.configs import smoke_config
from repro.models import transformer as tf


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips on a host without CUDA")


# ---------------------------------------------------------------------------
# small-model fixtures
# ---------------------------------------------------------------------------

@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.key(0)


@pytest.fixture
def tiny_cfg():
    """1-layer float32 stablelm: the standard tiny serving-test model."""
    return smoke_config("stablelm-1.6b").replace(num_layers=1,
                                                 activation_dtype="float32")


@functools.lru_cache(maxsize=None)
def _cached_params(name: str, seed: int):
    cfg = smoke_config(name)
    return cfg, tf.init_params(jax.random.key(seed), cfg)


@pytest.fixture(scope="session")
def smoke_model():
    """Factory: (cfg, params) for a smoke config, cached across tests so the
    per-arch forward/grad/decode tests share one init."""
    return _cached_params


# ---------------------------------------------------------------------------
# coloring
# ---------------------------------------------------------------------------

class FakeHashModel:
    """Deterministic 4-channel page-interleaved hash — no reverse-engineering
    machinery, so engine/allocator tests stay fast and exact."""
    num_channels = 4
    granularity = 1024

    def channel_of(self, addrs):
        return (np.asarray(addrs, np.int64) // self.granularity) % \
            self.num_channels


@pytest.fixture
def fake_hash_model():
    return FakeHashModel()
