"""Test harness configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding logic is
exercised without accelerators (the standard JAX trick; SURVEY.md §4).
Tests that need a GPU carry the ``gpu`` marker and skip here (see the
``gpu`` fixture below).

The CPU platform is set with jax.config.update AFTER importing jax but
BEFORE any backend initialization, so it holds whatever JAX_PLATFORMS
says.  XLA_FLAGS must be in the environment before the CPU client starts
(lazy, at first device use).

Persistent compilation cache: OFF by default.  XLA:CPU serializes AOT
results that embed compile-machine CPU features (jax 0.9 has no config to
prevent it — ``jax_persistent_cache_enable_xla_caches`` only covers GPU
auxiliary caches), so a cache produced on one machine loads elsewhere with
feature-mismatch warnings and potential numeric drift.  A fresh checkout
must behave identically on every machine, so the default is a cold cache.
Set ``MSLAM_TEST_CACHE=1`` to opt in for faster local iteration; the cache
dir is then scoped by a machine fingerprint so a foreign cache can never
be loaded even if the directory is copied across machines.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# MSLAM_TEST_GPU=1 keeps JAX's own platform choice, so the `gpu` tests
# run on a card (name their files: a machine whose site-packages holds
# another `tests` package cannot import this namespace package):
#   MSLAM_TEST_GPU=1 python -m pytest -m gpu tests/test_match_pallas.py \
#       tests/test_fast_pallas.py
_ON_GPU = os.environ.get("MSLAM_TEST_GPU", "0") == "1"
if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

if os.environ.get("MSLAM_TEST_CACHE", "0") == "1":
    # Machine fingerprint: CPU feature flags + arch.  A cache produced on a
    # different machine lands in a different directory and is never loaded.
    # (Same scoping that setup_compile_cache applies for every CLI entry
    # point — utils/jaxtools.py machine_fingerprint.)
    from modular_slam_tpu.utils.jaxtools import machine_fingerprint

    _CACHE_DIR = os.path.join(
        os.path.dirname(__file__), "..", ".jax_cache",
        f"cpu-{machine_fingerprint()}"
    )
    jax.config.update("jax_compilation_cache_dir", os.path.abspath(_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_enable_xla_caches", "none")

if not _ON_GPU:
    assert jax.default_backend() == "cpu", jax.default_backend()
    assert len(jax.devices()) == 8, jax.devices()


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided here, at test
    time, never at import: every xdist worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX device is {dev.platform})")
    return dev
