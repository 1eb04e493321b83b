"""Test environment: CPU backend with 8 virtual devices (multi-device sharding
tests run on a virtual mesh, SURVEY §5.8), float64 enabled (the reference is
f64; f64 oracles validate the f32 production path).

The platform is forced through ``jax.config`` (not only the environment), so
the suite runs on the CPU even where an accelerator is present.

Two test tiers: heavy end-to-end / property / multi-device tests are marked
``@pytest.mark.slow`` and SKIPPED by default so the edit loop stays in
minutes; run the FULL suite with ``pytest tests/ --slow`` or ``LJMD_SLOW=1``.
"""

import os
import tempfile

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compile cache for the whole session (same policy the CLI sets):
# parity tests re-jit IDENTICAL engine programs (fresh jax.jit objects get no
# in-memory cache hit), so the disk cache deduplicates compiles ACROSS tests.
# A JAX_COMPILATION_CACHE_DIR set by the caller is kept; otherwise a
# per-session temporary directory keeps the suite (and the CLI tests, which
# then set no directory of their own) hermetic.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp(
        prefix="ljmd_test_xla_cache_"
    )

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_compilation_cache_dir", os.environ["JAX_COMPILATION_CACHE_DIR"])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def pytest_addoption(parser):
    parser.addoption(
        "--slow", action="store_true", default=False,
        help="also run tests marked slow (full-suite tier)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy e2e/property/multichip test (opt in with --slow)"
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--slow") or os.environ.get("LJMD_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow tier: pass --slow (or LJMD_SLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
