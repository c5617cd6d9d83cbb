"""Test harness: force JAX onto a virtual 8-device CPU mesh.

XLA_FLAGS is extended before backend init and the platform is pinned via
jax.config, so the suite runs on the CPU even where a GPU is visible.
Multi-chip sharding tests run against these 8 virtual CPU devices. Kernels
run in Pallas interpret mode here; tests marked ``gpu`` need a real card
and skip (through the ``gpu`` fixture below) everywhere else — run them on
the GPU machine with ``RAYTRACER_TEST_GPU=1 python -m pytest -m gpu``.
"""

import os

# RAYTRACER_TEST_GPU=1 leaves the platform to JAX (the GPU machine's run of
# the ``gpu`` tests); every other run is pinned to the virtual CPU mesh.
ON_GPU_RUN = os.environ.get("RAYTRACER_TEST_GPU") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if not ON_GPU_RUN and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU_RUN:
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu_mesh():
    if not ON_GPU_RUN:
        assert jax.default_backend() == "cpu"
        assert len(jax.devices()) == 8


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, at run time, never at
    import: every xdist worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run with RAYTRACER_TEST_GPU=1 "
                    "on the GPU machine")


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_live_programs():
    """XLA:CPU segfaults nondeterministically once a few hundred live
    jitted programs accumulate in one process (crash frames wander
    between compile/serialize/cache-read; both suite halves pass in
    isolation). Clearing jax's program caches at every module boundary
    keeps the live-program count bounded; modules compile their own
    programs anyway, so the extra recompile cost is marginal."""
    jax.clear_caches()
    yield


@pytest.fixture(autouse=True)
def _reset_persistent_compilation_cache():
    """The CLI enables the persistent XLA compilation cache via
    jax.config in-process (cli.py --jax-cache); without a reset it stays
    enabled for every later test, pointing at a per-test tmp dir that
    pytest may have deleted — cache writes to a vanished dir segfault in
    the serializer. Restore the no-cache default after each test."""
    yield
    if jax.config.jax_compilation_cache_dir is not None:
        jax.config.update("jax_compilation_cache_dir", None)
        # the config alone is not enough: jax memoizes the cache OBJECT on
        # first use, so later compiles keep writing to the (by then
        # pytest-GC'd) tmp dir — executable serialization into a vanished
        # dir is what segfaulted the suite
        from jax._src import compilation_cache as _cc
        if hasattr(_cc, "reset_cache"):
            _cc.reset_cache()
