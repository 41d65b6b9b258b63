"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding is validated on host CPU devices per SURVEY.md §4;
the GPU runs are `chip_smoke.py` and `bench.py`. The CPU backend is forced
through the config API, so the test workers never open an accelerator.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
# NOTE: jax_disable_most_optimizations was tried for compile speed and
# REVERTED — it cut frame compiles 33% but inflated execution-heavy
# tests (SDF collision steps: 21 -> 111 s) for a net loss.

assert jax.default_backend() == "cpu", jax.default_backend()

# Persistent XLA compile cache for the suite: identical frame graphs
# (rebuilt closures with the same shapes/config) compile ONCE per cache
# lifetime instead of once per test — within a run and across runs. The
# cache dir is gitignored; a cold CI run still dedupes within the run.
# The cache dir is FINGERPRINTED by the host's CPU feature set: XLA:CPU
# caches AOT artifacts compiled for the build machine's features, and
# loading them on a host with a different feature set can SIGILL (the
# loader only warns) — observed as a hard interpreter crash when this
# repo's cache moved across machine generations.
def _cpu_fingerprint() -> str:
    import hashlib

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.md5(line.encode()).hexdigest()[:10]
    except OSError:
        pass
    import platform

    return platform.machine()


# JAX_COMPILATION_CACHE_DIR, when set, wins (JAX reads it itself).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(__file__),
                     f".jax_cache_cpu_{_cpu_fingerprint()}"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
# Cache even small-speedup entries: compile time dominates this suite.
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
