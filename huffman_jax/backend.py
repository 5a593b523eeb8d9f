"""The one backend decision: compiled GPU kernels or the plain XLA versions.

Every device path asks `use_kernels()` instead of testing the platform
itself:

- ``gpu``: the Pallas kernels compiled through Triton;
- ``cpu`` (chosen explicitly, e.g. ``JAX_PLATFORMS=cpu``): the plain
  ``jnp``/``lax`` versions, which are also the kernels' references;
- anything else raises.  Library code never falls back to the Pallas
  interpreter; tests ask for interpret mode explicitly.

`setup_compile_cache()` points JAX's persistent compilation cache at a
fixed ``.jax_cache/`` inside the checkout unless ``JAX_COMPILATION_CACHE_DIR``
is set, in which case JAX uses that directory and nothing here overrides it.
"""

from __future__ import annotations

import os

import jax

__all__ = [
    "CACHE_DIR",
    "SUPPORTED_PLATFORMS",
    "platform",
    "setup_compile_cache",
    "use_kernels",
]

SUPPORTED_PLATFORMS = ("gpu", "cpu")

#: the checkout-local compile cache (listed in .gitignore); a fixed path,
#: because the cache key includes it and a moving directory never hits
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def platform() -> str:
    """The default backend's platform, validated."""
    name = jax.default_backend()
    if name not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: huffman_jax runs compiled "
            "kernels on 'gpu' and the plain XLA versions on 'cpu' "
            "(set JAX_PLATFORMS=cpu to choose the latter)"
        )
    return name


def use_kernels() -> bool:
    """True on the GPU (compiled Triton kernels), False on the CPU."""
    return platform() == "gpu"


def setup_compile_cache() -> str:
    """Enable the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env  # JAX reads the variable itself
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
