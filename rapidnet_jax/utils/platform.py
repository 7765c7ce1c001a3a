"""Device platform and compile-cache decisions, in one place.

The solver has one device path: the XLA programs of ``solver/``, compiled
for the host CPU or an NVIDIA GPU.  Every entry point asks this module
which platform it runs on, and any other platform is an error rather
than a guess.
"""

from __future__ import annotations

import os
import subprocess

import jax

PLATFORMS = ("cpu", "gpu")

# One fixed directory inside the checkout: the path is part of the
# persistent cache's key, so a directory that moved would never hit.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def check_platform(name: str) -> str:
    """Return ``name`` if the solver runs on it; raise otherwise."""
    if name not in PLATFORMS:
        raise ValueError(f"unsupported platform '{name}': the solver runs "
                         f"on {' or '.join(PLATFORMS)}")
    return name


# JAX's backend name for each platform: given "gpu", JAX starts every
# GPU backend it knows (CUDA and ROCm) and fails where one is missing.
JAX_BACKENDS = {"cpu": "cpu", "gpu": "cuda"}


def use_platform(name: str) -> None:
    """Pin JAX to ``name`` ('cpu' or 'gpu') before its first use."""
    jax.config.update("jax_platforms", JAX_BACKENDS[check_platform(name)])


def device_platform(device=None) -> str:
    """Platform of ``device`` (default: JAX's first device), checked."""
    if device is None:
        device = jax.devices()[0]
    return check_platform(device.platform)


def nvidia_smi() -> str | None:
    """``name, power.limit`` of each GPU, as nvidia-smi prints them, or
    None where nvidia-smi is absent or fails.  Runs in a child process,
    so it never touches this process's JAX client."""
    try:
        cp = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return cp.stdout.strip() if cp.returncode == 0 else None


def device_summary() -> dict:
    """What every reported result names: platform, device kind and
    count, and the card's name and power limit (None off a GPU)."""
    devices = jax.devices()
    return {"platform": device_platform(devices[0]),
            "device_kind": devices[0].device_kind,
            "device_count": len(devices),
            "gpu": nvidia_smi()}


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    left to JAX.  Otherwise the cache lives at ``DEFAULT_CACHE_DIR``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
