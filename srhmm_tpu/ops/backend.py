"""The one place that picks an implementation per platform.

Every job has an XLA implementation that runs on any backend.  On a GPU a
job may instead run a kept Pallas kernel (Triton route); on the CPU it
always runs XLA.  Nothing here falls back silently: a kernel forced where
it cannot run raises, and the Pallas interpreter runs only when a caller
(a test) asks for it explicitly.

Also here: the matmul precision policy and the persistent compile cache.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# float32 GEMMs on the emission, moment, scoring and decode paths.  On a
# GPU an f32 product may otherwise run in TF32 (~3 decimal digits): the
# lifted-feature emission [x, x^2] @ W cancels catastrophically at reduced
# precision (PERF.md, "Numerics").
PRECISION = jax.lax.Precision.HIGHEST

XLA = "xla"
TRITON = "triton"

# the checkout root: srhmm_tpu/ops/backend.py -> parents[2]
_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def platform() -> str:
    """Platform of the device computations land on: the default device's
    (jax.default_device) when one is set, else the default backend's."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def _single_device(arrays) -> bool:
    """False for concrete arrays laid out over several devices (a GSPMD
    caller: a pallas_call cannot be partitioned, so such inputs take the
    XLA path).  Tracers carry no placement and count as local — inside
    shard_map they are."""
    for a in arrays:
        try:
            if len(a.sharding.device_set) > 1:
                return False
        except AttributeError:
            pass
    return True


def lattice_impl(*arrays) -> str:
    """Implementation of the isolated-word forward/backward lattices:
    the Triton kernel on a GPU for single-device inputs, XLA otherwise."""
    if platform() == "gpu" and _single_device(arrays):
        return TRITON
    return XLA


def check_kernel_runnable(interpret: bool) -> None:
    """Raise unless a Pallas Triton kernel can run as asked: compiled only
    on a GPU, interpreted only off it (tests pass interpret=True on CPU)."""
    on_gpu = platform() == "gpu"
    if interpret and on_gpu:
        raise RuntimeError(
            "Pallas interpret mode requested on a GPU; the kernel would run "
            "in the interpreter instead of compiled"
        )
    if not interpret and not on_gpu:
        raise RuntimeError(
            f"the Triton kernel needs a GPU (platform is {platform()!r}); "
            "use the XLA path, or interpret=True in tests"
        )


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory:
    $JAX_COMPILATION_CACHE_DIR where set, else <checkout>/.jax_cache — a
    fixed path, since the path is part of the cache key."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
