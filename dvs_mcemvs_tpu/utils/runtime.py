"""Process-level runtime choices: which platform JAX computes on, and where
compiled programs are cached.

`on_accelerator` is the one test of "is this process on a GPU?" — the CLI's
device count, the benchmark and the chip smoke test all ask it, so no two
callers can disagree about what the platform means.
"""

from __future__ import annotations

import os
from typing import Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Platform names JAX reports for an NVIDIA GPU (`jax.default_backend()` says
# "gpu"; `Device.platform` and `--platform` may say "cuda").
GPU_PLATFORMS = ("gpu", "cuda")
CPU_PLATFORMS = ("cpu",)


def on_accelerator(platform: Optional[str] = None) -> bool:
    """True when `platform` (default: JAX's default backend) is a GPU,
    False for the CPU.  Any other platform is an error: no code path of
    this program was built or checked for it."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    platform = platform.lower()
    if platform in GPU_PLATFORMS:
        return True
    if platform in CPU_PLATFORMS:
        return False
    raise ValueError(f"unsupported JAX platform {platform!r}; expected one of "
                     f"{CPU_PLATFORMS + GPU_PLATFORMS}")


def compile_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<checkout>/.jax_cache`.

    The path is fixed (never a temp name, pid or time): it is part of what
    a later run must find again for the cache to hit."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return env if env else os.path.join(_REPO, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`
    and return that directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
