"""Platform policy and the persistent compile cache.

``policy()`` is the one place that decides what each backend runs: every
call site that used to compare ``jax.default_backend()`` with a platform
name asks it instead. A backend missing from the table is an error, not a
default.

The engines cold-compile in tens of seconds to minutes, so every CLI
enables JAX's persistent compilation cache (``apply_compile_cache_env``):
in ``JAX_COMPILATION_CACHE_DIR`` when that is set, else in the fixed
``<checkout>/.jax_cache`` (a fixed path, because the path is part of the
cache key). ``HIPRFISH_PLATFORM=cpu[:N]`` forces the CPU backend (with N
virtual devices) through the config API, which wins if applied before first
device use.
"""

from __future__ import annotations

import os
from typing import NamedTuple

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Policy(NamedTuple):
    # segstats one-hot dots in bf16 against hi/lo-split f32 features (the
    # GPU's tensor cores accumulate in f32; the CPU backend accumulates bf16
    # dots in bf16, ~1e-3 relative error, so it takes plain f32 dots)
    bf16_dots: bool
    # 3D LP-CV stencil min/max accumulated in bf16 (selection commutes with
    # monotone rounding; halves the sweep's memory traffic; CPU bf16 is
    # emulated and slow)
    lp3d_bf16: bool
    # 2D engine behind cli.measure / cli.warmup: "fused" is the one-program
    # engine the bench times; "host" the host-composed engine, which
    # compiles much faster on the CPU
    cli_engine: str
    # NL-means: "triton" (ops/nlm_triton.py) or "xla" (ops/denoise.py)
    nlm_kernel: str


_POLICIES = {
    "cpu": Policy(bf16_dots=False, lp3d_bf16=False, cli_engine="host",
                  nlm_kernel="xla"),
    "gpu": Policy(bf16_dots=True, lp3d_bf16=True, cli_engine="fused",
                  nlm_kernel="triton"),
}


def policy(backend: str | None = None) -> Policy:
    """The platform policy of ``backend`` (default: JAX's default
    backend)."""
    if backend is None:
        import jax

        backend = jax.default_backend()
    try:
        return _POLICIES[backend]
    except KeyError:
        raise ValueError(f"no platform policy for backend {backend!r}; "
                         f"known: {sorted(_POLICIES)}") from None


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def apply_compile_cache_env() -> None:
    """Enable the persistent compile cache in ``compile_cache_dir()``."""
    cache = compile_cache_dir()
    os.makedirs(cache, exist_ok=True)
    import jax

    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def apply_platform_env() -> None:
    """Every CLI entry point calls this first: compile cache, then the
    optional ``HIPRFISH_PLATFORM`` override."""
    apply_compile_cache_env()
    spec = os.environ.get("HIPRFISH_PLATFORM")
    if not spec:
        return
    import jax

    parts = spec.split(":")
    try:
        jax.config.update("jax_platforms", parts[0])
        if len(parts) > 1 and parts[0] == "cpu":
            jax.config.update("jax_num_cpu_devices", int(parts[1]))
    except RuntimeError:
        # Backends already initialized — leave the platform as-is.
        pass
