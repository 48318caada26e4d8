"""Pre-seed the persistent XLA compile cache for the flagship engines.

First contact with a fresh machine pays the full XLA compile of the
engines — the reference's per-rule Snakemake fan-out
(ecoli/Snakefile:78-82) would pay it in the first rule's process. Running

    python -m hiprfish_tpu.cli.warmup --family ecoli multispecies --size 2000

once per machine (e.g. at environment setup, or as the workflow driver's
first step) compiles every program those CLI paths dispatch into the
persistent compile cache the CLIs use (utils.platform) — so the first
real FOV process finds every executable there.

Compile-cache keys are exact program keys: warm up with the --size /
--max_cells your production FOVs will use (multiple sizes may be given).
Where the engine is one jitted program (the ecoli fused engine, the
per-cell measurement) warmup AOT-lowers from ShapeDtypeStructs — no fixture
is ever materialized; host-composed paths (the multispecies LP-CV engine)
run once on a zeros stack instead, which populates the same cache.
"""

from __future__ import annotations

import argparse
import sys
import time


def warmup_ecoli(size: int, max_cells: int) -> None:
    """AOT-compile the fused ecoli engine and the per-cell measurement
    cli.measure runs at this size."""
    import jax
    import jax.numpy as jnp

    from hiprfish_tpu.config import TEN_BIT, SegmentationConfig
    from hiprfish_tpu.pipeline import fused_ecoli, measure
    from hiprfish_tpu.utils.platform import policy

    layout = TEN_BIT
    cfg = SegmentationConfig()
    bounds = layout.block_bounds
    specs = tuple(
        jax.ShapeDtypeStruct((size, size, bounds[i + 1] - bounds[i]),
                             jnp.float32)
        for i in range(layout.n_lasers))
    t0 = time.time()
    fused_ecoli.segment_ecoli_device.lower(specs, cfg, max_cells).compile()
    print(f"# ecoli fused engine {size}^2 x{max_cells}: "
          f"{time.time()-t0:.1f}s", file=sys.stderr)
    t0 = time.time()
    # cli.measure feeds measure_device the engine's registered cube: the
    # fused engine stores it in cfg.registered_dtype, the host-composed one
    # keeps f32 — the spec must match the engine the platform policy gives
    # the CLI, or the first real FOV pays a fresh compile
    reg_dt = (jnp.dtype(cfg.registered_dtype)
              if policy().cli_engine == "fused" else jnp.float32)
    measure.measure_device.lower(
        jax.ShapeDtypeStruct((size, size), jnp.int32),
        jax.ShapeDtypeStruct((size, size, layout.n_channels), reg_dt),
        max_cells).compile()
    print(f"# measure_device {size}^2 x{layout.n_channels}ch: "
          f"{time.time()-t0:.1f}s", file=sys.stderr)


def warmup_multispecies(size: int, max_cells: int) -> None:
    """The 7-bit LP-CV path is host-composed of many jitted ops; running it
    once on zeros compiles each one into the persistent cache (the data is
    irrelevant to the cache key; the one execution costs little device
    time)."""
    import numpy as np
    import jax

    from hiprfish_tpu.config import SEVEN_BIT, SegmentationConfig
    from hiprfish_tpu.pipeline import measure, segment2d

    layout = SEVEN_BIT
    bounds = layout.block_bounds
    stack = tuple(
        np.zeros((size, size, bounds[i + 1] - bounds[i]), np.float32)
        for i in range(layout.n_lasers))
    t0 = time.time()
    res = segment2d.segment_lpcv(stack, None, SegmentationConfig(),
                                 max_cells, "multispecies")
    jax.block_until_ready(res.segmentation)
    measure.measure_fov(res.segmentation, res.registered, 0, max_cells)
    print(f"# multispecies LP-CV path {size}^2: {time.time()-t0:.1f}s",
          file=sys.stderr)


def warmup_3d(shape, max_cells: int) -> None:
    from hiprfish_tpu.config import SegmentationConfig
    from hiprfish_tpu.pipeline import segment3d

    t0 = time.time()
    segment3d.warmup_pipeline(tuple(shape), SegmentationConfig(),
                              max_cells=max_cells)
    print(f"# 3D pipeline {shape}: {time.time()-t0:.1f}s", file=sys.stderr)


def main(argv=None):
    from hiprfish_tpu.utils.platform import apply_platform_env

    apply_platform_env()
    p = argparse.ArgumentParser(
        "Pre-seed the persistent compile cache for the flagship engines")
    p.add_argument("--family", nargs="*",
                   default=["ecoli", "multispecies"],
                   choices=["ecoli", "multispecies", "3d"])
    p.add_argument("--size", nargs="*", type=int, default=[2000],
                   help="2D FOV side length(s) to warm")
    p.add_argument("--shape3d", nargs=3, type=int, default=[2020, 2020, 170],
                   help="3D volume shape (X Y Z) for --family 3d")
    p.add_argument("--max_cells", type=int, default=4096,
                   help="must match the CLI's --max_cells")
    args = p.parse_args(argv)
    t0 = time.time()
    for size in args.size:
        if "ecoli" in args.family:
            warmup_ecoli(size, args.max_cells)
        if "multispecies" in args.family:
            warmup_multispecies(size, args.max_cells)
    if "3d" in args.family:
        warmup_3d(args.shape3d, args.max_cells)
    print(f"# warmup complete in {time.time()-t0:.1f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
