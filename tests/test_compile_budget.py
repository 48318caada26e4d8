"""Compile-size regression guards for the hot whole-volume programs.

XLA compile time scales with lowered op count, and two silent regressions
this round cost 30+ s of per-process compile each (a Python-unrolled
39-step erosion chain, an unbounded flood-doubling tree). Wall-clock
compile time is machine-dependent, but the stablehlo op count of a lowered
program is deterministic — pin it with ~35% headroom so an accidental
unroll/doubling blowup fails CI instead of landing on the device's critical
path. Lowering from ShapeDtypeStructs allocates nothing and takes seconds.
"""

import jax
import jax.numpy as jnp
import pytest


def _ops(lowered) -> int:
    txt = lowered.as_text()
    return sum(1 for line in txt.splitlines()
               if "=" in line and "stablehlo" in line)


def test_3d_tile_and_seed_programs_stay_small():
    from hiprfish_tpu.pipeline import segment3d as s3

    x, y, z = 2020, 2020, 170
    tile_x, margin, tile_cap = 360, 64, 8192
    n_tiles = -(-x // tile_x)
    padded_x = n_tiles * tile_x + 2 * margin
    statics = (64, 256, 512, tile_cap, 0)
    f32s = jax.ShapeDtypeStruct((), jnp.float32)
    # f32 to match what warmup_pipeline lowers and the runtime actually
    # passes (lp_cv_enhance_3d_chunked emits f32 on every backend); every
    # full buffer is in the canonical (x, Z, Y) layout
    enh = jax.ShapeDtypeStruct((padded_x, z, y), jnp.float32)
    bkg = jax.ShapeDtypeStruct((padded_x, z, y), jnp.bool_)
    seeds = jax.ShapeDtypeStruct((padded_x, z, y), jnp.bool_)
    start = jax.ShapeDtypeStruct((), jnp.int32)

    tile = s3._segment_tile_at_seeded.lower(
        enh, bkg, seeds, f32s, start, statics, (tile_x, margin))
    assert _ops(tile) < 1800, _ops(tile)          # 1334 @ 2026-08-18 (f32)

    gs = s3._global_seeds.lower(
        jax.ShapeDtypeStruct((x, z, y), jnp.float32), f32s)
    # 1152 @ 2026-08-18: the coarse-pool reshape became c strided slices
    # per axis and the upsample an axis-gather — more (cheap) ops, but it
    # removed a 22.8 GB tile-padded bool intermediate that OOM'd at
    # compile on the 16 GB chip (see labeling._block_pool).
    assert _ops(gs) < 1550, _ops(gs)


@pytest.mark.slow
def test_10bit_engine_program_stays_small():
    from hiprfish_tpu.config import SegmentationConfig
    from hiprfish_tpu.pipeline import fused_ecoli

    stack_specs = tuple(jax.ShapeDtypeStruct((2000, 2000, c), jnp.float32)
                        for c in (32, 23, 20, 14, 6))
    eng = fused_ecoli.segment_ecoli_device.lower(
        stack_specs, SegmentationConfig(), 4096)
    assert _ops(eng) < 4400, _ops(eng)            # 3283 @ 2026-08-18
