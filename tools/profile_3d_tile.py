"""Per-op timing of one margin-tiled 3D segmentation slab on the current
device — targets the 3D sweep's per-tile cost (the dominant term of the
full-scale volume benchmark).

Usage: python tools/profile_3d_tile.py [--tile-x 128] [--margin 64]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from hiprfish_tpu.utils.platform import apply_platform_env

apply_platform_env()

from _timing import device_time_ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tile-x", type=int, default=128)
    ap.add_argument("--margin", type=int, default=64)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from hiprfish_tpu.config import SegmentationConfig
    from hiprfish_tpu.ops import labeling as lab
    from hiprfish_tpu.ops import morphology as morph
    from hiprfish_tpu.ops import segstats
    from hiprfish_tpu.ops import watershed as ws
    from hiprfish_tpu.pipeline import segment3d
    from hiprfish_tpu.utils import synthetic3d as s3

    cfg = SegmentationConfig()
    slab_x = args.tile_x + 2 * args.margin
    spec = s3.VolumeSpec(shape=(slab_x, 2020, 170), seed=5,
                         spacing=(36, 36, 52))
    vol = s3.build_sum_volume(spec, 127, np.ones(127, np.float32) * 63.0,
                              seed=1, z_chunk=16)
    vol_norm = vol / jnp.maximum(jnp.max(vol), 1e-12)
    del vol
    enh = segment3d.lp_cv_enhance_3d_chunked(vol_norm, cfg, 128)
    enh = enh.astype(jnp.float32)
    thr_fg = segment3d._cluster_threshold(enh, 2, cfg.kmeans_iters)
    thr_int = segment3d._cluster_threshold(enh, 3, cfg.kmeans_iters)
    bkg = jnp.log10(vol_norm + 1e-8) >= segment3d._cluster_threshold(
        jnp.log10(vol_norm + 1e-8), 2, cfg.kmeans_iters)
    del vol_norm
    print(f"# slab ({slab_x}, 2020, 170) on {jax.devices()[0].device_kind}",
          file=sys.stderr)

    stages = {}

    def timeit(name, fn, *xs, reps=3):
        stages[name], out = device_time_ms(fn, *xs, n=3, reps=reps, warmup=1)
        return out

    pos_fg = jax.jit(lambda e: (e >= thr_fg) & (e > 0))
    fg = timeit("masks(fg)", pos_fg, enh)
    interior0 = (enh >= thr_int) & (enh > 0)
    interior1 = timeit("opening", jax.jit(morph.binary_opening), interior0)
    rso = jax.jit(lambda m: segstats.remove_small_objects_fast(
        m, cfg.lp_seed_min_size, 3, num_segments=8192,
        max_iters=cfg.ccl_max_iters, exact_fallback=False))
    interior = timeit("rso_fast(label+rank+stats)", rso, interior1)
    fh = jax.jit(lambda m: morph.binary_fill_holes(m, 1))
    sm1 = timeit("fill_holes(interior)", fh, interior)
    sm2 = timeit("fill_holes(fg)", fh, fg)
    seeds_mask = sm1 & sm2
    lb = jax.jit(lambda m: lab.label(m, 3, cfg.ccl_max_iters))
    lbl = timeit("label(seeds)", lb, seeds_mask & bkg)
    rk = jax.jit(lambda l: segstats.rank_labels(l, 3, cfg.ccl_max_iters))
    markers, _n = timeit("rank_labels", rk, lbl)
    markers = jnp.minimum(markers, 8191)
    wsf = jax.jit(lambda e, b, m, s, f: ws.watershed(
        -(e * b), m, s | (f & b), 1, cfg.watershed_max_iters))
    seg = timeit("watershed", wsf, enh, bkg, markers, seeds_mask, fg)
    st = jax.jit(lambda o: segstats.label_stats(o, None, 8192).counts > 0)
    timeit("present(label_stats)", st, seg[args.margin:args.margin
                                           + args.tile_x])

    # _segment_one_tile expects the canonical (sx, Z, Y) layout
    enh_xzy = jnp.transpose(enh, (0, 2, 1))
    bkg_xzy = jnp.transpose(bkg, (0, 2, 1))
    one = lambda: segment3d._segment_one_tile(
        enh_xzy, bkg_xzy, (thr_fg, thr_int),
        (cfg.lp_seed_min_size, cfg.ccl_max_iters, cfg.watershed_max_iters,
         8192), (args.tile_x, args.margin))
    timeit("TOTAL one_tile", one)

    width = max(len(k) for k in stages)
    for k, v in stages.items():
        print(f"{k:<{width}}  {v:8.1f} ms")


if __name__ == "__main__":
    main()
