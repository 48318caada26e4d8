"""3D biofilm segmentation family (L2) + volumetric measurement (L3/L4).

Covers the reference's 3D paths (hiprfish_imaging_biofilm_analysis.py):
  * t-stack registration (average & per-tile, :134-236)
  * microscope-tile stitching with overlap-count blending (:1064-1101)
  * full 3D LP-CV segmentation, xy-chunked so the (X, Y, Z, 72) orientation
    tensor never materializes for the full volume (:778-861, :1105-1126)
  * per-z-slice 2D segmentation of a z-stack (:664-776, :955-1007)
  * volumetric measurement + classification + bvox export (:1359-1417)

Chunking note: the 3D LP-CV sweep holds a (72, cx, cy, Z) orientation stack
per chunk — the device equivalent of the reference's 100x100 chunk loop.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from hiprfish_tpu.config import SegmentationConfig
from hiprfish_tpu.io import outputs
from hiprfish_tpu.ops import kmeans as km
from hiprfish_tpu.ops import labeling as lab
from hiprfish_tpu.ops import line_profile as lp
from hiprfish_tpu.ops import morphology as morph
from hiprfish_tpu.ops import regionprops as rp
from hiprfish_tpu.ops import register as reg
from hiprfish_tpu.ops import watershed as ws
from hiprfish_tpu.pipeline import measure as meas
from hiprfish_tpu.pipeline import segment2d


# ---------------------------------------------------------------------------
# Registration / stitching
# ---------------------------------------------------------------------------


def register_tstack_average(volumes):
    """Average a time series of (X, Y, Z, C) volumes after registering each
    to t=0 on the channel-summed volume (biofilm_analysis.py:134-165)."""
    ref = jnp.asarray(volumes[0])
    ref_sum = jnp.sum(ref, axis=3)
    acc = ref
    for i in range(1, len(volumes)):
        vol = jnp.asarray(volumes[i])
        shift = reg.register_translation_3d(ref_sum, jnp.sum(vol, axis=3))
        shifted, _ = reg.apply_shift_3d(vol, shift)
        acc = acc + shifted
    return acc / len(volumes)


def register_volume_stack(volume_stack, log_domain: bool = True):
    """Register per-laser (X, Y, Z, C_l) volumes to laser 0 on summed
    volumes and concatenate channels (biofilm_analysis.py:424-450)."""
    sums = [jnp.sum(jnp.asarray(v), axis=3) for v in volume_stack]
    if log_domain:
        sums = [jnp.log(s + 1e-8) for s in sums]
    parts = [jnp.asarray(volume_stack[0])]
    for i in range(1, len(volume_stack)):
        shift = reg.register_translation_3d(sums[0], sums[i])
        shifted, _ = reg.apply_shift_3d(jnp.asarray(volume_stack[i]), shift)
        parts.append(shifted)
    return jnp.concatenate(parts, axis=3)


def stitch_tiles(tile_volumes, tile_masks, grid, tile_shape, overlap: int,
                 out_shape, pad: int = 10):
    """Overlap-count-blended stitching of microscope tiles into one volume
    (biofilm_analysis.py:1077-1101): chain registration along the first
    row/column, accumulate intensity and hit counts, divide."""
    gy, gx = grid
    shift_full = np.zeros((gy, gx, 3))
    for i in range(gy):
        for j in range(gx):
            if i == 0 and j == 0:
                continue
            if j == 0:
                a = tile_volumes[(i - 1) * gx][-50:]
                b = tile_volumes[i * gx][:50]
            else:
                a = tile_volumes[i * gx + j - 1][:, -50:]
                b = tile_volumes[i * gx + j][:, :50]
            shift_full[i, j] = np.asarray(
                reg.register_translation_3d(jnp.asarray(a), jnp.asarray(b)))
    full = np.zeros(out_shape, np.float32)
    count = np.zeros(out_shape, np.float32)
    ty, tx, tz = tile_shape
    step_y = ty - overlap
    step_x = tx - overlap
    for i in range(gy):
        for j in range(gx):
            sy = int(i * step_y + shift_full[: i + 1, 0, 0].sum()
                     + shift_full[i, 1: j + 1, 0].sum()) + pad
            sx = int(j * step_x + shift_full[i, : j + 1, 1].sum()) + pad
            sz = int(shift_full[i, : j + 1, 2].sum()) + pad
            vol = np.asarray(tile_volumes[i * gx + j])
            msk = np.asarray(tile_masks[i * gx + j]).astype(np.float32)
            full[sy:sy + ty, sx:sx + tx, sz:sz + tz] += vol * msk
            count[sy:sy + ty, sx:sx + tx, sz:sz + tz] += msk
    count[count == 0] = 1
    return full / count


def stitch_tiles_device(tile_volumes, grid, overlap: int, out_shape,
                        pad: int = 10, strip: int | None = None,
                        tile_masks=None):
    """Device-resident microscope-tile stitching (the device formulation of
    biofilm_analysis.py:1064-1101): chain phase-correlation registration of
    neighboring tiles on their ``strip``-deep overlap faces, then
    overlap-count-blended accumulation with dynamic_update_slice — no
    host round-trips, positions stay traced.

    Args:
      tile_volumes: list of (ty, tx, tz) arrays in row-major grid order.
      grid: (gy, gx).
      overlap: nominal overlap in pixels along y and x.
      out_shape: (Y, X, Z) of the stitched volume before padding.
      strip: registration-strip depth; must equal the content overlap for
        zero-deviation tiles to register at zero (the reference compares
        50-deep strips on 50-px overlaps, biofilm_analysis.py:1077-1087).
      tile_masks: optional per-tile validity masks (the host stitch_tiles'
        mask contract); invalid voxels contribute neither intensity nor
        count.
    Returns (Y+2*pad, X+2*pad, Z+2*pad) blended volume.
    """
    if strip is None:
        strip = overlap
    gy, gx = grid
    tiles = [jnp.asarray(t, jnp.float32) for t in tile_volumes]
    ty, tx, tz = tiles[0].shape
    if tile_masks is None:
        masks = [jnp.ones((ty, tx, tz), jnp.float32)] * len(tiles)
    else:
        masks = [jnp.asarray(m, jnp.float32) for m in tile_masks]
    return _stitch_device(tuple(tiles), tuple(masks), (gy, gx), overlap,
                          tuple(out_shape), pad, strip)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _stitch_device(tiles, masks, grid, overlap, out_shape, pad, strip):
    """Module-level jit of the stitch program (a per-call local jit made
    every stitch recompile and left nothing for warmup to AOT-lower)."""
    gy, gx = grid
    ty, tx, tz = tiles[0].shape
    shifts = {}
    for i in range(gy):
        for j in range(gx):
            if i == 0 and j == 0:
                shifts[(i, j)] = jnp.zeros((3,), jnp.int32)
            elif j == 0:
                s = reg.register_translation_3d(
                    tiles[(i - 1) * gx][-strip:], tiles[i * gx][:strip])
                shifts[(i, j)] = s.astype(jnp.int32)
            else:
                s = reg.register_translation_3d(
                    tiles[i * gx + j - 1][:, -strip:],
                    tiles[i * gx + j][:, :strip])
                shifts[(i, j)] = s.astype(jnp.int32)
    full = jnp.zeros((out_shape[0] + 2 * pad, out_shape[1] + 2 * pad,
                      out_shape[2] + 2 * pad), jnp.float32)
    count = jnp.zeros_like(full)
    step_y = ty - overlap
    step_x = tx - overlap
    for i in range(gy):
        for j in range(gx):
            sy = i * step_y + pad + sum(
                shifts[(r, 0)][0] for r in range(1, i + 1)) + sum(
                shifts[(i, c)][0] for c in range(1, j + 1))
            sx = j * step_x + pad + sum(
                shifts[(i, c)][1] for c in range(0, j + 1))
            sz = pad + sum(shifts[(i, c)][2] for c in range(0, j + 1))
            pos = (jnp.asarray(sy), jnp.asarray(sx), jnp.asarray(sz))
            msk = masks[i * gx + j]
            patch = jax.lax.dynamic_slice(full, pos, (ty, tx, tz))
            full = jax.lax.dynamic_update_slice(
                full, patch + tiles[i * gx + j] * msk, pos)
            cpatch = jax.lax.dynamic_slice(count, pos, (ty, tx, tz))
            count = jax.lax.dynamic_update_slice(count, cpatch + msk, pos)
    return full / jnp.maximum(count, 1.0)


# ---------------------------------------------------------------------------
# Chunked 3D LP-CV enhancement
# ---------------------------------------------------------------------------


import functools as _functools


@_functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _lp_cv_3d_device(vol, patch_size, theta_range, phi_range, chunk_xy,
                     bf16: bool):
    """The xy-chunked sweep. Quartiles come from the pruned selection
    network over the leading orientation axis
    (line_profile._lp_cv_combine_network), which needs no sort and no move
    of the orientation axis to the minor dimension."""
    x, y, z = vol.shape
    pad = (patch_size - 1) // 2
    gx = -(-x // chunk_xy)
    gy = -(-y // chunk_xy)
    if bf16:
        vol = vol.astype(jnp.bfloat16)
    padded = jnp.pad(
        vol, ((pad, pad + gx * chunk_xy - x),
              (pad, pad + gy * chunk_xy - y), (pad, pad)), mode="edge")

    coords = jnp.stack(jnp.meshgrid(
        jnp.arange(gx, dtype=jnp.int32) * chunk_xy,
        jnp.arange(gy, dtype=jnp.int32) * chunk_xy,
        indexing="ij"), axis=-1).reshape(-1, 2)

    def per_chunk(c):
        block = jax.lax.dynamic_slice(
            padded, (c[0], c[1], 0),
            (chunk_xy + 2 * pad, chunk_xy + 2 * pad, z + 2 * pad))
        return lp._lp_cv_combine_network(
            lp._rnc_3d(block, patch_size, theta_range, phi_range))

    chunks = jax.lax.map(per_chunk, coords)  # (gx*gy, cxy, cxy, z)
    out = chunks.reshape(gx, gy, chunk_xy, chunk_xy, z)
    out = jnp.transpose(out, (0, 2, 1, 3, 4)).reshape(
        gx * chunk_xy, gy * chunk_xy, z)
    return out[:x, :y]


def lp_cv_enhance_3d_chunked(volume, cfg: SegmentationConfig,
                             chunk_xy: int = 128, bf16: bool | None = None,
                             layout: str = "xyz"):
    """Fused 3D LP-CV enhancement, xy-chunked with halo so the per-chunk
    (72, cx, cy, Z) scratch stays in budget (the reference's chunk loop,
    biofilm_analysis.py:1105-1126) — one jitted program sweeping the chunk
    grid with lax.map (no per-chunk host dispatch).

    The sweep is memory-bound; where the platform policy says so
    (utils/platform.policy().lp3d_bf16) the stencil accumulates in bfloat16
    (min/max selection commutes with monotone rounding; the normalized
    ratio is formed in f32), halving the traffic. Pass bf16=False to force
    full precision.

    ``layout="xzy"``: volume arrives (and the result returns) in the 3D
    pipeline's canonical (X, Z, Y) layout. The sweep is written for
    (X, Y, Z), so it pays one transpose each way; the orientation stencil's
    axis semantics are preserved either way."""
    from hiprfish_tpu.utils.platform import policy

    vol = jnp.asarray(volume, jnp.float32)
    if bf16 is None:
        bf16 = policy().lp3d_bf16
    if layout == "xzy":
        vol = vol.transpose(0, 2, 1)
    out = _lp_cv_3d_device(vol, cfg.patch_size, cfg.theta_range,
                           cfg.phi_range, chunk_xy, bool(bf16))
    return out.transpose(0, 2, 1) if layout == "xzy" else out


# ---------------------------------------------------------------------------
# 3D segmentation
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(2,))
def _segment_post_enhance(enhanced, bkg, statics):
    """Everything after the LP-CV sweep as ONE compiled program. At the
    reference's 2020x2020x170 scale every full-volume buffer is 2.8 GB
    (f32/int32), so staging these ops as separate dispatches (each pinning
    its inputs and outputs as persistent buffers) multiplies peak memory;
    a single program lets XLA's liveness analysis reuse dead buffers.
    (No donate_argnums here: buffer donation in this program corrupted the
    executable cache for LATER unrelated computations — "supplied N buffers
    but expected N+1" — reproducibly on both backends.) At the reference's
    full volume even this is not enough — use segment_3d_tiled there; this
    whole-volume program is for sub-gigavoxel inputs where exact global
    propagation is free. Labeling avoids the classic
    690M-entry scatter/gather tables entirely: marker ids are ranked to
    sequential 1..n with the gather-free presence trick (ops/segstats.py)
    BEFORE flooding, and since watershed regions retain their seed pixels
    the output needs no final relabel pass at all."""
    from hiprfish_tpu.ops import segstats

    (kmeans_iters, seed_min, ccl_iters, ws_iters, max_cells) = statics
    pos = enhanced > 0
    fg3, int3 = km.brightest_cluster_masks(enhanced, (2, 3), kmeans_iters)
    fg = fg3 & pos
    interior = int3 & pos & fg
    interior = morph.binary_opening(interior)
    interior = segstats.remove_small_objects_fast(
        interior, seed_min, 3, max_iters=ccl_iters, exact_fallback=False)
    # fill(interior) & fill(fg) == fill(interior) whenever interior ⊆ fg
    # (reachability through ~fg implies reachability through the superset
    # ~interior, so every interior hole is an fg hole; verified
    # numerically). The explicit & fg above makes the subset unconditional,
    # deleting the fill_holes(fg) border flood, the largest 3D stage.
    seeds_mask = morph.binary_fill_holes(interior, 1, 64)

    markers, n_cells = segstats.rank_labels(
        lab.label(seeds_mask & bkg, 3, ccl_iters), 3, ccl_iters)
    markers = jnp.minimum(markers, max_cells - 1)
    seg = ws.watershed(-(enhanced.astype(jnp.float32) * bkg), markers,
                       seeds_mask | (fg & bkg), 1, ws_iters)
    return seg, jnp.minimum(n_cells, max_cells - 1)


def segment_3d_from_sum(vol_sum, cfg: SegmentationConfig = SegmentationConfig(),
                        max_cells: int = 16384, chunk_xy: int = 128):
    """3D LP-CV segmentation of an already channel-summed volume — the
    input produced by the stitched tile path
    (generate_3d_segmentation_tile_memory_efficient,
    biofilm_analysis.py:1102-1171). Returns (segmentation, n_cells,
    enhanced).

    Pass ``vol_sum`` as a single-element list to transfer ownership: the
    function pops it so the 2.8 GB input can be freed as soon as the
    background mask and enhancement no longer need it (callers keeping
    their own reference forfeit that saving)."""
    if isinstance(vol_sum, list):
        vol_sum = vol_sum.pop()
    vol_norm = vol_sum / jnp.maximum(jnp.max(vol_sum), 1e-12)
    del vol_sum
    bkg = km.brightest_cluster_mask(jnp.log10(vol_norm + 1e-8), 2,
                                    cfg.kmeans_iters)

    # Chunk-size backoff: if the per-chunk (72, cx, cy, Z) scratch overflows
    # device memory, retry the sweep at half the chunk edge (utils/oom.py — the
    # recovery analogue of the reference's always-small numpy tile loop).
    from hiprfish_tpu.utils import oom

    def _enhance(cx):
        out = lp_cv_enhance_3d_chunked(vol_norm, cfg, cx)
        jax.block_until_ready(out)   # surface dispatch-time OOM here
        return out

    enhanced, _ = oom.run_with_backoff(
        _enhance, oom.halving_ladder(chunk_xy, 32), label="chunk_xy")
    del vol_norm

    statics = (cfg.kmeans_iters, cfg.lp_seed_min_size, cfg.ccl_max_iters,
               cfg.watershed_max_iters, max_cells)
    seg, n_cells = _segment_post_enhance(enhanced, bkg, statics)
    return seg, n_cells, enhanced


@functools.partial(jax.jit, static_argnums=(1, 2))
def _cluster_threshold(values, k: int, iters: int):
    """Global KMeans decision boundary between the two brightest clusters:
    assignment to the brightest cluster is exactly ``value >= midpoint`` for
    1-D nearest-center clustering, so tiles reproduce the full-volume
    brightest_cluster_mask from this one scalar. Centers-only fit — the
    full-size assignment's (N, k) distance buffer is several GB at volume
    scale (measured RESOURCE_EXHAUSTED)."""
    centers = km.kmeans1d_centers(values, k, iters)
    return (centers[-1] + centers[-2]) / 2.0


@functools.partial(jax.jit, static_argnums=(3, 4))
def _segment_one_tile(enh, bkg, thresholds, statics, shapes):
    """One margin-tiled slab of the 3D segmenter (see segment_3d_tiled):
    thresholded fg/interior masks -> opening -> small-object filter ->
    fill-holes seeds -> tile-local CCL + rank -> watershed -> crop the
    margin. Returns (tile_x, Z, Y) labels with tile-local sequential ids,
    the id-presence bitmap of the crop, and this tile's PRIVATE labels on
    its right-boundary plane pair (the host merge's sameness evidence).

    One compiled program swept over slabs by a host loop (one dispatch
    per tile).

    Slabs arrive in the pipeline's canonical (sx, Z, Y) layout: the large
    Y axis minor. segment_3d_tiled relayouts ONCE at entry, when only
    vol_sum is live (transposing enh/bkg mid-pipeline, with the originals
    still live, would double peak memory).
    """
    from hiprfish_tpu.ops import segstats

    (thr_fg, thr_int) = thresholds
    (tile_x, margin) = shapes

    enh = enh.astype(jnp.float32)
    pos = enh > 0
    # max(thr_int, thr_fg) forces interior ⊆ fg, which makes
    # fill(interior) & fill(fg) == fill(interior) an identity (see
    # _segment_post_enhance) — the fill_holes(fg) border flood, the
    # largest 3D stage, is skipped.
    interior = (enh >= jnp.maximum(thr_int, thr_fg)) & pos
    interior = morph.binary_opening(interior)
    seeds_mask = morph.binary_fill_holes(interior, 1, 64)
    return _tile_body(enh, bkg, seeds_mask, thr_fg, statics, shapes)


def _tile_body(enh, bkg, seeds_mask, thr_fg, statics, shapes):
    """Post-seeds tile body in the canonical (sx, Z, Y) layout: tile-local
    CCL + rank over the seed mask, small-seed filter, watershed, margin
    crop, id-presence bitmap, right-boundary plane pair. Shared between the
    in-tile seeds path (_segment_one_tile) and the hoisted global-seeds
    path (_segment_one_tile_seeded)."""
    from hiprfish_tpu.ops import segstats

    (seed_min, ccl_iters, ws_iters, tile_cap) = statics[:4]
    # optional 5th static: the id floods' scan-doubling cap (defaults to
    # the margin). Seed components are cells (< margin by the tiling
    # contract), so doubling past their extent is dead memory passes AND dead
    # compile (each doubling step is unrolled in the while body); a
    # too-small cap only adds fixpoint iterations, never changes the
    # result. HIPRFISH_3D_SCAN_CAP threads in here via segment_3d_tiled.
    (tile_x, margin) = shapes
    cap = min(margin, statics[4]) if len(statics) > 4 and statics[4] \
        else margin
    pos = enh > 0
    fg = (enh >= thr_fg) & pos
    markers0, _n = segstats.rank_labels(
        lab.label(seeds_mask & bkg, 3, ccl_iters, cap), 3, ccl_iters,
        cap)
    markers0 = jnp.minimum(markers0, tile_cap - 1)
    # Small-seed filter AFTER the single CCL+rank (the pre-filter
    # remove_small_objects ran a second full CCL, the bulk of the tile
    # program). Equivalent up to sub-seed_min fragments'
    # hole pixels: interior ⊂ fg (thr_int > thr_fg), so the watershed mask
    # is unchanged and unfiltered fragments just lose their markers.
    st = segstats.label_stats(markers0, None, tile_cap)
    keep_tbl = jnp.where(st.counts >= seed_min,
                         jnp.arange(tile_cap, dtype=jnp.float32),
                         0.0).at[0].set(0.0)
    markers = segstats.label_lookup(markers0, keep_tbl).astype(jnp.int32)
    seg = ws.watershed(-(enh * bkg), markers,
                       seeds_mask | (fg & bkg), 1, ws_iters)
    out = jax.lax.dynamic_slice(
        seg, (margin, 0, 0), (tile_x, seg.shape[1], seg.shape[2]))
    # A tile also labels cells living only in its margin; those ids never
    # reach the cropped output and must not become global cells — report
    # which ids are actually present in the crop.
    present = segstats.label_stats(out, None, tile_cap).counts > 0
    # Private labels on the plane pair straddling this tile's right
    # boundary (slab-local x = margin + tile_x - 1 and + tile_x); stays in
    # the canonical (x, Z, Y) layout like the cropped labels.
    planes = jax.lax.dynamic_slice(
        seg, (margin + tile_x - 1, 0, 0), (2, seg.shape[1], seg.shape[2]))
    return (out, present, planes)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _segment_tile_at(enhanced_p, bkg_p, thresholds, start, statics, shapes):
    """Slab slice + tile segmentation as ONE dispatched program (instead of
    two eager ~260 MB slice ops plus the jit call per tile). A
    traced ``start`` keeps this a single executable for every tile, and
    lets warmup precompile it from ShapeDtypeStructs alone. All full
    buffers are in the canonical (x, Z, Y) layout."""
    tile_x, margin = shapes
    slab_x = tile_x + 2 * margin
    d1, d2 = enhanced_p.shape[1], enhanced_p.shape[2]
    enh = jax.lax.dynamic_slice(enhanced_p, (start, 0, 0), (slab_x, d1, d2))
    bkg = jax.lax.dynamic_slice(bkg_p, (start, 0, 0), (slab_x, d1, d2))
    return _segment_one_tile(enh, bkg, thresholds, statics, shapes)


def _scan_cap() -> int:
    """HIPRFISH_3D_SCAN_CAP: optional tighter doubling cap for the tile id
    floods (0 = default to the margin). Read once per sweep and threaded
    through the STATIC args so jit caching and AOT warmup stay coherent."""
    import os

    v = os.environ.get("HIPRFISH_3D_SCAN_CAP")
    return int(v) if v else 0


@functools.partial(jax.jit, static_argnums=(2,))
def _global_seeds(enhanced, thr_seed, max_run: int = 128):
    """Watershed seed mask for the WHOLE volume in one program:
    threshold -> opening -> border-flood fill-holes, in the canonical
    (x, Z, Y) layout (input and output; opening/fill commute with axis
    permutation — the face neighborhood is axis-symmetric). Hoisting this out of the per-tile program cuts the
    tile executable's XLA compile by the whole opening+fill subgraph and
    deletes the margin-overlap redundancy (every voxel's seeds were
    computed up to twice across neighboring slabs); full-volume fill is
    also *exactly* the untiled semantics rather than exact-up-to-margin.
    Costs ~3 full-volume bool temporaries, so the caller falls back to
    in-tile seeds on RESOURCE_EXHAUSTED."""
    pos = enhanced > 0
    interior = (enhanced.astype(jnp.float32) >= thr_seed) & pos
    interior = morph.binary_opening(interior)
    return morph.binary_fill_holes(interior, 1, max_run)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _segment_one_tile_seeded(enh, bkg, seeds_mask, thr_fg, statics, shapes):
    """_segment_one_tile with the seed mask precomputed by _global_seeds —
    the tile program shrinks to threshold + CCL/rank + watershed (the
    opening/fill-holes subgraph is gone from its compile). All slabs
    arrive in the canonical (sx, Z, Y) layout."""
    return _tile_body(enh.astype(jnp.float32), bkg, seeds_mask, thr_fg,
                      statics, shapes)


@functools.partial(jax.jit, static_argnums=(5, 6))
def _segment_tile_at_seeded(enhanced_p, bkg_p, seeds_p, thr_fg, start,
                            statics, shapes):
    """Seeded analogue of _segment_tile_at: slab slice (enh, bkg, seeds)
    + tile segmentation as ONE dispatched program with a traced start.
    All full buffers are in the canonical (x, Z, Y) layout."""
    tile_x, margin = shapes
    slab_x = tile_x + 2 * margin
    d1, d2 = enhanced_p.shape[1], enhanced_p.shape[2]
    enh = jax.lax.dynamic_slice(enhanced_p, (start, 0, 0), (slab_x, d1, d2))
    bkg = jax.lax.dynamic_slice(bkg_p, (start, 0, 0), (slab_x, d1, d2))
    seeds = jax.lax.dynamic_slice(seeds_p, (start, 0, 0), (slab_x, d1, d2))
    return _segment_one_tile_seeded(enh, bkg, seeds, thr_fg, statics, shapes)


_PAIR_CAP = 8192


@functools.partial(jax.jit, static_argnums=(2, 3))
def _boundary_pair_codes(tiles, planes, tile_cap, cap):
    """Unique cross-boundary label pairs, extracted ON DEVICE.

    For boundary t (between tiles t and t+1): a matched pixel is one where
    tile t's PRIVATE labeling joins the two adjacent x-planes
    (planes[t, 0] == planes[t, 1] > 0) and both cropped labelings are
    foreground; its pair code is left_rank * tile_cap + right_rank
    (< tile_cap² = 2²⁶ at the default cap — exact in int32). Deduplicates
    per boundary with sort + first-occurrence + top_k and returns
    (codes (n_tiles-1, cap) zero-padded desc-sorted, n_unique (n_tiles-1,))
    so the host can detect cap spill. Replaces transferring the full
    (tiles, 2, Z, Y) private planes plus the cropped edge planes to the
    host (~30 MB per reference-scale volume -> cap*4 B/boundary)."""
    a = jnp.stack([tiles[t][-1] for t in range(len(tiles) - 1)])
    b = jnp.stack([tiles[t + 1][0] for t in range(len(tiles) - 1)])
    priv = planes[:len(tiles) - 1]
    same = (priv[:, 0] == priv[:, 1]) & (priv[:, 0] > 0) & (a > 0) & (b > 0)
    code = jnp.where(same, a.astype(jnp.int32) * tile_cap
                     + b.astype(jnp.int32), 0)
    code = code.reshape(code.shape[0], -1)
    s = jnp.sort(code, axis=1)
    first = jnp.concatenate(
        [s[:, :1] > 0, (s[:, 1:] != s[:, :-1]) & (s[:, 1:] > 0)], axis=1)
    n_unique = jnp.sum(first, axis=1)
    return (jax.lax.top_k(jnp.where(first, s, 0),
                          min(cap, s.shape[1]))[0], n_unique)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _remap_tile(labels, full_table, t, tile_cap, width):
    """Jitted remap of one tile's labels through its slice of the global
    union-find table — one dispatch per tile instead of the handful of
    eager ops inside label_lookup, and AOT-precompilable by warmup. The
    FULL table uploads once; each tile's slice is taken on device (no
    per-tile host->device put)."""
    from hiprfish_tpu.ops import segstats

    tbl = jax.lax.dynamic_slice(full_table, (t * tile_cap,), (tile_cap,))
    return segstats.label_lookup(labels, tbl, width=width,
                                 out_dtype=jnp.int32)


def _tiled_segment_pass_mesh(boxes, thresholds, statics, shapes, log, mesh):
    """Mesh-sharded sweep of _segment_one_tile: tiles are independent until
    the host union-find, so the slab batch shards over the mesh's 'fov'
    axis with shard_map and each device sweeps its local slabs under
    lax.map — the reference's only scale-out axis (Snakemake fan-out +
    spatial tiling, ecoli/Snakefile:63-114, biofilm_analysis.py:900-917)
    mapped onto chips. Tile count pads to a multiple of the axis size by
    replaying the last slab; padded outputs are dropped on host. Output
    contract matches _tiled_segment_pass."""
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    (kmeans_iters, seed_min, ccl_iters, ws_iters, tile_cap, patch_size,
     theta_range, phi_range, scan_cap) = statics
    (tile_x, margin, n_tiles) = shapes
    slab_x = tile_x + 2 * margin
    enhanced_p, bkg_p, seeds_p = boxes.pop()
    n_dev = mesh.shape["fov"]
    nt = n_tiles + ((-n_tiles) % n_dev)
    starts = [min(t, n_tiles - 1) * tile_x for t in range(nt)]

    def cut(vol):
        # every full buffer is in the canonical (x, Z, Y) layout
        slabs = jnp.stack([jax.lax.slice(vol, (s, 0, 0),
                                         (s + slab_x,) + vol.shape[1:])
                           for s in starts])
        return jax.device_put(slabs, NamedSharding(mesh, P("fov")))

    slabs_e, slabs_b = cut(enhanced_p), cut(bkg_p)
    slabs_s = cut(seeds_p) if seeds_p is not None else None
    del enhanced_p, bkg_p, seeds_p
    thr = jax.device_put(jnp.stack([thresholds[0], thresholds[1]]),
                         NamedSharding(mesh, P()))
    tile_statics = (seed_min, ccl_iters, ws_iters, tile_cap,
                    scan_cap)

    if slabs_s is None:
        def local(se, sb, th):
            def one(args):
                e, b = args
                return _segment_one_tile(e, b, (th[0], th[1]),
                                         tile_statics, (tile_x, margin))

            return jax.lax.map(one, (se, sb))

        run = jax.jit(shard_map(
            local, mesh=mesh, in_specs=(P("fov"), P("fov"), P()),
            out_specs=P("fov"), check_vma=False))
        outs, presents, planes = run(slabs_e, slabs_b, thr)
    else:
        def local_seeded(se, sb, ss, th):
            def one(args):
                e, b, s = args
                return _segment_one_tile_seeded(e, b, s, th[0],
                                                tile_statics,
                                                (tile_x, margin))

            return jax.lax.map(one, (se, sb, ss))

        run = jax.jit(shard_map(
            local_seeded, mesh=mesh,
            in_specs=(P("fov"), P("fov"), P("fov"), P()),
            out_specs=P("fov"), check_vma=False))
        outs, presents, planes = run(slabs_e, slabs_b, slabs_s, thr)
    jax.block_until_ready(presents)
    log(f"mesh sweep: {nt} slabs over {n_dev} devices")
    return ([outs[t] for t in range(n_tiles)], presents[:n_tiles],
            planes[:n_tiles])


def _tiled_segment_pass(boxes, thresholds, statics, shapes, log=lambda m: None,
                        mesh=None):
    """Host-looped sweep of _segment_one_tile. ``boxes`` is a single-element
    list [(enhanced_p, bkg_p, seeds_p-or-None)], all in the canonical
    (x, Z, Y) layout; it is emptied before the per-tile outputs are
    stacked so the padded inputs free first. Returns a list of
    (tile_x, Z, Y) label tiles, (tiles, tile_cap) presence, and
    (tiles, 2, Z, Y) boundary planes. With ``mesh``, tiles shard across
    chips instead (see _tiled_segment_pass_mesh)."""
    if mesh is not None:
        return _tiled_segment_pass_mesh(boxes, thresholds, statics, shapes,
                                        log, mesh)
    (kmeans_iters, seed_min, ccl_iters, ws_iters, tile_cap, patch_size,
     theta_range, phi_range, scan_cap) = statics
    (tile_x, margin, n_tiles) = shapes
    slab_x = tile_x + 2 * margin
    enhanced_p, bkg_p, seeds_p = boxes.pop()
    tile_statics = (seed_min, ccl_iters, ws_iters, tile_cap,
                    scan_cap)
    outs, presents, planes = [], [], []
    for t in range(n_tiles):
        if seeds_p is None:
            o, p, pl = _segment_tile_at(
                enhanced_p, bkg_p, thresholds, np.int32(t * tile_x),
                tile_statics, (tile_x, margin))
        else:
            o, p, pl = _segment_tile_at_seeded(
                enhanced_p, bkg_p, seeds_p, thresholds[0],
                np.int32(t * tile_x), tile_statics, (tile_x, margin))
        outs.append(o)
        presents.append(p)
        planes.append(pl)
        if t % 4 == 0 or t == n_tiles - 1:
            jax.block_until_ready(p)
            log(f"tile {t + 1}/{n_tiles}")
    del enhanced_p, bkg_p, seeds_p
    # outs stays a LIST: stacking the full volume here plus the later
    # global remap pass held three full-volume buffers at once (measured
    # RESOURCE_EXHAUSTED at the reference scale)
    return (outs, jnp.stack(presents), jnp.stack(planes))


def warmup_pipeline(shape, cfg: SegmentationConfig = SegmentationConfig(),
                    max_cells: int = 16384, tile_x: int = 360,
                    margin: int = 64, tile_cap: int = 8192,
                    z_chunk: int = 2, n_channels: int | None = None,
                    measure_runner=None):
    """Pre-compile the 3D tile program and the measurement program in
    background threads, overlapped with whatever the caller dispatches
    meanwhile (IO, stitching, enhancement): a cold process otherwise pays
    these compiles on the critical path. XLA compiles run on the host and
    overlap each other while the device queue keeps draining.

    All warms are AOT ``jit.lower(ShapeDtypeStruct...).compile()`` — this
    populates the same executable cache the later direct calls hit
    (verified by experiment: a post-AOT call pays tracing, never a
    recompile), allocates NOTHING on device, and lands no junk work in
    the queue — so it can precompile the full-volume-signature programs
    (_segment_tile_at, make_fused_measure's runner) without holding
    multi-GB dummies.

    ``n_channels`` warms the measurement: ``measure_runner`` (a
    make_fused_measure program) if given, else the streamed path's
    per-chunk accumulate for f32 (C, z_chunk, X, Y) slabs.

    Returns a join() callable; call it before timing segmentation to
    guarantee the programs are ready (optional — the jit cache is
    populated whenever the threads finish).
    """
    import os
    import threading

    x, y, z = shape
    n_tiles = -(-x // tile_x)
    padded_x = n_tiles * tile_x + 2 * margin
    statics = (cfg.lp_seed_min_size, cfg.ccl_max_iters,
               cfg.watershed_max_iters, tile_cap, _scan_cap())
    f32 = jnp.float32
    scalar_f32 = jax.ShapeDtypeStruct((), f32)
    use_seeded = os.environ.get("HIPRFISH_3D_GLOBAL_SEEDS", "1") != "0"
    tile_done = threading.Event()

    def warm_seeds():
        # the global-seeds program runs FIRST at runtime (right after
        # thresholds) — give it its own thread so it doesn't queue behind
        # the tile program
        _global_seeds.lower(
            jax.ShapeDtypeStruct((x, z, y), f32),
            scalar_f32).compile()

    def warm_tile():
        # f32 to match the runtime call exactly: lp_cv_enhance_3d_chunked
        # returns f32 on every backend (a bf16 sweep accumulates in bf16
        # internally but emits f32), and segment_3d_tiled
        # pads without casting. A dtype drift here silently recompiles the
        # tile program on the timed critical path. All full buffers are in
        # the canonical (x, Z, Y) layout.
        enh = jax.ShapeDtypeStruct((padded_x, z, y), f32)
        bkg = jax.ShapeDtypeStruct((padded_x, z, y), jnp.bool_)
        start = jax.ShapeDtypeStruct((), jnp.int32)
        if use_seeded:
            seeds = jax.ShapeDtypeStruct((padded_x, z, y), jnp.bool_)
            _segment_tile_at_seeded.lower(
                enh, bkg, seeds, scalar_f32, start, statics,
                (tile_x, margin)).compile()
        else:
            _segment_tile_at.lower(enh, bkg, (scalar_f32, scalar_f32),
                                   start, statics, (tile_x, margin)).compile()
        tile_done.set()
        # The remap program runs right after the tile sweep; compile it
        # next (sequentially, after the tile program lands) so the merge
        # stage doesn't pay its compile on the critical path.
        lab_s = jax.ShapeDtypeStruct((tile_x, z, y), jnp.int32)
        tbl_s = jax.ShapeDtypeStruct((n_tiles * tile_cap,), f32)
        t_s = jax.ShapeDtypeStruct((), jnp.int32)
        _remap_tile.lower(lab_s, tbl_s, t_s, tile_cap,
                          min(tile_cap, 2048)).compile()
        if use_seeded:
            # Also warm the unseeded tile program: segment_3d_tiled falls
            # back to it when the global-seeds flood hits
            # RESOURCE_EXHAUSTED, and that is exactly the run that can't
            # afford a cold compile on the critical path.
            _segment_tile_at.lower(enh, bkg, (scalar_f32, scalar_f32),
                                   start, statics, (tile_x, margin)).compile()

    def warm_measure():
        # Stagger: the tile program is on the critical path first, the
        # measurement only after the whole segment stage — don't contend
        # for GIL-bound tracing while the tile program compiles.
        # Event-based so join() never stalls past the compiles finishing.
        tile_done.wait(timeout=15)
        if measure_runner is not None:
            measure_runner.lower(
                jax.ShapeDtypeStruct((z, x, y), jnp.int32)).compile()
            return
        _accumulate_chunk_cm.lower(
            jax.ShapeDtypeStruct((max_cells, 1 + n_channels), f32),
            jax.ShapeDtypeStruct((x, y, z_chunk), jnp.int32),
            jax.ShapeDtypeStruct((n_channels, z_chunk, x, y), f32)).compile()

    targets = [warm_tile]
    if use_seeded:
        targets.append(warm_seeds)
    if n_channels is not None:
        targets.append(warm_measure)

    def _quiet_oom(fn):
        # A warm compile that overflows device memory must not spew a thread
        # traceback: the runtime call pays the same failure inside ITS
        # OOM handler and falls back (global seeds -> in-tile seeds,
        # fused measure -> streamed); anything else re-raises.
        def wrapped():
            from hiprfish_tpu.utils import oom
            try:
                fn()
            except Exception as e:
                if not oom.is_oom_error(e):
                    raise
                import logging
                logging.getLogger("hiprfish_tpu.segment3d").warning(
                    "warmup compile OOM in %s (runtime will fall back)",
                    fn.__name__)
        return wrapped

    threads = [threading.Thread(target=_quiet_oom(t), daemon=True)
               for t in targets]
    for t in threads:
        t.start()

    def join():
        for t in threads:
            t.join()

    return join


def segment_3d_tiled(vol_sum, cfg: SegmentationConfig = SegmentationConfig(),
                     max_cells: int = 16384, tile_x: int = 360,
                     margin: int = 64, tile_cap: int = 8192,
                     chunk_xy: int = 128, mesh=None,
                     out_layout: str = "xyz"):
    """Full-scale 3D segmentation as a margin-tiled sweep, which bounds the
    memory of the reference's 2020x2020x170 volume on one device.

    Whole-volume label propagation (CCL, watershed) holds 5-10 full-volume
    temporaries inside its while-loop body; at 690M voxels that is a
    program of tens of GB. Instead the volume is
    tiled along x with a ``margin`` overlap wider than any cell: every tile
    segments its slab independently inside one lax.map program (global
    KMeans thresholds keep the masks identical to the full-volume path),
    and each voxel's label comes from the tile that owns it. Cells
    straddling a tile boundary are segmented twice; the two halves are
    re-united by a host union-find over the boundary plane pair, where the
    owning tile's private (uncropped) labeling witnesses that the two
    global ids are one cell. The merged remap applies with the windowed
    gather-free lookup (ops/segstats.py) — tile-local sequential ids are
    band-local by construction. Exact for every structure smaller than
    ``margin``; the same decomposition shard_maps across chips (the tile
    axis is the mesh 'tile' axis of parallel/spatial.py).

    ``tile_x`` defaults to 360 (6 tiles at the reference's X=2020): the
    margin-overlap redundancy factor is (tile_x + 2*margin)/tile_x;
    exactness is margin's, not tile_x's, so the knob is pure scheduling.

    Accepts a single-element list for ownership transfer like
    segment_3d_from_sum. Returns (seg, n_cells, None).

    ``out_layout="xzy"``: return the labels in the pipeline's canonical
    (X, Z, Y) layout instead of (X, Y, Z), skipping the final
    minor-dim transpose — callers that next transpose to (Z, X, Y) for
    plane-streamed measurement (make_fused_measure) then pay only a cheap
    major-dims permute.
    """
    from hiprfish_tpu.ops import segstats
    from hiprfish_tpu.utils import oom

    import os as _os
    import sys as _sys
    import time as _time

    _t0 = _time.time()

    def _log(msg):
        if _os.environ.get("HIPRFISH_3D_LOG"):
            print(f"# [3d +{_time.time()-_t0:6.1f}s] {msg}",
                  file=_sys.stderr, flush=True)

    if isinstance(vol_sum, list):
        vol_sum = vol_sum.pop()
    x, y, z = vol_sum.shape
    # Canonical (x, Z, Y) relayout ONCE, while only vol_sum is live (the
    # large Y axis minor). Everything from here to the final label
    # assembly — thresholds, enhancement, seeds, the tile sweep — runs in
    # (x, Z, Y); the result transposes back once. At entry the transient
    # is just vol + vol_xzy.
    vol_sum = jnp.transpose(vol_sum, (0, 2, 1))
    vol_norm = vol_sum / jnp.maximum(jnp.max(vol_sum), 1e-12)
    del vol_sum
    logv = jnp.log10(vol_norm + 1e-8)
    thr_bkg = _cluster_threshold(logv, 2, cfg.kmeans_iters)
    _log(f"thr_bkg={float(thr_bkg):.3f}")
    bkg = logv >= thr_bkg
    del logv

    def _enhance(cx):
        out = lp_cv_enhance_3d_chunked(vol_norm, cfg, cx, layout="xzy")
        jax.block_until_ready(out)
        return out

    enhanced, _ = oom.run_with_backoff(
        _enhance, oom.halving_ladder(chunk_xy, 32), label="chunk_xy")
    del vol_norm
    _log("enhanced")
    # enhanced is f32 on every backend (a bf16 sweep accumulates in bf16
    # internally but emits f32)
    # one shared full-volume histogram for both k (the scatter pass over
    # 694M voxels dominates each call; kmeans1d_centers_multi halves it)
    c2, c3 = km.kmeans1d_centers_multi(enhanced.astype(jnp.float32),
                                       (2, 3), cfg.kmeans_iters)
    thr_fg = (c2[-1] + c2[-2]) / 2.0
    thr_int = (c3[-1] + c3[-2]) / 2.0

    # Hoisted seed mask (opening + fill-holes) for the whole volume in one
    # program — the per-tile programs then just slice it (smaller tile
    # compile, no margin-overlap redundancy, exact untiled fill semantics).
    # ~3 full-volume bool temporaries live inside the flood's while body;
    # if that overflows device memory, fall back to computing seeds inside each tile.
    seeds = None
    if _os.environ.get("HIPRFISH_3D_GLOBAL_SEEDS", "1") != "0":
        try:
            # the sync makes an asynchronous RESOURCE_EXHAUSTED surface
            # here, inside the handler, instead of at a later use
            seeds = jax.block_until_ready(
                _global_seeds(enhanced, jnp.maximum(thr_fg, thr_int)))
            _log("global seeds")
        except Exception as e:  # pragma: no cover - backend OOM only
            if not oom.is_oom_error(e):
                raise
            _log("global seeds RESOURCE_EXHAUSTED -> in-tile fallback")
            seeds = None

    n_tiles = -(-x // tile_x)
    pad_r = n_tiles * tile_x - x + margin
    enhanced_p = jnp.pad(enhanced, ((margin, pad_r), (0, 0), (0, 0)),
                         mode="edge")
    del enhanced
    bkg_p = jnp.pad(bkg, ((margin, pad_r), (0, 0), (0, 0)), mode="edge")
    seeds_p = None
    if seeds is not None:
        seeds_p = jnp.pad(seeds, ((margin, pad_r), (0, 0), (0, 0)),
                          mode="edge")
        del seeds

    statics = (cfg.kmeans_iters, cfg.lp_seed_min_size, cfg.ccl_max_iters,
               cfg.watershed_max_iters, tile_cap, cfg.patch_size,
               cfg.theta_range, cfg.phi_range, _scan_cap())
    _log(f"thr_fg={float(thr_fg):.3f} thr_int={float(thr_int):.3f}; "
         f"{n_tiles} tiles")
    box = [(enhanced_p, bkg_p, seeds_p)]
    del enhanced_p, bkg_p, seeds_p
    tiles_seg, tile_present, planes = _tiled_segment_pass(
        box, (thr_fg, thr_int), statics, (tile_x, margin, n_tiles),
        log=_log, mesh=mesh)

    # Host union-find over the boundary plane pairs. Global id of tile t's
    # local rank r is t * tile_cap + r.
    present = np.asarray(tile_present)        # (tiles, tile_cap) bool
    # Matched (left, right) rank pairs are deduplicated ON DEVICE and only
    # the unique codes come to the host (~cap*4 B/boundary); the full
    # plane-pair transfer (~30 MB/volume) remains only as the
    # pair-cap-spill fallback below.
    pair_rows = None
    planes_np = edges_np = None
    if n_tiles > 1:
        codes, n_uni = _boundary_pair_codes(tuple(tiles_seg), planes,
                                            tile_cap, _PAIR_CAP)
        n_uni = np.asarray(n_uni)
        if int(n_uni.max(initial=0)) < _PAIR_CAP:
            pair_rows = np.asarray(codes)
        else:
            _log(f"boundary pair cap spill ({int(n_uni.max())} >= "
                 f"{_PAIR_CAP}) -> full-plane merge")
            planes_np = np.asarray(planes)    # (tiles, 2, Z, Y) private ids
            edges_np = np.asarray(jax.jit(
                lambda ts: jnp.stack([jnp.stack([ts[t][-1], ts[t + 1][0]])
                                      for t in range(len(ts) - 1)]))(
                tuple(tiles_seg)))
    parent = {}

    def find(a):
        while parent.get(a, a) != a:
            parent[a] = parent.get(parent[a], parent[a])
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    for t in range(n_tiles - 1):
        xb = (t + 1) * tile_x
        if xb >= x:
            break
        if pair_rows is not None:
            for code in pair_rows[t][pair_rows[t] > 0].tolist():
                union(t * tile_cap + code // tile_cap,
                      (t + 1) * tile_cap + code % tile_cap)
            continue
        g0 = edges_np[t, 0]
        g0 = np.where(g0 > 0, g0 + t * tile_cap, 0)
        g1 = edges_np[t, 1]
        g1 = np.where(g1 > 0, g1 + (t + 1) * tile_cap, 0)
        priv = planes_np[t]
        same = (priv[0] == priv[1]) & (priv[0] > 0) & (g0 > 0) & (g1 > 0)
        # unique (a, b) pairs via one packed-int64 np.unique — the python
        # set(zip(...)) over up to Y*Z matched pixels per boundary was
        # seconds of host time at 2020x170
        packed = np.unique(g0[same].astype(np.int64) << 32
                           | g1[same].astype(np.int64))
        for p in packed.tolist():
            union(p >> 32, p & 0xFFFFFFFF)

    all_ids = [t * tile_cap + r
               for t in range(n_tiles)
               for r in np.flatnonzero(present[t][1:]) + 1]
    roots = sorted({find(i) for i in all_ids})
    root_rank = {r: i + 1 for i, r in enumerate(roots)}
    remap = np.zeros(n_tiles * tile_cap, np.float32)
    for i in all_ids:
        remap[i] = min(root_rank[find(i)], max_cells - 1)
    n_cells = min(len(roots), max_cells - 1)

    _log(f"merge done: {n_cells} cells")
    # Remap tile by tile (each tile's ids index its own tile_cap-slice of
    # the global table), freeing originals as we go, then assemble once.
    remapped = []
    remap_dev = jnp.asarray(remap)
    while tiles_seg:
        t = len(remapped)
        remapped.append(_remap_tile(tiles_seg.pop(0), remap_dev,
                                    np.int32(t), tile_cap,
                                    min(tile_cap, 2048)))
    # assemble in the canonical (x, Z, Y) layout, then transpose back once
    # to the public (X, Y, Z) contract unless the caller wants xzy
    seg = jnp.concatenate(remapped, axis=0)[:x]
    if out_layout != "xzy":
        seg = jnp.transpose(seg, (0, 2, 1))
    del remapped
    _log("remap applied")
    return seg, n_cells, None


def segment_3d(volume_stack, cfg: SegmentationConfig = SegmentationConfig(),
               max_cells: int = 16384, chunk_xy: int = 128):
    """3D LP-CV segmentation of per-laser volumes
    (generate_3d_segmentation_memory_efficient, biofilm_analysis.py:778-861).

    Returns (segmentation (X,Y,Z) int32 sequential, n_cells, registered
    (X,Y,Z,C), enhanced)."""
    registered = register_volume_stack(volume_stack)
    vol_sum = jnp.sum(registered, axis=3)
    seg, n_cells, enhanced = segment_3d_from_sum(vol_sum, cfg, max_cells,
                                                 chunk_xy)
    return seg, n_cells, registered, enhanced


def segment_zstack_slice(image_stack_4d, z: int,
                         cfg: SegmentationConfig = SegmentationConfig(),
                         max_cells: int = 4096):
    """Per-z-slice 2D segmentation of a pre-registered (X, Y, Z, C) stack
    (generate_2d_segmentation_from_zstack_t_sum, biofilm_analysis.py:721-776)."""
    plane = jnp.asarray(image_stack_4d)[:, :, z, :]
    return segment2d.segment_lpcv_from_registered(plane, cfg, max_cells,
                                                  "biofilm"), plane


def _stats_cm(labels, img_cm, num_segments: int):
    """(num_segments, 1 + C) per-label [pixel count, channel sums] of one
    channels-major slab. ``labels``: (zc, X, Y) int; ``img_cm``:
    (C, zc, X, Y) in any float dtype (sums accumulate in f32). Cells go
    through one scatter-add; the background (label 0), which would put
    most pixels' atomic adds on one row, is a dense masked reduction
    instead. Labels >= num_segments are dropped."""
    idx = labels.reshape(-1)
    c = img_cm.shape[0]
    img = img_cm.reshape(c, -1).astype(jnp.float32)
    feats = jnp.concatenate([jnp.ones((1, idx.size), jnp.float32), img],
                            axis=0)
    acc = jnp.zeros((num_segments, 1 + c), jnp.float32).at[
        jnp.where(idx > 0, idx, num_segments)].add(feats.T, mode="drop")
    return acc.at[0].set(jnp.sum(jnp.where(idx == 0, feats, 0.0), axis=1))


@jax.jit
def _accumulate_chunk_cm(acc, labels_slab, chunk_cm):
    """Channels-major accumulation: chunk (C, zc, X, Y), labels (X, Y, zc),
    acc (max_cells, 1 + C) [count, sums]."""
    return acc + _stats_cm(jnp.transpose(labels_slab, (2, 0, 1)), chunk_cm,
                           acc.shape[0])


def make_fused_measure(loader_fn, shape, z_chunk: int, n_channels: int,
                       max_cells: int):
    """Whole-volume streamed measurement as ONE jitted program, for
    loaders that are themselves jax-traceable with a traced z0 (the
    synthetic volume generator, or any on-device spectral source).

    measure_volume_streamed dispatches loader + accumulate per z-chunk
    from the host; here the chunk sweep is a ``lax.fori_loop`` inside one
    program: one dispatch, loader and accumulation fused, one chunk of
    spectra materialized at a time.

    Returns a jitted ``run(seg_zxy) -> (max_cells, C) mean spectra`` taking
    the (Z, X, Y)-transposed label volume; AOT-lower it for warmup via
    ``run.lower(ShapeDtypeStruct((z, x, y), jnp.int32)).compile()``.
    """
    x, y, z = shape
    nsteps, tail = divmod(z, z_chunk)

    def step(seg_zxy, acc, z0, zc):
        # Keep the loader's dtype: bf16 spectral sources halve the chunk
        # write + read (the sums accumulate in f32 either way).
        chunk = jnp.asarray(loader_fn(z0, zc))
        lab = jax.lax.dynamic_slice(seg_zxy, (z0, 0, 0), (zc, x, y))
        return acc + _stats_cm(lab, chunk, acc.shape[0])

    @jax.jit
    def run(seg_zxy):
        acc = jax.lax.fori_loop(
            0, nsteps, lambda i, a: step(seg_zxy, a, i * z_chunk, z_chunk),
            jnp.zeros((max_cells, 1 + n_channels), jnp.float32))
        if tail:
            acc = step(seg_zxy, acc, nsteps * z_chunk, tail)
        return acc[:, 1:] / jnp.maximum(acc[:, :1], 1.0)

    return run


def measure_volume_streamed(seg, chunk_loader, z_total: int, z_chunk: int,
                            n_channels: int, max_cells: int,
                            channels_major: bool = False):
    """Per-cell mean spectra of a labeled volume whose C-channel data never
    fits in memory: stream slabs from ``chunk_loader(z0, zc)`` (device array
    or host loader) and accumulate per-label channel sums with one
    scatter-add per slab — the working replacement for the reference's
    broken 3D measurement path (biofilm_analysis.py:1359-1364 references
    undefined variables; its 2D analogue runs one regionprops pass per
    channel).

    ``channels_major=True``: the loader yields (C, zc, X, Y) slabs (the
    layout the synthetic generator and make_fused_measure use); otherwise
    (X, Y, zc, C).

    A device OOM (e.g. a too-deep z_chunk) retries the whole accumulation
    down a halving ladder of slab depths; each attempt ends in
    ``jax.block_until_ready`` so an asynchronous RESOURCE_EXHAUSTED
    surfaces inside the handler instead of at a later read."""
    from hiprfish_tpu.utils import oom

    def _run(zc_max):
        acc = jnp.zeros((max_cells, 1 + n_channels), jnp.float32)
        for z0 in range(0, z_total, zc_max):
            zc = min(zc_max, z_total - z0)
            # keep the loader's dtype (bf16 sources halve traffic)
            chunk = jnp.asarray(chunk_loader(z0, zc))
            if not channels_major:
                chunk = jnp.transpose(chunk, (3, 2, 0, 1))
            acc = _accumulate_chunk_cm(
                acc, jax.lax.dynamic_slice_in_dim(seg, z0, zc, 2), chunk)
        return jax.block_until_ready(acc)

    acc, _ = oom.run_with_backoff(
        _run, oom.halving_ladder(z_chunk, 1), label="z_chunk")
    return acc[:, 1:] / jnp.maximum(acc[:, :1], 1.0)


def measure_volume_zsharded(seg, volume_cm, mesh, axis: str = "fov",
                            max_cells: int = 16384):
    """Multi-chip per-cell spectral measurement: the labeled volume and its
    channel data shard over ``mesh.shape[axis]`` devices as z-slabs; each
    device accumulates per-label channel sums/counts over its local slab
    (global label ids are slab-invariant, so partial sums are additive) and
    one ``psum`` over the axis replicates the totals. The multi-chip
    analogue of ``measure_volume_streamed`` — the scale-out axis the
    reference covers only with Snakemake process fan-out
    (ecoli/Snakefile:63-114; its in-script 3D measurement path is broken,
    biofilm_analysis.py:1359-1364).

    Args:
      seg: (X, Y, Z) int32 labels (0 = background).
      volume_cm: (C, Z, X, Y) channels-major intensity volume (the layout
        of ``_accumulate_chunk_cm``).
      mesh: jax Mesh containing ``axis``; Z must divide by its size.
    Returns (max_cells, C) per-label mean spectra (row 0 = background).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n = mesh.shape[axis]
    zdim = seg.shape[2]
    if zdim % n:
        raise ValueError(f"Z={zdim} must divide by mesh[{axis!r}]={n}")
    # JAX scatter-adds silently DROP out-of-bounds indices: a label >=
    # max_cells would lose its cell with no error (the default now matches
    # segment_3d_tiled's 16384, but a caller passing a smaller cap gets a
    # loud failure instead of silently missing cells).
    seg_max = int(jnp.max(seg))
    if seg_max >= max_cells:
        raise ValueError(
            f"seg contains label {seg_max} >= max_cells={max_cells}; "
            "raise max_cells to cover every label")
    c = volume_cm.shape[0]

    def _local(seg_l, vol_l):
        idx = jnp.transpose(seg_l, (2, 0, 1)).reshape(-1)
        sums_cm = jnp.zeros((c, max_cells), jnp.float32).at[:, idx].add(
            vol_l.reshape(c, -1).astype(jnp.float32))
        counts = jnp.zeros((max_cells,), jnp.float32).at[idx].add(1.0)
        sums_cm = jax.lax.psum(sums_cm, axis)
        counts = jax.lax.psum(counts, axis)
        return (sums_cm / jnp.maximum(counts, 1.0)[None, :]).T

    fn = shard_map(_local, mesh=mesh,
                   in_specs=(P(None, None, axis), P(None, axis, None, None)),
                   out_specs=P(None, None))
    return jax.jit(fn)(jnp.asarray(seg), jnp.asarray(volume_cm))


# ---------------------------------------------------------------------------
# Measurement front-ends (CLI glue)
# ---------------------------------------------------------------------------


def measure_biofilm_images_2d_from_zstack_cli(sample, clf, taxon_lookup,
                                              z_indices, cfg=SegmentationConfig(),
                                              max_cells=4096):
    """Z-slice biofilm measurement (measure_biofilm_images_2d_from_zstack,
    biofilm_analysis.py:1298-1357): per requested z, segment the slice and
    emit the per-slice artifact set."""
    from hiprfish_tpu.config import SEVEN_BIT
    from hiprfish_tpu.io import images as iio
    from hiprfish_tpu.pipeline import biofilm as bf

    volumes = [iio.load_image_zstack_fixed_t(f"{sample}_{laser}.npy")
               if not _exists(f"{sample}_{laser}.czi")
               else iio.load_image_zstack_fixed_t(f"{sample}_{laser}.czi")
               for laser in SEVEN_BIT.lasers]
    stack4d = register_volume_stack(volumes)
    for z in z_indices:
        res, plane = segment_zstack_slice(stack4d, z, cfg, max_cells)
        n = int(res.n_cells)
        tag = f"{sample}_z_{z}"
        np.save(f"{tag}_registered.npy", np.asarray(plane))
        np.save(f"{tag}_seg.npy", np.asarray(res.segmentation))
        np.save(f"{tag}_adjacency_seg.npy", np.asarray(res.adjacency))
        avgint, avgint_norm = meas.measure_fov(res.segmentation, plane, n,
                                               max_cells)
        codes, max_prob, probs, feats = clf.classify(jnp.asarray(avgint_norm))
        props = {k: np.asarray(v)[1:n + 1] for k, v in
                 rp.shape_props_2d(res.segmentation, max_cells).items()}
        import pandas as pd

        cell_info = pd.DataFrame(np.asarray(feats))
        col = cell_info.shape[1]
        cell_info[col] = codes
        cell_info[col + 1] = sample
        cell_info[col + 2] = np.arange(1, n + 1)
        cell_info[col + 3] = props["centroid_r"]
        cell_info[col + 4] = props["centroid_c"]
        cell_info[col + 5] = props["major_axis_length"]
        cell_info[col + 6] = props["minor_axis_length"]
        cell_info[col + 7] = props["eccentricity"]
        cell_info[col + 8] = props["orientation"]
        cell_info[col + 9] = props["area"]
        cell_info.to_csv(f"{tag}_cell_information.csv", index=None, header=None)
        ident = bf.paint_taxon_identification(
            np.asarray(res.segmentation), codes, taxon_lookup, n)
        np.save(f"{tag}_identification.npy", ident)
        pairs = bf.adjacency_label_pairs(np.asarray(res.adjacency))
        mat, _ = bf.adjacency_matrix_from_pairs(pairs, codes, taxon_lookup)
        mat.to_csv(f"{tag}_adjacency_matrix.csv")


def measure_biofilm_images_3d(sample, clf, taxon_lookup,
                              cfg=SegmentationConfig(), max_cells=16384,
                              save_bvox=True):
    """Volumetric biofilm measurement (measure_biofilm_images_3d,
    biofilm_analysis.py:1359-1417, with the reference's broken undefined-
    variable path repaired): 3D segment -> per-cell volume spectra ->
    classification -> 3D identification + bvox export."""
    from hiprfish_tpu.config import SEVEN_BIT
    from hiprfish_tpu.io import images as iio
    from hiprfish_tpu.pipeline import biofilm as bf

    volumes = []
    for laser in SEVEN_BIT.lasers:
        fn = (f"{sample}_{laser}.czi" if _exists(f"{sample}_{laser}.czi")
              else f"{sample}_{laser}.npy")
        volumes.append(iio.load_image_zstack_fixed_t(fn))
    seg, n_cells, registered, enhanced = segment_3d(volumes, cfg, max_cells)
    n = int(n_cells)
    np.save(f"{sample}_registered.npy", np.asarray(registered))
    np.save(f"{sample}_seg.npy", np.asarray(seg))

    avgint = np.asarray(rp.mean_intensities(seg, registered, max_cells))[1:n + 1]
    avgint_norm = avgint / np.maximum(avgint.max(axis=1, keepdims=True), 1e-12)
    codes, max_prob, probs, feats = clf.classify(jnp.asarray(avgint_norm))
    props3 = {k: np.asarray(v)[1:n + 1] for k, v in
              rp.shape_props_3d(seg, max_cells).items()}
    import pandas as pd

    nch = clf.n_channels
    cell_info = pd.DataFrame(
        np.asarray(feats),
        columns=[f"channel_{i}" for i in range(nch)]
        + [f"intensity_classification_{i}"
           for i in range(np.asarray(feats).shape[1] - nch)])
    cell_info["cell_barcode"] = codes
    cell_info["max_probability"] = max_prob
    cell_info["sample"] = sample
    cell_info["label"] = np.arange(1, n + 1)
    cell_info["centroid_x"] = props3["centroid_x"]
    cell_info["centroid_y"] = props3["centroid_y"]
    cell_info["centroid_z"] = props3["centroid_z"]
    cell_info["area"] = props3["area"]
    cell_info["type"] = "cell"
    debris = ((cell_info.area.values > 100000)
              | (cell_info.max_probability.values <= cfg.debris_prob_min))
    cell_info.loc[debris, "type"] = "debris"
    cell_info.to_csv(f"{sample}_cell_information.csv", index=None)

    seg_np = np.asarray(seg)
    ident = _paint_3d_identification(seg_np, codes, taxon_lookup, n)
    np.save(f"{sample}_identification.npy", ident)
    if save_bvox:
        outputs.save_identification_bvox(ident, sample)
        outputs.save_bvox(np.asarray(jnp.sum(registered, axis=3)),
                          f"{sample}_raw_image.bvox")
    return cell_info


def _paint_3d_identification(seg, codes, taxon_lookup, n_cells):
    from matplotlib.colors import hsv_to_rgb

    code_to_rgb = {
        str(row.code): hsv_to_rgb([row.H, row.S, row.V])
        for row in taxon_lookup.itertuples()
    }
    lut = np.zeros((n_cells + 1, 3), np.float32)
    for i, c in enumerate(codes):
        lut[i + 1] = code_to_rgb.get(str(c).split("_")[0], (1, 1, 1))
    return lut[np.clip(seg, 0, n_cells)]


def _exists(path):
    import os

    return os.path.exists(path)
