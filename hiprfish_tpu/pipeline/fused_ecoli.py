"""Fully fused single-program E. coli segmentation (10-bit path).

Same semantics as pipeline/segment2d.segment_ecoli
(spectral_image_measurement.py:44-127) but compiled as ONE XLA program: the
data-dependent erosion-seeding loop runs as a bounded lax.while_loop on
device instead of a host loop — hundreds of host dispatches collapse into a
single launch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hiprfish_tpu.config import SegmentationConfig
from hiprfish_tpu.ops import kmeans as km
from hiprfish_tpu.ops import labeling as lab
from hiprfish_tpu.ops import morphology as morph
from hiprfish_tpu.ops import register as reg
from hiprfish_tpu.ops import segstats
from hiprfish_tpu.ops import watershed as ws
from hiprfish_tpu.pipeline.segment2d import _erode_labels_twice


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def segment_ecoli_device(stack, cfg: SegmentationConfig = SegmentationConfig(),
                         max_cells: int = 4096, stop_after: str = ""):
    """(seg, n_cells, registered, avgint) for a tuple of per-laser (H, W, C_l)
    planes — pure device program.

    All per-label reductions (erosion-depth histogram, size/border filters,
    shape props, spectral measurement) run as windowed one-hot matmuls over
    sequential band-local ids (ops/segstats.py) — zero full-image
    gathers/scatters, the dominant cost of the previous formulation.

    ``stop_after`` (static, profiling only): truncate the program after the
    named stage and return a scalar checksum of that stage's output —
    consecutive prefix timings attribute IN-PROGRAM cost (including layout/
    fusion effects stage-isolated timing can't see). Empty = full program.

    Attribution caveat: each truncated prefix pays a full-resolution
    checksum reduction the full program never runs (a strided-slice sum
    would be cheaper but lets XLA dead-code-eliminate unread pixels of a
    fused elementwise stage, which corrupts the timing), and truncation
    itself changes what XLA fuses — so deltas of a few ms are noise-level
    and can even come out slightly negative. Use for coarse attribution.
    """

    def _ck(x):
        # Full-tensor reduction on purpose; see the attribution caveat
        # in the docstring.
        return jnp.sum(x.astype(jnp.float32))

    h, w = stack[0].shape[0], stack[0].shape[1]
    # FFT registration on a centered power-of-two crop (config.register_crop,
    # same integer shift for rigid stage drift, ~3x cheaper FFTs at 2000^2).
    # The raw planes are cropped BEFORE the max projection: the projection
    # is only ever consumed at the crop, and XLA does not sink the slice
    # through the reduce — the full-plane max would be 1.4 GB of dead
    # device-memory reads.
    c = cfg.register_crop
    if c and h > c and w > c:
        r0, c0 = (h - c) // 2, (w - c) // 2
        _crop3 = lambda im: jax.lax.slice(
            im, (r0, c0, 0), (r0 + c, c0 + c, im.shape[2]))
    else:
        _crop3 = lambda im: im
    projections = [jnp.max(_crop3(img), axis=2) for img in stack]
    cref = projections[0]
    # The 95-ch registered cube is consumed only by the per-cell spectral
    # sums; cfg.registered_dtype (default bf16) halves its roll/concat/
    # stats traffic. The KMeans input (fov_sum -> log) is built from f32
    # per-laser 2D channel sums instead of re-reading the cube: sum of roll
    # == roll of sum, and the overlap mask distributes over the laser sum
    # (overlap = AND of the per-laser valid masks).
    reg_dt = jnp.dtype(cfg.registered_dtype)
    sums2d = [jnp.sum(img, axis=2) for img in stack]
    parts = [stack[0].astype(reg_dt)]
    fov_sum = sums2d[0]
    overlap = jnp.ones((h, w), bool)
    for i in range(1, len(stack)):
        s = reg.register_translation(cref, projections[i])
        if cfg.clamp_shift:
            s = reg.clamp_shift(s, cfg.max_shift)
        shifted, mask = reg.apply_shift_2d(stack[i].astype(reg_dt), s)
        parts.append(shifted)
        fov_sum = fov_sum + reg.apply_shift_2d(sums2d[i], s)[0]
        overlap = overlap & mask
    registered = jnp.concatenate(parts, axis=2) \
        * overlap[:, :, None].astype(reg_dt)
    # Materialize ONCE: the 5-laser minor-dim concat sits at unaligned
    # channel offsets, and without the barrier XLA re-fuses this whole
    # registration chain into the stats pass's operand pack.
    registered = jax.lax.optimization_barrier(registered)
    fov_sum = fov_sum * overlap
    image_cn = jnp.log(fov_sum + 1e-2)
    if stop_after == 'register':
        return _ck(image_cn)

    fg, interior = km.brightest_cluster_masks(image_cn, (2, 3),
                                             cfg.kmeans_iters)
    if stop_after == 'kmeans':
        return _ck(fg) + _ck(interior)
    interior = segstats.remove_small_holes_fast(
        interior, 64, flood_max_run=64, exact_fallback=False)
    interior = morph.binary_opening(interior)
    if stop_after == 'opening':
        return _ck(interior)
    # Single CCL+rank + ONE stats pass carries the whole seeding decision:
    # the reference's remove_small_objects(50) -> label -> per-erosion-round
    # regionprops (spectral_image_measurement.py:97-110) collapses into the
    # component labeling, a fused [counts, erosion-depth histogram] pass,
    # and one table lookup. The sub-50 small-object filter becomes a
    # valid_seed conjunct (counts >= 50): dropped components simply get the
    # sentinel depth bound and emit no seeds — identical output, two fewer
    # windowed passes and one fewer lookup.
    # max_run=64: interior components are cells (minor axis <= 35 px,
    # spectral_image_measurement.py:119); longer clumps just cost extra
    # fixpoint iterations, never correctness.
    pre_segments = 2 * max_cells
    comp0, _ = segstats.rank_labels(
        lab.label(interior, 2, cfg.ccl_max_iters, cfg.scan_cap), 2,
        cfg.ccl_max_iters, cfg.scan_cap)
    comp0 = jnp.minimum(comp0, pre_segments - 1)
    if stop_after == 'ccl':
        return _ck(comp0)

    # Erosion seeding via the erosion-depth (L1 distance) transform: pixel p
    # survives k erosions iff depth(p) > k, so the per-iteration "component
    # area after k erosions" is a (component, depth) histogram. A component
    # becomes a seed at the first k where its surviving area drops below
    # seed_area_max, and its seed pixels are {depth > k}. When erosion
    # splits a component the lobes still emit separate markers: the
    # superlevel set {depth > k} is disconnected there, and the
    # connectivity-1 cleanup below deletes the diagonal bridge fragments
    # the reference's per-round removal would have deleted. Residual
    # divergence vs the loop (segment2d.erosion_seed_markers keeps exact
    # semantics): lobes freeze at the pair's common k instead of each
    # lobe's own k, so marker SHAPES can differ by an erosion round.
    kmax = cfg.max_erosion_iters
    # fori_loop, NOT a Python unroll: the 39 trace-unrolled erosion steps
    # were most of the engine's XLA compile time; the rolled body compiles
    # in a fraction of a second.

    def _erode_step(_, s):
        m, depth = s
        m = morph.binary_erosion(m) & interior
        return m, depth + m

    _, depth = jax.lax.fori_loop(
        0, kmax - 1, _erode_step, (interior, interior.astype(jnp.int32)))
    depth_c = jnp.clip(depth, 0, kmax)
    if stop_after == 'depth':
        return _ck(depth_c)
    dstats = segstats.label_stats(comp0, None, pre_segments, width=256,
                                  aux=depth_c, aux_classes=kmax + 1)
    hist = dstats.aux_hist                                     # (C, kmax+1)
    if stop_after == 'dhist':
        return _ck(hist) + _ck(dstats.counts)
    # area_k[c, k] = component c's area after k erosions = #pixels depth > k.
    area_k = jnp.cumsum(hist[:, ::-1], axis=1)[:, ::-1][:, 1:]  # (C, kmax)
    small = area_k < cfg.seed_area_max
    k_seed = jnp.argmax(small, axis=1).astype(jnp.int32)       # first such k
    seed_area = jnp.take_along_axis(area_k, k_seed[:, None], axis=1)[:, 0]
    valid_seed = (seed_area >= cfg.seed_min_size) \
        & (dstats.counts >= 50) & (jnp.arange(pre_segments) > 0)
    # Single windowed broadcast: invalid/background/dropped slots get a
    # sentinel depth bound no pixel exceeds.
    ktbl = jnp.where(valid_seed, k_seed, kmax + 1).astype(jnp.float32)
    k_pix = segstats.label_lookup(comp0, ktbl, width=256)
    seed_mask = (depth.astype(jnp.float32) > k_pix) & (comp0 > 0)
    # Connectivity-1 sub-seed_min_size removal on the final seed mask — the
    # one observable effect of the reference's per-round
    # remove_small_objects(10) at skimage's default connectivity
    # (spectral_image_measurement.py:107): diagonal-only bridge fragments
    # between the eroded lobes of a touching cell pair are deleted, so the
    # lobes label as separate markers below. Without it the whole pair
    # floods as one basin (the round-3 parity defect — all 10 10-bit
    # disagreements were such merged doublets; see
    # segment2d.erosion_seed_markers and DIAG_PARITY_10B.json).
    lbl4, _ = segstats.rank_labels(
        lab.label(seed_mask, 1, cfg.ccl_max_iters, cfg.scan_cap),
        1, cfg.ccl_max_iters, cfg.scan_cap)
    lbl4 = jnp.minimum(lbl4, pre_segments - 1)
    st4 = segstats.label_stats(lbl4, None, pre_segments, width=256)
    keep4 = jnp.where(st4.counts >= cfg.seed_min_size, 1.0, 0.0).at[0].set(0.0)
    seed_mask = seed_mask & (segstats.label_lookup(lbl4, keep4,
                                                   width=256) > 0.5)
    markers, _ = segstats.rank_labels(
        lab.label(seed_mask, 2, cfg.ccl_max_iters, cfg.scan_cap), 2,
        cfg.ccl_max_iters, cfg.scan_cap)
    markers = jnp.minimum(markers, pre_segments - 1)
    if stop_after == 'markers':
        return _ck(markers)

    seg_ws = ws.watershed(-image_cn, markers, fg, 1, cfg.watershed_max_iters)
    if stop_after == 'watershed':
        return _ck(seg_ws)

    # Size/border filter + shape gate + post-erosion measurement, all in ONE
    # stats pass: the double-eroded label image keeps its parent's ids
    # (eroded(p) = seg_ws(p) where it survives), so the eroded spectral sums
    # and eroded counts are just extra masked channels of the SAME windowed
    # one-hot over seg_ws — the second stats pass (a full one-hot rebuild
    # at 2000^2 x 95 ch) collapses into added matmul columns.
    eroded = _erode_labels_twice(seg_ws)
    mask_e = (eroded > 0).astype(jnp.float32)
    if stop_after == 'eroded':
        return _ck(eroded)
    s1 = segstats.label_stats(seg_ws, registered, pre_segments,
                              width=256, moments=True,
                              image_mask=mask_e)
    counts_e = s1.mask_counts
    if stop_after == 'stats':
        return _ck(s1.counts) + _ck(s1.sums) + _ck(s1.moments) + _ck(counts_e)
    sums_e = s1.sums
    keep = (s1.counts >= cfg.cell_min_size) & (s1.border_hits == 0)
    n = jnp.maximum(s1.counts, 1.0)
    rbar = s1.moments[:, 0] / n
    cbar = s1.moments[:, 1] / n
    mu20 = s1.moments[:, 2] / n - rbar * rbar + 1.0 / 12.0
    mu02 = s1.moments[:, 3] / n - cbar * cbar + 1.0 / 12.0
    mu11 = s1.moments[:, 4] / n - rbar * cbar
    common = jnp.sqrt(jnp.maximum((mu20 - mu02) ** 2 + 4 * mu11 * mu11, 0.0))
    lam2 = jnp.clip((mu20 + mu02 - common) / 2.0, 0.0, None)
    minor = 4.0 * jnp.sqrt(lam2)
    keep = keep & (minor >= cfg.minor_axis_min) & (minor <= cfg.minor_axis_max)
    keep = keep & (s1.counts > 0)
    keep = keep.at[0].set(False)
    keep = keep & (counts_e > 0)    # cells fully erased by the double
    #                                 erosion vanish, exactly as the
    #                                 reference's relabel of the eroded image
    final = jnp.cumsum(keep.astype(jnp.int32))
    n_cells = final[-1]
    remap = jnp.where(keep, jnp.minimum(final, max_cells - 1), 0)
    seg_final = segstats.label_lookup(eroded, remap,
                                      width=256).astype(jnp.int32)
    means = sums_e / jnp.maximum(counts_e, 1.0)[:, None]
    avgint = jnp.zeros((max_cells, means.shape[1]), jnp.float32) \
        .at[remap].set(means)
    avgint = avgint.at[0].set(0.0)
    return seg_final, n_cells, registered, avgint


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def fov_step_ecoli(stack, clf_arrays, cfg: SegmentationConfig,
                   max_cells: int, clf_static, classify_cap: int = 2048):
    """Single-program 10-bit forward step: raw per-laser planes -> barcode
    class indices (the ecoli counterpart of fused.fov_step; classification
    is the 132-d feature build + 6 check heads + gated kNN of
    image_classification.py:38-56)."""
    from hiprfish_tpu.pipeline import fused

    (n_classes, blocks, check_slice, n_channels, k, temperature,
     check_blocks) = clf_static
    seg, n_cells, registered, avgint = segment_ecoli_device(
        stack, cfg, max_cells)
    avgint_norm = avgint / jnp.maximum(
        jnp.max(avgint, axis=1, keepdims=True), 1e-12)
    # Violet-derivative feature block (image_classification.py:47-48).
    lo, hi = blocks[0]
    feats_base = jnp.concatenate(
        [avgint_norm, jnp.diff(avgint_norm[:, lo:hi], axis=1)], axis=1)
    code_idx, max_prob = fused.classify_capped(
        feats_base, n_cells, classify_cap,
        clf_arrays["check_params"],
        check_blocks,
        clf_arrays.get("scaler_mean"),
        clf_arrays.get("scaler_scale"),
        clf_arrays["train_features"],
        clf_arrays["train_labels"],
        n_classes, blocks, check_slice, n_channels, k, temperature,
    )
    return seg, n_cells, avgint_norm, code_idx, max_prob
